"""Virtual time and network links (copies of the reference's ``sim/clock.py``
and ``sim/network.py``): the event loop the controller ticks on, and the
links of the data plane."""
