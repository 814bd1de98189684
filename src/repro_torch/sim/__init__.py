"""The sim plane: virtual time and network links (copies of the
reference's ``sim/clock.py`` and ``sim/network.py``), and the roofline
cost model with its measured calibration, priced for one NVIDIA H100
(``sim/costmodel.py``, ``sim/calibration.py``)."""
