"""Request types and the knob surface (copies of ``repro.core``)."""
