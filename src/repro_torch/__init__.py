"""PyTorch/CUDA port of the ``repro`` serving stack, for NVIDIA Hopper.

The package mirrors ``repro``'s module layout (``repro_torch/models/
attention.py`` is the counterpart of ``repro/models/attention.py``, and
so on) and imports nothing from it.  Plain-Python planes the port needs
(configs, request types, knobs, the page allocator, the scheduler and
the engine core) are kept as copies with their import paths rewritten.

Every entry point takes ``device=None``, which means ``"cuda"``; without
CUDA it raises unless the caller passes ``device="cpu"``.
"""
