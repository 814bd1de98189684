"""Hand-written Hopper kernels of the port.

Each kernel ships as ``<name>.py`` (its plain PyTorch version and the
wrapper the model calls) beside ``csrc/<name>.cu`` (the CUDA source,
built for ``sm_90a`` by ``build.py`` at first use).  A wrapper takes the
plain version only for CPU tensors; on CUDA tensors it launches the
kernel or raises.  A wrapper launches on PyTorch's current stream and
does its one-time work (building and loading the library, reading the SM
count, setting a kernel attribute, fetching the CUDA driver's tensor-map
encoder) at its first call, so a CUDA graph captures it after one eager
call (``serving/graphs.py``).

Training: ``flash_attention`` under grad is an autograd Function whose
backward is ``csrc/flash_attention_bwd.cu``
(``flash_attention_backward``); the other four wrappers have no
backward yet and raise under grad (``grad.py``).
"""
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_backward, flash_attention_backward_plain,
    flash_attention_plain)
from repro_torch.kernels.grouped_matmul import (grouped_matmul,
                                                grouped_matmul_plain)
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention, paged_decode_attention_plain)
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_plain

__all__ = ["decode_attention", "decode_attention_plain", "flash_attention",
           "flash_attention_backward", "flash_attention_backward_plain",
           "flash_attention_plain", "grouped_matmul", "grouped_matmul_plain",
           "paged_decode_attention", "paged_decode_attention_plain",
           "ssm_scan", "ssm_scan_plain"]
