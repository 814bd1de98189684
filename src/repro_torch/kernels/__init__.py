"""Hand-written Hopper kernels of the port.

Each kernel ships as ``<name>.py`` (its plain PyTorch version and the
wrapper the model calls) beside ``csrc/<name>.cu`` (the CUDA source,
built for ``sm_90a`` by ``build.py`` at first use).  A wrapper takes the
plain version only for CPU tensors; on CUDA tensors it launches the
kernel or raises.
"""
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.grouped_matmul import (grouped_matmul,
                                                grouped_matmul_plain)
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention, paged_decode_attention_plain)
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_plain

__all__ = ["decode_attention", "decode_attention_plain", "flash_attention",
           "flash_attention_plain", "grouped_matmul", "grouped_matmul_plain",
           "paged_decode_attention", "paged_decode_attention_plain",
           "ssm_scan", "ssm_scan_plain"]
