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

Training: ``flash_attention``, ``grouped_matmul`` and ``ssm_scan`` under
grad are autograd Functions whose backwards are hand-written Hopper
kernels too (``csrc/flash_attention_bwd.cu``, ``grouped_matmul_bwd.cu``,
``ssm_scan_bwd.cu``; ``*_backward`` calls them directly); the two decode
wrappers, ``paged_flash_attention`` and ``attention_combine`` have no
backward and raise under grad (``grad.py``).

Meta tensors (the dry run's step pass, ``launch/dryrun.py``) take each
wrapper's meta branch: it allocates what the launch allocates (outputs,
scratch, and under autograd what the Function saves), at the launch's
shapes and dtypes, counts the call with its operations and bytes
(``work.count``, the formulas ``chip_smoke.py`` bounds each kernel by)
and returns; it never launches, never moves ``.launches`` (the card's
count) and never runs the plain version.

``attention_combine`` is port-side: it combines the partial softmaxes of
a sequence-sharded ring's ranks (``decode_attention(..., with_lse=True)``
over each rank's slots), where the reference leaves the reduction to
GSPMD.  So is ``paged_flash_attention``: the paged layout's suffix
prefill and mixed chunk over the pool through the block tables, where
the reference gathers each table (``paged_view``) and computes the
attention with jnp.
"""
from repro_torch.kernels.attention_combine import (attention_combine,
                                                   attention_combine_plain)
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_backward, flash_attention_backward_plain,
    flash_attention_plain)
from repro_torch.kernels.grouped_matmul import (
    grouped_matmul, grouped_matmul_backward, grouped_matmul_backward_plain,
    grouped_matmul_plain)
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention, paged_decode_attention_plain)
from repro_torch.kernels.paged_flash_attention import (
    paged_flash_attention, paged_flash_attention_plain)
from repro_torch.kernels.ssm_scan import (ssm_scan, ssm_scan_backward,
                                          ssm_scan_backward_plain,
                                          ssm_scan_plain)

__all__ = ["attention_combine", "attention_combine_plain",
           "decode_attention", "decode_attention_plain", "flash_attention",
           "flash_attention_backward", "flash_attention_backward_plain",
           "flash_attention_plain", "grouped_matmul",
           "grouped_matmul_backward", "grouped_matmul_backward_plain",
           "grouped_matmul_plain", "paged_decode_attention",
           "paged_decode_attention_plain", "paged_flash_attention",
           "paged_flash_attention_plain", "ssm_scan", "ssm_scan_backward",
           "ssm_scan_backward_plain", "ssm_scan_plain"]
