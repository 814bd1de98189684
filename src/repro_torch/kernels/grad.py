"""The gradient guard of the kernels that have no backward yet.

A wrapper fills its output through ``ctypes`` from ``data_ptr()``s, so on
a CUDA tensor the output has no ``grad_fn``: under autograd the inputs
would silently get no gradient.  ``flash_attention``, ``grouped_matmul``
and ``ssm_scan`` have backward kernels (their autograd Functions); the
two decode wrappers, ``paged_flash_attention`` and ``attention_combine``
call ``refuse_grad`` before they launch, and raise instead of returning
a tensor cut from the graph.  Serving runs under
``torch.inference_mode``, where grad mode is off, so the guard never
fires there.
"""
from __future__ import annotations

import torch

# the ROADMAP item that would give each kernel its backward
BACKWARD_ITEM = {
    "paged_decode_attention": "A4.5 (a decode step under grad)",
    "decode_attention": "A4.5 (a decode step under grad)",
    "attention_combine": "A4.5 (a decode step under grad)",
    "paged_flash_attention": "A4.5 (a paged prefill under grad)",
}


def refuse_grad(name: str, *xs: torch.Tensor) -> None:
    """Raise if grad mode is on and an input requires grad."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise RuntimeError(
            f"{name} has no backward kernel on CUDA yet (ROADMAP "
            f"{BACKWARD_ITEM[name]}): call it under torch.no_grad() or "
            f"torch.inference_mode(), or on detached inputs")
