"""int8 gradient all-reduce with error feedback (port of
``repro/distributed/collectives.py``), over a ``torch.distributed``
process group.

``compressed_psum`` quantizes each local gradient (plus the carried
error residual) to int8 with one f32 scale per tensor, puts only the
int8 payloads and the scales on the wire (one all-gather of every
leaf's int8 values, one of the scales), sums ``q_i * scale_i`` in rank
order in f32, and keeps the quantization error as feedback for the next
step.  The reference models this as ``psum(q * scale)`` over the pod
axis; the sum is the same, its order fixed here.

``launch/train.py`` uses it for the cross-pod hop of the gradient
reduction when ``TrainPlan.compress_grads`` is set.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.distributed import parallel
from repro_torch.models.params import flatten, unflatten


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 q, f32 scale): scale = max(max |x|, 1e-12) / 127, q =
    clip(round(x / scale), -127, 127), rounding half to even."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def compressed_psum(grads: Any, ef: Optional[Any], group):
    """int8 + error-feedback mean over ``group``.

    grads: tree of local f32/bf16 gradients.
    ef:    matching tree of f32 error residuals (or None on step 0).
    Returns (mean_grads, new_ef), the mean in each gradient's dtype."""
    n = parallel.group_size(group)
    flat_g, treedef = flatten(grads)
    flat_e = (flatten(ef)[0] if ef is not None else [None] * len(flat_g))
    gfs, qs, scales, new_e = [], [], [], []
    for g, e in zip(flat_g, flat_e):
        gf = g.float() + (e if e is not None else 0.0)
        q, scale = quantize_int8(gf)
        gfs.append(gf)
        qs.append(q)
        scales.append(scale)
        new_e.append(gf - q.float() * scale)
    if flat_g:
        q_all = parallel.all_gather(torch.cat([q.reshape(-1) for q in qs]),
                                    group)
        s_all = parallel.all_gather(torch.stack(scales), group)
    means, start = [], 0
    for i, (g, q) in enumerate(zip(flat_g, qs)):
        size = q.numel()
        total = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        for r in range(n):
            part = q_all[r, start:start + size].reshape(q.shape)
            total = total + part.float() * s_all[r, i]
        means.append((total / n).to(g.dtype))
        start += size
    return unflatten(treedef, means), unflatten(treedef, new_e)


def wire_bytes_saved(grads: Any) -> int:
    """Bytes saved per cross-pod all-reduce by int8 against bf16 payloads
    (one a gradient element)."""
    return int(sum(g.numel() for g in flatten(grads)[0]))
