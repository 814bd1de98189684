"""Paged decode attention: the hand-written Hopper kernel, its plain
PyTorch version, and the wrapper the model calls.

Port of the Pallas TPU kernel ``repro/kernels/paged_decode_attention.py``
(``paged_decode_attention``), reached in the reference through the
model-layout wrapper ``repro/kernels/ops.py::paged_decode_attention``.
The CUDA source is ``csrc/paged_decode_attention.cu``.

One query token per sequence attends over a shared KV page pool through
a block table: row ``b`` of ``block_tables`` lists the physical pages of
sequence ``b`` in logical order; -1 is read as page 0 and masked by
position.  Valid keys are ``kpos < ctx[b]``, and with a window also
``kpos >= ctx[b] - window``.  Arithmetic is f32 with ``NEG_INF = -1e30``;
the output takes ``q``'s dtype.

Bound on the card: the bytes of K and V read, about ``2 * ctx * Hkv * dh
* sizeof`` per sequence, against 3.35 TB/s of HBM.  The kernel reads the
pool in the model's ``(N+1, page, Hkv, dh)`` layout in place: unlike the
reference wrapper it transposes nothing (a whole-pool copy per layer per
step) and pads no head dim.  It splits each row's table into ranges of
whole pages, one CTA per (range, KV head or group chunk, sequence), as
``paged_decode_splits`` plans from the shapes alone; each CTA reads its
row's ``ctx`` first and walks only its valid keys, and a second kernel
merges the ranges' partial softmax states from an f32 scratch this
wrapper allocates.  See the CUDA source for the design.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.attention_shapes import (
    DTYPES, check_attention_shape, group_chunk)
from repro_torch.kernels.decode_attention import SPLIT_LENS, TARGET_CTAS

NEG_INF = -1e30
# most pages a CTA takes (csrc/paged_decode_attention.cu)
MAX_PAGES = 256


def paged_decode_splits(b: int, hkv: int, p_max: int,
                        page: int) -> tuple[int, int]:
    """The kernel's split of block tables ``p_max`` pages wide, pages of
    ``page`` slots, for ``b`` sequences of ``hkv`` KV heads: ``(splits,
    pages_per_split)``, with ``splits = ceil(p_max / pages_per_split)``.
    Ranges are whole pages: the most pages that fit the largest slot
    count in ``SPLIT_LENS`` (at least one page, at most ``MAX_PAGES``)
    that still gives ``b * hkv * splits >= TARGET_CTAS`` CTAs, else the
    smallest.  Shapes only, as plain ints, as ``decode_splits``: it never
    reads a tensor, so a decode step stays free of host syncs and its
    launch is the same from step to step."""
    for name, x in (("b", b), ("hkv", hkv), ("p_max", p_max),
                    ("page", page)):
        if type(x) is not int:
            raise TypeError(f"paged_decode_splits takes ints; {name} is "
                            f"{type(x).__name__}")
        if x <= 0:
            raise ValueError(f"{name} must be positive, got {x}")
    for n in SPLIT_LENS:
        per = min(max(n // page, 1), MAX_PAGES)
        if b * hkv * -(-p_max // per) >= TARGET_CTAS:
            break
    return -(-p_max // per), per


def paged_decode_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 ctx_lens: torch.Tensor, *,
                                 window: int = -1) -> torch.Tensor:
    """Gather-then-attend (``repro/kernels/ref.py:47-63``), model layout:
    q (B, 1, H, dh); pools (N, page, Hkv, dh); block_tables (B, P) int32;
    ctx_lens (B,) int32.  Returns (B, 1, H, dh)."""
    b, _, h, dh = q.shape
    page, hkv = k_pages.shape[1], k_pages.shape[2]
    g = h // hkv
    t = block_tables.shape[1] * page
    ids = block_tables.long().clamp(min=0)                       # (B, P)
    k = k_pages[ids].reshape(b, t, hkv, dh).float()
    v = v_pages[ids].reshape(b, t, hkv, dh).float()
    qg = q.reshape(b, hkv, g, dh).float()
    scores = torch.einsum("bhgd,bthd->bhgt", qg, k) / math.sqrt(dh)
    ctx = ctx_lens.long()[:, None]
    kpos = torch.arange(t, device=q.device)[None, :].expand(b, t)
    kpos = torch.where(kpos < ctx, kpos, -1)
    qpos = ctx - 1
    valid = (kpos >= 0) & (kpos <= qpos)
    if window > 0:
        valid &= kpos > qpos - window
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", p, v)
    return out.reshape(b, 1, h, dh).to(q.dtype)


def _check(q, k_pages, v_pages, block_tables, ctx_lens) -> None:
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, dh), got {tuple(q.shape)}")
    b, _, h, dh = q.shape
    if k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("k_pages and v_pages must be equal (N, page, Hkv, "
                         f"dh), got {tuple(k_pages.shape)} and "
                         f"{tuple(v_pages.shape)}")
    if k_pages.shape[3] != dh or h % k_pages.shape[2]:
        raise ValueError(f"pool {tuple(k_pages.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if block_tables.ndim != 2 or block_tables.shape[0] != b:
        raise ValueError(f"block_tables must be (B, P) with B={b}")
    if ctx_lens.shape != (b,):
        raise ValueError(f"ctx_lens must be ({b},)")
    if block_tables.dtype != torch.int32 or ctx_lens.dtype != torch.int32:
        raise ValueError("block_tables and ctx_lens must be int32")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise ValueError("q, k_pages and v_pages must share a dtype")
    devs = {x.device for x in (q, k_pages, v_pages, block_tables, ctx_lens)}
    if len(devs) != 1:
        raise ValueError(f"inputs span devices {sorted(map(str, devs))}")


def _launch(q, k_pages, v_pages, block_tables, ctx_lens,
            window: int) -> torch.Tensor:
    from repro_torch.kernels import build

    b, _, h, dh = q.shape
    n_pool, page, hkv, _ = k_pages.shape
    g = h // hkv
    check_attention_shape(q.dtype, dh, g)
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("ctx_lens", ctx_lens)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    fn = build.load("paged_decode_attention").paged_decode_attention_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_int])
    p_max = block_tables.shape[1]
    splits, per = paged_decode_splits(b, hkv, p_max, page)
    out = torch.empty_like(q)
    # per (query row, split): the partial accumulator, then (m, l)
    scratch = (torch.empty(b * h * splits * (dh + 2), dtype=torch.float32,
                           device=q.device) if splits > 1 else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
             v_pages.data_ptr(), block_tables.data_ptr(), ctx_lens.data_ptr(),
             out.data_ptr(), b, hkv, g, dh, page, p_max, n_pool, int(window),
             1.0 / math.sqrt(dh), stream,
             None if scratch is None else scratch.data_ptr(), per,
             group_chunk(g))
    if err != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: "
                           f"error {err}")
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           ctx_lens: torch.Tensor, *,
                           window: int = -1) -> torch.Tensor:
    """Model layout: q (B, 1, H, dh); k_pages/v_pages (N+1, page, Hkv,
    dh); block_tables (B, P) int32, -1 = unmapped; ctx_lens (B,) int32.
    Returns (B, 1, H, dh).

    CUDA tensors launch the Hopper kernel (or raise); CPU tensors take
    the plain version.  ``paged_decode_attention.launches`` counts the
    calls that launch the kernel (one per call, whether or not the splits
    need the merge kernel after it)."""
    _check(q, k_pages, v_pages, block_tables, ctx_lens)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages,
                                            block_tables, ctx_lens,
                                            window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no paged_decode_attention for device {q.device}")
    return _launch(q, k_pages, v_pages, block_tables, ctx_lens, window)


paged_decode_attention.launches = 0
