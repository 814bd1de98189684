"""Ring decode attention: the hand-written Hopper kernel, its plain
PyTorch version, and the wrapper the model calls.

Port of the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``decode_attention``), reached in the reference through the
model-layout wrapper ``repro/kernels/ops.py::decode_attention``.  The
CUDA source is ``csrc/decode_attention.cu``.  On the port's path it
computes the ring layout's decode attention.

One query token per sequence attends over a slot-contiguous ring of
``T`` slots.  ``kpos[b, t]`` is the absolute position held in slot
``t`` (-1 = empty); a slot is valid when ``0 <= kpos <= q_pos[b]``, and
with a window also ``kpos > q_pos[b] - window``.  Arithmetic is f32 with
``NEG_INF = -1e30``; the output takes ``q``'s dtype.  A row with no
valid slot comes out as zeros from the kernel and as the uniform average
from the plain version (as from the reference); ring decode never has
such a live row, since each step writes its token before attending.

Bound on the card: the bytes of K and V of the valid slots, about
``2 * valid * Hkv * dh * sizeof`` per sequence, against 3.35 TB/s of
HBM.  The kernel splits the ring into ranges of slots, one CTA per
(range, KV head, sequence), as ``decode_splits`` plans from the shapes
alone; each CTA reads its range's ``kpos`` first and loads only the
valid slots' rows, and a second kernel merges the ranges' partial
softmax states from an f32 scratch this wrapper allocates.  See the CUDA
source for the design.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.attention_shapes import (
    DTYPES, check_attention_shape, group_chunk)

NEG_INF = -1e30
# split planning: ring slots per CTA, largest first, and the CTAs a call
# should reach: four per SM of an H100 (132 SMs).  Only the ranges that
# hold live slots do work, and a ring sized for the longest context is
# mostly empty at a decode step; at the serve shapes (8 rows, 4096 slots)
# four a SM gives ranges of 256.  chip_smoke.py's time_ranges holds 256
# against 512 and 128 on full rings and at 515-token contexts (PERF.md).
SPLIT_LENS = (1024, 512, 256, 128, 64)
TARGET_CTAS = 4 * 132


def decode_splits(b: int, hkv: int, t: int) -> tuple[int, int]:
    """The kernel's split of a ring of ``t`` slots for ``b`` sequences of
    ``hkv`` KV heads: ``(splits, slots_per_split)``, with ``splits =
    ceil(t / slots_per_split)``.  The largest range in ``SPLIT_LENS``
    that still gives ``b * hkv * splits >= TARGET_CTAS`` CTAs, else the
    smallest.  Shapes only, as plain ints: it never reads a tensor, so a
    decode step stays free of host syncs."""
    for name, x in (("b", b), ("hkv", hkv), ("t", t)):
        if type(x) is not int:
            raise TypeError(f"decode_splits takes ints; {name} is "
                            f"{type(x).__name__}")
        if x <= 0:
            raise ValueError(f"{name} must be positive, got {x}")
    for n in SPLIT_LENS:
        if b * hkv * -(-t // n) >= TARGET_CTAS:
            break
    return -(-t // n), n


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kpos: torch.Tensor, q_pos: torch.Tensor, *,
                           window: int = -1) -> torch.Tensor:
    """``repro/kernels/ref.py:33-44`` in model layout: q (B, 1, H, dh);
    k, v (B, T, Hkv, dh); kpos (B, T) int32; q_pos (B,) int32.  Returns
    (B, 1, H, dh)."""
    b, _, h, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, hkv, h // hkv, dh).float()
    scores = torch.einsum("bhgd,bthd->bhgt", qg, k.float()) / math.sqrt(dh)
    kp = kpos.long()
    qp = q_pos.long()[:, None]
    valid = (kp >= 0) & (kp <= qp)
    if window > 0:
        valid &= kp > qp - window
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", p, v.float())
    return out.reshape(b, 1, h, dh).to(q.dtype)


def _check(q, k, v, kpos, q_pos) -> None:
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, dh), got {tuple(q.shape)}")
    b, _, h, dh = q.shape
    if k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"k and v must be equal (B, T, Hkv, dh), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if k.shape[0] != b or k.shape[3] != dh or h % k.shape[2]:
        raise ValueError(f"cache {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if k.shape[1] == 0:
        raise ValueError("empty ring")
    if kpos.shape != k.shape[:2]:
        raise ValueError(f"kpos must be {tuple(k.shape[:2])}, got "
                         f"{tuple(kpos.shape)}")
    if q_pos.shape != (b,):
        raise ValueError(f"q_pos must be ({b},), got {tuple(q_pos.shape)}")
    if kpos.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise ValueError("kpos and q_pos must be int32")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must share a dtype")
    devs = {x.device for x in (q, k, v, kpos, q_pos)}
    if len(devs) != 1:
        raise ValueError(f"inputs span devices {sorted(map(str, devs))}")


def _launch(q, k, v, kpos, q_pos, window: int) -> torch.Tensor:
    from repro_torch.kernels import build

    b, _, h, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    check_attention_shape(q.dtype, dh, g)
    # K/V rows are read 16 bytes a lane; kpos and q_pos one int at a time
    for name, x, align in (("q", q, 16), ("k", k, 16), ("v", v, 16),
                           ("kpos", kpos, 4), ("q_pos", q_pos, 4)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")
    fn = build.load("decode_attention").decode_attention_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_int])
    splits, split_len = decode_splits(b, hkv, t)
    out = torch.empty_like(q)
    # per (query row, split): the partial accumulator, then (m, l)
    scratch = (torch.empty(b * h * splits * (dh + 2), dtype=torch.float32,
                           device=q.device) if splits > 1 else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             kpos.data_ptr(), q_pos.data_ptr(), out.data_ptr(), b, t, hkv, g,
             dh, int(window), 1.0 / math.sqrt(dh), stream,
             None if scratch is None else scratch.data_ptr(), split_len,
             group_chunk(g))
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: error {err}")
    decode_attention.launches += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kpos: torch.Tensor, q_pos: torch.Tensor, *,
                     window: int = -1) -> torch.Tensor:
    """Model layout: q (B, 1, H, dh); k, v (B, T, Hkv, dh); kpos (B, T)
    int32, -1 = empty; q_pos (B,) int32.  Returns (B, 1, H, dh).

    CUDA tensors launch the Hopper kernel (or raise); CPU tensors take
    the plain version.  ``decode_attention.launches`` counts the calls
    that launch the kernel (one per call, whether or not the splits need
    the merge kernel after it)."""
    _check(q, k, v, kpos, q_pos)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kpos, q_pos, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no decode_attention for device {q.device}")
    return _launch(q, k, v, kpos, q_pos, window)


decode_attention.launches = 0
