"""Flash attention: the hand-written Hopper kernel, its plain PyTorch
version, and the wrapper the model calls.

Port of the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``), reached in the reference through the model-layout
wrapper ``repro/kernels/ops.py::flash_attention``.  The CUDA source is
``csrc/flash_attention.cu``.  On the port's path it computes the ring
layout's one-shot causal prefill, and non-causal the encoder's self
attention and a decoder prefill's cross attention.

Blocked GQA attention of q (B, S, H, dh) against k, v (B, T, Hkv, dh):
query head ``h`` reads KV head ``h // (H // Hkv)``.  Causal: key ``j``
is valid for query ``i`` when ``j <= i`` (and ``j > i - window`` with a
window); non-causal: every key.  Scores and softmax are f32 with
``NEG_INF = -1e30``; the output takes ``q``'s dtype.

Two differences from the reference wrapper, both on purpose: the key
length is the real ``T`` (``ops.py`` pads the key axis and passes the
padded length as ``kv_len``, so non-causal calls with ``T % 128 != 0``
let zero keys into the softmax; ROADMAP §C), and nothing is padded, so
the scale is ``1/sqrt(dh)`` of the real head dim.  A query row with no
valid key (causal with a window and ``S > T`` only) comes out as zeros
from the kernel and as the uniform average from the plain version.

Bound on the card: operations, ``4 * dh`` per (query row, head, valid
key), against the tensor cores' bf16 rate.  bf16 runs on the tensor
cores (``mma.sync``, f32 accumulators, P rounded to bf16 before P V);
f32 runs IEEE FMAs on the CUDA cores, since the f32 band of 2e-5 is
beyond TF32.  See the CUDA source for the design.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.attention_shapes import (DTYPES,
                                                  check_attention_shape)

NEG_INF = -1e30


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int = -1) -> torch.Tensor:
    """The semantics of ``repro/kernels/ref.py:13-30`` in model layout:
    q (B, S, H, dh); k, v (B, T, Hkv, dh).  Returns (B, S, H, dh)."""
    b, s, h, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, dh).float()
    scores = torch.einsum("bshgd,bthd->bhgst", qg, k.float()) / math.sqrt(dh)
    if causal:
        qpos = torch.arange(s, device=q.device)[:, None]
        kpos = torch.arange(t, device=q.device)[None, :]
        mask = kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", p, v.float())
    return out.reshape(b, s, h, dh).to(q.dtype)


def _check(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, S, H, dh) and k, v equal (B, T, "
                         f"Hkv, dh); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or h % k.shape[2]:
        raise ValueError(f"k {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if k.shape[1] == 0 or q.shape[1] == 0:
        raise ValueError("empty query or key axis")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must share a dtype")
    devs = {x.device for x in (q, k, v)}
    if len(devs) != 1:
        raise ValueError(f"inputs span devices {sorted(map(str, devs))}")


def _launch(q, k, v, causal: bool, window: int) -> torch.Tensor:
    from repro_torch.kernels import build

    b, s, h, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    check_attention_shape(q.dtype, dh, g)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    fn = build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), b, s, t, h, hkv, dh, int(bool(causal)),
             int(window), 1.0 / math.sqrt(dh), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: error {err}")
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = -1) -> torch.Tensor:
    """Model layout: q (B, S, H, dh); k, v (B, T, Hkv, dh).  Returns
    (B, S, H, dh).

    CUDA tensors launch the Hopper kernel (or raise); CPU tensors take
    the plain version.  ``flash_attention.launches`` counts kernel
    launches."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    return _launch(q, k, v, causal, window)


flash_attention.launches = 0
