"""Flash attention: the hand-written Hopper kernel, its plain PyTorch
version, and the wrapper the model calls.

Port of the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``), reached in the reference through the model-layout
wrapper ``repro/kernels/ops.py::flash_attention``.  The CUDA source is
``csrc/flash_attention.cu``.  On the port's path it computes the ring
layout's one-shot causal prefill, non-causal the encoder's self
attention and a decoder prefill's cross attention, and training's
whole-sequence attention (``models/attention.py::_full``).  Training
differentiates it: under grad the wrapper is an autograd Function whose
forward also writes each query row's log-sum-exp and whose backward is
the hand-written Hopper kernel of ``csrc/flash_attention_bwd.cu`` (the
reference has no backward kernel; JAX differentiates its jnp attention).

Blocked GQA attention of q (B, S, H, dh) against k, v (B, T, Hkv, dh):
query head ``h`` reads KV head ``h // (H // Hkv)``.  Causal: key ``j``
is valid for query ``i`` when ``j <= i`` (and ``j > i - window`` with a
window); non-causal: every key.  Scores and softmax are f32 with
``NEG_INF = -1e30``; the output takes ``q``'s dtype.

Two differences from the reference wrapper, both on purpose: the key
length is the real ``T`` (``ops.py`` pads the key axis and passes the
padded length as ``kv_len``, so non-causal calls with ``T % 128 != 0``
let zero keys into the softmax; ROADMAP §C), and the query and key axes
are never padded.  The head dim is padded only where it is not a
multiple of 8 (to the next one, where the reference pads every dh to a
multiple of 128): q, k and v (and out and dout for the backward) are
copied into zero-padded tensors, the scale stays ``1/sqrt(dh)`` of the
real head dim, and the outputs and gradients are cut back to dh.  A
query row with no valid key (causal with a window and ``S > T`` only)
comes out as zeros from the kernel (with LSE ``-inf`` and a zero
gradient) and as the uniform average from the plain version.

Bound on the card: operations, ``4 * dh`` per (query row, head, valid
key), against the tensor cores' bf16 rate.  bf16 up to dh 256 runs on
TMA and ``wgmma`` with warp specialisation: a persistent grid walking
(query head, b, 128 query rows) items, a producer warp streaming K/V
tiles of 128 keys (64 at
dh past 128) by TMA through (dh, heads, rows, B) tensor maps, and two
consumer warpgroups of 64 rows that compute S = Q K^T from shared memory
and O += P V with P rounded to bf16 in registers, the next tile's scores
overlapping this tile's P V and the two warpgroups taking turns at the
tensor cores; f32 runs IEEE FMAs on the CUDA cores, since the f32 band of
2e-5 is beyond TF32.  What still holds the bf16 body back is in the CUDA
source's note.  The backward's bound is operations too, ``10 * dh`` per
(query row, head, valid key); its bf16 body runs on TMA and ``wgmma``
(a dK/dV pass of 128-key blocks and a dQ pass of 128-row blocks, each
two consumer warpgroups of 64 rows fed 64-row tiles by a producer
warp).  A dh past 256 runs in column blocks, each CTA owning a block of
its output's columns and computing the whole scores again: bf16 on the
tensor cores (``mma.sync``; the forward's blocks of 256, dQ's of 128,
dK's and dV's of 64), f32 in FMAs in blocks of 64.  See the CUDA sources
for the designs.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import work
from repro_torch.kernels.attention_shapes import (DTYPES,
                                                  check_attention_shape,
                                                  pad_width)

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


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor, *,
                              causal: bool = True,
                              window: int = -1) -> torch.Tensor:
    """The f32 (B, H, S) log-sum-exp of each query row's scaled scores
    over its valid keys: what the forward kernel writes for the
    backward (a row with no valid key: about ``NEG_INF`` here, ``-inf``
    from the kernel)."""
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
    return torch.logsumexp(scores, dim=-1).reshape(b, h, s)


def flash_attention_backward_plain(q, k, v, dout, *, causal: bool = True,
                                   window: int = -1):
    """(dq, dk, dv): autograd through ``flash_attention_plain``, the
    backward's plain version."""
    with torch.enable_grad():
        qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
        out = flash_attention_plain(qq, kk, vv, causal=causal, window=window)
        return torch.autograd.grad(out, (qq, kk, vv), dout)


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


def _check_launch(name: str, *xs) -> None:
    for i, x in enumerate(xs):
        if not x.is_contiguous():
            raise ValueError(f"{name}: input {i} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: input {i} must be 16-byte aligned")


def _padded(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` with its last axis zero-padded to ``width`` (a copy), or
    ``x`` itself where it is that wide already."""
    if x.shape[-1] == width:
        return x
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def _launch(q, k, v, causal: bool, window: int,
            with_lse: bool = False):
    """The forward kernel.  Returns ``out``, or ``(out, lse)`` with the
    f32 (B, H, S) log-sum-exp of each query row when ``with_lse``; without
    it the kernel gets a null pointer, so the serving launches (and the
    CUDA graphs that captured them) are unchanged.  A dh that is not a
    multiple of 8 runs on zero-padded copies of q, k and v at the next
    one, with the real dh's scale, and ``out`` is cut back to dh."""
    from repro_torch.kernels import build

    b, s, h, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    check_attention_shape(q.dtype, dh, h // hkv)
    if b == 0:
        # a rank that holds no row of a batch split: no launch (a grid of
        # no CTAs is not a launch), nothing counted
        out = torch.empty_like(q)
        lse = torch.empty((0, h, s), dtype=torch.float32, device=q.device)
        return (out, lse) if with_lse else out
    _check_launch("flash_attention", q, k, v)
    width = pad_width(dh)
    q_in, k_in = q, k
    q, k, v = (_padded(x, width) for x in (q, k, v))
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if q.device.type == "meta":
        work.count("flash_attention", work.flash(q_in, k_in, causal, window))
    else:
        fn = build.load("flash_attention").flash_attention_launch
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                           + [ctypes.c_int] * 8
                           + [ctypes.c_float, ctypes.c_void_p])
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), lse.data_ptr() if with_lse else None, b, s,
                 t, h, hkv, width, int(bool(causal)), int(window),
                 1.0 / math.sqrt(dh), stream)
        if err != 0:
            raise RuntimeError(f"flash_attention launch failed: error {err}")
        flash_attention.launches += 1
    if width != dh:
        out = out[..., :dh].contiguous()
    return (out, lse) if with_lse else out


def _launch_backward(q, k, v, out, lse, dout, causal: bool, window: int):
    """The backward kernels (``csrc/flash_attention_bwd.cu``: the D
    pre-pass, dK/dV, dQ) on the current stream.  Returns (dq, dk, dv) in
    q's dtype.  One call counts one launch."""
    from repro_torch.kernels import build

    b, s, h, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    check_attention_shape(q.dtype, dh, h // hkv)
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not "
                         f"match q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (b, h, s) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be f32 {(b, h, s)}, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if b == 0:                  # no row: empty gradients, no launch
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _check_launch("flash_attention_backward", q, k, v, out, lse, dout)
    # a dh that is a multiple of 8 makes every row stride of the bf16
    # kernels' tensor maps, H dh and Hkv dh elements, 16-byte whole; any
    # other runs on zero-padded copies (the padded columns of out and
    # dout add nothing to D = rowsum(dout * out)), cut back below
    width = pad_width(dh)
    q_in, k_in = q, k
    q, k, v, out, dout = (_padded(x, width) for x in (q, k, v, out, dout))
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    dsum = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        work.count("flash_attention_backward",
                   work.flash_backward(q_in, k_in, causal, window))
    else:
        fn = build.load("flash_attention_bwd").flash_attention_bwd_launch
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                           + [ctypes.c_int] * 8
                           + [ctypes.c_float, ctypes.c_void_p])
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                 dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), b, s, t, h, hkv, width, int(bool(causal)),
                 int(window), 1.0 / math.sqrt(dh), stream)
        if err != 0:
            raise RuntimeError(f"flash_attention_backward launch failed: "
                               f"error {err}")
        flash_attention_backward.launches += 1
    if width != dh:
        dq, dk, dv = (x[..., :dh].contiguous() for x in (dq, dk, dv))
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The kernel pair under autograd: the forward kernel with its LSE,
    the backward kernels on the saved (q, k, v, out, lse).  Under
    ``torch.utils.checkpoint`` the forward runs again in the backward
    pass, and the LSE saved is the recomputed one."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = _launch(q, k, v, causal, window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _launch_backward(q, k, v, out, lse, dout.contiguous(),
                                      ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = -1) -> torch.Tensor:
    """Model layout: q (B, S, H, dh); k, v (B, T, Hkv, dh).  Returns
    (B, S, H, dh).

    CUDA tensors launch the Hopper kernel (or raise), meta tensors
    take the meta branch (``kernels.__init__``); with grad mode on
    and an input that requires grad, the call is the autograd Function
    whose backward is the Hopper backward kernel (there is no fallback to
    the plain version's autograd).  CPU tensors take the plain version,
    which autograd differentiates.  A batch of no rows (B 0) launches
    nothing, forward or backward, and returns empty tensors.
    ``flash_attention.launches`` counts forward launches,
    ``flash_attention_backward.launches`` backward ones."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"no flash_attention for device {q.device}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window)
    return _launch(q, k, v, causal, window)


def flash_attention_forward(q, k, v, *, causal: bool = True,
                            window: int = -1):
    """The forward kernel called directly on CUDA tensors, with the f32
    (B, H, S) log-sum-exp the backward reads: (out, lse).  Counts on
    ``flash_attention.launches``."""
    _check(q, k, v)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError("flash_attention_forward runs on CUDA tensors")
    return _launch(q, k, v, causal, window, with_lse=True)


def flash_attention_backward(q, k, v, out, lse, dout, *, causal: bool = True,
                             window: int = -1):
    """The backward kernels called directly on CUDA tensors: (dq, dk, dv)
    from the forward's ``out`` and ``lse`` and the output gradient
    ``dout``.  ``flash_attention_backward.launches`` counts the calls,
    from here and from autograd."""
    _check(q, k, v)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError("flash_attention_backward runs on CUDA tensors; "
                         "the CPU differentiates flash_attention_plain")
    return _launch_backward(q, k, v, out, lse, dout, causal, window)


flash_attention.launches = 0
flash_attention_backward.launches = 0
