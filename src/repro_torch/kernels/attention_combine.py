"""The log-sum-exp combine of a sequence-sharded ring's partial attention:
the hand-written Hopper kernel, its plain PyTorch version, and the
wrapper the model calls.

Port-side: no Pallas kernel of the reference computes it.  Where the
reference's ``cache_pspecs`` shards a ring's sequence axis (the GQA
fallback over ``model``, ``long_*`` over ``data``), GSPMD reduces the
decode softmax across the shards.  The port's ranks each attend over
their own slots (``decode_attention(..., with_lse=True)``), gather the
partial outputs and log-sum-exps over the ring's group, and combine them
here: mesh-level flash-decoding.  The CUDA source is
``csrc/attention_combine.cu``.

``out = sum_r exp(lse_r - M) out_r / sum_r exp(lse_r - M)``, M the
largest ``lse_r``: a rank whose range held no valid key (``lse =
NEG_INF``) weighs 0, and a row empty on every rank comes out as zeros.
f32 sums; the output takes the inputs' dtype.

Bound on the card: the bytes, ``R * B * H * (dh * sizeof + 4)`` read and
``B * H * dh * sizeof`` written, against 3.35 TB/s of HBM; at a decode
step a few hundred kilobytes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import work
from repro_torch.kernels.attention_shapes import DTYPES
from repro_torch.kernels.grad import refuse_grad

NEG_INF = -1e30
# a log-sum-exp at or below this is a rank with no valid key (NEG_INF)
EMPTY_LSE = 0.5 * NEG_INF


def attention_combine_plain(outs: torch.Tensor,
                            lses: torch.Tensor) -> torch.Tensor:
    """outs (R, B, H, dh), lses (R, B, H) f32 -> (B, H, dh)."""
    valid = lses > EMPTY_LSE
    m = torch.where(valid, lses, NEG_INF).amax(0)             # (B, H)
    w = torch.where(valid, torch.exp(lses - m), 0.0)          # (R, B, H)
    den = w.sum(0)
    num = (w[..., None] * outs.float()).sum(0)
    out = torch.where(den[..., None] > 0,
                      num / den.clamp_min(1e-30)[..., None], 0.0)
    return out.to(outs.dtype)


def _check(outs, lses) -> None:
    if outs.ndim != 4:
        raise ValueError(f"outs must be (R, B, H, dh), got "
                         f"{tuple(outs.shape)}")
    if lses.shape != outs.shape[:3]:
        raise ValueError(f"lses must be {tuple(outs.shape[:3])}, got "
                         f"{tuple(lses.shape)}")
    if lses.dtype != torch.float32:
        raise ValueError(f"lses must be float32, got {lses.dtype}")
    if outs.dtype not in DTYPES:
        raise ValueError(f"no attention_combine for {outs.dtype}")
    if outs.device != lses.device:
        raise ValueError(f"inputs span devices {outs.device} and "
                         f"{lses.device}")
    if 0 in outs.shape:
        raise ValueError(f"empty input {tuple(outs.shape)}")


def _launch(outs, lses) -> torch.Tensor:
    from repro_torch.kernels import build

    r, b, h, dh = outs.shape
    outs, lses = outs.contiguous(), lses.contiguous()
    out = torch.empty((b, h, dh), dtype=outs.dtype, device=outs.device)
    if outs.device.type == "meta":
        work.count("attention_combine", work.combine(outs, lses))
        return out
    fn = build.load("attention_combine").attention_combine_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_void_p])
    stream = torch.cuda.current_stream(outs.device).cuda_stream
    err = fn(DTYPES[outs.dtype], outs.data_ptr(), lses.data_ptr(),
             out.data_ptr(), r, b * h, dh, stream)
    if err != 0:
        raise RuntimeError(f"attention_combine launch failed: error {err}")
    attention_combine.launches += 1
    return out


def attention_combine(outs: torch.Tensor, lses: torch.Tensor
                      ) -> torch.Tensor:
    """outs (R, B, H, dh) f32 or bf16, the R ranks' partial outputs of
    the same query rows; lses (R, B, H) f32 their log-sum-exps (NEG_INF:
    no valid key).  Returns (B, H, dh) in the inputs' dtype.

    CUDA tensors launch the Hopper kernel (or raise), meta tensors
    take the meta branch (``kernels.__init__``); CPU tensors take
    the plain version.  ``attention_combine.launches`` counts the calls
    that launch the kernel.  Serving runs it under no_grad: it has no
    backward and raises under grad (``grad.py``)."""
    _check(outs, lses)
    if outs.device.type == "cpu":
        return attention_combine_plain(outs, lses)
    if outs.device.type not in ("cuda", "meta"):
        raise ValueError(f"no attention_combine for device {outs.device}")
    refuse_grad("attention_combine", outs, lses)
    return _launch(outs, lses)


attention_combine.launches = 0
