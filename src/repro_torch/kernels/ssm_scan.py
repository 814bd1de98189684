"""Chunked decayed linear-recurrence scan (the mamba-2 / SSD form): the
hand-written Hopper kernel, its plain PyTorch version, and the wrapper
the model calls.

Port of the Pallas TPU kernel ``repro/kernels/ssm_scan.py``
(``ssm_scan``), reached in the reference through the model-layout
wrapper ``repro/kernels/ops.py::ssm_scan``.  The CUDA source is
``csrc/ssm_scan.cu``.  On the port's path it is the chunked scan of
every hymba layer's mamba branch at prefill (``models/ssm.py``).

Per (batch, head), with an f32 state ``h`` of (dk, dv):

    h_t = exp(log_a_t) * h_{t-1} + k_t v_t^T,      y_t = q_t . h_t

evaluated chunk-parallel: inside a chunk a causal decay matrix
``exp(L_i - L_j)`` (``L`` the inclusive cumulative sum of ``log_a``,
masked to ``j <= i`` before the exponential, so no ``inf`` appears),
across chunks the carried state.  Returns ``(y, h_T)``; ``y`` takes
``v``'s dtype, ``h_T`` is f32.  A ragged last chunk behaves as if padded
with ``log_a = 0`` and ``k = 0`` (the state passes unchanged), as
``ops.ssm_scan`` pads; the reference model's
``chunked_linear_attention`` instead asserts ``T % chunk == 0``
(ROADMAP §C, fault 3).

Bound on the card: bytes.  q, k, v and y once each plus log_a, h0 and
h_T; the operations, about ``2 * chunk * (2 * dk + dv) + 4 * dk * dv``
per token and head, are far below the card's rate.  The kernel runs
mamba-2's three chunk phases (chunk states, the state pass, chunk
outputs; ``scan_plan``), the third on the tensor cores for bf16 with dk
<= 64.  See the CUDA source for the design.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DK = 512          # mLSTM's head dim
MAX_DV = 1024         # mLSTM's 513 (head dim + the normaliser column)
MAX_CHUNK = 128       # rows of a chunk a CTA holds
TILE = 64             # dv tile of every phase
FAST_MAX_DK = 64      # the tensor-core phase 3 holds q and k whole


@dataclass(frozen=True)
class ScanPlan:
    """What the wrapper needs of one call's three launches: ``nc``
    chunks; phase 3 on the tensor cores when ``fast``; the f32 scratch
    ``states_shape`` (the chunk states, then the states entering each
    chunk) and ``decay_shape`` (exp of each chunk's summed log_a)."""
    nc: int
    fast: bool
    states_shape: tuple
    decay_shape: tuple


def scan_plan(b: int, t: int, h: int, dk: int, dv: int, chunk: int,
              bf16: bool, aligned: bool) -> ScanPlan:
    """The plan from ints only.  ``aligned``: q, k and v rows start on
    16 bytes (strides multiples of 8 elements, 16-byte aligned bases),
    which the tensor-core phase 3 loads 16 bytes at a time."""
    if not (1 <= dk <= MAX_DK and 1 <= dv <= MAX_DV):
        raise ValueError(f"no kernel for dk {dk}, dv {dv} (dk 1..{MAX_DK}, "
                         f"dv 1..{MAX_DV})")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be 1..{MAX_CHUNK}, got {chunk}")
    nc = -(-t // chunk)
    fast = (bf16 and aligned and dk <= FAST_MAX_DK and dk % 8 == 0
            and dv % 8 == 0)
    return ScanPlan(nc=nc, fast=fast, states_shape=(b, h, nc, dk, dv),
                    decay_shape=(b, h, nc))


def ssm_scan_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   log_a: torch.Tensor, h0: torch.Tensor, *,
                   chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """``repro/models/ssm.py::chunked_linear_attention`` with a ragged
    tail padded as ``ops.ssm_scan`` pads it.  q, k (B, T, H, dk); v (B,
    T, H, dv); log_a (B, T, H), <= 0; h0 (B, H, dk, dv).  Returns (y (B,
    T, H, dv) in v's dtype, h_T (B, H, dk, dv) f32)."""
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, t)
    pad = (-t) % chunk
    qf, kf, vf = q.float(), k.float(), v.float()
    la = log_a.float()
    if pad:       # log_a = 0 and k = 0: the state passes the tail unchanged
        qf, kf, vf = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (qf, kf, vf))
        la = F.pad(la, (0, 0, 0, pad))
    nc = (t + pad) // chunk
    qf = qf.reshape(b, nc, chunk, h, dk)
    kf = kf.reshape(b, nc, chunk, h, dk)
    vf = vf.reshape(b, nc, chunk, h, dv)
    la = la.reshape(b, nc, chunk, h)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=q.device))
    state = h0.float()
    ys = []
    for c in range(nc):
        qc, kc, vc = qf[:, c], kf[:, c], vf[:, c]          # (B, C, H, *)
        L = torch.cumsum(la[:, c], dim=1)                   # (B, C, H)
        Lh = L.permute(0, 2, 1)                             # (B, H, C)
        # intra-chunk: S_ij = (q_i . k_j) exp(L_i - L_j), j <= i, masked
        # before the exponential
        scores = torch.einsum("bihd,bjhd->bhij", qc, kc)
        ldiff = Lh[:, :, :, None] - Lh[:, :, None, :]
        decay = torch.exp(ldiff.masked_fill(~causal, float("-inf")))
        y = torch.einsum("bhij,bjhd->bihd", scores * decay, vc)
        # inter-chunk: y_i += exp(L_i) q_i . h_prev
        y = y + torch.einsum("bihd,bhde->bihe", qc * torch.exp(L)[..., None],
                             state)
        # carry: h = exp(L_last) h + sum_j exp(L_last - L_j) k_j v_j^T
        l_last = Lh[:, :, -1]                               # (B, H)
        rem = torch.exp(l_last[:, None, :] - L)             # (B, C, H)
        kv = torch.einsum("bjhd,bjhe->bhde", kc * rem[..., None], vc)
        state = torch.exp(l_last)[..., None, None] * state + kv
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :t]
    return y.to(v.dtype), state


def _check(q, k, v, log_a, h0) -> None:
    if q.ndim != 4 or k.shape != q.shape or v.ndim != 4 \
            or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"q, k must be equal (B, T, H, dk) and v (B, T, H, "
                         f"dv); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, t, h, dk = q.shape
    if t == 0:
        raise ValueError("empty time axis")
    if log_a.shape != (b, t, h):
        raise ValueError(f"log_a must be {(b, t, h)}, got "
                         f"{tuple(log_a.shape)}")
    if h0.shape != (b, h, dk, v.shape[3]):
        raise ValueError(f"h0 must be {(b, h, dk, v.shape[3])}, got "
                         f"{tuple(h0.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must share a dtype")
    devs = {x.device for x in (q, k, v, log_a, h0)}
    if len(devs) != 1:
        raise ValueError(f"inputs span devices {sorted(map(str, devs))}")


def _aligned(q, k, v) -> bool:
    """Rows of q, k and v start on 16 bytes."""
    rows = [x.data_ptr() % 16 == 0 for x in (q, k, v)]
    strides = [s % 8 == 0 for x in (q, k) for s in x.stride()[:3]]
    return all(rows) and all(strides) and v.shape[3] % 8 == 0


def _launch(q, k, v, log_a, h0, chunk: int):
    from repro_torch.kernels import build

    b, t, h, dk = q.shape
    dv = v.shape[3]
    if q.dtype not in DTYPES:
        raise ValueError(f"no kernel for dtype {q.dtype} (dtypes "
                         f"{list(DTYPES)})")
    plan = scan_plan(b, t, h, dk, dv, chunk, q.dtype == torch.bfloat16,
                     _aligned(q, k, v))
    if h * -(-dk // 16) * -(-dv // TILE) > 65535 or b > 65535:
        raise ValueError(f"no kernel for B {b}, H {h} (grid limits)")
    # q and k may broadcast over heads (stride 0): hymba shares one B/C
    # pair among all its SSM heads
    for name, x in (("q", q), ("k", k)):
        if x.stride(3) != 1 and dk > 1:
            raise ValueError(f"{name} must have a unit stride on its last "
                             f"axis")
    if not v.is_contiguous():
        raise ValueError("v must be contiguous")
    la = log_a.float().contiguous()
    h0 = h0.float().contiguous()
    fn = build.load("ssm_scan").ssm_scan_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                       + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 6
                       + [ctypes.c_void_p])
    y = torch.empty_like(v)
    h_t = torch.empty_like(h0)
    states = torch.empty(plan.states_shape, dtype=torch.float32,
                         device=q.device)
    decay = torch.empty(plan.decay_shape, dtype=torch.float32,
                        device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             la.data_ptr(), h0.data_ptr(), y.data_ptr(), h_t.data_ptr(),
             states.data_ptr(), decay.data_ptr(), b, t, h, dk, dv, chunk,
             int(plan.fast), *q.stride()[:3], *k.stride()[:3], stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan launch failed: error {err}")
    ssm_scan.launches += 1
    return y, h_t


def ssm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_a: torch.Tensor, h0: torch.Tensor, *,
             chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """Model layout: q, k (B, T, H, dk); v (B, T, H, dv); log_a (B, T, H);
    h0 (B, H, dk, dv).  Returns (y (B, T, H, dv), h_T (B, H, dk, dv)
    f32).  Any T: a ragged last chunk is handled, not refused.

    CUDA tensors launch the Hopper kernels (or raise); CPU tensors take
    the plain version.  ``ssm_scan.launches`` counts calls that launched
    the kernels (three launches each, one count)."""
    _check(q, k, v, log_a, h0)
    if q.device.type == "cpu":
        return ssm_scan_plain(q, k, v, log_a, h0, chunk=chunk)
    if q.device.type != "cuda":
        raise ValueError(f"no ssm_scan for device {q.device}")
    return _launch(q, k, v, log_a, h0, min(chunk, q.shape[1]))


ssm_scan.launches = 0
