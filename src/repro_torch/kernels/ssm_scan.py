"""Chunked decayed linear-recurrence scan (the mamba-2 / SSD form): the
hand-written Hopper kernel, its plain PyTorch version, and the wrapper
the model calls.

Port of the Pallas TPU kernel ``repro/kernels/ssm_scan.py``
(``ssm_scan``), reached in the reference through the model-layout
wrapper ``repro/kernels/ops.py::ssm_scan``.  The CUDA source is
``csrc/ssm_scan.cu``.  On the port's path it is the chunked scan of
every hymba layer's mamba branch and every xLSTM mLSTM layer at prefill
(``models/ssm.py``).

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

Training differentiates it: under grad the wrapper is an autograd
Function whose forward keeps the kernel's chunk-entry states and whose
backward is the hand-written Hopper kernel of ``csrc/ssm_scan_bwd.cu``
(``ssm_scan_backward``: gradients of q, k, v, log_a and h0 from those of
y and h_T, chunk-parallel in reverse and deterministic; the reference has
no backward kernel, JAX differentiates its jnp scan).  Its bound is
bytes too.  ``backward_plan`` picks its route: where dk and dv are at
most 64 (hymba) one fused pass per chunk builds the decayed pair
matrices in registers and never writes them (four launches: U, the
reverse state pass, the chunk pass, dlog_a's suffix sums); above that
(the mLSTM's dk 512, dv 513) a pair pass writes P and W once per chunk
in the input type for tile passes over dk and dv (six launches).  bf16
runs the products on the tensor cores, f32 in FMAs on the CUDA cores.

Both directions take any dk and dv: every pass walks them in tiles
(the forward's state tiles of up to 64 x 64 and dk tiles of 32, the
backward's 64-column tiles), so the only refusals are the grids' limits
(``scan_plan``, ``backward_plan``).  xLSTM's mLSTM at the paper's 1.3B
width (d_model 2048) scans at dk 1024 and dv 1025, at 2.7B at 1280 and
1281; their f32 chunk states are ``B H nc dk dv`` floats, 0.54 GB at B 4,
T 1024, H 4 and dk 1024.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.kernels import work

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 128       # rows of a chunk a CTA holds
GRID_ROWS = 65535     # a grid's y and z
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


def _check_grid(b: int, dk: int, dv: int, rows: dict) -> None:
    """Raise ``ValueError``, naming the launch, where a grid passes the
    card's limits: ``rows`` maps each launch to its grid's y (heads x
    tiles), each at most ``GRID_ROWS``; z is B; the state passes take
    ``ceil(dk dv / 256)`` CTAs in x, below 2^31."""
    if b > GRID_ROWS:
        raise ValueError(f"no kernel for B {b}: the grids' z, at most "
                         f"{GRID_ROWS}")
    if -(-dk * dv // 256) >= 2 ** 31:
        raise ValueError(f"no kernel for dk {dk} x dv {dv}: the state "
                         f"pass's grid x, below 2^31")
    for name, y in rows.items():
        if y > GRID_ROWS:
            raise ValueError(f"no kernel for dk {dk}, dv {dv}: {name}'s "
                             f"grid has {y} rows, at most {GRID_ROWS}")


def scan_plan(b: int, t: int, h: int, dk: int, dv: int, chunk: int,
              bf16: bool, aligned: bool) -> ScanPlan:
    """The plan from ints only.  ``aligned``: q, k and v rows start on
    16 bytes (strides multiples of 8 elements, 16-byte aligned bases),
    which the tensor-core phase 3 loads 16 bytes at a time.  Any dk and
    dv from 1: only the grids' limits refuse (``_check_grid``)."""
    if dk < 1 or dv < 1:
        raise ValueError(f"no kernel for dk {dk}, dv {dv} (dk and dv from "
                         f"1)")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be 1..{MAX_CHUNK}, got {chunk}")
    dkr = 16 if dk <= 16 else 32 if dk <= 32 else TILE
    _check_grid(b, dk, dv, {"the chunk-state pass": h * -(-dk // dkr)
                            * -(-dv // TILE)})
    nc = -(-t // chunk)
    fast = (bf16 and aligned and dk <= FAST_MAX_DK and dk % 8 == 0
            and dv % 8 == 0)
    return ScanPlan(nc=nc, fast=fast, states_shape=(b, h, nc, dk, dv),
                    decay_shape=(b, h, nc))


FUSED_MAX = 64        # dk and dv the backward's fused chunk pass holds


@dataclass(frozen=True)
class BackwardPlan:
    """What the wrapper needs of one backward call: the fused chunk pass
    (``fused``, four launches) or the tiled one (six); ``n_parts`` parts
    of r a row (q . dq and -k . dk per 64 columns of dk in the tiled
    pass); ``states_shape`` of the reverse chunk states (their rows padded
    to a multiple of 8 in the tiled pass); the pair scratch ``pw_shape``
    (the tiled pass's, in the input type) or None."""
    nc: int
    fused: bool
    n_parts: int
    states_shape: tuple
    pw_shape: tuple | None


def backward_plan(b: int, t: int, h: int, dk: int, dv: int, chunk: int,
                  vec: int, aligned: bool) -> BackwardPlan:
    """The backward's plan from ints only.  ``vec``: elements of 16 bytes
    (8 bf16, 4 f32); ``aligned``: q, k, v and dy rows start on 16 bytes,
    which the fused pass loads 16 bytes at a time."""
    scan_plan(b, t, h, dk, dv, chunk, False, False)     # the size checks
    n_dvt = -(-dv // TILE)
    _check_grid(b, dk, dv, {"the pair pass": h * 2 * -(-chunk // TILE),
                            "the U pass": h * -(-dk // 128) * n_dvt,
                            "the dq/dk pass": h * -(-dk // TILE) * 2,
                            "the dv pass": h * n_dvt})
    nc = -(-t // chunk)
    fused = (aligned and dk <= FUSED_MAX and dv <= FUSED_MAX
             and dk % vec == 0 and dv % vec == 0)
    if fused:
        return BackwardPlan(nc=nc, fused=True, n_parts=1,
                            states_shape=(b, h, nc, dk, dv), pw_shape=None)
    return BackwardPlan(nc=nc, fused=False, n_parts=2 * -(-dk // TILE),
                        states_shape=(b, h, nc, dk, -(-dv // 8) * 8),
                        pw_shape=(b, h, nc, 2, chunk, chunk))


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


def ssm_scan_backward_plain(q, k, v, log_a, h0, dy, dh_t=None, *,
                            chunk: int = 128):
    """(dq, dk, dv, dlog_a, dh0): autograd through ``ssm_scan_plain`` for
    the gradients ``dy`` of y and ``dh_t`` of h_T (None: no gradient
    reaches h_T), the backward's plain version."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(True) for t in (q, k, v, log_a, h0)]
        y, h_t = ssm_scan_plain(*xs, chunk=chunk)
        outs, grads = [y], [dy]
        if dh_t is not None:
            outs.append(h_t)
            grads.append(dh_t)
        return torch.autograd.grad(outs, xs, grads)


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


def _rows16(q, k, *rows, vec: int = 8) -> bool:
    """Rows of q, k and the contiguous ``rows`` start on 16 bytes: every
    base 16-byte aligned and q's and k's strides multiples of ``vec``
    elements (16 bytes of their type)."""
    bases = [x.data_ptr() % 16 == 0 for x in (q, k, *rows)]
    strides = [s % vec == 0 for x in (q, k) for s in x.stride()[:3]]
    return all(bases) and all(strides)


def _launch(q, k, v, log_a, h0, chunk: int, keep_states: bool = False):
    """The forward kernels.  Returns (y, h_T), or (y, h_T, states) with
    the f32 (B, H, nc, dk, dv) states entering each chunk, which the
    backward reads, when ``keep_states``."""
    from repro_torch.kernels import build

    b, t, h, dk = q.shape
    dv = v.shape[3]
    if q.dtype not in DTYPES:
        raise ValueError(f"no kernel for dtype {q.dtype} (dtypes "
                         f"{list(DTYPES)})")
    if b == 0:
        # a rank that holds no row of a batch split: no launch (a grid of
        # no CTAs is not a launch), nothing counted
        f32 = dict(dtype=torch.float32, device=q.device)
        y, h_t = torch.empty_like(v), torch.empty((0, h, dk, dv), **f32)
        states = torch.empty((0, h, -(-t // chunk), dk, dv), **f32)
        return (y, h_t, states) if keep_states else (y, h_t)
    plan = scan_plan(b, t, h, dk, dv, chunk, q.dtype == torch.bfloat16,
                     _rows16(q, k, v))
    _check_qk_strides(q, k)
    if not v.is_contiguous():
        raise ValueError("v must be contiguous")
    la = log_a.float().contiguous()
    h0_in, h0 = h0, h0.float().contiguous()
    y = torch.empty_like(v)
    h_t = torch.empty_like(h0)
    states = torch.empty(plan.states_shape, dtype=torch.float32,
                         device=q.device)
    decay = torch.empty(plan.decay_shape, dtype=torch.float32,
                        device=q.device)
    if q.device.type == "meta":
        work.count("ssm_scan", work.scan(q, k, v, log_a, h0_in, chunk))
        return (y, h_t, states) if keep_states else (y, h_t)
    fn = build.load("ssm_scan").ssm_scan_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                       + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 6
                       + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             la.data_ptr(), h0.data_ptr(), y.data_ptr(), h_t.data_ptr(),
             states.data_ptr(), decay.data_ptr(), b, t, h, dk, dv, chunk,
             int(plan.fast), *q.stride()[:3], *k.stride()[:3], stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan launch failed: error {err}")
    ssm_scan.launches += 1
    return (y, h_t, states) if keep_states else (y, h_t)


def _check_qk_strides(q, k) -> None:
    # q and k may broadcast over heads (stride 0): hymba shares one B/C
    # pair among all its SSM heads
    for name, x in (("q", q), ("k", k)):
        if x.stride(3) != 1 and x.shape[3] > 1:
            raise ValueError(f"{name} must have a unit stride on its last "
                             f"axis")


def _launch_backward(q, k, v, la, states, h_t, dy, dh_t, chunk: int):
    """The backward kernels (``csrc/ssm_scan_bwd.cu``) on the current
    stream, from the forward's f32 ``la`` and chunk-entry ``states`` (and
    ``h_t`` when ``dh_t`` is given): (dq, dk, dv, dlog_a f32, dh0 f32),
    dq and dk full (B, T, H, dk) even where q and k broadcast over heads.
    Scratch: U (the size of ``states``; the reverse states over it when
    fused), r's parts and, in the tiled pass only, the reverse states and
    the pair matrices in q's type.  One call counts one launch."""
    from repro_torch.kernels import build

    b, t, h, dk = q.shape
    dv = v.shape[3]
    if q.dtype not in DTYPES:
        raise ValueError(f"no kernel for dtype {q.dtype} (dtypes "
                         f"{list(DTYPES)})")
    if b == 0:                  # no row: empty gradients, no launch
        f32 = dict(dtype=torch.float32, device=q.device)
        return (torch.empty_like(q), torch.empty_like(k),
                torch.empty_like(v), torch.empty((0, t, h), **f32),
                torch.empty((0, h, dk, dv), **f32))
    vec = 16 // q.element_size()
    plan = backward_plan(b, t, h, dk, dv, chunk, vec,
                         _rows16(q, k, v, dy, vec=vec))
    nc = plan.nc
    if dy.shape != v.shape or dy.dtype != v.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match "
                         f"y {tuple(v.shape)} {v.dtype}")
    if states.shape != (b, h, nc, dk, dv) or states.dtype != torch.float32:
        raise ValueError(f"states must be f32 {(b, h, nc, dk, dv)}, got "
                         f"{tuple(states.shape)} {states.dtype}")
    _check_qk_strides(q, k)
    for name, x in (("v", v), ("dy", dy), ("log_a", la),
                    ("states", states)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dh_t is not None:
        dh_t = dh_t.float().contiguous()
        h_t = h_t.float().contiguous()
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    dq = torch.empty((b, t, h, dk), dtype=q.dtype, device=dev)
    dk_ = torch.empty((b, t, h, dk), dtype=q.dtype, device=dev)
    dv_ = torch.empty_like(v)
    dla = torch.empty((b, t, h), **f32)
    dh0 = torch.empty((b, h, dk, dv), **f32)
    us = torch.empty(plan.states_shape, **f32)      # U (and D, fused)
    decay = torch.empty((b, h, nc), **f32)
    parts = torch.empty((b, t, h, plan.n_parts), **f32)
    tiled = dict(dtype=q.dtype, device=dev)
    ds = None if plan.fused else torch.empty(plan.states_shape, **tiled)
    pw = None if plan.fused else torch.empty(plan.pw_shape, **tiled)
    if dev.type == "meta":
        work.count("ssm_scan_backward", work.scan_backward(q, k, v, states))
        return dq, dk_, dv_, dla, dh0
    fn = build.load("ssm_scan_bwd").ssm_scan_bwd_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 18
                       + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 6
                       + [ctypes.c_void_p])
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             la.data_ptr(), dy.data_ptr(), states.data_ptr(), ptr(dh_t),
             ptr(h_t if dh_t is not None else None), dq.data_ptr(),
             dk_.data_ptr(), dv_.data_ptr(), dla.data_ptr(), dh0.data_ptr(),
             us.data_ptr(), ptr(ds), decay.data_ptr(), parts.data_ptr(),
             ptr(pw), b, t, h, dk, dv, chunk, int(plan.fused),
             *q.stride()[:3], *k.stride()[:3], stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan_backward launch failed: error {err}")
    ssm_scan_backward.launches += 1
    return dq, dk_, dv_, dla, dh0


class _SsmScan(torch.autograd.Function):
    """The kernel pair under autograd: the forward kernels keeping their
    chunk-entry states, the backward kernels on the saved (q, k, v, f32
    log_a, states, h_T).  A gradient that reaches neither output stays
    None (no zeros are made for h_T's)."""

    @staticmethod
    def forward(ctx, q, k, v, log_a, h0, chunk: int):
        ctx.set_materialize_grads(False)
        y, h_t, states = _launch(q, k, v, log_a, h0, chunk, keep_states=True)
        ctx.save_for_backward(q, k, v, log_a.float().contiguous(), states,
                              h_t)
        ctx.chunk, ctx.la_dtype = chunk, log_a.dtype
        return y, h_t

    @staticmethod
    def backward(ctx, dy, dh_t):
        q, k, v, la, states, h_t = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(v)
        dq, dk, dv, dla, dh0 = _launch_backward(
            q, k, v, la, states, h_t, dy.contiguous(), dh_t, ctx.chunk)
        return dq, dk, dv, dla.to(ctx.la_dtype), dh0, None


def ssm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_a: torch.Tensor, h0: torch.Tensor, *,
             chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """Model layout: q, k (B, T, H, dk); v (B, T, H, dv); log_a (B, T, H);
    h0 (B, H, dk, dv).  Returns (y (B, T, H, dv), h_T (B, H, dk, dv)
    f32).  Any T: a ragged last chunk is handled, not refused.

    CUDA tensors launch the Hopper kernels (or raise), meta tensors
    take the meta branch (``kernels.__init__``); with grad mode on
    and an input that requires grad, the call is the autograd Function
    whose backward is the Hopper backward kernel (there is no fallback to
    the plain version's autograd).  CPU tensors take the plain version,
    which autograd differentiates.  A batch of no rows (B 0) launches
    nothing, forward or backward, and returns empty tensors.
    ``ssm_scan.launches`` counts calls that launched the forward kernels
    (three launches each, one count), ``ssm_scan_backward.launches``
    backward calls (four launches at hymba's width, six at the mLSTM's;
    one count)."""
    _check(q, k, v, log_a, h0)
    if q.device.type == "cpu":
        return ssm_scan_plain(q, k, v, log_a, h0, chunk=chunk)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"no ssm_scan for device {q.device}")
    chunk = min(chunk, q.shape[1])
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v, log_a, h0)):
        return _SsmScan.apply(q, k, v, log_a, h0, chunk)
    return _launch(q, k, v, log_a, h0, chunk)


def ssm_scan_backward(q, k, v, log_a, h0, dy, dh_t=None, *,
                      chunk: int = 128):
    """The forward kernels (for their chunk-entry states) and then the
    backward kernels, called directly on CUDA tensors: (dq, dk, dv,
    dlog_a, dh0) for the gradients ``dy`` of y and ``dh_t`` of h_T (None:
    none reaches it).  Counts one launch on ``ssm_scan`` and one on
    ``ssm_scan_backward.launches``."""
    _check(q, k, v, log_a, h0)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError("ssm_scan_backward runs on CUDA tensors; the CPU "
                         "differentiates ssm_scan_plain")
    chunk = min(chunk, q.shape[1])
    _, h_t, states = _launch(q, k, v, log_a, h0, chunk, keep_states=True)
    dq, dk, dv, dla, dh0 = _launch_backward(
        q, k, v, log_a.float().contiguous(), states, h_t, dy.contiguous(),
        dh_t, chunk)
    return dq, dk, dv, dla.to(log_a.dtype), dh0


ssm_scan.launches = 0
ssm_scan_backward.launches = 0
