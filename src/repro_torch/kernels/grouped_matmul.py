"""Grouped (per-expert) matrix product of the MoE FFN: the hand-written
Hopper kernel, its plain PyTorch version, and the wrapper the model
calls.

Port of the Pallas TPU kernel ``repro/kernels/grouped_matmul.py``
(``grouped_matmul``), reached in the reference through the wrapper
``repro/kernels/ops.py::grouped_matmul`` (oracle
``repro/kernels/ref.py::grouped_matmul_ref``).  The CUDA source is
``csrc/grouped_matmul.cu``.  On the port's path it is each of the three
expert products of every MoE layer under ``cfg.use_pallas``
(``models/moe.py``).

``out[e] = x[e] @ w[e]`` for the ``(E, C, d)`` dispatch buffer and ``w
(E, d, f)``, accumulated in f32 and written in ``x``'s dtype; rows
``r >= counts[e]`` come out as zeros.  The kernel takes the real ``C``,
``d`` and ``f`` (no padding to 128, as ``ops.grouped_matmul`` pads).

Bound on the card: the bytes of the live experts' weights (a row block
at or past ``counts[e]`` never reads ``w[e]``, as the TPU kernel skips
its MXU work), at decode and at prefill.  bf16 with ``f`` and ``d``
multiples of 8 runs the persistent TMA + wgmma kernel, planned here from
ints only (``tma_plan``); f32 and ragged widths the CUDA-core kernel.
Neither the wrapper nor the kernels read ``counts`` on the host.  See
the CUDA source for the design.

Training differentiates it: under grad the wrapper is an autograd
Function whose backward is the hand-written Hopper kernel of
``csrc/grouped_matmul_bwd.cu`` (``grouped_matmul_backward``: dX = dOut
w^T over the live rows, dW = x^T dOut over them, both deterministic; the
reference has no backward kernel, JAX differentiates its einsums).  Its
bound is bytes too: the live experts' weights read for dX, E * d * f
written for dW.  bf16 at widths of 8 runs two persistent TMA + wgmma
kernels (dX as the forward's swap-AB pipeline, dW writing 128 x 256
tiles by TMA stores); the rest the CUDA cores.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import work

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the CUDA source's paths: f32 FMAs a column at a time, f32 FMAs four
# columns a load (f % 4 == 0, w 16-byte aligned), bf16 on the tensor cores
# through TMA (f and d multiples of 8, x and w 16-byte aligned, E <= 1024)
PATH_ONE_COLUMN, PATH_FOUR_COLUMNS, PATH_TENSOR_CORES = 0, 1, 2

TF = 64                 # output columns per w box (csrc TF)
CONSUMERS = 2           # consumer warpgroups per CTA (csrc NWG)
MAX_TMA_EXPERTS = 1024  # the shared live list (csrc MAX_E)
ROWS = tuple(range(8, 72, 8))  # rows of a unit: wgmma's N
DECODE_C = 16           # the largest C of the decode shapes


@dataclass(frozen=True)
class TmaPlan:
    """How the TMA kernel covers an (E, C, d) x (E, d, f) product: units
    of ``rows`` rows x ``cols`` columns (``m_tiles`` w boxes per consumer
    warpgroup) over the whole of d, walked by ``grid`` persistent CTAs,
    with evict-first / last L2 hints on the w / x loads when
    ``l2_hints``."""
    rows: int
    row_blocks: int
    m_tiles: int
    l2_hints: bool
    cols: int
    tiles: int
    grid: int


def tma_plan(c: int, f: int, n_sm: int) -> TmaPlan:
    """The launch plan from ints only (no device value): rows per unit the
    smallest multiple of 8 that holds C, else blocks of 64; one CTA per
    SM; units of 128 columns up to C = 16 (decode) and of 256 with L2
    hints past it, each measured the faster there (PERF.md §6)."""
    rows = next((r for r in ROWS if c <= r), ROWS[-1])
    m_tiles = 1 if c <= DECODE_C else 2
    cols = TF * CONSUMERS * m_tiles
    return TmaPlan(rows=rows, row_blocks=-(-c // rows), m_tiles=m_tiles,
                   l2_hints=c > DECODE_C, cols=cols, tiles=-(-f // cols),
                   grid=n_sm)


_SM_COUNT: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The device's SM count, read once from its properties."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                         counts: torch.Tensor) -> torch.Tensor:
    """``ref.grouped_matmul_ref``: an f32 product, rows past ``counts``
    zeroed, cast to ``x``'s dtype."""
    out = torch.einsum("ecd,edf->ecf", x.float(), w.float())
    row = torch.arange(x.shape[1], device=x.device)[None, :, None]
    live = row < counts.to(x.device)[:, None, None]
    return torch.where(live, out, 0.0).to(x.dtype)


def grouped_matmul_backward_plain(x: torch.Tensor, w: torch.Tensor,
                                  counts: torch.Tensor, dout: torch.Tensor):
    """(dx, dw): autograd through ``grouped_matmul_plain``, the backward's
    plain version."""
    with torch.enable_grad():
        xx, ww = (t.detach().requires_grad_(True) for t in (x, w))
        out = grouped_matmul_plain(xx, ww, counts)
        return torch.autograd.grad(out, (xx, ww), dout)


def _check(x, w, counts) -> None:
    if x.ndim != 3 or w.ndim != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"x must be (E, C, d) and w (E, d, f); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if counts.shape != (x.shape[0],):
        raise ValueError(f"counts must be ({x.shape[0]},), got "
                         f"{tuple(counts.shape)}")
    if x.dtype != w.dtype:
        raise ValueError(f"x and w must share a dtype: {x.dtype}, {w.dtype}")
    devs = {t.device for t in (x, w, counts)}
    if len(devs) != 1:
        raise ValueError(f"inputs span devices {sorted(map(str, devs))}")


def kernel_path(x: torch.Tensor, w: torch.Tensor) -> int:
    """Which of the CUDA source's kernels takes these inputs: TMA needs
    16-byte aligned bases and 16-byte row strides (d and f multiples of
    8), and the live list holds at most 1024 experts."""
    d, f = w.shape[1], w.shape[2]
    w_aligned = w.data_ptr() % 16 == 0
    if x.dtype == torch.bfloat16 and f % 8 == 0 and d % 8 == 0 \
            and w_aligned and x.data_ptr() % 16 == 0 \
            and x.shape[0] <= MAX_TMA_EXPERTS:
        return PATH_TENSOR_CORES
    if f % 4 == 0 and w_aligned:
        return PATH_FOUR_COLUMNS
    return PATH_ONE_COLUMN


def _launch(x, w, counts) -> torch.Tensor:
    from repro_torch.kernels import build

    e, c, d = x.shape
    f = w.shape[2]
    if x.dtype not in DTYPES:
        raise ValueError(f"no kernel for dtype {x.dtype} (dtypes "
                         f"{list(DTYPES)})")
    if counts.dtype != torch.int32:
        raise ValueError(f"counts must be int32, got {counts.dtype}")
    if e > 65535 or -(-c // 32) > 65535:
        raise ValueError(f"no kernel for E {e}, C {c} (grid limits)")
    for name, t in (("x", x), ("w", w), ("counts", counts)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0 or d == 0:
        return out.zero_()
    if x.device.type == "meta":
        work.count("grouped_matmul", work.grouped_matmul(
            x, w, counts, *work.live_rows(counts, c)))
        return out
    lib = build.load("grouped_matmul")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    path = kernel_path(x, w)
    if path == PATH_TENSOR_CORES:
        # the kernel's CUtensorMaps are __grid_constant__ parameters
        # encoded on the host at each launch; under a CUDA graph they are
        # encoded at capture and baked into the graph, so they stay right
        # only while x, w and out keep their addresses.  They do: x and
        # out live in the graph's memory pool and w is a weight.  The SM
        # count is read and the CUDA driver's encoder fetched at the first
        # launch, which a capture's eager warm-up makes.
        plan = tma_plan(c, f, sm_count(x.device))
        fn = lib.grouped_matmul_tma_launch
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                           + [ctypes.c_void_p])
        err = fn(x.data_ptr(), w.data_ptr(), counts.data_ptr(),
                 out.data_ptr(), e, c, d, f, plan.rows, plan.m_tiles,
                 plan.grid, int(plan.l2_hints), stream)
    else:
        fn = lib.grouped_matmul_launch
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                           + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        err = fn(DTYPES[x.dtype], x.data_ptr(), w.data_ptr(),
                 counts.data_ptr(), out.data_ptr(), e, c, d, f, path, stream)
    if err != 0:
        raise RuntimeError(f"grouped_matmul launch failed: error {err}")
    grouped_matmul.launches += 1
    return out


def tensor_core_backward(x, w, dout) -> bool:
    """The backward's TMA + wgmma kernels take bf16 with d and f multiples
    of 8 (16-byte rows for the tensor maps) and 16-byte aligned x, w and
    dout, at any E (past 1024 experts dX walks every expert instead of a
    shared list of the live ones); the rest runs on the CUDA cores."""
    d, f = w.shape[1], w.shape[2]
    return (x.dtype == torch.bfloat16 and d % 8 == 0 and f % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, w, dout)))


def _launch_backward(x, w, counts, dout, need_dx: bool = True,
                     need_dw: bool = True):
    """The backward kernels (``csrc/grouped_matmul_bwd.cu``) on the current
    stream: (dx or None, dw or None) in x's dtype.  One call counts one
    launch."""
    from repro_torch.kernels import build

    e, c, d = x.shape
    f = w.shape[2]
    if x.dtype not in DTYPES:
        raise ValueError(f"no kernel for dtype {x.dtype} (dtypes "
                         f"{list(DTYPES)})")
    if counts.dtype != torch.int32:
        raise ValueError(f"counts must be int32, got {counts.dtype}")
    if dout.shape != (e, c, f) or dout.dtype != x.dtype:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not "
                         f"match out {(e, c, f)} {x.dtype}")
    if e > 65535 or -(-c // 64) > 65535 or -(-d // 64) > 65535:
        raise ValueError(f"no kernel for E {e}, C {c}, d {d} (grid limits)")
    for name, t in (("x", x), ("w", w), ("counts", counts),
                    ("dout", dout)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dx = torch.empty_like(x) if need_dx else None
    dw = torch.empty_like(w) if need_dw else None
    if x.numel() == 0 or w.numel() == 0:
        return (dx.zero_() if need_dx else None,
                dw.zero_() if need_dw else None)
    if x.device.type == "meta":
        rows, live = work.live_rows(counts, c)
        part = "both" if need_dx and need_dw else "dx" if need_dx else "dw"
        work.count("grouped_matmul_backward", work.grouped_matmul_backward(
            x, w, counts, rows, live, part))
        return dx, dw
    fn = build.load("grouped_matmul_bwd").grouped_matmul_bwd_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), counts.data_ptr(),
             dout.data_ptr(), dx.data_ptr() if need_dx else None,
             dw.data_ptr() if need_dw else None, e, c, d, f,
             int(tensor_core_backward(x, w, dout)), stream)
    if err != 0:
        raise RuntimeError(f"grouped_matmul_backward launch failed: error "
                           f"{err}")
    grouped_matmul_backward.launches += 1
    return dx, dw


class _GroupedMatmul(torch.autograd.Function):
    """The kernel pair under autograd: the forward kernel, and the backward
    kernels on the saved (x, w, counts).  Under ``torch.utils.checkpoint``
    the forward runs again in the backward pass (one more forward
    launch)."""

    @staticmethod
    def forward(ctx, x, w, counts):
        ctx.save_for_backward(x, w, counts)
        return _launch(x, w, counts)

    @staticmethod
    def backward(ctx, dout):
        x, w, counts = ctx.saved_tensors
        dx, dw = _launch_backward(x, w, counts, dout.contiguous(),
                                  ctx.needs_input_grad[0],
                                  ctx.needs_input_grad[1])
        return dx, dw, None


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   counts: torch.Tensor) -> torch.Tensor:
    """x (E, C, d) @ w (E, d, f) -> (E, C, f) in x's dtype; counts (E,)
    int32, the live rows of each expert (clamped to [0, C]); rows past
    them are zeros.

    CUDA tensors launch the Hopper kernel (or raise), meta tensors
    take the meta branch (``kernels.__init__``); with grad mode on
    and x or w requiring grad, the call is the autograd Function whose
    backward is the Hopper backward kernel (there is no fallback to the
    plain version's autograd).  CPU tensors take the plain version, which
    autograd differentiates.  ``grouped_matmul.launches`` counts forward
    launches, ``grouped_matmul_backward.launches`` backward ones."""
    _check(x, w, counts)
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, counts)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"no grouped_matmul for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _GroupedMatmul.apply(x, w, counts)
    return _launch(x, w, counts)


def grouped_matmul_backward(x, w, counts, dout):
    """The backward kernels called directly on CUDA tensors: (dx, dw) of
    ``out = grouped_matmul(x, w, counts)`` for the output gradient
    ``dout``.  ``grouped_matmul_backward.launches`` counts the calls, from
    here and from autograd."""
    _check(x, w, counts)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError("grouped_matmul_backward runs on CUDA tensors; the "
                         "CPU differentiates grouped_matmul_plain")
    return _launch_backward(x, w, counts, dout)


grouped_matmul.launches = 0
grouped_matmul_backward.launches = 0
