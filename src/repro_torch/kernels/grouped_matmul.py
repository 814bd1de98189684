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
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

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
    lib = build.load("grouped_matmul")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    path = kernel_path(x, w)
    if path == PATH_TENSOR_CORES:
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


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   counts: torch.Tensor) -> torch.Tensor:
    """x (E, C, d) @ w (E, d, f) -> (E, C, f) in x's dtype; counts (E,)
    int32, the live rows of each expert (clamped to [0, C]); rows past
    them are zeros.

    CUDA tensors launch the Hopper kernel (or raise); CPU tensors take
    the plain version.  ``grouped_matmul.launches`` counts kernel
    launches."""
    _check(x, w, counts)
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, counts)
    if x.device.type != "cuda":
        raise ValueError(f"no grouped_matmul for device {x.device}")
    return _launch(x, w, counts)


grouped_matmul.launches = 0
