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
its MXU work), at decode and, on the tensor cores, at prefill too.  bf16
with ``f`` and ``d`` multiples of 8 runs on the tensor cores; f32 and
ragged widths on the CUDA cores.  See the CUDA source for the design.
"""
from __future__ import annotations

import ctypes

import torch

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the CUDA source's paths: f32 FMAs a column at a time, f32 FMAs four
# columns a load (f % 4 == 0, w 16-byte aligned), bf16 on the tensor cores
# (f and d multiples of 8, x and w 16-byte aligned)
PATH_ONE_COLUMN, PATH_FOUR_COLUMNS, PATH_TENSOR_CORES = 0, 1, 2


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
    """Which of the CUDA source's kernels takes these inputs."""
    d, f = w.shape[1], w.shape[2]
    w_aligned = w.data_ptr() % 16 == 0
    if x.dtype == torch.bfloat16 and f % 8 == 0 and d % 8 == 0 \
            and w_aligned and x.data_ptr() % 16 == 0:
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
    fn = build.load("grouped_matmul").grouped_matmul_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), counts.data_ptr(),
             out.data_ptr(), e, c, d, f, kernel_path(x, w), stream)
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
