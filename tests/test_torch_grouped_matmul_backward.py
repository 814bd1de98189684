"""The ``grouped_matmul`` backward on the CPU: its plain version against
the JAX package, and an emulation of the CUDA kernels' walks against the
plain version.

* ``grouped_matmul_backward_plain`` (autograd through the port's plain
  product) against ``jax.grad`` of the reference's oracle
  (``repro/kernels/ref.py::grouped_matmul_ref``): dx and dw within 2e-5
  of each output's largest magnitude (f32), for counts of 0, of C and
  ragged.
* ``walk``: the kernels of ``csrc/grouped_matmul_bwd.cu`` in PyTorch.
  dX, the forward's swap-AB pipeline: units of N rows of C (the
  smallest of 8, 16, 32, 48, 64, 96, 128 that holds C, else blocks of
  128) by 128 columns of d, f consumed 64 a stage; a unit past an
  expert's count is never walked (its weights are not read) and rows
  past the count are written as zeros.  dW: output tiles of 128 rows of
  d by 256 columns of f over the live rows of C, 64 a stage, each stage
  rounded up to 16 rows with the rows from the count to that multiple
  of 16 zeroed first (they hold NaN here); an expert no token chose gets
  zero tiles, nothing read.  Inputs widened to f32 from their type (bf16
  operands are exact in the tensor cores' f32 accumulators), outputs
  rounded once.  Dead rows of x and dOut and the weights of empty
  experts hold NaN, which the walk must not read.  Held to the plain
  backward within 2e-5 (f32) and 2e-2 (bf16) of each output's largest
  magnitude, dead rows of dx and empty experts' dw exactly zero.
* ``tensor_core_backward``: which inputs the TMA + wgmma kernels take.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import grouped_matmul_ref  # noqa: E402
from repro_torch.kernels.grouped_matmul import (  # noqa: E402
    grouped_matmul_backward_plain, grouped_matmul_plain,
    tensor_core_backward)

BAND = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
DX_UNIT_ROWS = (8, 16, 32, 48, 64, 96, 128)   # dX: N of a unit
DX_COLS = 128          # dX: columns of d a unit (two warpgroups of 64)
DW_ROWS, DW_COLS = 128, 256   # dW: an output tile, rows of d x columns of f
STAGE, K_STEP = 64, 16        # rows or columns a stage; a wgmma k-step
# e, c, d, f, counts
CASES = [(4, 8, 64, 32, [8, 3, 0, 5]),
         (3, 88, 96, 72, [88, 40, 0]),
         (2, 130, 40, 24, [130, 129]),
         (3, 24, 60, 36, [24, 0, 7]),
         (2, 16, 32, 16, [0, 0]),
         (6, 40, 136, 264, [0, 1, 15, 16, 17, 40]),
         (2, 200, 144, 520, [200, 65])]
IDS = ["decode", "arctic-train-C", "two-row-blocks", "widths-not-of-8",
       "no-token", "counts-at-16-edges", "two-tiles-and-stages"]


def gm_inputs(e, c, d, f, counts, dtype, seed=0, poison=True):
    """``poison`` puts NaN in the rows of x and dout past each count and
    in the weights of every empty expert."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((e, c, d))).float()
    w = torch.from_numpy(rng.standard_normal((e, d, f)) / np.sqrt(d)).float()
    dout = torch.from_numpy(rng.standard_normal((e, c, f))).float()
    cnt = torch.tensor(counts, dtype=torch.int32)
    if poison:
        dead = torch.arange(c)[None, :] >= cnt[:, None]
        x[dead] = float("nan")
        dout[dead] = float("nan")
        w[cnt == 0] = float("nan")
    return x.to(dtype), w.to(dtype), cnt, dout.to(dtype)


def dx_unit_rows(c: int) -> int:
    return next((r for r in DX_UNIT_ROWS if c <= r), DX_UNIT_ROWS[-1])


def walk(x, w, counts, dout):
    """The backward kernels' walks, in PyTorch."""
    e, c, d = x.shape
    f = w.shape[2]
    dx = torch.zeros((e, c, d))
    dw = torch.zeros((e, d, f))
    n_rows = dx_unit_rows(c)
    for ei in range(e):
        live = min(max(int(counts[ei]), 0), c)
        # dX: units (row block, 128 columns of d), f 64 a stage; a unit's
        # rows past C arrive as zeros, rows past the count are computed
        # and not stored
        for rb in range(0, c, n_rows):
            if rb >= live:
                continue                      # w[e] is not read
            g = torch.zeros((n_rows, f))
            rows = min(n_rows, c - rb)
            g[:rows] = dout[ei, rb:rb + rows].float()
            for c0 in range(0, d, DX_COLS):
                wt = w[ei, c0:c0 + DX_COLS].float()
                acc = torch.zeros((wt.shape[0], n_rows))
                for k0 in range(0, f, STAGE):
                    acc += wt[:, k0:k0 + STAGE] @ g[:, k0:k0 + STAGE].T
                n = min(n_rows, live - rb)
                dx[ei, rb:rb + n, c0:c0 + DX_COLS] = acc[:, :n].T
        # dW: 128 x 256 tiles over the live rows, 64 a stage rounded up to
        # 16, the rows from the count to that multiple zeroed first
        for r0 in range(0, d, DW_ROWS):
            for f0 in range(0, f, DW_COLS):
                acc = torch.zeros((min(DW_ROWS, d - r0), min(DW_COLS, f - f0)))
                for k0 in range(0, live, STAGE):
                    n = min(STAGE, live - k0)
                    k = -(-n // K_STEP) * K_STEP
                    xs = torch.zeros((k, acc.shape[0]))
                    gs = torch.zeros((k, acc.shape[1]))
                    top = min(k, c - k0)      # rows past C arrive as zeros
                    xs[:top] = x[ei, k0:k0 + top, r0:r0 + DW_ROWS].float()
                    gs[:top] = dout[ei, k0:k0 + top, f0:f0 + DW_COLS].float()
                    xs[n:] = 0                # zeroed before the product
                    gs[n:] = 0
                    acc += xs.T @ gs
                dw[ei, r0:r0 + DW_ROWS, f0:f0 + DW_COLS] = acc
    return dx.to(x.dtype), dw.to(w.dtype)


def rel(got, want) -> float:
    got, want = got.double(), want.double()
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_jax_grad(case):
    e, c, d, f, counts = case
    x, w, cnt, dout = gm_inputs(e, c, d, f, counts, torch.float32,
                                poison=False)
    got = grouped_matmul_backward_plain(x, w, cnt, dout)
    jdout = jnp.asarray(dout.numpy())
    want = jax.grad(lambda xx, ww: jnp.sum(grouped_matmul_ref(
        xx, ww, jnp.asarray(counts)) * jdout), argnums=(0, 1))(
            jnp.asarray(x.numpy()), jnp.asarray(w.numpy()))
    for g, wnt in zip(got, want):
        wnt = torch.from_numpy(np.array(wnt))
        assert g.shape == wnt.shape
        if wnt.abs().max() > 0:
            assert rel(g, wnt) <= BAND[torch.float32]
        else:
            assert not g.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernel_walk_matches_plain_backward(case, dtype):
    e, c, d, f, counts = case
    x, w, cnt, dout = gm_inputs(e, c, d, f, counts, dtype)
    got = walk(x, w, cnt, dout)
    assert all(torch.isfinite(g).all() for g in got)   # NaN never read
    want = grouped_matmul_backward_plain(torch.nan_to_num(x),
                                         torch.nan_to_num(w), cnt,
                                         torch.nan_to_num(dout))
    dead = torch.arange(c)[None, :] >= cnt[:, None]
    assert not got[0][dead].any() and not want[0][dead].any()
    assert not got[1][cnt == 0].any()
    for g, wnt in zip(got, want):
        assert g.shape == wnt.shape and g.dtype == wnt.dtype
        if any(counts):
            assert rel(g, wnt) <= BAND[dtype]


def test_plain_backward_is_autograd_of_the_plain_product():
    x, w, cnt, dout = gm_inputs(3, 12, 16, 8, [12, 5, 0], torch.float32,
                                poison=False)
    xs, ws = (t.clone().requires_grad_(True) for t in (x, w))
    want = torch.autograd.grad(grouped_matmul_plain(xs, ws, cnt), (xs, ws),
                               dout)
    got = grouped_matmul_backward_plain(x, w, cnt, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_tensor_core_backward_takes_bf16_at_widths_of_8():
    x, w, cnt, dout = gm_inputs(2, 8, 64, 32, [8, 1], torch.bfloat16,
                                poison=False)
    assert tensor_core_backward(x, w, dout)
    assert not tensor_core_backward(x.float(), w.float(), dout.float())
    x, w, cnt, dout = gm_inputs(2, 8, 60, 36, [8, 1], torch.bfloat16,
                                poison=False)
    assert not tensor_core_backward(x, w, dout)
