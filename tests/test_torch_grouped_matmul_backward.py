"""The ``grouped_matmul`` backward on the CPU: its plain version against
the JAX package, and an emulation of the CUDA kernels' walks against the
plain version.

* ``grouped_matmul_backward_plain`` (autograd through the port's plain
  product) against ``jax.grad`` of the reference's oracle
  (``repro/kernels/ref.py::grouped_matmul_ref``): dx and dw within 2e-5
  of each output's largest magnitude (f32), for counts of 0, of C and
  ragged.
* ``walk``: the kernels of ``csrc/grouped_matmul_bwd.cu`` in PyTorch.
  dX: blocks of 128 rows of C, only the live rows' 16-row tiles
  computed, f consumed 32 at a time, so a block past an expert's count
  never reads its weights; dW: the live rows of C consumed 32 at a time,
  nothing read for an expert no token chose.  Inputs widened to f32 from
  their type (bf16 operands are exact in the tensor cores' f32
  accumulators), outputs rounded once.  Dead rows of x and the weights
  of empty experts hold NaN, which the walk must not read.  Held to the
  plain backward within 2e-5 (f32) and 2e-2 (bf16) of each output's
  largest magnitude, dead rows of dx and empty experts' dw exactly zero.
* ``tensor_core_backward``: which inputs the mma.sync kernels take.
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
DX_ROWS, KS, LIVE_TILE = 128, 32, 16
# e, c, d, f, counts
CASES = [(4, 8, 64, 32, [8, 3, 0, 5]),
         (3, 88, 96, 72, [88, 40, 0]),
         (2, 130, 40, 24, [130, 129]),
         (3, 24, 60, 36, [24, 0, 7]),
         (2, 16, 32, 16, [0, 0])]
IDS = ["decode", "arctic-train-C", "two-row-blocks", "widths-not-of-8",
       "no-token"]


def gm_inputs(e, c, d, f, counts, dtype, seed=0, poison=True):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((e, c, d))).float()
    w = torch.from_numpy(rng.standard_normal((e, d, f)) / np.sqrt(d)).float()
    dout = torch.from_numpy(rng.standard_normal((e, c, f))).to(dtype)
    cnt = torch.tensor(counts, dtype=torch.int32)
    if poison:
        x[torch.arange(c)[None, :] >= cnt[:, None]] = float("nan")
        w[cnt == 0] = float("nan")
    return x.to(dtype), w.to(dtype), cnt, dout


def walk(x, w, counts, dout):
    """The backward kernels' walks, in PyTorch."""
    e, c, d = x.shape
    f = w.shape[2]
    dx = torch.zeros((e, c, d))
    dw = torch.zeros((e, d, f))
    for ei in range(e):
        live = min(max(int(counts[ei]), 0), c)
        for m0 in range(0, c, DX_ROWS):               # dX row blocks
            n = min(live - m0, DX_ROWS)
            if n <= 0:
                continue                              # w[e] is not read
            rows = -(-n // LIVE_TILE) * LIVE_TILE     # live 16-row tiles
            a = torch.zeros((rows, f))
            a[:n] = dout[ei, m0:m0 + n].float()
            acc = torch.zeros((rows, d))
            for k0 in range(0, f, KS):
                acc += a[:, k0:k0 + KS] @ w[ei, :, k0:k0 + KS].float().T
            dx[ei, m0:m0 + n] = acc[:n]
        acc = torch.zeros((d, f))
        for k0 in range(0, live, KS):                 # dW over live rows
            k1 = min(k0 + KS, live)
            acc += x[ei, k0:k1].float().T @ dout[ei, k0:k1].float()
        dw[ei] = acc
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
                                         torch.nan_to_num(w), cnt, dout)
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
