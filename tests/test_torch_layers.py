"""Port layers vs the JAX reference (repro.models.layers), op by op, on
the same numpy inputs.  Tolerance: f32 1e-5, bf16 2e-2 (the reference's
own kernel-test band, tests/test_kernels.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = ["float32", "bfloat16"]


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jnp and a torch array of ``dtype``."""
    return (jnp.asarray(a, jnp.float32).astype(dtype),
            torch.from_numpy(a.astype(np.float32)).to(getattr(torch, dtype)))


def _close(j, t, dtype):
    np.testing.assert_allclose(np.asarray(j.astype(jnp.float32)),
                               t.float().numpy(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    xj, xt = _pair(x, dtype)
    out_j = jl.rmsnorm({"scale": jnp.asarray(scale)}, xj, 1e-6)
    out_t = tl.rmsnorm({"scale": torch.from_numpy(scale)}, xt, 1e-6)
    assert out_t.dtype == xt.dtype
    _close(out_j, out_t, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh,theta", [(32, 10_000.0), (128, 500_000.0)])
def test_apply_rope(dtype, dh, theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, dh)).astype(np.float32)
    pos = np.stack([np.arange(7) + 5, np.arange(7) + 900]).astype(np.int32)
    xj, xt = _pair(x, dtype)
    out_j = jl.apply_rope(xj, jnp.asarray(pos), theta)
    out_t = tl.apply_rope(xt, torch.from_numpy(pos), theta)
    _close(out_j, out_t, dtype)


def test_rope_freqs():
    np.testing.assert_allclose(np.asarray(jl.rope_freqs(128, 10_000.0)),
                               tl.rope_freqs(128, 10_000.0).numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp(dtype):
    rng = np.random.default_rng(2)
    d, ff = 32, 48
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    ws = {"w_in": rng.standard_normal((d, ff)) / np.sqrt(d),
          "w_gate": rng.standard_normal((d, ff)) / np.sqrt(d),
          "w_out": rng.standard_normal((ff, d)) / np.sqrt(ff)}
    pj = {k: _pair(v.astype(np.float32), dtype)[0] for k, v in ws.items()}
    pt = {k: _pair(v.astype(np.float32), dtype)[1] for k, v in ws.items()}
    xj, xt = _pair(x, dtype)
    _close(jl.mlp(pj, xj), tl.mlp(pt, xt), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_embed_unembed(dtype):
    rng = np.random.default_rng(3)
    vocab, d = 40, 16
    table = rng.standard_normal((vocab, d)).astype(np.float32)
    w = (rng.standard_normal((d, vocab)) / np.sqrt(d)).astype(np.float32)
    toks = rng.integers(0, vocab, (2, 5)).astype(np.int32)
    tj, tt = _pair(table, dtype)
    wj, wt = _pair(w, dtype)
    ej = jl.embed({"table": tj}, jnp.asarray(toks))
    et = tl.embed({"table": tt}, torch.from_numpy(toks).long())
    _close(ej, et, dtype)
    _close(jl.unembed({"w": wj}, ej), tl.unembed({"w": wt}, et), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_unembed_tied_softcap(dtype, softcap):
    rng = np.random.default_rng(4)
    vocab, d = 40, 16
    table = (rng.standard_normal((vocab, d)) * 2).astype(np.float32)
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    tj, tt = _pair(table, dtype)
    xj, xt = _pair(x, dtype)
    _close(jl.unembed_tied({"table": tj}, xj, softcap),
           tl.unembed_tied({"table": tt}, xt, softcap), dtype)
    _close(jl.unembed({"w": tj.T}, xj, softcap),
           tl.unembed({"w": tt.T}, xt, softcap), dtype)
