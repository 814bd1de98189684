"""Port MoE modules vs the JAX reference.

``grouped_matmul``'s wrapper on CPU tensors runs its plain version; it is
held against the reference's Pallas kernel in interpret mode
(``ops.grouped_matmul(..., interpret=True)``) and the oracle
``ref.grouped_matmul_ref`` over the sweep of tests/test_kernels.py:203-230.
Tolerance 2e-5 in f32 (relative and absolute; the sweep's outputs reach
|x| ~ 40, so the absolute band is scaled by d, as the reference's own
test scales it) and 2e-2 in bf16.  ``models/moe.py`` is held against
``repro.models.moe`` on the same numpy inputs and weights at the arctic
and kimi smoke widths: 1e-5 in f32, 2e-2 in bf16, the aux loss within
1e-6 and the dropped fraction within the rounding of its mean.  The
kernel itself runs only on the card (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _jax_caps import HAVE_PALLAS_API, PALLAS_SKIP_REASON  # noqa: E402
from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.kernels import ops, ref  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import params as jprm  # noqa: E402
from repro_torch.configs import get_smoke as tsmoke  # noqa: E402
from repro_torch.kernels import grouped_matmul  # noqa: E402
from repro_torch.kernels.grouped_matmul import (  # noqa: E402
    grouped_matmul_plain)
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import params as tprm  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GM_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
needs_pallas = pytest.mark.skipif(not HAVE_PALLAS_API,
                                  reason=PALLAS_SKIP_REASON)
MOE = ("arctic-480b", "kimi-k2-1t-a32b")


def close(want, got, dtype="float32", tol=None, scale=1.0):
    tol = TOL[dtype] if tol is None else tol
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(jnp.asarray(want).astype(jnp.float32)),
        atol=tol * scale, rtol=tol)


# ---------------------------------------------------------------------------
# grouped_matmul: plain version vs the Pallas kernel and the oracle
# ---------------------------------------------------------------------------


def gm_inputs(e, c, d, f, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    w = rng.standard_normal((e, d, f)).astype(np.float32)
    counts = np.array([min(c, max(0, c - i * (c // max(e - 1, 1))))
                       for i in range(e)], np.int32)
    return x, w, counts


@needs_pallas
@pytest.mark.parametrize("e,c,d,f", [
    (4, 64, 128, 256),
    (8, 32, 64, 64),
    (2, 128, 256, 128),
    (8, 8, 64, 96),            # arctic smoke: C 8 at decode, d 64, f 96
    (3, 24, 96, 64),           # its w_out at a prefill's C, ragged to 128
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_plain_matches_kernel_sweep(e, c, d, f, dtype):
    x, w, counts = gm_inputs(e, c, d, f)
    jx, jw = (jnp.asarray(a).astype(dtype) for a in (x, w))
    tx, tw = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w))
    before = grouped_matmul.launches
    out = grouped_matmul(tx, tw, torch.from_numpy(counts))
    assert grouped_matmul.launches == before           # CPU: no kernel
    assert out.dtype == tx.dtype and tuple(out.shape) == (e, c, f)
    want = ops.grouped_matmul(jx, jw, jnp.asarray(counts), interpret=True)
    close(want, out, dtype, GM_TOL[dtype], scale=d)
    close(ref.grouped_matmul_ref(jx, jw, jnp.asarray(counts)), out, dtype,
          GM_TOL[dtype], scale=d)


@needs_pallas
def test_grouped_matmul_plain_empty_experts_are_zero():
    """tests/test_kernels.py::test_grouped_matmul_empty_experts_are_zero."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 16, 32)).astype(np.float32)
    w = rng.standard_normal((4, 32, 64)).astype(np.float32)
    counts = np.array([16, 0, 3, 0], np.int32)
    out = grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(counts)).numpy()
    assert np.all(out[1] == 0) and np.all(out[3] == 0)
    assert np.all(out[2, 3:] == 0)          # rows past count zeroed
    want = ops.grouped_matmul(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(counts), interpret=True)
    np.testing.assert_allclose(out, np.asarray(want), atol=2e-5 * 32,
                               rtol=2e-5)


def test_grouped_matmul_wrapper_on_cpu():
    """Counts outside [0, C] clamp; bad shapes and dtypes raise."""
    x, w, _ = gm_inputs(3, 8, 16, 24)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    out = grouped_matmul(tx, tw, torch.tensor([9, -1, 8], dtype=torch.int32))
    torch.testing.assert_close(out[0], tx[0] @ tw[0])
    assert not out[1].any()
    with pytest.raises(ValueError, match="counts"):
        grouped_matmul(tx, tw, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\(E, C, d\)"):
        grouped_matmul(tx, tw[:, :8], torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="dtype"):
        grouped_matmul(tx, tw.double(), torch.zeros(3, dtype=torch.int32))
    torch.testing.assert_close(
        grouped_matmul_plain(tx, tw, torch.tensor([8, 0, 2])),
        grouped_matmul(tx, tw, torch.tensor([8, 0, 2], dtype=torch.int32)))


def test_grouped_matmul_kernel_path_follows_dtype_and_widths():
    """bf16 with d and f multiples of 8 (arctic's, kimi's and their
    smokes') takes the tensor-core kernel; f32 and ragged widths the
    CUDA-core one."""
    import importlib
    gm = importlib.import_module("repro_torch.kernels.grouped_matmul")

    def path(dtype, d, f, offset=0):
        x = torch.zeros((2, 8, d), dtype=dtype)
        w = torch.zeros((2 * d * f + offset,), dtype=dtype)[offset:]
        return gm.kernel_path(x, w.view(2, d, f))

    for d, f in ((72, 136), (64, 96), (64, 32)):
        assert path(torch.bfloat16, d, f) == gm.PATH_TENSOR_CORES
        assert path(torch.float32, d, f) == gm.PATH_FOUR_COLUMNS
    assert path(torch.bfloat16, 70, 96) == gm.PATH_FOUR_COLUMNS
    assert path(torch.bfloat16, 64, 132) == gm.PATH_FOUR_COLUMNS
    assert path(torch.bfloat16, 64, 33) == gm.PATH_ONE_COLUMN
    assert path(torch.bfloat16, 64, 96, offset=1) == gm.PATH_ONE_COLUMN


# ---------------------------------------------------------------------------
# models/moe.py vs repro.models.moe at the MoE smoke widths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", [1, 2, 7, 8, 9, 63, 64, 100, 256, 1000, 1024])
@pytest.mark.parametrize("name", MOE)
def test_capacity_matches(name, t):
    jcfg, tcfg = jsmoke(name), tsmoke(name)
    assert tmoe.capacity(t, tcfg) == jmoe.capacity(t, jcfg)
    for cf in (0.5, 2.0):
        assert tmoe.capacity(t, tcfg.replace(capacity_factor=cf)) == \
            jmoe.capacity(t, jcfg.replace(capacity_factor=cf))
    assert tmoe.GROUPWISE_MIN_TOKENS == jmoe.GROUPWISE_MIN_TOKENS


def configs(name, dtype="float32", **kw):
    return (jsmoke(name).replace(dtype=dtype, **kw),
            tsmoke(name).replace(dtype=dtype, **kw))


def moe_spec(cfg):
    return cfg.plan()[-1].pattern[0][0]


def block_params(jcfg, tcfg, seed=1):
    """One MoE block's random weights (the reference's init) in both
    packages: the MoE tree with arctic's dense residual MLP or kimi's
    shared expert."""
    jdt = jnp.float32 if jcfg.dtype == "float32" else jnp.bfloat16
    jdefs = jblocks.block_defs(jcfg, moe_spec(jcfg))
    tree = jax.device_get(jprm.init_params(jdefs, jax.random.key(seed), jdt))
    tparams = tprm.load_tree(tblocks.block_defs(tcfg, moe_spec(tcfg)), tree,
                             None, torch.device("cpu"))
    return jax.tree.map(jnp.asarray, tree), tparams


def hidden(b, s, d, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((b, s, d))
            * scale).astype(np.float32)


def test_moe_defs_match():
    for name in MOE:
        jcfg, tcfg = configs(name)
        jd = jblocks.block_defs(jcfg, moe_spec(jcfg))
        td = tblocks.block_defs(tcfg, moe_spec(tcfg))
        jl = jax.tree.leaves(jd, is_leaf=lambda p: isinstance(p, jprm.P))
        tl = tprm.tree_leaves(td)
        assert [p.shape for p in jl] == [p.shape for p in tl]
        assert [p.dtype for p in jl] == [p.dtype for p in tl]
        assert td["moe"]["router"].dtype == "float32"
        assert ("mlp" in td) == (name == "arctic-480b")
        assert ("shared" in td["moe"]) == (name == "kimi-k2-1t-a32b")


def run_both(name, x, dtype="float32", use_pallas=False, **kw):
    jcfg, tcfg = configs(name, dtype, **kw)
    tcfg = tcfg.replace(use_pallas=use_pallas)
    jp, tp = block_params(jcfg, tcfg)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jy, jstats = jmoe.moe_ffn(jp["moe"], jx, jcfg, moe_spec(jcfg))
    ty, tstats = tmoe.moe_ffn(tp["moe"], tx, tcfg, moe_spec(tcfg))
    return (jy, jstats), (ty, tstats), (jp, tp, jx, tx, jcfg, tcfg)


def check_stats(jstats, tstats):
    """The aux loss within 1e-6; the dropped fraction to the rounding of
    its mean (one drop more or less moves it by 1/(T*k) >= 1e-4)."""
    np.testing.assert_allclose(float(tstats.aux_loss),
                               float(jstats.aux_loss), rtol=1e-6)
    np.testing.assert_allclose(float(tstats.dropped_frac),
                               float(jstats.dropped_frac), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s", [(1, 1), (8, 1), (1, 100), (2, 37)])
@pytest.mark.parametrize("name", MOE)
def test_moe_ffn_matches_reference(name, b, s, dtype):
    """Decode-shaped (one token a row, all rows routed at once) and
    prefill-shaped inputs through the global dispatch; kimi's shared
    expert is inside ``moe_ffn``."""
    x = hidden(b, s, 64)
    (jy, jstats), (ty, tstats), _ = run_both(name, x, dtype)
    assert ty.dtype == getattr(torch, dtype) and tuple(ty.shape) == (b, s, 64)
    close(jy, ty, dtype)
    check_stats(jstats, tstats)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MOE)
def test_ffn_with_dense_residual_matches_reference(name, dtype):
    """``blocks._ffn``: arctic adds its dense residual MLP to the
    experts' output; kimi's MoE block has none."""
    x = hidden(2, 19, 64, seed=5)
    jcfg, tcfg = configs(name, dtype)
    jp, tp = block_params(jcfg, tcfg)
    jy, _ = jblocks._ffn(jp, jnp.asarray(x).astype(dtype), jcfg,
                         moe_spec(jcfg))
    ty = tblocks._ffn(tp, torch.from_numpy(x).to(getattr(torch, dtype)),
                      tcfg, moe_spec(tcfg))
    close(jy, ty, dtype)


@pytest.mark.parametrize("name", MOE)
def test_forced_drops_match_reference(name):
    """A capacity factor small enough that experts overflow: the same
    (token, expert) pairs are dropped in both packages."""
    x = hidden(1, 100, 64, seed=2)
    (jy, jstats), (ty, tstats), _ = run_both(name, x, capacity_factor=0.25)
    assert float(tstats.dropped_frac) > 0.2
    close(jy, ty)
    check_stats(jstats, tstats)


def test_per_row_dispatch_matches_reference():
    """b = 2, s = 256 takes the per-row path in both packages (capacity
    per row), mirroring tests/test_models.py::
    test_moe_groupwise_matches_global_dispatch; with generous capacity it
    also agrees with routing all 512 tokens at once."""
    name = "kimi-k2-1t-a32b"
    b, s = 2, tmoe.GROUPWISE_MIN_TOKENS
    x = hidden(b, s, 64, seed=1, scale=0.3)
    (jy, jstats), (ty, tstats), (_, tp, _, tx, _, tcfg) = run_both(name, x)
    close(jy, ty)
    check_stats(jstats, tstats)
    roomy = tcfg.replace(capacity_factor=4.0)
    moe = {k: v for k, v in tp["moe"].items() if k != "shared"}
    yg, _ = tmoe.moe_ffn(moe, tx, roomy, moe_spec(roomy))
    yt, _, _ = tmoe._moe_tokens(moe, tx.reshape(b * s, 64), roomy)
    torch.testing.assert_close(yg, yt.reshape(b, s, 64), atol=2e-4,
                               rtol=2e-4)


@pytest.mark.parametrize("name", MOE)
def test_use_pallas_on_and_off_equal(name, monkeypatch):
    """With ``use_pallas`` the three expert products go through the
    ``grouped_matmul`` wrapper (plain version on the CPU) with counts =
    min(load, C); the result equals the batched-product path's."""
    calls = []
    real = tmoe.grouped_matmul

    def spy(x, w, counts):
        calls.append((tuple(x.shape), tuple(w.shape), counts.clone()))
        return real(x, w, counts)

    monkeypatch.setattr(tmoe, "grouped_matmul", spy)
    x = hidden(1, 100, 64, seed=3)
    _, (y_off, s_off), ctx = run_both(name, x, capacity_factor=0.5)
    tp, tx, tcfg = ctx[1], ctx[3], ctx[5]
    assert calls == []
    on = tcfg.replace(use_pallas=True)
    y_on, s_on = tmoe.moe_ffn(tp["moe"], tx, on, moe_spec(on))
    torch.testing.assert_close(y_on, y_off, atol=1e-6, rtol=1e-6)
    assert float(s_on.dropped_frac) == float(s_off.dropped_frac) > 0
    assert len(calls) == 3
    c = tmoe.capacity(100, on)
    e, d, f = on.n_experts, on.d_model, on.d_ff_expert
    assert [s[:2] for s in calls] == [((e, c, d), (e, d, f)),
                                      ((e, c, d), (e, d, f)),
                                      ((e, c, f), (e, f, d))]
    counts = calls[0][2]
    assert counts.dtype == torch.int32 and int(counts.max()) == c
    assert int(counts.sum()) == round(100 * on.top_k
                                      * (1 - float(s_on.dropped_frac)))


def test_moe_ffn_without_stats():
    """The serve path asks for no statistics; the output is the same."""
    name = "arctic-480b"
    x = hidden(3, 5, 64, seed=6)
    _, (ty, _), ctx = run_both(name, x)
    tp, tx, tcfg = ctx[1], ctx[3], ctx[5]
    y, stats = tmoe.moe_ffn(tp["moe"], tx, tcfg, moe_spec(tcfg),
                            with_stats=False)
    assert stats is None and torch.equal(y, ty)
