"""Port transformer vs the JAX reference on tiny-agent in f32: paged
suffix prefill, then decode steps with live block tables, on the same
weights (``from_jax``) and the same tokens.  The matrix is that of
tests/test_paged_engine.py::test_paged_model_logit_parity: GQA/MQA x
full/SWA(24), a 27-token prompt, pages of 16, a decode tail crossing a
page.  Tolerance rtol/atol 1e-4 (that test's prefill band), with the
kernel flag off (gather path) and on (the port's plain kernel version
against the reference kernel in interpret mode)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _jax_caps import HAVE_PALLAS_API, PALLAS_SKIP_REASON  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402

PAGE = 16
TOL = 1e-4
DECODE_TOL = 2e-3


def configs(**kw):
    jcfg = jget("tiny-agent").replace(dtype="float32", **kw)
    tcfg = tget("tiny-agent").replace(dtype="float32", **kw)
    return jcfg, tcfg


def shared_params(jcfg, tcfg, seed=0):
    tree = jax.device_get(jmodels.init(jcfg, jax.random.key(seed)))
    return tree, tmodels.from_jax(tcfg, tree, device="cpu")


def test_from_jax_keeps_tree_shapes_and_dtypes():
    jcfg, tcfg = configs()
    tree, params = shared_params(jcfg, tcfg)
    jl = jax.tree_util.tree_leaves_with_path(tree)
    assert tmodels.param_count(tcfg) == jmodels.param_count(jcfg)
    for path, leaf in jl:
        node = params
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    # a bf16 reference tree keeps bf16, its f32-pinned norms stay f32
    jb, tb = jget("tiny-agent"), tget("tiny-agent")
    pb = tmodels.from_jax(tb, jax.device_get(jmodels.init(jb,
                                                          jax.random.key(0))),
                          device="cpu")
    assert pb["embed"]["table"].dtype == torch.bfloat16
    assert pb["final_norm"]["scale"].dtype == torch.float32


def test_init_follows_reference_rule():
    _, tcfg = configs()
    gen = torch.Generator().manual_seed(0)
    params = tmodels.init(tcfg, gen, device="cpu")
    e0 = params["decoder"][0]["e0"]
    assert tuple(e0["attn"]["wq"].shape) == (2, 128, 4, 32)
    assert torch.equal(e0["norm1"]["scale"], torch.ones(2, 128))
    # std = 1 / sqrt(fan_in), fan_in = shape[-2]
    std = e0["mlp"]["w_in"].std().item()
    assert abs(std - 1 / np.sqrt(128)) < 0.05 / np.sqrt(128)
    bf = tmodels.init(tget("tiny-agent"), gen, device="cpu")
    assert bf["unembed"]["w"].dtype == torch.bfloat16
    assert bf["final_norm"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("use_pallas", [False, True], ids=["gather", "kernel"])
@pytest.mark.parametrize("n_kv_heads", [2, 1], ids=["gqa", "mqa"])
@pytest.mark.parametrize("window", [-1, 24], ids=["full", "swa"])
def test_paged_logit_parity(n_kv_heads, window, use_pallas):
    if use_pallas and not HAVE_PALLAS_API:
        pytest.skip(PALLAS_SKIP_REASON)
    jcfg, tcfg = configs(n_kv_heads=n_kv_heads, window=window,
                         use_pallas=use_pallas)
    tree, tparams = shared_params(jcfg, tcfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 27))
    toks = toks.astype(np.int32)

    pmax = 96 // PAGE
    tables = np.asarray([[b * pmax + j for j in range(pmax)]
                         for b in range(2)], np.int32)
    jcache = jmodels.init_cache(jcfg, 2, 96, layout="paged", num_pages=16,
                                page_size=PAGE)
    tcache = tmodels.init_cache(tcfg, 2, 96, layout="paged", num_pages=16,
                                page_size=PAGE, device="cpu")
    jl, tlog = [], []
    for b in range(2):
        lj, jcache = jtfm.prefill_paged(jparams, jcfg, jnp.asarray(toks[b:b + 1]),
                                        jcache, jnp.asarray(tables[b:b + 1]),
                                        jnp.zeros((1,), jnp.int32),
                                        jnp.int32(b))
        lt, tcache = tmodels.prefill_paged(
            tparams, tcfg, torch.from_numpy(toks[b:b + 1]).long(), tcache,
            torch.from_numpy(tables[b:b + 1]), torch.zeros(1, dtype=torch.int32),
            b)
        jl.append(np.asarray(lj))
        tlog.append(lt.numpy())
    np.testing.assert_allclose(np.concatenate(tlog), np.concatenate(jl),
                               rtol=TOL, atol=TOL)
    assert tcache["pos"].tolist() == [27, 27]

    tok = np.argmax(np.concatenate(jl), -1).astype(np.int32)[:, None]
    jt = jnp.asarray(tables)
    tt = torch.from_numpy(tables)
    for _ in range(8):                        # crosses the 27 -> 32 page edge
        lj, jcache = jmodels.decode_step(jparams, jcfg, jnp.asarray(tok),
                                         jcache, jt)
        lt, tcache = tmodels.decode_step(tparams, tcfg,
                                         torch.from_numpy(tok).long(),
                                         tcache, tt)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   rtol=DECODE_TOL, atol=DECODE_TOL)
        tok = np.argmax(np.asarray(lj), -1).astype(np.int32)[:, None]
        assert (np.argmax(lt.numpy(), -1)[:, None] == tok).all()
    assert tcache["pos"].tolist() == [35, 35]


@pytest.mark.parametrize("window", [-1, 24], ids=["full", "swa"])
def test_prefill_query_chunks_parity(window):
    """A 64-token suffix is two query chunks of tiny-agent's attn_chunk
    32, attending after a 5-token resident prefix."""
    jcfg, tcfg = configs(window=window)
    assert 64 % tcfg.attn_chunk == 0 and 64 > tcfg.attn_chunk
    tree, tparams = shared_params(jcfg, tcfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (1, 69))
    toks = toks.astype(np.int32)
    tables = np.asarray([[3, 0, 7, 1, 5, -1]], np.int32)
    jcache = jmodels.init_cache(jcfg, 1, 96, layout="paged", num_pages=8,
                                page_size=PAGE)
    tcache = tmodels.init_cache(tcfg, 1, 96, layout="paged", num_pages=8,
                                page_size=PAGE, device="cpu")
    for lo, hi in ((0, 5), (5, 69)):
        lj, jcache = jtfm.prefill_paged(
            jparams, jcfg, jnp.asarray(toks[:, lo:hi]), jcache,
            jnp.asarray(tables), jnp.full((1,), lo, jnp.int32), jnp.int32(0))
        lt, tcache = tmodels.prefill_paged(
            tparams, tcfg, torch.from_numpy(toks[:, lo:hi]).long(), tcache,
            torch.from_numpy(tables), torch.full((1,), lo, dtype=torch.int32),
            0)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL,
                                   atol=TOL)
    assert tcache["pos"].tolist() == [69]


def test_unported_paths_raise():
    _, tcfg = configs()
    with pytest.raises(ValueError, match="layout"):
        tmodels.init_cache(tcfg, 2, 64, layout="ragged", device="cpu")
    # the MoE FFN is ported (tests/test_torch_moe*.py): its defs build
    moe = tmodels.model_defs(tcfg.replace(n_experts=4, top_k=2,
                                          d_ff_expert=64))
    assert "moe" in moe["decoder"][0]["e0"]
    with pytest.raises(NotImplementedError, match="xLSTM"):
        tmodels.model_defs(tcfg.replace(family="ssm"))


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "kernel"])
@pytest.mark.parametrize("window", [-1, 24], ids=["full", "swa"])
def test_ring_logit_parity(window, use_pallas):
    """One-shot ring prefill of a 70-token batch (longer than the 64-slot
    SWA ring), then decode steps, against the reference's ring path.  With
    the kernel flag the port runs its flash and ring decode wrappers
    (plain versions on the CPU); the reference's ring path is jnp."""
    jcfg, tcfg = configs(window=window, use_pallas=use_pallas)
    tree, tparams = shared_params(jcfg, tcfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (2, 70))
    toks = toks.astype(np.int32)
    jcache = jmodels.init_cache(jcfg, 2, 96)
    tcache = tmodels.init_cache(tcfg, 2, 96, device="cpu")
    lj, jcache = jtfm.prefill(jparams, jcfg, jnp.asarray(toks), jcache)
    lt, tcache = tmodels.prefill(tparams, tcfg, torch.from_numpy(toks).long(),
                                 tcache)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL, atol=TOL)
    ring_j = jcache["segments"][0]["e0"]["kv"]
    ring_t = tcache["segments"][0]["e0"]["kv"]
    assert ring_t.k.shape == ring_j.k.shape
    np.testing.assert_array_equal(ring_t.kpos.numpy(), np.asarray(ring_j.kpos))
    tok = np.argmax(np.asarray(lj), -1).astype(np.int32)[:, None]
    for _ in range(6):
        lj, jcache = jmodels.decode_step(jparams, jcfg, jnp.asarray(tok),
                                         jcache)
        lt, tcache = tmodels.decode_step(tparams, tcfg,
                                         torch.from_numpy(tok).long(), tcache)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   rtol=DECODE_TOL, atol=DECODE_TOL)
        tok = np.argmax(np.asarray(lj), -1).astype(np.int32)[:, None]
        assert (np.argmax(lt.numpy(), -1)[:, None] == tok).all()
    assert tcache["pos"].tolist() == [76, 76]
