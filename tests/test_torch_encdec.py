"""The encoder-decoder (seamless-m4t: an encoder over frame embeddings,
decoder blocks with cross attention) in the port against the JAX
reference.

Both packages run ``get_smoke("seamless-m4t-large-v2")`` (2 encoder and
2 decoder layers, d_model 64, 4 heads) in f32 with the same weights
(``from_jax``).  Module level: the encoder block's non-causal
``self_attention``, ``cross_attention``, ``cross_kv_precompute`` with
``cross_attention_cached`` (a prefill's query block and a decode step's
single query) and ``encode``, within 1e-4; with ``use_pallas`` the
port's non-causal flash and ring decode wrappers (plain versions on the
CPU).  Model level: ``prefill(frames=)`` and ``decode_step`` against
the reference's, at a ragged encoder length (23 frames), prefill logits
within 1e-4 and decode within 2e-3 (the reference's bands,
tests/test_paged_engine.py:91-93), greedy tokens equal; the stored
cross K (entries up to ~10) within 1e-3.

Neither package's engine serves an encoder-decoder model: the reference
``Engine`` passes its prefill no frames and fails at the first prompt;
``TorchEngine`` refuses the config up front (ROADMAP §C).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jmodels  # noqa: E402
from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.core.types import Request as JRequest  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving.engine import Engine  # noqa: E402
from repro.serving.scheduler import SchedulerConfig as JSched  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.configs import get_smoke as tsmoke  # noqa: E402
from repro_torch.kernels import decode_attention, flash_attention  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.serving.engine import TorchEngine  # noqa: E402
from repro_torch.serving.scheduler import SchedulerConfig  # noqa: E402

NAME = "seamless-m4t-large-v2"
TOL = 1e-4
DECODE_TOL = 2e-3
T_ENC = 23


@functools.lru_cache(maxsize=None)
def _tree():
    jcfg = jsmoke(NAME).replace(dtype="float32")
    return jax.device_get(jmodels.init(jcfg, jax.random.key(0)))


def setup(**kw):
    jcfg = jsmoke(NAME).replace(dtype="float32")
    tcfg = tsmoke(NAME).replace(dtype="float32", **kw)
    return jcfg, tcfg, tmodels.from_jax(tcfg, _tree(), device="cpu")


def rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def close(want, got, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def layer(tree, part, key):
    """Layer 0's ``key`` params of the encoder or decoder."""
    return jax.tree.map(lambda a: a[0], tree[part][0]["e0"][key])


def both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree))


# ---------------------------------------------------------------------------
# Module level
# ---------------------------------------------------------------------------

def test_defs_and_plans():
    jcfg, tcfg, tparams = setup()
    assert tcfg.is_encdec and [s.pattern[0][0].kind for s in
                               tcfg.enc_plan()] == ["enc"]
    dec = tcfg.plan()[0].pattern[0][0]
    assert dec.kind == "dec" and dec.cross_attention
    e0 = tparams["decoder"][0]["e0"]
    assert set(e0) == {"norm1", "attn", "norm_x", "cross", "norm2", "mlp"}
    assert len(tparams["encoder"]) == 1 and "enc_norm" in tparams
    assert tmodels.param_count(tcfg) == jmodels.param_count(jcfg)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "kernel"])
def test_encoder_self_attention_is_non_causal(use_pallas, monkeypatch):
    jcfg, tcfg, _ = setup(use_pallas=use_pallas)
    jp, tp = both(layer(_tree(), "encoder", "attn"))
    x = rand(2, T_ENC, jcfg.d_model, seed=1)
    pos = np.broadcast_to(np.arange(T_ENC, dtype=np.int32), (2, T_ENC))
    spec = tcfg.enc_plan()[0].pattern[0][0]
    calls = []
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **k: calls.append(k) or
                        flash_attention(*a, **k))
    want = jattn.self_attention(jp, jnp.asarray(x), jcfg, spec,
                                jnp.asarray(pos), causal=False)
    got = tattn.self_attention(tp, torch.from_numpy(x), tcfg, spec,
                               torch.from_numpy(pos.copy()), causal=False)
    close(want, got)
    assert calls == ([{"causal": False, "window": -1}] if use_pallas else [])
    causal = tattn.self_attention(tp, torch.from_numpy(x), tcfg, spec,
                                  torch.from_numpy(pos.copy()))
    assert not torch.allclose(causal[:, 0], got[:, 0])


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "kernel"])
def test_cross_attention_paths(use_pallas, monkeypatch):
    jcfg, tcfg, _ = setup(use_pallas=use_pallas)
    jp, tp = both(layer(_tree(), "decoder", "cross"))
    mem = rand(2, T_ENC, jcfg.d_model, seed=2)
    x = rand(2, 7, jcfg.d_model, seed=3)
    want = jattn.cross_attention(jp, jnp.asarray(x), jnp.asarray(mem), jcfg)
    got = tattn.cross_attention(tp, torch.from_numpy(x), torch.from_numpy(mem),
                                tcfg)
    close(want, got)
    jkv = jattn.cross_kv_precompute(jp, jnp.asarray(mem))
    tkv = tattn.cross_kv_precompute(tp, torch.from_numpy(mem))
    close(jkv.k, tkv.k)
    close(jkv.v, tkv.v)
    calls = []
    monkeypatch.setattr(tattn, "decode_attention",
                        lambda *a, **k: calls.append(a[3:]) or
                        decode_attention(*a, **k))
    for sq in (7, 1):
        want = jattn.cross_attention_cached(jp, jnp.asarray(x[:, :sq]), jkv)
        got = tattn.cross_attention_cached(tp, torch.from_numpy(x[:, :sq]),
                                           tkv, tcfg)
        close(want, got)
    if use_pallas:
        (kpos, q_pos), = calls
        assert kpos.tolist() == [list(range(T_ENC))] * 2
        assert q_pos.tolist() == [T_ENC - 1] * 2
    else:
        assert calls == []


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "kernel"])
def test_encode(use_pallas):
    jcfg, tcfg, tparams = setup(use_pallas=use_pallas)
    frames = rand(2, T_ENC, jcfg.d_model, seed=4)
    want = jtfm.encode(jax.tree.map(jnp.asarray, _tree()), jcfg,
                       jnp.asarray(frames))
    got = tmodels.encode(tparams, tcfg, torch.from_numpy(frames))
    close(want, got)


# ---------------------------------------------------------------------------
# Model level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "kernel"])
def test_prefill_and_decode_match_reference(use_pallas):
    jcfg, tcfg, tparams = setup(use_pallas=use_pallas)
    jparams = jax.tree.map(jnp.asarray, _tree())
    frames = rand(2, T_ENC, jcfg.d_model, seed=5)
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (2, 9))
    toks = toks.astype(np.int32)
    jcache = jmodels.init_cache(jcfg, 2, 32, enc_len=T_ENC)
    tcache = tmodels.init_cache(tcfg, 2, 32, device="cpu", enc_len=T_ENC)
    cross = tcache["segments"][0]["e0"]["cross"]
    assert tuple(cross.k.shape) == (2, 2, T_ENC, 4, tcfg.d_head)
    lj, jcache = jtfm.prefill(jparams, jcfg, jnp.asarray(toks), jcache,
                              frames=jnp.asarray(frames))
    lt, tcache = tmodels.prefill(tparams, tcfg, torch.from_numpy(toks).long(),
                                 tcache, frames=torch.from_numpy(frames))
    close(lj, lt)
    # the cross K/V the prefill stored: projections of the encoder's
    # output, whose entries reach ~10, within 1e-3
    close(jcache["segments"][0]["e0"]["cross"].k, cross.k, 1e-3)
    jtok = np.argmax(np.asarray(lj), -1).astype(np.int32)[:, None]
    ttok = lt.argmax(-1)[:, None]
    for _ in range(8):
        lj, jcache = jmodels.decode_step(jparams, jcfg, jnp.asarray(jtok),
                                         jcache)
        lt, tcache = tmodels.decode_step(tparams, tcfg, ttok, tcache)
        close(lj, lt, DECODE_TOL)
        jtok = np.argmax(np.asarray(lj), -1).astype(np.int32)[:, None]
        ttok = lt.argmax(-1)[:, None]
        assert ttok.numpy().tolist() == jtok.tolist()
    assert tcache["pos"].tolist() == [17, 17]


# ---------------------------------------------------------------------------
# Neither engine serves it
# ---------------------------------------------------------------------------

def test_engines_refuse_encoder_decoder():
    jcfg, tcfg, tparams = setup()
    sched = dict(max_slots=2, num_pages=16, page_size=16, max_context=64)
    with pytest.raises(ValueError, match="seamless-m4t-large-v2 is an "
                                         "encoder-decoder model"):
        TorchEngine(tcfg, tparams, SchedulerConfig(**sched), device="cpu")
    eng = Engine(jcfg, jax.tree.map(jnp.asarray, _tree()), JSched(**sched),
                 cache_layout="ring")
    eng.submit(JRequest(prompt_len=5, max_new_tokens=2,
                        prompt_tokens=np.arange(5, dtype=np.int32)))
    with pytest.raises(AttributeError, match="shape"):
        eng.step()                  # its prefill encodes frames=None
