"""xLSTM (mLSTM and sLSTM blocks) in the port against the JAX reference.

Both packages run ``get_smoke("xlstm-350m")`` (6 layers: two groups of
two mLSTM and one sLSTM layer; d_model 64, 2 heads, so an mLSTM head
has dk = 64 and dv = 65 with the normaliser column) in f32 with the
same weights (``from_jax`` of the reference's init).  With
``use_pallas`` on, the port's mLSTM prefill reaches the ``ssm_scan``
wrapper, which runs its plain version on CPU tensors; the reference is
jnp either way.

Module level: ``mlstm_block`` and ``mlstm_block_step``, ``slstm_block``
and ``slstm_block_step`` within 1e-4 (f32), a step's live mask keeping
the other rows' state.  Model level: ring prefill logits within 1e-4
and decode within 2e-3, the reference's bands
(tests/test_paged_engine.py:91-93).  Engine level: greedy tokens equal
to the JAX ``Engine``'s on the ring layout (the paged layout is refused
by both), one scan per mLSTM layer per prefill, and migration of the
recurrent states within the port and across the packages.

A prompt longer than 128 tokens and not a multiple of 128 cannot be
prefilled by the reference's mLSTM (its chunked scan asserts ``T %
chunk == 0``, ROADMAP §C fault 3); the port pads the tail, and the
oracle is the reference's own ``mlstm_block_step`` walked over the
tokens.
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
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.attention import KVCache as JKVCache  # noqa: E402
from repro.models.ssm import SLSTMState as JSLSTMState  # noqa: E402
from repro.models.ssm import SSMState as JSSMState  # noqa: E402
from repro.serving.engine import Engine  # noqa: E402
from repro.serving.scheduler import SchedulerConfig as JSched  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.configs import get_smoke as tsmoke  # noqa: E402
from repro_torch.core.types import Request  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.ssm import SLSTMState  # noqa: E402
from repro_torch.serving import cache_utils  # noqa: E402
from repro_torch.serving.engine import TorchEngine  # noqa: E402
from repro_torch.serving.scheduler import SchedulerConfig  # noqa: E402

NAME = "xlstm-350m"
TOL = 1e-4
DECODE_TOL = 2e-3
SCHED = dict(max_slots=2, num_pages=64, max_context=320, page_size=16)


@functools.lru_cache(maxsize=None)
def _tree():
    jcfg = jsmoke(NAME).replace(dtype="float32")
    return jax.device_get(jmodels.init(jcfg, jax.random.key(0)))


def setup(**kw):
    jcfg = jsmoke(NAME).replace(dtype="float32")
    tcfg = tsmoke(NAME).replace(dtype="float32", **kw)
    return jcfg, tcfg


def layer_params(kind: str):
    """The reference's weights of the first layer of ``kind`` (segment 0,
    element 0 for mLSTM, 1 for sLSTM, repeat 0, layer 0)."""
    e = "e0" if kind == "mlstm" else "e1"
    tree = jax.tree.map(lambda a: a[0, 0], _tree()["decoder"][0][e])
    return tree, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def hidden(b, t, d, seed):
    return np.random.default_rng(seed).standard_normal((b, t, d)).astype(
        np.float32)


def close(want, got, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# Module level
# ---------------------------------------------------------------------------

def test_defs_match_reference():
    jcfg, tcfg = setup()
    for kind in ("mlstm", "slstm"):
        jt, tt = layer_params(kind)
        defs = getattr(tssm, f"{kind}_defs")(tcfg)
        assert set(defs) == set(jt)
        for k, p in defs.items():
            if isinstance(p, dict):
                continue
            assert p.shape == jt[k].shape, (kind, k)
    assert tssm.mlstm_defs(tcfg)["gn"].dtype == "float32"
    assert tssm.mlstm_dims(tcfg) == jssm.mlstm_dims(jcfg) == (128, 2, 64)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "kernel"])
@pytest.mark.parametrize("t", [37, 128, 256])
def test_mlstm_block_and_step(t, use_pallas):
    jcfg, tcfg = setup(use_pallas=use_pallas)
    jp, tp = layer_params("mlstm")
    x = hidden(2, t, jcfg.d_model, seed=t)
    jy, jh = jssm.mlstm_block(jp, jnp.asarray(x), jcfg)
    ty, th = tssm.mlstm_block(tp, torch.from_numpy(x), tcfg)
    close(jy, ty)
    close(jh, th)
    assert tuple(th.shape) == (2, 2, 64, 65) and th.dtype == torch.float32
    xs = hidden(2, 1, jcfg.d_model, seed=99)
    jy, jh2 = jssm.mlstm_block_step(jp, jnp.asarray(xs), jh, jcfg)
    ty, th2 = tssm.mlstm_block_step(tp, torch.from_numpy(xs), th, tcfg)
    close(jy, ty)
    close(jh2, th2)
    # a row outside the live mask keeps its state
    live = torch.tensor([True, False])
    _, th3 = tssm.mlstm_block_step(tp, torch.from_numpy(xs), th, tcfg, live)
    assert torch.equal(th3[1], th[1]) and torch.equal(th3[0], th2[0])


@pytest.mark.parametrize("t", [1, 37])
def test_slstm_block_and_step(t):
    jcfg, tcfg = setup()
    jp, tp = layer_params("slstm")
    x = hidden(2, t, jcfg.d_model, seed=t + 1)
    jy, js = jssm.slstm_block(jp, jnp.asarray(x), jcfg)
    ty, ts = tssm.slstm_block(tp, torch.from_numpy(x), tcfg)
    close(jy, ty)
    assert isinstance(ts, SLSTMState)
    for a, b in zip(js, ts):
        close(a, b)
    xs = hidden(2, 1, jcfg.d_model, seed=98)
    jy, js2 = jssm.slstm_block_step(jp, jnp.asarray(xs), js, jcfg)
    ty, ts2 = tssm.slstm_block_step(tp, torch.from_numpy(xs), ts, tcfg)
    close(jy, ty)
    for a, b in zip(js2, ts2):
        close(a, b)
    live = torch.tensor([False, True])
    _, ts3 = tssm.slstm_block_step(tp, torch.from_numpy(xs), ts, tcfg, live)
    for old, new, kept in zip(ts, ts2, ts3):
        assert torch.equal(kept[0], old[0]) and torch.equal(kept[1], new[1])


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "kernel"])
def test_ragged_mlstm_prompt_reference_fault(use_pallas):
    """ROADMAP §C fault 3: the reference's ``mlstm_block`` asserts ``T %
    chunk == 0`` with ``chunk = min(128, T)``, so a 130-token prompt
    raises; the port serves it, equal to the reference's own step walked
    over the 130 tokens from the zero state."""
    jcfg, tcfg = setup(use_pallas=use_pallas)
    jp, tp = layer_params("mlstm")
    x = hidden(1, 130, jcfg.d_model, seed=6)
    with pytest.raises(AssertionError, match="130, 128"):
        jssm.mlstm_block(jp, jnp.asarray(x), jcfg)
    ty, th = tssm.mlstm_block(tp, torch.from_numpy(x), tcfg)
    step = jax.jit(lambda p, xt, h: jssm.mlstm_block_step(p, xt, h, jcfg))
    h = jssm.init_mlstm_state(1, jcfg)
    outs = []
    for i in range(130):
        o, h = step(jp, jnp.asarray(x[:, i:i + 1]), h)
        outs.append(o)
    close(jnp.concatenate(outs, axis=1), ty)
    close(h, th)


# ---------------------------------------------------------------------------
# Model level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "kernel"])
def test_logit_parity(use_pallas):
    jcfg, tcfg = setup(use_pallas=use_pallas)
    jparams = jax.tree.map(jnp.asarray, _tree())
    tparams = tmodels.from_jax(tcfg, _tree(), device="cpu")
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (2, 70))
    toks = toks.astype(np.int32)
    jcache = jmodels.init_cache(jcfg, 2, 96)
    tcache = tmodels.init_cache(tcfg, 2, 96, device="cpu")
    seg = tcache["segments"][0]
    assert tuple(seg["e0"]["h"].shape) == (2, 2, 2, 2, 64, 65)
    assert isinstance(seg["e1"]["s"], SLSTMState)
    lj, jcache = jtfm.prefill(jparams, jcfg, jnp.asarray(toks), jcache)
    lt, tcache = tmodels.prefill(tparams, tcfg, torch.from_numpy(toks).long(),
                                 tcache)
    close(lj, lt)
    tok = np.argmax(np.asarray(lj), -1).astype(np.int32)[:, None]
    for _ in range(6):
        lj, jcache = jmodels.decode_step(jparams, jcfg, jnp.asarray(tok),
                                         jcache)
        lt, tcache = tmodels.decode_step(tparams, tcfg,
                                         torch.from_numpy(tok).long(), tcache)
        close(lj, lt, DECODE_TOL)
        tok = np.argmax(np.asarray(lj), -1).astype(np.int32)[:, None]
    assert tcache["pos"].tolist() == [76, 76]


# ---------------------------------------------------------------------------
# Engine level
# ---------------------------------------------------------------------------

def prompts(vocab, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def serve(eng, cls, ps, max_new=6):
    reqs = [cls(prompt_len=len(p), max_new_tokens=max_new, prompt_tokens=p)
            for p in ps]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    for r in reqs:
        assert r.state.value == "finished"
        assert len(r.output_tokens) == max_new
    return [list(r.output_tokens) for r in reqs]


def port_engine(tcfg, name="port"):
    return TorchEngine(tcfg, tmodels.from_jax(tcfg, _tree(), device="cpu"),
                       SchedulerConfig(**SCHED), name=name,
                       cache_layout="ring", device="cpu")


def jax_engine(jcfg, name="ref"):
    return Engine(jcfg, jax.tree.map(jnp.asarray, _tree()), JSched(**SCHED),
                  name=name, cache_layout="ring")


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "kernel"])
@pytest.mark.parametrize("lens", [[20, 100], [256, 40]], ids=["short", "256"])
def test_greedy_tokens_match_reference(lens, use_pallas):
    jcfg, tcfg = setup(use_pallas=use_pallas)
    ps = prompts(jcfg.vocab, lens)
    assert serve(port_engine(tcfg), Request, ps) == \
        serve(jax_engine(jcfg), JRequest, ps)


def test_ring_reaches_the_scan_once_per_mlstm_layer(monkeypatch):
    calls = []
    real = tssm.ssm_scan
    monkeypatch.setattr(tssm, "ssm_scan",
                        lambda *a, **k: calls.append(a[2].shape) or
                        real(*a, **k))
    _, tcfg = setup(use_pallas=True)
    eng = port_engine(tcfg)
    serve(eng, Request, prompts(tcfg.vocab, [20, 45, 33]))
    assert len(calls) == 4 * 3                  # 4 mLSTM layers, 3 prompts
    assert all(s[2:] == (2, 65) for s in calls)
    _, off = setup(use_pallas=False)
    calls.clear()
    serve(port_engine(off), Request, prompts(off.vocab, [20]))
    assert calls == []


def test_paged_layout_refused_by_both():
    jcfg, tcfg = setup()
    with pytest.raises(ValueError, match="attention-only"):
        TorchEngine(tcfg, tmodels.from_jax(tcfg, _tree(), device="cpu"),
                    SchedulerConfig(**SCHED), cache_layout="paged",
                    device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        Engine(jcfg, jax.tree.map(jnp.asarray, _tree()), JSched(**SCHED),
               cache_layout="paged")


def start_and_extract(eng, cls, prompt, at, max_new):
    r = cls(prompt_len=len(prompt), max_new_tokens=max_new,
            prompt_tokens=prompt)
    eng.submit(r)
    while r.generated < at:
        eng.step()
    state = eng.extract_state(r)
    first = list(r.output_tokens)
    eng.scheduler.preempt_one()
    return state, first


def continue_on(eng, cls, prompt, at, max_new, state):
    r = cls(prompt_len=len(prompt), max_new_tokens=max_new,
            prompt_tokens=prompt)
    r.generated, r.prefilled = at, len(prompt)
    assert eng.scheduler.admit_direct(r)
    eng.inject_state(r, state)
    eng.run_until_idle()
    return list(r.output_tokens)


AT, MAX_NEW = 3, 9


def test_port_ring_to_ring_migration_carries_recurrent_state():
    _, tcfg = setup()
    prompt = prompts(tcfg.vocab, [45], seed=5)[0]
    want = serve(port_engine(tcfg), Request, [prompt], MAX_NEW)[0]
    state, first = start_and_extract(port_engine(tcfg, "src"), Request,
                                     prompt, AT, MAX_NEW)
    seg = state["cache"]["segments"][0]
    assert tuple(seg["e0"]["h"].shape) == (2, 2, 1, 2, 64, 65)
    assert isinstance(seg["e1"]["s"], SLSTMState)
    assert state["nbytes"] == cache_utils.cache_nbytes(state["cache"])
    got = continue_on(port_engine(tcfg, "dst"), Request, prompt, AT, MAX_NEW,
                      state)
    assert first + got == want


def test_jax_extract_port_inject():
    jcfg, tcfg = setup()
    prompt = prompts(tcfg.vocab, [45], seed=5)[0]
    want = serve(jax_engine(jcfg), JRequest, [prompt], MAX_NEW)[0]
    state, first = start_and_extract(jax_engine(jcfg, "src"), JRequest,
                                     prompt, AT, MAX_NEW)
    tree = cache_utils.ring_tree_from_numpy(jax.device_get(state["cache"]),
                                            device="cpu")
    assert isinstance(tree["segments"][0]["e1"]["s"], SLSTMState)
    got = continue_on(port_engine(tcfg), Request, prompt, AT, MAX_NEW,
                      {"cache": tree, "last_token": state["last_token"]})
    assert first + got == want


def test_port_extract_jax_inject():
    jcfg, tcfg = setup()
    prompt = prompts(tcfg.vocab, [45], seed=5)[0]
    want = serve(port_engine(tcfg), Request, [prompt], MAX_NEW)[0]
    state, first = start_and_extract(port_engine(tcfg, "src"), Request,
                                     prompt, AT, MAX_NEW)
    tree = cache_utils.ring_tree_to_numpy(state["cache"], JKVCache, JSSMState,
                                          JSLSTMState)
    assert isinstance(tree["segments"][0]["e1"]["s"], JSLSTMState)
    got = continue_on(jax_engine(jcfg), JRequest, prompt, AT, MAX_NEW,
                      {"cache": jax.tree.map(jnp.asarray, tree),
                       "last_token": state["last_token"]})
    assert first + got == want
