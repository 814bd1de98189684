"""The hymba hybrid on the port's ring layout vs the JAX reference.

Both packages serve ``get_smoke("hymba-1.5b")`` (5 layers: global, 3
sliding-window, global; window 16, attn_chunk 8, so each SWA ring holds
24 slots; 2 SSM heads of state 4) in f32 with the same weights
(``from_jax`` of the reference's init).  With ``use_pallas`` on, the
port's ring prefill reaches the flash and ``ssm_scan`` wrappers and its
decode the ring decode wrapper, which run their plain versions on CPU
tensors; the reference's ring path is jnp either way.  Greedy tokens
must be equal, exactly.

Logits: decode within 2e-3, the reference's own decode band
(tests/test_paged_engine.py:91-93); prefill within the 1e-4 of the dense
ring tests on a 2-layer cut (global, SWA), and within 2e-3 at the smoke
model's 5 layers.  This random-init hybrid amplifies rounding about 10x
per layer: raising every embedding entry of the reference by one f32 ulp
moves its own 5-layer prefill logits by up to 3.6e-4 (tiny-agent: 1e-5),
and port and reference differ by up to 4.3e-4 there, against 2e-5 at 2
layers (ROADMAP §C).

A prompt longer than 128 tokens and not a multiple of 128 cannot be
prefilled by the reference (ROADMAP §C fault 3); there the oracle is the
reference model prefilling 128 tokens and stepping through the rest.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jmodels  # noqa: E402
from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.core.types import Request as JRequest  # noqa: E402
from repro.models.attention import KVCache as JKVCache  # noqa: E402
from repro.models.ssm import SSMState as JSSMState  # noqa: E402
from repro.serving.engine import Engine  # noqa: E402
from repro.serving.scheduler import SchedulerConfig as JSched  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.configs import get_smoke as tsmoke  # noqa: E402
from repro_torch.core.types import Request  # noqa: E402
from repro_torch.kernels import (decode_attention, flash_attention,  # noqa: E402
                                 ssm_scan)
from repro_torch.models.ssm import SSMState  # noqa: E402
from repro_torch.serving import cache_utils  # noqa: E402
from repro_torch.serving.engine import TorchEngine  # noqa: E402
from repro_torch.serving.scheduler import SchedulerConfig  # noqa: E402

SCHED = dict(max_slots=2, num_pages=64, max_context=320, page_size=16)
TOL = 2e-3
# the smoke model cut to its first global layer and one SWA layer
CUT2 = (("n_layers", 2), ("global_layers", (0,)))
PREFILL_TOL = {2: 1e-4, 5: TOL}


@functools.lru_cache(maxsize=None)
def _tree(cut=()):
    jcfg = jsmoke("hymba-1.5b").replace(dtype="float32", **dict(cut))
    return jax.device_get(jmodels.init(jcfg, jax.random.key(0)))


def setup(cut=(), **kw):
    kw = {"dtype": "float32", **dict(cut), **kw}
    return (jsmoke("hymba-1.5b").replace(**kw),
            tsmoke("hymba-1.5b").replace(**kw), _tree(cut))


def jax_engine(jcfg, tree, layout="ring", name="ref"):
    return Engine(jcfg, jax.tree.map(jnp.asarray, tree), JSched(**SCHED),
                  name=name, cache_layout=layout)


def port_engine(tcfg, tree, layout="ring", name="port"):
    return TorchEngine(tcfg, tmodels.from_jax(tcfg, tree, device="cpu"),
                       SchedulerConfig(**SCHED), name=name,
                       cache_layout=layout, device="cpu")


def prompts(vocab, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def serve(eng, req_cls, ps, max_new=6):
    reqs = [req_cls(prompt_len=len(p), max_new_tokens=max_new,
                    prompt_tokens=p) for p in ps]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    for r in reqs:
        assert r.state.value == "finished"
        assert len(r.output_tokens) == max_new
    return [list(r.output_tokens) for r in reqs]


def test_plan_and_param_count_match_reference():
    """Five segments (global, 29 SWA split 15 + 14, ...) and 1,640,662,400
    parameters at full width, the same tree as the reference's."""
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget

    jcfg, tcfg = jget("hymba-1.5b"), tget("hymba-1.5b")
    assert [(s.pattern[0][0].window, s.pattern[0][1]) for s in tcfg.plan()] \
        == [(-1, 1), (1024, 15), (-1, 1), (1024, 14), (-1, 1)]
    assert tmodels.param_count(tcfg) == jmodels.param_count(jcfg) \
        == 1_640_662_400


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "kernel"])
@pytest.mark.parametrize("lens", [[20, 100], [256, 40]],
                         ids=["short", "256"])
def test_hymba_greedy_tokens_match_reference(lens, use_pallas):
    """Every prompt but the 20-token one wraps the 24-slot SWA rings;
    100 is one ragged-free chunk and 256 two chunks of the scan."""
    jcfg, tcfg, tree = setup(use_pallas=use_pallas)
    teng = port_engine(tcfg, tree)
    seg = teng.cache["segments"]
    assert seg[1]["e0"]["kv"].k.shape[2] == 24
    assert isinstance(seg[1]["e0"]["ssm"], SSMState)
    ps = prompts(jcfg.vocab, lens)
    got = serve(teng, Request, ps)
    assert got == serve(jax_engine(jcfg, tree), JRequest, ps)
    assert teng.prefill_steps > 0 and teng.decode_steps > 0


def test_hymba_ring_reaches_every_kernel_wrapper(monkeypatch):
    """With use_pallas, ring prefill calls the flash and scan wrappers
    once per layer per prompt and decode the ring decode wrapper once per
    layer per step.  On the CPU no kernel launches."""
    from repro_torch.models import attention, ssm

    _, tcfg, tree = setup(use_pallas=True)
    eng = port_engine(tcfg, tree)
    calls = {"flash": [], "scan": [], "decode": 0}

    def flash_spy(q, k, v, **kw):
        calls["flash"].append(kw["window"])
        return flash_attention(q, k, v, **kw)

    def scan_spy(q, k, v, log_a, h0, **kw):
        calls["scan"].append(tuple(q.shape))
        assert q.stride(2) == 0 and k.stride(2) == 0   # B/C broadcast
        return ssm_scan(q, k, v, log_a, h0, **kw)

    def decode_spy(*a, **kw):
        calls["decode"] += 1
        return decode_attention(*a, **kw)

    monkeypatch.setattr(attention, "flash_attention", flash_spy)
    monkeypatch.setattr(ssm, "ssm_scan", scan_spy)
    monkeypatch.setattr(attention, "decode_attention", decode_spy)
    launches = (flash_attention.launches, decode_attention.launches,
                ssm_scan.launches)
    r = Request(prompt_len=130, max_new_tokens=3,
                prompt_tokens=prompts(tcfg.vocab, [130])[0])
    eng.submit(r)
    eng.step()                                     # prefill
    assert calls["flash"] == [-1, 16, 16, 16, -1]
    assert calls["scan"] == [(1, 130, 2, 4)] * 5
    assert calls["decode"] == 0
    eng.step()                                     # decode
    assert calls["decode"] == tcfg.n_layers
    assert (flash_attention.launches, decode_attention.launches,
            ssm_scan.launches) == launches


def oracle_logits(jcfg, tree, prompt, max_new):
    """The reference model on one prompt of any length: one-shot prefill
    where its scan can take the prompt, else prefill of the first 128
    tokens and decode steps through the rest; then ``max_new - 1`` greedy
    tokens.  Returns the logits after the prompt and after each greedy
    token."""
    params = jax.tree.map(jnp.asarray, tree)
    n = len(prompt)
    n0 = n if n % min(n, 128) == 0 else 128
    cache = jmodels.init_cache(jcfg, 1, SCHED["max_context"])
    logits, cache = jax.jit(functools.partial(jmodels.prefill, cfg=jcfg))(
        params, tokens=jnp.asarray(prompt[None, :n0]), cache=cache)
    step = jax.jit(functools.partial(jmodels.decode_step, cfg=jcfg))
    for t in prompt[n0:]:
        logits, cache = step(params, tokens=jnp.asarray([[t]]), cache=cache)
    out = [np.asarray(logits)[0]]
    for _ in range(max_new - 1):
        tok = int(np.argmax(out[-1]))
        logits, cache = step(params, tokens=jnp.asarray([[tok]]), cache=cache)
        out.append(np.asarray(logits)[0])
    return out


@pytest.mark.parametrize("depth", [2, 5])
@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "kernel"])
@pytest.mark.parametrize("n", [100, 256, 200], ids=["100", "256", "ragged"])
def test_hymba_logit_parity(n, use_pallas, depth):
    """The port's one-shot prefill and decode steps against the reference
    model: its one-shot prefill where it can run one (n = 100, 256),
    else prefill of 128 and steps through the rest (n = 200, which the
    reference's prefill refuses).  Greedy tokens follow the logits."""
    jcfg, tcfg, tree = setup(CUT2 if depth == 2 else (),
                             use_pallas=use_pallas)
    p = prompts(jcfg.vocab, [n], seed=n)[0]
    if n % min(n, 128):
        with pytest.raises(AssertionError, match=f"{n}, 128"):
            jmodels.prefill(jax.tree.map(jnp.asarray, tree), jcfg,
                            jnp.asarray(p[None]),
                            jmodels.init_cache(jcfg, 1, SCHED["max_context"]))
    want = oracle_logits(jcfg, tree, p, 6)
    params = tmodels.from_jax(tcfg, tree, device="cpu")
    cache = tmodels.init_cache(tcfg, 1, SCHED["max_context"], device="cpu")
    logits, cache = tmodels.prefill(params, tcfg,
                                    torch.from_numpy(p[None]).long(), cache)
    got = [logits[0].numpy()]
    for _ in range(5):
        tok = torch.tensor([[int(np.argmax(got[-1]))]])
        logits, cache = tmodels.decode_step(params, tcfg, tok, cache)
        got.append(logits[0].numpy())
    for i, (w, g) in enumerate(zip(want, got)):
        tol = PREFILL_TOL[depth] if i == 0 else TOL
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol)
        assert np.argmax(g) == np.argmax(w)
    assert cache["pos"].tolist() == [n + 5]


def test_ragged_prompt_served_by_port_refused_by_reference():
    """ROADMAP §C fault 3 at the engine: a 130-token prompt kills the
    reference engine's prefill; the port serves it, and its tokens are
    the oracle's greedy tokens."""
    jcfg, tcfg, tree = setup()
    p = prompts(jcfg.vocab, [130], seed=7)[0]
    with pytest.raises(AssertionError, match="130, 128"):
        serve(jax_engine(jcfg, tree), JRequest, [p])
    got = serve(port_engine(tcfg, tree), Request, [p])[0]
    assert got == [int(np.argmax(w)) for w in oracle_logits(jcfg, tree, p, 6)]


# ---------------------------------------------------------------------------
# Migration with the SSM state
# ---------------------------------------------------------------------------


def start_and_extract(eng, req_cls, p, at=4, max_new=10):
    r = req_cls(prompt_len=len(p), max_new_tokens=max_new, prompt_tokens=p)
    eng.submit(r)
    while r.generated < at:
        eng.step()
    state = eng.extract_state(r)
    first = list(r.output_tokens)
    eng.scheduler.preempt_one()
    return state, first


def inject_and_finish(eng, req_cls, p, state, at=4, max_new=10):
    r = req_cls(prompt_len=len(p), max_new_tokens=max_new, prompt_tokens=p)
    r.generated = at
    r.prefilled = r.prompt_len
    assert eng.scheduler.admit_direct(r)
    eng.inject_state(r, state)
    eng.run_until_idle()
    assert r.state.value == "finished"
    return list(r.output_tokens)


def test_port_ring_to_ring_migration_carries_ssm_state():
    _, tcfg, tree = setup(use_pallas=True)
    p = prompts(tcfg.vocab, [70])[0]
    want = serve(port_engine(tcfg, tree, name="oracle"), Request, [p],
                 max_new=10)[0]
    state, first = start_and_extract(port_engine(tcfg, tree, name="a"),
                                     Request, p)
    ssm_states = [s["e0"]["ssm"] for s in state["cache"]["segments"]]
    assert all(isinstance(s, SSMState) and s.h.shape[-4] == 1
               for s in ssm_states)             # batch 1, stacked layers
    assert any(s.h.abs().sum() > 0 for s in ssm_states)
    assert state["nbytes"] == cache_utils.cache_nbytes(state["cache"])
    got = inject_and_finish(port_engine(tcfg, tree, name="b"), Request, p,
                            state)
    assert first + got == want


def test_jax_extract_port_inject_hymba():
    jcfg, tcfg, tree = setup()
    p = prompts(jcfg.vocab, [70])[0]
    want = serve(jax_engine(jcfg, tree, name="oracle"), JRequest, [p],
                 max_new=10)[0]
    state, first = start_and_extract(jax_engine(jcfg, tree), JRequest, p)
    tree_t = cache_utils.ring_tree_from_numpy(jax.device_get(state["cache"]),
                                              device="cpu")
    assert isinstance(tree_t["segments"][0]["e0"]["ssm"], SSMState)
    got = inject_and_finish(port_engine(tcfg, tree), Request, p,
                            {**state, "cache": tree_t})
    assert first + got == want


def test_port_extract_jax_inject_hymba():
    jcfg, tcfg, tree = setup()
    p = prompts(jcfg.vocab, [70])[0]
    want = serve(jax_engine(jcfg, tree, name="oracle"), JRequest, [p],
                 max_new=10)[0]
    state, first = start_and_extract(port_engine(tcfg, tree), Request, p)
    tree_np = cache_utils.ring_tree_to_numpy(state["cache"], JKVCache,
                                             JSSMState)
    assert isinstance(tree_np["segments"][0]["e0"]["ssm"], JSSMState)
    state = {**state, "cache": jax.tree.map(jnp.asarray, tree_np)}
    got = inject_and_finish(jax_engine(jcfg, tree), JRequest, p, state)
    assert first + got == want


def test_paged_layout_refused_by_both():
    """hymba's recurrent state has no page structure: both packages
    refuse the paged layout, asked for or defaulted to by use_pallas."""
    jcfg, tcfg, tree = setup(use_pallas=True)
    for layout in ("paged", None):
        with pytest.raises(ValueError, match="attention-only"):
            jax_engine(jcfg, tree, layout)
        with pytest.raises(ValueError, match="attention-only"):
            port_engine(tcfg, tree, layout)
    with pytest.raises(ValueError, match="attention-only"):
        tmodels.init_cache(tcfg, 2, 64, layout="paged", num_pages=4,
                           device="cpu")
