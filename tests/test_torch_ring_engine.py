"""TorchEngine's ring layout and KV migration vs the JAX Engine.

Both engines serve the same prompts with the same weights (``from_jax``
of the reference's init) in tiny-agent f32.  With ``use_pallas`` on, the
port's ring prefill and decode reach the flash and ring decode kernel
wrappers, which run their plain versions on CPU tensors; the reference's
ring path is jnp either way.  Greedy tokens must be equal, exactly.

The SWA cases use ``window=24`` with tiny-agent's ``attn_chunk=32``, so
every ring holds 64 slots, and prompts of 70 and 100 tokens that wrap it.
Migration moves a sequence after 4 generated tokens; it passes when the
continued tokens equal those of an unmigrated run.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro import models as jmodels  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core.types import Request as JRequest  # noqa: E402
from repro.models.attention import KVCache as JKVCache  # noqa: E402
from repro.serving.engine import Engine  # noqa: E402
from repro.serving.scheduler import SchedulerConfig as JSched  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.types import Request  # noqa: E402
from repro_torch.kernels import decode_attention, flash_attention  # noqa: E402
from repro_torch.serving import cache_utils  # noqa: E402
from repro_torch.serving.engine import TorchEngine  # noqa: E402
from repro_torch.serving.scheduler import SchedulerConfig  # noqa: E402

SCHED = dict(max_slots=2, num_pages=64, max_context=128, page_size=16)
LENS = [70, 100]


def setup(**kw):
    kw = {"dtype": "float32", **kw}
    jcfg = jget("tiny-agent").replace(**kw)
    tcfg = tget("tiny-agent").replace(**kw)
    tree = jax.device_get(jmodels.init(jcfg, jax.random.key(0)))
    return jcfg, tcfg, tree


def jax_engine(jcfg, tree, layout, name="ref"):
    return Engine(jcfg, jax.tree.map(jax.numpy.asarray, tree),
                  JSched(**SCHED), name=name, cache_layout=layout)


def port_engine(tcfg, params, layout, name="port"):
    return TorchEngine(tcfg, params, SchedulerConfig(**SCHED), name=name,
                       cache_layout=layout, device="cpu")


def prompts(vocab, lens=LENS, seed=3):
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


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "kernel"])
@pytest.mark.parametrize("n_kv_heads", [2, 1], ids=["gqa", "mqa"])
@pytest.mark.parametrize("window", [-1, 24], ids=["full", "swa"])
def test_ring_greedy_tokens_match_reference(n_kv_heads, window, use_pallas):
    jcfg, tcfg, tree = setup(n_kv_heads=n_kv_heads, window=window,
                             use_pallas=use_pallas)
    teng = port_engine(tcfg, tmodels.from_jax(tcfg, tree, device="cpu"),
                       "ring")
    if window > 0:       # every prompt is longer than the 64-slot ring
        assert teng.cache["segments"][0]["e0"]["kv"].k.shape[2] == 64
    ps = prompts(jcfg.vocab)
    got = serve(teng, Request, ps)
    assert got == serve(jax_engine(jcfg, tree, "ring"), JRequest, ps)
    assert teng.prefill_steps > 0 and teng.decode_steps > 0


def test_ring_reaches_both_kernel_wrappers(monkeypatch):
    """With use_pallas, ring prefill calls the flash wrapper once per
    layer per prompt (causal, the layer's window) and each decode step
    calls the ring decode wrapper once per layer with every slot's
    ``kpos`` and position.  On the CPU no kernel launches."""
    from repro_torch.models import attention

    _, tcfg, tree = setup(window=24, use_pallas=True)
    eng = port_engine(tcfg, tmodels.from_jax(tcfg, tree, device="cpu"),
                      "ring")
    calls = {"flash": [], "decode": []}

    def flash_spy(q, k, v, **kw):
        calls["flash"].append((q.shape[1], kw))
        return flash_attention(q, k, v, **kw)

    def decode_spy(q, k, v, kpos, q_pos, **kw):
        calls["decode"].append((kpos.clone(), q_pos.clone(), kw))
        return decode_attention(q, k, v, kpos, q_pos, **kw)

    monkeypatch.setattr(attention, "flash_attention", flash_spy)
    monkeypatch.setattr(attention, "decode_attention", decode_spy)
    launches = (flash_attention.launches, decode_attention.launches)
    r = Request(prompt_len=70, max_new_tokens=3,
                prompt_tokens=prompts(tcfg.vocab, [70])[0])
    eng.submit(r)
    eng.step()                                     # prefill
    assert calls["flash"] == [(70, {"causal": True, "window": 24})] * 2
    assert not calls["decode"]
    eng.step()                                     # decode
    assert len(calls["decode"]) == tcfg.n_layers
    kpos, q_pos, kw = calls["decode"][-1]
    assert kw == {"window": 24} and q_pos[r.slot] == 70
    assert sorted(kpos[r.slot].tolist()) == list(range(71 - 64, 71))
    assert (flash_attention.launches, decode_attention.launches) == launches


def test_port_ring_and_paged_tokens_equal():
    """The port's two layouts agree, with and without the kernels
    (tests/test_paged_engine.py::test_live_engine_paged_vs_ring_tokens)."""
    _, tcfg, tree = setup()
    params = tmodels.from_jax(tcfg, tree, device="cpu")
    ps = prompts(tcfg.vocab, [35, 27])
    outs = [serve(port_engine(tcfg.replace(use_pallas=up), params, layout),
                  Request, ps)
            for layout in ("ring", "paged") for up in (False, True)]
    assert all(o == outs[0] for o in outs)


# ---------------------------------------------------------------------------
# Migration
# ---------------------------------------------------------------------------


def start_and_extract(eng, req_cls, p, at=4, max_new=10):
    """Serve ``p`` until ``at`` tokens are out, export the sequence and
    drop it from ``eng``.  Returns (state, tokens so far)."""
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


@pytest.mark.parametrize("src,dst,window", [
    ("ring", "paged", -1), ("paged", "ring", -1), ("ring", "ring", -1),
    ("paged", "paged", -1), ("ring", "ring", 24), ("ring", "paged", 24)])
def test_port_migration_continues_unmigrated_tokens(src, dst, window):
    _, tcfg, tree = setup(window=window)
    params = tmodels.from_jax(tcfg, tree, device="cpu")
    p = prompts(tcfg.vocab, [70])[0]
    want = serve(port_engine(tcfg, params, src, "oracle"), Request, [p],
                 max_new=10)[0]
    state, first = start_and_extract(port_engine(tcfg, params, src, "a"),
                                     Request, p)
    assert state["nbytes"] == cache_utils.cache_nbytes(state["cache"]) > 0
    got = inject_and_finish(port_engine(tcfg, params, dst, "b"), Request, p,
                            state)
    assert first + got == want


@pytest.mark.parametrize("jax_layout,port_layout", [("ring", "ring"),
                                                    ("paged", "ring"),
                                                    ("ring", "paged")])
def test_jax_extract_port_inject(jax_layout, port_layout):
    jcfg, tcfg, tree = setup()
    p = prompts(jcfg.vocab, [70])[0]
    want = serve(jax_engine(jcfg, tree, jax_layout, "oracle"), JRequest,
                 [p], max_new=10)[0]
    state, first = start_and_extract(jax_engine(jcfg, tree, jax_layout),
                                     JRequest, p)
    state = {**state, "cache": cache_utils.ring_tree_from_numpy(
        jax.device_get(state["cache"]), device="cpu")}
    teng = port_engine(tcfg, tmodels.from_jax(tcfg, tree, device="cpu"),
                       port_layout)
    assert first + inject_and_finish(teng, Request, p, state) == want


@pytest.mark.parametrize("port_layout,jax_layout", [("ring", "ring"),
                                                    ("ring", "paged"),
                                                    ("paged", "ring")])
def test_port_extract_jax_inject(port_layout, jax_layout):
    jcfg, tcfg, tree = setup()
    p = prompts(jcfg.vocab, [70])[0]
    want = serve(jax_engine(jcfg, tree, jax_layout, "oracle"), JRequest,
                 [p], max_new=10)[0]
    teng = port_engine(tcfg, tmodels.from_jax(tcfg, tree, device="cpu"),
                       port_layout)
    state, first = start_and_extract(teng, Request, p)
    tree_np = cache_utils.ring_tree_to_numpy(state["cache"], JKVCache)
    state = {**state, "cache": jax.tree.map(jax.numpy.asarray, tree_np)}
    got = inject_and_finish(jax_engine(jcfg, tree, jax_layout), JRequest, p,
                            state)
    assert first + got == want


def test_paged_to_ring_with_window_refused_by_both():
    """A paged engine exports max_context-slot rings (128 here) while a
    ring engine's SWA layers hold 64 slots: the reference fails inside its
    slice update with a TypeError, the port refuses with a ValueError
    naming both ring sizes."""
    jcfg, tcfg, tree = setup(window=24)
    p = prompts(jcfg.vocab, [70])[0]
    state, _ = start_and_extract(jax_engine(jcfg, tree, "paged"), JRequest, p)
    r = JRequest(prompt_len=len(p), max_new_tokens=10, prompt_tokens=p)
    r.prefilled = r.prompt_len
    jdst = jax_engine(jcfg, tree, "ring")
    assert jdst.scheduler.admit_direct(r)
    with pytest.raises(TypeError):
        jdst.inject_state(r, state)

    params = tmodels.from_jax(tcfg, tree, device="cpu")
    state, _ = start_and_extract(port_engine(tcfg, params, "paged"),
                                 Request, p)
    r = Request(prompt_len=len(p), max_new_tokens=10, prompt_tokens=p)
    r.prefilled = r.prompt_len
    dst = port_engine(tcfg, params, "ring")
    assert dst.scheduler.admit_direct(r)
    with pytest.raises(ValueError, match="ring size 128 vs 64"):
        dst.inject_state(r, state)


def test_cache_layout_knob():
    """tests/test_paged_engine.py::test_cache_layout_knob on the port."""
    _, tcfg, tree = setup()
    params = tmodels.from_jax(tcfg, tree, device="cpu")
    eng = port_engine(tcfg, params, None)
    assert eng.get_param("cache_layout") == "ring"     # use_pallas off
    eng.set_param("cache_layout", "paged")
    assert eng.cache_layout == "paged"
    assert tuple(eng.cache["segments"][0]["e0"]["kv"].k.shape[1:3]) == \
        (65, 16)                                       # pages + sink, page
    assert len(serve(eng, Request, [np.arange(6, 30, dtype=np.int32)])[0]) \
        == 6

    r = Request(prompt_len=20, max_new_tokens=8,
                prompt_tokens=np.arange(20).astype(np.int32))
    eng.submit(r)
    eng.step()
    with pytest.raises(RuntimeError, match="idle"):
        eng.set_param("cache_layout", "ring")
    assert eng.cache_layout == "paged"
    eng.run_until_idle()
    eng.set_param("cache_layout", "ring")
    assert eng.cache["segments"][0]["e0"]["kv"].kpos.shape == (2, 2, 128)

    assert port_engine(tcfg.replace(use_pallas=True), params,
                       None).cache_layout == "paged"
