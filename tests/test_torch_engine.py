"""TorchEngine vs the JAX Engine: greedy tokens must be equal.

Both engines serve the same prompts with the same weights (``from_jax``
of the reference's init), the paged layout and ``use_pallas=True``: the
reference runs its Pallas kernel in interpret mode, the port on CPU
tensors its plain kernel version.  Token equality is exact.  Scenarios
follow tests/test_paged_engine.py: GQA/MQA x full/SWA, chunked suffix
prefill, preemption churn, and a spy proving decode reaches the kernel
wrapper with the allocator's live block-table row.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from _jax_caps import HAVE_PALLAS_API, PALLAS_SKIP_REASON  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core.types import Request as JRequest  # noqa: E402
from repro.serving.engine import Engine  # noqa: E402
from repro.serving.scheduler import SchedulerConfig as JSched  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.types import Request  # noqa: E402
from repro_torch.serving.engine import TorchEngine  # noqa: E402
from repro_torch.serving.scheduler import SchedulerConfig  # noqa: E402

pytestmark = pytest.mark.skipif(not HAVE_PALLAS_API,
                                reason=PALLAS_SKIP_REASON)

PAGE = 16


def setup(**kw):
    jcfg = jget("tiny-agent").replace(dtype="float32", use_pallas=True, **kw)
    tcfg = tget("tiny-agent").replace(dtype="float32", use_pallas=True, **kw)
    tree = jax.device_get(jmodels.init(jcfg, jax.random.key(0)))
    return jcfg, tcfg, tree


def sched_kw(num_pages=64, prefill_chunk=0):
    return dict(max_slots=2, num_pages=num_pages, max_context=128,
                page_size=PAGE, prefill_chunk=prefill_chunk)


def engines(jcfg, tcfg, tree, **kw):
    jeng = Engine(jcfg, jax.tree.map(jax.numpy.asarray, tree),
                  JSched(**sched_kw(**kw)), name="ref", cache_layout="paged")
    teng = TorchEngine(tcfg, tmodels.from_jax(tcfg, tree, device="cpu"),
                       SchedulerConfig(**sched_kw(**kw)), name="port",
                       device="cpu")
    return jeng, teng


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


@pytest.mark.parametrize("n_kv_heads", [2, 1], ids=["gqa", "mqa"])
@pytest.mark.parametrize("window", [-1, 24], ids=["full", "swa"])
def test_greedy_tokens_match_reference(n_kv_heads, window):
    jcfg, tcfg, tree = setup(n_kv_heads=n_kv_heads, window=window)
    jeng, teng = engines(jcfg, tcfg, tree)
    ps = prompts(jcfg.vocab, [27, 40])
    assert serve(teng, Request, ps) == serve(jeng, JRequest, ps)
    assert teng.decode_steps == jeng.decode_steps > 0


def test_chunked_prefill_tokens_match_reference():
    jcfg, tcfg, tree = setup()
    jeng, teng = engines(jcfg, tcfg, tree, prefill_chunk=16)
    ps = prompts(jcfg.vocab, [27, 40], seed=4)
    assert serve(teng, Request, ps) == serve(jeng, JRequest, ps)
    # 27 -> 2 chunks, 40 -> 3 chunks: the prefill_chunk knob is live
    assert teng.prefill_steps == jeng.prefill_steps >= 3


def churn(eng, req_cls, ps):
    """tests/test_paged_engine.py's churn without the prefix cache:
    admit and prefill, preempt the youngest running sequence mid-flight,
    then drain.  The victim restarts from scratch."""
    reqs = [req_cls(prompt_len=len(p), max_new_tokens=6, prompt_tokens=p)
            for p in ps]
    for r in reqs:
        eng.submit(r)
    eng.step()                                   # admit + prefill
    victim = eng.scheduler.preempt_one()
    assert victim is not None
    alloc = eng.scheduler.alloc
    assert alloc.page_table(victim.req_id) == []
    eng.run_until_idle()
    for r in reqs:
        assert r.state.value == "finished" and len(r.output_tokens) == 6
    assert alloc.free_pages == alloc.num_pages
    return [list(r.output_tokens) for r in reqs], reqs.index(victim)


def test_preemption_churn_tokens_match_reference():
    jcfg, tcfg, tree = setup()
    jeng, teng = engines(jcfg, tcfg, tree, num_pages=10)
    ps = prompts(jcfg.vocab, [30, 30, 30], seed=5)
    got, victim = churn(teng, Request, ps)
    assert (got, victim) == churn(jeng, JRequest, ps)
    # the restarted victim equals an uncontended run of its prompt
    fresh = TorchEngine(tcfg, teng.params, SchedulerConfig(**sched_kw()),
                        name="oracle", device="cpu")
    assert serve(fresh, Request, [ps[victim]]) == [got[victim]]


def test_decode_reaches_kernel_wrapper_with_live_table(monkeypatch):
    from repro_torch.kernels import paged_decode_attention as real
    from repro_torch.models import attention

    _, tcfg, tree = setup()
    teng = TorchEngine(tcfg, tmodels.from_jax(tcfg, tree, device="cpu"),
                       SchedulerConfig(**sched_kw()), device="cpu")
    calls = []

    def spy(q, k_pages, v_pages, tables, ctx, **kw):
        calls.append((tables.numpy().copy(), ctx.numpy().copy()))
        return real(q, k_pages, v_pages, tables, ctx, **kw)

    monkeypatch.setattr(attention, "paged_decode_attention", spy)
    p = prompts(tcfg.vocab, [26])[0]
    r = Request(prompt_len=26, max_new_tokens=3, prompt_tokens=p)
    teng.submit(r)
    teng.step()                                  # prefill: no kernel
    assert not calls
    expect = teng.scheduler.alloc.page_table(r.req_id)
    launches = real.launches
    teng.step()                                  # decode
    assert len(calls) == tcfg.n_layers           # once per layer
    row = calls[-1][0][r.slot]
    assert list(row[:len(expect)]) == expect
    assert (row[len(expect):] == -1).all()
    assert calls[-1][1][r.slot] == 27            # ctx = pos + 1
    other = 1 - r.slot
    assert (calls[-1][0][other] == -1).all() and calls[-1][1][other] == 0
    assert real.launches == launches             # CPU: plain version


def test_unported_engine_paths_raise():
    """The mixed step is ported; what stays refused is mixed batching off
    the paged layout, as the reference's three guards: at construction,
    on the ``mixed`` knob, and on a ``cache_layout`` flip to ring (each a
    RuntimeError that reverts the knob)."""
    _, tcfg, tree = setup()
    params = tmodels.from_jax(tcfg, tree, device="cpu")
    with pytest.raises(RuntimeError, match="paged"):
        TorchEngine(tcfg, params, SchedulerConfig(mixed=True),
                    cache_layout="ring", device="cpu")
    with pytest.raises(ValueError, match="layout"):
        TorchEngine(tcfg, params, SchedulerConfig(), cache_layout="ragged",
                    device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        TorchEngine(tcfg, params, SchedulerConfig(), device="cpu",
                    cuda_graphs=True)
    ring = TorchEngine(tcfg, params, SchedulerConfig(**sched_kw()),
                       cache_layout="ring", device="cpu")
    with pytest.raises(RuntimeError, match="paged"):
        ring.set_param("mixed", True)
    assert ring.scheduler.cfg.mixed is False
    eng = TorchEngine(tcfg, params, SchedulerConfig(**sched_kw()),
                      device="cpu")
    # use_pallas picks the paged layout, as the reference's default rule
    assert eng.get_param("cache_layout") == "paged"
    eng.set_param("mixed", True)
    with pytest.raises(RuntimeError, match="mixed"):
        eng.set_param("cache_layout", "ring")
    assert eng.get_param("cache_layout") == "paged"
    eng.set_param("mixed", False)
    eng.set_param("cache_layout", "ring")
    assert eng.cache_layout == "ring"
