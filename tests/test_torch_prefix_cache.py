"""The port's ``PrefixCache`` (a copy of ``repro/serving/prefix_cache.py``
with its imports rewritten) on ``TorchEngine``, against the JAX
``Engine`` with the reference's cache.

Shared-prefix admission takes the resident prefix blocks by page id: the
admitted sequence's block table starts with the pages its sibling's
prefill wrote, and nothing is copied.  The port of
tests/test_paged_engine.py::test_shared_prefix_zero_copy_admission runs
with the mixed step off and on (the suffix then prefills in the padded
chunk of a mixed step beside the sibling's decode row); a fan-out with
churn holds the cache's counters and the tokens to the reference's step
by step.  tiny-agent, f32, prompts from numpy seeds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _jax_caps import HAVE_PALLAS_API, PALLAS_SKIP_REASON  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core.types import Request as JRequest  # noqa: E402
from repro.serving import prefix_cache as jpc  # noqa: E402
from repro.serving.engine import Engine  # noqa: E402
from repro.serving.scheduler import SchedulerConfig as JSched  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.types import Request  # noqa: E402
from repro_torch.serving import prefix_cache as tpc  # noqa: E402
from repro_torch.serving.engine import TorchEngine  # noqa: E402
from repro_torch.serving.scheduler import SchedulerConfig  # noqa: E402

PAGE = 16


def setup(**kw):
    jcfg = jget("tiny-agent").replace(dtype="float32", **kw)
    tcfg = tget("tiny-agent").replace(dtype="float32", **kw)
    tree = jax.device_get(jmodels.init(jcfg, jax.random.key(0)))
    return jcfg, tcfg, tree


def sched_kw(mixed, num_pages=64, chunk=0):
    return dict(max_slots=2, num_pages=num_pages, max_context=128,
                page_size=PAGE, max_batch_tokens=64, prefill_chunk=chunk,
                mixed=mixed)


def engines(jcfg, tcfg, tree, reserve_frac=0.8, **kw):
    """(reference, port), each with a PrefixCache over its own allocator,
    as tests/test_paged_engine.py builds it."""
    jeng = Engine(jcfg, jax.tree.map(jnp.asarray, tree),
                  JSched(**sched_kw(**kw)), name="ref", cache_layout="paged")
    teng = TorchEngine(tcfg, tmodels.from_jax(tcfg, tree, device="cpu"),
                       SchedulerConfig(**sched_kw(**kw)), name="port",
                       cache_layout="paged", device="cpu")
    for eng, mod in ((jeng, jpc), (teng, tpc)):
        eng.attach_cache(mod.PrefixCache(
            eng.scheduler.alloc, name=f"{eng.name}.cache", instance=eng.name,
            block_tokens=PAGE, reserve_frac=reserve_frac))
    return jeng, teng


def counters(eng):
    c = eng.scheduler.cache
    return (c.lookups, c.hit_tokens, c.miss_tokens, c.evictions,
            c.blocks_resident, eng.scheduler.alloc.free_pages)


@pytest.mark.parametrize("mixed", [False, True], ids=["serial", "mixed"])
def test_shared_prefix_zero_copy_admission(mixed):
    """rB shares rA's two-page prefix: admitted while rA decodes, its
    table starts with the exact pages rA's prefill wrote, and both
    packages emit the same tokens (the reference's kernel in interpret
    mode, the port's plain version)."""
    if not HAVE_PALLAS_API:
        pytest.skip(PALLAS_SKIP_REASON)
    jcfg, tcfg, tree = setup(use_pallas=True)
    shared = (np.arange(11, 43) % jcfg.vocab).astype(np.int32)   # 2 pages
    pa = np.concatenate([shared, np.asarray([7, 8, 9], np.int32)])
    pb = np.concatenate([shared, np.asarray([1, 2, 3, 4], np.int32)])
    outs = []
    for eng, req_cls in zip(engines(jcfg, tcfg, tree, mixed=mixed),
                            (JRequest, Request)):
        ra = req_cls(prompt_len=len(pa), max_new_tokens=5, prompt_tokens=pa)
        eng.submit(ra)
        while ra.generated < 2:
            eng.step()
        cache, alloc = eng.scheduler.cache, eng.scheduler.alloc
        shared_pages = [pid for blk in cache.chain(list(shared))
                        for pid in alloc.block_pages(blk.digest)]
        assert len(shared_pages) == len(shared) // PAGE
        rb = req_cls(prompt_len=len(pb), max_new_tokens=5, prompt_tokens=pb)
        eng.submit(rb)
        kind = eng.step()                  # admit + suffix prefill
        assert kind.value == ("mixed" if mixed else "prefill")
        assert rb.meta["cached_prompt_tokens"] == len(shared)
        assert alloc.page_table(rb.req_id)[:len(shared_pages)] \
            == shared_pages
        eng.run_until_idle()
        outs.append([list(ra.output_tokens), list(rb.output_tokens)])
    assert outs[1] == outs[0]


@pytest.mark.parametrize("mixed", [False, True], ids=["serial", "mixed"])
def test_prefix_fanout_with_eviction_matches_reference(mixed):
    """Five prompts over one 40-token system prompt (two full blocks), two
    slots and a cache allowed 20% of 24 pages: admission hits, commits,
    evictions and free pages after every step, and the tokens, equal the
    reference's."""
    jcfg, tcfg, tree = setup()
    rng = np.random.default_rng(7)
    system = rng.integers(0, jcfg.vocab, 40).astype(np.int32)
    ps = [np.concatenate([system, rng.integers(0, jcfg.vocab, n)
                          .astype(np.int32)]) for n in (5, 17, 9, 30, 12)]
    jeng, teng = engines(jcfg, tcfg, tree, reserve_frac=0.2, mixed=mixed,
                         num_pages=24, chunk=16)
    reqs = []
    for eng, req_cls in ((jeng, JRequest), (teng, Request)):
        rs = [req_cls(prompt_len=len(p), max_new_tokens=4, prompt_tokens=p)
              for p in ps]
        for r in rs:
            eng.submit(r)
        reqs.append(rs)
    steps = 0
    while jeng.busy or teng.busy:
        assert jeng.step() == teng.step()
        assert counters(teng) == counters(jeng)
        steps += 1
        assert steps < 500
    assert teng.scheduler.cache.hit_tokens > 0
    assert teng.scheduler.cache.evictions > 0
    assert [r.output_tokens for r in reqs[1]] == \
        [r.output_tokens for r in reqs[0]]


@pytest.mark.parametrize("source", [
    list(range(100)),
    [(("system-prompt", 512)), ("sess:a", 96)],
    [("a", 10), ("b", 70), ("a", 3)],
], ids=["tokens", "segments", "ragged-segments"])
def test_chain_digests_match_reference(source):
    for bt in (16, 64):
        assert tpc.chain_for(source, bt) == [
            tpc.BlockId(b.digest, b.labels) for b in jpc.chain_for(source, bt)]
