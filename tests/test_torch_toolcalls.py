"""Tool-call suspend/resume on a live ``TorchEngine`` against the JAX
``Engine`` (the port's mirror of tests/test_toolcalls.py's live-engine
parity), on tiny-agent f32 with the reference's weights (``from_jax``).

The host tier (``offload=True``): a warm resume on the same engine and a
migration of the suspended request to a sibling engine continue with
the unsuspended run's greedy tokens, which are the JAX ``Engine``'s, in
both layouts and with the mixed step, and on xLSTM's smoke model (its
mLSTM and sLSTM states in the host copy); the host store holds the
state on the CPU, its bytes equal to ``nbytes``.

The pin tier (``offload=False``) with traffic between suspend and
resume: the port's parked slot keeps its ``pos``, ring and recurrent
state, so its tokens equal the unsuspended run's, in both layouts, with
the mixed step and on hymba's and xLSTM's smoke models.  The JAX
``Engine`` advances every slot on every step, so on the same schedule
its tokens differ
(ROADMAP §C, reference fault 4).  Then the starved-pin demotion and the
drop-and-recompute rung of a full host tier.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro import models as jmodels  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.core.types import Request as JRequest  # noqa: E402
from repro.serving.engine import Engine  # noqa: E402
from repro.serving.scheduler import SchedulerConfig as JSched  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import get_smoke as tsmoke  # noqa: E402
from repro_torch.core.types import Request, RequestState  # noqa: E402
from repro_torch.serving import cache_utils  # noqa: E402
from repro_torch.serving.engine import TorchEngine  # noqa: E402
from repro_torch.serving.scheduler import SchedulerConfig  # noqa: E402

PAGE = 16
PROMPT = np.arange(1, 28)           # tests/test_toolcalls.py's prompt
MAX_NEW, AT = 10, 4                 # suspend after AT of MAX_NEW tokens
HOLD = 8                            # steps of other traffic while parked

# (config, layout, mixed)
CASES = {"paged": ("tiny-agent", "paged", False),
         "paged-mixed": ("tiny-agent", "paged", True),
         "ring": ("tiny-agent", "ring", False)}
HYMBA = {"hymba-ring": ("hymba-1.5b", "ring", False)}
XLSTM = {"xlstm-ring": ("xlstm-350m", "ring", False)}


def _cfgs(name):
    if name in ("hymba-1.5b", "xlstm-350m"):
        return (jsmoke(name).replace(dtype="float32"),
                tsmoke(name).replace(dtype="float32"))
    return (jget(name).replace(dtype="float32"),
            tget(name).replace(dtype="float32"))


@functools.lru_cache(maxsize=None)
def _tree(name):
    return jax.device_get(jmodels.init(_cfgs(name)[0], jax.random.key(0)))


def _sched(mixed, host_pages=32, **kw):
    return dict(max_slots=2, num_pages=64, max_context=128, page_size=PAGE,
                host_capacity_pages=host_pages, mixed=mixed, **kw)


def port_engine(case, name="port", **kw):
    cfg_name, layout, mixed = case
    tcfg = _cfgs(cfg_name)[1]
    return TorchEngine(tcfg, tmodels.from_jax(tcfg, _tree(cfg_name),
                                              device="cpu"),
                       SchedulerConfig(**_sched(mixed, **kw)), name=name,
                       cache_layout=layout, device="cpu")


def jax_engine(case, name="ref", **kw):
    cfg_name, layout, mixed = case
    jcfg = _cfgs(cfg_name)[0]
    return Engine(jcfg, jax.tree.map(jax.numpy.asarray, _tree(cfg_name)),
                  JSched(**_sched(mixed, **kw)), name=name,
                  cache_layout=layout)


def _request(cls, prompt, max_new=MAX_NEW, **meta):
    r = cls(prompt_len=len(prompt), max_new_tokens=max_new,
            prompt_tokens=np.asarray(prompt, np.int32))
    r.meta.update(meta)
    return r


def unsuspended(eng, cls, prompt=PROMPT, max_new=MAX_NEW):
    r = _request(cls, prompt, max_new)
    eng.submit(r)
    eng.run_until_idle()
    assert r.state.value == "finished"
    return list(r.output_tokens)


def decode_partially(eng, cls, prompt=PROMPT, upto=AT, **meta):
    r = _request(cls, prompt, **meta)
    eng.submit(r)
    while r.generated < upto:
        eng.step()
    return r


def other_prompt(vocab, n=20):
    return np.random.default_rng(7).integers(0, vocab, n).astype(np.int32)


def host_leaves(eng, r):
    state = eng._host_store[r.req_id]
    leaves = cache_utils._leaves(state["cache"])
    assert all(t.device.type == "cpu" for t in leaves)
    assert sum(t.numel() * t.element_size() for t in leaves) \
        == state["nbytes"]
    return state


# ---------------------------------------------------------------------------
# The host tier: warm resume and cross-engine migration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list({**CASES, **XLSTM}.values()),
                         ids=list({**CASES, **XLSTM}))
def test_warm_resume_and_migrate_match_reference(case):
    ref = unsuspended(jax_engine(case), JRequest)
    assert unsuspended(port_engine(case), Request) == ref

    # same-engine warm resume: spill to the host, reclaim, decode on
    eng = port_engine(case, "tc-home")
    r = decode_partially(eng, Request)
    assert eng.suspend_request(r, offload=True) == "host"
    assert eng.scheduler.num_running == 0
    assert eng.scheduler.alloc.is_suspended(r.req_id)
    host_leaves(eng, r)
    assert eng.resume_suspended(r) == "hit"
    assert r.req_id not in eng._host_store
    eng.run_until_idle()
    assert r.state == RequestState.FINISHED
    assert list(r.output_tokens) == ref

    # cross-engine migrate: the host copy lands on a sibling through the
    # handoff admission path and decoding continues token-exact there
    src, dst = port_engine(case, "tc-src"), port_engine(case, "tc-dst")
    r2 = decode_partially(src, Request)
    assert src.suspend_request(r2, offload=True) == "host"
    host_leaves(src, r2)
    assert src.migrate_suspended(r2, dst)
    assert not src.scheduler.alloc.is_suspended(r2.req_id)
    assert r2.req_id not in src._host_store
    dst.run_until_idle()
    assert r2.state == RequestState.FINISHED
    assert list(r2.output_tokens) == ref
    assert dst.scheduler.resume_hits == 1


# ---------------------------------------------------------------------------
# The pin tier with traffic in between (reference fault 4)
# ---------------------------------------------------------------------------

def pinned_with_traffic(eng, cls, vocab):
    """Park a request in its slot after AT tokens, run HOLD steps of a
    second request beside it, resume, finish.  Returns (its tokens, the
    parked slot's ``pos`` before and after the hold)."""
    r = decode_partially(eng, cls)
    assert eng.suspend_request(r, offload=False) == "pin"
    pos0 = int(np.asarray(eng.cache["pos"])[r.slot])
    eng.submit(_request(cls, other_prompt(vocab)))
    for _ in range(HOLD):
        eng.step()
    pos1 = int(np.asarray(eng.cache["pos"])[r.slot])
    assert eng.resume_suspended(r) == "pin"
    eng.run_until_idle()
    assert r.state.value == "finished"
    return list(r.output_tokens), (pos0, pos1)


@pytest.mark.parametrize("case", list({**CASES, **HYMBA, **XLSTM}.values()),
                         ids=list({**CASES, **HYMBA, **XLSTM}))
def test_pin_tier_keeps_the_parked_slot(case):
    jcfg = _cfgs(case[0])[0]
    want = unsuspended(port_engine(case), Request)
    got, (pos0, pos1) = pinned_with_traffic(port_engine(case), Request,
                                            jcfg.vocab)
    assert pos1 == pos0 == len(PROMPT) + AT - 1
    assert got == want
    # reference fault 4: the JAX Engine advances the parked slot
    jwant = unsuspended(jax_engine(case), JRequest)
    assert jwant == want
    jgot, (jpos0, jpos1) = pinned_with_traffic(jax_engine(case), JRequest,
                                               jcfg.vocab)
    assert jpos1 > jpos0
    assert jgot[:AT] == want[:AT] and jgot != want


# ---------------------------------------------------------------------------
# The ladder's other rungs
# ---------------------------------------------------------------------------

def test_starved_pin_is_demoted_to_the_host():
    """Both slots parked on blocked tools and work waiting: the oldest
    pin is extracted to the host tier so the queued call runs; both
    resume with their unsuspended tokens."""
    case = CASES["paged"]
    vocab = _cfgs(case[0])[1].vocab
    prompts = [PROMPT, other_prompt(vocab), other_prompt(vocab, 33)]
    want = [unsuspended(port_engine(case), Request, p) for p in prompts]
    eng = port_engine(case)
    r1 = decode_partially(eng, Request, prompts[0], tool_blocked=True)
    r2 = decode_partially(eng, Request, prompts[1], tool_blocked=True)
    for r in (r1, r2):
        assert eng.suspend_request(r, offload=False) == "pin"
    r3 = _request(Request, prompts[2])
    eng.submit(r3)
    eng.step()
    assert eng.demote_count == 1
    assert r1.meta["suspend_tier"] == "host" and r1.slot == -1
    host_leaves(eng, r1)
    while r3.state != RequestState.FINISHED:
        eng.step()
    assert eng.resume_suspended(r1) == "hit"
    assert eng.resume_suspended(r2) == "pin"
    eng.run_until_idle()
    assert [list(r.output_tokens) for r in (r1, r2, r3)] == want


def test_full_host_tier_recomputes():
    """No host room: the suspend drops the KV, the resume folds the
    generated tokens into the prompt and prefills it again; the tokens
    equal the JAX Engine's on the same path."""
    case = CASES["paged"]
    out = []
    for make, cls in ((jax_engine, JRequest), (port_engine, Request)):
        eng = make(case, host_pages=0)
        r = decode_partially(eng, cls)
        assert eng.suspend_request(r, offload=True) == "drop"
        assert r.req_id not in eng._host_store
        assert eng.resume_suspended(r) == "recompute"
        eng.run_until_idle()
        assert r.state.value == "finished"
        assert eng.scheduler.resume_recomputes == 1
        out.append(list(r.output_tokens))
    assert out[1] == out[0]
    assert len(out[1]) == MAX_NEW
