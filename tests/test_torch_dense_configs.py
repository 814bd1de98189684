"""Every config of the reference's registry in the port, and the four
dense architectures this slice adds (gemma3-27b, h2o-danube-3-4b,
llama3-405b, command-r-plus-104b) against the JAX reference.

Config level: ``get_config`` and ``get_smoke`` resolve every name the
JAX registry resolves (its ``ARCHS`` and the paper's extras) with equal
fields, equal stack plans and equal parameter counts at full width.

Model level, f32 on each smoke config with the reference's weights
(``from_jax``): ring prefill logits within 1e-4 and decode logits
within 2e-3 (the reference's bands, tests/test_paged_engine.py:91-93),
kernel flag off and on (the port's plain kernel versions on the CPU).
gemma3's smoke runs 13 layers (two local:global cycles of 5 + 1 and one
local layer) with qk-norm and the logit softcap; command-r's the
parallel block.

Engine level: greedy tokens equal to the JAX ``Engine``'s in the paged
and ring layouts and with the mixed step (paged, chunks of 16).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.core.types import Request as JRequest  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving.engine import Engine  # noqa: E402
from repro.serving.scheduler import SchedulerConfig as JSched  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.core.types import Request  # noqa: E402
from repro_torch.serving.engine import TorchEngine  # noqa: E402
from repro_torch.serving.scheduler import SchedulerConfig  # noqa: E402

DENSE = ("gemma3-27b", "h2o-danube-3-4b", "llama3-405b",
         "command-r-plus-104b")
EXTRAS = ("tiny-agent", "lm-100m", "agent-7b", "agent-1b")
TOL = 1e-4
DECODE_TOL = 2e-3
SCHED = dict(max_slots=3, num_pages=64, max_context=128, page_size=16,
             max_batch_tokens=64)
LENS = [20, 45, 33, 60]


def _fields(cfg):
    return dataclasses.asdict(cfg)


# ---------------------------------------------------------------------------
# Config level
# ---------------------------------------------------------------------------

def test_registry_resolves_every_reference_name():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    for name in jconfigs.ARCHS + EXTRAS:
        assert _fields(tconfigs.get_config(name)) == \
            _fields(jconfigs.get_config(name)), name
        assert _fields(tconfigs.get_smoke(name)) == \
            _fields(jconfigs.get_smoke(name)), name
    with pytest.raises(KeyError, match="unknown config"):
        tconfigs.get_config("gpt-5")


@pytest.mark.parametrize("name", jconfigs.ARCHS + EXTRAS)
def test_plans_and_param_counts_match(name):
    """The same stack plan (segments, block specs, repeats), encoder plan
    and parameter count at full width."""
    jcfg, tcfg = jconfigs.get_config(name), tconfigs.get_config(name)
    jplan = [(s.repeat, [(_fields(b), n) for b, n in s.pattern])
             for s in jcfg.plan()]
    tplan = [(s.repeat, [(_fields(b), n) for b, n in s.pattern])
             for s in tcfg.plan()]
    assert tplan == jplan
    if jcfg.is_encdec:
        assert [s.n_layers for s in tcfg.enc_plan()] == \
            [s.n_layers for s in jcfg.enc_plan()]
    assert tmodels.param_count(tcfg) == jmodels.param_count(jcfg)


# ---------------------------------------------------------------------------
# Model level
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tree(name):
    jcfg = jconfigs.get_smoke(name).replace(dtype="float32")
    return jax.device_get(jmodels.init(jcfg, jax.random.key(0)))


def setup(name, **kw):
    jcfg = jconfigs.get_smoke(name).replace(dtype="float32")
    tcfg = tconfigs.get_smoke(name).replace(dtype="float32", **kw)
    tree = _tree(name)
    return jcfg, tcfg, tree, tmodels.from_jax(tcfg, tree, device="cpu")


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "kernel"])
@pytest.mark.parametrize("name", DENSE)
def test_ring_logit_parity(name, use_pallas):
    """One-shot ring prefill of a 70-token batch of two (longer than the
    smoke windows' 24-slot rings), then six decode steps."""
    jcfg, tcfg, tree, tparams = setup(name, use_pallas=use_pallas)
    jparams = jax.tree.map(jnp.asarray, tree)
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (2, 70))
    toks = toks.astype(np.int32)
    jcache = jmodels.init_cache(jcfg, 2, 96)
    tcache = tmodels.init_cache(tcfg, 2, 96, device="cpu")
    lj, jcache = jtfm.prefill(jparams, jcfg, jnp.asarray(toks), jcache)
    lt, tcache = tmodels.prefill(tparams, tcfg, torch.from_numpy(toks).long(),
                                 tcache)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL, atol=TOL)
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


def test_gemma3_smoke_plan_runs_local_and_global_rings():
    """gemma3's smoke nests its 5:1 cycle twice and ends on one local
    layer; local rings hold window + chunk = 24 slots, global ones the
    whole context."""
    _, tcfg, _, _ = setup("gemma3-27b")
    cache = tmodels.init_cache(tcfg, 2, 96, device="cpu")
    seg = cache["segments"]
    assert [s.repeat for s in tcfg.plan()] == [2, 1]
    assert seg[0]["e0"]["kv"].k.shape[:3] == (2, 5, 2)
    assert seg[0]["e0"]["kv"].k.shape[3] == 24
    assert seg[0]["e1"]["kv"].k.shape[3] == 96
    assert seg[1]["e0"]["kv"].k.shape[:3] == (1, 2, 24)


# ---------------------------------------------------------------------------
# Engine level
# ---------------------------------------------------------------------------

def prompts(vocab, lens=LENS, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def serve(eng, cls, ps, max_new=8):
    reqs = [cls(prompt_len=len(p), max_new_tokens=max_new, prompt_tokens=p)
            for p in ps]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    for r in reqs:
        assert r.state.value == "finished"
        assert len(r.output_tokens) == max_new
    return [list(r.output_tokens) for r in reqs]


@functools.lru_cache(maxsize=None)
def reference_tokens(name, layout, mixed):
    jcfg, _, tree, _ = setup(name)
    sched = dict(SCHED, mixed=mixed, prefill_chunk=16 if mixed else 0)
    eng = Engine(jcfg, jax.tree.map(jnp.asarray, tree), JSched(**sched),
                 cache_layout=layout)
    return serve(eng, JRequest, prompts(jcfg.vocab))


MODES = [("paged", False), ("ring", False), ("paged", True)]


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "kernel"])
@pytest.mark.parametrize("layout,mixed", MODES,
                         ids=["paged", "ring", "mixed"])
@pytest.mark.parametrize("name", DENSE)
def test_greedy_tokens_match_reference_engine(name, layout, mixed,
                                              use_pallas):
    _, tcfg, _, tparams = setup(name, use_pallas=use_pallas)
    sched = dict(SCHED, mixed=mixed, prefill_chunk=16 if mixed else 0)
    eng = TorchEngine(tcfg, tparams, SchedulerConfig(**sched),
                      cache_layout=layout, device="cpu")
    got = serve(eng, Request, prompts(tcfg.vocab))
    assert got == reference_tokens(name, layout, mixed)
    if mixed:
        assert eng.step_captures["mixed"] == 1
