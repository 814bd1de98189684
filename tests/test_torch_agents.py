"""The port's agent planes against the JAX package.

``agents/*`` are copies (``tests/test_torch_control_plane.py`` checks
the text).  With the port's cost figures set to the reference's (the
port reads them through ``repro_torch.sim.costmodel`` at call time),
both id counters restarted and both event loops clamped as
``tests/test_examples.py`` clamps them, the quickstart pipeline under its
intent and the fig1, map_reduce and debate workflow pipelines give the
same action log, task completions and latency percentiles.  A ``DisaggPool`` of a prefill-role and a
decode-role ``TorchEngine`` on tiny-agent f32 with the reference's
weights hands every request through ``extract_state`` /
``receive_handoff`` and gives the greedy tokens of one ``TorchEngine``
and of the same pair of JAX ``Engine``s.

Tolerances: sim runs exact (the same events in the same order on the
same virtual clock); tokens exact.
"""
import importlib
import itertools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
from test_examples import CLOCK_BUDGET  # noqa: E402

import jax  # noqa: E402

import repro.agents  # noqa: E402
import repro.core.types as jtypes  # noqa: E402
import repro.sim.costmodel as jcm  # noqa: E402
import repro_torch.agents  # noqa: E402
import repro_torch.core.types as ttypes  # noqa: E402
import repro_torch.sim.costmodel as tcm  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.sim.clock import EventLoop as JEventLoop  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.sim.clock import EventLoop as TEventLoop  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
@pytest.fixture
def aligned(monkeypatch):
    """The port's cost figures set to the JAX package's, both id
    counters restarted at 0, and both event loops clamped to
    ``tests/test_examples.py``'s budget."""
    for name in ("PEAK_FLOPS", "HBM_BW", "HOST_BW", "STEP_OVERHEAD"):
        monkeypatch.setattr(tcm, name, getattr(jcm, name))
    for loop in (JEventLoop, TEventLoop):
        orig = loop.run_until

        def bounded(self, t_end=float("inf"), max_events=10_000_000,
                    orig=orig):
            return orig(self, min(t_end, CLOCK_BUDGET), max_events)
        monkeypatch.setattr(loop, "run_until", bounded)

    def restart():
        jtypes._ids = itertools.count()
        ttypes._ids = itertools.count()
    # registered unchanged, so that teardown puts the counters back
    monkeypatch.setattr(jtypes, "_ids", jtypes._ids)
    monkeypatch.setattr(ttypes, "_ids", ttypes._ids)
    return restart


def test_agents_export_what_the_reference_exports():
    assert repro_torch.agents.__all__ == repro.agents.__all__
    for name in repro.agents.__all__:
        got, want = (getattr(repro_torch.agents, name),
                     getattr(repro.agents, name))
        assert (got.__module__, got.__name__) == (
            want.__module__.replace("repro.", "repro_torch."), want.__name__)


# ---------------------------------------------------------------------------
# Pipelines in both packages
# ---------------------------------------------------------------------------

QUICKSTART_INTENT = """
objective: maximize throughput under p95(pipeline.task_latency) <= 4.0
rule overload:  when mean(tester-0.queue_len, 1.0) > 12
    => granularity dev->tester batch; set tester-0.decode_first true
rule loaded:    when mean(tester-0.queue_len, 1.0) > 3
    => granularity dev->tester pipeline; reset tester-0.decode_first
rule idle:      when mean(tester-0.queue_len, 1.0) <= 3
    => granularity dev->tester stream
"""
POOL = {"large": ("agent-7b", 4, 2, 16), "small": ("agent-1b", 1, 2, 16)}


def run_pipeline(root: str, kind: str) -> dict:
    """One pipeline of package ``root``: the quickstart AgenticPipeline
    under its intent and phased load, the fig1 graph built into the
    classic pipeline, or a map_reduce / debate WorkflowPipeline with a
    burst of graph tasks."""
    ag = importlib.import_module(f"{root}.agents")
    wl = importlib.import_module(f"{root}.agents.workloads")
    intent = importlib.import_module(f"{root}.core.intent")
    types = importlib.import_module(f"{root}.core.types")
    if kind == "quickstart":
        p = ag.AgenticPipeline(ag.PipelineConfig(
            granularity=types.Granularity.PIPELINE, n_testers=1,
            stream_chunk=2))
        p.controller.install(intent.compile_intent(QUICKSTART_INTENT))
        wl.PhasedLoad(p, ag.WorkloadConfig(think_time=0.3),
                      [wl.Phase(5.0, 2), wl.Phase(5.0, 48),
                       wl.Phase(5.0, 2)]).start()
        p.run(until=16.0)
    elif kind == "fig1":
        p = ag.AgenticPipeline.build(ag.fig1(), ag.PipelineConfig(n_testers=2))
        for i in range(6):
            p.submit(ag.TaskSpec(session=f"s{i % 3}", n_functions=3))
        p.run(until=30.0)
    else:
        graph = ag.map_reduce(width=4) if kind == "map_reduce" \
            else ag.debate()
        p = ag.AgenticPipeline.build(graph, ag.WorkflowConfig(tiers={
            t: ag.TierSpec(m, chips=c, replicas=r, slots=s)
            for t, (m, c, r, s) in POOL.items()}))
        p.controller.install(intent.compile_intent(
            "rule slow on stage map.p95 > 0.2 hold 2:\n"
            "    => set stage map.model_tier small\n"
            if kind == "map_reduce" else
            "rule busy: when mean(wf-large-0.queue_len, 1.0) > 2\n"
            "    => set wf-large-0.decode_first true\n"))
        ag.GraphBurst(p, n_tasks=6, stagger=0.05).start()
        p.run(until=60.0)
    lat = p.latencies()
    return {"done": [(t.submitted_at, t.finished_at) for t in p.done],
            "actions": [(a.t, a.kind, a.target, a.detail)
                        for a in p.controller.actions],
            "p50_p95_p99": (list(np.percentile(lat, [50, 95, 99]))
                            if lat else []),
            "now": p.loop.now()}


@pytest.mark.parametrize("kind", ["quickstart", "fig1", "map_reduce",
                                  "debate"])
def test_pipeline_runs_as_the_reference(kind, aligned):
    aligned()
    want = run_pipeline("repro", kind)
    aligned()
    got = run_pipeline("repro_torch", kind)
    assert got == want
    assert got["done"]
    if kind in ("quickstart", "map_reduce"):
        assert got["actions"]


# ---------------------------------------------------------------------------
# A live pair behind the DisaggPool on the CPU
# ---------------------------------------------------------------------------

LENS = [20, 33, 47, 5, 60, 12]
NEW = 8
SCHED = dict(max_slots=4, num_pages=64, page_size=16, max_context=128)


def drive(loop, engines, reqs, rounds=10_000) -> None:
    """Run the event loop dry (routed prompts land, handoffs arrive),
    then step each busy engine; until every request has finished."""
    for _ in range(rounds):
        loop.run_until()
        if all(r.state.value == "finished" for r in reqs):
            return
        busy = [e for e in engines if e.busy]
        assert busy, [r.state.value for r in reqs]
        for e in busy:
            e.step()
    raise AssertionError("unfinished")


def live_pair(root: str, cfg, params, make_engine) -> tuple:
    """``root``'s DisaggPool over a prefill-role and a decode-role engine
    from ``make_engine(sched, name)``, serving ``LENS``: (tokens per
    request, handoffs, extracts, landed receives)."""
    m = {k: importlib.import_module(f"{root}.{k}") for k in (
        "core.types", "serving.disagg", "serving.kv_transfer",
        "serving.scheduler", "sim.clock", "sim.costmodel")}
    loop = m["sim.clock"].EventLoop()
    engines = [make_engine(m["serving.scheduler"].SchedulerConfig(
        **SCHED, role=role), f"{role}-0") for role in ("prefill", "decode")]
    cm = m["sim.costmodel"].CostModel(cfg)
    kvt = m["serving.kv_transfer"]
    kvx = kvt.KVTransferManager(loop, kvt.SessionDirectory(),
                                bytes_fn=cm.kv_transfer_bytes)
    pool = m["serving.disagg"].DisaggPool(loop, engines, kvx)
    calls = {"extract": 0, "receive": 0}
    pre, dec = engines
    extract, receive = pre.extract_state, dec.receive_handoff

    def counted_extract(req):
        calls["extract"] += 1
        return extract(req)

    def counted_receive(req, state):
        landed = receive(req, state)
        calls["receive"] += landed
        return landed
    pre.extract_state, dec.receive_handoff = counted_extract, counted_receive
    reqs = requests(m["core.types"].Request, cfg.vocab)
    for r in reqs:
        pool.submit(r)
    drive(loop, engines, reqs)
    assert pre.decode_steps == 0 and dec.prefill_steps == 0
    return ([list(map(int, r.output_tokens)) for r in reqs], pool.handoffs,
            calls["extract"], calls["receive"])


def requests(request_type, vocab: int) -> list:
    rng = np.random.default_rng(3)
    return [request_type(prompt_len=n, max_new_tokens=NEW,
                         prompt_tokens=rng.integers(0, vocab, n).astype(
                             np.int32)) for n in LENS]


def test_live_pair_gives_one_engines_tokens_and_the_jax_pairs():
    from repro.serving.engine import Engine
    from repro_torch.serving.engine import TorchEngine
    from repro_torch.serving.scheduler import SchedulerConfig

    jcfg = jget("tiny-agent").replace(dtype="float32")
    tcfg = tget("tiny-agent").replace(dtype="float32")
    tree = jax.device_get(jmodels.init(jcfg, jax.random.key(0)))
    params = tmodels.from_jax(tcfg, tree, device="cpu")

    def torch_engine(sched, name):
        return TorchEngine(tcfg, params, sched, name=name,
                           cache_layout="paged", device="cpu")

    def jax_engine(sched, name):
        return Engine(jcfg, jax.tree.map(jax.numpy.asarray, tree), sched,
                      name=name, cache_layout="paged")

    single = torch_engine(SchedulerConfig(**SCHED), "single")
    reqs = requests(ttypes.Request, tcfg.vocab)
    for r in reqs:
        single.submit(r)
    single.run_until_idle()
    want = [list(map(int, r.output_tokens)) for r in reqs]
    assert all(len(t) == NEW for t in want)

    got = live_pair("repro_torch", tcfg, params, torch_engine)
    assert got == (want, len(LENS), len(LENS), len(LENS))
    assert live_pair("repro", jcfg, None, jax_engine) == got
