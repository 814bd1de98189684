"""The control plane over a live ``TorchEngine`` against the JAX package.

The control-plane modules are copies: each differs from its source in
``src/repro/`` only in import paths (and in the listed edits), and
``repro_torch.core`` exports what ``repro.core`` exports.  On tiny-agent
f32 with the reference's weights (``from_jax``), the port's serve_llm
twin (``repro_torch/examples/serve_llm.py``) and the JAX package's
serve_llm flow give the same tokens per request, the same controller
action log and the same final knob values; and a live ``Tracer`` on
either engine records the same segment spans per request, a tool-call
suspend included.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

import repro.core  # noqa: E402
import repro_torch.core  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core import Controller as JController  # noqa: E402
from repro.core import Registry as JRegistry  # noqa: E402
from repro.core import Tracer as JTracer  # noqa: E402
from repro.core import compile_intent as jcompile  # noqa: E402
from repro.core.controller import ControlContext as JControlContext  # noqa: E402
from repro.core.metrics import CentralPoller as JCentralPoller  # noqa: E402
from repro.core.metrics import Collector as JCollector  # noqa: E402
from repro.core.metrics import StateStore as JStateStore  # noqa: E402
from repro.core.types import Request as JRequest  # noqa: E402
from repro.serving.engine import Engine  # noqa: E402
from repro.serving.scheduler import SchedulerConfig as JSched  # noqa: E402
from repro.sim.clock import EventLoop as JEventLoop  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import Registry, Tracer  # noqa: E402
from repro_torch.core.types import Request  # noqa: E402
from repro_torch.examples import serve_llm  # noqa: E402
from repro_torch.serving.engine import TorchEngine  # noqa: E402
from repro_torch.serving.scheduler import SchedulerConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# each copied module, with the edits its copy makes beyond the import
# paths: (pattern in the source, replacement) as regular expressions,
# each matching once; the copies drop unused imports and the source's
# issue-number references
COPIES = {
    "core/types.py": (), "core/knobs.py": (), "core/metrics.py": (),
    "core/registry.py": (), "core/rules.py": (), "core/controller.py": (),
    "core/intent.py": (), "core/trace.py": (), "core/dataplane.py": (),
    "core/tenancy.py": (), "core/__init__.py": (),
    "core/policies.py": ((r"plane \([A-Z]+ 4\): flip", "plane: flip"),),
    "sim/clock.py": (), "sim/network.py": (),
    "serving/kv_cache.py": (), "serving/prefix_cache.py": (),
    "serving/scheduler.py": (
        (r"import Priority, Request, RequestState",
         "import Request, RequestState"),
        (r"\([A-Z]+ 4's \"(prefill-only engines never decode)\"\)",
         r"(\1)")),
    "serving/engine_base.py": (
        (r"\(PrefillWork, Scheduler, SchedulerConfig,\n +StepKind, StepPlan\)",
         "(PrefillWork, Scheduler,\n" + " " * 43 + "SchedulerConfig)"),),
    "configs/base.py": (), "configs/paper_agentic.py": (),
    "serving/router.py": (), "serving/kv_transfer.py": (),
    "serving/engine_sim.py": (), "serving/disagg.py": (),
    "agents/protocol.py": (), "agents/stage.py": (), "agents/agent.py": (),
    "agents/graph.py": (), "agents/workloads.py": (),
    "agents/__init__.py": (),
    # the port reads its own fits, never the JAX package's
    "agents/pipeline.py": (
        (r"REPRO_CALIB_DIR env / artifacts/bench default",
         "REPRO_TORCH_CALIB_DIR env / artifacts/torch default"),),
    # the elastic tester group every AgenticPipeline builds, and the
    # heartbeat monitor it attaches new replicas to
    "runtime/elastic.py": (), "runtime/heartbeat.py": (),
    # the training slice: the token pipeline, the supervisor and the
    # straggler policy; the package inits of runtime, data, checkpoint
    # and optim export what the reference's export
    "data/pipeline.py": (), "data/__init__.py": (),
    "runtime/supervisor.py": (), "runtime/straggler.py": (),
    "runtime/__init__.py": (), "checkpoint/__init__.py": (),
    "optim/__init__.py": (),
}


@pytest.mark.parametrize("path", sorted(COPIES))
def test_copy_differs_from_its_source_only_in_import_paths(path):
    src = (ROOT / "src" / "repro" / path).read_text()
    want = src.replace("repro.", "repro_torch.")
    for pattern, repl in COPIES[path]:
        want, n = re.subn(pattern, repl, want)
        assert n == 1, pattern
    assert (ROOT / "src" / "repro_torch" / path).read_text() == want


def test_core_exports_what_the_reference_exports():
    assert repro_torch.core.__all__ == repro.core.__all__
    for name in repro.core.__all__:
        got, want = getattr(repro_torch.core, name), getattr(repro.core, name)
        if isinstance(want, dict):                  # AGGREGATIONS
            assert got.keys() == want.keys()
        else:
            assert (got.__module__, got.__name__) == (
                want.__module__.replace("repro.", "repro_torch."),
                want.__name__)


# ---------------------------------------------------------------------------
# The serve_llm flow in both packages
# ---------------------------------------------------------------------------

# serve_llm's intent with a rule first that reopens admission when
# nothing runs: with 16 requests on 4 slots the shed rule fires and holds
# every LOW request, and queue_len never falls to 2 by itself
REOPEN = """
rule drain: when last(llm-0.num_running) <= 0 => reset llm-0.admit_priority_min
""" + serve_llm.INTENT.replace(
    "set llm-0.admit_priority_min 1",
    "set llm-0.admit_priority_min 1; set llm-0.prefill_chunk 8").replace(
    "reset llm-0.admit_priority_min\n",
    "reset llm-0.admit_priority_min; reset llm-0.prefill_chunk\n")
FLOWS = {"serve_llm": (10, serve_llm.INTENT), "shed-and-reopen": (16, REOPEN)}


def weights():
    jcfg = jget("tiny-agent").replace(dtype="float32")
    tcfg = tget("tiny-agent").replace(dtype="float32")
    return jcfg, tcfg, jax.device_get(jmodels.init(jcfg, jax.random.key(0)))


def jax_flow(cfg, tree, specs, intent, max_steps=200):
    """examples/serve_llm.py's flow on the JAX Engine, on ``specs``'
    prompts and priorities."""
    collector = JCollector("serve")
    eng = Engine(cfg, jax.tree.map(jax.numpy.asarray, tree),
                 JSched(max_slots=4, num_pages=128, max_context=128),
                 name="llm-0", collector=collector)
    registry = JRegistry()
    registry.register(eng)
    poller = JCentralPoller(JStateStore())
    poller.attach(collector)
    controller = JController(JEventLoop(), registry, poller)
    controller.install(jcompile(intent))
    reqs = [JRequest(prompt_len=r.prompt_len, max_new_tokens=r.max_new_tokens,
                     priority=int(r.priority), prompt_tokens=r.prompt_tokens)
            for r in specs]
    for r in reqs:
        eng.submit(r)
    for _ in range(max_steps):
        if not eng.busy:
            break
        eng.step()
        poller.poll(eng.now())
        ctx = JControlContext(controller)
        for pol in controller.policies:
            pol.on_tick(ctx)
    registry.set("llm-0", "max_num_seqs", 2)
    return eng, reqs, controller


@pytest.mark.parametrize("flow", list(FLOWS.values()), ids=list(FLOWS))
def test_serve_llm_twin_matches_the_reference_flow(flow):
    n, intent = flow
    jcfg, tcfg, tree = weights()
    eng, reqs, registry, controller = serve_llm.run(
        tcfg, tmodels.from_jax(tcfg, tree, device="cpu"), device="cpu",
        n_requests=n, intent=intent)
    registry.set("llm-0", "max_num_seqs", 2)
    jeng, jreqs, jcontroller = jax_flow(
        jcfg, tree, serve_llm.make_requests(tcfg.vocab, n), intent)

    assert all(r.state.value == "finished" for r in reqs + jreqs)
    assert [list(r.output_tokens) for r in reqs] \
        == [list(r.output_tokens) for r in jreqs]
    log = [(a.kind, a.target, a.detail) for a in controller.actions]
    assert log == [(a.kind, a.target, a.detail) for a in jcontroller.actions]
    if n > 10:                      # both knobs set, then reset at the end
        assert log[:2] == [("set", "llm-0", "admit_priority_min=1"),
                           ("set", "llm-0", "prefill_chunk=8")]
        assert ("reset", "llm-0", "admit_priority_min") in log
        assert log[-1] == ("reset", "llm-0", "prefill_chunk")
    knobs = jeng.knob_names()
    assert set(knobs) <= set(eng.knob_names())
    assert {k: eng.get_param(k) for k in knobs} \
        == {k: jeng.get_param(k) for k in knobs}
    assert eng.scheduler.cfg.max_slots == 2


# ---------------------------------------------------------------------------
# A live Tracer
# ---------------------------------------------------------------------------

def traced_run(eng, cls, prompts, tracer):
    """Serve ``prompts`` with ``tracer`` on the engine; the first request
    is suspended to the host after two tokens and resumed.  Returns each
    request's span names, in order of opening, its id masked."""
    tracer.set_scope(None, 1.0)
    eng.tracer = tracer
    reqs = [cls(prompt_len=len(p), max_new_tokens=6, prompt_tokens=p)
            for p in prompts]
    for r in reqs:
        eng.submit(r)
    while reqs[0].generated < 2:
        eng.step()
    assert eng.suspend_request(reqs[0], offload=True) == "host"
    eng.step()
    assert eng.resume_suspended(reqs[0]) == "hit"
    eng.run_until_idle()
    spans = sorted(tracer.all_spans(), key=lambda s: s.span_id)
    return [[s.name.replace(r.req_id, "R") for s in spans
             if s.attrs.get("req_id") == r.req_id] for r in reqs]


def test_live_tracer_records_the_same_spans():
    jcfg, tcfg, tree = weights()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab, n).astype(np.int32)
               for n in (27, 12, 19)]
    sched = dict(max_slots=4, num_pages=64, max_context=128, page_size=16,
                 host_capacity_pages=32)
    teng = TorchEngine(tcfg, tmodels.from_jax(tcfg, tree, device="cpu"),
                       SchedulerConfig(**sched), name="llm-0",
                       cache_layout="paged", device="cpu")
    jeng = Engine(jcfg, jax.tree.map(jax.numpy.asarray, tree),
                  JSched(**sched), name="llm-0", cache_layout="paged")
    got = traced_run(teng, Request, prompts, Tracer(teng.now))
    want = traced_run(jeng, JRequest, prompts, JTracer(jeng.now))
    assert got == want
    assert got[0] == ["request:R", "queue_wait", "prefill", "decode",
                      "suspended", "decode"]


def test_slot_knob_shrinks_a_running_engine():
    """``max_num_seqs`` set below the running count through the Registry
    mid-run: the sequences in the slots above it run to the end with
    the tokens of a run without the move, on the step buffers sized by
    the cache's slots, and only the slots below it return to the pool."""
    _, tcfg, tree = weights()
    params = tmodels.from_jax(tcfg, tree, device="cpu")
    specs = serve_llm.make_requests(tcfg.vocab, 6)

    def run(shrink):
        eng = TorchEngine(tcfg, params, SchedulerConfig(
            max_slots=4, num_pages=128, max_context=128), name="llm-0",
            cache_layout="paged", device="cpu")
        registry = Registry()
        registry.register(eng)
        reqs = [Request(prompt_len=r.prompt_len, max_new_tokens=12,
                        prompt_tokens=r.prompt_tokens) for r in specs]
        for r in reqs:
            eng.submit(r)
        for _ in range(3):
            eng.step()
        if shrink:
            assert {r.slot for r in reqs[:4]} == {0, 1, 2, 3}
            registry.set("llm-0", "max_num_seqs", 2)
        eng.run_until_idle()
        assert all(r.state.value == "finished" for r in reqs)
        assert eng.step_captures["decode"] == 1
        return [list(r.output_tokens) for r in reqs], eng

    want, _ = run(False)
    got, eng = run(True)
    assert got == want
    assert sorted(eng.scheduler._free_slots) == [0, 1]
