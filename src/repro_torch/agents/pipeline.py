"""Pipeline assembly — the compiler from workflow graphs to wired
serving topologies.

``AgenticPipeline.build(graph)`` is the general entry point: any
``WorkflowGraph`` (agents/graph.py) compiles into engines, channels and
routers with the metrics plane attached to every component and
everything registered with the controller.

* Graphs carrying the ``fig1`` template marker compile through the
  classic ``AgenticPipeline`` — the paper's Fig-1 topology

      clients → developer(engine) → channel(shim) → router → tester[i]

  with its DeveloperAgent/TesterAgent semantics, KV-transfer fabric,
  prefix-cache plane and elastic tester group.  All pre-graph
  ``PipelineConfig`` callers (benchmarks, examples) keep building this
  path unmodified.

* Every other graph compiles into a ``WorkflowPipeline``: a shared,
  tier-labelled engine pool behind one router (``stage_aware`` policy
  routes each stage's calls to its ``model_tier``), one ``StageAgent``
  per stage registered as a ``stage.<name>`` controllable, and one
  data-plane ``Channel`` per graph edge.  The graph is a control-plane
  object: the scheduler consumes critical-path-derived deadlines and
  longest-remaining-path boosts propagated along its edges.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.agents.agent import (DeveloperAgent, TesterAgent, ToolAgent,
                                expected_tool_latency)
from repro_torch.agents.graph import GraphTask, WorkflowGraph, fig1
from repro_torch.agents.stage import EngineWorker, StageAgent, StageKind
from repro_torch.configs import get_config
from repro_torch.core.controller import Controller
from repro_torch.core.dataplane import Channel
from repro_torch.core.metrics import CentralPoller, Collector, MetricBus, StateStore
from repro_torch.core.registry import Registry
from repro_torch.core.trace import FlightRecorder, Tracer
from repro_torch.core.types import Granularity, Priority, RequestState, fresh_id
from repro_torch.serving.disagg import DisaggPool
from repro_torch.serving.engine_sim import SimEngine
from repro_torch.serving.kv_transfer import KVTransferManager, SessionDirectory
from repro_torch.serving.prefix_cache import CacheDirectory, PrefixCache
from repro_torch.serving.router import Router
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.sim.clock import EventLoop
from repro_torch.sim.costmodel import costmodel_for
from repro_torch.sim.network import Link


@dataclass
class TaskSpec:
    """One MetaGPT-style task: write n functions, each gets tests.

    ``speculative`` flows onto the outbound channel's messages (the
    shim's speculative gate holds them while gated); ``finished_at`` is
    stamped by the pipeline's single completion path (``_task_done``)
    and backs ``throughput()``/``latencies()``.
    """

    session: str
    prompt_tokens: int = 192
    system_tokens: int = 128            # shared system preamble (cacheable)
    n_functions: int = 6
    func_tokens: int = 48
    test_tokens: int = 40
    priority: Priority = Priority.NORMAL
    speculative: bool = False
    task_id: str = field(default_factory=lambda: fresh_id("task"))
    submitted_at: float = 0.0
    finished_at: float = 0.0


@dataclass
class PipelineConfig:
    model: str = "agent-7b"             # cost-model architecture
    n_testers: int = 1
    dev_chips: int = 4                  # developer engine TP degree
    tester_chips: int = 4               # per-tester-instance TP degree
    granularity: Granularity = Granularity.PIPELINE
    stream_chunk: int = 4
    header_tokens: int = 64
    dev_slots: int = 32                 # developer engine batch capacity
    tester_slots: int = 12              # tester engine batch capacity
    num_pages: int = 4096
    max_context: int = 8192
    msg_bandwidth: float = 1.25e9       # 10 GbE-class agent links
    msg_proc_time: float = 1.0e-3      # per-message protocol/serde cost
    kv_bandwidth: float = 12.5e9        # 100 Gb interconnect for KV
    controller_interval: float = 0.05
    router_policy: str = "static"       # static | least_loaded | cache_aware
    # prefix-cache plane (serving/prefix_cache.py)
    prefix_cache: bool = True
    cache_block_tokens: int = 64
    cache_reserve_frac: float = 0.5
    cache_evict_policy: str = "lru"
    # measured-calibration artifacts (CALIB_*.json) for the sim engines'
    # cost models; None = REPRO_TORCH_CALIB_DIR env / artifacts/torch default,
    # with analytic-roofline fallback when no artifact exists
    calib_dir: Optional[str] = None


class ServingFabric:
    """Shared control/metrics fabric every compiled topology stands on:
    metric bus + collector + central poller + registry + controller,
    plus the task-completion bookkeeping (``done``/``latencies``/
    ``throughput``) both pipeline flavors report through."""

    def __init__(self, loop: Optional[EventLoop] = None,
                 interval: float = 0.05):
        self.loop = loop or EventLoop()
        self.bus = MetricBus()
        self.collector = Collector("pipeline", bus=self.bus)
        self.store = StateStore()
        self.poller = CentralPoller(self.store)
        self.poller.attach(self.collector)
        self.registry = Registry()
        self.controller = Controller(self.loop, self.registry, self.poller,
                                     interval=interval, bus=self.bus,
                                     collector=self.collector)
        # tracing plane: off by default (the `trace` intent verb or a
        # direct knob write turns sampling on at runtime); the flight
        # recorder always captures the controller's audit actions so a
        # later-enabled trace can still show what the control plane did
        self.tracer = Tracer(self.loop.now, collector=self.collector)
        self.registry.register(self.tracer)
        self.recorder = FlightRecorder(self.loop.now, bus=self.bus)
        self.controller.attach_recorder(self.recorder)
        self.done: list = []
        self.on_task_done = None

    def run(self, until: float) -> None:
        self.controller.start()
        self.loop.run_until(until)

    def throughput(self, t0: float = 0.0, t1: Optional[float] = None) -> float:
        t1 = t1 if t1 is not None else self.loop.now()
        n = sum(1 for s in self.done if t0 <= s.finished_at <= t1)
        return n / max(t1 - t0, 1e-9)

    def latencies(self) -> list[float]:
        return [s.finished_at - s.submitted_at for s in self.done]


class AgenticPipeline(ServingFabric):
    """The classic Fig-1 pipeline (see module docstring)."""

    def __init__(self, cfg: PipelineConfig, loop: Optional[EventLoop] = None,
                 graph: Optional[WorkflowGraph] = None):
        self.cfg = cfg
        super().__init__(loop, interval=cfg.controller_interval)
        # the fig1 topology as a graph: the same control-plane object
        # generic workflows get, so policies can read stage structure
        # (build() threads a caller-customized fig1 graph through here)
        self.graph = graph if graph is not None else fig1()
        self.controller.attach_graph(self.graph)

        model_cfg = get_config(cfg.model)
        self.costmodel = costmodel_for(model_cfg, chips=cfg.tester_chips,
                                       calib_dir=cfg.calib_dir)
        self.dev_costmodel = costmodel_for(model_cfg, chips=cfg.dev_chips,
                                           calib_dir=cfg.calib_dir)
        # page granularity bounds the effective prefix-cache block size
        # from below: keep it <= header_tokens so the shared system
        # header fills whole blocks and is actually reusable at defaults
        page = min(cfg.cache_block_tokens, max(cfg.header_tokens, 1))
        sched = lambda slots: SchedulerConfig(
            max_slots=slots, num_pages=cfg.num_pages,
            max_context=cfg.max_context, page_size=page)

        # --- KV fabric + session directory --------------------------------
        self.directory = SessionDirectory()
        # session KV is bounded by the engine's context window
        kv_bytes = lambda ctx_len: self.costmodel.kv_transfer_bytes(
            min(ctx_len, cfg.max_context))
        self.kvx = KVTransferManager(
            self.loop, self.directory, bytes_fn=kv_bytes,
            bandwidth=cfg.kv_bandwidth, collector=self.collector)

        # --- prefix-cache plane: per-instance caches + the controller-
        # visible residency directory the cache-aware router reads
        self.cache_dir = CacheDirectory()

        # --- tester instances behind the router -----------------------------
        self.router = Router(self.loop, "tester-router",
                             policy=cfg.router_policy,
                             collector=self.collector,
                             cache_dir=self.cache_dir,
                             prefix_fn=self._msg_prefix)
        self.testers: list[TesterAgent] = []
        for i in range(cfg.n_testers):
            eng = SimEngine(self.loop, self.costmodel,
                            sched(cfg.tester_slots),
                            name=f"tester-{i}", collector=self.collector)
            eng.tracer = self.tracer
            t = TesterAgent(f"tester-{i}", eng, self.loop,
                            directory=self.directory, kvx=self.kvx,
                            header_tokens=cfg.header_tokens,
                            on_task_done=self._task_done)
            self.testers.append(t)
            self.router.add_instance(t)
            self.registry.register(eng)
            self.attach_prefix_cache(eng)

        # --- developer + the controllable channel ----------------------------
        dev_eng = SimEngine(self.loop, self.dev_costmodel,
                            sched(cfg.dev_slots),
                            name="developer", collector=self.collector)
        dev_eng.tracer = self.tracer
        self.router.tracer = self.tracer
        self.kvx.tracer = self.tracer
        link = Link(self.loop, bandwidth=cfg.msg_bandwidth,
                    proc_time=cfg.msg_proc_time, name="dev-link")
        self.channel = Channel(self.loop, link, "developer", self.router,
                               name="dev->tester", collector=self.collector,
                               granularity=cfg.granularity,
                               stream_chunk=cfg.stream_chunk)
        self.developer = DeveloperAgent("developer", dev_eng, self.loop,
                                        self.channel,
                                        controller=self.controller)
        self.registry.register(dev_eng)
        self.attach_prefix_cache(dev_eng)
        self.registry.register(self.channel)
        self.registry.register(self.router)
        self.router.rules = self.controller.rules
        self.controller.attach_transfer(
            lambda sess, src, dst, proactive: self.kvx.transfer(
                sess, src, dst, proactive=proactive))

        # --- elastic tester group: a "group" controllable so intent v2's
        # ``scale tester-group ±N`` reaches the fleet through the same
        # Table-1 surface as every other knob (import is deferred —
        # runtime/elastic imports agents/agent)
        from repro_torch.runtime.elastic import ElasticGroup
        self.elastic = ElasticGroup(self, name="tester-group")
        self.registry.register(self.elastic)

        # --- bookkeeping -------------------------------------------------------
        self._inflight: dict[str, TaskSpec] = {}
        self.collector.describe(
            "pipeline.task_latency",
            "End-to-end pipeline task latency in seconds; lower is better.")

    # -- graph entry point --------------------------------------------------
    @classmethod
    def build(cls, graph: WorkflowGraph, cfg=None,
              loop: Optional[EventLoop] = None):
        """Compile a workflow graph into a wired serving topology.

        ``fig1``-template graphs build the classic pipeline (pass a
        ``PipelineConfig``); everything else builds a
        ``WorkflowPipeline`` (pass a ``WorkflowConfig``)."""
        graph.validate()
        if graph.template == "fig1":
            if cfg is not None and not isinstance(cfg, PipelineConfig):
                raise TypeError("fig1 graphs take a PipelineConfig")
            return cls(cfg or PipelineConfig(), loop, graph=graph)
        if cfg is not None and not isinstance(cfg, WorkflowConfig):
            raise TypeError(f"graph {graph.name!r} takes a WorkflowConfig")
        return WorkflowPipeline(graph, cfg, loop)

    # -- prefix-cache wiring ------------------------------------------------------
    def attach_prefix_cache(self, eng):
        """Give an engine its prefix cache (over the engine's own page
        pool), registered as a `<engine>.cache` controllable and visible
        in the shared CacheDirectory.  No-op when the plane is off."""
        cfg = self.cfg
        if not cfg.prefix_cache:
            return None
        # same clamp as the scheduler page size: blocks no larger than
        # the shared header, or the header could never fill one
        block = min(cfg.cache_block_tokens, max(cfg.header_tokens, 1))
        cache = PrefixCache(
            eng.scheduler.alloc, name=f"{eng.name}.cache",
            instance=eng.name, block_tokens=block,
            evict_policy=cfg.cache_evict_policy,
            reserve_frac=cfg.cache_reserve_frac,
            directory=self.cache_dir, collector=self.collector,
            clock=self.loop.now)
        eng.attach_cache(cache)
        self.registry.register(cache)
        return cache

    def _msg_prefix(self, msg):
        """Prefix source the cache-aware router scores: every tester
        request for this message starts with the instance-shared system
        header (agents/agent.py builds the same identity)."""
        return (("system-prompt", self.cfg.header_tokens),)

    # -- workload entry -----------------------------------------------------------
    def submit(self, spec: TaskSpec) -> None:
        spec.submitted_at = self.loop.now()
        self._inflight[spec.task_id] = spec
        self.tracer.begin_task(spec.task_id, t=spec.submitted_at,
                               session=spec.session)
        self.developer.submit_task(spec)

    def _task_done(self, st, t: float) -> None:
        spec = self._inflight.pop(st.task_id, None)
        if spec is None:
            return
        spec.finished_at = t
        self.tracer.end_task(spec.task_id, t)
        self.done.append(spec)
        self.collector.observe("pipeline.task_latency",
                               t - spec.submitted_at, t)
        self.collector.counter("pipeline.tasks_done", 1, t)
        if self.on_task_done is not None:
            self.on_task_done(spec)


# ---------------------------------------------------------------------------
# Generic workflow pipeline
# ---------------------------------------------------------------------------


@dataclass
class TierSpec:
    """One model-size tier of the shared engine pool."""

    model: str                           # configs/ architecture name
    chips: int = 4                       # TP degree per instance
    replicas: int = 2                    # instances of this tier
    slots: int = 16                      # continuous-batching slots
    # disaggregation plane: per-replica engine roles, cycled over the
    # replicas (e.g. ("prefill", "decode", "decode")).  Any non-unified
    # role makes the tier a role-typed pool: a DisaggPool wires the
    # prefill→decode handoff fabric over the tier's engines, and the
    # controller can re-partition it at runtime through the role knob.
    roles: tuple = ()


@dataclass
class WorkflowConfig:
    """Compilation parameters for non-fig1 graphs."""

    tiers: dict[str, TierSpec] = field(default_factory=lambda: {
        "large": TierSpec("agent-7b", chips=4, replicas=2, slots=16),
        "small": TierSpec("agent-1b", chips=1, replicas=2, slots=16),
    })
    router_policy: str = "stage_aware"   # static | least_loaded | stage_aware
    critical_path: bool = True           # stamp deadlines + admission boost
    deadline_slack: float = 2.0          # deadline = slack x cp estimate
    est_prompt_tokens: int = 128         # nominal task prompt for cp math
    granularity: Granularity = Granularity.PIPELINE
    stream_chunk: int = 8
    num_pages: int = 4096
    max_context: int = 8192
    page_size: int = 64
    # tool-call plane: "hold" suspends the live sequence across a TOOL
    # stage (the post-tool turn resumes its KV); "reissue" is the legacy
    # complete-and-reissue flow (every post-tool turn re-prefills)
    tool_context: str = "hold"
    host_capacity_pages: int = 4096      # per-engine host KV tier
    msg_bandwidth: float = 1.25e9
    msg_proc_time: float = 1.0e-3
    controller_interval: float = 0.05
    kv_bandwidth: float = 12.5e9         # disagg handoff interconnect
    adaptive_roles: bool = False         # install a RoleBalancerPolicy
                                         # per role-typed tier
    calib_dir: Optional[str] = None      # CALIB_*.json dir for tier
                                         # cost models (None = env/default)


class WorkflowPipeline(ServingFabric):
    """A compiled workflow graph: shared tier-labelled engine pool
    behind one router, a StageAgent per stage, a Channel per edge."""

    def __init__(self, graph: WorkflowGraph,
                 cfg: Optional[WorkflowConfig] = None,
                 loop: Optional[EventLoop] = None):
        cfg = cfg or WorkflowConfig()
        self.cfg = cfg
        super().__init__(loop, interval=cfg.controller_interval)
        self.graph = graph.validate()

        # --- shared engine pool, one router over every tier ----------------
        self.costmodels = {
            tier: costmodel_for(get_config(ts.model), chips=ts.chips,
                                calib_dir=cfg.calib_dir)
            for tier, ts in cfg.tiers.items()}
        self.router = Router(self.loop, "workflow-router",
                             policy=cfg.router_policy,
                             collector=self.collector)
        self.workers: list[EngineWorker] = []
        tier_engines: dict[str, list[SimEngine]] = {}
        for tier, ts in cfg.tiers.items():
            for i in range(ts.replicas):
                role = ts.roles[i % len(ts.roles)] if ts.roles else "unified"
                eng = SimEngine(
                    self.loop, self.costmodels[tier],
                    SchedulerConfig(max_slots=ts.slots,
                                    num_pages=cfg.num_pages,
                                    max_context=cfg.max_context,
                                    page_size=cfg.page_size,
                                    host_capacity_pages=(
                                        cfg.host_capacity_pages),
                                    role=role),
                    name=f"wf-{tier}-{i}", collector=self.collector)
                eng.tracer = self.tracer
                w = EngineWorker(eng, tier)
                self.workers.append(w)
                self.router.add_instance(w, tier=tier, engine=eng)
                self.registry.register(eng)
                tier_engines.setdefault(tier, []).append(eng)
        self.registry.register(self.router)
        self.router.rules = self.controller.rules
        self.router.tracer = self.tracer

        # --- role-typed pools: tiers whose replicas carry prefill/decode
        # roles get a DisaggPool (prefill→decode handoff fabric over the
        # tier's engines); the role knob stays live, so the controller —
        # or a RoleBalancerPolicy, when cfg.adaptive_roles — can
        # re-partition each tier from queue pressure at runtime
        self.disagg_pools: dict[str, DisaggPool] = {}
        for tier, ts in cfg.tiers.items():
            if not ts.roles or set(ts.roles) == {"unified"}:
                continue
            directory = SessionDirectory()
            kvx = KVTransferManager(
                self.loop, directory,
                bytes_fn=self.costmodels[tier].kv_transfer_bytes,
                bandwidth=cfg.kv_bandwidth, collector=self.collector,
                name=f"{tier}-kvx")
            pool = DisaggPool(self.loop, tier_engines[tier], kvx,
                              collector=self.collector,
                              name=f"{tier}-disagg",
                              cluster_prefix=f"cluster.{tier}",
                              tracer=self.tracer)
            self.disagg_pools[tier] = pool
            if cfg.adaptive_roles:
                from repro_torch.core.policies import RoleBalancerPolicy
                self.controller.install(RoleBalancerPolicy(
                    [e.name for e in tier_engines[tier]],
                    prefix=f"cluster.{tier}"))

        # --- one StageAgent per stage, registered as stage.<name> ----------
        self.stages: dict[str, StageAgent] = {}
        for name, spec in graph.stages.items():
            ag = StageAgent(spec, self.loop, self, collector=self.collector)
            if spec.kind is StageKind.TOOL:
                ag.tool = ToolAgent(f"{name}.tool", self.loop,
                                    latency=spec.tool_latency,
                                    latency_cv=spec.tool_latency_cv,
                                    timeout=spec.tool_timeout,
                                    collector=self.collector)
                self.registry.register(ag.tool)
            self.stages[name] = ag
            self.registry.register(ag)

        # --- tool-call suspend/resume plane: which stage feeds which
        # TOOL stage (its calls hold their sequence open), and which
        # engine belongs to which tier (cross-engine resume placement)
        self._feeds_tool: dict[str, str] = {}
        for (u, v) in graph.edges:
            if graph.stages[v].kind is StageKind.TOOL:
                self._feeds_tool[u] = v
        self._engine_tier = {w.name: w.tier for w in self.workers}

        # --- one data-plane channel per graph edge -------------------------
        self.channels: dict[tuple[str, str], Channel] = {}
        for (u, v) in graph.edges:
            link = Link(self.loop, bandwidth=cfg.msg_bandwidth,
                        proc_time=cfg.msg_proc_time, name=f"{u}->{v}.link")
            ch = Channel(self.loop, link, u, self.stages[v],
                         name=f"{u}->{v}", collector=self.collector,
                         granularity=cfg.granularity,
                         stream_chunk=cfg.stream_chunk)
            self.channels[(u, v)] = ch
            self.registry.register(ch)
            self.stages[u].succs.append((v, ch))
        for name, ag in self.stages.items():
            ag.n_preds = len(graph.preds(name))

        self.controller.attach_graph(graph)
        self._pending: dict[str, int] = {}    # task -> activation refcount
        self._inflight: dict[str, GraphTask] = {}
        self._cp: dict[str, float] = {}
        self._cp_total = 0.0
        self._recompute_cp()
        self.collector.describe(
            "workflow.task_latency",
            "End-to-end workflow task latency in seconds; lower is better.")

    # -- critical path ------------------------------------------------------
    def tier_names(self) -> tuple[str, ...]:
        return tuple(self.cfg.tiers)

    def _stage_cost(self, spec, est_in: float) -> float:
        ag = self.stages.get(spec.name)
        tier = ag.model_tier if ag is not None else spec.model_tier
        if spec.kind is StageKind.TOOL:
            # the *expected* dwell under the heavy-tailed latency model,
            # not the median — tool-bound paths are systematically
            # longer than their nominal latency suggests
            return expected_tool_latency(spec.tool_latency,
                                         spec.tool_latency_cv,
                                         spec.tool_timeout)
        cm = self.costmodels.get(tier)
        ts = self.cfg.tiers.get(tier)
        if cm is None:                    # tier not in this pool: calls
            first = next(iter(self.cfg.tiers))   # fall back to the
            cm, ts = self.costmodels[first], self.cfg.tiers[first]  # default
        if spec.kind is StageKind.FAN_OUT:
            width = ag.width if ag is not None else spec.width
            serial = math.ceil(width / max(ts.replicas, 1))
            return serial * cm.call_time(
                spec.prompt_tokens + int(est_in // max(width, 1)),
                spec.out_tokens)
        return cm.call_time(spec.prompt_tokens + int(est_in),
                            spec.out_tokens)

    def _recompute_cp(self) -> None:
        self._cp = self.graph.critical_path(
            self._stage_cost, prompt_tokens=self.cfg.est_prompt_tokens)
        self._cp_total = self.graph.cp_total(self._cp)
        # per-stage deadline anchors, cached: dispatch is the hot path
        # and these only move when a tier/width knob does
        est_in = self.graph.est_inputs(self.cfg.est_prompt_tokens)
        self._through = {
            n: self._cp_total - max(
                self._cp[n] - self._stage_cost(spec, est_in[n]), 0.0)
            for n, spec in self.graph.stages.items()}

    def on_stage_retier(self, name: str) -> None:
        """A stage's model_tier/width knob moved: cost estimates — and
        therefore every propagated deadline — shift."""
        self._recompute_cp()

    def cp_enabled(self) -> bool:
        return self.cfg.critical_path

    def cp_remaining(self, stage: str) -> float:
        return self._cp.get(stage, 0.0)

    def cp_through(self, stage: str) -> float:
        """Critical-path work through the *end* of ``stage`` — the
        deadline anchor propagated along edges."""
        return self._through.get(stage, 0.0)

    # -- stage runtime hooks ------------------------------------------------
    def route_call(self, msg) -> None:
        self.router.deliver(msg)

    # -- tool-call suspend/resume plane --------------------------------------
    def hold_enabled(self) -> bool:
        return self.cfg.tool_context == "hold"

    def tool_hold_est(self, stage: str):
        """Expected tool dwell when ``stage`` feeds a TOOL stage — the
        price signal the engine's offload policy weighs a suspend
        against.  None when the stage feeds no tool (or the hold flow
        is off): its calls complete normally."""
        if not self.hold_enabled():
            return None
        tool = self._feeds_tool.get(stage)
        if tool is None:
            return None
        ag = self.stages[tool].tool
        return ag.mean_latency() if ag is not None else None

    def tool_fanin(self, stage: str) -> int:
        """How many input stages the TOOL fed by ``stage`` waits for.
        >1 means a held call parks while *sibling* stages still need
        slots — the configuration where a pinned hold can wedge an
        engine (debate's pro/con -> factcheck)."""
        tool = self._feeds_tool.get(stage)
        return len(self.graph.preds(tool)) if tool is not None else 0

    def engine_tier(self, req) -> str:
        eng = req.meta.get("engine")
        return self._engine_tier.get(getattr(eng, "name", ""), "")

    def resume_request(self, req) -> None:
        """Land a held-open request back on silicon after its tool
        returned: pay the host→HBM restore cost, then resume on the
        home engine — and when home is out of slots, migrate the host
        KV copy to the least-loaded same-tier peer (cache-aware
        placement: the resume runs where capacity is, not where the
        sequence happened to start)."""
        eng = req.meta.get("engine")
        if eng is None:
            return
        d = eng.restore_cost(req)
        if d > 0.0:
            self.loop.call_after(d, lambda: self._resume_land(eng, req))
        else:
            self._resume_land(eng, req)

    def _resume_land(self, eng, req) -> None:
        if eng.resume_suspended(req) != "wait":
            return
        tier = self._engine_tier.get(eng.name, "")
        peers = sorted((w.engine for w in self.workers
                        if w.tier == tier and w.engine is not eng
                        and w.engine.scheduler._free_slots),
                       key=lambda e: e.load())
        for peer in peers:
            if eng.migrate_suspended(req, peer):
                return
        # no capacity anywhere: stays on the home scheduler's
        # resume-pending list, retried ahead of fresh admissions

    def task_merge(self, task: GraphTask, arrived: int) -> None:
        """A stage dispatched after absorbing ``arrived`` input
        activations: they merge into the stage's single activation."""
        if arrived > 1:
            self._bump(task, -(arrived - 1))

    def task_advance(self, task: GraphTask, forwarded: int) -> None:
        """A stage completed: its activation ends, ``forwarded``
        successor activations begin."""
        self._bump(task, forwarded - 1)

    def task_drop(self, task: GraphTask) -> None:
        """A straggler input arrived after its join already fired."""
        self._bump(task, -1)

    def _bump(self, task: GraphTask, delta: int) -> None:
        tid = task.task_id
        if tid not in self._pending:
            return
        self._pending[tid] += delta
        if self._pending[tid] <= 0:
            del self._pending[tid]
            self._inflight.pop(tid, None)
            # a task can finish with sequences still parked (e.g. its
            # BRANCH arm never reached the post-tool stage): release them
            for r in (task.meta.pop("held", []) if task.meta else []):
                eng = r.meta.get("engine")
                if eng is not None and r.state == RequestState.SUSPENDED:
                    eng.finish_suspended(r)
            t = self.loop.now()
            task.finished_at = t
            self.tracer.end_task(tid, t)
            self.done.append(task)
            self.collector.observe("workflow.task_latency",
                                   t - task.submitted_at, t)
            self.collector.counter("workflow.tasks_done", 1, t)
            if self.on_task_done is not None:
                self.on_task_done(task)

    # -- workload entry -----------------------------------------------------
    def submit(self, task: GraphTask) -> None:
        task.submitted_at = self.loop.now()
        if self.cfg.critical_path and task.deadline == math.inf:
            task.deadline = (task.submitted_at
                             + self.cfg.deadline_slack * self._cp_total)
        self.tracer.begin_task(task.task_id, t=task.submitted_at,
                               session=task.session)
        sources = self.graph.sources()
        self._pending[task.task_id] = len(sources)
        self._inflight[task.task_id] = task
        for s in sources:
            self.stages[s].inject(task, task.prompt_tokens)
