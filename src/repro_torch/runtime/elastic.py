"""Elastic scaling of a serving instance group.

``ElasticGroup`` owns the tester fleet: it can spawn a new instance
(engine + agent, registered with the registry, watched by the heartbeat
monitor, added to the router) or drain one (stop admissions, migrate its
sessions out over the KV fabric, then remove it).  AutoscalePolicy
(core/policies.py) decides *when*; this module knows *how* — the
separation of concerns the paper's control plane prescribes.

The group is itself a registered *controllable* (kind ``"group"``) with
a single ``replicas`` knob, so the intent language's ``scale GROUP ±N``
action and plain ``registry.set(group, "replicas", n)`` both reach it
through the same Table-1 surface as every other knob."""
from __future__ import annotations


from repro_torch.agents.agent import TesterAgent
from repro_torch.core.knobs import ControlSurface, KnobSpec
from repro_torch.core.rules import RequestRule
from repro_torch.core.types import RequestState
from repro_torch.serving.engine_sim import SimEngine
from repro_torch.serving.scheduler import SchedulerConfig


class ElasticGroup(ControlSurface):
    kind = "group"
    CAPABILITIES = ("scale",)
    METRICS = ("replicas",)
    KNOB_SPECS = (
        KnobSpec("replicas", kind="int", lo=1, attr="replicas",
                 doc="target live instance count; setting it scales "
                     "up (spawn) or down (graceful drain)"),
    )

    def __init__(self, pipeline, monitor=None, name: str = "tester-group"):
        self.name = name
        self.p = pipeline
        self.loop = pipeline.loop
        self.collector = getattr(pipeline, "collector", None)
        self.monitor = monitor
        self.spawned = 0
        self.drained: list[str] = []
        self._draining: set[str] = set()
        self._publish_replicas()

    def _publish_replicas(self) -> None:
        # keep the advertised METRICS live so intent terms/triggers over
        # tester-group.replicas actually observe samples
        if self.collector is not None:
            self.collector.gauge(f"{self.name}.replicas", self.replicas,
                                 self.loop.now())

    # -- the replicas knob ----------------------------------------------------
    def _live(self) -> list[TesterAgent]:
        return [t for t in self.p.testers if t.name not in self._draining]

    @property
    def replicas(self) -> int:
        return len(self._live())

    @replicas.setter
    def replicas(self, n: int) -> None:
        n = max(1, int(n))
        while self.replicas < n:
            self.scale_up()
        while self.replicas > n:
            self.drain(self._live()[-1].name)   # newest live instance first

    # -- scale up -----------------------------------------------------------
    def scale_up(self) -> str:
        cfg = self.p.cfg
        taken = set(self.p.registry.names()) | {t.name
                                                for t in self.p.testers}
        i = 0
        while f"tester-{i}" in taken:
            i += 1
        name = f"tester-{i}"
        sched = SchedulerConfig(max_slots=cfg.tester_slots,
                                num_pages=cfg.num_pages,
                                max_context=cfg.max_context)
        eng = SimEngine(self.p.loop, self.p.costmodel, sched, name=name,
                        collector=self.p.collector)
        agent = TesterAgent(name, eng, self.p.loop,
                            directory=self.p.directory, kvx=self.p.kvx,
                            header_tokens=cfg.header_tokens,
                            on_task_done=self.p._task_done)
        self.p.testers.append(agent)
        self.p.router.add_instance(agent)
        self.p.registry.register(eng)
        if hasattr(self.p, "attach_prefix_cache"):
            self.p.attach_prefix_cache(eng)
        if self.monitor is not None:
            from repro_torch.runtime.heartbeat import attach_engine
            attach_engine(self.monitor, eng)
        # installed agent-rules (e.g. an admit_priority_min floor) must
        # hold for the new replica too — the rule table stays the
        # source of truth across scale-ups
        self.p.controller.reapply_agent_rules()
        self.spawned += 1
        self._publish_replicas()
        return name

    def _drop_cache(self, name: str) -> None:
        """Instance gone: its cache controllable and directory residency
        records go with it."""
        self.p.registry.deregister(f"{name}.cache")
        cache_dir = getattr(self.p, "cache_dir", None)
        if cache_dir is not None:
            cache_dir.detach(name)

    # -- scale down ----------------------------------------------------------
    def drain(self, name: str) -> None:
        """Graceful: stop new sessions, migrate homed sessions away,
        remove once idle."""
        agent = next(t for t in self.p.testers if t.name == name)
        others = [t.name for t in self.p.testers
                  if t.name != name and t.name not in self._draining]
        assert others, "cannot drain the last instance"
        self._draining.add(name)
        # stop new admissions at the engine
        self.p.registry.set(name, "admit_priority_min", 99)
        # re-home sessions
        for sess, rec in list(self.p.directory.records.items()):
            if rec.instance == name:
                dst = others[len(self.drained) % len(others)]
                self.p.kvx.transfer(sess, name, dst)
                self.p.controller.rules.install(
                    RequestRule(session=sess, route_to=dst))

        def _finalize():
            if agent.engine.busy:
                self.p.loop.call_after(0.2, _finalize)
                return
            self.p.router.remove_instance(name)
            self.p.registry.deregister(name)
            self._drop_cache(name)
            if self.monitor is not None:
                self.monitor.unwatch(name)
            self.p.testers = [t for t in self.p.testers if t.name != name]
            self._draining.discard(name)
            self.drained.append(name)

        _finalize()
        self._publish_replicas()

    # -- failure path ---------------------------------------------------------
    def fail_over(self, name: str) -> int:
        """Hard failure: instance is gone.  Re-route its sessions (KV is
        lost → destination re-prefills) and re-submit its queued work."""
        agent = next((t for t in self.p.testers if t.name == name), None)
        if agent is None:
            return 0
        others = [t for t in self.p.testers if t.name != name]
        assert others, "no surviving instances"
        moved = 0
        for sess, rec in self.p.directory.records.items():
            if rec.instance == name:
                dst = others[moved % len(others)]
                rec.instance = dst.name       # KV lost; recompute on arrival
                rec.context_len = 0           # nothing left to transfer
                self.p.controller.rules.install(
                    RequestRule(session=sess, route_to=dst.name))
                moved += 1
        # re-queue in-flight requests on survivors (they re-prefill)
        sched = agent.engine.scheduler
        for req in list(sched.running) + list(sched.waiting):
            req.prefilled = 0
            req.generated = 0
            req.available = req.prompt_len
            req.state = RequestState.QUEUED
            others[moved % len(others)].engine.submit(req)
            moved += 1
        self.p.router.remove_instance(name)
        self.p.registry.deregister(name)
        self._drop_cache(name)
        if self.monitor is not None:
            self.monitor.unwatch(name)
        self.p.testers = [t for t in self.p.testers if t.name != name]
        self._publish_replicas()
        return moved
