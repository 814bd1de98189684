"""Control plane (paper §3.1).

A logically centralized controller that

1. polls the metrics plane into its ``StateStore`` on a fixed interval
   (the paper's centralized on-demand polling),
2. reacts to **events** between polls: named events agents push
   (``task_start`` …) and ``MetricBus`` threshold subscriptions — the
   hybrid event/interval control loop,
3. runs installed **policies** — closed-loop programs written against the
   store + registry (hand-written, or compiled from the declarative
   intent language in core/intent.py),
4. enforces decisions through the Table-1 ``set()/reset()`` surface and
   the **rule table** (agent-level + request-level rules) the data plane
   consults.

Policies receive a ``ControlContext`` capability object rather than raw
internals, which keeps control programs small and auditable — and gives
us one choke-point to log every action (the audit trail the benchmarks
print).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import fnmatch

from repro_torch.core.metrics import CentralPoller, MetricBus, StateStore
from repro_torch.core.registry import Registry
from repro_torch.core.rules import AgentRule, RequestRule, RuleTable
from repro_torch.core.types import Granularity
from repro_torch.sim.clock import EventLoop


@dataclass
class Action:
    t: float
    kind: str         # set | reset | rule | transfer | scale | note
    target: str
    detail: str


class ControlContext:
    """Capability surface handed to policies each tick."""

    def __init__(self, controller: "Controller"):
        self._c = controller
        self.store: StateStore = controller.store
        self.registry: Registry = controller.registry
        self.rules: RuleTable = controller.rules

    @property
    def now(self) -> float:
        return self._c.loop.now()

    @property
    def graph(self):
        """The serving topology's workflow graph (agents/graph.py), when
        one is attached — policies can read stage structure, e.g. to
        walk a breaching stage's successors before re-tiering it."""
        return self._c.graph

    # -- metric sugar -----------------------------------------------------------
    def metric(self, name: str, agg: Optional[str] = None,
               window: float = float("inf"), default: float = 0.0) -> float:
        return self.store.get(name, agg, window, default)

    def refresh(self) -> None:
        """On-demand poll: event handlers call this so guards read the
        current metric window, not the previous tick's."""
        self._c.poller.poll(self.now)

    # -- Table-1 surface ---------------------------------------------------------
    def set(self, target: str, knob: str, value) -> None:
        cur = self._c.registry.get_param(target, knob)
        if cur == value:
            return                      # no-op sets don't thrash the system
        self._c.registry.set(target, knob, value)
        self._c._log("set", target, f"{knob}={value}")

    def reset(self, target: str, knob: str) -> None:
        before = self._c.registry.get_param(target, knob)
        self._c.registry.reset(target, knob)
        if self._c.registry.get_param(target, knob) != before:
            self._c._log("reset", target, knob)

    def get(self, target: str, knob: str):
        return self._c.registry.get_param(target, knob)

    # -- convenience wrappers ---------------------------------------------------
    def granularity(self, channel: str, g) -> None:
        self.set(channel, "granularity", Granularity(g))

    def install(self, rule) -> None:
        self._c.rules.install(rule)
        self._c._log("rule", getattr(rule, "target", "request"), repr(rule))
        if isinstance(rule, AgentRule):
            self._apply_agent_rule(rule)

    def _apply_agent_rule(self, rule: AgentRule) -> None:
        """Installing an AgentRule IS a batch of ``set()`` calls (the
        rules module's contract): the channel knobs land on every
        registered channel matching ``target``, and
        ``admit_priority_min`` lands on those channels' *destination
        engines* — rules.py documents it as "applied to the dst engine",
        but ``knob_updates()`` (channel knobs only) silently dropped
        it."""
        reg = self._c.registry
        for name in reg.of_kind("channel"):
            if not fnmatch.fnmatch(name, rule.target):
                continue
            for knob, value in rule.knob_updates().items():
                self.set(name, knob, value)
            if rule.admit_priority_min is None:
                continue
            dst = getattr(reg.get(name), "dst", None)
            for eng in self._dst_engines(dst):
                self.set(eng, "admit_priority_min",
                         rule.admit_priority_min)

    def _dst_engines(self, dst) -> list[str]:
        """Registered engine names behind a channel destination: a
        router fans out to its instances; a direct endpoint is its own
        engine (agents register their engine under the agent's name)."""
        if dst is None:
            return []
        cand = (list(getattr(dst, "instances", None) or ())
                or [getattr(dst, "name", "")])
        out = []
        for n in cand:
            try:
                card = self._c.registry.card(n)
            except KeyError:
                continue
            if "admit_priority_min" in card.knobs:
                out.append(n)
        return out

    def route(self, session: str, instance: str) -> None:
        """Pin a session to an instance (request-level rule)."""
        self._c.rules.remove_request_rules(
            lambda r: r.session == session and r.route_to is not None)
        self._c.rules.install(RequestRule(session=session,
                                          route_to=instance))
        self._c._log("rule", instance, f"route session={session}")

    def transfer_kv(self, session: str, src: str, dst: str,
                    proactive: bool = False) -> None:
        """Cross-instance state transfer (§3.1's rich-control example)."""
        if self._c.transfer_fn is None:
            raise RuntimeError("no kv-transfer backend attached")
        self._c.transfer_fn(session, src, dst, proactive)
        self._c._log("transfer", f"{src}->{dst}",
                     f"session={session} proactive={proactive}")

    # -- intent v2 verbs ---------------------------------------------------------
    def scale_to(self, group: str, n: int) -> None:
        """Set a group's replica target (intent ``scale GROUP N``)."""
        cur = int(self.get(group, "replicas"))
        n = max(1, int(n))
        if n == cur:
            return
        self._c.registry.set(group, "replicas", n)
        self._c._log("scale", group, f"replicas {cur}->{n}")

    def scale(self, group: str, delta: int) -> None:
        """Scale a group by ±delta replicas (intent ``scale GROUP ±N``)."""
        cur = int(self.get(group, "replicas"))
        self.scale_to(group, cur + int(delta))

    def gate(self, channel: str, on: bool) -> None:
        """Gate/release a channel's speculative traffic
        (intent ``gate CHANNEL on|off``)."""
        self.set(channel, "gate_speculative", bool(on))

    def role(self, engine: str, role: str) -> None:
        """Flip an engine's phase role (disaggregation plane; intent
        ``set engine NAME.role unified|prefill|decode``).  The engine's
        fabric drains role-inconsistent work on the flip; audited
        distinctly from plain knob sets so role churn is greppable."""
        cur = self.get(engine, "role")
        if cur == role:
            return
        self._c.registry.set(engine, "role", role)
        self._c._log("role", engine, f"{cur}->{role}")

    def pin(self, prefix: str) -> int:
        """Pin a named prefix in every registered cache plane (intent
        ``pin PREFIX``): its blocks become exempt from eviction."""
        n, hit = 0, []
        for name in self.registry.with_capability("pin"):
            n += self.registry.get(name).pin(prefix)
            hit.append(name)
        self._c._log("pin", ",".join(hit) or "-",
                     f"prefix={prefix} blocks={n}")
        return n

    def unpin(self, prefix: str) -> int:
        """Release a pinned prefix (intent ``unpin PREFIX``)."""
        n, hit = 0, []
        for name in self.registry.with_capability("pin"):
            n += self.registry.get(name).unpin(prefix)
            hit.append(name)
        self._c._log("unpin", ",".join(hit) or "-",
                     f"prefix={prefix} blocks={n}")
        return n

    def trace(self, scope: Optional[str], rate: float) -> None:
        """Set trace sampling (intent ``trace [tenant|stage NAME]
        on|off|RATE``): ``scope`` is ``None`` for the global rate or
        ``tenant:NAME`` / ``stage:NAME``; fans out to every registered
        tracer via the ``trace`` capability."""
        hit = []
        for name in self.registry.with_capability("trace"):
            self.registry.get(name).set_scope(scope, rate)
            hit.append(name)
        self._c._log("trace", ",".join(hit) or "-",
                     f"scope={scope or 'global'} rate={rate:g}")

    def note(self, target: str, detail: str) -> None:
        self._c._log("note", target, detail)


class Policy:
    """Base class: closed-loop control program."""

    name = "policy"

    def on_tick(self, ctx: ControlContext) -> None:  # pragma: no cover
        raise NotImplementedError

    def on_event(self, ctx: ControlContext, kind: str, **kw) -> None:
        """Optional push-path: agents raise events (task_start, task_done,
        instance_failed) the controller forwards between polls."""

    def on_install(self, controller: "Controller") -> None:
        """Bind-time hook: e.g. intent programs register their ``on``
        triggers as MetricBus threshold subscriptions here."""


class Controller:
    def __init__(self, loop: EventLoop, registry: Registry,
                 poller: CentralPoller, store: Optional[StateStore] = None,
                 interval: float = 0.05, bus: Optional[MetricBus] = None,
                 collector=None, actions_cap: int = 4096):
        self.loop = loop
        self.registry = registry
        self.poller = poller
        self.store = store or poller.store
        self.interval = interval
        self.bus = bus
        self.collector = collector
        self.rules = RuleTable()
        self.policies: list[Policy] = []
        self.actions: list[Action] = []      # bounded audit ring
        self.actions_cap = actions_cap
        self.actions_total = 0
        self.recorder = None                 # optional FlightRecorder
        self.transfer_fn: Optional[Callable] = None
        self.graph = None                # workflow graph (control-plane view)
        self._running = False
        self.ticks = 0
        self.events_handled = 0

    # -- policy management ---------------------------------------------------
    def install(self, policy: Policy) -> None:
        self.policies.append(policy)
        hook = getattr(policy, "on_install", None)
        if hook is not None:
            hook(self)

    def attach_transfer(self, fn: Callable) -> None:
        self.transfer_fn = fn

    def reapply_agent_rules(self) -> None:
        """Re-apply every installed AgentRule against the *current*
        registry: instances registered after install (autoscale
        spawn-ups) receive the rules' knobs too, so a declared
        admission floor keeps holding fleet-wide.  Idempotent —
        ``ctx.set`` no-ops on values already held."""
        ctx = ControlContext(self)
        for rule in self.rules.agent_rules:
            ctx._apply_agent_rule(rule)

    def attach_graph(self, graph) -> None:
        """Register the serving topology's workflow graph as a
        control-plane object: policies and intent programs see the same
        DAG the scheduler derives critical-path priorities from."""
        self.graph = graph

    # -- loop ------------------------------------------------------------------
    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self.loop.call_after(self.interval, self._tick)

    def stop(self) -> None:
        self._running = False

    def _tick(self) -> None:
        if not self._running:
            return
        now = self.loop.now()
        self.poller.poll(now)
        ctx = ControlContext(self)
        for p in self.policies:
            p.on_tick(ctx)
        self.ticks += 1
        self.loop.call_after(self.interval, self._tick)

    # -- push events from agents ------------------------------------------------
    def event(self, kind: str, **kw) -> None:
        ctx = ControlContext(self)
        for p in self.policies:
            p.on_event(ctx, kind, **kw)

    # -- event tier (MetricBus threshold subscriptions) --------------------------
    def watch_metric(self, metric: str, above: Optional[float] = None,
                     below: Optional[float] = None, cooldown: float = 0.0,
                     edge: bool = True):
        """Subscribe the control loop to a metric threshold: when the
        data plane pushes a sample into the region, policies get an
        ``on_event(ctx, "metric", ...)`` *between* interval polls.
        Requires a MetricBus; returns the subscription handle."""
        if self.bus is None:
            raise RuntimeError("controller has no MetricBus attached")
        return self.bus.subscribe(
            metric, above=above, below=below, cooldown=cooldown, edge=edge,
            fn=lambda name, value, t: self._defer(
                lambda: self.event("metric", name=name, value=value, t=t)))

    def _defer(self, fn: Callable[[], None]) -> None:
        """Run a control action on the next loop turn.  Bus callbacks
        arrive *inside* data-plane writes (mid engine-step); deferring
        keeps control actions from mutating scheduler state re-entrantly."""
        self.loop.call_after(0.0, fn)

    def fire_on_event(self, run: Callable[[ControlContext], None],
                      reason: str = "") -> None:
        """Event-path entry used by intent programs: on-demand poll for a
        fresh window, then run ``run(ctx)`` — deferred one loop turn."""
        def _go():
            self.poller.poll(self.loop.now())
            self.events_handled += 1
            if reason:
                self._log("event", "bus", reason)
            run(ControlContext(self))
        self._defer(_go)

    # -- audit ---------------------------------------------------------------------
    def attach_recorder(self, recorder) -> None:
        """Forward every audit-log action to a FlightRecorder (which
        keeps its own bound and the causal-annotation machinery)."""
        self.recorder = recorder

    def _log(self, kind: str, target: str, detail: str) -> None:
        t = self.loop.now()
        a = Action(t, kind, target, detail)
        self.actions_total += 1
        self.actions.append(a)
        if len(self.actions) > self.actions_cap:
            # ring behavior: drop the oldest half in one O(n) move so a
            # long fleet sim cannot leak audit memory
            del self.actions[: self.actions_cap // 2]
        if self.recorder is not None:
            self.recorder.record_action(a)
        if self.collector is not None:
            self.collector.gauge("controller.actions_retained",
                                 len(self.actions), t)

    def action_log(self, kind: Optional[str] = None) -> list[Action]:
        return [a for a in self.actions if kind is None or a.kind == kind]
