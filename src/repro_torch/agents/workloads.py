"""Workload generators for the MetaGPT-style developer→tester pipeline.

``ClosedLoopClient`` — N concurrent sessions; each submits a task, waits
for completion, thinks, submits the next.  Sweeping N is the paper's
"varying load" axis (Fig 3): at low N latency dominates (streaming wins),
at high N engine efficiency dominates (batching wins).

``PhasedLoad`` — drives the client count through phases (low → high →
low) for the Fig-6 adaptive-switching experiment.

``GraphBurst`` — the workflow-plane arrival pattern: N ``GraphTask``s
submitted to a ``WorkflowPipeline`` in a (possibly staggered) burst, so
queues form and cross-stage scheduling order actually matters.

``TenantMix`` — the tenancy-plane arrival pattern: per-tenant open
(Poisson) or closed (session) loops submitting tenant-stamped
``Request``s straight at a serving pool, with a heavy-head Zipf helper
for the many-small-tenants shape real multi-tenant fleets see.
"""
from __future__ import annotations

import random
from dataclasses import dataclass

from repro_torch.agents.graph import GraphTask
from repro_torch.agents.pipeline import AgenticPipeline, TaskSpec
from repro_torch.core.types import Priority, Request, SLOClass


@dataclass
class WorkloadConfig:
    n_clients: int = 4
    think_time: float = 0.5
    tasks_per_client: int = 0          # 0 = unlimited (run until t_end)
    prompt_tokens: int = 192
    n_functions: int = 6
    func_tokens: int = 48
    test_tokens: int = 40
    jitter: float = 0.25               # fractional think-time jitter
    seed: int = 0


class ClosedLoopClient:
    def __init__(self, pipeline: AgenticPipeline, session: str,
                 cfg: WorkloadConfig, rng: random.Random,
                 stop_at: float = float("inf")):
        self.p = pipeline
        self.session = session
        self.cfg = cfg
        self.rng = rng
        self.stop_at = stop_at
        self.submitted = 0
        self.completed = 0
        self.active = False
        self._timer = None               # pending think/start event

    def start(self, delay: float = 0.0) -> None:
        self.active = True
        self._timer = self.p.loop.call_after(delay, self._next)

    def stop(self) -> None:
        """Deactivate AND cancel the pending think-timer, so a stopped
        client leaves nothing on the event loop (a bare flag would let
        an in-flight timer fire one more ``_next``)."""
        self.active = False
        if self._timer is not None:
            self.p.loop.cancel(self._timer)
            self._timer = None

    def _next(self) -> None:
        self._timer = None
        if not self.active or self.p.loop.now() >= self.stop_at:
            return
        if self.cfg.tasks_per_client and self.submitted >= self.cfg.tasks_per_client:
            return
        spec = TaskSpec(session=self.session,
                        prompt_tokens=self.cfg.prompt_tokens,
                        n_functions=self.cfg.n_functions,
                        func_tokens=self.cfg.func_tokens,
                        test_tokens=self.cfg.test_tokens)
        spec.meta_client = self        # dispatch handle for _dispatch_done
        self.submitted += 1
        self.p.submit(spec)

    def _on_done(self) -> None:
        self.completed += 1
        if not self.active:
            return        # stopped with a task in flight: stay quiescent
                          # (re-arming here would leave an untracked timer
                          # that a later start() could double up with)
        think = self.cfg.think_time * (
            1 + self.rng.uniform(-self.cfg.jitter, self.cfg.jitter))
        self._timer = self.p.loop.call_after(max(think, 0.0), self._next)


def _dispatch_done(spec: TaskSpec) -> None:
    client = getattr(spec, "meta_client", None)
    if client is not None:
        client._on_done()


def launch_clients(pipeline: AgenticPipeline, cfg: WorkloadConfig,
                   stop_at: float = float("inf")) -> list[ClosedLoopClient]:
    rng = random.Random(cfg.seed)
    clients = []
    pipeline.on_task_done = _dispatch_done
    for i in range(cfg.n_clients):
        c = ClosedLoopClient(pipeline, f"sess-{i}", cfg, rng, stop_at)
        clients.append(c)
        c.start(delay=rng.uniform(0, cfg.think_time + 1e-3))
    return clients


class OpenLoopSource:
    """Poisson arrivals per session, independent of completions — the
    load does NOT self-throttle, so hot-instance queue buildup is fully
    visible (Fig 7 needs this; closed loops hide imbalance)."""

    def __init__(self, pipeline: AgenticPipeline, sessions: list[str],
                 rate_per_session: float, cfg: WorkloadConfig,
                 t_end: float, seed: int = 0):
        self.p = pipeline
        self.sessions = sessions
        self.rate = rate_per_session
        self.cfg = cfg
        self.t_end = t_end
        self.rng = random.Random(seed)
        self.submitted = 0

    def start(self) -> None:
        for s in self.sessions:
            self._schedule(s, self.rng.expovariate(self.rate))

    def _schedule(self, session: str, dt: float) -> None:
        t = self.p.loop.now() + dt
        if t >= self.t_end:
            return
        self.p.loop.call_at(t, lambda: self._fire(session))

    def _fire(self, session: str) -> None:
        spec = TaskSpec(session=session,
                        prompt_tokens=self.cfg.prompt_tokens,
                        n_functions=self.cfg.n_functions,
                        func_tokens=self.cfg.func_tokens,
                        test_tokens=self.cfg.test_tokens)
        self.submitted += 1
        self.p.submit(spec)
        self._schedule(session, self.rng.expovariate(self.rate))


class GraphBurst:
    """Open-loop burst of workflow tasks against a WorkflowPipeline."""

    def __init__(self, pipeline, n_tasks: int, prompt_tokens: int = 128,
                 stagger: float = 0.0, seed: int = 0):
        self.p = pipeline
        self.n_tasks = n_tasks
        self.prompt_tokens = prompt_tokens
        self.stagger = stagger           # mean inter-arrival gap (0 = all at t0)
        self.rng = random.Random(seed)
        self.tasks: list[GraphTask] = []

    def start(self) -> None:
        t = self.p.loop.now()
        for i in range(self.n_tasks):
            task = GraphTask(session=f"wf-sess-{i}",
                             prompt_tokens=self.prompt_tokens)
            self.tasks.append(task)
            self.p.loop.call_at(t, lambda task=task: self.p.submit(task))
            if self.stagger > 0:
                t += self.rng.expovariate(1.0 / self.stagger)


@dataclass
class TenantLoad:
    """One tenant's traffic shape inside a ``TenantMix``."""

    tenant: str
    slo_class: str = SLOClass.STANDARD.value
    mode: str = "open"               # open (Poisson) | closed (sessions)
    rate: float = 4.0                # open: requests/s (live-tunable —
                                     # rescheduling reads it each arrival)
    sessions: int = 4                # closed: concurrent sessions
    think: float = 0.25              # closed: think time between requests
    prompt: int = 256
    gen: int = 64
    priority: Priority = Priority.NORMAL


class TenantMix:
    """Multi-tenant arrival generator: each ``TenantLoad`` runs its own
    open (Poisson) or closed (think-time session) loop, submitting
    tenant-stamped ``Request``s through ``submit_fn``.  Closed loops
    re-arm from ``req.meta['on_done']`` — wire the serving pool's finish
    callback with ``TenantMix.wire_pool(pool)``.  Open-loop rates are
    read on every reschedule, so a driver can reshape a tenant's load
    mid-run (flash crowds) by assigning ``load.rate``."""

    def __init__(self, loop, submit_fn, loads: list[TenantLoad],
                 t_end: float = float("inf"), seed: int = 0):
        self.loop = loop
        self.submit_fn = submit_fn
        self.loads = loads
        self.t_end = t_end
        self.rng = random.Random(seed)
        self.requests: dict[str, list[Request]] = {
            ld.tenant: [] for ld in loads}

    # -- zipf helper ---------------------------------------------------------
    @classmethod
    def zipf(cls, loop, submit_fn, n_tenants: int, total_rate: float,
             alpha: float = 1.1, t_end: float = float("inf"), seed: int = 0,
             prompt: int = 256, gen: int = 64) -> "TenantMix":
        """Heavy-head Zipf over N open-loop tenants: tenant *i* arrives
        at a rate ∝ 1/(i+1)^alpha, normalized to ``total_rate``."""
        raw = [1.0 / (i + 1) ** alpha for i in range(n_tenants)]
        z = sum(raw)
        loads = [TenantLoad(f"t{i}", rate=total_rate * w / z,
                            prompt=prompt, gen=gen)
                 for i, w in enumerate(raw)]
        return cls(loop, submit_fn, loads, t_end=t_end, seed=seed)

    # -- drive ---------------------------------------------------------------
    RATE_PROBE = 0.25            # quiesced-loop poll for a rate restore

    def start(self) -> None:
        for ld in self.loads:
            if ld.mode == "open":
                self._schedule_open(
                    ld, (self.rng.expovariate(ld.rate) if ld.rate > 0
                         else self.RATE_PROBE))
            else:
                for _ in range(ld.sessions):
                    self._arm_closed(
                        ld, delay=self.rng.uniform(0, max(ld.think, 0.01)))

    def _make(self, ld: TenantLoad) -> Request:
        r = Request(prompt_len=ld.prompt, max_new_tokens=ld.gen,
                    priority=ld.priority, tenant=ld.tenant,
                    slo_class=ld.slo_class)
        self.requests[ld.tenant].append(r)
        return r

    def _schedule_open(self, ld: TenantLoad, dt: float) -> None:
        t = self.loop.now() + dt
        if t >= self.t_end:
            return
        self.loop.call_at(t, lambda: self._tick_open(ld))

    def _tick_open(self, ld: TenantLoad) -> None:
        if ld.rate > 0:
            self.submit_fn(self._make(ld))
            self._schedule_open(ld, self.rng.expovariate(ld.rate))
        else:
            # quiesced (rate set to 0 mid-run): keep a probe timer alive
            # so restoring the rate revives the loop
            self._schedule_open(ld, self.RATE_PROBE)

    def _arm_closed(self, ld: TenantLoad, delay: float) -> None:
        def go():
            if self.loop.now() >= self.t_end:
                return
            r = self._make(ld)
            r.meta["on_done"] = lambda: self._arm_closed(
                ld, ld.think * (1 + self.rng.uniform(-0.3, 0.3)))
            self.submit_fn(r)
        self.loop.call_after(max(delay, 0.0), go)

    @staticmethod
    def wire_pool(pool) -> None:
        """Chain the pool's finish callback to the closed loops'
        ``on_done`` re-arm hook (keeps any existing callback)."""
        prev = pool.on_finish

        def _done(req, t):
            cb = req.meta.get("on_done")
            if cb is not None:
                cb()
            if prev is not None:
                prev(req, t)
        pool.on_finish = _done


@dataclass
class Phase:
    duration: float
    n_clients: int


class PhasedLoad:
    """Fig 6: load that shifts between phases at runtime."""

    def __init__(self, pipeline: AgenticPipeline, cfg: WorkloadConfig,
                 phases: list[Phase]):
        self.p = pipeline
        self.cfg = cfg
        self.phases = phases
        self.clients: list[ClosedLoopClient] = []
        self.rng = random.Random(cfg.seed)
        self.boundaries: list[float] = []

    def start(self) -> None:
        self.p.on_task_done = _dispatch_done
        t = 0.0
        for ph in self.phases:
            self.p.loop.call_at(t, lambda n=ph.n_clients: self._set_clients(n))
            self.boundaries.append(t)
            t += ph.duration
        self.t_end = t

    def _set_clients(self, n: int) -> None:
        while len(self.clients) < n:
            i = len(self.clients)
            c = ClosedLoopClient(self.p, f"sess-{i}", self.cfg, self.rng)
            self.clients.append(c)
            c.start(delay=self.rng.uniform(0, 0.2))
        for i, c in enumerate(self.clients):
            if i < n and not c.active:
                c.active = True
                c.start(delay=self.rng.uniform(0, 0.2))
            elif i >= n:
                c.stop()
