"""Disaggregated prefill/decode plane — software-defined engine roles.

The paper's thesis is that serving attributes should be programmable
from runtime state rather than statically encoded.  This module applies
that to *disaggregation itself*: instead of deploying a fixed prefill
fleet and a fixed decode fleet, every engine carries a ``role`` knob
(``unified | prefill | decode``) on the ordinary Table-1 surface, and a
``DisaggPool`` turns a fleet of role-knobbed engines into one serving
entry point:

* the pool's ``disagg`` router picks the prefill-capable engine with
  the shallowest prefill queue and — when that engine is prefill-role —
  pre-pins the paired decode engine, so the KV handoff session opens
  *before the first token exists*;
* as prefill advances, the ``KVTransferManager`` handoff pipeline
  streams KV chunks to the pinned decode engine (transfer overlaps the
  tail of prefill); at prefill completion the first token is emitted on
  the prefill engine (TTFT), the sequence is released, and the tail
  chunk rides the link;
* the decode engine admits through the generalized ``admit_direct``
  path, gated on KV residency, and carries the decode tail to
  completion — its ``on_finish`` chain fires exactly as if the request
  had lived there all along.

Because the role is a knob, a ``RoleBalancerPolicy`` (core/policies.py)
or an intent rule (``on cluster.prefill_pressure > 2 => set engine
e2.role prefill``) can re-partition the fleet at runtime; the pool
drains role-inconsistent work on every flip — RUNNING decodes migrate
off a newly-prefill engine, un-admitted prompts bounce off a
newly-decode engine — so no request is ever lost.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.metrics import FleetAggregate
from repro_torch.core.types import Message, Request, RequestState
from repro_torch.serving.engine_base import EngineCore
from repro_torch.serving.kv_transfer import KVTransferManager
from repro_torch.serving.router import Router, pick_decode_engine
from repro_torch.sim.clock import EventLoop


class EngineEndpoint:
    """Router endpoint adapting one engine of the pool: messages carry a
    prebuilt ``Request`` (the pool's routing unit)."""

    def __init__(self, engine: EngineCore):
        self.engine = engine
        self.name = engine.name

    def deliver(self, msg: Message) -> None:
        self.engine.submit((msg.payload or {})["request"])

    def load(self) -> float:
        return self.engine.load()


class DisaggPool:
    """One serving entry point over a fleet of role-knobbed engines
    (see module docstring)."""

    def __init__(self, loop: EventLoop, engines: list[EngineCore],
                 kvx: KVTransferManager, collector=None,
                 name: str = "disagg", cluster_prefix: str = "cluster",
                 tenants=None, tracer=None):
        self.loop = loop
        self.name = name
        self.engines = {e.name: e for e in engines}
        self.kvx = kvx
        self.collector = collector
        self.tenants = tenants           # TenantDirectory | None
        self.tracer = tracer             # tracing plane | None
        self.router = Router(loop, f"{name}.router", policy="disagg",
                             collector=collector, tenants=tenants)
        self.router.on_dispatch = self._dispatched
        if tracer is not None:
            self.router.tracer = tracer
            kvx.tracer = tracer
            for e in engines:
                e.tracer = tracer
        if tenants is not None:
            # one directory serves the fleet: schedulers read fairness
            # weights, engines report per-tenant TTFT through it
            for e in engines:
                e.scheduler.attach_tenants(tenants)
        self._backlog: dict[str, list[tuple[Request, dict]]] = {}
        self.finished: list[Request] = []
        self.handoffs = 0
        self.migrations = 0          # role-flip drains (reactive handoffs)
        self.on_finish = None        # optional user callback (req, t)
        for e in engines:
            self._wire(e)
            self.router.add_instance(EngineEndpoint(e), engine=e)
        self._wire_cluster_gauges(cluster_prefix)

    # -- wiring -------------------------------------------------------------
    def _wire(self, e: EngineCore) -> None:
        e.disagg = self
        # a victim preempted on a decode-role engine could never be
        # re-admitted locally (decode role blocks waiting-queue
        # admission): bounce it back through the router to re-prefill
        e.scheduler.bounce_fn = self.resubmit
        e.kv_ready_fn = (
            lambda req, n=e.name: self.kvx.handoff_wait(req.req_id, n))
        e.on_prefill_progress = (
            lambda req, t: self.kvx.handoff_progress(req.req_id,
                                                     req.prefilled))
        e.on_prefill_done = (
            lambda req, t, e=e: self._prefill_done(e, req, t))
        prev_finish = e.on_finish
        def _fin(req, t, e=e, prev=prev_finish):
            self._finished(e, req, t)
            if prev is not None:
                prev(req, t)
        e.on_finish = _fin

    def _wire_cluster_gauges(self, prefix: str) -> None:
        """Fleet-level derived gauges the RoleBalancerPolicy / intent
        triggers consume: total prefill backlog, mean decode slot
        utilization, and the normalized prefill pressure (steps of
        backlog relative to the fleet's per-step prefill budget)."""
        if self.collector is None or self.collector.bus is None:
            self.fleet = None
            return
        names = list(self.engines)
        budget = sum(e.scheduler.cfg.max_batch_tokens
                     for e in self.engines.values())
        self.fleet = FleetAggregate(self.collector, prefix=prefix)
        self.fleet.watch("prefill_queue_tokens",
                         [f"{n}.prefill_queue_tokens" for n in names],
                         how="sum")
        self.fleet.watch("decode_slot_util",
                         [f"{n}.decode_slot_util" for n in names],
                         how="mean")
        self.fleet.watch("prefill_pressure",
                         [f"{n}.prefill_queue_tokens" for n in names],
                         how="sum", scale=1.0 / max(budget, 1))

    # -- role inventory -----------------------------------------------------
    def roles(self) -> dict[str, str]:
        return {n: e.role for n, e in self.engines.items()}

    def _pick_decode(self, exclude: Optional[str] = None) -> Optional[str]:
        # same criterion the router's pre-pin uses (router.py)
        return pick_decode_engine(self.engines, exclude=exclude)

    # -- workload entry -----------------------------------------------------
    def submit(self, req: Request, session: Optional[str] = None,
               _remeter: bool = True) -> None:
        msg = Message(src="client", dst=self.router.name,
                      payload={"request": req,
                               "session": session or req.req_id},
                      task_id=req.req_id, created_at=self.loop.now(),
                      tokens=req.prompt_len,      # meter by prompt size
                      tenant=req.tenant, slo_class=req.slo_class)
        if not _remeter:
            # internal re-route (role-flip bounce): already charged
            # through the tenant bucket on first admission
            self.router.exempt(msg.msg_id)
        # the clock starts at submission: time held by the tenant meter
        # is part of the request's TTFT/latency, not invisible to it
        if not req.meta.get("arrived"):
            req.meta["arrived"] = True
            req.arrival_time = self.loop.now()
        self.router.deliver(msg)

    def _dispatched(self, msg: Message, inst: str) -> None:
        """Router dispatch hook: runs when the message actually lands on
        an engine — including messages released from the throttle/held
        queues later, whose pre-pin would otherwise never be consumed
        (and the proactive handoff never opened)."""
        req = (msg.payload or {}).get("request")
        if req is None:
            return
        pair = self.router.pair_for(req.req_id)
        if pair is not None:
            src, dst = pair
            if src != dst:
                # pre-pinned decode engine: open the handoff session NOW
                # so prefill-progress chunks stream before first token
                self.kvx.start_handoff(req.req_id, src, dst)

    def resubmit(self, req: Request) -> None:
        """A decode-role engine bounced a fresh prompt back: route it to
        a prefill-capable engine.  Loud failure when the fleet has none
        (a misconfigured all-decode fleet would otherwise starve)."""
        if all(e.role == "decode" for e in self.engines.values()):
            raise RuntimeError(
                f"{self.name}: no prefill-capable engine for {req.req_id}")
        n = req.meta.get("disagg_reroutes", 0) + 1
        req.meta["disagg_reroutes"] = n
        if n > len(self.engines) + 1:
            # a routing rule keeps pinning this request to a decode
            # engine: surface the conflict instead of ping-ponging
            raise RuntimeError(
                f"{self.name}: {req.req_id} cannot reach a "
                "prefill-capable engine (conflicting route rule?)")
        self.kvx.end_handoff(req.req_id)     # stale pre-pin, if any
        self.submit(req, _remeter=False)

    # -- handoff state machine ----------------------------------------------
    def _prefill_done(self, eng: EngineCore, req: Request, t: float) -> None:
        """Prefill-role engine finished a prompt: release it there and
        finish the (possibly pre-streamed) handoff to its decode pair."""
        rec = self.kvx.handoff_records.get(req.req_id)
        dst_name = rec.dst if rec is not None else None
        if (dst_name is None or dst_name not in self.engines
                or self.engines[dst_name].role == "prefill"):
            dst_name = self._pick_decode(exclude=eng.name)
        if dst_name is None:
            raise RuntimeError(
                f"{self.name}: no decode-capable engine for {req.req_id}")
        self._handoff_to(eng, req, dst_name)
        self.handoffs += 1
        if self.collector is not None:
            self.collector.counter(f"{self.name}.handoffs", 1, t)

    def _handoff_to(self, eng: EngineCore, req: Request,
                    dst_name: str) -> None:
        state = eng.extract_state(req)
        eng.release_for_handoff(req)
        dst = self.engines[dst_name]
        self.kvx.finish_handoff(
            req.req_id, eng.name, dst_name, req.total_len,
            on_ready=lambda: self._arrive(dst, req, state))

    def _arrive(self, dst: EngineCore, req: Request, state: dict) -> None:
        """Handoff KV landed at the decode engine: admit (generalized
        admit_direct, residency-gated), queue for retry when a slot
        frees up, or re-home if the engine left decode duty while the
        tail was in flight."""
        if req.state is not RequestState.HANDOFF:
            self.kvx.end_handoff(req.req_id)   # finished/failed in flight
            return
        if dst.role == "prefill":
            # the pinned engine flipped while the KV was on the wire:
            # backlogging here would strand the request (a prefill-role
            # engine never admits decodes and rarely finishes anything)
            self._rehome(dst.name, req, state)
            return
        if dst.receive_handoff(req, state):
            self.kvx.end_handoff(req.req_id)
        else:
            self._backlog.setdefault(dst.name, []).append((req, state))

    def _rehome(self, old_name: str, req: Request, state: dict) -> None:
        """Re-target an in-flight/landed handoff whose decode engine is
        no longer decode-capable (its KV restreams to the new target)."""
        dst_name = self._pick_decode(exclude=old_name)
        if dst_name is None:
            raise RuntimeError(
                f"{self.name}: no decode-capable engine for {req.req_id}")
        dst = self.engines[dst_name]
        self.kvx.finish_handoff(
            req.req_id, old_name, dst_name, req.total_len,
            on_ready=lambda: self._arrive(dst, req, state))

    def _drain_backlog(self, eng: EngineCore) -> None:
        backlog = self._backlog.get(eng.name)
        if not backlog:
            return
        if eng.role == "prefill":
            # the engine left decode duty with arrivals still queued:
            # re-home them (their KV restreams to the new target)
            for req, state in backlog:
                self._rehome(eng.name, req, state)
            backlog.clear()
            return
        keep = []
        for req, state in backlog:
            if req.state is not RequestState.HANDOFF:
                self.kvx.end_handoff(req.req_id)   # abandoned in flight
                continue
            if eng.receive_handoff(req, state):
                self.kvx.end_handoff(req.req_id)
            else:
                keep.append((req, state))
        self._backlog[eng.name] = keep

    # -- engine callbacks ---------------------------------------------------
    def _finished(self, eng: EngineCore, req: Request, t: float) -> None:
        # any open handoff session for a finished request is moot — e.g.
        # a pre-pinned request done at its first token (max_new_tokens
        # == 1) never reaches the handoff path, but its record (and the
        # chunks already streamed) must not outlive it
        self.kvx.end_handoff(req.req_id)
        self.finished.append(req)
        if self.on_finish is not None:
            self.on_finish(req, t)
        self._drain_backlog(eng)         # a slot just freed up

    # -- role transitions ---------------------------------------------------
    def on_role_change(self, eng: EngineCore, old: str, new: str) -> None:
        """Drain work that is inconsistent with the engine's new role.
        Flipping to ``prefill``: RUNNING decodes migrate to a decode
        engine (reactive handoff of their full state) and queued
        arrivals re-home.  Flipping to ``decode``: un-admitted prompts
        bounce back through the router to a prefill-capable engine;
        admitted PREFILL sequences are grandfathered (they finish
        prefill here and decode in place — the KV is already local)."""
        if new == "prefill":
            running = [r for r in list(eng.scheduler.running)
                       if r.state is RequestState.RUNNING]
            for r in running:
                dst_name = self._pick_decode(exclude=eng.name)
                if dst_name is None:
                    raise RuntimeError(
                        f"{self.name}: cannot flip {eng.name} to prefill "
                        "— no decode-capable engine to drain to")
                # no start_handoff here: _handoff_to's finish_handoff
                # creates (or re-targets) the record itself
                self._handoff_to(eng, r, dst_name)
                self.migrations += 1
            self._drain_backlog(eng)
        elif new == "decode":
            waiting, eng.scheduler.waiting = eng.scheduler.waiting, []
            for r in waiting:
                self.resubmit(r)
            # admitted PREFILL sequences are grandfathered: they finish
            # prefill here and decode in place, so their open handoff
            # sessions are moot — same cleanup as the unified flip
            self._drop_local_handoffs(eng)
        elif new == "unified":
            # sequences mid-prefill here will now decode in place: any
            # handoff session opened for them is moot
            self._drop_local_handoffs(eng)

    def _drop_local_handoffs(self, eng: EngineCore) -> None:
        """Drop unfinished handoff records whose source sequences will
        now decode locally on ``eng`` — stops further chunk streaming to
        a stale destination and keeps the record table bounded."""
        local = {r.req_id for r in eng.scheduler.running}
        local |= {r.req_id for r in eng.scheduler.waiting}
        for req_id, rec in list(self.kvx.handoff_records.items()):
            if rec.src == eng.name and not rec.finished \
                    and req_id in local:
                self.kvx.end_handoff(req_id)
