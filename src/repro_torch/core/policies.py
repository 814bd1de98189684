"""Control policies — the closed-loop programs the paper's evaluation
exercises (Figs 6–7), plus guards used by examples/tests.

Each is a plain ``Policy``: it reads the state store, and acts only
through the ControlContext capability surface.  The same behaviours can
be expressed in the declarative intent language (core/intent.py); these
programmatic versions exist because Fig 6/7 need stateful logic
(hysteresis counters, per-session placement maps) beyond the guarded
commands the language targets.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.controller import ControlContext, Policy
from repro_torch.core.types import Granularity


class AdaptiveGranularityPolicy(Policy):
    """Fig 6: switch a channel's granularity with downstream load.

    Load signal = queue length + running at the consumer engine(s).
    Thresholds carry hysteresis (switch up at ``hi``, back down at
    ``lo``) so the data plane doesn't flap around a boundary.
    """

    name = "adaptive-granularity"

    def __init__(self, channel: str, consumers: list[str],
                 stream_below: float = 2.0, batch_above: float = 8.0,
                 window: float = 1.0, dwell: float = 1.5):
        assert stream_below <= batch_above
        self.channel = channel
        self.consumers = consumers
        self.stream_below = stream_below
        self.batch_above = batch_above
        self.window = window
        self.dwell = dwell              # min residency in a mode (anti-flap)
        self.mode: Optional[Granularity] = None
        self.switches: list[tuple[float, Granularity]] = []

    def _load(self, ctx: ControlContext) -> float:
        total = 0.0
        for c in self.consumers:
            total += ctx.metric(f"{c}.queue_len", "mean", self.window)
            total += ctx.metric(f"{c}.num_running", "mean", self.window)
        return total

    def on_tick(self, ctx: ControlContext) -> None:
        load = self._load(ctx)
        mode = self.mode or Granularity.PIPELINE
        if load >= self.batch_above:
            mode = Granularity.BATCH
        elif load <= self.stream_below:
            mode = Granularity.STREAM
        elif self.mode is None:
            mode = Granularity.PIPELINE
        elif self.mode is Granularity.BATCH and load < self.batch_above * 0.6:
            mode = Granularity.PIPELINE
        elif self.mode is Granularity.STREAM and load > self.stream_below * 1.5:
            mode = Granularity.PIPELINE
        if mode is not self.mode:
            if self.switches and ctx.now - self.switches[-1][0] < self.dwell:
                return
            ctx.granularity(self.channel, mode)
            self.mode = mode
            self.switches.append((ctx.now, mode))


@dataclass
class _SessionHome:
    instance: str
    context_len: int = 0


class LoadBalancePolicy(Policy):
    """Fig 7: keep tester instances balanced; migrate session KV state.

    * ``mode='none'``   — static session→instance hash (the baseline).
    * ``mode='reactive'`` — route to least-loaded; the destination pulls
      session KV *after* the request arrives (transfer serializes with
      the request).
    * ``mode='hints'``  — on ``task_start`` (the upstream agent begins
      generating) the controller *proactively* pushes the session KV to
      the chosen instance, overlapping the transfer with generation —
      the paper's 1.8× mechanism.
    """

    name = "load-balance"

    def __init__(self, instances: list[str], mode: str = "hints",
                 imbalance_min: float = 6.0, cooldown: float = 4.0,
                 window: float = 0.5, pending_weight: float = 6.0,
                 pending_horizon: float = 1.5):
        assert mode in ("none", "reactive", "hints")
        self.instances = instances
        self.mode = mode
        self.imbalance_min = imbalance_min
        self.cooldown = cooldown            # min gap between migrations
        self.window = window                # of the same session
        # install-time accounting: the controller charges each routing
        # decision to the target *before* the metrics can see it, else
        # every session herds to the same briefly-cold instance
        self.pending_weight = pending_weight
        self.pending_horizon = pending_horizon
        self._pending: dict[str, list[float]] = {i: [] for i in instances}
        self.homes: dict[str, _SessionHome] = {}
        self._last_move: dict[str, float] = {}
        self.migrations = 0
        self.hints_sent = 0

    # -- helpers ----------------------------------------------------------------
    def _static_instance(self, session: str) -> str:
        h = zlib.crc32(session.encode())
        return self.instances[h % len(self.instances)]

    def _load(self, ctx: ControlContext, inst: str) -> float:
        q = ctx.metric(f"{inst}.queue_len", "last", default=0.0)
        r = ctx.metric(f"{inst}.num_running", "last", default=0.0)
        pend = self._pending.get(inst, [])
        horizon = ctx.now - self.pending_horizon
        pend[:] = [t for t in pend if t >= horizon]
        return q + r + self.pending_weight * len(pend)

    def _pick(self, ctx: ControlContext) -> str:
        return min(self.instances, key=lambda i: self._load(ctx, i))

    def _charge(self, ctx: ControlContext, inst: str) -> None:
        self._pending.setdefault(inst, []).append(ctx.now)

    # -- event path (push, between polls) ------------------------------------
    def on_event(self, ctx: ControlContext, kind: str, **kw) -> None:
        if kind != "task_start":
            return
        session = kw["session"]
        home = self.homes.get(session)
        if self.mode == "none":
            inst = self._static_instance(session)
            if home is None:
                self.homes[session] = _SessionHome(inst)
                ctx.route(session, inst)
            return
        # dynamic: choose the least-loaded instance *now*
        inst = self._pick(ctx)
        if home is None:
            self.homes[session] = _SessionHome(inst)
            self._charge(ctx, inst)
            ctx.route(session, inst)
            return
        if inst == home.instance:
            self._charge(ctx, inst)
            ctx.route(session, inst)
            return
        # migration is not free (KV moves, the destination warms up) —
        # move only if the imbalance is material and this session hasn't
        # just moved (cost-aware throttling, not per-message micromanaging)
        gap = self._load(ctx, home.instance) - self._load(ctx, inst)
        recently = ctx.now - self._last_move.get(session, -1e18)
        if gap < self.imbalance_min or recently < self.cooldown:
            self._charge(ctx, home.instance)
            ctx.route(session, home.instance)
            return
        self._last_move[session] = ctx.now
        self._charge(ctx, inst)
        ctx.route(session, inst)
        self.migrations += 1
        if self.mode == "hints":
            # proactive: start moving state NOW, while the developer is
            # still generating — the transfer overlaps generation
            ctx.transfer_kv(session, home.instance, inst, proactive=True)
            self.hints_sent += 1
        # reactive: no transfer here — the destination instance pulls the
        # state only once the request arrives (serialized on the request)
        home.instance = inst

    def on_tick(self, ctx: ControlContext) -> None:
        pass                            # all work happens on task_start


class SpeculativeGatePolicy(Policy):
    """Request-level rule from §3.1: block speculative sends while the
    consumer is loaded; release when pressure clears."""

    name = "speculative-gate"

    def __init__(self, channel: str, consumers: list[str],
                 gate_above: float = 4.0, window: float = 1.0):
        self.channel = channel
        self.consumers = consumers
        self.gate_above = gate_above
        self.window = window
        self.gated = False

    def on_tick(self, ctx: ControlContext) -> None:
        load = sum(ctx.metric(f"{c}.queue_len", "mean", self.window)
                   for c in self.consumers)
        if load >= self.gate_above and not self.gated:
            ctx.set(self.channel, "gate_speculative", True)
            self.gated = True
        elif load < self.gate_above * 0.5 and self.gated:
            ctx.set(self.channel, "gate_speculative", False)
            self.gated = False


class SLOGuardPolicy(Policy):
    """Intent example from §3.1: 'ensure p90 latency of interactive
    requests meets the SLO' — demote background traffic and tighten
    admission until the SLO holds, then relax."""

    name = "slo-guard"

    def __init__(self, latency_metric: str, slo: float, engine: str,
                 background_channel: Optional[str] = None,
                 window: float = 2.0):
        self.latency_metric = latency_metric
        self.slo = slo
        self.engine = engine
        self.background_channel = background_channel
        self.window = window
        self.tightened = False
        self.violations = 0

    def on_tick(self, ctx: ControlContext) -> None:
        p90 = ctx.metric(self.latency_metric, "p90", self.window,
                         default=float("nan"))
        if p90 != p90:
            return
        if p90 > self.slo and not self.tightened:
            self.violations += 1
            ctx.set(self.engine, "admit_priority_min", 1)   # drop LOW
            ctx.set(self.engine, "decode_first", True)
            if self.background_channel:
                ctx.granularity(self.background_channel, Granularity.BATCH)
            self.tightened = True
        elif p90 <= self.slo * 0.7 and self.tightened:
            ctx.reset(self.engine, "admit_priority_min")
            ctx.reset(self.engine, "decode_first")
            if self.background_channel:
                ctx.reset(self.background_channel, "granularity")
            self.tightened = False


class TenantGuardPolicy(Policy):
    """Tenancy plane: keep a gold tenant's TTFT SLO by reshaping the
    fleet's fairness state — bump the gold tenant's weighted-fair
    ``weight`` and pause ``batch``-class tenants while the breach is
    sustained; restore both once the SLO holds again with margin.  Acts
    only through the registered ``tenant.<name>`` knobs, so the same
    behaviour is expressible in intent as

        rule guard on tenant gold.p95_ttft > 1.5 hold 2:
            => set tenant gold.weight 8; set tenant batch.paused true

    The p95 is computed from the raw ``tenant.<t>.ttft`` observations
    in the store (window ``window``), so the policy works with or
    without a MetricBus; ``sustain`` consecutive breaching ticks are
    required before acting (transient spikes don't pause anyone).
    """

    name = "tenant-guard"

    def __init__(self, gold: str, batch: list[str], slo_ttft: float,
                 boost_weight: float = 8.0, window: float = 2.0,
                 sustain: int = 3, clear_frac: float = 0.6,
                 pause_batch: bool = True, prefix: str = "tenant"):
        self.gold = gold
        self.batch = batch
        self.slo_ttft = slo_ttft
        self.boost_weight = boost_weight
        self.window = window
        self.sustain = sustain              # consecutive breaching ticks
        self.clear_frac = clear_frac        # hysteresis release threshold
        self.pause_batch = pause_batch
        self.prefix = prefix
        self.tightened = False
        self.breaches = 0
        self.actions: list[tuple[float, str]] = []

    def _p95(self, ctx: ControlContext) -> float:
        return ctx.metric(f"{self.prefix}.{self.gold}.ttft", "p95",
                          self.window, default=float("nan"))

    def _relax(self, ctx: ControlContext) -> None:
        ctx.reset(f"{self.prefix}.{self.gold}", "weight")
        if self.pause_batch:
            for b in self.batch:
                ctx.reset(f"{self.prefix}.{b}", "paused")
        self.tightened = False
        self.breaches = 0
        self.actions.append((ctx.now, "relax"))

    def on_tick(self, ctx: ControlContext) -> None:
        p95 = self._p95(ctx)
        if p95 != p95:
            # no gold samples in the window: nothing left to protect —
            # a tightened guard must not leave batch tenants paused
            # (= starved) forever after the gold traffic goes quiet
            if self.tightened:
                self._relax(ctx)
            return
        if p95 > self.slo_ttft:
            self.breaches += 1
        else:
            self.breaches = 0
        if self.breaches >= self.sustain and not self.tightened:
            ctx.set(f"{self.prefix}.{self.gold}", "weight",
                    self.boost_weight)
            if self.pause_batch:
                for b in self.batch:
                    ctx.set(f"{self.prefix}.{b}", "paused", True)
            self.tightened = True
            self.actions.append((ctx.now, "tighten"))
        elif self.tightened and p95 <= self.slo_ttft * self.clear_frac:
            self._relax(ctx)


class StageTierPolicy(Policy):
    """Workflow-plane tiering (Aragog-style): when a stage's p95 call
    latency breaches, shift its calls to the smaller model tier; when
    it stays calm, shift back up.  Acts only through the stage's
    registered ``stage.<name>.model_tier`` knob, so the same behaviour
    is expressible in intent as

        rule slow on stage reviewer.p95 > 2 hold 3:
            => set stage reviewer.model_tier small
    """

    name = "stage-tier"

    def __init__(self, stages: list[str], slow_above: float,
                 fast_below: Optional[float] = None,
                 small: str = "small", large: str = "large",
                 dwell: float = 2.0):
        self.stages = stages
        self.slow_above = slow_above
        self.fast_below = (fast_below if fast_below is not None
                           else slow_above * 0.4)
        self.small = small
        self.large = large
        self.dwell = dwell               # min residency per tier (anti-flap)
        self._moved: dict[str, float] = {}
        self.shifts: list[tuple[float, str, str]] = []

    def on_tick(self, ctx: ControlContext) -> None:
        for s in self.stages:
            p95 = ctx.metric(f"stage.{s}.p95", "last",
                             default=float("nan"))
            if p95 != p95:
                continue
            cur = ctx.get(f"stage.{s}", "model_tier")
            want = cur
            if p95 > self.slow_above and cur != self.small:
                want = self.small
            elif p95 < self.fast_below and cur != self.large:
                want = self.large
            if want == cur:
                continue
            if ctx.now - self._moved.get(s, -1e18) < self.dwell:
                continue
            ctx.set(f"stage.{s}", "model_tier", want)
            self._moved[s] = ctx.now
            self.shifts.append((ctx.now, s, want))


class ChunkPolicy(Policy):
    """Mixed-batching plane: retune an engine's chunked-prefill size from
    its runtime decode-stall signal — the paper's software-defined knob
    loop closed over the ``prefill_chunk`` attribute.

    Sustained ``itl_p95`` above the SLO means the co-running prefill
    chunk is stealing too much of each fused step: halve the chunk
    (floored at ``chunk_min``, so prefill always progresses).  When ITL
    is calm with margin AND prompt tokens are backed up behind prefill,
    grow the chunk back (capped at ``chunk_max``) so TTFT recovers.
    ``dwell`` rate-limits moves (anti-flap), and a ``prefill_chunk`` of
    0 (= whole prompt) is treated as ``chunk_max`` when shrinking.
    Acts only through the engine's registered Table-1 knob, so the same
    behaviour is expressible in intent as

        rule stall on engine e0.itl_p95 > 0.05:
            => set engine e0.prefill_chunk 256
    """

    name = "chunk-policy"

    def __init__(self, engine: str, itl_slo: float,
                 chunk_min: int = 64, chunk_max: int = 1024,
                 shrink: float = 0.5, grow: float = 2.0,
                 clear_frac: float = 0.5, dwell: float = 0.5):
        assert 0 < shrink < 1 < grow
        self.engine = engine
        self.itl_slo = itl_slo
        self.chunk_min = chunk_min
        self.chunk_max = chunk_max
        self.shrink = shrink
        self.grow = grow
        self.clear_frac = clear_frac     # grow only below slo*clear_frac
        self.dwell = dwell
        self._last_move = -1e18
        self.moves: list[tuple[float, int]] = []

    def on_tick(self, ctx: ControlContext) -> None:
        itl = ctx.metric(f"{self.engine}.itl_p95", "last",
                         default=float("nan"))
        if itl != itl:
            return                       # no decode signal yet
        if ctx.now - self._last_move < self.dwell:
            return
        cur = int(ctx.get(self.engine, "prefill_chunk"))
        eff = cur if cur > 0 else self.chunk_max
        want = eff
        if itl > self.itl_slo:
            want = max(self.chunk_min, int(eff * self.shrink))
        elif itl < self.itl_slo * self.clear_frac:
            backlog = ctx.metric(f"{self.engine}.prefill_queue_tokens",
                                 "last", default=0.0)
            if backlog > 0 and eff < self.chunk_max:
                want = min(self.chunk_max, int(eff * self.grow))
        if want == cur:
            return
        ctx.set(self.engine, "prefill_chunk", want)
        self._last_move = ctx.now
        self.moves.append((ctx.now, want))


class OffloadPolicy(Policy):
    """Tool-call suspend/resume plane: escalate an engine's KV offload
    stance from queue pressure.  Under light load the ``auto`` rule is
    right — pinning a tool-waiting sequence in its slot is free when
    nobody wants the slot.  Once admission backs up, every parked
    sequence is stolen decode capacity: push the engine to
    ``aggressive`` (spill every suspend to the host tier), and relax
    back to ``auto`` only below the hysteresis low-water mark.  Acts
    only through the engine's registered Table-1 ``offload`` knob, so
    the same behaviour is expressible in intent as

        rule offload on engine e0.queue_len > 8:
            => set engine e0.offload aggressive
    """

    name = "offload-policy"

    def __init__(self, engine: str, queue_hi: float = 8.0,
                 queue_lo: float = 2.0, dwell: float = 0.5):
        assert queue_lo <= queue_hi
        self.engine = engine
        self.queue_hi = queue_hi
        self.queue_lo = queue_lo
        self.dwell = dwell
        self._last_move = -1e18
        self.moves: list[tuple[float, str]] = []

    def on_tick(self, ctx: ControlContext) -> None:
        q = ctx.metric(f"{self.engine}.queue_len", "last",
                       default=float("nan"))
        if q != q:
            return                       # engine not reporting yet
        if ctx.now - self._last_move < self.dwell:
            return
        cur = str(ctx.get(self.engine, "offload"))
        want = cur
        if q > self.queue_hi:
            want = "aggressive"
        elif q <= self.queue_lo and cur == "aggressive":
            want = "auto"
        if want == cur:
            return
        ctx.set(self.engine, "offload", want)
        self._last_move = ctx.now
        self.moves.append((ctx.now, want))


class RoleBalancerPolicy(Policy):
    """Disaggregation plane: flip engine *roles* from fleet
    pressure — the SDN-native version of disaggregated serving.  Reads
    the ``FleetAggregate`` gauges the DisaggPool publishes
    (``cluster.prefill_pressure``, ``cluster.decode_slot_util``) and
    acts only through each engine's registered ``role`` knob, so the
    same behaviour is expressible in intent as

        rule surge on cluster.prefill_pressure > 2 hold 1:
            => set engine e2.role prefill

    Guard rails: the fleet always keeps at least one prefill-capable
    and at least one decode-capable engine (``unified`` counts as
    both), and ``dwell`` rate-limits flips so the fleet doesn't thrash
    around a pressure boundary.
    """

    name = "role-balancer"

    def __init__(self, engines: list[str], pressure_hi: float = 2.0,
                 pressure_lo: float = 0.25, min_prefill: int = 0,
                 min_decode: int = 1, dwell: float = 0.5,
                 release_dwell: Optional[float] = None,
                 window: float = 1.0, prefix: str = "cluster",
                 slot_profile: Optional[dict] = None):
        assert pressure_lo <= pressure_hi
        self.engines = engines
        self.pressure_hi = pressure_hi
        self.pressure_lo = pressure_lo
        self.min_prefill = min_prefill
        self.min_decode = min_decode
        self.dwell = dwell
        # asymmetric residency: conscripting a prefill engine migrates
        # its running decodes (disruptive — deliberate), releasing one
        # back to decode duty drains nothing (cheap — prompt), so the
        # two directions get separate dwells
        self.release_dwell = (release_dwell if release_dwell is not None
                              else dwell / 3.0)
        self.window = window        # sustained-pressure window: a role
        self.prefix = prefix        # flip drains real work, so transient
                                    # spikes must not trigger one
        # role -> max_num_seqs co-flip: a decode-only engine spends the
        # activation memory a unified engine reserves for prefill chunks
        # on extra decode slots instead, so flipping the role also
        # reshapes the batch (both through the same Table-1 surface)
        self.slot_profile = slot_profile or {}
        self._last_flip = -1e18
        self.flips: list[tuple[float, str, str]] = []

    def _flip(self, ctx: ControlContext, engine: str, role: str) -> None:
        ctx.role(engine, role)
        if role in self.slot_profile:
            ctx.set(engine, "max_num_seqs", self.slot_profile[role])
        self._last_flip = ctx.now
        self.flips.append((ctx.now, engine, role))

    def on_tick(self, ctx: ControlContext) -> None:
        since_flip = ctx.now - self._last_flip
        if since_flip < min(self.dwell, self.release_dwell):
            return
        pressure = ctx.metric(f"{self.prefix}.prefill_pressure", "mean",
                              self.window, default=float("nan"))
        if pressure != pressure:
            return                       # fleet gauges not flowing yet
        roles = {e: ctx.get(e, "role") for e in self.engines}
        n_prefill = sum(1 for r in roles.values() if r == "prefill")
        decode_capable = sum(1 for r in roles.values() if r != "prefill")
        prefill_capable = len(roles) - sum(1 for r in roles.values()
                                           if r == "decode")
        if pressure > self.pressure_hi and since_flip >= self.dwell:
            # prefill starved: conscript the least decode-utilized
            # non-prefill engine — but never drain the decode fleet
            if decode_capable - 1 < max(self.min_decode, 1):
                return
            cand = [e for e in self.engines if roles[e] != "prefill"]
            pick = min(cand, key=lambda e: ctx.metric(
                f"{e}.decode_slot_util", "last", default=0.0))
            self._flip(ctx, pick, "prefill")
        elif (pressure < self.pressure_lo and n_prefill > self.min_prefill
                and since_flip >= self.release_dwell):
            # prefill idle: return the emptiest prefill engine to
            # decode duty — but keep a prefill path alive
            if prefill_capable - 1 < 1:
                return
            cand = [e for e in self.engines if roles[e] == "prefill"]
            pick = min(cand, key=lambda e: ctx.metric(
                f"{e}.prefill_queue_tokens", "last", default=0.0))
            self._flip(ctx, pick, "decode")


class AutoscalePolicy(Policy):
    """Elastic-scaling hook (§4 posture): ask the runtime to add/remove
    instances when sustained load crosses thresholds.  The actual
    spawn/drain is the runtime's job (runtime/elastic.py); the policy
    only decides."""

    name = "autoscale"

    def __init__(self, instances: list[str], scale_up_at: float = 12.0,
                 scale_down_at: float = 1.0, window: float = 2.0,
                 cooldown: float = 5.0):
        self.instances = instances
        self.scale_up_at = scale_up_at
        self.scale_down_at = scale_down_at
        self.window = window
        self.cooldown = cooldown
        self._last = -1e18
        self.decisions: list[tuple[float, str]] = []
        self.scale_fn = None            # runtime attaches

    def on_tick(self, ctx: ControlContext) -> None:
        if ctx.now - self._last < self.cooldown:
            return
        loads = [ctx.metric(f"i.queue_len".replace("i", i), "mean",
                            self.window) for i in self.instances]
        mean_load = sum(loads) / max(len(loads), 1)
        if mean_load >= self.scale_up_at:
            self.decisions.append((ctx.now, "up"))
            ctx.note("autoscale", f"scale up (load={mean_load:.1f})")
            if self.scale_fn:
                self.scale_fn(+1)
            self._last = ctx.now
        elif mean_load <= self.scale_down_at and len(self.instances) > 1:
            self.decisions.append((ctx.now, "down"))
            ctx.note("autoscale", f"scale down (load={mean_load:.1f})")
            if self.scale_fn:
                self.scale_fn(-1)
            self._last = ctx.now
