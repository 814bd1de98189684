"""Multi-instance router — the request-level control point.

Sits between a channel and a group of agent instances.  Routing order:

1. an installed **request-level rule** (controller's ``ctx.route``) wins;
2. otherwise the router's own fallback policy applies: `static` session
   hash, `least_loaded`, `cache_aware` — score instances by the
   estimated prefix-cache hit (via the controller-visible
   ``CacheDirectory``) and break ties by load, so fan-out requests land
   where their shared prefix is already resident — `stage_aware` —
   Aragog-style per-stage model tiering: instances register with a
   model-size ``tier`` label, messages carry the desired tier (stamped
   from the issuing stage's ``model_tier`` knob), and the router keeps
   the call on a matching-tier instance (least-loaded within the tier,
   full least-loaded fallback when no instance of that tier exists) —
   or `disagg` — disaggregation-aware: pick the prefill-capable engine
   with the shallowest prefill queue, and when that engine is
   prefill-role, *pre-pin* the paired decode engine (lowest decode slot
   utilization) so the fabric can open the KV handoff before the first
   token exists (``pair_for`` hands the pin to the DisaggPool).

Messages delivered while the fleet is empty are held (with the blocked
ones) and re-dispatched on the next ``add_instance`` — the
``<router>.held_count`` gauge makes that window observable.

With a ``TenantDirectory`` attached, every message is metered through
its tenant's token bucket *ahead of* the rule/policy pick: messages of
a throttled (or paused) tenant are **held, never dropped**, and
re-released when the bucket refills or a ``rate``/``paused`` knob moves
— the ``<router>.throttled_count`` gauge tracks the held set, and the
directory publishes the per-tenant ``throttle_rate`` rollups.

Session affinity matters because the tester instances hold per-session
KV state; the controller's LoadBalancePolicy re-pins sessions and pairs
each re-pin with a KV transfer (serving/kv_transfer.py).

Blocked messages (request rules with ``block=True``) are held and
re-checked whenever the rule table version changes — and whenever an
instance is removed, so held traffic never targets a dead instance.
"""
from __future__ import annotations

import zlib
from typing import Callable, Optional

from repro_torch.core.dataplane import Endpoint
from repro_torch.core.knobs import ControlSurface, KnobSpec
from repro_torch.core.rules import RuleTable
from repro_torch.core.types import Message
from repro_torch.sim.clock import EventLoop


def pick_decode_engine(engines: dict, exclude: Optional[str] = None):
    """Shared decode-placement criterion for the disaggregation plane:
    the non-prefill engine minimizing (decode_slot_util, load).  Used
    by both the router's ``disagg`` pre-pin and the DisaggPool's
    reactive handoff/re-home paths, so the pinned pair and the fallback
    can never disagree.  ``exclude`` is soft: it falls back to the
    excluded engine when nothing else can decode.  None when no engine
    is decode-capable."""
    cand = [(n, e) for n, e in engines.items()
            if getattr(e, "role", "unified") != "prefill" and n != exclude]
    if not cand:
        cand = [(n, e) for n, e in engines.items()
                if getattr(e, "role", "unified") != "prefill"]
    if not cand:
        return None
    return min(cand, key=lambda ne: (ne[1].scheduler.decode_slot_util,
                                     ne[1].load()))[0]


class Router(ControlSurface):
    kind = "router"
    CAPABILITIES = ("route",)
    KNOB_SPECS = (
        KnobSpec("policy", kind="str",
                 choices=("static", "least_loaded", "cache_aware",
                          "stage_aware", "disagg"),
                 doc="fallback routing policy when no rule matches"),
    )

    def __init__(self, loop: EventLoop, name: str = "router",
                 rules: Optional[RuleTable] = None, policy: str = "static",
                 collector=None, cache_dir=None,
                 prefix_fn: Optional[Callable[[Message], object]] = None,
                 tenants=None):
        self.loop = loop
        self.name = name
        self.rules = rules or RuleTable()
        self.policy = policy
        self.collector = collector
        self.cache_dir = cache_dir               # CacheDirectory | None
        self.prefix_fn = prefix_fn               # Message -> prefix source
        self.tenants = tenants                   # TenantDirectory | None
        self._throttled: list[Message] = []      # held by the meter
        self._throttle_seen: set[str] = set()    # counted-once msg ids
        self._held_tenants: dict[str, int] = {}  # tenant -> held count
        self._metered: set[str] = set()          # passed-the-bucket ids
        self._pump_at = float("inf")             # pending refill-pump time
        self.tracer = None                       # tracing plane | None
        self._hold_t0: dict[str, float] = {}     # msg_id -> first-hold time
        if tenants is not None:
            # rate/burst/paused knob moves can unblock held traffic NOW
            tenants.subscribe_release(self._pump_throttled)
        self.instances: dict[str, Endpoint] = {}
        self._loads: dict[str, object] = {}      # name -> load() callable
        self._tiers: dict[str, str] = {}         # name -> model-size tier
        self._engines: dict[str, object] = {}    # name -> engine (disagg)
        self._session_pin: dict[str, str] = {}   # fallback stickiness
        self._held: list[Message] = []
        self._pairs: dict[str, tuple[str, str]] = {}  # task -> (src, dst)
        self._rules_seen = -1
        self.routed: dict[str, int] = {}
        self.on_dispatch = None                  # (msg, instance) hook,
                                                 # fired at actual dispatch
        self.cache_routed = 0                    # picks won on prefix score
        self.tier_routed = 0                     # picks won on tier match
        self.disagg_routed = 0                   # picks won on role/depth

    # -- wiring ----------------------------------------------------------------
    def add_instance(self, agent, load_fn=None, tier: Optional[str] = None,
                     engine=None) -> None:
        self.instances[agent.name] = agent
        self._loads[agent.name] = load_fn or getattr(agent, "load", None)
        if tier is not None:
            self._tiers[agent.name] = tier
        if engine is not None:
            self._engines[agent.name] = engine   # live role/depth source
        self.routed.setdefault(agent.name, 0)
        # messages held while the fleet was empty (remove-last-then-add)
        # get their first chance at the new instance here
        self._pump()

    def remove_instance(self, name: str) -> None:
        self.instances.pop(name, None)
        self._loads.pop(name, None)
        self._tiers.pop(name, None)
        self._engines.pop(name, None)
        # stale fallback pins would re-route sessions to the dead name
        self._session_pin = {s: i for s, i in self._session_pin.items()
                             if i != name}
        # held/blocked messages re-evaluate against the surviving set
        # (their block rule may have been removed without a new deliver)
        if self.instances:
            self._pump()
        else:
            self._gauge_held()

    # -- set/reset shim: derived from ControlSurface -------------------------
    def card_metrics(self) -> tuple:
        return tuple(f"routed.{n}" for n in self.instances)

    # -- routing ------------------------------------------------------------------
    def _load_of(self, name: str) -> float:
        fn = self._loads.get(name)
        return fn() if callable(fn) else 0.0

    def _cache_pick(self, names: list[str], msg: Optional[Message]):
        """Best estimated prefix hit, ties broken by load; None when the
        directory has no signal (caller falls back to load)."""
        if self.cache_dir is None or self.prefix_fn is None or msg is None:
            return None
        source = self.prefix_fn(msg)
        if source is None:
            return None
        scores = {n: self.cache_dir.estimate_hit(source, n) for n in names}
        best = max(scores.values())
        if best <= 0:
            return None
        top = [n for n in names if scores[n] == best]
        self.cache_routed += 1
        return min(top, key=self._load_of)

    def _role_of(self, name: str) -> str:
        eng = self._engines.get(name)
        if eng is None:
            return "unified"
        try:
            return eng.get_param("role")
        except (KeyError, AttributeError):
            return "unified"

    def _prefill_depth(self, name: str) -> float:
        eng = self._engines.get(name)
        if eng is None:
            return self._load_of(name)
        return float(eng.scheduler.prefill_queue_tokens)

    def _disagg_pick(self, names: list[str], msg: Optional[Message]):
        """Shallowest prefill queue among prefill-capable engines; when
        the pick is a dedicated prefill engine, pre-pin its decode pair
        (lowest decode slot utilization) so the handoff can start
        streaming before the first token.  None when no engine can
        prefill (caller falls back to plain least-loaded)."""
        pre = [n for n in names if self._role_of(n) != "decode"]
        if not pre:
            return None
        src = min(pre, key=lambda n: (self._prefill_depth(n),
                                      self._load_of(n)))
        if self._role_of(src) == "prefill":
            dst = pick_decode_engine(
                {n: self._engines[n] for n in names if n in self._engines},
                exclude=src)
            if dst is not None and msg is not None and msg.task_id:
                self._pairs[msg.task_id] = (src, dst)
                # pins are consumed by pair_for right after deliver;
                # bound the table so a caller that never consumes them
                # (e.g. this policy on a plain router) cannot leak
                while len(self._pairs) > 512:
                    self._pairs.pop(next(iter(self._pairs)))
        self.disagg_routed += 1
        return src

    def pair_for(self, task_id: str):
        """Consume the (prefill, decode) pre-pin made for a task by the
        ``disagg`` policy; None when the pick decodes in place."""
        return self._pairs.pop(task_id, None)

    def _tier_pick(self, names: list[str], msg: Optional[Message]):
        """Least-loaded instance of the tier the message asks for; None
        when the message carries no tier or no instance matches (caller
        falls back to plain least-loaded)."""
        want = (msg.payload or {}).get("tier") if msg is not None else None
        if want is None:
            return None
        match = [n for n in names if self._tiers.get(n) == want]
        if not match:
            return None
        self.tier_routed += 1
        return min(match, key=self._load_of)

    def _fallback(self, session: str, msg: Optional[Message] = None) -> str:
        names = sorted(self.instances)
        if not names:
            raise RuntimeError(f"{self.name}: no instances")
        if self.policy == "disagg":
            pick = self._disagg_pick(names, msg)
            if pick is not None:
                return pick
            return min(names, key=self._load_of)
        if self.policy == "stage_aware":
            pick = self._tier_pick(names, msg)
            if pick is not None:
                return pick
            return min(names, key=self._load_of)
        if self.policy == "cache_aware":
            pick = self._cache_pick(names, msg)
            if pick is not None:
                return pick
            return min(names, key=self._load_of)
        if self.policy == "least_loaded":
            return min(names, key=self._load_of)
        if session not in self._session_pin:
            h = zlib.crc32(session.encode())        # deterministic hash
            self._session_pin[session] = names[h % len(names)]
        return self._session_pin[session]

    def pick(self, msg: Message) -> str:
        ruled = self.rules.route_for(msg)
        if ruled is not None and ruled in self.instances:
            return ruled
        session = (msg.payload or {}).get("session") or msg.task_id or ""
        return self._fallback(session, msg)

    # -- tenancy meter (ahead of the rule/policy pick) -----------------------
    def _tenant_admit(self, msg: Message) -> bool:
        """Meter the message through its tenant's token bucket.  False =
        held: the message sits in ``_throttled`` until the bucket
        refills (timer) or a tenant knob moves (directory release
        hook).  Held messages are never dropped."""
        cost = max(msg.tokens, 1)
        now = self.loop.now()
        was_held = msg.msg_id in self._throttle_seen
        # a tenant's older held messages drain first: a fresh arrival
        # may not steal the refill out from under a large held message
        # (which would starve it behind a stream of small ones)
        jumps_queue = (not was_held
                       and self._held_tenants.get(msg.tenant, 0) > 0)
        if not jumps_queue and self.tenants.try_take(msg.tenant, cost, now):
            if was_held:
                self._throttle_seen.discard(msg.msg_id)
                self._held_tenants[msg.tenant] -= 1
                self._trace_hold(msg, now)
            self._metered.add(msg.msg_id)
            self.tenants.note_admitted(msg.tenant, cost, now)
            return True
        if not was_held:
            # count each message once, not once per re-check
            self._throttle_seen.add(msg.msg_id)
            self._held_tenants[msg.tenant] = (
                self._held_tenants.get(msg.tenant, 0) + 1)
            self.tenants.note_throttled(msg.tenant, now)
            if self.tracer is not None:
                self._hold_t0[msg.msg_id] = now
        self._throttled.append(msg)
        self._gauge_throttled()
        wait = self.tenants.time_until(msg.tenant, cost, now)
        if wait != float("inf"):
            # paused / zero-rate tenants have no refill horizon; their
            # release rides the directory's knob-change hook instead.
            # ONE pending pump per router: a flood of held messages must
            # not schedule a timer (and a full re-scan) per message
            at = now + max(wait, 1e-3)
            if at < self._pump_at - 1e-12:
                self._pump_at = at
                self.loop.call_after(at - now, self._timed_pump)
        return False

    def _timed_pump(self) -> None:
        self._pump_at = float("inf")
        self._pump_throttled()

    def _trace_hold(self, msg: Message, now: float) -> None:
        """A held message just cleared the meter: record its
        throttle-hold as a standalone segment span.  The span has no
        parent yet — when the request reaches an engine and gets a root
        span, ``trace_pre`` re-parents it under that root (spans are
        mutable); the hold window tiles the gap between pool arrival
        and engine submission."""
        t0 = self._hold_t0.pop(msg.msg_id, None)
        if self.tracer is None or t0 is None:
            return
        tid = msg.task_id or msg.msg_id
        if not self.tracer.decide(tid, tenant=msg.tenant):
            return
        sp = self.tracer.record("throttle_hold", tid, t0, now,
                                cat="segment", router=self.name,
                                tenant=msg.tenant)
        req = (msg.payload or {}).get("request")
        if req is not None:
            req.meta.setdefault("trace_pre", []).append(sp)

    def exempt(self, msg_id: str) -> None:
        """Mark a message as already metered, so delivering it bypasses
        the tenant bucket — for traffic the fabric re-routes internally
        (role-flip bounces), which was charged on first admission."""
        self._metered.add(msg_id)

    def _pump_throttled(self) -> None:
        throttled, self._throttled = self._throttled, []
        blocked: set[str] = set()
        for msg in throttled:
            if msg.tenant in blocked:
                # this tenant's bucket already refused a message this
                # round: keep FIFO order, skip the redundant re-meter
                self._throttled.append(msg)
                continue
            before = len(self._throttled)
            self.deliver(msg)
            if len(self._throttled) > before:
                blocked.add(msg.tenant)
        self._gauge_throttled()

    @property
    def throttled_count(self) -> int:
        return len(self._throttled)

    def _gauge_throttled(self) -> None:
        if self.collector is not None:
            self.collector.gauge(f"{self.name}.throttled_count",
                                 len(self._throttled), self.loop.now())

    def deliver(self, msg: Message) -> None:
        if self._rules_seen != self.rules.version:
            self._rules_seen = self.rules.version
            self._pump()
        if (self.tenants is not None and msg.msg_id not in self._metered
                and not self._tenant_admit(msg)):
            return
        if self.rules.blocked(msg) or not self.instances:
            # blocked by rule, or the fleet is momentarily empty
            # (remove-last-then-add): hold until something can take it
            # (already metered — a later re-check must not charge again)
            self._held.append(msg)
            self._gauge_held()
            return
        self._metered.discard(msg.msg_id)
        inst = self.pick(msg)
        self.routed[inst] += 1
        if self.collector is not None:
            self.collector.counter(f"{self.name}.routed.{inst}", 1,
                                   self.loop.now())
        self.instances[inst].deliver(msg)
        if self.on_dispatch is not None:
            # post-deliver so callers observe the same synchronous order
            # as a direct deliver (engine submitted, then the hook)
            self.on_dispatch(msg, inst)

    def _pump(self) -> None:
        held, self._held = self._held, []
        self._gauge_held()
        for msg in held:
            self.deliver(msg)

    @property
    def held_count(self) -> int:
        return len(self._held)

    def _gauge_held(self) -> None:
        if self.collector is not None:
            self.collector.gauge(f"{self.name}.held_count",
                                 len(self._held), self.loop.now())
