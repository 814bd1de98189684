"""Multi-tenant SLO plane — tenancy as a first-class, intent-controllable
serving object.

The paper's thesis is that serving attributes should be *programmed*
from runtime state.  Up to now the most load-bearing attribute of all —
who gets served next — was a single static sort; this module makes the
tenant the unit of control:

* ``TenantSpec`` — declarative description of one tenant: fair-share
  ``weight`` (consumed by the scheduler's ``weighted_fair`` queue
  discipline), token-bucket ``rate``/``burst`` (enforced by the router's
  admission meter), and SLO targets (``slo_class``, ``p95_ttft_target``).
* ``TenantEntry`` — the per-tenant ControlSurface, registered as
  ``tenant.<name>`` (the stage-plane idiom): ``weight`` / ``rate`` /
  ``burst`` / ``paused`` are ordinary Table-1 knobs, so policies and
  intent programs (``set tenant batch.weight 0.2``) reshape fairness at
  runtime through the same audited surface as every other attribute.
  The entry also owns the tenant's token bucket.
* ``TenantDirectory`` — the shared lookup the data plane consults
  (schedulers read weights, routers meter buckets) plus the metric
  rollup point: it publishes ``tenant.<t>.ttft`` observations and the
  derived ``tenant.<t>.p95_ttft`` / ``.share`` / ``.throttle_rate``
  gauges (via ``FleetAggregate.watch_window`` when a MetricBus is
  attached, so intent triggers like ``on tenant gold.p95_ttft > 1.5``
  ride the ordinary push tier).

Unknown tenants are auto-registered with neutral defaults (weight 1,
unmetered), so pre-tenancy call sites — everything stamps the implicit
``"default"`` tenant — run unchanged.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.core.knobs import ControlSurface, KnobSpec
from repro_torch.core.metrics import FleetAggregate, RollingStat
from repro_torch.core.types import SLOClass


@dataclass
class TenantSpec:
    """Declarative tenant description (constructor input; the live,
    knob-controllable state lives on the registered ``TenantEntry``)."""

    tenant: str
    weight: float = 1.0                  # weighted-fair share weight
    rate: float = math.inf               # token-bucket refill (tokens/s)
    burst: float = 8192.0                # token-bucket capacity (tokens)
    slo_class: str = SLOClass.STANDARD.value
    p95_ttft_target: float = math.inf    # seconds; inf = no target


class TenantEntry(ControlSurface):
    """One tenant's live control state: a registered ``tenant.<name>``
    controllable whose knobs feed the scheduler's fairness accounting
    (``weight``) and the router's admission meter (``rate`` / ``burst``
    / ``paused``)."""

    kind = "tenant"
    CAPABILITIES = ("fairness", "throttle")
    METRICS = ("ttft", "p95_ttft", "share", "throttle_rate",
               "admitted_tokens", "throttled")
    KNOB_SPECS = (
        KnobSpec("weight", kind="float", lo=1e-3,
                 doc="weighted-fair share weight"),
        KnobSpec("rate", kind="float", lo=0.0,
                 doc="token-bucket refill in tokens/s; inf = unmetered"),
        KnobSpec("burst", kind="float", lo=1.0,
                 doc="token-bucket capacity in tokens"),
        KnobSpec("paused", kind="bool",
                 doc="hold this tenant's traffic at the router"),
    )

    def __init__(self, spec: TenantSpec, directory: "TenantDirectory"):
        self.tenant = spec.tenant
        self.name = f"{directory.prefix}.{spec.tenant}"
        self.weight = spec.weight
        self.rate = spec.rate
        self.burst = spec.burst
        self.paused = False
        self.slo_class = spec.slo_class
        self.p95_ttft_target = spec.p95_ttft_target
        self._dir = directory
        # token bucket (refilled lazily on access)
        self._level = spec.burst if math.isfinite(spec.rate) else 0.0
        self._refill_t = 0.0
        self.admitted_tokens = 0.0       # metered through the bucket
        self.throttled_count = 0         # admission holds
        self.served_tokens = 0.0         # actual prefill+decode work

    # -- bucket -----------------------------------------------------------
    def _refill(self, now: float) -> None:
        if now > self._refill_t:
            self._level = min(self.burst,
                              self._level + (now - self._refill_t) * self.rate)
            self._refill_t = now

    def try_take(self, tokens: float, now: float) -> bool:
        """Meter ``tokens`` through the bucket; False = hold the message
        (paused tenant, or the bucket has not refilled enough yet).  A
        message costing more than ``burst`` passes once the bucket is
        FULL, driving the level negative — debt paid forward — so
        held-never-dropped admission cannot deadlock on oversized
        messages while the long-run rate stays enforced."""
        if self.paused:
            return False
        if math.isinf(self.rate):
            return True
        self._refill(now)
        if (self._level + 1e-9 >= tokens
                or self._level + 1e-9 >= self.burst):
            self._level -= tokens
            return True
        return False

    def time_until(self, tokens: float, now: float) -> float:
        """Seconds until ``try_take(tokens)`` could succeed (inf while
        paused or with a zero refill rate)."""
        if self.paused:
            return math.inf
        if math.isinf(self.rate):
            return 0.0
        self._refill(now)
        deficit = min(tokens, self.burst) - self._level
        if deficit <= 0:
            return 0.0
        if self.rate <= 0:
            return math.inf
        return deficit / self.rate

    # -- knob side effects -------------------------------------------------
    def on_knob_set(self, name: str, old, new) -> None:
        # a rate/burst bump or an unpause can unblock held traffic NOW;
        # routers subscribe to the directory's release hook
        if name in ("rate", "burst", "paused") and old != new:
            self._dir.notify_release()


class TenantDirectory:
    """Shared tenant lookup + metric rollup point (see module doc).

    One directory serves a whole fleet: schedulers read ``weight()``,
    routers meter ``try_take()``/``time_until()``, engines report
    ``observe_ttft()``, and the scheduler's fairness accounting reports
    ``note_served()``.  Everything is keyed by plain tenant name;
    unknown tenants auto-register with neutral defaults.
    """

    def __init__(self, collector=None, registry=None, prefix: str = "tenant",
                 share_window: float = 5.0, ttft_window: float = 10.0,
                 share_pub_interval: float = 0.25):
        self.collector = collector
        self.registry = registry
        self.prefix = prefix
        self.share_window = share_window
        self.ttft_window = ttft_window
        self.share_pub_interval = share_pub_interval
        self.entries: dict[str, TenantEntry] = {}
        self._release_fns: list[Callable[[], None]] = []
        self._served: dict[str, deque] = {}      # tenant -> (t, tokens)
        self._served_sum: dict[str, float] = {}  # windowed running totals
        self._last_share_pub = -math.inf
        self._gate: dict[str, deque] = {}        # tenant -> (t, throttled?)
        self._ttft: dict[str, RollingStat] = {}
        # derived-rollup tier: with a MetricBus attached, p95_ttft is a
        # FleetAggregate window aggregation over the raw ttft series —
        # the same push tier every other fleet gauge uses
        self.fleet: Optional[FleetAggregate] = None
        if collector is not None and collector.bus is not None:
            self.fleet = FleetAggregate(collector, prefix=prefix)

    # -- registration ------------------------------------------------------
    def add(self, spec_or_name, **kw) -> TenantEntry:
        """Register a tenant from a TenantSpec (or name + spec kwargs)."""
        spec = (spec_or_name if isinstance(spec_or_name, TenantSpec)
                else TenantSpec(spec_or_name, **kw))
        if spec.tenant in self.entries:
            raise ValueError(f"duplicate tenant: {spec.tenant}")
        entry = TenantEntry(spec, self)
        self.entries[spec.tenant] = entry
        if self.registry is not None:
            self.registry.register(entry)
        if self.fleet is not None:
            self.fleet.watch_window(f"{spec.tenant}.p95_ttft",
                                    f"{self.prefix}.{spec.tenant}.ttft",
                                    how="p95", window=self.ttft_window)
        return entry

    def ensure(self, tenant: str) -> TenantEntry:
        entry = self.entries.get(tenant)
        if entry is None:
            entry = self.add(TenantSpec(tenant))
        return entry

    def get(self, tenant: str) -> TenantEntry:
        return self.entries[tenant]

    def names(self) -> list[str]:
        return list(self.entries)

    # -- data-plane reads --------------------------------------------------
    def weight(self, tenant: str) -> float:
        return self.ensure(tenant).weight

    def paused(self, tenant: str) -> bool:
        return self.ensure(tenant).paused

    def try_take(self, tenant: str, tokens: float, now: float) -> bool:
        return self.ensure(tenant).try_take(tokens, now)

    def time_until(self, tenant: str, tokens: float, now: float) -> float:
        return self.ensure(tenant).time_until(tokens, now)

    # -- release hooks (routers pump held traffic on refill/unpause) -------
    def subscribe_release(self, fn: Callable[[], None]) -> None:
        self._release_fns.append(fn)

    def notify_release(self) -> None:
        for fn in list(self._release_fns):
            fn()

    # -- metric rollups ----------------------------------------------------
    def _gauge(self, tenant: str, metric: str, value: float,
               t: float) -> None:
        if self.collector is not None:
            self.collector.gauge(f"{self.prefix}.{tenant}.{metric}",
                                 value, t)

    def note_admitted(self, tenant: str, tokens: float, t: float) -> None:
        """Router admission: the message cleared the tenant's bucket."""
        entry = self.ensure(tenant)
        entry.admitted_tokens += tokens
        if self.collector is not None:
            self.collector.counter(
                f"{self.prefix}.{tenant}.admitted_tokens", tokens, t)
        self._note_gate(tenant, throttled=False, t=t)

    def note_throttled(self, tenant: str, t: float) -> None:
        """Router admission: the message was held by the meter."""
        entry = self.ensure(tenant)
        entry.throttled_count += 1
        if self.collector is not None:
            self.collector.counter(
                f"{self.prefix}.{tenant}.throttled", 1, t)
        self._note_gate(tenant, throttled=True, t=t)

    def _note_gate(self, tenant: str, throttled: bool, t: float) -> None:
        q = self._gate.setdefault(tenant, deque())
        q.append((t, throttled))
        lo = t - self.share_window
        while q and q[0][0] < lo:
            q.popleft()
        if q:
            rate = sum(1 for _, th in q if th) / len(q)
            self._gauge(tenant, "throttle_rate", rate, t)

    def note_served(self, tenant: str, tokens: float, t: float) -> None:
        """Scheduler fairness accounting: actual prefill+decode tokens
        processed for this tenant.  Maintains O(1)-amortized windowed
        running sums (this is called once per decode token on the hot
        path) and publishes every tenant's ``share`` gauge — fraction of
        fleet tokens served — at most every ``share_pub_interval``."""
        self.ensure(tenant).served_tokens += tokens
        q = self._served.setdefault(tenant, deque())
        q.append((t, tokens))
        lo = t - self.share_window
        s = self._served_sum.get(tenant, 0.0) + tokens
        while q and q[0][0] < lo:
            s -= q.popleft()[1]
        self._served_sum[tenant] = s
        if (self.collector is None
                or t - self._last_share_pub < self.share_pub_interval):
            return
        # full cross-tenant sweep only at publish time: idle tenants'
        # stale window entries expire here, not on the per-token path
        self._last_share_pub = t
        for name, dq in self._served.items():
            sn = self._served_sum[name]
            while dq and dq[0][0] < lo:
                sn -= dq.popleft()[1]
            self._served_sum[name] = sn
        fleet_total = sum(self._served_sum.values())
        if fleet_total > 0:
            for name, tot in self._served_sum.items():
                self._gauge(name, "share", tot / fleet_total, t)

    def observe_ttft(self, tenant: str, ttft: float, t: float) -> None:
        """Engine first-token callback: raw per-tenant TTFT sample.
        With a MetricBus the derived ``p95_ttft`` gauge re-publishes via
        ``FleetAggregate.watch_window``; without one, from a bounded
        rolling window here (same series name either way)."""
        self.ensure(tenant)
        if self.collector is not None:
            self.collector.observe(f"{self.prefix}.{tenant}.ttft", ttft, t)
        if self.fleet is None:
            stat = self._ttft.get(tenant)
            if stat is None:
                stat = self._ttft[tenant] = RollingStat()
            stat.add(ttft)
            self._gauge(tenant, "p95_ttft", stat.pctl(0.95), t)
