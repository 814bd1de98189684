"""Metrics plane (paper §3.2).

Two-tier design, exactly as proposed:

* ``Collector`` — the *local metric collector* at each node.  Writes go
  into fixed-size ring buffers (the paper's "lightweight shared-memory
  structures"): O(1) per observation, no allocation on the hot path, and
  bounded memory regardless of traffic.
* ``CentralPoller`` — the control plane's *centralized polling* façade:
  it fetches windows from every registered collector **on demand** (no
  constant streaming) and materializes aggregates into the controller's
  ``StateStore``.
* ``AGGREGATIONS`` — the *flexible aggregation functions*; callers can
  register custom ones (``register_aggregation``) without touching the
  plane, as §3.2 requires for mixed-volume metrics (per-token TPT vs
  per-query TTFT).
* ``MetricSpec`` — the *metric specification language* giving the
  controller semantic understanding (direction, kind, unit).  Specs come
  from structured dicts (the paper's JSON/YAML path) or from
  ``MetricSpec.from_docstring`` — a deterministic parser over the
  natural-language docstring grammar (the paper suggests an LLM here; we
  keep the interface and make the transform rule-based so the container
  needs no model).
"""
from __future__ import annotations

import fnmatch
import math
import re
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional


# ---------------------------------------------------------------------------
# Metric bus (event tier)
# ---------------------------------------------------------------------------


@dataclass
class ThresholdSub:
    """One threshold subscription: fire ``fn(name, value, t)`` when a
    published sample enters the subscribed region.

    Edge-triggered by default: the subscription re-arms only after a
    sample *leaves* the region, so a sustained breach fires once, not on
    every sample.  ``cooldown`` additionally rate-limits fires.
    """

    sub_id: int
    metric: str                          # exact name or glob
    fn: Callable[[str, float, float], None]
    above: Optional[float] = None
    below: Optional[float] = None
    predicate: Optional[Callable[[float], bool]] = None
    cooldown: float = 0.0
    edge: bool = True
    fires: int = 0
    # per concrete metric name: a glob subscription must track each
    # matched series independently, or one instance's breach would
    # suppress / mask another's
    _in_region: dict = field(default_factory=dict)
    _last_fire: dict = field(default_factory=dict)

    def _hit(self, value: float) -> bool:
        if self.predicate is not None:
            return bool(self.predicate(value))
        if self.above is not None and value > self.above:
            return True
        if self.below is not None and value < self.below:
            return True
        return False

    def check(self, name: str, value: float, t: float) -> bool:
        hit = self._hit(value)
        was = self._in_region.get(name, False)
        if not hit:
            self._in_region[name] = False
            return False
        if self.edge and was:
            return False
        if t - self._last_fire.get(name, -math.inf) < self.cooldown:
            return False               # suppressed: stay ARMED, so the
                                       # breach fires once cooldown expires
        self._in_region[name] = True   # entry recorded only on a real fire
        self._last_fire[name] = t
        self.fires += 1
        self.fn(name, value, t)
        return True


class MetricBus:
    """Push tier of the metrics plane: components publish deltas as they
    write, and threshold subscriptions fire *between* controller polls.

    The interval poll path scans every ring of every collector each
    tick; the bus inverts that — O(subscriptions-on-this-metric) per
    observation, nothing at all for unwatched metrics — which is the
    shape that scales to large fleets.  The controller runs both paths
    (hybrid): polls for policy state, bus events for fast reaction.
    """

    def __init__(self):
        self._exact: dict[str, list[ThresholdSub]] = {}
        self._globs: list[ThresholdSub] = []
        self._next_id = 0
        self.published = 0
        self.delivered = 0

    def subscribe(self, metric: str, fn: Callable[[str, float, float], None],
                  above: Optional[float] = None,
                  below: Optional[float] = None,
                  predicate: Optional[Callable[[float], bool]] = None,
                  cooldown: float = 0.0, edge: bool = True) -> ThresholdSub:
        if above is None and below is None and predicate is None:
            raise ValueError("subscribe needs above=, below= or predicate=")
        sub = ThresholdSub(self._next_id, metric, fn, above, below,
                           predicate, cooldown, edge)
        self._next_id += 1
        if any(c in metric for c in "*?["):
            self._globs.append(sub)
        else:
            self._exact.setdefault(metric, []).append(sub)
        return sub

    def unsubscribe(self, sub: ThresholdSub) -> None:
        if sub in self._globs:
            self._globs.remove(sub)
        subs = self._exact.get(sub.metric)
        if subs and sub in subs:
            subs.remove(sub)

    def publish(self, name: str, value: float, t: float) -> None:
        self.published += 1
        for sub in self._exact.get(name, ()):
            if sub.check(name, value, t):
                self.delivered += 1
        for sub in self._globs:
            if fnmatch.fnmatch(name, sub.metric) and sub.check(name, value, t):
                self.delivered += 1

    def subscriptions(self) -> list[ThresholdSub]:
        return [s for subs in self._exact.values() for s in subs] + \
            list(self._globs)

# ---------------------------------------------------------------------------
# Ring buffer
# ---------------------------------------------------------------------------


class Ring:
    """Fixed-capacity (value, time) ring; O(1) append, windowed reads."""

    __slots__ = ("cap", "vals", "times", "idx", "count")

    def __init__(self, cap: int = 256):
        self.cap = cap
        self.vals = [0.0] * cap
        self.times = [0.0] * cap
        self.idx = 0
        self.count = 0

    def push(self, value: float, t: float) -> None:
        self.vals[self.idx] = value
        self.times[self.idx] = t
        self.idx = (self.idx + 1) % self.cap
        self.count += 1

    def window(self, since: float = -math.inf) -> list[tuple[float, float]]:
        """(time, value) pairs newer than ``since``, oldest first."""
        n = min(self.count, self.cap)
        start = (self.idx - n) % self.cap
        out = []
        for i in range(n):
            j = (start + i) % self.cap
            if self.times[j] >= since:
                out.append((self.times[j], self.vals[j]))
        return out

    def last(self) -> Optional[float]:
        if self.count == 0:
            return None
        return self.vals[(self.idx - 1) % self.cap]


# ---------------------------------------------------------------------------
# Aggregation functions (flexible, user-extensible)
# ---------------------------------------------------------------------------


def _percentile(xs: list[float], q: float) -> float:
    if not xs:
        return math.nan
    s = sorted(xs)
    k = (len(s) - 1) * q
    lo, hi = int(math.floor(k)), int(math.ceil(k))
    if lo == hi:
        return s[lo]
    return s[lo] + (s[hi] - s[lo]) * (k - lo)


AGGREGATIONS: dict[str, Callable[[list[float]], float]] = {
    "mean": lambda xs: sum(xs) / len(xs) if xs else math.nan,
    "max": lambda xs: max(xs) if xs else math.nan,
    "min": lambda xs: min(xs) if xs else math.nan,
    "sum": lambda xs: sum(xs),
    "count": lambda xs: float(len(xs)),
    "last": lambda xs: xs[-1] if xs else math.nan,
    "p50": lambda xs: _percentile(xs, 0.50),
    "p90": lambda xs: _percentile(xs, 0.90),
    "p95": lambda xs: _percentile(xs, 0.95),
    "p99": lambda xs: _percentile(xs, 0.99),
}


def register_aggregation(name: str,
                         fn: Callable[[list[float]], float]) -> None:
    """§3.2 'custom aggregation functions' hook."""
    AGGREGATIONS[name] = fn


class RollingStat:
    """Bounded rolling sample window for components that export a
    *derived* gauge — e.g. a workflow stage publishing its own p95 call
    latency as ``stage.<name>.p95`` so MetricBus threshold triggers
    (``on stage reviewer.p95 > 2``) can subscribe to a plain series
    instead of re-aggregating rings on every push."""

    def __init__(self, cap: int = 128):
        self.cap = cap
        self._xs: list[float] = []
        self._idx = 0

    def add(self, x: float) -> None:
        if len(self._xs) < self.cap:
            self._xs.append(x)
        else:
            self._xs[self._idx] = x
        self._idx = (self._idx + 1) % self.cap

    def pctl(self, q: float) -> float:
        return _percentile(self._xs, q)

    def mean(self) -> float:
        return sum(self._xs) / len(self._xs) if self._xs else math.nan

    def __len__(self) -> int:
        return len(self._xs)


class FleetAggregate:
    """Fleet-level derived gauges (§3.2's flexible aggregation, pushed
    down to the collector tier).  ``watch`` re-publishes an aggregate of
    per-member series as a ``<prefix>.<name>`` gauge on every member
    write, so MetricBus threshold rules and intent programs (``on
    cluster.prefill_pressure > 2 => set engine e2.role prefill``)
    subscribe to one plain series instead of re-aggregating windows —
    the disaggregation plane's RoleBalancerPolicy reads exactly these.
    """

    def __init__(self, collector: "Collector", prefix: str = "cluster"):
        if collector.bus is None:
            raise ValueError("FleetAggregate needs a Collector with a "
                             "MetricBus attached")
        self.collector = collector
        self.prefix = prefix
        self.watches: list[str] = []

    def watch(self, name: str, members: list[str], how: str = "sum",
              scale: float = 1.0) -> None:
        """Publish ``AGGREGATIONS[how]`` over the members' freshest
        values (times ``scale``) whenever any member is written."""
        agg = AGGREGATIONS[how]
        out = f"{self.prefix}.{name}"

        def _update(_name: str, _value: float, t: float) -> None:
            xs = [v for v in (self.collector.last(m) for m in members)
                  if v is not None]
            if xs:
                self.collector.gauge(out, agg(xs) * scale, t)

        for m in members:
            self.collector.bus.subscribe(m, predicate=lambda v: True,
                                         edge=False, fn=_update)
        self.watches.append(out)

    def watch_window(self, name: str, member: str, how: str = "p95",
                     window: float = math.inf, scale: float = 1.0) -> None:
        """Like ``watch``, but over ONE member's recent ring *window*
        rather than many members' freshest values — for rollups that
        need the sample distribution, not a fleet snapshot.  The
        tenancy plane derives ``tenant.<t>.p95_ttft`` from the raw
        ``tenant.<t>.ttft`` observations this way, so intent triggers
        (``on tenant gold.p95_ttft > 1.5``) ride the ordinary push
        tier."""
        agg = AGGREGATIONS[how]
        out = f"{self.prefix}.{name}"

        def _update(_name: str, _value: float, t: float) -> None:
            xs = [v for (_, v) in self.collector.read(member, t - window)]
            if xs:
                self.collector.gauge(out, agg(xs) * scale, t)

        self.collector.bus.subscribe(member, predicate=lambda v: True,
                                     edge=False, fn=_update)
        self.watches.append(out)


def ewma(alpha: float = 0.3) -> Callable[[list[float]], float]:
    def _fn(xs: list[float]) -> float:
        acc = math.nan
        for x in xs:
            acc = x if math.isnan(acc) else alpha * x + (1 - alpha) * acc
        return acc
    return _fn


register_aggregation("ewma", ewma())


# ---------------------------------------------------------------------------
# Metric specification (semantic understanding)
# ---------------------------------------------------------------------------

_KIND_WORDS = {
    "latency": ("latency", "time", "delay", "seconds", "duration"),
    "counter": ("count", "total", "number of", "cumulative"),
    "utilization": ("utilization", "fraction", "occupancy", "pressure"),
    "rate": ("per second", "rate", "throughput"),
    "gauge": ("length", "depth", "size", "current"),
}

_LOWER_BETTER = ("lower is better", "minimize", "smaller is better",
                 "lower the better", "should be low")
_HIGHER_BETTER = ("higher is better", "maximize", "larger is better",
                  "higher the better", "should be high")

_UNIT_RE = re.compile(r"\bin\s+(seconds|ms|milliseconds|tokens|bytes|"
                      r"pages|requests|fraction|percent)\b")


@dataclass(frozen=True)
class MetricSpec:
    """Semantic descriptor the controller uses to interpret a metric.

    direction: 'lower_better' | 'higher_better' | 'neutral' — e.g. when
    the objective is throughput, high ``page_util`` is good but a high
    ``queue_len`` is not; the spec is what encodes that (§3.2 goal 4).
    """

    name: str
    kind: str = "gauge"            # gauge|counter|latency|rate|utilization
    unit: str = ""
    direction: str = "neutral"
    description: str = ""
    default_agg: str = "mean"

    @classmethod
    def from_dict(cls, d: dict) -> "MetricSpec":
        """Structured (JSON/YAML-shaped) spec file path."""
        return cls(name=d["name"], kind=d.get("kind", "gauge"),
                   unit=d.get("unit", ""),
                   direction=d.get("direction", "neutral"),
                   description=d.get("description", ""),
                   default_agg=d.get("default_agg", "mean"))

    @classmethod
    def from_docstring(cls, name: str, doc: str) -> "MetricSpec":
        """Deterministic NL → spec transform (rule-based stand-in for the
        paper's LLM-assisted path; same interface)."""
        low = doc.lower()
        kind = "gauge"
        for k, words in _KIND_WORDS.items():
            if any(w in low for w in words):
                kind = k
                break
        direction = "neutral"
        if any(w in low for w in _LOWER_BETTER):
            direction = "lower_better"
        elif any(w in low for w in _HIGHER_BETTER):
            direction = "higher_better"
        elif kind == "latency":
            direction = "lower_better"
        m = _UNIT_RE.search(low)
        unit = m.group(1) if m else ("seconds" if kind == "latency" else "")
        default_agg = "p95" if kind == "latency" else (
            "sum" if kind == "counter" else "mean")
        return cls(name=name, kind=kind, unit=unit, direction=direction,
                   description=doc.strip(), default_agg=default_agg)


# Built-in specs for everything the engines/channels/agents export.
BUILTIN_SPECS: dict[str, MetricSpec] = {}


def _builtin(name: str, doc: str) -> None:
    BUILTIN_SPECS[name] = MetricSpec.from_docstring(name, doc)


_builtin("queue_len", "Current length of the admission queue; lower is better under latency goals.")
_builtin("num_running", "Current number of running sequences.")
_builtin("page_util", "KV page pool utilization as a fraction; higher is better for throughput, but 1.0 means preemption pressure.")
_builtin("step_time", "Engine step time in seconds; lower is better.")
_builtin("mean_step_time", "EWMA of measured engine step time in seconds, published every step; lower is better. The hardware-honesty signal intents trigger on when measured step time drifts from the CostModel's prediction.")
_builtin("ttft", "Time to first token in seconds; lower is better.")
_builtin("latency", "End-to-end request latency in seconds; lower is better.")
_builtin("tpt", "Time per output token in seconds; lower is better.")
_builtin("itl_p95", "Windowed p95 inter-token latency in seconds, published every step; lower is better. The decode-stall signal: a long serialized prefill spikes it, which is what adaptive chunked-prefill intents and ChunkPolicy trigger on.")
_builtin("throughput", "Completed requests per second; higher is better.")
_builtin("tokens_total", "Cumulative number of generated tokens.")
_builtin("task_latency", "End-to-end pipeline task latency in seconds; lower is better.")
_builtin("msgs_sent", "Cumulative number of messages sent on a channel.")
_builtin("bytes_sent", "Cumulative number of bytes sent on a channel.")
_builtin("link_delay", "Current queueing delay of the link in seconds; lower is better.")
_builtin("transfer_bytes", "Cumulative bytes of KV-cache state moved between instances.")
_builtin("hit_rate", "Prefix-cache token hit fraction; higher is better.")
_builtin("prefill_queue_tokens", "Current number of prompt tokens backed up behind prefill; lower is better under latency goals.")
_builtin("decode_slot_util", "Decoding-slot occupancy as a fraction; higher is better for throughput.")
_builtin("prefill_pressure", "Fleet prefill backlog relative to the per-step prefill budget; lower is better.")
_builtin("held_count", "Current number of messages held in the router (blocked or fleet-empty); lower is better.")
_builtin("handoffs", "Cumulative number of prefill-to-decode KV handoffs.")
_builtin("handoff_bytes", "Cumulative bytes of KV state moved by prefill-to-decode handoffs.")
_builtin("saved_prefill_tokens", "Cumulative number of prompt tokens served from the prefix cache instead of re-prefilled.")
_builtin("shared_pages", "Current number of KV pages held in shared (refcounted) prefix blocks.")
_builtin("p95_ttft", "Windowed p95 time to first token in seconds; lower is better.")
_builtin("share", "Windowed fraction of fleet tokens served to a tenant.")
_builtin("throttle_rate", "Windowed fraction of a tenant's messages held by the admission meter; lower is better.")
_builtin("admitted_tokens", "Cumulative number of tokens metered through a tenant's admission bucket.")
_builtin("throttled", "Cumulative number of a tenant's messages held by the admission meter.")
_builtin("queue_wait", "Queue-wait segment of a request in seconds; lower is better.")
_builtin("throttle_hold", "Tenant-throttle-hold segment of a request in seconds; lower is better.")
_builtin("handoff_wait", "KV-handoff-wait segment of a request in seconds; lower is better.")
_builtin("prefill", "Prefill segment of a request in seconds; lower is better.")
_builtin("decode", "Decode segment of a request in seconds; lower is better.")
_builtin("actions_retained", "Current number of control-plane actions retained in the audit ring.")
_builtin("spans_total", "Cumulative number of trace spans recorded.")
_builtin("spans_dropped", "Cumulative number of trace spans evicted from the bounded store.")


# ---------------------------------------------------------------------------
# Local collector (tier 1)
# ---------------------------------------------------------------------------


class Collector:
    """Per-node metric collector.

    ``gauge`` overwrites a point-in-time series; ``observe`` appends an
    event sample (latencies etc.); ``counter`` accumulates.  All three
    land in ring buffers read by ``CentralPoller.poll`` — writers never
    block on the control plane.  When a ``MetricBus`` is attached, every
    write is also pushed through it so threshold subscriptions can react
    between polls (the event tier; still O(1) when nothing subscribes).
    """

    def __init__(self, node: str = "node0", cap: int = 512,
                 bus: Optional[MetricBus] = None):
        self.node = node
        self.cap = cap
        self.bus = bus
        self._rings: dict[str, Ring] = {}
        self._counters: dict[str, float] = {}
        self._specs: dict[str, MetricSpec] = {}

    # -- write side (hot path) ------------------------------------------------
    def _ring(self, name: str) -> Ring:
        r = self._rings.get(name)
        if r is None:
            r = self._rings[name] = Ring(self.cap)
        return r

    def gauge(self, name: str, value: float, t: float) -> None:
        self._ring(name).push(float(value), t)
        if self.bus is not None:
            self.bus.publish(name, float(value), t)

    def observe(self, name: str, value: float, t: float) -> None:
        self._ring(name).push(float(value), t)
        if self.bus is not None:
            self.bus.publish(name, float(value), t)

    def counter(self, name: str, delta: float, t: float) -> None:
        total = self._counters.get(name, 0.0) + delta
        self._counters[name] = total
        self._ring(name).push(total, t)
        if self.bus is not None:
            self.bus.publish(name, total, t)

    # -- spec side --------------------------------------------------------------
    def describe(self, name: str, spec_or_doc) -> None:
        """Attach semantics: a MetricSpec, a dict (JSON path), or a
        natural-language docstring (NL path)."""
        if isinstance(spec_or_doc, MetricSpec):
            self._specs[name] = spec_or_doc
        elif isinstance(spec_or_doc, dict):
            self._specs[name] = MetricSpec.from_dict({"name": name,
                                                      **spec_or_doc})
        else:
            self._specs[name] = MetricSpec.from_docstring(name,
                                                          str(spec_or_doc))

    def spec(self, name: str) -> MetricSpec:
        if name in self._specs:
            return self._specs[name]
        base = name.rsplit(".", 1)[-1]
        return BUILTIN_SPECS.get(base, MetricSpec(name=name))

    # -- read side (poller only) --------------------------------------------
    def names(self) -> list[str]:
        return list(self._rings)

    def read(self, name: str, since: float = -math.inf):
        r = self._rings.get(name)
        return r.window(since) if r is not None else []

    def last(self, name: str) -> Optional[float]:
        r = self._rings.get(name)
        return r.last() if r is not None else None


# ---------------------------------------------------------------------------
# State store + central poller (tier 2)
# ---------------------------------------------------------------------------


@dataclass
class Series:
    spec: MetricSpec
    points: list[tuple[float, float]] = field(default_factory=list)

    def agg(self, how: str, window: float = math.inf,
            now: float = math.inf) -> float:
        lo = (now - window) if math.isfinite(now) else -math.inf
        xs = [v for (t, v) in self.points if t >= lo]
        return AGGREGATIONS[how](xs)


class StateStore:
    """The controller's logical state store (§3.1 design point 3): the
    freshest polled window of every metric, keyed ``node.metric``."""

    def __init__(self):
        self.series: dict[str, Series] = {}
        self.polled_at: float = -math.inf

    def update(self, name: str, spec: MetricSpec,
               points: Iterable[tuple[float, float]]) -> None:
        s = self.series.get(name)
        if s is None:
            s = self.series[name] = Series(spec)
        s.spec = spec
        s.points = list(points)

    # -- query API used by policies / the intent language ---------------------
    def get(self, name: str, agg: Optional[str] = None,
            window: float = math.inf, default: float = math.nan) -> float:
        if any(c in name for c in "*?["):
            return self._get_glob(name, agg, window, default)
        s = self.series.get(name)
        if s is None or not s.points:
            return default
        how = agg or s.spec.default_agg
        v = s.agg(how, window, now=self.polled_at)
        return default if (isinstance(v, float) and math.isnan(v)) else v

    def _get_glob(self, pattern: str, agg: Optional[str],
                  window: float, default: float) -> float:
        """Fleet-wide query: pool every series matching the glob (e.g.
        ``mean(tester-*.queue_len)``) and aggregate the combined window —
        mirroring the MetricBus's glob threshold subscriptions."""
        lo = ((self.polled_at - window)
              if math.isfinite(self.polled_at) else -math.inf)
        xs: list[float] = []
        how = agg
        for n, s in self.series.items():
            if not fnmatch.fnmatch(n, pattern) or not s.points:
                continue
            if how is None:
                how = s.spec.default_agg
            xs.extend(v for (t, v) in s.points if t >= lo)
        if not xs:
            return default
        v = AGGREGATIONS[how or "mean"](xs)
        return default if (isinstance(v, float) and math.isnan(v)) else v

    def names(self, pattern: str = "") -> list[str]:
        return [n for n in self.series if pattern in n]

    def spec(self, name: str) -> Optional[MetricSpec]:
        s = self.series.get(name)
        return s.spec if s else None


class CentralPoller:
    """On-demand pull of every collector's fresh window into the store."""

    def __init__(self, store: StateStore, window: float = 5.0):
        self.store = store
        self.window = window
        self.collectors: list[Collector] = []
        self.polls = 0

    def attach(self, collector: Collector) -> None:
        if collector not in self.collectors:
            self.collectors.append(collector)

    def poll(self, now: float) -> None:
        since = now - self.window
        for c in self.collectors:
            for name in c.names():
                self.store.update(name, c.spec(name), c.read(name, since))
        self.store.polled_at = now
        self.polls += 1
