"""Tracing plane — end-to-end request spans + control-plane flight
recorder (the observability half of the SDN story).

The control plane can *act* from runtime state, but until now it could
not *explain*: aggregate gauges answer "is p95 high", not "why was this
request slow" or "what did that intent actually change".  This module
adds both halves:

* ``Tracer`` — a span store threaded through every layer a request
  crosses: router admission / tenant throttle hold, scheduler queue
  wait and preemption, prefill, chunk-streamed KV handoff, decode, and
  workflow stage/DAG edges (stage spans parent onto the task root;
  engine request spans parent onto their issuing stage).  Per-request
  **segment** spans (``queue_wait``, ``throttle_hold``,
  ``handoff_wait``, ``prefill``, ``decode``) tile the request's
  lifetime exactly — they are opened/closed at the same lifecycle
  transitions the engines already stamp, so their durations sum to the
  end-to-end measured latency.  Every closed segment is also published
  as a ``request.<segment>`` observation through the MetricBus, so
  intent programs can trigger on *segments*, not just totals.

  Sampling is a control-plane attribute: the tracer registers as a
  ``tracer`` controllable (knobs ``enabled`` / ``sample``) with
  capability ``trace``, and the intent verb ``trace [tenant|stage NAME]
  on|off|RATE`` scopes sampling per tenant or per stage at runtime.
  Decisions are deterministic (crc32 hash of the trace id) — no RNG,
  no wall clock — so a sim replay traces the same tasks.

* ``FlightRecorder`` — a bounded black box: every control-plane action
  from the controller's audit log, plus rolling windows of watched
  metric series (``watch("tester-*.queue_len")``).  At export time
  actions are causally annotated onto the data-plane spans they
  overlapped, so a trace shows "p95 breached → intent X fired → engine
  e3 role flipped → this request's handoff_wait".  The recorded metric
  windows are the substrate ROADMAP item 5's ``dry-run`` verb replays.

``Tracer.export`` writes Perfetto/Chrome-trace JSON (``TRACE_*.json``,
load it at ``chrome://tracing`` or https://ui.perfetto.dev): complete
("X") events per span, instant ("i") events per control action, and
flow ("s"/"f") events drawing each causal action→span link.
``tools/trace_report.py`` walks the exported JSON alone and reprints
the DAG critical path with the dominant segment per stage.
"""
from __future__ import annotations

import json
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

from repro_torch.core.knobs import ControlSurface, KnobSpec
from repro_torch.core.metrics import MetricBus, Ring

# the per-request latency decomposition: these tile [arrival, finish]
SEGMENTS = ("queue_wait", "throttle_hold", "handoff_wait",
            "prefill", "decode")


@dataclass
class Span:
    """One timed interval on a trace tree.  ``trace_id`` groups a task's
    spans; ``parent_id`` links request→stage→task (and segment→request).
    ``t1 is None`` while the span is open."""

    span_id: int
    name: str
    cat: str                       # task | stage | request | segment | kv
    trace_id: str
    t0: float
    t1: Optional[float] = None
    parent_id: Optional[int] = None
    attrs: dict = field(default_factory=dict)

    @property
    def closed(self) -> bool:
        return self.t1 is not None

    @property
    def dur(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0


class Tracer(ControlSurface):
    """Span store + sampling policy, registered as a controllable."""

    kind = "tracer"
    CAPABILITIES = ("trace",)
    METRICS = ("spans_total", "spans_dropped")
    KNOB_SPECS = (
        KnobSpec("enabled", kind="bool",
                 doc="master switch for span capture"),
        KnobSpec("sample", kind="float", lo=0.0, hi=1.0,
                 doc="global trace sampling rate (fraction of tasks)"),
    )

    def __init__(self, clock: Callable[[], float], name: str = "tracer",
                 collector=None, cap: int = 65536):
        self.name = name
        self.clock = clock
        self.collector = collector
        self.cap = cap
        self.enabled = False           # knob: off by default (zero cost)
        self.sample = 1.0              # knob: rate once enabled
        self.scopes: dict[str, float] = {}   # "tenant:gold"/"stage:map" -> rate
        self.spans: list[Span] = []          # closed spans (bounded ring)
        self._open: dict[int, Span] = {}
        self._decisions: dict[str, bool] = {}
        self._task_spans: dict[str, Span] = {}
        self._next_id = 0
        self.spans_total = 0
        self.spans_dropped = 0

    def _surface_now(self) -> float:
        return self.clock()

    # -- sampling policy ----------------------------------------------------
    def set_scope(self, scope: Optional[str], rate: float) -> None:
        """The ``trace`` verb's target: ``scope`` is ``None`` (global),
        ``tenant:NAME`` or ``stage:NAME``; ``rate`` in [0, 1] (the verb
        maps on→1.0, off→0.0).  Any positive scoped rate implies the
        master switch — ``trace tenant gold on`` must not silently no-op
        because global tracing was never enabled."""
        rate = min(max(float(rate), 0.0), 1.0)
        if scope is None:
            self.sample = rate
            self.enabled = rate > 0
        else:
            self.scopes[scope] = rate
            if rate > 0:
                self.enabled = True

    @staticmethod
    def _hash_ok(key: str, rate: float) -> bool:
        if rate >= 1.0:
            return True
        if rate <= 0.0:
            return False
        # deterministic: the sim has no RNG, and a replay must trace
        # the same tasks
        return (zlib.crc32(key.encode()) % 10000) / 10000.0 < rate

    def decide(self, trace_id: str, tenant: str = "default",
               stage: Optional[str] = None) -> bool:
        """Sample decision for a trace id, cached so every span of a
        task agrees.  A ``stage:`` scope is most specific and overrides
        the task-level decision for that stage's requests; a ``tenant:``
        scope overrides the global rate."""
        if not self.enabled:
            return False               # not cached: enabling mid-run
        if stage is not None:          # must reach tasks submitted later
            srate = self.scopes.get(f"stage:{stage}")
            if srate is not None:
                return self._hash_ok(f"{trace_id}:{stage}", srate)
        d = self._decisions.get(trace_id)
        if d is None:
            rate = self.scopes.get(f"tenant:{tenant}", self.sample)
            d = self._hash_ok(trace_id, rate)
            if len(self._decisions) > 4 * self.cap:
                self._decisions.clear()
            self._decisions[trace_id] = d
        return d

    def decided(self, trace_id: str) -> bool:
        """True only for trace ids already sampled in — used by
        supplementary recorders (kv chunks) that must not originate
        fresh decisions."""
        return self._decisions.get(trace_id, False)

    # -- span lifecycle -----------------------------------------------------
    def begin(self, name: str, trace_id: str, cat: str = "span",
              parent: Optional[Span] = None, t: Optional[float] = None,
              **attrs) -> Span:
        sp = Span(self._next_id, name, cat, trace_id,
                  self.clock() if t is None else t,
                  parent_id=parent.span_id if parent is not None else None,
                  attrs=attrs)
        self._next_id += 1
        self._open[sp.span_id] = sp
        return sp

    def end(self, span: Optional[Span], t: Optional[float] = None) -> None:
        if span is None or span.t1 is not None:
            return
        span.t1 = self.clock() if t is None else t
        self._open.pop(span.span_id, None)
        self._store(span)

    def record(self, name: str, trace_id: str, t0: float, t1: float,
               cat: str = "span", parent: Optional[Span] = None,
               **attrs) -> Span:
        """One-shot span with both endpoints known."""
        sp = Span(self._next_id, name, cat, trace_id, t0, t1,
                  parent_id=parent.span_id if parent is not None else None,
                  attrs=attrs)
        self._next_id += 1
        self._store(sp)
        return sp

    def _store(self, span: Span) -> None:
        self.spans_total += 1
        self.spans.append(span)
        if len(self.spans) > self.cap:
            drop = self.cap // 2
            del self.spans[:drop]
            self.spans_dropped += drop
        if span.cat == "segment" and self.collector is not None:
            # the per-segment decomposition gauges intents trigger on
            self.collector.observe(f"request.{span.name}", span.dur,
                                   span.t1)

    # -- task roots ---------------------------------------------------------
    def begin_task(self, task_id: str, tenant: str = "default",
                   t: Optional[float] = None, **attrs) -> Optional[Span]:
        if not self.decide(task_id, tenant=tenant):
            return None
        sp = self.begin(f"task:{task_id}", task_id, cat="task", t=t,
                        tenant=tenant, **attrs)
        self._task_spans[task_id] = sp
        return sp

    def end_task(self, task_id: str, t: Optional[float] = None) -> None:
        self.end(self._task_spans.pop(task_id, None), t)

    def task_span(self, task_id: str) -> Optional[Span]:
        return self._task_spans.get(task_id)

    # -- export -------------------------------------------------------------
    def all_spans(self) -> list[Span]:
        out = list(self.spans) + list(self._open.values())
        out.sort(key=lambda s: (s.t0, s.span_id))
        return out

    def export(self, path=None, recorder: "FlightRecorder" = None,
               clip_at: Optional[float] = None) -> dict:
        """Build (and optionally write) the Chrome-trace JSON document.
        Open spans are clipped at ``clip_at`` (default: now) and marked
        ``open``; recorder actions become instant events with flow
        edges to the spans they causally overlapped."""
        now = self.clock() if clip_at is None else clip_at
        spans = self.all_spans()
        actions = list(recorder.actions) if recorder is not None else []
        links = correlate_actions(actions, spans)
        linked: dict[int, list] = {}
        for a, s in links:
            linked.setdefault(s.span_id, []).append(a)

        tracks: dict[str, int] = {}
        tids: dict[str, int] = {}

        def pid(track: str) -> int:
            return tracks.setdefault(track, len(tracks) + 1)

        def tid(trace_id: str) -> int:
            return tids.setdefault(trace_id, len(tids) + 1)

        _CAT_TRACK = {"task": "tasks", "stage": "stages", "kv": "kv-fabric"}
        events = []
        placed: dict[int, tuple[int, int]] = {}   # span_id -> (pid, tid)
        for s in spans:
            track = s.attrs.get("engine") or _CAT_TRACK.get(s.cat,
                                                            "requests")
            p, th = pid(track), tid(s.trace_id)
            placed[s.span_id] = (p, th)
            end = s.t1 if s.t1 is not None else now
            args = {"span_id": s.span_id, "parent_id": s.parent_id,
                    "trace_id": s.trace_id, **s.attrs}
            if s.t1 is None:
                args["open"] = True
            acts = linked.get(s.span_id)
            if acts:
                args["actions"] = [f"{a.kind} {a.target}: {a.detail}"
                                   for a in acts]
            events.append({"name": s.name, "cat": s.cat, "ph": "X",
                           "ts": round(s.t0 * 1e6, 3),
                           "dur": round(max(end - s.t0, 0.0) * 1e6, 3),
                           "pid": p, "tid": th, "args": args})
        cpid = pid("control-plane")
        for a in actions:
            events.append({"name": f"{a.kind}:{a.target}", "cat": "control",
                           "ph": "i", "s": "p",
                           "ts": round(a.t * 1e6, 3), "pid": cpid, "tid": 0,
                           "args": {"kind": a.kind, "target": a.target,
                                    "detail": a.detail}})
        for i, (a, s) in enumerate(links, 1):
            p, th = placed[s.span_id]
            events.append({"name": "causal", "cat": "control", "ph": "s",
                           "id": i, "ts": round(a.t * 1e6, 3),
                           "pid": cpid, "tid": 0})
            events.append({"name": "causal", "cat": "control", "ph": "f",
                           "bp": "e", "id": i,
                           "ts": round(max(a.t, s.t0) * 1e6, 3),
                           "pid": p, "tid": th})
        for track, p in tracks.items():
            events.append({"name": "process_name", "ph": "M", "ts": 0,
                           "pid": p, "tid": 0, "args": {"name": track}})
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"clock": "virtual-seconds",
                             "spans": len(spans), "actions": len(actions),
                             "links": len(links)}}
        if path is not None:
            Path(path).write_text(json.dumps(doc, indent=1) + "\n")
        return doc


def correlate_actions(actions, spans, per_action: int = 4,
                      cap: int = 512) -> list:
    """Causal annotation: for each control-plane action, the data-plane
    spans it temporally overlapped — preferring spans whose attributes
    name the action's target (an engine, tenant or stage), falling back
    to the overlapping trace roots.  Returns (action, span) pairs,
    bounded so a chatty controller cannot blow up the export."""
    out = []
    for a in actions:
        overlapping = [s for s in spans
                       if s.t0 - 1e-9 <= a.t
                       and (s.t1 is None or a.t <= s.t1 + 1e-9)]
        if not overlapping:
            continue
        tgt = str(a.target)

        def _names_target(s):
            if not tgt or tgt == "-":
                return False
            hay = [s.name] + [str(v) for v in s.attrs.values()]
            return any(tgt == h or (len(tgt) > 2 and tgt in h)
                       for h in hay)

        hit = [s for s in overlapping if _names_target(s)] \
            or [s for s in overlapping if s.parent_id is None]
        for s in hit[:per_action]:
            out.append((a, s))
            if len(out) >= cap:
                return out
    return out


def request_decomposition(spans) -> list:
    """Per traced request: (request span, {segment: summed seconds},
    request duration).  Only closed requests — the acceptance check is
    that the segment sum matches the request's end-to-end latency."""
    by_parent: dict[int, list[Span]] = {}
    for s in spans:
        if s.parent_id is not None:
            by_parent.setdefault(s.parent_id, []).append(s)
    out = []
    for s in spans:
        if s.cat != "request" or s.t1 is None:
            continue
        segs: dict[str, float] = {}
        for c in by_parent.get(s.span_id, ()):
            if c.cat == "segment" and c.t1 is not None:
                segs[c.name] = segs.get(c.name, 0.0) + c.dur
        out.append((s, segs, s.dur))
    return out


class FlightRecorder:
    """Bounded black box for the control plane: every audit-log action
    plus rolling windows of watched metric series.  The recorded
    windows are what a future ``dry-run`` verb replays through the
    CostModel to predict an intent's effect before it goes live."""

    def __init__(self, clock: Callable[[], float],
                 bus: Optional[MetricBus] = None,
                 action_cap: int = 2048, window_cap: int = 1024):
        self.clock = clock
        self.bus = bus
        self.action_cap = action_cap
        self.window_cap = window_cap
        self.actions: list = []            # controller Action records
        self.actions_total = 0
        self.windows: dict[str, Ring] = {}
        self.watched: list[str] = []

    # -- control-plane feed (Controller._log forwards here) ------------------
    def record_action(self, action) -> None:
        self.actions_total += 1
        self.actions.append(action)
        if len(self.actions) > self.action_cap:
            del self.actions[: self.action_cap // 2]

    def actions_between(self, t0: float = float("-inf"),
                        t1: float = float("inf"),
                        kind: Optional[str] = None) -> list:
        return [a for a in self.actions
                if t0 <= a.t <= t1 and (kind is None or a.kind == kind)]

    # -- metric-window feed --------------------------------------------------
    def watch(self, pattern: str) -> None:
        """Record every published sample of series matching ``pattern``
        (exact name or glob) into a bounded per-series ring."""
        if self.bus is None:
            raise RuntimeError("FlightRecorder.watch needs a MetricBus")
        self.watched.append(pattern)
        self.bus.subscribe(pattern, predicate=lambda v: True, edge=False,
                           fn=self._sample)

    def _sample(self, name: str, value: float, t: float) -> None:
        ring = self.windows.get(name)
        if ring is None:
            ring = self.windows[name] = Ring(self.window_cap)
        ring.push(value, t)

    def window(self, name: str,
               since: float = float("-inf")) -> list:
        ring = self.windows.get(name)
        return ring.window(since) if ring is not None else []

    def snapshot(self, since: float = float("-inf")) -> dict:
        """The dry-run substrate: recorded actions + metric windows
        newer than ``since``, as plain data."""
        return {
            "t": self.clock(),
            "actions": [(a.t, a.kind, a.target, a.detail)
                        for a in self.actions if a.t >= since],
            "metrics": {n: r.window(since)
                        for n, r in self.windows.items()},
        }
