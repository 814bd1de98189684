"""Configurable data plane (paper §3.3).

``Channel`` is the *shim layer* between the agent-protocol surface
(agents/protocol.py exposes an A2A-like API on top of it) and the
transport (sim/network.Link).  It owns the attributes the paper wants
runtime-controllable:

* **granularity** — BATCH / PIPELINE / STREAM buffering of the producer's
  token flow (Fig 2).  Switchable mid-task: buffered content flushes
  under the new mode's boundary rules from that point on.
* **pacing** — a minimum inter-message gap, so the controller can slow a
  chatty producer without touching the agent.
* **priority** — stamped on every message; downstream engines' schedulers
  honor it (pipeline-wide prioritization).
* **speculative gating** — request-level rule hook: speculative messages
  are held in the shim until the controller releases them ("when an agent
  sends a speculative request, block it until resources are free").

Every knob goes through the same two-function ``set()/reset()`` surface
(Table 1) as engines and agents, so the controller needs exactly one
integration.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Protocol

from repro_torch.core.knobs import ControlSurface, KnobSpec
from repro_torch.core.types import Granularity, Message, Priority
from repro_torch.sim.clock import EventLoop
from repro_torch.sim.network import Link


class Endpoint(Protocol):
    name: str

    def deliver(self, msg: Message) -> None: ...


@dataclass
class _TaskBuf:
    task_id: str
    session: Optional[str] = None
    tokens: int = 0                  # buffered, not yet flushed
    units: int = 0                   # completed units in buffer
    total_tokens: int = 0
    total_units: int = 0
    meta: dict = field(default_factory=dict)
    speculative: bool = False
    open_unit_tokens: int = 0        # tokens in the currently-open unit


class Channel(ControlSurface):
    """One directed agent→agent (or agent→router) communication shim."""

    kind = "channel"
    CAPABILITIES = ("granularity", "pace", "gate")
    METRICS = ("msgs_sent", "bytes_sent", "link_delay")
    KNOB_SPECS = (
        KnobSpec("granularity", enum=Granularity,
                 on_change="_granularity_changed",
                 doc="BATCH/PIPELINE/STREAM buffering of the token flow"),
        KnobSpec("stream_chunk", kind="int", lo=1,
                 doc="tokens per message under STREAM"),
        KnobSpec("pace", kind="float", lo=0.0,
                 doc="min seconds between flushes"),
        KnobSpec("priority", enum=Priority,
                 doc="priority stamped on outgoing messages"),
        KnobSpec("gate_speculative", kind="bool", on_change="_gate_changed",
                 doc="hold speculative messages until released"),
    )

    def __init__(self, loop: EventLoop, link: Link, src: str, dst: Endpoint,
                 name: Optional[str] = None, collector=None,
                 granularity: Granularity = Granularity.BATCH,
                 stream_chunk: int = 8):
        self.loop = loop
        self.link = link
        self.src = src
        self.dst = dst
        self.name = name or f"{src}->{dst.name}"
        self.collector = collector
        self.granularity = granularity
        self.stream_chunk = int(stream_chunk)
        self.pace = 0.0                      # min seconds between flushes
        self.priority = Priority.NORMAL
        self.gate_speculative = False
        self._bufs: dict[str, _TaskBuf] = {}
        self._held: list[Message] = []       # gated speculative messages
        self._last_flush = -1e18
        self.msgs_sent = 0
        self.tokens_sent = 0

    # -------------------------------------------------- knob change hooks
    # (get/set/reset/card come from ControlSurface)
    def _granularity_changed(self, old, new) -> None:
        # re-evaluate buffers under the new mode immediately
        for buf in list(self._bufs.values()):
            self._maybe_flush(buf)

    def _gate_changed(self, old, new) -> None:
        if not new:
            self.release_held()

    # ------------------------------------------------------------- producer
    def begin_task(self, task_id: str, session: Optional[str] = None,
                   speculative: bool = False, **meta) -> None:
        self._bufs[task_id] = _TaskBuf(task_id, session, meta=dict(meta),
                                       speculative=speculative)

    def push_tokens(self, task_id: str, n: int = 1) -> None:
        buf = self._bufs[task_id]
        buf.tokens += n
        buf.total_tokens += n
        buf.open_unit_tokens += n
        if self.granularity is Granularity.STREAM:
            while buf.tokens >= self.stream_chunk:
                self._flush(buf, self.stream_chunk)

    def end_unit(self, task_id: str) -> None:
        buf = self._bufs[task_id]
        buf.units += 1
        buf.total_units += 1
        buf.open_unit_tokens = 0
        if self.granularity is Granularity.PIPELINE:
            self._flush(buf, buf.tokens, unit_end=True)
        elif self.granularity is Granularity.STREAM and buf.tokens:
            self._flush(buf, buf.tokens, unit_end=True)

    def end_task(self, task_id: str) -> None:
        buf = self._bufs.pop(task_id)
        self._flush(buf, buf.tokens, unit_end=buf.units > 0, task_end=True)

    # ------------------------------------------------------------- flushing
    def _maybe_flush(self, buf: _TaskBuf) -> None:
        """Apply the current mode's boundary rule to buffered content
        (used after a mid-task granularity switch)."""
        if self.granularity is Granularity.STREAM:
            while buf.tokens >= self.stream_chunk:
                self._flush(buf, self.stream_chunk)
        elif self.granularity is Granularity.PIPELINE and buf.units > 0:
            # flush all *complete* units; keep the open unit buffered
            done = buf.tokens - buf.open_unit_tokens
            if done > 0:
                self._flush(buf, done, unit_end=True)

    def _flush(self, buf: _TaskBuf, tokens: int, unit_end: bool = False,
               task_end: bool = False) -> None:
        units = buf.units if (unit_end or task_end) else 0
        msg = Message(
            src=self.src, dst=self.dst.name,
            payload={"session": buf.session, "unit_end": unit_end,
                     "task_end": task_end, "units": units, **buf.meta},
            units=max(units, 1), tokens=tokens,
            granularity=self.granularity, priority=self.priority,
            created_at=self.loop.now(), task_id=buf.task_id,
            speculative=buf.speculative)
        buf.tokens -= tokens
        buf.units = 0
        if msg.speculative and self.gate_speculative:
            self._held.append(msg)
            return
        self._send(msg)

    def _send(self, msg: Message) -> None:
        delay = 0.0
        if self.pace > 0:
            gap = self.loop.now() - self._last_flush
            if gap < self.pace:
                delay = self.pace - gap
        self._last_flush = self.loop.now() + delay
        nbytes = self.link.message_bytes(msg.tokens)
        self.link.transfer(nbytes, lambda m=msg: self.dst.deliver(m),
                           extra_latency=delay)
        self.msgs_sent += 1
        self.tokens_sent += msg.tokens
        if self.collector is not None:
            t = self.loop.now()
            self.collector.counter(f"{self.name}.msgs_sent", 1, t)
            self.collector.counter(f"{self.name}.bytes_sent", nbytes, t)
            self.collector.gauge(f"{self.name}.link_delay",
                                 self.link.queue_delay, t)

    # ------------------------------------------------------------ gating
    def release_held(self) -> None:
        held, self._held = self._held, []
        for msg in held:
            self._send(msg)

    @property
    def held_count(self) -> int:
        return len(self._held)
