"""Cross-instance KV/state transfer — the paper's "rich control surface"
example (§3.1) and the Fig-7 mechanism.

Two timing modes:

* **reactive** — the transfer starts when called (i.e. after the request
  already arrived at the destination); the request's prefill is gated on
  delivery, so the transfer latency lands on the critical path.
* **proactive ("hint")** — the controller starts the transfer while the
  *upstream* agent is still generating; by the time the request arrives
  the state is (usually) resident, and the hand-off costs ~nothing.

The byte count comes from the architecture's cost model
(``CostModel.kv_transfer_bytes``): SWA archs move at most ``window``
tokens of KV, SSM/hybrid archs move O(1) recurrent state — the
controller's migrate-or-not threshold consumes exactly this number.

The same manager moves *real* engine state when given Engine instances
(extract_state/inject_state pytrees); in the sim it moves byte counts.

On top of session migration, the manager owns the disaggregation
plane's **prefill→decode handoff pipeline**: a per-request transfer that
is *chunk-streamed* — as prefill advances on the prefill-role engine,
the KV computed so far is pushed to the paired decode engine
(``handoff_progress``), so by prefill completion only the tail chunk
remains in flight (``finish_handoff``) and the handoff latency exposed
on the critical path is ``CostModel.handoff_time`` with the prefill
duration as overlap, not the full transfer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.sim.clock import EventLoop
from repro_torch.sim.network import Link


@dataclass
class SessionRecord:
    session: str
    instance: str                  # where the KV currently lives
    context_len: int = 0           # accumulated session context (tokens)
    inflight_to: Optional[str] = None
    ready_at: float = -1.0         # when the inflight copy lands


class SessionDirectory:
    """Controller-visible map: session → (home instance, context size)."""

    def __init__(self):
        self.records: dict[str, SessionRecord] = {}

    def ensure(self, session: str, instance: str) -> SessionRecord:
        rec = self.records.get(session)
        if rec is None:
            rec = self.records[session] = SessionRecord(session, instance)
        return rec

    def get(self, session: str) -> Optional[SessionRecord]:
        return self.records.get(session)

    def grow(self, session: str, tokens: int) -> None:
        rec = self.records.get(session)
        if rec is not None:
            rec.context_len += tokens

    def resident(self, session: str, instance: str, now: float) -> bool:
        rec = self.records.get(session)
        if rec is None:
            return False
        if rec.instance == instance:
            return True
        return (rec.inflight_to == instance and 0 <= rec.ready_at <= now)


@dataclass
class HandoffRecord:
    """One in-flight prefill→decode handoff (per request, not session)."""

    req_id: str
    src: str
    dst: str
    streamed_tokens: int = 0       # prefix whose KV has been pushed
    ready_at: float = -1.0         # delivery time of the last chunk sent
    finished: bool = False         # finish_handoff called (tail in flight)


class KVTransferManager:
    """Owns the inter-instance links and the transfer state machine."""

    def __init__(self, loop: EventLoop, directory: SessionDirectory,
                 bytes_fn: Callable[[int], int],
                 bandwidth: float = 12.5e9, latency: float = 1.0e-3,
                 collector=None, name: str = "kvx"):
        self.loop = loop
        self.dir = directory
        self.bytes_fn = bytes_fn          # context_len -> bytes to move
        self.collector = collector
        self.name = name
        self.bandwidth = bandwidth
        self.latency = latency
        self._links: dict[tuple[str, str], Link] = {}
        self.tracer = None                # tracing plane | None
        self.transfers = 0
        self.bytes_moved = 0.0
        self.payload_movers: dict[tuple[str, str], Callable] = {}
        self.handoff_records: dict[str, HandoffRecord] = {}
        self.handoffs = 0
        self.handoff_bytes = 0.0

    def link(self, src: str, dst: str) -> Link:
        key = (src, dst)
        if key not in self._links:
            self._links[key] = Link(self.loop, self.bandwidth, self.latency,
                                    name=f"{self.name}:{src}->{dst}")
        return self._links[key]

    def attach_engines(self, agents: dict[str, object]) -> None:
        """Real-engine mode: wire extract/inject around the timed link."""
        self._agents = agents

    # -- the control-plane verb ------------------------------------------------
    def transfer(self, session: str, src: str, dst: str,
                 proactive: bool = False,
                 on_done: Optional[Callable[[], None]] = None) -> float:
        """Move a session's KV state src → dst; returns delivery time."""
        rec = self.dir.ensure(session, src)
        if rec.instance == dst:
            if on_done:
                on_done()
            return self.loop.now()
        nbytes = self.bytes_fn(rec.context_len)
        rec.inflight_to = dst
        rec.ready_at = float("inf")
        link = self.link(src, dst)

        def _deliver():
            rec.instance = dst
            rec.inflight_to = None
            if on_done:
                on_done()

        t = link.transfer(nbytes, _deliver)
        rec.ready_at = t
        self.transfers += 1
        self.bytes_moved += nbytes
        if self.collector is not None:
            self.collector.counter(f"{self.name}.transfer_bytes", nbytes,
                                   self.loop.now())
            self.collector.counter(f"{self.name}.transfers", 1,
                                   self.loop.now())
        return t

    # -- prefill→decode handoff pipeline (disaggregation plane) -----------------
    def start_handoff(self, req_id: str, src: str, dst: str) -> HandoffRecord:
        """Open a handoff session for one request.  Called when the
        router pre-pins the decode pair — *before* prefill produces its
        first token — so ``handoff_progress`` chunks can start streaming
        while the prompt is still being prefilled."""
        rec = HandoffRecord(req_id, src, dst)
        self.handoff_records[req_id] = rec
        return rec

    def handoff_progress(self, req_id: str, prefilled_tokens: int) -> None:
        """Prefill advanced to ``prefilled_tokens``: stream the newly
        computed KV chunk now, overlapping the remaining prefill.  Bytes
        are incremental through ``bytes_fn`` so windowed/SSM archs whose
        movable state saturates are not over-charged per chunk."""
        rec = self.handoff_records.get(req_id)
        if rec is None or rec.finished:
            return
        if prefilled_tokens <= rec.streamed_tokens:
            return
        delta = self.bytes_fn(prefilled_tokens) - self.bytes_fn(
            rec.streamed_tokens)
        rec.streamed_tokens = prefilled_tokens
        if delta <= 0:
            return
        rec.ready_at = self.link(rec.src, rec.dst).transfer(
            delta, lambda: None)
        self._count_handoff_bytes(delta)
        self._trace_chunk(rec, delta, rec.ready_at, tail=False)

    def finish_handoff(self, req_id: str, src: str, dst: str,
                       total_tokens: int,
                       on_ready: Callable[[], None]) -> float:
        """Prefill complete: stream the remaining tail and schedule
        ``on_ready`` at final delivery.  If the record was pinned to a
        different destination (its decode engine changed role while
        chunks were in flight), the already-streamed prefix is wasted
        and the full state restreams to the new target."""
        rec = self.handoff_records.get(req_id)
        if rec is None:
            rec = self.start_handoff(req_id, src, dst)
        if rec.dst != dst or rec.src != src:
            rec.src, rec.dst = src, dst
            rec.streamed_tokens = 0
            rec.ready_at = -1.0
        rec.finished = True
        tail = self.bytes_fn(total_tokens) - self.bytes_fn(
            rec.streamed_tokens)
        rec.streamed_tokens = max(rec.streamed_tokens, total_tokens)
        if tail > 0:
            t = self.link(src, dst).transfer(tail, on_ready)
            self._count_handoff_bytes(tail)
            self._trace_chunk(rec, tail, t, tail=True)
        else:
            # everything already streamed: residency lands with the last
            # in-flight chunk (or immediately, if it has already landed)
            t = max(self.loop.now(), rec.ready_at)
            self.loop.call_at(t, on_ready)
        rec.ready_at = t
        self.handoffs += 1
        if self.collector is not None:
            self.collector.counter(f"{self.name}.handoffs", 1,
                                   self.loop.now())
        return t

    def handoff_wait(self, req_id: str, instance: str) -> float:
        """Seconds until a handed-off request's KV is resident at
        ``instance``: 0 when no handoff is in flight (locally-prefilled
        state is resident by construction), +inf while prefill is still
        producing state or the transfer targets another instance."""
        rec = self.handoff_records.get(req_id)
        if rec is None:
            return 0.0
        if rec.dst != instance or not rec.finished:
            return float("inf")
        return max(0.0, rec.ready_at - self.loop.now())

    def end_handoff(self, req_id: str) -> None:
        """Drop a handoff record (delivered and admitted, or aborted)."""
        self.handoff_records.pop(req_id, None)

    def _trace_chunk(self, rec: HandoffRecord, nbytes: float,
                     ready_at: float, tail: bool) -> None:
        """Record one streamed KV chunk as a span on the kv-fabric
        track: [send, delivery].  Gated on an *existing* sample decision
        (``decided``) — the fabric keys handoffs by req_id and must not
        originate fresh decisions for requests tracing keyed by task."""
        tr = self.tracer
        if tr is None or not tr.decided(rec.req_id):
            return
        tr.record("kv_chunk_tail" if tail else "kv_chunk", rec.req_id,
                  self.loop.now(), ready_at, cat="kv",
                  src=rec.src, dst=rec.dst, bytes=int(nbytes),
                  req_id=rec.req_id)

    def _count_handoff_bytes(self, nbytes: float) -> None:
        self.handoff_bytes += nbytes
        self.bytes_moved += nbytes
        if self.collector is not None:
            self.collector.counter(f"{self.name}.handoff_bytes", nbytes,
                                   self.loop.now())

    # -- query used by the destination agent ------------------------------------
    def wait_time(self, session: str, instance: str) -> float:
        """Seconds until the session KV is resident at ``instance``;
        0 if resident, +inf if nothing is on the way."""
        rec = self.dir.get(session)
        now = self.loop.now()
        if rec is None:
            return float("inf")
        if rec.instance == instance:
            return 0.0
        if rec.inflight_to == instance:
            return max(0.0, rec.ready_at - now)
        return float("inf")
