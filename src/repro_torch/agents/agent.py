"""Agents: LLM-backed roles wired through the data plane.

``DeveloperAgent`` — generates code for a task on its engine, emitting
tokens into its outbound channel; the channel's *current* granularity
decides how they leave (the agent itself is granularity-oblivious: late
binding, the paper's fix for §2.2 "early binding").

``TesterAgent`` — consumes messages, turns arrived content into engine
requests *incrementally* (progressive prefill under STREAM), maintains
per-session KV residency via the SessionDirectory, and triggers reactive
KV pulls when a session's state lives on a sibling instance.

``ToolAgent`` — a non-LLM tool (e.g. code executor) with heavy-tailed
latency, timeout/retry semantics, and the same set()/reset() surface,
demonstrating that the Table-1 interface covers tools, not just models.
"""
from __future__ import annotations

import math
import random
import zlib
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core.dataplane import Channel
from repro_torch.core.knobs import ControlSurface, KnobSpec
from repro_torch.core.types import Message, Priority, Request
from repro_torch.serving.engine_base import EngineCore
from repro_torch.serving.kv_transfer import KVTransferManager, SessionDirectory
from repro_torch.sim.clock import EventLoop


# ---------------------------------------------------------------------------
# Developer
# ---------------------------------------------------------------------------


class DeveloperAgent:
    """Generates ``n_functions × func_tokens`` for each task."""

    def __init__(self, name: str, engine: EngineCore, loop: EventLoop,
                 out: Channel, controller=None):
        self.name = name
        self.engine = engine
        self.loop = loop
        self.out = out
        self.controller = controller
        self._active: dict[str, object] = {}     # req_id -> spec
        engine.on_token = self._on_token
        engine.on_finish = self._on_finish

    def submit_task(self, spec) -> None:
        # prefix identity for the cache plane: the MetaGPT-style system
        # preamble is shared across every task; the task body is private
        sys_toks = min(int(getattr(spec, "system_tokens", 0) or 0),
                       spec.prompt_tokens)
        prefix = (("system-prompt", sys_toks),
                  (f"task:{spec.task_id}", spec.prompt_tokens - sys_toks))
        req = Request(prompt_len=spec.prompt_tokens,
                      max_new_tokens=spec.n_functions * spec.func_tokens,
                      priority=spec.priority, stage="developer",
                      meta={"spec": spec, "prefix": prefix,
                            "task": spec.task_id})
        self._active[req.req_id] = spec
        self.out.begin_task(
            spec.task_id, session=spec.session,
            speculative=spec.speculative,
            n_functions=spec.n_functions, func_tokens=spec.func_tokens,
            test_tokens=spec.test_tokens,
            total_tokens=spec.n_functions * spec.func_tokens)
        if self.controller is not None:
            # the hint hook: the controller learns a task started *before*
            # any tokens exist — early enough to pre-position KV state
            self.controller.event("task_start", session=spec.session,
                                  task=spec.task_id, agent=self.name)
        self.engine.submit(req)

    # engine callbacks ---------------------------------------------------------
    def _on_token(self, req: Request, tok: int, t: float) -> None:
        spec = self._active.get(req.req_id)
        if spec is None:
            return
        self.out.push_tokens(spec.task_id, 1)
        if req.generated % spec.func_tokens == 0:
            self.out.end_unit(spec.task_id)

    def _on_finish(self, req: Request, t: float) -> None:
        spec = self._active.pop(req.req_id, None)
        if spec is not None:
            self.out.end_task(spec.task_id)

    def load(self) -> float:
        return self.engine.load()


# ---------------------------------------------------------------------------
# Tester
# ---------------------------------------------------------------------------


@dataclass
class _TaskState:
    task_id: str
    session: str
    n_functions: int
    func_tokens: int
    test_tokens: int
    arrived: int = 0                 # content tokens arrived
    units_requested: int = 0         # units already covered by requests
    open_req: Optional[Request] = None
    open_fed: int = 0                # content tokens fed to open_req
    done_units: int = 0
    reqs: list = field(default_factory=list)
    started_at: float = 0.0
    extra_prefill: int = 0           # session-context recompute tokens


class TesterAgent:
    """One tester *instance* (Fig 7 runs two behind a router)."""

    def __init__(self, name: str, engine: EngineCore, loop: EventLoop,
                 directory: Optional[SessionDirectory] = None,
                 kvx: Optional[KVTransferManager] = None,
                 header_tokens: int = 64, on_task_done: Optional[Callable] = None,
                 recompute_on_miss: bool = True):
        self.name = name
        self.engine = engine
        self.loop = loop
        self.dir = directory
        self.kvx = kvx
        self.header_tokens = header_tokens
        self.on_task_done = on_task_done
        self.recompute_on_miss = recompute_on_miss
        self._tasks: dict[str, _TaskState] = {}
        self.recomputed_tokens = 0
        self.kv_waits: list[float] = []
        engine.on_finish = self._on_finish

    # -- data-plane endpoint -----------------------------------------------------
    def deliver(self, msg: Message) -> None:
        pay = msg.payload or {}
        task_id = msg.task_id
        st = self._tasks.get(task_id)
        if st is None:
            st = self._open_task(task_id, msg)
            if st is None:            # gated on KV transfer: redelivered later
                return
        st.arrived += msg.tokens
        if pay.get("task_end") and st.units_requested == 0 and st.open_req is None:
            self._request_units(st, st.n_functions, st.arrived,
                                priority=msg.priority, batch=True)
            return
        self._absorb(st, msg)

    def _open_task(self, task_id: str, msg: Message) -> Optional[_TaskState]:
        pay = msg.payload or {}
        session = pay.get("session") or task_id
        st = _TaskState(
            task_id=task_id, session=session,
            n_functions=pay.get("n_functions", 1),
            func_tokens=pay.get("func_tokens", msg.tokens or 1),
            test_tokens=pay.get("test_tokens", 32),
            started_at=self.loop.now())
        # --- session KV residency ------------------------------------------
        if self.dir is not None:
            rec = self.dir.get(session)
            if rec is None:
                self.dir.ensure(session, self.name)
            elif not self.dir.resident(session, self.name, self.loop.now()):
                wait = (self.kvx.wait_time(session, self.name)
                        if self.kvx else float("inf"))
                if wait == float("inf") and self.kvx is not None:
                    # reactive pull: fetch the state now that the request
                    # has arrived (the Fig-7 "without hints" arm)
                    self.kvx.transfer(session, rec.instance, self.name)
                    wait = self.kvx.wait_time(session, self.name)
                if wait != float("inf") and wait > 0:
                    self.kv_waits.append(wait)
                    self.loop.call_after(wait, lambda m=msg: self.deliver(m))
                    return None
                if wait == float("inf"):
                    # no transfer fabric: re-prefill the session context
                    if self.recompute_on_miss:
                        st.extra_prefill = rec.context_len
                        self.recomputed_tokens += rec.context_len
                        rec.instance = self.name
                else:
                    self.kv_waits.append(0.0)
        self._tasks[task_id] = st
        return st

    # -- unit/request bookkeeping ----------------------------------------------
    def _absorb(self, st: _TaskState, msg: Message) -> None:
        pay = msg.payload or {}
        full_units = min(st.arrived // st.func_tokens, st.n_functions)
        partial = st.arrived - full_units * st.func_tokens

        if st.open_req is not None:
            # feed the in-flight streaming request up to its unit boundary
            unit_start = (st.units_requested - 1) * st.func_tokens
            have_now = min(st.arrived - unit_start, st.func_tokens)
            delta = have_now - st.open_fed
            if delta > 0:
                st.open_req.feed(delta)
                st.open_fed = have_now
                self.engine.kick()
            if st.open_fed >= st.func_tokens:
                st.open_req = None    # its unit fully arrived
                st.open_fed = 0

        if pay.get("task_end"):
            remaining = st.n_functions - st.units_requested
            if remaining > 0:
                tokens = st.arrived - st.units_requested * st.func_tokens
                self._request_units(st, remaining, tokens,
                                    priority=msg.priority, batch=True)
            return

        # whole units that arrived but aren't covered yet (PIPELINE mode
        # delivers exactly one per message; BATCH after a switch several)
        if full_units > st.units_requested:
            k = full_units - st.units_requested
            self._request_units(st, k, k * st.func_tokens,
                                priority=msg.priority)

        # partial unit under STREAM: open a progressive-prefill request
        if (partial > 0 and st.open_req is None
                and st.units_requested == full_units
                and st.units_requested < st.n_functions):
            req = self._make_request(st, units=1,
                                     content_tokens=st.func_tokens,
                                     available_content=partial,
                                     priority=msg.priority)
            st.open_req = req
            st.open_fed = partial
            st.units_requested += 1

    def _request_units(self, st: _TaskState, units: int, content_tokens: int,
                       priority: Priority, batch: bool = False) -> None:
        self._make_request(st, units=units, content_tokens=content_tokens,
                           available_content=content_tokens,
                           priority=priority)
        st.units_requested += units

    def _make_request(self, st: _TaskState, units: int, content_tokens: int,
                      available_content: int, priority: Priority) -> Request:
        extra = st.extra_prefill
        base = self.header_tokens + extra
        st.extra_prefill = 0          # recompute cost paid once per task
        # prefix identity: the tester's system header is shared across
        # every request on this instance; the session-context recompute
        # is shared within the session; the unit content is private
        prefix = [("system-prompt", self.header_tokens)]
        if extra > 0:
            prefix.append((f"sess:{st.session}", extra))
        prefix.append((f"unit:{st.task_id}:{st.units_requested}",
                       content_tokens))
        req = Request(
            prompt_len=base + content_tokens,
            max_new_tokens=units * st.test_tokens,
            priority=priority, stage="tester",
            meta={"task": st.task_id, "units": units, "agent": self.name,
                  "prefix": tuple(prefix)})
        req.available = base + available_content
        st.reqs.append(req)
        self.engine.submit(req)
        return req

    def _on_finish(self, req: Request, t: float) -> None:
        task_id = req.meta.get("task")
        st = self._tasks.get(task_id)
        if st is None:
            return
        st.done_units += req.meta.get("units", 1)
        if st.done_units >= st.n_functions:
            del self._tasks[task_id]
            if self.dir is not None:
                self.dir.grow(st.session,
                              st.n_functions * (st.func_tokens
                                                + st.test_tokens))
            if self.on_task_done is not None:
                self.on_task_done(st, t)

    def load(self) -> float:
        return self.engine.load()


# ---------------------------------------------------------------------------
# Tool
# ---------------------------------------------------------------------------


class ToolAgent(ControlSurface):
    """A tool endpoint (code executor / retriever / file system).

    Not an LLM: its metrics are call latency and queue depth, and its
    knobs are concurrency and an artificial throttle — the §3.2 point
    that tools need *different* metrics under the same unified plane.

    Real tool latency is heavy-tailed, so beyond the fixed ``latency``
    a ``latency_cv`` coefficient of variation samples per-call
    durations from a lognormal with *median* ``latency`` (the mean is
    then ``latency * exp(sigma^2/2)`` — the tail pulls it up, which is
    exactly what critical-path estimates must account for).  A
    ``timeout`` knob caps any attempt: a timed-out call burns the full
    timeout, then retries with a fresh sample up to ``max_retries``
    times (fail-open after that), with timeout/retry counters on the
    bus for OffloadPolicy and the benchmarks.
    """

    kind = "tool"
    CAPABILITIES = ("throttle",)
    METRICS = ("tool_latency", "tool_queue", "tool_timeouts",
               "tool_retries")
    KNOB_SPECS = (
        KnobSpec("concurrency", kind="int", lo=1,
                 doc="max simultaneous tool calls"),
        KnobSpec("throttle", kind="float", lo=0.0,
                 doc="artificial per-call latency in seconds"),
        KnobSpec("timeout", kind="float", lo=0.0,
                 doc="per-attempt wall-clock cap in seconds; a timed-out "
                     "attempt retries with a fresh latency sample "
                     "(0 = no timeout)"),
    )

    def __init__(self, name: str, loop: EventLoop, latency: float = 0.05,
                 concurrency: int = 2, collector=None,
                 latency_cv: float = 0.0, timeout: float = 0.0,
                 max_retries: int = 1, seed: int | None = None):
        self.name = name
        self.loop = loop
        self.latency = latency
        self.latency_cv = latency_cv
        self.concurrency = concurrency
        self.throttle = 0.0
        self.timeout = timeout
        self.max_retries = max_retries
        self.collector = collector
        self._busy = 0
        self._queue: list[tuple[Message, Callable]] = []
        self.calls = 0
        self.timeouts = 0
        self.retries = 0
        self._rng = random.Random(
            seed if seed is not None else zlib.crc32(name.encode()))
        if collector is not None:
            collector.describe(
                f"{name}.tool_latency",
                "Tool call latency in seconds; lower is better.")

    def on_knob_set(self, name: str, old, new) -> None:
        self._pump()                    # raised concurrency drains the queue

    # -- latency model --------------------------------------------------------
    def sample_latency(self) -> float:
        """One attempt's duration: lognormal(median=latency) when
        latency_cv > 0, the fixed latency otherwise; throttle on top."""
        if self.latency_cv <= 0:
            return self.latency + self.throttle
        sigma = math.sqrt(math.log1p(self.latency_cv ** 2))
        z = self._rng.gauss(0.0, 1.0)
        return self.latency * math.exp(sigma * z) + self.throttle

    def mean_latency(self) -> float:
        """Expected per-call wall clock including the heavy tail and
        timeout retries — what suspend policies and critical-path
        estimates should charge, not the fixed median."""
        return expected_tool_latency(self.latency + self.throttle,
                                     self.latency_cv, self.timeout,
                                     self.max_retries)

    # -- endpoint -------------------------------------------------------------
    def deliver(self, msg: Message, on_done: Optional[Callable] = None) -> None:
        self._queue.append((msg, on_done))
        if self.collector is not None:
            self.collector.gauge(f"{self.name}.tool_queue",
                                 len(self._queue), self.loop.now())
        self._pump()

    def _pump(self) -> None:
        while self._busy < self.concurrency and self._queue:
            msg, on_done = self._queue.pop(0)
            self._busy += 1
            t0 = self.loop.now()
            self._attempt(msg, on_done, t0, tries=0)

    def _attempt(self, msg, on_done, t0: float, tries: int) -> None:
        dur = self.sample_latency()
        if 0 < self.timeout < dur and tries < self.max_retries:
            # the attempt burns the whole timeout window, then retries
            def _retry(msg=msg, on_done=on_done, t0=t0, tries=tries):
                self.timeouts += 1
                self.retries += 1
                if self.collector is not None:
                    now = self.loop.now()
                    self.collector.gauge(f"{self.name}.tool_timeouts",
                                         self.timeouts, now)
                    self.collector.gauge(f"{self.name}.tool_retries",
                                         self.retries, now)
                self._attempt(msg, on_done, t0, tries + 1)

            self.loop.call_after(self.timeout, _retry)
            return
        if 0 < self.timeout < dur:
            # retry budget exhausted: fail open at the timeout so a
            # pathological tail can't wedge the workflow
            dur = self.timeout
            self.timeouts += 1
            if self.collector is not None:
                self.collector.gauge(f"{self.name}.tool_timeouts",
                                     self.timeouts, self.loop.now())

        def _fin(msg=msg, on_done=on_done, t0=t0):
            self._busy -= 1
            self.calls += 1
            if self.collector is not None:
                self.collector.observe(f"{self.name}.tool_latency",
                                       self.loop.now() - t0,
                                       self.loop.now())
            if on_done is not None:
                on_done(msg)
            self._pump()

        self.loop.call_after(dur, _fin)

    def load(self) -> float:
        return self._busy + len(self._queue)


def expected_tool_latency(latency: float, cv: float = 0.0,
                          timeout: float = 0.0,
                          max_retries: int = 1) -> float:
    """Expected wall clock of one tool call under the lognormal model.

    ``latency`` is the distribution's *median*; the heavy tail lifts the
    mean to ``latency * exp(sigma^2/2)``.  With a timeout, each attempt
    is capped (first order: ``min(mean, timeout)``) but a timed-out
    attempt burns the full window before retrying, adding
    ``P(X > timeout) * timeout`` per allowed retry."""
    if latency <= 0:
        return max(latency, 0.0)
    if cv <= 0:
        return latency if timeout <= 0 else min(latency, timeout)
    sigma2 = math.log1p(cv * cv)
    mean = latency * math.exp(0.5 * sigma2)
    if timeout <= 0:
        return mean
    # lognormal tail: P(X > T) = 1 - Phi(ln(T/median)/sigma)
    sigma = math.sqrt(sigma2)
    x = math.log(timeout / latency) / sigma
    p_tail = 0.5 * (1.0 - math.erf(x / math.sqrt(2.0)))
    return min(mean, timeout) + p_tail * timeout * max(max_retries, 0)
