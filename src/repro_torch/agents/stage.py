"""Typed workflow stages + their runtime (the workflow graph plane's
data-plane half; the graph structure itself lives in agents/graph.py).

``StageSpec`` declares one stage of an agent DAG: its kind (chain,
fan-out, fan-in/join, branch, tool), how many tokens it reads/emits,
and which model-size tier its calls should run on.

``StageAgent`` executes a stage.  It is a channel endpoint (upstream
stages feed it through ordinary data-plane ``Channel``s), collects each
task's inputs (fan-in waits for all — or ``join_k`` — predecessors,
bounded by ``join_timeout``), then issues the stage's engine calls
through the pipeline's shared, tier-labelled engine pool via the
router.  Every agent registers as a ``stage.<name>`` controllable:

* knobs — ``model_tier`` (Aragog-style per-stage model choice the
  ``stage_aware`` router honors), ``deadline_slack`` (scales the
  edge-propagated deadline), ``join_timeout``, ``width``;
* gauges — ``stage.<name>.latency`` / ``.p95`` / ``.queue``, so intent
  programs can write ``on stage reviewer.p95 > 2 => set stage
  reviewer.model_tier small``.

Critical-path scheduling: each engine request is stamped with the
task's edge-propagated ``deadline`` (finish-by time for this stage) and
a ``cp_remaining`` estimate; the scheduler orders EDF-within-priority
with a longest-remaining-path tie-break, and a task that is *behind*
its critical-path schedule gets a one-level priority boost on
admission.
"""
from __future__ import annotations

import enum
import math
import zlib
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.core.knobs import ControlSurface, KnobSpec
from repro_torch.core.metrics import RollingStat
from repro_torch.core.types import Message, Priority, Request, RequestState
from repro_torch.sim.clock import EventLoop


class StageKind(str, enum.Enum):
    CHAIN = "chain"          # one LLM call per task
    FAN_OUT = "fan_out"      # `width` parallel LLM calls per task
    JOIN = "join"            # fan-in barrier (join_k / join_timeout)
    BRANCH = "branch"        # one call, output routed to ONE successor
    TOOL = "tool"            # non-LLM tool call (fixed latency)


@dataclass
class StageSpec:
    """Declarative description of one workflow stage."""

    name: str
    kind: StageKind = StageKind.CHAIN
    model_tier: str = "large"        # default tier for this stage's calls
    width: int = 4                   # FAN_OUT: parallel calls per task
    join_k: int = 0                  # JOIN: inputs needed (0 = all preds)
    join_timeout: float = 0.0        # JOIN: max wait for stragglers (0 = forever)
    prompt_tokens: int = 96          # stage-local instruction prompt
    out_tokens: int = 64             # tokens generated per call
    tool_latency: float = 0.05       # TOOL: median per-call latency
    tool_latency_cv: float = 0.0     # TOOL: lognormal tail (0 = fixed)
    tool_timeout: float = 0.0        # TOOL: per-attempt cap (0 = none)
    deadline_slack: float = 0.0      # 0 = inherit the pipeline default
    branch_fn: Optional[Callable[[str], int]] = None  # task_id -> succ index


@dataclass
class _StageRun:
    """Per-task state while the task is at (or queued for) this stage."""

    task: object                     # GraphTask
    tokens: int = 0                  # input tokens arrived
    inputs_done: int = 0             # predecessors that sent task_end
    dispatched: bool = False
    calls_open: int = 0
    out_tokens: int = 0
    started_at: float = 0.0
    timer: object = None             # join-timeout event
    trace_span: object = None        # open stage span (tracing plane)


class EngineWorker:
    """Router endpoint adapting one engine of the shared pool to stage
    calls: messages carry a prebuilt ``Request`` whose ``meta`` holds
    the per-call completion callbacks (engines are shared across
    stages, so per-engine ``on_finish`` must dispatch per request)."""

    def __init__(self, engine, tier: str):
        self.engine = engine
        self.tier = tier
        self.name = engine.name
        engine.on_finish = self._finish
        engine.on_token = self._token

    def deliver(self, msg: Message) -> None:
        self.engine.submit((msg.payload or {})["request"])

    def _finish(self, req: Request, t: float) -> None:
        cb = req.meta.get("on_finish")
        if cb is not None:
            cb(req, t)

    def _token(self, req: Request, tok: int, t: float) -> None:
        cb = req.meta.get("on_token")
        if cb is not None:
            cb(req, tok, t)

    def load(self) -> float:
        return self.engine.load()


class StageAgent(ControlSurface):
    """Executes one stage of a workflow graph (see module docstring)."""

    kind = "stage"
    CAPABILITIES = ("tier", "deadline")
    METRICS = ("latency", "p95", "queue")
    KNOB_SPECS = (
        KnobSpec("model_tier", kind="str", clamp="_clamp_tier",
                 on_change="_tier_changed",
                 doc="model-size tier this stage's calls route to "
                     "(stage_aware router policy)"),
        KnobSpec("deadline_slack", kind="float", lo=0.0,
                 doc="deadline = submit + slack x critical-path work "
                     "through this stage"),
        KnobSpec("join_timeout", kind="float", lo=0.0,
                 doc="fan-in: max seconds to wait for missing inputs "
                     "(0 = wait forever)"),
        KnobSpec("width", kind="int", lo=1, on_change="_width_changed",
                 doc="FAN_OUT: parallel calls per task"),
    )

    def __init__(self, spec: StageSpec, loop: EventLoop, pipeline,
                 collector=None):
        self.spec = spec
        self.name = f"stage.{spec.name}"
        self.loop = loop
        self.p = pipeline                # WorkflowPipeline
        self.collector = collector
        # knob-backed attributes (defaults from the spec / pipeline)
        self.model_tier = spec.model_tier
        self.deadline_slack = (spec.deadline_slack
                               or pipeline.cfg.deadline_slack)
        self.join_timeout = spec.join_timeout
        self.width = spec.width
        self.tool = None                 # ToolAgent, attached for TOOL kind
        self.succs: list[tuple[str, object]] = []   # (stage name, Channel)
        self.n_preds = 0                 # wired by the pipeline
        self._runs: dict[str, _StageRun] = {}
        self._done_ids: set[str] = set()
        self._lat = RollingStat(128)
        self.calls = 0
        if collector is not None:
            collector.describe(
                f"{self.name}.latency",
                "Stage service latency in seconds (input-complete to "
                "output-forwarded); lower is better.")

    # -- knob hooks ---------------------------------------------------------
    def _clamp_tier(self, value: str) -> str:
        tiers = self.p.tier_names()
        if tiers and value not in tiers:
            raise ValueError(f"{self.name}: unknown tier {value!r} "
                             f"(have {tiers})")
        return value

    def _tier_changed(self, old, new) -> None:
        self.p.on_stage_retier(self.spec.name)   # cp estimates shift

    def _width_changed(self, old, new) -> None:
        self.p.on_stage_retier(self.spec.name)

    # -- input side ---------------------------------------------------------
    def _need_inputs(self) -> int:
        need = max(self.n_preds, 1)
        if self.spec.kind is StageKind.JOIN and self.spec.join_k > 0:
            need = min(self.spec.join_k, need)
        return need

    def inject(self, task, tokens: int) -> None:
        """Source-stage entry: the pipeline feeds the task directly."""
        run = self._runs.setdefault(task.task_id, _StageRun(task))
        run.tokens += tokens
        run.inputs_done += 1
        self._dispatch(run)

    def deliver(self, msg: Message) -> None:
        pay = msg.payload or {}
        tid = msg.task_id
        if tid in self._done_ids or (tid in self._runs
                                     and self._runs[tid].dispatched):
            # straggler input after a join timeout already fired (or the
            # stage finished): absorb its activation so the task's
            # completion refcount still drains
            if pay.get("task_end"):
                task = pay.get("task")
                run = self._runs.get(tid)
                if task is None and run is not None:
                    task = run.task
                if task is not None:
                    self.p.task_drop(task)
            return
        run = self._runs.get(tid)
        if run is None:
            run = self._runs[tid] = _StageRun(pay.get("task"))
        run.tokens += msg.tokens
        if not pay.get("task_end"):
            return
        run.inputs_done += 1
        if run.inputs_done >= self._need_inputs():
            self._dispatch(run)
        elif run.timer is None and self.join_timeout > 0:
            run.timer = self.loop.call_after(
                self.join_timeout, lambda r=run: self._join_timeout(r))
        self._gauge_queue()

    def _join_timeout(self, run: _StageRun) -> None:
        if run.dispatched or run.task.task_id not in self._runs:
            return
        if run.inputs_done >= 1:         # proceed with what arrived
            self._dispatch(run)

    # -- dispatch -----------------------------------------------------------
    def _deadline_and_cp(self, task) -> tuple[float, float]:
        if not self.p.cp_enabled() or task.deadline == math.inf:
            return math.inf, 0.0
        cp_rem = self.p.cp_remaining(self.spec.name)
        through = self.p.cp_through(self.spec.name)
        return task.submitted_at + self.deadline_slack * through, cp_rem

    def _boosted(self, task, cp_rem: float) -> Priority:
        """Longest-remaining-path boost on admission: a task whose
        remaining critical path no longer fits before its deadline is
        behind schedule — bump it one priority level."""
        prio = task.priority
        if (self.p.cp_enabled() and task.deadline < math.inf
                and self.loop.now() + cp_rem > task.deadline
                and int(prio) < int(Priority.HIGH)):
            prio = Priority(int(prio) + 1)
        return prio

    def _trace_run(self, run: _StageRun) -> None:
        """Open the stage's span for a task: a child of the task root,
        and the parent every engine call made for this run links under
        (the DAG edges the trace report's critical path walks)."""
        tr = getattr(self.p, "tracer", None)
        if tr is None or run.task is None:
            return
        tid = run.task.task_id
        if not tr.decide(tid, stage=self.spec.name):
            return
        run.trace_span = tr.begin(
            f"stage:{self.spec.name}", tid, cat="stage",
            parent=tr.task_span(tid), stage=self.spec.name,
            kind=self.spec.kind.value, inputs=run.inputs_done)

    def _dispatch(self, run: _StageRun) -> None:
        run.dispatched = True
        run.started_at = self.loop.now()
        self._trace_run(run)
        if run.timer is not None:
            self.loop.cancel(run.timer)
            run.timer = None
        self.p.task_merge(run.task, run.inputs_done)
        if self.spec.kind is StageKind.TOOL:
            self._dispatch_tool(run)
        else:
            self._dispatch_llm(run)
        self._gauge_queue()

    def _dispatch_tool(self, run: _StageRun) -> None:
        # the tool is now in flight: its feeders' held requests are no
        # longer demotable — their resume is what frees the slot
        for r in run.task.meta.get("held", ()):
            r.meta.pop("tool_blocked", None)
        msg = Message(src=self.name, dst=self.tool.name, payload={},
                      tokens=run.tokens, task_id=run.task.task_id)
        run.calls_open = 1
        self.tool.deliver(msg, on_done=lambda m, r=run: self._tool_done(r))

    def _dispatch_llm(self, run: _StageRun) -> None:
        task = run.task
        parts = self.width if self.spec.kind is StageKind.FAN_OUT else 1
        share = max((run.tokens + parts - 1) // parts, 0)
        deadline, cp_rem = self._deadline_and_cp(task)
        prio = self._boosted(task, cp_rem)
        held = self._take_held(task, parts)
        if held is not None:
            self._continue_held(run, held, share, prio, deadline, cp_rem)
            return
        hold_est = self.p.tool_hold_est(self.spec.name)
        run.calls_open = parts
        for i in range(parts):
            req = Request(
                prompt_len=self.spec.prompt_tokens + share,
                max_new_tokens=self.spec.out_tokens,
                priority=prio, deadline=deadline, stage=self.spec.name,
                meta={"stage": self.spec.name, "task": task.task_id,
                      "part": i, "cp_remaining": cp_rem,
                      "trace_parent": run.trace_span,
                      "prefix": ((f"stage:{self.spec.name}",
                                  self.spec.prompt_tokens),
                                 (f"in:{task.task_id}", share)),
                      "on_finish":
                          lambda r, t, run=run: self._call_done(run, r, t)})
            if hold_est is not None:
                # this stage feeds a TOOL stage: keep the sequence alive
                # at completion so the post-tool turn resumes its KV
                # instead of re-prefilling the whole transcript
                req.meta["hold_open"] = True
                req.meta["tool_latency_est"] = hold_est
            self.p.route_call(Message(
                src=self.name, dst="pool",
                payload={"request": req, "tier": self.model_tier,
                         "session": task.session},
                tokens=share, priority=prio, task_id=task.task_id,
                created_at=self.loop.now()))
            self.calls += 1

    # -- tool-call suspend/resume continuations ------------------------------
    def _take_held(self, task, parts: int):
        """Claim the task's held-open (suspended) request if this stage
        can decode straight on top of its live KV: single call, same
        tier as the engine parking the cache.  Held requests this stage
        cannot use are released — the stage falls back to fresh calls."""
        meta = getattr(task, "meta", None)
        if not meta or "held" not in meta:
            return None
        held = meta.pop("held")
        keep = None
        if parts == 1:
            live = [r for r in held
                    if r.state == RequestState.SUSPENDED
                    and self.p.engine_tier(r) == self.model_tier]
            if live:
                keep = max(live, key=lambda r: r.total_len)
        for r in held:
            if r is not keep:
                self._release_held(r)
        return keep

    def _release_held(self, req: Request) -> None:
        eng = req.meta.get("engine")
        if eng is not None and req.state == RequestState.SUSPENDED:
            eng.finish_suspended(req)

    def _continue_held(self, run: _StageRun, req: Request, share: int,
                       prio: Priority, deadline: float,
                       cp_rem: float) -> None:
        """Resume the suspended pre-tool request in place of a fresh
        call: the tool result arrives as ``share`` appended prompt
        tokens (still prefilled — only the pre-tool context is warm),
        then this stage's out_tokens decode on top of it."""
        run.calls_open = 1
        req.meta.pop("tool_blocked", None)
        req.meta["continued_base"] = req.generated
        req.prompt_len += share
        req.available = req.prompt_len
        req.max_new_tokens += self.spec.out_tokens
        req.priority = prio
        req.deadline = deadline
        req.stage = self.spec.name
        req.meta["stage"] = self.spec.name
        req.meta["task"] = run.task.task_id
        req.meta["cp_remaining"] = cp_rem
        req.meta["on_finish"] = (
            lambda r, t, run=run: self._call_done(run, r, t))
        hold_est = self.p.tool_hold_est(self.spec.name)
        if hold_est is not None:
            req.meta["hold_open"] = True
            req.meta["tool_latency_est"] = hold_est
        req.meta["post_tool_t0"] = self.loop.now()
        self.calls += 1
        self.p.resume_request(req)

    # -- completion ---------------------------------------------------------
    def _tool_done(self, run: _StageRun) -> None:
        self._prune_held(run.task)
        run.calls_open = 0
        run.out_tokens = run.tokens       # tools pass content through
        self._complete(run, self.loop.now())

    def _prune_held(self, task) -> None:
        """The tool returned: keep only the richest-context held request
        (it carries the most reusable KV into the post-tool turn) and
        release the rest — e.g. only one of pro/con survives a join."""
        meta = getattr(task, "meta", None)
        if not meta or "held" not in meta:
            return
        live = [r for r in meta["held"]
                if r.state == RequestState.SUSPENDED]
        if not live:
            meta.pop("held", None)
            return
        keep = max(live, key=lambda r: r.total_len)
        for r in live:
            if r is not keep:
                self._release_held(r)
        meta["held"] = [keep]

    def _call_done(self, run: _StageRun, req: Request, t: float) -> None:
        run.calls_open -= 1
        run.out_tokens += req.generated - req.meta.pop("continued_base", 0)
        if req.state == RequestState.SUSPENDED:
            # the engine held the sequence open for our TOOL successor:
            # park it on the task until the post-tool stage claims it
            run.task.meta.setdefault("held", []).append(req)
            if self.p.tool_fanin(self.spec.name) > 1:
                # the TOOL this hold targets waits on *sibling* stages
                # whose calls still need slots: a pinned hold here can
                # wedge a fully parked engine (debate's pro holds the
                # slot its own con needs), so flag it demotable for the
                # scheduler's liveness rung until the tool dispatches
                req.meta["tool_blocked"] = True
        if run.calls_open <= 0:
            self._complete(run, t)

    def _complete(self, run: _StageRun, t: float) -> None:
        task = run.task
        self._runs.pop(task.task_id, None)
        self._done_ids.add(task.task_id)
        if run.trace_span is not None:
            run.trace_span.attrs["out_tokens"] = run.out_tokens
            getattr(self.p, "tracer").end(run.trace_span, t)
            run.trace_span = None
        lat = t - run.started_at
        self._lat.add(lat)
        if self.collector is not None:
            self.collector.observe(f"{self.name}.latency", lat, t)
            self.collector.gauge(f"{self.name}.p95",
                                 self._lat.pctl(0.95), t)
        self._gauge_queue()
        succs = self.succs
        if self.spec.kind is StageKind.BRANCH and len(succs) > 1:
            idx = (self.spec.branch_fn(task.task_id)
                   if self.spec.branch_fn is not None
                   else zlib.crc32(task.task_id.encode()))
            succs = [succs[idx % len(succs)]]
        for _, ch in succs:
            ch.begin_task(task.task_id, session=task.session,
                          speculative=task.speculative, task=task)
            ch.push_tokens(task.task_id, run.out_tokens)
            ch.end_unit(task.task_id)
            ch.end_task(task.task_id)
        self.p.task_advance(task, forwarded=len(succs))

    # -- introspection ------------------------------------------------------
    def _gauge_queue(self) -> None:
        if self.collector is not None:
            q = sum(1 for r in self._runs.values() if not r.dispatched)
            q += sum(r.calls_open for r in self._runs.values())
            self.collector.gauge(f"{self.name}.queue", q, self.loop.now())

    def p95(self) -> float:
        return self._lat.pctl(0.95)

    def load(self) -> float:
        return float(len(self._runs))
