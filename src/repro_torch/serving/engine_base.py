"""Engine core: request lifecycle + scheduler interplay shared by the
real-JAX engine and the virtual-clock sim engine.

Subclasses implement ``_exec_prefill`` / ``_exec_decode`` (returning step
duration and sampled tokens) and drive ``apply_*`` bookkeeping.  The
controller talks to every engine through the paper's two-function
``set()/reset()`` surface (Table 1) — ``knob_names`` is what the engine
advertises at registration.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Optional

from repro_torch.core.knobs import ControlSurface, KnobSpec
from repro_torch.core.types import Request, RequestState
from repro_torch.serving.scheduler import (PrefillWork, Scheduler,
                                           SchedulerConfig)


class EngineCore(ControlSurface):
    """Lifecycle + metrics + knobs; time/token mechanics in subclasses.

    Scheduler knobs are *delegated*: the engine advertises them on its
    card and forwards set/get to its scheduler's own ControlSurface —
    the uniform knob name maps onto the engine-internal API with no
    per-knob shim code (the paper's vLLM ``max_num_seqs`` example).
    """

    kind = "llm"
    CAPABILITIES = ("kv_transfer", "pause", "priority", "role")
    METRICS = ("queue_len", "num_running", "page_util", "step_time",
               "mean_step_time", "ttft", "latency", "tpt", "itl_p95",
               "throughput", "prefill_queue_tokens", "decode_slot_util",
               "suspended_seqs", "host_pages_used", "restore_hit_rate",
               "restore_ttft")

    ITL_WINDOW = 256                 # rolling inter-token-latency samples
    KNOB_SPECS = tuple(
        s.delegated("scheduler", clamp="_clamp_max_num_seqs")
        if s.name == "max_num_seqs" else s.delegated("scheduler")
        for s in Scheduler.KNOB_SPECS
    ) + (
        KnobSpec("temperature", kind="float", lo=0.0,
                 doc="sampling temperature; 0 = greedy"),
        KnobSpec("paused", kind="bool", on_change="_paused_changed",
                 doc="freeze the step loop (resume kicks it)"),
        KnobSpec("offload", kind="str",
                 choices=("off", "auto", "aggressive"),
                 doc="tool-call suspend policy: off pins the slot for the "
                     "tool's duration; auto offloads KV to the host tier "
                     "when predicted tool latency under queue pressure "
                     "beats the offload+restore cost; aggressive always "
                     "offloads"),
    )

    def __init__(self, name: str, model_name: str, sched_cfg: SchedulerConfig,
                 collector=None):
        self.name = name
        self.model_name = model_name
        self._physical_slots = sched_cfg.max_slots   # hardware capacity
        self.scheduler = Scheduler(sched_cfg, name=f"{name}.scheduler")
        self.collector = collector
        self.temperature = 0.0
        self.paused = False
        self.steps = 0
        self.prefill_steps = 0
        self.decode_steps = 0
        # measured step time (EWMA + total): the hardware-honesty gauge —
        # the calibration plane compares CostModel predictions against
        # this instead of trusting hand-set roofline constants
        self.mean_step_time = 0.0
        self.step_time_total = 0.0
        self.tokens_generated = 0
        # rolling inter-token-latency samples (per-request gaps between
        # consecutive emitted tokens): the decode-stall signal — a long
        # serialized prefill shows up here as a batch-wide ITL spike,
        # which is exactly what adaptive chunk policies trigger on
        self._itl_samples: deque[float] = deque(maxlen=self.ITL_WINDOW)
        self.finished: list[Request] = []
        self.on_finish: Optional[Callable[[Request, float], None]] = None
        self.on_token: Optional[Callable[[Request, int, float], None]] = None
        # tracing plane (wired by the owning pipeline/fabric): the
        # scheduler reports admit/preempt instants so segment spans
        # open/close at the exact lifecycle transitions
        self.tracer = None
        self.scheduler.on_admit = self._trace_admit
        self.scheduler.on_preempt = self._trace_preempt
        # -- tool-call plane: suspend/resume with tiered KV offload --------
        self.offload = "auto"
        self._host_store: dict[str, dict] = {}  # req_id -> extracted KV
        self.suspend_count = 0
        self.demote_count = 0
        self.restore_ttfts: list[float] = []    # post-tool first-token gaps
        self.scheduler.on_resume = self._resume_landed
        self.scheduler.demote_fn = self._demote_starved_pin
        # -- disaggregation plane hooks (wired by a DisaggPool) ------------
        self.disagg = None                          # owning handoff fabric
        self.kv_ready_fn: Optional[Callable[[Request], float]] = None
        self.on_prefill_progress: Optional[
            Callable[[Request, float], None]] = None
        self.on_prefill_done: Optional[Callable[[Request, float], None]] = None

    # ------------------------------------------------------------------ knobs
    def _clamp_max_num_seqs(self, value: int) -> int:
        return min(int(value), self.physical_slots())

    def _paused_changed(self, old, new) -> None:
        if not new:
            self.kick()

    def on_knob_set(self, name: str, old, new) -> None:
        if name == "role" and old != new:
            self._role_changed(old, new)
        self.kick()                     # new headroom may unblock work

    @property
    def role(self) -> str:
        return self.scheduler.cfg.role

    def _role_changed(self, old: str, new: str) -> None:
        """Runtime role flip.  Specialized roles only make sense inside
        a disaggregation fabric (something must carry sequences across
        the prefill/decode boundary); the fabric drains this engine's
        now-role-inconsistent work — no request is lost, and no decode
        ever runs on a prefill-role engine."""
        if new != "unified" and self.disagg is None:
            self.scheduler.cfg.role = old           # revert before failing
            raise RuntimeError(
                f"{self.name}: role {new!r} needs a disaggregation "
                "fabric attached (see serving/disagg.py)")
        if self.disagg is not None:
            self.disagg.on_role_change(self, old, new)

    def physical_slots(self) -> int:
        return self._physical_slots

    def attach_cache(self, cache):
        """Wire a PrefixCache (sharing this engine's PageAllocator) into
        the scheduler's admission path.  (`scheduler.cache` is the
        handle; the real Engine keeps `self.cache` for its KV pytree.)"""
        self.scheduler.cache = cache
        return cache

    def _surface_now(self) -> float:
        return self.now()               # audit stamps use engine time

    # ---------------------------------------------------------------- queue
    def submit(self, req: Request) -> None:
        if self.role == "decode":
            if self.disagg is None:
                # no fabric to bounce through: the waiting queue would
                # never drain (decode role blocks admission) — fail loud
                raise RuntimeError(
                    f"{self.name}: decode-role engine cannot take fresh "
                    "prompts without a disaggregation fabric")
            # decode engines take no fresh prompts: bounce back through
            # the fabric's router to a prefill-capable engine
            self.disagg.resubmit(req)
            return
        req.meta.pop("disagg_reroutes", None)   # accepted: reset loop guard
        # stamp arrival only once: a preemption victim bounced back
        # through the fabric re-enters submit, and restamping would
        # erase its pre-preemption queueing from every latency metric
        if not req.meta.get("arrived"):
            req.meta["arrived"] = True
            req.arrival_time = self.now()
        self._trace_submit(req)
        self.scheduler.submit(req)
        self._gauge("queue_len", self.scheduler.queue_len)
        self._gauge("prefill_queue_tokens",
                    self.scheduler.prefill_queue_tokens)
        self.kick()

    def admit_handoff(self, req: Request) -> bool:
        """Decode-side admission of a prefill→decode handoff: the
        generalized ``admit_direct`` path, gated on KV residency — the
        request is only admitted once its transferred state has landed
        (``kv_ready_fn``, usually ``KVTransferManager.handoff_wait``)."""
        if self.kv_ready_fn is not None and self.kv_ready_fn(req) > 0:
            return False
        if not self.scheduler.admit_direct(req):
            return False
        self._gauge("num_running", self.scheduler.num_running)
        self.kick()
        return True

    def receive_handoff(self, req: Request, state: dict) -> bool:
        """Full decode-side arrival: residency-gated admission plus the
        subclass's state install (sim: bookkeeping; real engine: the
        transferred KV slice lands in the granted slot).  The
        DisaggPool's arrival/backlog paths route through here, so sim
        and real engines share one handoff admission sequence."""
        if not self.admit_handoff(req):
            return False
        self.inject_state(req, state)
        return True

    def release_for_handoff(self, req: Request) -> None:
        """Source-side release at prefill completion (or a role flip):
        slot and pages free immediately; the request's state rides the
        handoff transfer to its decode engine."""
        self.scheduler.release_for_handoff(req)
        self._trace_seg(req, "handoff_wait")
        self._gauge("num_running", self.scheduler.num_running)

    # ------------------------------------- tool-call suspend/resume plane
    @property
    def restore_hit_rate(self) -> float:
        return self.scheduler.restore_hit_rate

    def restore_cost(self, req: Request) -> float:
        """Modeled host→HBM refill delay a resume pays before landing.
        0 on the real engine (the DMA rides ``inject_state``'s measured
        wall clock); the sim engine prices it from the CostModel."""
        return 0.0

    def _offload_pays(self, req: Request, latency_est: float) -> bool:
        """The ``auto`` rule: offload only when there is queue pressure
        for the freed capacity AND the predicted tool latency beats the
        round-trip spill cost (unknown estimates default to offloading
        under pressure — a pinned slot can never pay for itself)."""
        s = self.scheduler
        pressured = (s.queue_len > 0 or not s._free_slots
                     or bool(s._resume_pending))
        if not pressured:
            return False
        cm = getattr(self, "cm", None)
        if cm is None or latency_est <= 0:
            return True
        cost = (cm.offload_time(req.total_len)
                + cm.restore_time(req.total_len))
        return latency_est > 2.0 * cost

    def suspend_request(self, req: Request, offload: bool | None = None,
                        latency_est: float = 0.0) -> str:
        """Park a RUNNING request for an external wait (a tool call).
        ``offload=None`` lets the engine's ``offload`` knob decide; the
        KV is extracted *before* the scheduler frees its pages so the
        host copy rides the live block table.  Returns the tier:
        ``pin`` | ``host`` | ``drop`` | ``none``."""
        if offload is None:
            offload = (self.offload == "aggressive"
                       or (self.offload == "auto"
                           and self._offload_pays(req, latency_est)))
        want_host = offload and self.scheduler.alloc.host_room_for(req.req_id)
        state = self.extract_state(req) if want_host else None
        tier = self.scheduler.suspend(req, offload=offload)
        if tier == "none":
            return tier
        if tier == "host" and state is not None:
            self._host_store[req.req_id] = state
        self.suspend_count += 1
        req.meta["engine"] = self
        self._trace_seg(req, "suspended")
        self._suspend_gauges()
        self.kick()                     # the freed slot may admit work
        return tier

    def _demote_starved_pin(self) -> None:
        """Scheduler's pin-deadlock breaker: every slot-holder is a
        parked pin and work is waiting.  Demote the oldest pin to a real
        offload — this runs regardless of the ``offload`` knob, because
        it is a liveness guarantee, not a policy choice."""
        victim = self.scheduler.pin_starved()
        if victim is None:
            return
        want_host = self.scheduler.alloc.host_room_for(victim.req_id)
        state = self.extract_state(victim) if want_host else None
        tier = self.scheduler.offload_pinned(victim)
        if tier == "none":
            return
        if tier == "host" and state is not None:
            self._host_store[victim.req_id] = state
        self.demote_count += 1
        victim.meta["engine"] = self
        self._trace_seg(victim, "suspended")
        self._suspend_gauges()

    def resume_suspended(self, req: Request) -> str:
        """Bring a suspended request back: ``pin``/``hit`` land now (the
        scheduler's ``on_resume`` hook re-injects host KV), ``wait``
        queues it ahead of fresh admissions, ``recompute`` re-enters
        normal admission with the tail folded into the prompt."""
        out = self.scheduler.resume(req)
        self._suspend_gauges()
        self.kick()
        return out

    def migrate_suspended(self, req: Request, dest: "EngineCore") -> bool:
        """Cross-engine resume — cache-aware placement when the home
        engine is out of capacity: the host KV copy lands on ``dest``
        through the same ``admit_direct``/``inject_state`` sequence a
        disaggregation handoff uses.  Only offloaded-with-state suspends
        migrate (a pinned request already holds its home slot)."""
        if req.state != RequestState.SUSPENDED \
                or req in self.scheduler.running:
            return False
        state = self._host_store.get(req.req_id)
        if state is None:
            return False
        if not dest.scheduler.admit_direct(req):
            return False
        self.scheduler.forget_suspended(req)
        self._host_store.pop(req.req_id, None)
        dest.inject_state(req, state)
        dest.scheduler.resume_hits += 1
        req.meta["engine"] = dest
        self._suspend_gauges()
        dest._suspend_gauges()
        self.kick()
        dest.kick()
        return True

    def finish_suspended(self, req: Request) -> None:
        """Abandon a held-open suspended request (its continuation went
        to a sibling): release the parked state and account it done."""
        t = self.now()
        self._host_store.pop(req.req_id, None)
        self.scheduler.finish_suspended(req, t)
        self.finished.append(req)
        self._observe("latency", t - req.arrival_time)
        self._trace_finish(req, t)
        self._suspend_gauges()
        self.kick()

    def _resume_landed(self, req: Request, outcome: str) -> None:
        """Scheduler hook: a resume reached its terminal path."""
        state = self._host_store.pop(req.req_id, None)
        if outcome == "hit" and state is not None:
            self.inject_state(req, state)
        elif outcome == "pin":
            self._trace_seg(req, "decode")
        self._suspend_gauges()

    def _suspend_gauges(self) -> None:
        s = self.scheduler
        self._gauge("suspended_seqs", s.suspended_seqs)
        self._gauge("host_pages_used", s.alloc.host_pages)
        self._gauge("restore_hit_rate", s.restore_hit_rate)

    # subclasses provide the actual KV movement (sim: bookkeeping; real
    # engine: the paged_extract/paged_insert batch-1 bridge)
    def extract_state(self, req: Request) -> dict:
        raise NotImplementedError

    def inject_state(self, req: Request, state: dict) -> None:
        raise NotImplementedError

    # ------------------------------------------------------------- tracing
    # Segment spans tile [arrival, finish] exactly: each lifecycle
    # transition closes the open segment and opens the next at the same
    # timestamp, so the per-request decomposition sums to the measured
    # end-to-end latency (the acceptance check in tests/test_trace.py).
    def _trace_submit(self, req: Request) -> None:
        tr = self.tracer
        if tr is None:
            return
        if "traced" not in req.meta:
            tid = req.meta.get("task") or req.req_id
            traced = tr.decide(tid, tenant=req.tenant, stage=req.stage)
            req.meta["traced"] = traced
            if traced:
                parent = req.meta.get("trace_parent") or tr.task_span(tid)
                root = tr.begin(
                    f"request:{req.req_id}", tid, cat="request",
                    parent=parent, t=req.arrival_time, engine=self.name,
                    req_id=req.req_id, stage=req.stage or "",
                    tenant=req.tenant)
                req.meta["trace_root"] = root
                # throttle-hold spans recorded upstream by the router
                # (before a root existed) become children of the root
                for sp in req.meta.pop("trace_pre", []):
                    sp.parent_id = root.span_id
        self._trace_seg(req, "queue_wait")

    def _trace_seg(self, req: Request, name: str) -> None:
        """Roll the request's open segment over to ``name`` at now."""
        tr = self.tracer
        if tr is None or not req.meta.get("traced"):
            return
        t = self.now()
        cur = req.meta.get("trace_seg")
        if cur is not None and cur.t1 is None:
            if cur.name == name and cur.attrs.get("engine") == self.name:
                return                  # same segment, same engine: keep it
            tr.end(cur, t)
        root = req.meta.get("trace_root")
        if root is None or root.t1 is not None:
            req.meta["trace_seg"] = None
            return
        req.meta["trace_seg"] = tr.begin(name, root.trace_id, cat="segment",
                                         parent=root, t=t, engine=self.name,
                                         req_id=req.req_id)

    def _trace_admit(self, req: Request) -> None:
        # admit_direct lands straight in RUNNING (handoff/migration →
        # decode); _admit lands in PREFILL
        self._trace_seg(req, "decode" if req.state is RequestState.RUNNING
                        else "prefill")

    def _trace_preempt(self, req: Request) -> None:
        self._trace_seg(req, "queue_wait")

    def _trace_finish(self, req: Request, t: float) -> None:
        tr = self.tracer
        if tr is None or not req.meta.get("traced"):
            return
        tr.end(req.meta.get("trace_seg"), t)
        req.meta["trace_seg"] = None
        root = req.meta.get("trace_root")
        if root is not None:
            root.attrs["latency"] = t - req.arrival_time
            root.attrs["tokens"] = req.generated
            tr.end(root, t)

    # -------------------------------------------------------------- metrics
    def _gauge(self, name: str, value: float) -> None:
        if self.collector is not None:
            self.collector.gauge(f"{self.name}.{name}", value, self.now())

    def _observe(self, name: str, value: float) -> None:
        if self.collector is not None:
            self.collector.observe(f"{self.name}.{name}", value, self.now())

    def _step_metrics(self, duration: float) -> None:
        s = self.scheduler
        self._gauge("queue_len", s.queue_len)
        self._gauge("num_running", s.num_running)
        self._gauge("page_util", s.alloc.utilization)
        self._observe("step_time", duration)
        self.step_time_total += duration
        self.mean_step_time = (duration if self.steps <= 1 else
                               0.9 * self.mean_step_time + 0.1 * duration)
        self._gauge("mean_step_time", self.mean_step_time)
        self._gauge("tokens_total", self.tokens_generated)
        self._gauge("itl_p95", self.itl_p95)
        self._gauge("prefill_queue_tokens", s.prefill_queue_tokens)
        self._gauge("decode_slot_util", s.decode_slot_util)

    # ------------------------------------------------------ plan bookkeeping
    def apply_prefill(self, works: list[PrefillWork], first_tokens,
                      t: float) -> None:
        """first_tokens: per-work sampled token or None (chunk not final)."""
        self.prefill_steps += 1
        for work, tok in zip(works, first_tokens):
            r = work.req
            if r not in self.scheduler.running:
                continue          # preempted / drained mid-flight
            r.prefilled += work.chunk
            # fairness accounting charges actually-processed tokens
            self.scheduler.charge(r, work.chunk, t)
            if r.prefilled < r.prompt_len:
                if self.on_prefill_progress is not None:
                    # chunk-streamed handoff: push the KV computed so far
                    # while the rest of the prompt is still prefilling
                    self.on_prefill_progress(r, t)
                continue
            r.state = RequestState.RUNNING
            self.scheduler.commit_prefix(r)
            if self.role != "prefill":
                # prefill-role engines skip the zero-length decode span:
                # their prefill segment rolls directly to handoff_wait
                self._trace_seg(r, "decode")
            if tok is not None:
                self._emit_token(r, int(tok), t)
                if r.first_token_time is None:
                    r.first_token_time = t
                    # one ttft sample per request: a preempted victim
                    # resets first_token_time (its output restarts) but
                    # must not contribute a second observation
                    if not r.meta.get("ttft_observed"):
                        r.meta["ttft_observed"] = True
                        self._observe("ttft", t - r.arrival_time)
                        if self.scheduler.tenants is not None:
                            self.scheduler.tenants.observe_ttft(
                                r.tenant, t - r.arrival_time, t)
            if r.state is RequestState.RUNNING and self.role == "prefill":
                if self.on_prefill_done is None:
                    # no handoff sink: the sequence could never decode
                    # (prefill role plans no DECODE steps) — fail loud
                    # instead of holding its slot forever
                    raise RuntimeError(
                        f"{self.name}: prefill-role engine finished "
                        f"{r.req_id} with no disaggregation fabric "
                        "attached to hand it to")
                # first token came from prefill; the decode tail belongs
                # to the paired decode engine — release and hand off
                self.on_prefill_done(r, t)

    def apply_decode(self, reqs: list[Request], tokens, t: float) -> None:
        self.decode_steps += 1
        for r, tok in zip(reqs, tokens):
            if r.state != RequestState.RUNNING \
                    or r not in self.scheduler.running:
                # preempted or handed off mid-flight — the state check
                # alone is not enough: a migrated request can already be
                # RUNNING again on its *destination* engine by the time
                # this stale step lands, and emitting here would decode
                # on an engine that no longer owns the sequence
                continue
            self._emit_token(r, int(tok), t)

    @property
    def itl_p95(self) -> float:
        """Windowed p95 inter-token latency over the engine's recent
        emissions (0.0 until two tokens of one request have landed)."""
        if not self._itl_samples:
            return 0.0
        xs = sorted(self._itl_samples)
        return xs[min(int(0.95 * len(xs)), len(xs) - 1)]

    def _note_itl(self, r: Request, t: float) -> None:
        prev = r.meta.get("last_token_t")
        r.meta["last_token_t"] = t
        if prev is not None and t >= prev:
            self._itl_samples.append(t - prev)

    def _emit_token(self, r: Request, tok: int, t: float) -> None:
        self._note_itl(r, t)
        r.generated += 1
        r.output_tokens.append(tok)
        self.tokens_generated += 1
        self.scheduler.charge(r, 1, t)
        t0 = r.meta.pop("post_tool_t0", None)
        if t0 is not None:
            # post-tool TTFT: tool completion -> first resumed token
            # (restore/recompute latency + any capacity wait)
            self._observe("restore_ttft", t - t0)
            self.restore_ttfts.append(t - t0)
        if self.on_token is not None:
            self.on_token(r, tok, t)
        if r.done:
            if r.meta.pop("hold_open", False):
                # the *call* is complete but the sequence lives on: park
                # it for the tool's duration instead of finishing, so the
                # post-tool turn resumes on a warm cache.  Stage
                # bookkeeping still advances through on_finish.
                self.suspend_request(
                    r, latency_est=float(r.meta.get("tool_latency_est", 0.0)))
                if self.on_finish is not None:
                    self.on_finish(r, t)
                return
            self.scheduler.finish(r, t)
            self.finished.append(r)
            self._observe("latency", t - r.arrival_time)
            if r.generated > 1 and r.first_token_time is not None:
                tpt = (t - r.first_token_time) / max(r.generated - 1, 1)
                self._observe("tpt", tpt)
            self._trace_finish(r, t)
            if self.on_finish is not None:
                self.on_finish(r, t)

    # ----------------------------------------------------------- abstract
    def now(self) -> float:
        raise NotImplementedError

    def kick(self) -> None:
        """Called when new work may be available."""

    @property
    def busy(self) -> bool:
        return (self.scheduler.queue_len > 0
                or self.scheduler.num_running > 0)

    # current load signal used by routing policies
    def load(self) -> float:
        return self.scheduler.queue_len + self.scheduler.num_running
