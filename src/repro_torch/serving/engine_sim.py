"""Sim engine: identical scheduler/lifecycle semantics, virtual-clock
timing from the roofline cost model.

Every Fig-3/6/7 benchmark runs on this substrate: step durations are the
CostModel's three-term roofline for the *paper-scale* agent (7B-class by
default), so load sweeps are deterministic, hardware-honest, and fast on
the CPU container.  The controller cannot tell sim and real engines apart
— both expose the same knobs/metrics/transfer surface.
"""
from __future__ import annotations


from repro_torch.core.types import Request, RequestState
from repro_torch.serving.engine_base import EngineCore
from repro_torch.serving.scheduler import SchedulerConfig, StepKind
from repro_torch.sim.clock import EventLoop
from repro_torch.sim.costmodel import CostModel


class SimEngine(EngineCore):
    def __init__(self, loop: EventLoop, costmodel: CostModel,
                 sched_cfg: SchedulerConfig, name: str = "sim-engine",
                 collector=None):
        super().__init__(name, costmodel.cfg.name, sched_cfg, collector)
        self.loop = loop
        self.cm = costmodel
        self._stepping = False
        self.busy_time = 0.0

    def now(self) -> float:
        return self.loop.now()

    # ------------------------------------------------------------------ drive
    def kick(self) -> None:
        if not self._stepping and not self.paused:
            self._begin_step()

    def _begin_step(self) -> None:
        plan = self.scheduler.plan_step()
        if plan.kind == StepKind.IDLE:
            return
        self._stepping = True
        if plan.kind == StepKind.PREFILL:
            # chunks cover only uncached tokens (the scheduler starts
            # ``prefilled`` past the cached prefix), so prefix-cache hits
            # shrink step time; the resident context still costs KV reads
            dur = sum(self.cm.prefill_time(w.chunk, context=w.req.prefilled)
                      for w in plan.prefills)
            self.loop.call_after(dur, lambda: self._finish_prefill(plan, dur))
        elif plan.kind == StepKind.MIXED:
            # fused prefill-chunk + decode-batch step, priced by the
            # CostModel's mixed roofline (weights read once) — the sim
            # substrate sees the same semantics as the real engine's
            # jitted mixed step
            live = [r for r in plan.decodes
                    if self.scheduler.ensure_decode_capacity(r)]
            w = plan.prefills[0]
            ctx = (sum(r.total_len for r in live) / len(live)
                   if live else 0.0)
            dur = self.cm.mixed_time(w.chunk, w.req.prefilled,
                                     len(live), ctx)
            self.loop.call_after(
                dur, lambda: self._finish_mixed(plan, live, dur))
        else:
            live = [r for r in plan.decodes
                    if self.scheduler.ensure_decode_capacity(r)]
            if not live:
                self._stepping = False
                return
            ctx = sum(r.total_len for r in live) / len(live)
            dur = self.cm.decode_time(len(live), ctx)
            self.loop.call_after(dur, lambda: self._finish_decode(live, dur))

    def _finish_prefill(self, plan, dur: float) -> None:
        firsts = []
        for w in plan.prefills:
            final = (w.req.prefilled + w.chunk) >= w.req.prompt_len
            firsts.append(w.req.generated if final else None)  # synthetic id
        self.apply_prefill(plan.prefills, firsts, self.now())
        self._end_step(dur)

    def _finish_mixed(self, plan, live, dur: float) -> None:
        firsts = []
        for w in plan.prefills:
            final = (w.req.prefilled + w.chunk) >= w.req.prompt_len
            firsts.append(w.req.generated if final else None)
        self.apply_prefill(plan.prefills, firsts, self.now())
        if live:
            self.apply_decode(live, [r.generated for r in live], self.now())
        self._end_step(dur)

    def _finish_decode(self, reqs, dur: float) -> None:
        toks = [r.generated for r in reqs]        # synthetic token ids
        self.apply_decode(reqs, toks, self.now())
        self._end_step(dur)

    def _end_step(self, dur: float) -> None:
        self.steps += 1
        self.busy_time += dur
        self._step_metrics(dur)
        self._stepping = False
        if not self.paused:
            self._begin_step()

    # ------------------------------------------------------------ kv transfer
    def extract_state(self, req: Request) -> dict:
        return {"cache": None, "last_token": 0,
                "nbytes": self.cm.kv_transfer_bytes(req.total_len)}

    def inject_state(self, req: Request, state: dict) -> None:
        # continuation resumes may carry appended, un-prefilled prompt
        # tokens (a tool result): keep ``prefilled`` where the suspend
        # left it and land in PREFILL so their ingestion is charged;
        # handoffs arrive fully prefilled and go straight to RUNNING
        req.prefilled = min(req.prefilled, req.prompt_len)
        req.state = (RequestState.PREFILL
                     if req.prefilled < req.prompt_len
                     else RequestState.RUNNING)
        self.kick()

    # ----------------------------------------------------- tool-call plane
    def restore_cost(self, req: Request) -> float:
        """Virtual-clock price of the host→HBM refill a warm resume pays
        (pinned or recompute resumes move no host KV)."""
        if req.req_id in self._host_store \
                or self.scheduler.alloc.is_suspended(req.req_id):
            return self.cm.restore_time(req.total_len)
        return 0.0
