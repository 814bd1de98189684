"""Continuous-batching scheduler (shared by the real and sim engines).

Each engine step executes one ``StepPlan``:
  * PREFILL — one or more waiting/preempted requests get (a chunk of)
    their prompt processed, bounded by ``max_batch_tokens``;
  * DECODE  — every running sequence advances one token (fixed-shape
    batched step on TPU).

Admission takes page capacity (PageAllocator) and the priority floor into
account; decode-time page growth failures preempt the lowest-priority
youngest sequence (its pages are freed, the request re-queues — or the
controller migrates it to another instance via kv_transfer first).

When a ``PrefixCache`` (serving/prefix_cache.py) is attached, admission
consults the prefix index first: resident blocks are acquired (shared,
refcounted pages), ``req.prefilled`` starts past the cached prefix, and
only *uncached* prompt tokens are charged against ``max_batch_tokens``
and allocated privately.  New blocks are registered when prefill
completes (``commit_prefix``); capacity pressure evicts idle cache
blocks before preempting running sequences.

Who gets served next is itself a programmable attribute (the tenancy
plane): the waiting-queue order, the admission gate and the preemption
victim rule live in a pluggable ``QueueDiscipline`` selected by the
``discipline`` knob — ``fifo_priority`` reproduces the classic
priority/EDF order bit-exactly (the default), ``weighted_fair`` adds
start-time virtual-time fairness across tenants (weights from an
attached ``TenantDirectory``), with priority/EDF preserved *within* a
tenant.  Engines charge actually-processed prefill+decode tokens back
through ``Scheduler.charge`` so the fair-share accounting tracks real
work, not request counts.

All the ``set()``-able knobs the paper's Table-1 interface exposes live
here: max_num_seqs, max_batch_tokens, prefill_chunk, admit_priority_min,
discipline.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core.knobs import ControlSurface, KnobSpec
from repro_torch.core.types import Request, RequestState
from repro_torch.serving.kv_cache import PageAllocator


class StepKind(str, enum.Enum):
    PREFILL = "prefill"
    DECODE = "decode"
    MIXED = "mixed"           # all live decodes + one chunked prefill
    IDLE = "idle"


@dataclass
class PrefillWork:
    req: Request
    chunk: int            # prompt tokens to process this step


@dataclass
class StepPlan:
    kind: StepKind
    prefills: list[PrefillWork] = field(default_factory=list)
    decodes: list[Request] = field(default_factory=list)


class QueueDiscipline:
    """Pluggable who-is-served-next policy: the waiting-queue sort key,
    the preemption victim rule, and (for fairness disciplines) the
    served-token accounting.  ``attach`` hands it the owning scheduler;
    ``dynamic`` disciplines have keys that move between submits (served
    tokens shift virtual time), so the scheduler re-sorts at every
    admission pass instead of only on enqueue."""

    name = "discipline"
    dynamic = False

    def attach(self, scheduler: "Scheduler") -> None:
        self.sched = scheduler

    def on_submit(self, req: Request) -> None:
        """Called before ``req`` joins the waiting queue."""

    def key(self, req: Request):
        """Ascending waiting-queue sort key."""
        raise NotImplementedError

    def victim_key(self, req: Request):
        """``min()`` over RUNNING candidates picks the preemption
        victim."""
        raise NotImplementedError

    def charge(self, req: Request, tokens: int) -> None:
        """Actual prefill/decode tokens processed for ``req``."""


class FifoPriorityDiscipline(QueueDiscipline):
    """The classic (pre-tenancy) order, bit-exact: priority first;
    within a priority class EDF over the workflow plane's
    edge-propagated deadlines, then longest-remaining-critical-path,
    then FIFO.  Requests without a graph behind them keep deadline=inf
    / cp=0, so the order degenerates to (-priority, arrival) for every
    pre-graph caller.  Preemption evicts the lowest-priority youngest
    running sequence."""

    name = "fifo_priority"

    def key(self, req: Request):
        return (-int(req.priority), req.deadline,
                -float(req.meta.get("cp_remaining", 0.0)), req.arrival_time)

    def victim_key(self, req: Request):
        return (int(req.priority), -req.arrival_time)


class WeightedFairDiscipline(QueueDiscipline):
    """Start-time virtual-time fair queueing over tenants (SFQ-style).

    Each tenant accrues virtual time at ``served_tokens / weight``
    (weights from the scheduler's attached ``TenantDirectory``; 1.0
    when none).  The waiting queue orders by tenant virtual time —
    the least-served-relative-to-weight tenant admits first — with the
    full priority/EDF/critical-path/FIFO order preserved *within* a
    tenant.  An idle tenant re-enters at the current virtual floor
    (start-time rule): sleeping never banks credit, and stale debt from
    a past solo-busy period is forgiven.  Preemption picks victims from
    the most-over-share tenant first."""

    name = "weighted_fair"
    dynamic = True

    def __init__(self):
        self.vtime: dict[str, float] = {}

    def _weight(self, tenant: str) -> float:
        d = getattr(self.sched, "tenants", None)
        if d is None:
            return 1.0
        return max(d.weight(tenant), 1e-3)

    def on_submit(self, req: Request) -> None:
        t = req.tenant
        active = {r.tenant for r in self.sched.waiting}
        active.update(r.tenant for r in self.sched.running)
        if t in active:
            # tenant already has queued/running work: its virtual time
            # is live — re-flooring here would erase an underserved
            # tenant's accrued lag (and neutralize the weight knob)
            return
        # idle -> active: re-enter AT the floor, both directions —
        # sleeping banks no credit, and a past solo-heavy tenant's
        # stale virtual-time debt is forgiven (fairness is about the
        # current backlogged period, not history)
        floor = min((self.vtime[u] for u in active if u in self.vtime),
                    default=0.0)
        self.vtime[t] = floor

    def key(self, req: Request):
        return (self.vtime.get(req.tenant, 0.0),
                -int(req.priority), req.deadline,
                -float(req.meta.get("cp_remaining", 0.0)), req.arrival_time)

    def victim_key(self, req: Request):
        return (-self.vtime.get(req.tenant, 0.0),
                int(req.priority), -req.arrival_time)

    def charge(self, req: Request, tokens: int) -> None:
        t = req.tenant
        self.vtime[t] = (self.vtime.get(t, 0.0)
                         + tokens / self._weight(t))


DISCIPLINES = {
    "fifo_priority": FifoPriorityDiscipline,
    "weighted_fair": WeightedFairDiscipline,
}


@dataclass
class SchedulerConfig:
    max_slots: int = 8
    max_batch_tokens: int = 2048
    prefill_chunk: int = 0            # 0 = whole prompt in one step
    mixed: bool = False               # co-run prefill chunk with decode batch
    max_context: int = 4096
    page_size: int = 128
    num_pages: int = 1024
    admit_priority_min: int = 0
    preempt: bool = True
    decode_first: bool = False        # prioritize decode over admission
    require_complete_prompt: bool = False  # real engine: no partial prefill
    # disaggregation plane: the engine's phase role.  `prefill` engines
    # never plan decode steps (sequences are released at prefill
    # completion and handed to a decode engine); `decode` engines never
    # admit from the waiting queue (arrivals come through the handoff
    # `admit_direct` path); `unified` is the classic both-phases loop.
    role: str = "unified"             # unified | prefill | decode
    # tenancy plane: the queue discipline deciding who is served next
    discipline: str = "fifo_priority"  # fifo_priority | weighted_fair
    # tool-call plane: host-memory spill tier for suspended sequences
    # (0 = no offload tier: suspend drops straight to recompute)
    host_capacity_pages: int = 0


class Scheduler(ControlSurface):
    # -- knobs (set()/reset() surface, derived from ControlSurface) --------
    kind = "scheduler"
    CAPABILITIES = ("priority", "preempt")
    METRICS = ("queue_len", "num_running", "page_util",
               "prefill_queue_tokens", "decode_slot_util",
               "suspended_seqs", "host_pages_used")
    KNOB_SPECS = (
        KnobSpec("max_num_seqs", kind="int", lo=1, attr="cfg.max_slots",
                 on_change="_resize_slots",
                 doc="continuous-batching slot count"),
        KnobSpec("max_batch_tokens", kind="int", lo=1,
                 attr="cfg.max_batch_tokens",
                 doc="prefill token budget per step"),
        KnobSpec("prefill_chunk", kind="int", lo=0, attr="cfg.prefill_chunk",
                 doc="chunked-prefill size; 0 = whole prompt"),
        KnobSpec("mixed", kind="bool", attr="cfg.mixed",
                 doc="stall-free continuous batching: co-run one chunked "
                     "prefill with all live decode slots in a single fused "
                     "step (unified role only)"),
        KnobSpec("admit_priority_min", kind="int",
                 attr="cfg.admit_priority_min",
                 doc="admission floor: requests below are not admitted"),
        KnobSpec("decode_first", kind="bool", attr="cfg.decode_first",
                 doc="prioritize decode over new admissions"),
        KnobSpec("role", kind="str",
                 choices=("unified", "prefill", "decode"), attr="cfg.role",
                 doc="engine phase role: unified | prefill | decode"),
        KnobSpec("discipline", kind="str",
                 choices=tuple(DISCIPLINES), attr="cfg.discipline",
                 on_change="_discipline_changed",
                 doc="queue discipline: fifo_priority | weighted_fair"),
        KnobSpec("host_capacity_pages", kind="int", lo=0,
                 attr="cfg.host_capacity_pages",
                 on_change="_host_capacity_changed",
                 doc="host-memory spill tier for tool-call suspend "
                     "(pages); 0 = no offload tier, suspended sequences "
                     "drop straight to recompute"),
    )

    def __init__(self, cfg: SchedulerConfig, name: str = "scheduler",
                 cache=None, tenants=None):
        self.name = name
        self.cfg = cfg
        self.alloc = PageAllocator(cfg.num_pages, cfg.page_size,
                                   host_capacity_pages=cfg.host_capacity_pages)
        self.cache = cache               # Optional[PrefixCache] over alloc
        self.tenants = tenants           # Optional[TenantDirectory]
        self.discipline = DISCIPLINES[cfg.discipline]()
        self.discipline.attach(self)
        self.waiting: list[Request] = []
        self.running: list[Request] = []
        self._free_slots = list(range(cfg.max_slots))
        self.preempt_count = 0
        # tool-call plane: offloaded (slotless) suspended requests, plus
        # the restore-capable ones waiting for a free slot/pages — those
        # are retried with priority over fresh admissions every plan_step
        self.suspended: list[Request] = []
        self._resume_pending: list[Request] = []
        self.resume_hits = 0
        self.resume_recomputes = 0
        # disaggregation fabric hook: where a decode-role scheduler
        # sends preempted victims (it can never re-admit them itself —
        # they need a fresh prefill on a prefill-capable engine)
        self.bounce_fn: Optional[Callable[[Request], None]] = None
        # tracing hooks: the owning engine stamps segment transitions
        # at the exact admit/preempt instants the spans must tile on
        self.on_admit: Optional[Callable[[Request], None]] = None
        self.on_preempt: Optional[Callable[[Request], None]] = None
        # resume hook: the owning engine re-injects host KV (or notes a
        # recompute) at the exact instant a suspended request lands back
        self.on_resume: Optional[Callable[[Request, str], None]] = None
        # pin-deadlock breaker: when every slot-holder is a parked pin
        # and work is waiting, plan_step asks the engine to demote one
        # pin down the eviction ladder (the engine owns the KV movement)
        self.demote_fn: Optional[Callable[[], None]] = None

    def _resize_slots(self, old: int, new: int) -> None:
        if new > old:
            self._free_slots.extend(range(old, new))
        elif new < old:
            self._free_slots = [s for s in self._free_slots if s < new]

    def _host_capacity_changed(self, old: int, new: int) -> None:
        # shrink is clamped above pages holding live spills: reflect the
        # capacity that actually took effect back into the knob value
        self.cfg.host_capacity_pages = self.alloc.set_host_capacity(new)

    def _discipline_changed(self, old: str, new: str) -> None:
        # fresh accounting on a switch: virtual time from a previous
        # discipline instance has no meaning under the new one
        self.discipline = DISCIPLINES[new]()
        self.discipline.attach(self)
        self._sort_waiting()

    def attach_tenants(self, directory) -> None:
        """Wire the fleet's TenantDirectory into the fairness path:
        weighted_fair reads per-tenant weights, charge() reports served
        tokens, and engines report per-tenant TTFT through it."""
        self.tenants = directory

    # -- queue ops ---------------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.state = RequestState.QUEUED
        if req.available < 0:
            req.available = req.prompt_len
        self.discipline.on_submit(req)
        self.waiting.append(req)
        self._sort_waiting()

    def _sort_waiting(self) -> None:
        # order is the discipline's call (sort is stable, so equal keys
        # keep insertion order — the FIFO tail of every discipline)
        self.waiting.sort(key=self.discipline.key)

    def charge(self, req: Request, tokens: int, now: float = 0.0) -> None:
        """Engines report actually-processed prefill/decode tokens here:
        the discipline's fair-share accounting and the tenancy plane's
        ``share`` rollups both track real work, not request counts."""
        if tokens <= 0:
            return
        if self.tenants is not None:
            self.tenants.note_served(req.tenant, tokens, now)
        self.discipline.charge(req, tokens)

    @property
    def queue_len(self) -> int:
        return len(self.waiting)

    @property
    def num_running(self) -> int:
        return len(self.running)

    def slots_in_use(self) -> int:
        return self.cfg.max_slots - len(self._free_slots)

    @property
    def suspended_seqs(self) -> int:
        """Requests parked on an external wait: offloaded (slotless) plus
        pinned-in-place ones still holding their slot."""
        pinned = sum(1 for r in self.running
                     if r.state == RequestState.SUSPENDED)
        return len(self.suspended) + pinned

    @property
    def host_pages_used(self) -> int:
        return self.alloc.host_pages

    @property
    def restore_hit_rate(self) -> float:
        """Warm-restore fraction of completed resumes (1.0 until any
        resume has gone the drop-and-recompute path)."""
        total = self.resume_hits + self.resume_recomputes
        return self.resume_hits / total if total else 1.0

    # -- disaggregation gauges (fleet policies aggregate these) -------------
    @property
    def prefill_queue_tokens(self) -> int:
        """Prompt tokens backed up behind prefill: everything waiting,
        plus the un-prefilled remainder of admitted PREFILL sequences."""
        backlog = sum(max(r.prompt_len - r.prefilled, 0)
                      for r in self.waiting)
        backlog += sum(max(r.prompt_len - r.prefilled, 0)
                       for r in self.running
                       if r.state == RequestState.PREFILL)
        return backlog

    @property
    def decode_slot_util(self) -> float:
        """Fraction of batching slots occupied by decoding sequences."""
        running = sum(1 for r in self.running
                      if r.state == RequestState.RUNNING)
        return running / max(self.cfg.max_slots, 1)

    # -- planning -----------------------------------------------------------------
    def _cache_limit(self, req: Request) -> int:
        """Cap on usable cached prefix: never the whole prompt (the last
        token is always recomputed to produce first-token logits) and
        never beyond the prompt tokens that have *arrived*."""
        lim = req.prompt_len - 1
        if req.available >= 0:
            lim = min(lim, req.available)
        return max(lim, 0)

    def _private_need(self, req: Request) -> int:
        """Tokens that must be privately allocated at admission: the full
        footprint minus the cached prefix resident in shared blocks."""
        need = min(req.prompt_len + req.max_new_tokens, self.cfg.max_context)
        if self.cache is None:
            return need
        cached = self.cache.probe_request(req, limit=self._cache_limit(req))
        return need - min(cached, need)

    def _admissible(self, req: Request) -> bool:
        if int(req.priority) < self.cfg.admit_priority_min:
            return False
        if not self._free_slots:
            return False
        need = self._private_need(req)
        if self.alloc.can_allocate(need):
            return True
        # reclaim idle cache blocks before refusing admission
        return self.cache is not None and self.cache.make_room(need)

    def _admit(self, req: Request) -> bool:
        req.slot = self._free_slots.pop(0)
        need = min(req.prompt_len + req.max_new_tokens, self.cfg.max_context)
        cached = 0
        if self.cache is not None:
            cached = self.cache.begin(req, limit=self._cache_limit(req))
            req.meta["cached_prompt_tokens"] = cached
        priv = need - min(cached, need)
        ok = self.alloc.allocate(req.req_id, priv)
        if not ok and self.cache is not None:
            # _admissible's probe can go stale — e.g. its make_room call
            # evicted this very request's idle prefix blocks — so retry
            # the eviction with the acquired chain now reference-held
            ok = self.cache.make_room(priv) \
                and self.alloc.allocate(req.req_id, priv)
        if not ok:
            # undo: release acquired blocks + slot, requeue at the front
            self.alloc.free(req.req_id)
            if self.cache is not None:
                self.cache.seq_done(req.req_id)
            self._free_slots.insert(0, req.slot)
            req.slot = -1
            req.state = RequestState.QUEUED
            self.waiting.insert(0, req)
            return False
        req.prefilled = max(req.prefilled, cached)
        req.state = RequestState.PREFILL
        self.running.append(req)
        if self.on_admit is not None:
            self.on_admit(req)
        return True

    def commit_prefix(self, req: Request) -> None:
        """Prefill done: register the prompt's new blocks in the cache."""
        if self.cache is not None:
            self.cache.commit(req)

    def _release(self, req: Request) -> None:
        self.alloc.free(req.req_id)
        if self.cache is not None:
            self.cache.seq_done(req.req_id)
        if req.slot >= 0 and req.slot < self.cfg.max_slots:
            self._free_slots.append(req.slot)
        req.slot = -1
        if req in self.running:
            self.running.remove(req)

    def finish(self, req: Request, now: float) -> None:
        req.state = RequestState.FINISHED
        req.finish_time = now
        self._release(req)

    def admit_direct(self, req: Request) -> bool:
        """Admit a request straight into RUNNING, no local prefill: its
        decode state arrives from elsewhere (a kv_transfer migration, or
        the disaggregation plane's prefill→decode handoff — engines gate
        this call on KV residency via ``EngineCore.admit_handoff``)."""
        if self.cfg.role == "prefill":
            return False              # prefill engines never decode
        if not self._free_slots:
            return False
        need = min(req.total_len + (req.max_new_tokens - req.generated),
                   self.cfg.max_context)
        if not self.alloc.allocate(req.req_id, need):
            return False
        req.slot = self._free_slots.pop(0)
        req.state = RequestState.RUNNING
        self.running.append(req)
        if self.on_admit is not None:
            self.on_admit(req)
        return True

    def release_for_handoff(self, req: Request) -> None:
        """Prefill complete on a prefill-role engine: free the slot and
        pages here — the KV rides the handoff pipeline to the paired
        decode engine, which re-admits via ``admit_direct``."""
        self._release(req)
        req.state = RequestState.HANDOFF

    # -- tool-call suspend/resume ------------------------------------------------
    def suspend(self, req: Request, offload: bool = True) -> str:
        """Park a RUNNING request on an external wait (a tool call).

        ``offload=False`` *pins*: the request keeps its slot and pages
        (it simply stops being planned into decode steps) — the
        baseline behavior this plane exists to beat.  ``offload=True``
        returns the slot to the pool immediately and spills private KV
        pages to the allocator's host tier (shared prefix blocks are
        only decref'd, so sharers keep them hot).  Returns the tier the
        request landed on: ``pin`` | ``host`` | ``drop`` (host tier
        full — resume will recompute) | ``none`` (not suspendable)."""
        if req.state != RequestState.RUNNING or req not in self.running:
            return "none"
        req.state = RequestState.SUSPENDED
        if not offload:
            req.meta["suspend_tier"] = "pin"
            return "pin"
        return self._spill(req)

    def _spill(self, req: Request) -> str:
        """Move a SUSPENDED slot-holder down the ladder: KV to the host
        tier (or dropped when it is full), slot back to the pool."""
        tier = self.alloc.suspend(req.req_id)
        if tier == "drop" and self.cache is not None:
            self.cache.seq_done(req.req_id)
        if 0 <= req.slot < self.cfg.max_slots:
            self._free_slots.append(req.slot)
        req.slot = -1
        self.running.remove(req)
        self.suspended.append(req)
        req.meta["suspend_tier"] = tier
        return tier

    def offload_pinned(self, req: Request) -> str:
        """Demote a *pinned* suspended request to a real offload — the
        anti-deadlock rung.  A pin is best-effort: if every slot-holder
        is parked on a tool wait and queued work includes the very calls
        those tools are waiting on (a fan-in like debate's pro/con ->
        factcheck), no slot would ever free.  The caller (the engine's
        ``demote_fn``) extracts KV first, exactly like a knob-driven
        offload."""
        if req.state != RequestState.SUSPENDED or req not in self.running:
            return "none"
        return self._spill(req)

    def pin_starved(self) -> Optional[Request]:
        """The demotion trigger — a *true* wedge, not mere pressure: no
        free slot, work waiting, and every slot-holder is a parked pin
        whose tool cannot even *start* until a queued sibling call runs
        (the workflow layer stamps those ``tool_blocked``).  If any
        occupant is still decoding, or is parked on a tool already in
        flight, the engine makes progress on its own — that is latency,
        not deadlock, and the pin baseline stays pinned through it."""
        if self._free_slots or not self.running:
            return None
        if not (self.waiting or self._resume_pending):
            return None
        for r in self.running:
            if (r.state != RequestState.SUSPENDED
                    or not r.meta.get("tool_blocked")):
                return None               # someone can still make progress
        return self.running[0]            # oldest blocked pin first

    def resume(self, req: Request) -> str:
        """Bring a SUSPENDED request back to RUNNING.

        Outcomes: ``pin`` (never left — state flip only), ``hit``
        (host pages reclaimed into HBM, prefix blocks re-acquired, slot
        granted; the engine's ``on_resume`` hook re-injects the KV),
        ``wait`` (restorable, but no slot/pages right now — queued on
        the resume-pending list, which ``plan_step`` retries *before*
        fresh admissions), or ``recompute`` (host copy or prefix chain
        gone: the eviction ladder's bottom rung — generated tokens fold
        into the prompt and the request re-enters normal admission)."""
        if req.state != RequestState.SUSPENDED:
            return "none"
        if req in self.running:               # pinned: slot never left
            req.state = self._resume_state(req)
            req.meta.pop("suspend_tier", None)
            if self.on_resume is not None:
                self.on_resume(req, "pin")
            return "pin"
        out = self._try_restore(req)
        if out == "wait" and req not in self._resume_pending:
            self._resume_pending.append(req)
        return out

    def _resume_state(self, req: Request) -> RequestState:
        """A resume lands in PREFILL when the continuation appended
        prompt tokens (a tool result) that still need prefilling on top
        of the restored context; plain resumes go straight to RUNNING."""
        if req.prefilled < min(req.prompt_len, max(req.available, 0)):
            return RequestState.PREFILL
        return RequestState.RUNNING

    def _try_restore(self, req: Request) -> str:
        ready = self.alloc.restore_ready(req.req_id)
        if ready == "no_pages" and self.cache is not None:
            # eviction ladder: reclaim idle cache blocks before forcing
            # a restorable spill down to recompute (or making it wait)
            if self.cache.make_room(self.alloc.host_holds(req.req_id)
                                    * self.cfg.page_size):
                ready = self.alloc.restore_ready(req.req_id)
        if ready == "ok":
            if not self._free_slots:
                return "wait"
            self.alloc.restore(req.req_id)
            req.slot = self._free_slots.pop(0)
            req.state = self._resume_state(req)
            req.meta.pop("suspend_tier", None)
            if req in self.suspended:
                self.suspended.remove(req)
            self.running.append(req)
            self.resume_hits += 1
            if self.on_admit is not None:
                self.on_admit(req)
            if self.on_resume is not None:
                self.on_resume(req, "hit")
            return "hit"
        if ready == "no_pages":
            return "wait"
        # gone / no_blocks: drop-and-recompute.  The generated tail's KV
        # is lost with the host copy, so it folds into the prompt and the
        # whole context re-prefills through normal admission (where the
        # prefix cache may still shortcut most of it).
        self.alloc.drop_suspended(req.req_id)
        if self.cache is not None:
            self.cache.seq_done(req.req_id)
        if req in self.suspended:
            self.suspended.remove(req)
        req.meta.pop("suspend_tier", None)
        if req.generated:
            if req.prompt_tokens is not None:
                req.prompt_tokens = (list(req.prompt_tokens)
                                     + list(req.output_tokens))
            req.prompt_len += req.generated
            req.max_new_tokens = max(req.max_new_tokens - req.generated, 1)
            req.generated = 0
        req.available = req.prompt_len
        req.prefilled = 0
        req.slot = -1
        self.resume_recomputes += 1
        if self.cfg.role == "decode" and self.bounce_fn is not None:
            # decode engines can't run the recompute prefill themselves
            self.bounce_fn(req)
        else:
            self.submit(req)
        if self.on_resume is not None:
            self.on_resume(req, "recompute")
        return "recompute"

    def _resume_pass(self) -> None:
        """Retry restore-pending resumes — before fresh admissions, so a
        returning tool call outranks new work for freed capacity."""
        if not self._resume_pending:
            return
        still = []
        for req in self._resume_pending:
            if req.state != RequestState.SUSPENDED:
                continue                  # finished/migrated meanwhile
            if self._try_restore(req) == "wait":
                still.append(req)
        self._resume_pending = still

    def forget_suspended(self, req: Request) -> None:
        """Strip every trace of a suspended request from this scheduler —
        the abandon path, and the source side of a cross-engine
        migration."""
        if req in self.running:           # pinned: slot + pages held
            self._release(req)
        else:
            self.alloc.drop_suspended(req.req_id)
            if self.cache is not None:
                self.cache.seq_done(req.req_id)
            if req in self.suspended:
                self.suspended.remove(req)
            if req in self._resume_pending:
                self._resume_pending.remove(req)
        req.meta.pop("suspend_tier", None)

    def finish_suspended(self, req: Request, now: float) -> None:
        """A suspended request whose continuation was abandoned: release
        its parked state (pinned slot+pages or host copy) and finish."""
        self.forget_suspended(req)
        req.state = RequestState.FINISHED
        req.finish_time = now

    def preempt_one(self) -> Optional[Request]:
        """Evict lowest-priority, youngest running sequence."""
        candidates = [r for r in self.running
                      if r.state == RequestState.RUNNING]
        if not candidates:
            return None
        victim = min(candidates, key=self.discipline.victim_key)
        self._release(victim)
        victim.state = RequestState.PREEMPTED
        # cache dropped: the victim restarts from scratch on re-admit, so
        # every per-request emission record resets with it — leaving
        # output_tokens/first_token_time populated would re-emit the same
        # tokens (duplicate output, double-counted ttft) after re-admission
        victim.prefilled = 0
        victim.generated = 0
        victim.output_tokens.clear()
        victim.first_token_time = None
        self.preempt_count += 1
        if self.on_preempt is not None:
            self.on_preempt(victim)
        if self.cfg.role == "decode" and self.bounce_fn is not None:
            # this scheduler never admits from waiting: re-route the
            # victim to a prefill-capable engine instead of stranding it
            self.bounce_fn(victim)
            return victim
        self.waiting.append(victim)
        self._sort_waiting()
        return victim

    def _admission_pass(self) -> None:
        """Admit from the head of the discipline-ordered waiting queue
        while capacity lasts.  Paused tenants' requests are skipped (not
        head-of-line blockers); with no TenantDirectory attached this
        loop is bit-exact with the classic admit-while-admissible."""
        if self.discipline.dynamic:
            self._sort_waiting()         # served tokens moved the keys
        held = []
        while self.waiting:
            head = self.waiting[0]
            if self.tenants is not None and self.tenants.paused(head.tenant):
                held.append(self.waiting.pop(0))
                continue
            if not self._admissible(head):
                break
            if not self._admit(self.waiting.pop(0)):
                break
        if held:
            # restore discipline order: a plain front-insert would leave
            # the skipped requests ahead of higher-priority work until
            # the next submit happens to re-sort
            self.waiting[:0] = held
            self._sort_waiting()

    def plan_step(self) -> StepPlan:
        # 0. liveness: a fully pin-parked engine with waiting work can
        #    never free a slot on its own — demote one pin down the
        #    ladder (the engine moves the KV) before planning anything
        if self.demote_fn is not None and self.pin_starved() is not None:
            self.demote_fn()
        #    returning tool calls first: restore-pending resumes get the
        #    freed capacity before any fresh admission sees it
        if self.cfg.role != "prefill":
            self._resume_pass()
        # 1. admit while capacity (decode engines only admit through the
        #    handoff path — their waiting queue is bounced by the fabric)
        if self.cfg.role != "decode" and (not self.cfg.decode_first
                                          or not self.running):
            self._admission_pass()
        # 2. prefill work pending?  (only tokens that have *arrived* —
        #    under STREAM granularity the prompt trickles in and prefill
        #    overlaps the upstream agent's generation)
        pending = [r for r in self.running
                   if r.state in (RequestState.PREFILL,)
                   and r.prefilled < min(r.prompt_len, r.available)]
        if self.cfg.require_complete_prompt:
            pending = [r for r in pending if r.available >= r.prompt_len]
        if pending and self.cfg.mixed and self.cfg.role == "unified":
            # stall-free continuous batching: the token budget is filled
            # with every live decode slot first (one token each), then
            # one head-of-line prefill chunk takes whatever remains —
            # a long prompt never serializes against the decode batch.
            decodes = [r for r in self.running
                       if r.state == RequestState.RUNNING]
            budget = self.cfg.max_batch_tokens - len(decodes)
            chunkcfg = self.cfg.prefill_chunk
            r = pending[0]
            remaining = min(r.prompt_len, r.available) - r.prefilled
            chunk = remaining if chunkcfg <= 0 else min(chunkcfg, remaining)
            chunk = min(chunk, budget)
            if chunk > 0:
                return StepPlan(StepKind.MIXED,
                                prefills=[PrefillWork(r, chunk)],
                                decodes=decodes)
            if decodes:          # budget exhausted by decode slots alone
                return StepPlan(StepKind.DECODE, decodes=decodes)
            return StepPlan(StepKind.IDLE)
        if pending:
            budget = self.cfg.max_batch_tokens
            chunkcfg = self.cfg.prefill_chunk
            plan = StepPlan(StepKind.PREFILL)
            for r in pending:
                if budget <= 0:
                    break
                remaining = min(r.prompt_len, r.available) - r.prefilled
                chunk = remaining if chunkcfg <= 0 else min(chunkcfg,
                                                            remaining)
                chunk = min(chunk, budget)
                if chunk <= 0:
                    continue
                plan.prefills.append(PrefillWork(r, chunk))
                budget -= chunk
            if plan.prefills:
                return plan
        # 3. decode everyone running — never on a prefill-role engine:
        #    its RUNNING sequences are awaiting handoff release, not a
        #    decode step (prefill-only engines never decode)
        if self.cfg.role == "prefill":
            return StepPlan(StepKind.IDLE)
        decodes = [r for r in self.running if r.state == RequestState.RUNNING]
        if decodes:
            return StepPlan(StepKind.DECODE, decodes=decodes)
        return StepPlan(StepKind.IDLE)

    # -- decode-time growth ----------------------------------------------------------
    def ensure_decode_capacity(self, req: Request) -> bool:
        """Grow pages for the next token; evict idle cache blocks first,
        then preempt others if configured."""
        shared = (self.cache.shared_tokens(req.req_id)
                  if self.cache is not None else 0)
        target = max(min(req.total_len + 1, self.cfg.max_context) - shared, 0)
        while not self.alloc.grow_to(req.req_id, target):
            if self.cache is not None and self.cache.evict_one():
                continue
            if not self.cfg.preempt:
                return False
            victim = self.preempt_one()
            if victim is None or victim is req:
                return False
        return True
