"""Live PyTorch serving engine (port of ``repro/serving/engine.py``).

Two KV layouts, selected by the ``cache_layout`` knob (default: paged
when ``cfg.use_pallas`` is set, else ring, as in the reference):

* ``ring``  -- slot-contiguous ring buffers.  Prefill recomputes the
  whole prompt into a fresh batch-1 sub-cache in one shot, which is then
  copied into the slot (``serving/cache_utils``).  With ``cfg.use_pallas``
  prefill attention runs the Hopper flash kernel and decode attention the
  ring decode kernel.  A hybrid's (hymba's) layers add their SSM state
  to the slot, and their mamba branch runs the SSM scan kernel at
  prefill; a hybrid serves only on this layout.
* ``paged`` -- one shared page pool per layer, sized by the scheduler's
  ``PageAllocator`` (pool page *i* is allocator page *i*).  Inactive
  slots ride along with all -1 block-table rows, so their writes land in
  the pool's sink page and their reads mask out.  With ``cfg.use_pallas``
  decode attention runs the paged Hopper kernel over the live block
  tables.  Prefill computes only the uncached suffix of a prompt, in the
  chunks the scheduler plans (the ``prefill_chunk`` knob).

Each decode step runs every slot at once.  Sampling runs on the device;
only token ids cross to the host.  ``extract_state``/``inject_state``
move one sequence between engines of either layout through the batch-1
ring tree (SSM states included).  PyTorch runs eagerly, so there is
nothing to compile or donate: each step updates the cache in place.
Waiting for later slices (ROADMAP queue A): the mixed step and the
prefix cache.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs.base import ModelConfig
from repro_torch.core.knobs import KnobSpec
from repro_torch.core.types import Request, RequestState
from repro_torch.models.params import resolve_device
from repro_torch.serving import cache_utils, sampler
from repro_torch.serving.engine_base import EngineCore
from repro_torch.serving.kv_cache import block_tables
from repro_torch.serving.scheduler import SchedulerConfig, StepKind


class TorchEngine(EngineCore):
    KNOB_SPECS = EngineCore.KNOB_SPECS + (
        KnobSpec("cache_layout", kind="str", choices=("ring", "paged"),
                 attr="_cache_layout", on_change="_cache_layout_changed",
                 doc="KV cache layout: 'ring' slot-contiguous buffers or "
                     "'paged' shared page pool driven by live allocator "
                     "block tables"),
    )

    def __init__(self, cfg: ModelConfig, params, sched_cfg: SchedulerConfig,
                 name: str = "engine", collector=None, seed: int = 0,
                 cache_layout: str | None = None, device=None):
        self.device = resolve_device(device)
        if cache_layout not in (None, "ring", "paged"):
            raise ValueError(f"unknown cache layout {cache_layout!r}")
        if sched_cfg.mixed:
            raise NotImplementedError(
                "mixed batching is not ported yet (ROADMAP queue A: mixed "
                "step)")
        table_dev = params["embed"]["table"].device
        if table_dev.type != self.device.type:
            raise ValueError(f"params live on {table_dev}, engine device "
                             f"is {self.device}")
        sched_cfg.require_complete_prompt = True   # whole prompt before prefill
        super().__init__(name, cfg.name, sched_cfg, collector)
        self.cfg = cfg
        self.params = params
        self._t0 = time.monotonic()
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # fixed block-table width: the allocator never hands a live
        # sequence more pages than a max_context footprint
        self._p_max = self.scheduler.alloc.pages_for(sched_cfg.max_context)
        self._axes = cache_utils.batch_axes(cfg, sched_cfg.max_context)
        if cache_layout is None:
            cache_layout = "paged" if cfg.use_pallas else "ring"
        self._cache_layout = cache_layout
        self._last_token = np.zeros((sched_cfg.max_slots,), np.int32)
        self._build_cache()

    # ----------------------------------------------------------- cache layout
    @property
    def cache_layout(self) -> str:
        return self._cache_layout

    def _build_cache(self) -> None:
        sc = self.scheduler.cfg
        self.cache = None                   # free the old cache first
        self.cache = models.init_cache(
            self.cfg, sc.max_slots, sc.max_context, layout=self._cache_layout,
            num_pages=sc.num_pages, page_size=sc.page_size,
            device=self.device)

    def _cache_layout_changed(self, old: str, new: str) -> None:
        if old == new:
            return
        if self.scheduler.num_running > 0:
            self._cache_layout = old            # revert before failing
            raise RuntimeError(
                f"{self.name}: cache_layout flip needs an idle engine "
                f"({self.scheduler.num_running} sequences running)")
        self._build_cache()

    def on_knob_set(self, name: str, old, new) -> None:
        if name == "mixed" and new:
            self.scheduler.cfg.mixed = old      # revert before failing
            raise NotImplementedError(
                f"{self.name}: mixed batching is not ported yet (ROADMAP "
                "queue A: mixed step)")
        super().on_knob_set(name, old, new)

    def _block_table_rows(self, reqs: list[Request]) -> np.ndarray:
        """(max_slots, P_max) int32 table: live rows come straight from
        ``PageAllocator.page_table`` (physical ids in logical order);
        inactive slots are all -1."""
        slots = self.scheduler.cfg.max_slots
        out = np.full((slots, self._p_max), -1, np.int32)
        live = [r for r in reqs if 0 <= r.slot < slots]
        if live:
            rows = block_tables(self.scheduler.alloc,
                                [r.req_id for r in live], width=self._p_max)
            for r, row in zip(live, rows):
                out[r.slot] = row
        return out

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------------ time
    def now(self) -> float:
        return time.monotonic() - self._t0

    # ------------------------------------------------------------------ step
    def step(self) -> StepKind:
        """Run one scheduler plan synchronously.  Returns the plan kind."""
        if self.paused:
            return StepKind.IDLE
        t_start = time.monotonic()
        plan = self.scheduler.plan_step()
        if plan.kind == StepKind.PREFILL:
            firsts = []
            for work in plan.prefills:
                if self._cache_layout == "paged":
                    firsts.append(self._run_prefill_paged(work.req,
                                                          work.chunk))
                else:
                    work.chunk = work.req.prompt_len   # ring: one shot
                    firsts.append(self._run_prefill(work.req))
            self.apply_prefill(plan.prefills, firsts, self.now())
        elif plan.kind == StepKind.DECODE:
            live = [r for r in plan.decodes
                    if self.scheduler.ensure_decode_capacity(r)]
            if live:
                toks = self._run_decode(live)
                self.apply_decode(live, toks, self.now())
        self.steps += 1
        self._step_metrics(time.monotonic() - t_start)
        return plan.kind

    def run_until_idle(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if not self.busy:
                break
            self.step()

    # ---------------------------------------------------------------- prefill
    @torch.inference_mode()
    def _run_prefill(self, req: Request) -> int:
        """Ring prefill: the whole prompt in one shot into a fresh batch-1
        sub-cache, then copied into the request's slot."""
        tokens = self._to_device(
            np.asarray(req.prompt_tokens, np.int64)[None, :])
        sub = models.init_cache(self.cfg, 1, self.scheduler.cfg.max_context,
                                layout="ring", device=self.device)
        logits, sub = models.prefill(self.params, self.cfg, tokens, sub)
        cache_utils.cache_insert(self.cache, sub, req.slot, self._axes)
        first = int(sampler.sample(logits, self._gen, self.temperature)[0])
        self._last_token[req.slot] = first
        return first

    @torch.inference_mode()
    def _run_prefill_paged(self, req: Request, chunk: int):
        """Prefill ``chunk`` uncached prompt tokens into the shared pool.
        ``req.prefilled`` tokens are already resident (earlier chunks of
        this prefill); the block-table row lays those pages first, so the
        chunk attends back into them.  Returns the sampled first token
        when this chunk completes the prompt, else None."""
        start = min(req.prefilled, req.prompt_len - 1)
        chunk = min(chunk, req.prompt_len - start)
        tokens = self._to_device(
            np.asarray(req.prompt_tokens[start:start + chunk],
                       np.int64)[None, :])
        row = self._to_device(self._block_table_rows([req])[req.slot][None])
        logits, self.cache = models.prefill_paged(
            self.params, self.cfg, tokens, self.cache, row,
            torch.full((1,), start, dtype=torch.int32, device=self.device),
            req.slot)
        if start + chunk < req.prompt_len:
            return None                     # chunk not final: no token yet
        first = int(sampler.sample(logits, self._gen, self.temperature)[0])
        self._last_token[req.slot] = first
        return first

    # ----------------------------------------------------------------- decode
    @torch.inference_mode()
    def _run_decode(self, reqs: list[Request]) -> list[int]:
        tokens = self._to_device(self._last_token[:, None].astype(np.int64))
        tables = None
        if self._cache_layout == "paged":
            tables = self._to_device(self._block_table_rows(reqs))
        logits, self.cache = models.decode_step(self.params, self.cfg, tokens,
                                                self.cache, tables)
        toks = sampler.sample(logits, self._gen, self.temperature).cpu()
        toks = toks.numpy()
        out = []
        for r in reqs:
            t = int(toks[r.slot])
            self._last_token[r.slot] = t
            out.append(t)
        return out

    # ------------------------------------------------------------ kv transfer
    @torch.inference_mode()
    def extract_state(self, req: Request) -> dict:
        """(batch-1 ring-format cache tree, last token, nbytes) of one
        sequence, for migration.  Both layouts export the same format, so
        the receiving engine never cares which layout produced it.  The
        tree is a copy on this engine's device."""
        if self._cache_layout == "paged":
            row = self._block_table_rows([req])[req.slot]
            ctx = int(self.cache["pos"][req.slot])
            sub = models.paged_extract(self.cfg, self.cache, row, ctx,
                                       self.scheduler.cfg.max_context,
                                       req.slot)
        else:
            sub = cache_utils.cache_extract(self.cache, req.slot, self._axes)
        return {"cache": sub,
                "last_token": int(self._last_token[req.slot]),
                "nbytes": cache_utils.cache_nbytes(sub)}

    @torch.inference_mode()
    def inject_state(self, req: Request, state: dict) -> None:
        """Install a migrated request into a fresh slot (already admitted:
        ``req.slot`` assigned, scheduler pages reserved).  A ring engine
        refuses a ring whose size differs from its own (the reference
        fails there too, with a TypeError from its slice update)."""
        if self._cache_layout == "paged":
            row = self._block_table_rows([req])[req.slot]
            self.cache = models.paged_insert(self.cfg, self.cache,
                                             state["cache"], row, req.slot)
        else:
            cache_utils.cache_insert(self.cache, state["cache"], req.slot,
                                     self._axes)
        self._last_token[req.slot] = state["last_token"]
        req.state = RequestState.RUNNING
        req.prefilled = req.prompt_len
