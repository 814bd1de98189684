"""Live PyTorch serving engine (port of ``repro/serving/engine.py``),
paged KV layout.

One shared page pool per layer, sized by the scheduler's
``PageAllocator`` (pool page *i* is allocator page *i*).  Each decode
step runs every slot at once: inactive slots ride along with all -1
block-table rows, so their writes land in the pool's sink page and
their reads mask out.  With ``cfg.use_pallas`` decode attention runs the
hand-written Hopper kernel over the live block tables.  Prefill computes
only the uncached suffix of a prompt, in the chunks the scheduler plans
(the ``prefill_chunk`` knob), straight into the pool.  Sampling runs on
the device; only token ids cross to the host.

PyTorch runs eagerly, so there is nothing to compile or donate: each
step updates the pool in place.  Waiting for later slices (ROADMAP
queue A): the mixed step, ``extract_state``/``inject_state``, the
prefix cache and the ring layout.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs.base import ModelConfig
from repro_torch.core.knobs import KnobSpec
from repro_torch.core.types import Request
from repro_torch.models.params import resolve_device
from repro_torch.serving import sampler
from repro_torch.serving.engine_base import EngineCore
from repro_torch.serving.kv_cache import block_tables
from repro_torch.serving.scheduler import SchedulerConfig, StepKind


class TorchEngine(EngineCore):
    KNOB_SPECS = EngineCore.KNOB_SPECS + (
        KnobSpec("cache_layout", kind="str", choices=("paged",),
                 attr="_cache_layout",
                 doc="KV cache layout: 'paged' shared page pool driven by "
                     "live allocator block tables (the ring layout is not "
                     "ported yet)"),
    )

    def __init__(self, cfg: ModelConfig, params, sched_cfg: SchedulerConfig,
                 name: str = "engine", collector=None, seed: int = 0,
                 cache_layout: str | None = None, device=None):
        self.device = resolve_device(device)
        if cache_layout not in (None, "paged"):
            raise NotImplementedError(
                f"cache layout {cache_layout!r} is not ported yet (ROADMAP "
                "queue A: ring layout)")
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
        self._cache_layout = "paged"
        self._last_token = np.zeros((sched_cfg.max_slots,), np.int32)
        sc = sched_cfg
        self.cache = models.init_cache(cfg, sc.max_slots, sc.max_context,
                                       layout="paged", num_pages=sc.num_pages,
                                       page_size=sc.page_size,
                                       device=self.device)

    @property
    def cache_layout(self) -> str:
        return self._cache_layout

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
            firsts = [self._run_prefill_paged(w.req, w.chunk)
                      for w in plan.prefills]
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
    def extract_state(self, req: Request):
        raise NotImplementedError(
            "extract_state is not ported yet (ROADMAP queue A: migration "
            "bridge)")

    def inject_state(self, req: Request, state: dict) -> None:
        raise NotImplementedError(
            "inject_state is not ported yet (ROADMAP queue A: migration "
            "bridge)")
