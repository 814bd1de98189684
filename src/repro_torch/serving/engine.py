"""Live PyTorch serving engine (port of ``repro/serving/engine.py``).

Two KV layouts, selected by the ``cache_layout`` knob (default: paged
when ``cfg.use_pallas`` is set, else ring, as in the reference):

* ``ring``  -- slot-contiguous ring buffers.  Prefill recomputes the
  whole prompt into a fresh batch-1 sub-cache in one shot, which is then
  copied into the slot (``serving/cache_utils``).  With ``cfg.use_pallas``
  prefill attention runs the Hopper flash kernel and decode attention the
  ring decode kernel.  A hybrid's (hymba's) layers add their SSM state
  to the slot, and their mamba branch runs the SSM scan kernel at
  prefill; an xLSTM stack keeps an mLSTM or sLSTM state per layer in
  place of a ring, and its mLSTM layers run the same kernel at prefill.
  Hybrid and recurrent models serve only on this layout.
* ``paged`` -- one shared page pool per layer, sized by the scheduler's
  ``PageAllocator`` (pool page *i* is allocator page *i*).  Inactive
  slots ride along with all -1 block-table rows, so their writes land in
  the pool's sink page and their reads mask out.  With ``cfg.use_pallas``
  decode attention runs the paged Hopper kernel over the live block
  tables.  Prefill computes only the uncached suffix of a prompt, in the
  chunks the scheduler plans (the ``prefill_chunk`` knob).

Each decode step runs every slot at once.  A per-slot live mask (the
plan's decoding requests) goes in beside the block tables: a slot outside
it -- empty, or parked on a tool call (a *pinned* suspend) -- keeps its
``pos``, its ring and a recurrent layer's state (SSM, mLSTM, sLSTM), so
a pinned request resumes where it stopped.  An encoder-decoder model is
refused: the reference's ``Engine`` passes its prefill no frames either
(ROADMAP §C), so such a model runs at the model level only.  With the
scheduler's ``mixed`` knob (paged layout only), prefill stops
serializing against decode: one mixed step runs every decode slot and
one prefill chunk padded to a fixed capacity (``_mixed_cap``), its
start, length and slot device scalars, as the reference's
``_mixed_step``.  A ``PrefixCache``
(``serving/prefix_cache.py``, attached with ``attach_cache``) hands
admission a shared prompt prefix as page ids in the block table: no KV
is copied.  Sampling runs on the device; only token ids cross to the
host.  ``extract_state``/``inject_state`` move one sequence between
engines of either layout through the batch-1 ring tree (recurrent
states included), which lives in host memory in between (pinned on the card):
the host tier of a tool-call suspend and the carrier of a migration.

On the card every decode step (both layouts) and every mixed step is a
replay of a CUDA graph captured once per engine (``serving/graphs.py``,
the counterpart of the reference's ``jax.jit`` with donated buffers;
``cuda_graphs=False`` runs them eagerly).  A graph writes the cache
tensors it was captured against, so every cache update keeps their
addresses: ``cache_insert``, ``paged_insert``, ``prefill_paged`` and the
steps themselves write in place.  Only a ``cache_layout`` flip builds a
new cache, and it drops the graphs, so the next step captures anew.
Serialized prefill (a ring one-shot prompt, a paged chunk) stays eager at
its exact length, as the reference retraces per length.
"""
from __future__ import annotations

import time
from collections import Counter

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs.base import ModelConfig
from repro_torch.core.knobs import KnobSpec
from repro_torch.core.types import Request, RequestState
from repro_torch.models.params import resolve_device
from repro_torch.serving import cache_utils, sampler
from repro_torch.serving.engine_base import EngineCore
from repro_torch.serving.graphs import StepGraph
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
                 cache_layout: str | None = None, device=None,
                 cuda_graphs: bool | None = None):
        if cfg.is_encdec:
            raise ValueError(
                f"{cfg.name} is an encoder-decoder model: the engine has no "
                f"frames to encode (serve it with models.prefill(frames=) "
                f"and models.decode_step)")
        self.device = resolve_device(device)
        if cache_layout not in (None, "ring", "paged"):
            raise ValueError(f"unknown cache layout {cache_layout!r}")
        if cuda_graphs is None:
            cuda_graphs = self.device.type == "cuda"
        if cuda_graphs and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not "
                             f"{self.device}")
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
        if sched_cfg.mixed and cache_layout != "paged":
            raise RuntimeError(
                f"{name}: mixed batching needs the paged cache layout "
                f"(got {cache_layout!r})")
        self._last_token = np.zeros((sched_cfg.max_slots,), np.int32)
        # fixed chunk capacity of the mixed step, set once so that moving
        # the prefill_chunk knob never changes the captured shapes (knob
        # values above it are clamped)
        self._mixed_cap = min(sched_cfg.max_batch_tokens,
                              sched_cfg.max_context)
        self._cuda_graphs = cuda_graphs
        self._graphs: dict[str, StepGraph] = {}
        # per step kind ("decode", "mixed"): programs made (graph
        # captures, or without graphs the one build of the static
        # buffers) and body runs (warm-up runs included, so launch
        # counts can be checked exactly)
        self.step_captures: Counter = Counter()
        self.step_runs: Counter = Counter()
        self._build_cache()

    # ----------------------------------------------------------- cache layout
    @property
    def cache_layout(self) -> str:
        return self._cache_layout

    @property
    def mixed_step_traces(self) -> int:
        """Programs made for the mixed step (the reference counts its
        traces): 1 whatever the churn, until a ``cache_layout`` flip
        builds a new cache and the step is captured anew."""
        return self.step_captures["mixed"]

    def _build_cache(self) -> None:
        sc = self.scheduler.cfg
        self.release_graphs()               # captured against the old cache
        self.cache = None                   # free the old cache first
        self.cache = models.init_cache(
            self.cfg, self.physical_slots(), sc.max_context,
            layout=self._cache_layout,
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
        if new == "ring" and self.scheduler.cfg.mixed:
            self._cache_layout = old            # revert before failing
            raise RuntimeError(
                f"{self.name}: cache_layout 'ring' is incompatible with "
                "mixed batching -- set mixed false first")
        self._build_cache()

    def on_knob_set(self, name: str, old, new) -> None:
        if name == "mixed" and new and self._cache_layout != "paged":
            self.scheduler.cfg.mixed = old      # revert before failing
            raise RuntimeError(
                f"{self.name}: mixed batching needs the paged cache "
                f"layout (current: {self._cache_layout!r})")
        super().on_knob_set(name, old, new)

    def _block_table_rows(self, reqs: list[Request]) -> np.ndarray:
        """(slots, P_max) int32 table, a row for each of the cache's
        slots (the ``max_num_seqs`` knob may use fewer): live rows come
        straight from ``PageAllocator.page_table`` (physical ids in
        logical order); inactive slots are all -1."""
        slots = self.physical_slots()
        out = np.full((slots, self._p_max), -1, np.int32)
        live = [r for r in reqs if 0 <= r.slot < slots]
        if live:
            rows = block_tables(self.scheduler.alloc,
                                [r.req_id for r in live], width=self._p_max)
            for r, row in zip(live, rows):
                out[r.slot] = row
        return out

    def _live_rows(self, reqs: list[Request]) -> np.ndarray:
        """(slots,) bool: the slots of ``reqs``, the rows a step decodes;
        every other slot's cache state is left as it is."""
        out = np.zeros((self.physical_slots(),), bool)
        out[[r.slot for r in reqs if 0 <= r.slot < out.shape[0]]] = True
        return out

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _temperature(self) -> torch.Tensor:
        return torch.full((), self.temperature, dtype=torch.float32,
                          device=self.device)

    # ---------------------------------------------------------- step graphs
    def _recurrent_state(self) -> list[torch.Tensor]:
        """The cache tensors a step updates from their own values: each
        slot's ``pos`` and the recurrent layers' states (a hybrid's SSM
        states, xLSTM's mLSTM memories and sLSTM states).  A capture's
        warm-up runs put them back; every other write of a step is the
        same on every run."""
        out = [self.cache["pos"]]
        for seg in self.cache["segments"]:
            for e in seg.values():
                for key in ("ssm", "s"):
                    if key in e:
                        out.extend(e[key])
                if "h" in e:
                    out.append(e["h"])
        return out

    def _step_graph(self, kind: str) -> StepGraph:
        g = self._graphs.get(kind)
        if g is not None:
            return g
        slots = self.physical_slots()
        tok, i32, f32 = torch.int64, torch.int32, torch.float32
        if kind == "decode":
            specs = {"tokens": ((slots, 1), tok),
                     "live": ((slots,), torch.bool), "temperature": ((), f32)}
            if self._cache_layout == "paged":
                specs["tables"] = ((slots, self._p_max), i32)
            body = self._decode_body
        else:
            specs = {"dec_tokens": ((slots, 1), tok),
                     "dec_live": ((slots,), torch.bool),
                     "pf_tokens": ((1, self._mixed_cap), tok),
                     "dec_tables": ((slots, self._p_max), i32),
                     "pf_table": ((1, self._p_max), i32),
                     "start": ((), i32), "n": ((), i32), "slot": ((), i32),
                     "temperature": ((), f32)}
            body = self._mixed_body
        g = StepGraph(body, specs, self.device, graphed=self._cuda_graphs,
                      restore=self._recurrent_state(), generator=self._gen)
        self._graphs[kind] = g
        return g

    def _run_step(self, kind: str, **arrays) -> np.ndarray:
        """Run the ``kind`` step on ``arrays``; its sampled ids on the
        host."""
        g = self._step_graph(kind)
        captures, runs = g.captures, g.runs
        out = g.run(**arrays).cpu().numpy()
        self.step_captures[kind] += g.captures - captures
        self.step_runs[kind] += g.runs - runs
        return out

    def release_graphs(self) -> None:
        """Drop the step graphs and free their memory pools; the next step
        captures anew."""
        for g in self._graphs.values():
            g.close()
        self._graphs.clear()

    def _decode_body(self, tokens, live, temperature,
                     tables=None) -> torch.Tensor:
        logits, _ = models.decode_step(self.params, self.cfg, tokens,
                                       self.cache, tables, live)
        return sampler.sample(logits, self._gen, temperature)

    def _mixed_body(self, dec_tokens, dec_live, pf_tokens, dec_tables,
                    pf_table, start, n, slot, temperature) -> torch.Tensor:
        """Every decode slot, then the prefill chunk.  The decode rows
        write into their own pages and advance their own ``pos``; the
        chunk attends into its resident prefix pages and sets its slot's
        ``pos`` absolutely.  Returns the decode ids and then the chunk's
        id, (max_slots + 1,)."""
        dec_logits, _ = models.decode_step(self.params, self.cfg, dec_tokens,
                                           self.cache, dec_tables, dec_live)
        pf_logits, _ = models.prefill_paged_padded(
            self.params, self.cfg, pf_tokens, self.cache, pf_table, start,
            slot, n)
        return torch.cat([sampler.sample(dec_logits, self._gen, temperature),
                          sampler.sample(pf_logits, self._gen, temperature)])

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
        elif plan.kind == StepKind.MIXED:
            self._run_mixed(plan)
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
        first = int(sampler.sample(logits, self._gen, self._temperature())[0])
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
        first = int(sampler.sample(logits, self._gen, self._temperature())[0])
        self._last_token[req.slot] = first
        return first

    # ------------------------------------------------------------------ mixed
    @torch.inference_mode()
    def _run_mixed(self, plan) -> None:
        """One fused step: every live decode slot advances a token while
        one prefill chunk computes.  Every input of the step has a fixed
        shape (see ``_step_graph``)."""
        if self._cache_layout != "paged":
            raise RuntimeError(
                f"{self.name}: mixed batching needs the paged cache "
                f"layout (current: {self._cache_layout!r})")
        work = plan.prefills[0]
        req = work.req
        live = [r for r in plan.decodes
                if self.scheduler.ensure_decode_capacity(r)]
        cap = self._mixed_cap
        chunk = min(work.chunk, cap)
        work.chunk = chunk                  # bookkeeping sees the clamp
        start = req.prefilled
        buf = np.zeros((1, cap), np.int64)
        buf[0, :chunk] = req.prompt_tokens[start:start + chunk]
        toks = self._run_step(
            "mixed", dec_tokens=self._last_token[:, None],
            dec_live=self._live_rows(live), pf_tokens=buf,
            dec_tables=self._block_table_rows(live),
            pf_table=self._block_table_rows([req])[req.slot][None],
            start=start, n=chunk, slot=req.slot,
            temperature=self.temperature)
        out = []
        for r in live:
            t = int(toks[r.slot])
            self._last_token[r.slot] = t
            out.append(t)
        final = (start + chunk) >= req.prompt_len
        first = int(toks[-1]) if final else None
        if final:
            self._last_token[req.slot] = first
        now = self.now()
        self.apply_prefill([work], [first], now)
        if live:
            self.apply_decode(live, out, now)

    # ----------------------------------------------------------------- decode
    @torch.inference_mode()
    def _run_decode(self, reqs: list[Request]) -> list[int]:
        arrays = {"tokens": self._last_token[:, None],
                  "live": self._live_rows(reqs),
                  "temperature": self.temperature}
        if self._cache_layout == "paged":
            arrays["tables"] = self._block_table_rows(reqs)
        toks = self._run_step("decode", **arrays)
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
        sequence, for migration and the host tier of a suspend.  Both
        layouts export the same format, so the receiving engine never
        cares which layout produced it.  The tree is a copy in host
        memory, as the reference's ``jax.device_get``: pinned, and
        complete when this returns, so the scheduler may free the pages
        next (``cache_utils.to_host``)."""
        if self._cache_layout == "paged":
            row = self._block_table_rows([req])[req.slot]
            ctx = int(self.cache["pos"][req.slot])
            sub = models.paged_extract(self.cfg, self.cache, row, ctx,
                                       self.scheduler.cfg.max_context,
                                       req.slot)
        else:
            sub = cache_utils.cache_extract(self.cache, req.slot, self._axes)
        sub = cache_utils.to_host(sub)
        return {"cache": sub,
                "last_token": int(self._last_token[req.slot]),
                "nbytes": cache_utils.cache_nbytes(sub)}

    @torch.inference_mode()
    def inject_state(self, req: Request, state: dict) -> None:
        """Install a migrated or host-tier request into a fresh slot
        (already admitted: ``req.slot`` assigned, scheduler pages
        reserved); the tree may lie in host memory.  A ring engine
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
