"""Model assembly (port of ``repro/models/transformer.py``): embeddings
→ stack-plan segments → final norm → unembed, with the paged serving
entry points ``init_cache(layout="paged")``, ``decode_step(tables=)``
and ``prefill_paged``.

The reference runs each stacked segment with ``lax.scan``; here it is a
Python loop over the leading ``(n,)`` (or ``(repeat, n)``) dims of the
stacked parameters and pools.  The cache is updated in place: a step
returns the same pool tensors it was given.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig, Segment
from repro_torch.models import params as prm
from repro_torch.models.attention import PagedKVCache
from repro_torch.models.blocks import (block_apply, block_defs,
                                       init_paged_block_cache)
from repro_torch.models.layers import (embed, embed_defs, rmsnorm,
                                       rmsnorm_defs, unembed, unembed_defs,
                                       unembed_tied)

# ---------------------------------------------------------------------------
# Defs / parameters
# ---------------------------------------------------------------------------


def _stack_dims(seg: Segment, n: int) -> tuple[int, ...]:
    return (seg.repeat, n) if seg.repeat > 1 else (n,)


def _segment_defs(cfg: ModelConfig, seg: Segment) -> dict:
    return {f"e{j}": prm.stack(block_defs(cfg, spec), *_stack_dims(seg, n))
            for j, (spec, n) in enumerate(seg.pattern)}


def model_defs(cfg: ModelConfig) -> dict:
    if cfg.is_encdec:
        raise NotImplementedError(
            "encoder-decoder models are not ported yet (ROADMAP queue A: "
            "enc-dec)")
    defs: dict[str, Any] = {
        "embed": embed_defs(cfg.vocab, cfg.d_model),
        "final_norm": rmsnorm_defs(cfg.d_model),
        "decoder": [_segment_defs(cfg, s) for s in cfg.plan()],
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = unembed_defs(cfg.d_model, cfg.vocab)
    return defs


def init(cfg: ModelConfig, generator: torch.Generator, device=None) -> dict:
    """The port's own random weights, by the reference's rule (fan-in
    scaled normal, ones for norms, f32 where the defs say so).  Draws on
    ``generator``'s device."""
    dev = prm.resolve_device(device)
    return prm.init_params(model_defs(cfg), generator,
                           prm.torch_dtype(cfg.dtype), dev)


def param_count(cfg: ModelConfig) -> int:
    return prm.count_params(model_defs(cfg))


# ---------------------------------------------------------------------------
# Stack execution
# ---------------------------------------------------------------------------


def _layer(tree, idx: tuple[int, ...]):
    """One layer's slice of a stacked tree (views, so in-place cache
    writes land in the stacked pools)."""
    if isinstance(tree, PagedKVCache):
        return PagedKVCache(tree.k[idx], tree.v[idx])
    if isinstance(tree, dict):
        return {k: _layer(v, idx) for k, v in tree.items()}
    return tree[idx]


def _run_plan(cfg: ModelConfig, params_list, x, positions, cache_list,
              tables):
    for seg, seg_params, seg_cache in zip(cfg.plan(), params_list,
                                          cache_list):
        for r in range(seg.repeat):
            for j, (spec, n) in enumerate(seg.pattern):
                for i in range(n):
                    idx = (r, i) if seg.repeat > 1 else (i,)
                    x = block_apply(_layer(seg_params[f"e{j}"], idx), x,
                                    cfg, spec, positions,
                                    _layer(seg_cache[f"e{j}"], idx), tables)
    return x


# ---------------------------------------------------------------------------
# Positions / logits
# ---------------------------------------------------------------------------


def default_positions(cfg: ModelConfig, b: int, s: int, offset=None,
                      device=None) -> torch.Tensor:
    if cfg.mrope_sections:
        raise NotImplementedError(
            "M-RoPE positions are not ported yet (ROADMAP queue A: VLM)")
    dev = offset.device if offset is not None else device
    pos = torch.arange(s, dtype=torch.int32, device=dev)[None, :].expand(b, s)
    if offset is not None:
        pos = pos + offset.to(torch.int32)[:, None]
    return pos


def _logits(params, cfg: ModelConfig, x):
    if cfg.tie_embeddings:
        return unembed_tied(params["embed"], x, cfg.logit_softcap)
    return unembed(params["unembed"], x, cfg.logit_softcap)


# ---------------------------------------------------------------------------
# Cache + serving entry points
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_context: int,
               layout: str = "paged", num_pages: int = 0,
               page_size: int = 128, device=None) -> dict:
    """Decode state: one shared page pool per layer (stacked per
    segment element), sized by the allocator's ``num_pages``, plus the
    per-slot next position ``pos``.  ``max_context`` bounds the block
    tables the engine passes; the pool itself does not depend on it."""
    if layout != "paged":
        raise NotImplementedError(
            f"cache layout {layout!r} is not ported yet (ROADMAP queue A: "
            "ring layout)")
    if num_pages <= 0:
        raise ValueError("paged cache layout needs num_pages > 0")
    dev = prm.resolve_device(device)
    dtype = prm.torch_dtype(cfg.dtype)
    segments = [
        {f"e{j}": init_paged_block_cache(cfg, spec, num_pages, page_size,
                                         dtype, dev, _stack_dims(seg, n))
         for j, (spec, n) in enumerate(seg.pattern)}
        for seg in cfg.plan()]
    return {"segments": segments,
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, cache: dict,
                tables: Optional[torch.Tensor] = None):
    """tokens: (B, 1), one new token per sequence; ``tables`` (B, P) the
    live block tables.  Returns (logits (B, V), cache), the cache updated
    in place and every slot's ``pos`` advanced by one."""
    if tables is None:
        raise NotImplementedError(
            "decode without block tables is the ring layout (ROADMAP queue "
            "A: ring layout)")
    pos = cache["pos"]                                   # (B,)
    x = embed(params["embed"], tokens)
    x = _run_plan(cfg, params["decoder"], x, pos[:, None],
                  cache["segments"], tables)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _logits(params, cfg, x)[:, 0]
    pos += 1
    return logits, cache


def prefill_paged(params, cfg: ModelConfig, tokens: torch.Tensor, cache: dict,
                  tables: torch.Tensor, start: torch.Tensor, slot: int):
    """Suffix prefill into the shared page pool.

    tokens (1, S): the uncached prompt suffix; start (1,) int32: its
    absolute position; tables (1, P): the sequence's block-table row
    (resident prefix pages first); slot: the batch slot whose ``pos`` to
    set.  Returns (last-token logits (1, V), cache)."""
    b, s = tokens.shape
    positions = default_positions(cfg, b, s, offset=start)
    x = embed(params["embed"], tokens)
    x = _run_plan(cfg, params["decoder"], x, positions, cache["segments"],
                  tables)
    x_last = rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    logits = _logits(params, cfg, x_last)[:, 0]
    cache["pos"][slot] = start[0] + s
    return logits, cache
