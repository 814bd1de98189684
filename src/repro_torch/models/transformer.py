"""Model assembly (port of ``repro/models/transformer.py``): embeddings
→ stack-plan segments → final norm → unembed, with the serving entry
points of both KV layouts -- ring: ``init_cache(layout="ring")``,
``prefill`` and ``decode_step``; paged: ``init_cache(layout="paged")``,
``prefill_paged`` and ``decode_step(tables=)`` -- and the paged <-> ring
state bridge of KV migration (``paged_extract``, ``paged_insert``).
Hybrid (hymba) stacks run on the ring layout only; their caches carry
an ``SSMState`` beside each ring.

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
from repro_torch.models import attention as attn
from repro_torch.models.attention import KVCache, PagedKVCache
from repro_torch.models.blocks import (block_apply, block_defs,
                                       init_block_cache,
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
    writes land in the stacked pools).  Namedtuples (``KVCache``,
    ``PagedKVCache``, ``SSMState``) keep their type."""
    if isinstance(tree, tuple):
        return type(tree)(*(t[idx] for t in tree))
    if isinstance(tree, dict):
        return {k: _layer(v, idx) for k, v in tree.items()}
    return tree[idx]


def _run_plan(cfg: ModelConfig, params_list, x, positions, cache_list,
              tables, mode=None):
    for seg, seg_params, seg_cache in zip(cfg.plan(), params_list,
                                          cache_list):
        for r in range(seg.repeat):
            for j, (spec, n) in enumerate(seg.pattern):
                for i in range(n):
                    idx = (r, i) if seg.repeat > 1 else (i,)
                    x = block_apply(_layer(seg_params[f"e{j}"], idx), x,
                                    cfg, spec, positions,
                                    _layer(seg_cache[f"e{j}"], idx), tables,
                                    mode)
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
               layout: str = "ring", num_pages: int = 0,
               page_size: int = 128, device=None) -> dict:
    """Decode state, stacked per segment element, plus the per-slot next
    position ``pos``.  ``layout="ring"`` (default) builds slot-contiguous
    rings (``batch`` rows, ``kv_cache_size`` slots per layer);
    ``layout="paged"`` one shared page pool per layer sized by the
    allocator's ``num_pages``, where ``max_context`` only bounds the
    block tables the engine passes."""
    if layout not in ("ring", "paged"):
        raise ValueError(f"unknown cache layout {layout!r}")
    if layout == "paged" and num_pages <= 0:
        raise ValueError("paged cache layout needs num_pages > 0")
    dev = prm.resolve_device(device)
    dtype = prm.torch_dtype(cfg.dtype)

    def one(spec, stack):
        if layout == "paged":
            return init_paged_block_cache(cfg, spec, num_pages, page_size,
                                          dtype, dev, stack)
        return init_block_cache(cfg, spec, batch, max_context, dtype, dev,
                                stack)

    segments = [{f"e{j}": one(spec, _stack_dims(seg, n))
                 for j, (spec, n) in enumerate(seg.pattern)}
                for seg in cfg.plan()]
    return {"segments": segments,
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, cache: dict):
    """One-shot prefill of a ring cache from position 0.  tokens (B, S).
    Returns (last-token logits (B, V), cache), the cache updated in place
    and every row's ``pos`` set to S."""
    b, s = tokens.shape
    positions = default_positions(cfg, b, s, device=tokens.device)
    x = embed(params["embed"], tokens)
    x = _run_plan(cfg, params["decoder"], x, positions, cache["segments"],
                  None, "prefill")
    x_last = rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    logits = _logits(params, cfg, x_last)[:, 0]
    cache["pos"].fill_(s)
    return logits, cache


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, cache: dict,
                tables: Optional[torch.Tensor] = None):
    """tokens: (B, 1), one new token per sequence.  A paged cache needs
    ``tables`` (B, P), the live block tables; a ring cache takes none.
    Returns (logits (B, V), cache), the cache updated in place and every
    slot's ``pos`` advanced by one."""
    pos = cache["pos"]                                   # (B,)
    x = embed(params["embed"], tokens)
    x = _run_plan(cfg, params["decoder"], x, pos[:, None],
                  cache["segments"], tables, "step")
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


# ---------------------------------------------------------------------------
# Paged <-> ring state bridge (KV migration)
# ---------------------------------------------------------------------------


def _map_paged_kv(cache: dict, fn):
    """A copy of the cache's segment tree with ``fn`` applied to every
    PagedKVCache (leaves carry leading layer-stack dims), dict keys
    visited in sorted order."""
    def walk(node):
        if isinstance(node, PagedKVCache):
            return fn(node)
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(cache["segments"])


def _ring_leaves(tree) -> list[KVCache]:
    """The KVCache leaves of a segment tree, in the walk order of
    ``_map_paged_kv`` (a tree from the reference has its dict keys
    sorted, as ``jax.tree`` rebuilds them)."""
    if isinstance(tree, KVCache):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _ring_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _ring_leaves(v)]
    return []


def _as_table(table_row, device) -> torch.Tensor:
    return torch.as_tensor(table_row, dtype=torch.int32,
                           device=device).reshape(1, -1)


def paged_extract(cfg: ModelConfig, cache: dict, table_row, ctx: int,
                  max_context: int, slot: int) -> dict:
    """One sequence of the paged pool as a batch-1 *ring*-layout cache:
    the format ring engines extract and inject, so KV migration does not
    care which layout produced it.  Every layer's ring has
    ``max_context`` slots, as the reference's."""
    dev = cache["pos"].device
    tables = _as_table(table_row, dev)

    def one(pkv: PagedKVCache) -> KVCache:
        stack = pkv.k.shape[:-4]
        kf = pkv.k.reshape((-1,) + pkv.k.shape[-4:])
        vf = pkv.v.reshape((-1,) + pkv.v.shape[-4:])
        outs = [_pool_to_ring(cfg, PagedKVCache(kf[i], vf[i]), tables, ctx,
                              max_context) for i in range(kf.shape[0])]
        return KVCache(*(torch.stack(xs).reshape(stack + xs[0].shape)
                         for xs in zip(*outs)))

    return {"segments": _map_paged_kv(cache, one),
            "pos": cache["pos"][slot:slot + 1].clone()}


def _pool_to_ring(cfg: ModelConfig, pkv: PagedKVCache, tables: torch.Tensor,
                  ctx: int, max_context: int) -> KVCache:
    view = attn.paged_view(pkv, tables)                  # (1, P*page, ...)
    ring = attn.init_kv_cache(1, max_context, pkv.k.shape[-2],
                              pkv.k.shape[-1], pkv.k.dtype, pkv.k.device)
    if ctx <= 0:
        return ring
    n = min(ctx, view.k.shape[1])
    return attn.cache_write(ring, view.k[:, :n], view.v[:, :n],
                            torch.zeros((1,), dtype=torch.int32,
                                        device=pkv.k.device))


def paged_insert(cfg: ModelConfig, cache: dict, sub: dict, table_row,
                 slot: int) -> dict:
    """Install a batch-1 ring-layout cache (from ``paged_extract`` or a
    ring engine's extract) into the paged pool at ``table_row``'s pages,
    in place.  Ring slots scatter through their absolute ``kpos``, so a
    wrapped SWA ring lands at the right logical pages and empty slots
    hit the sink."""
    dev = cache["pos"].device
    tables = _as_table(table_row, dev)
    rings = iter(_ring_leaves(sub["segments"]))

    def one(pkv: PagedKVCache) -> PagedKVCache:
        ring = next(rings)
        kf = pkv.k.reshape((-1,) + pkv.k.shape[-4:])
        vf = pkv.v.reshape((-1,) + pkv.v.shape[-4:])
        rk = ring.k.reshape((-1,) + ring.k.shape[-4:]).to(dev)
        rv = ring.v.reshape((-1,) + ring.v.shape[-4:]).to(dev)
        rp = ring.kpos.reshape((-1,) + ring.kpos.shape[-2:]).to(dev)
        for i in range(kf.shape[0]):
            attn.paged_cache_write_at(PagedKVCache(kf[i], vf[i]), rk[i],
                                      rv[i], rp[i], tables)
        return pkv

    _map_paged_kv(cache, one)
    cache["pos"][slot] = sub["pos"][0].to(dev)
    return cache
