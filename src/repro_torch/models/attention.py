"""Attention (port of ``repro/models/attention.py``): GQA projections,
the masked-softmax core, the ring-buffer KV cache and the shared paged
pool.

Two layouts share one masked-softmax core:

* ``ring``  -- slot-contiguous ring buffers (``KVCache``) whose ``kpos``
  holds each slot's absolute position.  One-shot prefill runs
  ``attention_full`` over the prompt (query-chunked, window-sliced) and
  writes the surviving tail into the ring; decode writes its token and
  attends with ``attention_cached``.  With ``cfg.use_pallas`` prefill
  runs the Hopper kernel ``kernels.flash_attention`` and decode
  ``kernels.decode_attention``.
* ``paged`` -- one shared page pool per layer (``PagedKVCache``).
  Decode with ``cfg.use_pallas`` runs ``kernels.paged_decode_attention``
  straight over the pool and the live block tables; everything else
  gathers a contiguous view of each sequence's pages (``paged_view``)
  and runs ``attention_cached``, as the reference does.

JAX updates caches functionally and donates the old buffers; here ring
and pool are updated in place (``index_put_``) and the same tensors are
returned.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.kernels import (decode_attention, flash_attention,
                                 paged_decode_attention)
from repro_torch.models.layers import apply_rope
from repro_torch.models.params import P

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Parameter defs
# ---------------------------------------------------------------------------


def attn_defs(cfg: ModelConfig, cross: bool = False) -> dict:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    defs = {
        "wq": P((d, h, dh), ("embed", "heads", None)),
        "wk": P((d, hkv, dh), ("embed", "kv_heads", None)),
        "wv": P((d, hkv, dh), ("embed", "kv_heads", None)),
        "wo": P((h, dh, d), ("heads", None, "embed")),
    }
    if cfg.qk_norm and not cross:
        defs["q_scale"] = P((dh,), (None,), init="ones", dtype="float32")
        defs["k_scale"] = P((dh,), (None,), init="ones", dtype="float32")
    return defs


# ---------------------------------------------------------------------------
# Core masked attention (GQA grouped layout)
# ---------------------------------------------------------------------------


def _group(q: torch.Tensor, hkv: int) -> torch.Tensor:
    b, s, h, dh = q.shape
    return q.reshape(b, s, hkv, h // hkv, dh)


def _qk_rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(dt)


def attn_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """q: (B,Sq,Hkv,G,dh); k,v: (B,T,Hkv,dh); mask: (B,1,1,Sq,T) or
    broadcastable.  Scores and softmax in f32.  Returns (B,Sq,Hkv,G,dh)."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhgd,bthd->bhgqt", q.float(), k.float())
    scores = scores * (1.0 / math.sqrt(dh))
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgqt,bthd->bqhgd", probs.to(v.dtype), v)


# ---------------------------------------------------------------------------
# Full-sequence path (one-shot prefill)
# ---------------------------------------------------------------------------


def _causal_window_mask(qpos: torch.Tensor, kpos: torch.Tensor,
                        window: int) -> torch.Tensor:
    """qpos (Sq,), kpos (T,) -> (1,1,1,Sq,T) bool."""
    m = kpos[None, :] <= qpos[:, None]
    if window > 0:
        m &= kpos[None, :] > (qpos[:, None] - window)
    return m[None, None, None]


def attention_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   window: int, chunk: int, causal: bool = True
                   ) -> torch.Tensor:
    """q (B,S,H,dh) vs k,v (B,T,Hkv,dh), queries chunked by ``chunk``.
    A windowed layer reads only the ``window + chunk`` keys a query chunk
    can see, as the reference's ``dynamic_slice`` does."""
    b, s, h, dh = q.shape
    t = k.shape[1]
    hkv = k.shape[2]
    qg = _group(q, hkv)
    dev = q.device

    if not causal:
        mask = torch.ones((1, 1, 1, s, t), dtype=torch.bool, device=dev)
        return attn_core(qg, k, v, mask).reshape(b, s, h, dh)

    if s <= chunk or s % chunk != 0:
        mask = _causal_window_mask(torch.arange(s, device=dev),
                                   torch.arange(t, device=dev), window)
        return attn_core(qg, k, v, mask).reshape(b, s, h, dh)
    use_slice = window > 0 and t > window + chunk
    kv_span = window + chunk if use_slice else t
    outs = []
    for qs in range(0, s, chunk):
        ks = min(max(qs - window, 0), t - kv_span) if use_slice else 0
        kpos = torch.arange(ks, ks + kv_span, device=dev)
        qpos = torch.arange(qs, qs + chunk, device=dev)
        outs.append(attn_core(qg[:, qs:qs + chunk], k[:, ks:ks + kv_span],
                              v[:, ks:ks + kv_span],
                              _causal_window_mask(qpos, kpos, window)))
    return torch.cat(outs, dim=1).reshape(b, s, h, dh)


# ---------------------------------------------------------------------------
# Ring-buffer KV cache
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """Ring buffer over ``size`` slots; ``kpos`` holds the absolute
    position written in each slot (-1 = empty).  For full-attention
    layers ``size`` is the max context, so the ring never wraps; for SWA
    layers it is ``window + chunk`` rounded up (``kv_cache_size``).
    ``paged_view`` returns the same type for a gathered view."""

    k: torch.Tensor       # (B, size, Hkv, dh)
    v: torch.Tensor       # (B, size, Hkv, dh)
    kpos: torch.Tensor    # (B, size) int32


def kv_cache_size(spec: BlockSpec, max_context: int, chunk: int) -> int:
    if spec.window > 0:
        size = spec.window + chunk
        return min(-(-size // chunk) * chunk, max_context)
    return max_context


def init_kv_cache(batch: int, size: int, hkv: int, dh: int,
                  dtype: torch.dtype, device: torch.device) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, size, hkv, dh), dtype=dtype, device=device),
        v=torch.zeros((batch, size, hkv, dh), dtype=dtype, device=device),
        kpos=torch.full((batch, size), -1, dtype=torch.int32, device=device))


def cache_write(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                start_pos: torch.Tensor) -> KVCache:
    """Write S_new tokens at absolute positions start_pos..start_pos+S_new
    (start_pos (B,) int32), in place.  If S_new exceeds the ring size only
    the last ``size`` tokens are written (the older ones would be
    overwritten anyway), which keeps the scatter slots unique."""
    b, s_new = k_new.shape[:2]
    size = cache.k.shape[1]
    start = start_pos.long()
    if s_new > size:
        k_new = k_new[:, s_new - size:]
        v_new = v_new[:, s_new - size:]
        start = start + (s_new - size)
        s_new = size
    pos = start[:, None] + torch.arange(s_new, device=start.device)[None, :]
    slots = torch.remainder(pos, size)
    bidx = torch.arange(b, device=start.device)[:, None].expand(b, s_new)
    cache.k.index_put_((bidx, slots), k_new.to(cache.k.dtype))
    cache.v.index_put_((bidx, slots), v_new.to(cache.v.dtype))
    cache.kpos.index_put_((bidx, slots), pos.to(torch.int32))
    return cache


def _cached_mask(kpos: torch.Tensor, q_pos: torch.Tensor,
                 window: int) -> torch.Tensor:
    """kpos (B,T), q_pos (B,Sq) -> (B,1,1,Sq,T) bool."""
    mask = (kpos[:, None, :] <= q_pos[:, :, None]) & (kpos[:, None, :] >= 0)
    if window > 0:
        mask &= kpos[:, None, :] > (q_pos[:, :, None] - window)
    return mask[:, None, None]


def attention_cached(q: torch.Tensor, cache: KVCache, q_pos: torch.Tensor, *,
                     window: int, chunk: int = 0) -> torch.Tensor:
    """q: (B,Sq,H,dh) at absolute positions q_pos (B,Sq), against tokens
    already written (write-then-attend).  Sq that is a multiple of
    ``chunk`` and larger runs in ``chunk``-sized query blocks."""
    b, sq, h, dh = q.shape
    hkv = cache.k.shape[2]
    qg = _group(q, hkv)
    if chunk and sq > chunk and sq % chunk == 0:
        outs = [attn_core(qg[:, i:i + chunk], cache.k, cache.v,
                          _cached_mask(cache.kpos, q_pos[:, i:i + chunk],
                                       window))
                for i in range(0, sq, chunk)]
        return torch.cat(outs, dim=1).reshape(b, sq, h, dh)
    out = attn_core(qg, cache.k, cache.v,
                    _cached_mask(cache.kpos, q_pos, window))
    return out.reshape(b, sq, h, dh)


# ---------------------------------------------------------------------------
# Paged-pool KV cache
# ---------------------------------------------------------------------------


class PagedKVCache(NamedTuple):
    """Shared KV page pool for one layer: ``(num_pages + 1, page, Hkv,
    dh)``.  Pool page ``i`` is ``PageAllocator`` page ``i``; the extra
    last page is the write sink for rows whose block-table entry is -1
    (inactive slots, positions past the mapped tail)."""

    k: torch.Tensor       # (num_pages + 1, page, Hkv, dh)
    v: torch.Tensor       # (num_pages + 1, page, Hkv, dh)


def init_paged_kv_cache(num_pages: int, page: int, hkv: int, dh: int,
                        dtype: torch.dtype,
                        device: torch.device) -> PagedKVCache:
    shape = (num_pages + 1, page, hkv, dh)
    return PagedKVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                        v=torch.zeros(shape, dtype=dtype, device=device))


def _phys_slots(cache: PagedKVCache, tables: torch.Tensor,
                pos: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Map absolute token positions (B,S) through block tables (B,P) to
    (physical page, in-page slot); unmapped positions hit the sink."""
    page = cache.k.shape[1]
    p_max = tables.shape[1]
    sink = cache.k.shape[0] - 1
    logical = torch.div(pos.long(), page, rounding_mode="floor")
    phys = torch.gather(tables.long(), 1, logical.clamp(0, p_max - 1))
    bad = (phys < 0) | (logical < 0) | (logical >= p_max)
    return torch.where(bad, sink, phys), torch.remainder(pos.long(), page)


def paged_cache_write_at(cache: PagedKVCache, k_new: torch.Tensor,
                         v_new: torch.Tensor, pos: torch.Tensor,
                         tables: torch.Tensor) -> PagedKVCache:
    """Scatter tokens (B,S,Hkv,dh) at absolute positions (B,S) into the
    pool, in place; negative or unmapped positions hit the sink page."""
    phys, slot = _phys_slots(cache, tables, pos)
    cache.k.index_put_((phys, slot), k_new.to(cache.k.dtype))
    cache.v.index_put_((phys, slot), v_new.to(cache.v.dtype))
    return cache


def paged_view(cache: PagedKVCache, tables: torch.Tensor) -> KVCache:
    """Gather a (B, P*page) contiguous view of each sequence's pages.
    ``kpos`` is the absolute position for mapped pages, -1 for the
    unmapped tail."""
    b, p_max = tables.shape
    page, hkv, dh = cache.k.shape[1:]
    phys = tables.long().clamp(min=0)
    kg = cache.k[phys].reshape(b, p_max * page, hkv, dh)
    vg = cache.v[phys].reshape(b, p_max * page, hkv, dh)
    t = p_max * page
    kpos = torch.arange(t, dtype=torch.int32,
                        device=tables.device)[None].expand(b, t)
    mapped = torch.repeat_interleave(tables >= 0, page, dim=1)
    return KVCache(kg, vg, torch.where(mapped, kpos, -1))


def self_attention_paged(params: dict, x: torch.Tensor, cache: PagedKVCache,
                         cfg: ModelConfig, spec: BlockSpec,
                         positions: torch.Tensor, tables: torch.Tensor,
                         ) -> tuple[torch.Tensor, PagedKVCache]:
    """Write-then-attend over the shared page pool, for decode (Sq = 1)
    and suffix prefill (Sq = uncached prompt tokens)."""
    q, k, v = qkv_project(params, x, cfg, positions)
    pos1 = _pos1d(positions)
    cache = paged_cache_write_at(cache, k, v, pos1, tables)
    if cfg.use_pallas and q.shape[1] == 1:
        # the just-written token sits at pos, so ctx = pos + 1; a row
        # whose head page is unmapped is an inactive slot: no context
        ctx = torch.where(tables[:, 0] >= 0, pos1[:, 0] + 1, 0)
        out = paged_decode_attention(q, cache.k, cache.v, tables,
                                     ctx.to(torch.int32), window=spec.window)
    else:
        view = paged_view(cache, tables)
        out = attention_cached(q, view, pos1, window=spec.window,
                               chunk=cfg.attn_chunk)
    return out_project(params, out), cache


# ---------------------------------------------------------------------------
# Ring entry points (one-shot prefill, write-then-attend decode)
# ---------------------------------------------------------------------------


def self_attention_cached(params: dict, x: torch.Tensor, cache: KVCache,
                          cfg: ModelConfig, spec: BlockSpec,
                          positions: torch.Tensor
                          ) -> tuple[torch.Tensor, KVCache]:
    """Write this block of tokens into the ring, then attend.  Decode
    (Sq = 1) with ``cfg.use_pallas`` runs the ring decode kernel over the
    ring and its ``kpos``."""
    q, k, v = qkv_project(params, x, cfg, positions)
    pos1 = _pos1d(positions)
    cache = cache_write(cache, k, v, pos1[:, 0])
    if cfg.use_pallas and q.shape[1] == 1:
        out = decode_attention(q, cache.k, cache.v, cache.kpos,
                               pos1[:, 0].contiguous(), window=spec.window)
    else:
        out = attention_cached(q, cache, pos1, window=spec.window,
                               chunk=cfg.attn_chunk)
    return out_project(params, out), cache


def self_attention_prefill(params: dict, x: torch.Tensor, cache: KVCache,
                           cfg: ModelConfig, spec: BlockSpec,
                           positions: torch.Tensor
                           ) -> tuple[torch.Tensor, KVCache]:
    """One-shot prefill from position 0: causal (windowed) attention over
    the prompt itself, then the surviving tail written into the ring.
    With ``cfg.use_pallas`` the attention is the flash kernel."""
    q, k, v = qkv_project(params, x, cfg, positions)
    if cfg.use_pallas:
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=True, window=spec.window)
    else:
        out = attention_full(q, k, v, window=spec.window,
                             chunk=cfg.attn_chunk)
    cache = cache_write(cache, k, v, _pos1d(positions)[:, 0])
    return out_project(params, out), cache


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------


def qkv_project(params: dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, rope: bool = True):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if cfg.qk_norm and "q_scale" in params:
        q = _qk_rms(q, params["q_scale"], cfg.norm_eps)
        k = _qk_rms(k, params["k_scale"], cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return q, k, v


def out_project(params: dict, out: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])


def _pos1d(positions: torch.Tensor) -> torch.Tensor:
    """(B,S) from (B,S) or (B,S,3)."""
    return positions[..., 0] if positions.ndim == 3 else positions
