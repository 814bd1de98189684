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
  With ``cfg.use_pallas`` both run straight over the pool and the live
  block tables: decode (Sq = 1) on ``kernels.paged_decode_attention``,
  suffix prefill and the mixed step's chunk (Sq > 1) on
  ``kernels.paged_flash_attention``.  Without it every call gathers a
  contiguous view of each sequence's pages (``paged_view``) and runs
  ``attention_cached``, as the reference does for all but decode.

Cache-free paths serve the encoder of an encoder-decoder model:
``self_attention`` (``causal=False`` in an encoder block) and the cross
attention of a decoder block, whose keys are the encoder's memory:
``cross_kv_precompute`` projects it once at prefill into a ``CrossKV``
the decoder's cache keeps, and ``cross_attention_cached`` attends to it.
With ``cfg.use_pallas`` a full sequence runs the flash kernel
non-causal, and a decode step's cross attention the ring decode kernel
over the cross K/V (every key valid).  Training runs the encoder's self
attention and the decoder's ``cross_attention`` through flash under
grad, whose backward kernel takes the non-causal case too.

On a mesh whose model axis cuts the heads (TP), ``qkv_project`` and
``out_project`` are where the shards meet: each rank projects its own
heads and the output projection's partial sums are reduced.  The cross
attention does the same, its query input and the encoder's memory both
entering through ``copy_to``; the cross K/V a decoder's cache keeps is
cut by heads, as the reference's cache spec cuts it.  A ring whose
KV heads the cache spec keeps whole gets every KV head of the new tokens,
and each rank's query heads read theirs (``local_kv_heads``).

A serve step's cache spec may cut a ring's sequence axis
(``parallel.ring_shard``: the GQA fallback over ``model``, ``long_*``
over ``data``); ``kpos`` stays whole.  Each rank then writes the tokens
whose slots fall in its range (``cache_write_range``), prefill attends
over the prompt as before, and decode (``attend_range``) attends over
the rank's slots alone, with the query heads of the whole model axis
where the ring is cut over it, and combines the ranks' partial softmaxes
by their log-sum-exps (``kernels.attention_combine``).  A cross K/V cut
along its encoder axis (``parallel.cross_shard``) is read the same way
by a decode step's ``cross_attention_cached``.

Where the stack's S is cut over ``model`` (sequence parallelism), the
projections' input arrives gathered along S and ``out_project`` leaves
this rank's rows (``parallel.enter`` / ``leave``); the attention itself
runs over the whole sequence.

JAX updates caches functionally and donates the old buffers; here ring
and pool are updated in place (``index_put_``) and the same tensors are
returned.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.distributed import parallel
from repro_torch.kernels import (attention_combine, attention_combine_plain,
                                 decode_attention, flash_attention,
                                 paged_decode_attention,
                                 paged_flash_attention)
from repro_torch.models.layers import apply_rope
from repro_torch.models import params as prm
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


@torch.no_grad()
def rescale_to_true_fan_in(params) -> None:
    """Rescale, in place, every attention projection of a parameter tree
    drawn by the reference's rule (``models.init``) to a normal of its
    true fan-in: wq, wk and wv (..., d, heads, dh) to 1/sqrt(d), wo
    (..., heads, dh, d) to 1/sqrt(heads * dh).  The rule takes a
    weight's last-but-one axis as its fan-in, so it draws wq, wk and wv
    at 1/sqrt(heads) and wo at 1/sqrt(dh): attention scores get a std of
    64-314 and a deep stack's gradients explode (ROADMAP §C, reference
    fault 5).  Training entry points call this after ``init``."""
    if isinstance(params, list):
        for x in params:
            rescale_to_true_fan_in(x)
        return
    if not isinstance(params, dict):
        return
    for key, x in params.items():
        if key in ("wq", "wk", "wv"):
            x.mul_(math.sqrt(x.shape[-2] / x.shape[-3]))
        elif key == "wo":
            x.mul_(math.sqrt(1 / x.shape[-3]))
        else:
            rescale_to_true_fan_in(x)


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
                  dtype: torch.dtype, device: torch.device,
                  slots: Optional[int] = None) -> KVCache:
    """An empty ring of ``size`` slots; K and V hold ``slots`` of them
    where given (a rank's range of a sequence-sharded ring)."""
    n = size if slots is None else slots
    return KVCache(
        k=torch.zeros((batch, n, hkv, dh), dtype=dtype, device=device),
        v=torch.zeros((batch, n, hkv, dh), dtype=dtype, device=device),
        kpos=torch.full((batch, size), -1, dtype=torch.int32, device=device))


def cache_write(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                start_pos: torch.Tensor,
                live: Optional[torch.Tensor] = None) -> KVCache:
    """Write S_new tokens at absolute positions start_pos..start_pos+S_new
    (start_pos (B,) int32), in place.  If S_new exceeds the ring size only
    the last ``size`` tokens are written (the older ones would be
    overwritten anyway), which keeps the scatter slots unique.  ``live``
    (B,) bool, when given, marks the rows to write: every other row
    writes back what its slots hold, so an empty or parked slot's ring
    and ``kpos`` are left as they were (the shapes stay fixed for a
    captured step)."""
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
    k_new, v_new = k_new.to(cache.k.dtype), v_new.to(cache.v.dtype)
    pos = pos.to(torch.int32)
    if live is not None:
        keep = ~live[:, None]                            # (B, 1)
        k_new = torch.where(keep[..., None, None], cache.k[bidx, slots],
                            k_new)
        v_new = torch.where(keep[..., None, None], cache.v[bidx, slots],
                            v_new)
        pos = torch.where(keep, cache.kpos[bidx, slots], pos)
    cache.k.index_put_((bidx, slots), k_new)
    cache.v.index_put_((bidx, slots), v_new)
    cache.kpos.index_put_((bidx, slots), pos)
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


def attention_cached_lse(q: torch.Tensor, cache: KVCache,
                         q_pos: torch.Tensor, *, window: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``attention_cached`` over the slots of ``cache`` alone (one rank's
    range of a sequence-sharded ring), with each query row's natural
    log-sum-exp of its scaled scores: (out (B,Sq,H,dh), lse (B,Sq,H)
    f32).  A row with no valid slot gives zeros and NEG_INF, which
    ``attention_combine`` weighs 0."""
    b, sq, h, dh = q.shape
    hkv = cache.k.shape[2]
    mask = _cached_mask(cache.kpos, q_pos, window)       # (B,1,1,Sq,T)
    scores = torch.einsum("bqhgd,bthd->bhgqt", _group(q, hkv).float(),
                          cache.k.float()) * (1.0 / math.sqrt(dh))
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqt,bthd->bqhgd", probs.to(cache.v.dtype), cache.v)
    live = mask.any(-1)                                  # (B,1,1,Sq)
    lse = torch.where(live, torch.logsumexp(scores, dim=-1), NEG_INF)
    out = torch.where(live.permute(0, 3, 1, 2)[..., None], out, 0.0)
    return (out.reshape(b, sq, h, dh).to(q.dtype),
            lse.permute(0, 3, 1, 2).reshape(b, sq, h))


def cache_write_range(cache: KVCache, k_new: torch.Tensor,
                      v_new: torch.Tensor, start_pos: torch.Tensor,
                      shard: parallel.RingShard,
                      live: Optional[torch.Tensor] = None) -> KVCache:
    """``cache_write`` on this rank's slots [lo, lo + local) of a ring of
    ``total`` slots cut along its sequence axis, in place: each token's
    global slot is ``pos % total``, and the rank writes the tokens whose
    slot is in its range at ``slot - lo``.  ``kpos`` is whole on every
    rank and written as the unsharded ring's.

    One token a row (decode) scatters to one slot a row, so no index
    repeats; a row whose token another rank holds (or outside ``live``)
    writes back what its slot held.  Several tokens a row (prefill) may
    outnumber the range, so the rank instead merges its whole range once:
    slot j takes token ``(lo + j - start) % total`` where that is one of
    the new tokens, and keeps its content elsewhere."""
    b, s_new = k_new.shape[:2]
    size, lo, n = shard.total, shard.lo, shard.local
    start = start_pos.long()
    if s_new > size:
        k_new = k_new[:, s_new - size:]
        v_new = v_new[:, s_new - size:]
        start = start + (s_new - size)
        s_new = size
    dev = start.device
    pos = start[:, None] + torch.arange(s_new, device=dev)[None, :]
    slots = torch.remainder(pos, size)
    bidx = torch.arange(b, device=dev)[:, None].expand(b, s_new)
    kp = pos.to(torch.int32)
    if live is not None:
        kp = torch.where(~live[:, None], cache.kpos[bidx, slots], kp)
    cache.kpos.index_put_((bidx, slots), kp)
    k_new, v_new = k_new.to(cache.k.dtype), v_new.to(cache.v.dtype)
    if s_new == 1:
        mine = (slots >= lo) & (slots < lo + n)
        if live is not None:
            mine &= live[:, None]
        j = torch.where(mine, slots - lo, 0)
        keep = ~mine[..., None, None]
        cache.k.index_put_((bidx, j), torch.where(keep, cache.k[bidx, j],
                                                  k_new))
        cache.v.index_put_((bidx, j), torch.where(keep, cache.v[bidx, j],
                                                  v_new))
        return cache
    t = torch.remainder(lo + torch.arange(n, device=dev)[None, :]
                        - start[:, None], size)            # (B, local)
    take = t < s_new
    if live is not None:
        take &= live[:, None]
    src = t.clamp(max=s_new - 1)
    rows = torch.arange(b, device=dev)[:, None].expand(b, n)
    take = take[..., None, None]
    cache.k.copy_(torch.where(take, k_new[rows, src], cache.k))
    cache.v.copy_(torch.where(take, v_new[rows, src], cache.v))
    return cache


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
    and suffix prefill (Sq = uncached prompt tokens, or the mixed step's
    padded chunk, whose tail rows sit at position -1).  With
    ``cfg.use_pallas`` decode runs the paged decode kernel and Sq > 1 the
    paged flash kernel, both over the pool in place; without it the
    gather path, as the reference."""
    q, k, v = qkv_project(params, x, cfg, positions)
    pos1 = _pos1d(positions)
    cache = paged_cache_write_at(cache, k, v, pos1, tables)
    if cfg.use_pallas and q.shape[1] == 1:
        # the just-written token sits at pos, so ctx = pos + 1; a row
        # whose head page is unmapped is an inactive slot: no context
        ctx = torch.where(tables[:, 0] >= 0, pos1[:, 0] + 1, 0)
        out = paged_decode_attention(q, cache.k, cache.v, tables,
                                     ctx.to(torch.int32), window=spec.window)
    elif cfg.use_pallas:
        out = paged_flash_attention(q, cache.k, cache.v, tables,
                                    pos1.to(torch.int32).contiguous(),
                                    window=spec.window)
    else:
        view = paged_view(cache, tables)
        out = attention_cached(q, view, pos1, window=spec.window,
                               chunk=cfg.attn_chunk)
    return out_project(params, out, cfg), cache


# ---------------------------------------------------------------------------
# Ring entry points (one-shot prefill, write-then-attend decode)
# ---------------------------------------------------------------------------


def self_attention_cached(params: dict, x: torch.Tensor, cache: KVCache,
                          cfg: ModelConfig, spec: BlockSpec,
                          positions: torch.Tensor,
                          live: Optional[torch.Tensor] = None
                          ) -> tuple[torch.Tensor, KVCache]:
    """Write this block of tokens into the ring, then attend.  Decode
    (Sq = 1) with ``cfg.use_pallas`` runs the ring decode kernel over the
    ring and its ``kpos``.  Rows outside ``live`` (B,) bool leave their
    ring untouched (``cache_write``).  A ring whose sequence axis the
    step's cache spec cuts goes through ``cache_write_range`` and
    ``attend_range``."""
    q, k, v = qkv_project(params, x, cfg, positions,
                          all_kv=_holds_all_kv(cache, cfg))
    pos1 = _pos1d(positions)
    shard = parallel.ring_shard(cache.k, cache.kpos)
    if shard is not None:
        cache = cache_write_range(cache, k, v, pos1[:, 0], shard, live)
        out = attend_range(params, q, cache, pos1, cfg, spec.window, shard)
        return out_project(params, out, cfg), cache
    cache = cache_write(cache, k, v, pos1[:, 0], live)
    kc, vc = _read_kv(params, cfg, cache.k), _read_kv(params, cfg, cache.v)
    if cfg.use_pallas and q.shape[1] == 1:
        out = decode_attention(q, kc, vc, cache.kpos,
                               pos1[:, 0].contiguous(), window=spec.window)
    else:
        out = attention_cached(q, KVCache(kc, vc, cache.kpos), pos1,
                               window=spec.window, chunk=cfg.attn_chunk)
    return out_project(params, out, cfg), cache


def attend_range(params: dict, q: torch.Tensor, cache: KVCache,
                 pos1: torch.Tensor, cfg: ModelConfig, window: int,
                 shard: parallel.RingShard) -> torch.Tensor:
    """Attention of this rank's query heads q (B,Sq,H,dh) over a ring cut
    along its sequence axis: every rank of the ring's group attends over
    its own slots, with the query heads of the whole model axis where
    the ring is cut over it (they are gathered; the cache then holds
    every KV head), the partial outputs and log-sum-exps are gathered
    over the group and combined, and this rank keeps its own heads.
    With ``cfg.use_pallas`` a decode step runs ``decode_attention`` with
    its log-sum-exp and the combine kernel; else the plain versions.
    The partials are gathered and combined in f32."""
    b, sq, h, dh = q.shape
    q_off = prm.tp(params["wq"], -2, cfg.n_heads)
    gather_q = q_off is not None and "model" in parallel.entry_axes(
        shard.entry)
    if gather_q:
        # gathered in f32 (exact for bf16), as every serving gather here
        q = parallel.gather_cat(q.float(), 2,
                                parallel.current().model).to(q.dtype)
        k, v = cache.k, cache.v
    else:
        k, v = _read_kv(params, cfg, cache.k), _read_kv(params, cfg, cache.v)
    kpos = cache.kpos[:, shard.lo:shard.lo + shard.local].contiguous()
    if cfg.use_pallas and sq == 1:
        out, lse = decode_attention(q.contiguous(), k, v, kpos,
                                    pos1[:, 0].contiguous(),
                                    window=window, with_lse=True)
        lse = lse[:, None]
    else:
        out, lse = attention_cached_lse(q, KVCache(k, v, kpos), pos1,
                                        window=window)
    outs = parallel.all_gather(out.float(), shard.group)
    lses = parallel.all_gather(lse, shard.group)
    if gather_q:
        outs = outs[:, :, :, q_off:q_off + h]
        lses = lses[:, :, :, q_off:q_off + h]
    combine = attention_combine if cfg.use_pallas else \
        attention_combine_plain
    out = combine(outs.reshape(shard.n, b * sq, h, dh),
                  lses.reshape(shard.n, b * sq, h))
    return out.reshape(b, sq, h, dh).to(q.dtype)


def self_attention_prefill(params: dict, x: torch.Tensor, cache: KVCache,
                           cfg: ModelConfig, spec: BlockSpec,
                           positions: torch.Tensor
                           ) -> tuple[torch.Tensor, KVCache]:
    """One-shot prefill from position 0: causal (windowed) attention over
    the prompt itself, then the surviving tail written into the ring (a
    rank's range of it, where the step's cache spec cuts its sequence
    axis).  With ``cfg.use_pallas`` the attention is the flash kernel."""
    q, k, v = qkv_project(params, x, cfg, positions,
                          all_kv=_holds_all_kv(cache, cfg))
    ka, va = _read_kv(params, cfg, k), _read_kv(params, cfg, v)
    if cfg.use_pallas:
        out = flash_attention(q.contiguous(), ka.contiguous(),
                              va.contiguous(), causal=True,
                              window=spec.window)
    else:
        out = attention_full(q, ka, va, window=spec.window,
                             chunk=cfg.attn_chunk)
    start = _pos1d(positions)[:, 0]
    shard = parallel.ring_shard(cache.k, cache.kpos)
    if shard is None:
        cache = cache_write(cache, k, v, start)
    else:
        cache = cache_write_range(cache, k, v, start, shard)
    return out_project(params, out, cfg), cache


def _holds_all_kv(cache: KVCache, cfg: ModelConfig) -> bool:
    """Whether the ring holds every KV head (the cache spec keeps them
    whole, also where the model axis cuts the query heads)."""
    return cache.k.shape[-2] == cfg.n_kv_heads


def _read_kv(params: dict, cfg: ModelConfig, t: torch.Tensor
             ) -> torch.Tensor:
    """The KV heads of ``t`` (B, T, Hkv, dh) that this rank's query heads
    read: ``t`` itself, or a view of ``local_kv_heads`` of it where ``t``
    holds every KV head while the model axis cuts the query heads."""
    q_off = prm.tp(params["wq"], -2, cfg.n_heads)
    if q_off is None or t.shape[-2] != cfg.n_kv_heads:
        return t
    k0, k1 = local_kv_heads(cfg, q_off, params["wq"].shape[-2])
    return t[..., k0:k1, :]


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------


def qkv_project(params: dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, rope: bool = True,
                all_kv: bool = False):
    """q, k, v of ``x``.  On a mesh whose model axis cuts the heads (TP)
    they are this rank's heads: ``x`` (and the qk-norm scales) enter the
    region through ``copy_to``, and where the rules replicate the KV heads
    (fewer than the model axis) this rank takes the KV heads its query
    heads read, their weights through ``copy_to`` too, or every KV head
    with ``all_kv`` (for a ring that holds them all)."""
    wq = params["wq"]
    q_scale, k_scale = params.get("q_scale"), params.get("k_scale")
    model, wk, wv = _head_shards(params, cfg, all_kv)
    x = parallel.enter(x, model)
    if model is not None:
        if q_scale is not None:
            q_scale = parallel.copy_to(q_scale, model)
            k_scale = parallel.copy_to(k_scale, model)
    q = torch.einsum("bsd,dhk->bshk", x, wq)
    k = torch.einsum("bsd,dhk->bshk", x, wk)
    v = torch.einsum("bsd,dhk->bshk", x, wv)
    if cfg.qk_norm and q_scale is not None:
        q = _qk_rms(q, q_scale, cfg.norm_eps)
        k = _qk_rms(k, k_scale, cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return q, k, v


def _head_shards(params: dict, cfg: ModelConfig, all_kv: bool = False):
    """(model group, wk, wv) of a projection whose query heads the model
    axis cuts, else (None, wk, wv): where the rules replicate the KV
    heads (fewer than the model axis), the KV heads this rank's query
    heads read, or all of them with ``all_kv``, their weights entering
    the region through ``copy_to``."""
    wq, wk, wv = params["wq"], params["wk"], params["wv"]
    q_off = prm.tp(wq, -2, cfg.n_heads)
    if q_off is None:
        return None, wk, wv
    model = parallel.current().model
    if prm.tp(wk, -2, cfg.n_kv_heads) is None:
        k0, k1 = (0, cfg.n_kv_heads) if all_kv else local_kv_heads(
            cfg, q_off, wq.shape[-2])
        wk = parallel.copy_to(wk, model)[..., k0:k1, :]
        wv = parallel.copy_to(wv, model)[..., k0:k1, :]
    return model, wk, wv


def local_kv_heads(cfg: ModelConfig, q_off: int, n_q: int
                   ) -> tuple[int, int]:
    """[k0, k1): the KV heads that query heads [q_off, q_off + n_q) read,
    which must be whole groups or lie within one group."""
    g = cfg.n_heads // cfg.n_kv_heads
    k0, k1 = q_off // g, (q_off + n_q - 1) // g + 1
    if n_q % (k1 - k0) or (n_q < g and g % n_q):
        raise ValueError(f"{cfg.name}: query heads [{q_off}, {q_off + n_q})"
                         f" do not split evenly over KV groups of {g}")
    return k0, k1


def out_project(params: dict, out: torch.Tensor,
                cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    """The output projection; where the model axis cuts the heads the
    ranks' partial sums are reduced (``reduce_from``), and where the
    stack's S is cut the output leaves as this rank's rows
    (``parallel.leave``)."""
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    if cfg is None:
        return y
    cut = prm.tp(params["wo"], -3, cfg.n_heads) is not None
    return parallel.leave(y, parallel.current().model if cut else None)


def _pos1d(positions: torch.Tensor) -> torch.Tensor:
    """(B,S) from (B,S) or (B,S,3)."""
    return positions[..., 0] if positions.ndim == 3 else positions


# ---------------------------------------------------------------------------
# Cache-free full-sequence attention (the encoder) and cross attention
# ---------------------------------------------------------------------------


def _full(q, k, v, cfg: ModelConfig, window: int, causal: bool):
    """Whole-sequence attention: the flash kernel with ``cfg.use_pallas``
    (non-causal too, over the real key length), else ``attention_full``."""
    if cfg.use_pallas:
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, window=window)
    return attention_full(q, k, v, window=window, chunk=cfg.attn_chunk,
                          causal=causal)


def self_attention(params: dict, x: torch.Tensor, cfg: ModelConfig,
                   spec: BlockSpec, positions: torch.Tensor,
                   causal: bool = True) -> torch.Tensor:
    """Whole-sequence self attention with no cache (an encoder block's,
    ``causal=False``)."""
    q, k, v = qkv_project(params, x, cfg, positions)
    return out_project(params, _full(q, k, v, cfg, spec.window, causal),
                       cfg)


def cross_attention(params: dict, x: torch.Tensor, memory: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Encoder-decoder cross attention against the memory (B, T_enc, d),
    projected here: this rank's query and KV heads where the model axis
    cuts them, ``x`` and ``memory`` entering the region through
    ``copy_to``."""
    model, wk, wv = _head_shards(params, cfg)
    x = parallel.enter(x, model)
    if model is not None:
        memory = parallel.copy_to(memory, model)
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("btd,dhk->bthk", memory, wk)
    v = torch.einsum("btd,dhk->bthk", memory, wv)
    return out_project(params, _full(q, k, v, cfg, -1, False), cfg)


class CrossKV(NamedTuple):
    k: torch.Tensor   # (B, T_enc, Hkv, dh)
    v: torch.Tensor


def cross_kv_precompute(params: dict, memory: torch.Tensor,
                        cfg: Optional[ModelConfig] = None,
                        all_kv: bool = False) -> CrossKV:
    """The cross K/V of the memory, once at prefill: this rank's KV heads
    where the model axis cuts the heads, as the cache spec cuts the cross
    K/V, or every KV head with ``all_kv`` (a cache that holds them all
    while the query heads are cut)."""
    wk, wv = params["wk"], params["wv"]
    if cfg is not None:
        model, wk, wv = _head_shards(params, cfg, all_kv)
        if model is not None:
            memory = parallel.copy_to(memory, model)
    k = torch.einsum("btd,dhk->bthk", memory, wk)
    v = torch.einsum("btd,dhk->bthk", memory, wv)
    return CrossKV(k, v)


def cross_attention_cached(params: dict, x: torch.Tensor, ckv: CrossKV,
                           cfg: Optional[ModelConfig] = None,
                           shard: Optional[parallel.RingShard] = None
                           ) -> torch.Tensor:
    """x (B, Sq, d) against precomputed cross K/V, every key valid: this
    rank's query heads where the model axis cuts them, over the KV heads
    they read (the cache's own, or a view of them where it holds every KV
    head).  With
    ``cfg.use_pallas`` a decode step (Sq = 1) runs the ring decode kernel
    with ``kpos = arange(T_enc)`` and ``q_pos = T_enc - 1``, and a longer
    query block the flash kernel non-causal; else the reference's masked
    core.  ``shard``: the K/V is this rank's range of the encoder axis,
    which the step's cache spec cuts (``parallel.cross_shard``: a
    ``long_*`` decode step's ``shard_seq``); each rank attends over its
    range with its log-sum-exp and the ranks combine, as
    ``attend_range`` does over a ring's slots."""
    b, sq = x.shape[:2]
    t = ckv.k.shape[1]
    kc, vc = ckv
    if cfg is not None:
        x = parallel.enter(x, parallel.current().model if prm.tp(
            params["wq"], -2, cfg.n_heads) is not None else None)
        if shard is None:
            kc, vc = _read_kv(params, cfg, kc), _read_kv(params, cfg, vc)
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    h, dh = q.shape[2], q.shape[3]
    if shard is not None:
        kpos = torch.arange(shard.total, dtype=torch.int32,
                            device=x.device)[None].expand(b, shard.total)
        q_pos = torch.full((b, sq), shard.total - 1, dtype=torch.int32,
                           device=x.device)
        out = attend_range(params, q, KVCache(kc, vc, kpos), q_pos, cfg, -1,
                           shard)
        return out_project(params, out, cfg)
    if cfg is not None and cfg.use_pallas:
        if sq == 1:
            kpos = torch.arange(t, dtype=torch.int32,
                                device=x.device)[None].expand(b, t)
            q_pos = torch.full((b,), t - 1, dtype=torch.int32,
                               device=x.device)
            out = decode_attention(q.contiguous(), kc.contiguous(),
                                   vc.contiguous(), kpos.contiguous(),
                                   q_pos, window=-1)
        else:
            out = _full(q, kc, vc, cfg, -1, False)
        return out_project(params, out, cfg)
    hkv = kc.shape[2]
    mask = torch.ones((1, 1, 1, sq, t), dtype=torch.bool, device=x.device)
    out = attn_core(_group(q, hkv), kc, vc, mask)
    return out_project(params, out.reshape(b, sq, h, dh), cfg)
