"""Block-level assembly (port of ``repro/models/blocks.py``) for every
block kind of the reference: ``attn`` (the dense MLP or the MoE FFN,
with arctic's dense residual MLP beside the experts and kimi's shared
expert inside them; ``parallel_block`` for cohere) over a ring or a
paged cache; ``hymba`` (attention and a mamba branch side by side) over
a ring plus its SSM state; xLSTM's ``mlstm`` and ``slstm`` over their
recurrent states; the encoder's ``enc`` (non-causal, no cache) and the
decoder's ``dec`` with cross attention over the encoder's memory, whose
projected K/V the decoder's ring cache keeps.  Only attention-only
blocks page.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.distributed import parallel
from repro_torch.models import ssm
from repro_torch.models.attention import (CrossKV, PagedKVCache, attn_defs,
                                          cross_attention,
                                          cross_attention_cached,
                                          cross_kv_precompute, init_kv_cache,
                                          init_paged_kv_cache,
                                          kv_cache_size, self_attention,
                                          self_attention_cached,
                                          self_attention_paged,
                                          self_attention_prefill)
from repro_torch.models.layers import mlp, mlp_defs, rmsnorm_defs, row_norm
from repro_torch.models.moe import moe_defs, moe_ffn

_KINDS = ("attn", "enc", "dec", "hymba", "mlstm", "slstm")


def _supported(spec: BlockSpec) -> None:
    if spec.kind not in _KINDS:
        raise ValueError(f"unknown block kind {spec.kind!r}")


# ---------------------------------------------------------------------------
# Defs
# ---------------------------------------------------------------------------


def block_defs(cfg: ModelConfig, spec: BlockSpec) -> dict:
    _supported(spec)
    if spec.kind == "mlstm":
        return ssm.mlstm_defs(cfg)
    if spec.kind == "slstm":
        return ssm.slstm_defs(cfg)
    if spec.kind == "hymba":
        return {
            "norm1": rmsnorm_defs(cfg.d_model),
            "attn": attn_defs(cfg),
            "mamba": ssm.mamba_defs(cfg),
            "norm2": rmsnorm_defs(cfg.d_model),
            "mlp": mlp_defs(cfg.d_model, cfg.d_ff),
        }
    # attn / enc / dec
    defs: dict[str, Any] = {
        "norm1": rmsnorm_defs(cfg.d_model),
        "attn": attn_defs(cfg),
    }
    if spec.cross_attention:
        defs["norm_x"] = rmsnorm_defs(cfg.d_model)
        defs["cross"] = attn_defs(cfg, cross=True)
    if not spec.parallel_block:
        defs["norm2"] = rmsnorm_defs(cfg.d_model)
    if spec.moe:
        defs["moe"] = moe_defs(cfg)
        if spec.dense_residual:
            defs["mlp"] = mlp_defs(cfg.d_model, cfg.d_ff)
    else:
        defs["mlp"] = mlp_defs(cfg.d_model, cfg.d_ff)
    return defs


# ---------------------------------------------------------------------------
# Cache init
# ---------------------------------------------------------------------------


def init_block_cache(cfg: ModelConfig, spec: BlockSpec, batch: int,
                     max_context: int, dtype: torch.dtype,
                     device: torch.device, stack: tuple[int, ...] = (),
                     enc_len: int = 0, ring_slots=None) -> dict:
    """Ring decode state for a stack of layers of one block kind: rings
    of shape ``stack + (batch, size, Hkv, dh)`` and ``kpos`` of ``stack +
    (batch, size)``, ``size`` from ``kv_cache_size`` (the rings
    ``ring_slots(size)`` slots where that is given: a rank's range of a
    sequence-sharded ring); a hymba layer adds
    its ``SSMState`` (``stack + (batch, nh, ds, 64)`` f32 and ``stack +
    (batch, 3, d_inner)``), a decoder block with cross attention the
    ``CrossKV`` of ``enc_len`` encoder positions.  An mLSTM layer holds
    only its matrix memory ``h`` (``stack + (batch, nh, dh, dh + 1)``
    f32), an sLSTM layer its ``SLSTMState`` (``stack + (batch, d)`` f32,
    three of them)."""
    _supported(spec)

    def stacked(one):
        if isinstance(one, torch.Tensor):
            return one.expand(*stack, *one.shape).contiguous()
        return type(one)(*(stacked(t) for t in one))

    if spec.kind == "mlstm":
        return {"h": stacked(ssm.init_mlstm_state(batch, cfg, device))}
    if spec.kind == "slstm":
        return {"s": stacked(ssm.init_slstm_state(batch, cfg, device))}
    size = kv_cache_size(spec, max_context, cfg.attn_chunk)
    slots = size if ring_slots is None else ring_slots(size)
    cache = {"kv": stacked(init_kv_cache(batch, size, cfg.n_kv_heads,
                                         cfg.d_head, dtype, device, slots))}
    if spec.kind == "hymba":
        cache["ssm"] = stacked(ssm.init_ssm_state(batch, cfg, dtype, device))
    if spec.cross_attention:
        shape = (batch, enc_len, cfg.n_kv_heads, cfg.d_head)
        cache["cross"] = stacked(CrossKV(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device)))
    return cache


def init_paged_block_cache(cfg: ModelConfig, spec: BlockSpec,
                           num_pages: int, page_size: int,
                           dtype: torch.dtype, device: torch.device,
                           stack: tuple[int, ...] = ()) -> dict:
    """Paged-pool decode state for a stack of layers of one block kind:
    pools of shape ``stack + (num_pages + 1, page, Hkv, dh)``, shared
    across slots and sized by the allocator's page count.  Only plain
    attention blocks page: recurrent state has no page structure."""
    if spec.kind not in ("attn", "dec") or spec.cross_attention:
        raise ValueError(
            f"paged KV layout supports attention-only blocks, not "
            f"{spec.kind!r} (cross={spec.cross_attention})")
    _supported(spec)
    one = init_paged_kv_cache(num_pages, page_size, cfg.n_kv_heads,
                              cfg.d_head, dtype, device)
    return {"kv": PagedKVCache(
        *(torch.zeros(stack + t.shape, dtype=t.dtype, device=t.device)
          for t in one))}


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def _ffn(params: dict, x: torch.Tensor, cfg: ModelConfig,
         spec: BlockSpec, with_aux: bool = False):
    """The block's FFN: the MoE (plus arctic's dense residual MLP) or the
    dense MLP.  Returns y, or (y, aux) with ``with_aux``: the MoE's
    load-balance loss, None for a dense FFN.  Serving drops the aux loss
    (``with_stats=False``), as the reference's engine does."""
    aux = None
    if spec.moe:
        y, stats = moe_ffn(params["moe"], x, cfg, spec, with_stats=with_aux)
        if with_aux:
            aux = stats.aux_loss
        if spec.dense_residual:
            y = y + mlp(params["mlp"], x, cfg.d_ff)
    else:
        y = mlp(params["mlp"], x, cfg.d_ff)
    return (y, aux) if with_aux else y


def _copy_state(old, new) -> None:
    """Write a recurrent state (a tensor or a namedtuple of them) into the
    cache's tensors in place."""
    if isinstance(old, torch.Tensor):
        old.copy_(new)
        return
    for o, n in zip(old, new):
        o.copy_(n)


def block_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
                spec: BlockSpec, positions: torch.Tensor,
                cache: Optional[dict], tables: Optional[torch.Tensor] = None,
                mode: Optional[str] = None,
                live: Optional[torch.Tensor] = None,
                memory: Optional[torch.Tensor] = None,
                with_aux: bool = False):
    """x: (B,S,d); positions: (B,S) or (B,S,3); tables: (B,P) physical
    page ids.  Returns the block's output; the layer's cache is updated
    in place.  ``cache=None`` runs the whole sequence with no decode
    state (the encoder's blocks, non-causal).  A ring cache needs
    ``mode``: ``"prefill"`` (one shot from position 0) or ``"step"``
    (write-then-attend), as do the recurrent kinds.  The paged pool
    serves prefill and decode alike, so it takes no mode.  A ``"step"``
    leaves the ring and recurrent state of every row outside ``live``
    (B,) bool as they were; a paged row outside it has an all -1 table
    row, so its writes already land in the sink.  ``memory`` (B, T_enc,
    d) is the encoder's output, read by a cross-attention block's
    prefill (and, with no cache, by training's cross attention); its step
    reads the cross K/V of the cache.  ``with_aux`` returns (x, aux), aux
    the MoE's load-balance loss or None: training's path, with no cache."""
    _supported(spec)
    if spec.kind in ("mlstm", "slstm"):
        key = "h" if spec.kind == "mlstm" else "s"
        if cache is None:            # the whole sequence, no decode state
            block = (ssm.mlstm_block if spec.kind == "mlstm"
                     else ssm.slstm_block)
            y, _ = block(params, x, cfg)
        elif mode == "step":
            step = (ssm.mlstm_block_step if spec.kind == "mlstm"
                    else ssm.slstm_block_step)
            y, st = step(params, x, cache[key], cfg, live)
        elif mode == "prefill":
            block = (ssm.mlstm_block if spec.kind == "mlstm"
                     else ssm.slstm_block)
            y, st = block(params, x, cfg)
        else:
            raise ValueError(f"a recurrent block needs mode 'prefill' or "
                             f"'step', got {mode!r}")
        if cache is not None:
            _copy_state(cache[key], st)
        return (y, None) if with_aux else y

    # the regions read the normed rows gathered along S where the stack's
    # S is cut (once for both of hymba's branches, and for a parallel
    # block's attention and FFN); each region's output leaves as this
    # rank's rows
    xr = parallel.seq_gather(row_norm(params["norm1"], x, cfg.norm_eps))
    kv = cache["kv"] if cache is not None else None
    if cache is None:
        a = self_attention(params["attn"], xr, cfg, spec, positions,
                           causal=spec.kind != "enc")
    elif isinstance(kv, PagedKVCache):
        if tables is None:
            raise ValueError("a paged cache needs block tables")
        a, _ = self_attention_paged(params["attn"], xr, kv, cfg, spec,
                                    positions, tables)
    elif mode == "prefill":
        a, _ = self_attention_prefill(params["attn"], xr, kv, cfg, spec,
                                      positions)
    elif mode == "step":
        a, _ = self_attention_cached(params["attn"], xr, kv, cfg, spec,
                                     positions, live)
    else:
        raise ValueError(f"a ring cache needs mode 'prefill' or 'step', "
                         f"got {mode!r}")
    if spec.kind == "hymba":
        if cache is None or mode == "prefill":
            m, st = ssm.mamba_branch(params["mamba"], xr, cfg)
        else:
            m, st = ssm.mamba_branch_step(params["mamba"], xr, cache["ssm"],
                                          cfg, live)
        if cache is not None:
            _copy_state(cache["ssm"], st)
        # each branch leaves the region on its own (``parallel.leave``:
        # its reduce_from, or its reduce-scatter or rows along S)
        x = x + 0.5 * (a + m)
    elif spec.parallel_block:
        # attention and FFN read the same normed input, summed
        y = _ffn(params, xr, cfg, spec, with_aux)
        return (x + a + y[0], y[1]) if with_aux else x + a + y
    else:
        x = x + a
    if spec.cross_attention and cache is None:
        # training's cross attention over the memory, as the reference's
        # train mode: no cross K/V is kept
        if memory is None:
            raise ValueError("a cross-attention block needs the encoder's "
                             "memory")
        xq = parallel.seq_gather(row_norm(params["norm_x"], x,
                                          cfg.norm_eps))
        x = x + cross_attention(params["cross"], xq, memory, cfg)
    elif spec.cross_attention:
        xq = parallel.seq_gather(row_norm(params["norm_x"], x,
                                          cfg.norm_eps))
        # a rank's range of the encoder axis, where the step's cache spec
        # cuts it: prefill stores its range and attends over the whole
        # memory, a step attends over its range and the ranks combine
        shard = parallel.cross_shard(cache["cross"].k)
        if mode == "prefill":
            if memory is None:
                raise ValueError("a cross-attention block's prefill needs "
                                 "the encoder's memory")
            ckv = cross_kv_precompute(
                params["cross"], memory, cfg,
                all_kv=cache["cross"].k.shape[-2] == cfg.n_kv_heads)
            _copy_state(cache["cross"], ckv if shard is None else CrossKV(
                *(t[:, shard.lo:shard.lo + shard.local] for t in ckv)))
            shard = None
        else:
            ckv = cache["cross"]
        x = x + cross_attention_cached(params["cross"], xq, ckv, cfg, shard)
    xf = parallel.seq_gather(row_norm(params["norm2"], x, cfg.norm_eps))
    y = _ffn(params, xf, cfg, spec, with_aux)
    return (x + y[0], y[1]) if with_aux else x + y
