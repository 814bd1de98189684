"""Block-level assembly (port of ``repro/models/blocks.py``) for the
kinds the port serves: ``attn`` and ``dec`` without cross attention,
including ``parallel_block``, over a ring or a paged cache; and
``hymba`` (attention and a mamba branch side by side) over a ring cache
plus its SSM state.  An ``attn`` block's FFN is the dense MLP or the MoE
FFN (``models/moe.py``), with arctic's dense residual MLP beside the
experts and kimi's shared expert inside them, on every branch.  Other
kinds and cross attention raise ``NotImplementedError`` naming the
ROADMAP queue A item that ports them.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.models import ssm
from repro_torch.models.attention import (PagedKVCache, attn_defs,
                                          init_kv_cache, init_paged_kv_cache,
                                          kv_cache_size,
                                          self_attention_cached,
                                          self_attention_paged,
                                          self_attention_prefill)
from repro_torch.models.layers import mlp, mlp_defs, rmsnorm, rmsnorm_defs
from repro_torch.models.moe import moe_defs, moe_ffn

_LATER = {"mlstm": "xLSTM", "slstm": "xLSTM", "enc": "enc-dec"}


def _supported(spec: BlockSpec) -> None:
    if spec.kind in _LATER:
        raise NotImplementedError(
            f"block kind {spec.kind!r} is not ported yet "
            f"(ROADMAP queue A: {_LATER[spec.kind]})")
    if spec.kind not in ("attn", "dec", "hymba"):
        raise ValueError(f"unknown block kind {spec.kind!r}")
    if spec.cross_attention:
        raise NotImplementedError(
            "cross attention is not ported yet (ROADMAP queue A: enc-dec)")


# ---------------------------------------------------------------------------
# Defs
# ---------------------------------------------------------------------------


def block_defs(cfg: ModelConfig, spec: BlockSpec) -> dict:
    _supported(spec)
    if spec.kind == "hymba":
        return {
            "norm1": rmsnorm_defs(cfg.d_model),
            "attn": attn_defs(cfg),
            "mamba": ssm.mamba_defs(cfg),
            "norm2": rmsnorm_defs(cfg.d_model),
            "mlp": mlp_defs(cfg.d_model, cfg.d_ff),
        }
    defs: dict[str, Any] = {
        "norm1": rmsnorm_defs(cfg.d_model),
        "attn": attn_defs(cfg),
    }
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
                     device: torch.device, stack: tuple[int, ...] = ()
                     ) -> dict:
    """Ring decode state for a stack of layers of one block kind: rings
    of shape ``stack + (batch, size, Hkv, dh)`` and ``kpos`` of ``stack +
    (batch, size)``, ``size`` from ``kv_cache_size``; a hymba layer adds
    its ``SSMState`` (``stack + (batch, nh, ds, 64)`` f32 and ``stack +
    (batch, 3, d_inner)``)."""
    _supported(spec)

    def stacked(one):
        return type(one)(*(t.expand(*stack, *t.shape).contiguous()
                           for t in one))

    size = kv_cache_size(spec, max_context, cfg.attn_chunk)
    cache = {"kv": stacked(init_kv_cache(batch, size, cfg.n_kv_heads,
                                         cfg.d_head, dtype, device))}
    if spec.kind == "hymba":
        cache["ssm"] = stacked(ssm.init_ssm_state(batch, cfg, dtype, device))
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
         spec: BlockSpec) -> torch.Tensor:
    """The block's FFN: the MoE (plus arctic's dense residual MLP) or the
    dense MLP.  Serving drops the MoE's aux loss, as the reference's
    engine does."""
    if spec.moe:
        y, _ = moe_ffn(params["moe"], x, cfg, spec, with_stats=False)
        if spec.dense_residual:
            y = y + mlp(params["mlp"], x)
        return y
    return mlp(params["mlp"], x)


def block_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
                spec: BlockSpec, positions: torch.Tensor, cache: dict,
                tables: Optional[torch.Tensor] = None,
                mode: Optional[str] = None) -> torch.Tensor:
    """x: (B,S,d); positions: (B,S); tables: (B,P) physical page ids.
    Returns the block's output; the layer's cache is updated in place.
    A ring cache needs ``mode``: ``"prefill"`` (one shot from position
    0) or ``"step"`` (write-then-attend).  The paged pool serves prefill
    and decode alike, so it takes no mode; this slice has no train
    mode."""
    _supported(spec)
    xr = rmsnorm(params["norm1"], x, cfg.norm_eps)
    kv = cache["kv"]
    if isinstance(kv, PagedKVCache):
        if tables is None:
            raise ValueError("a paged cache needs block tables")
        a, _ = self_attention_paged(params["attn"], xr, kv, cfg, spec,
                                    positions, tables)
    elif mode == "prefill":
        a, _ = self_attention_prefill(params["attn"], xr, kv, cfg, spec,
                                      positions)
    elif mode == "step":
        a, _ = self_attention_cached(params["attn"], xr, kv, cfg, spec,
                                     positions)
    else:
        raise ValueError(f"a ring cache needs mode 'prefill' or 'step', "
                         f"got {mode!r}")
    if spec.kind == "hymba":
        if mode == "prefill":
            m, st = ssm.mamba_branch(params["mamba"], xr, cfg)
        else:
            m, st = ssm.mamba_branch_step(params["mamba"], xr, cache["ssm"],
                                          cfg)
        for old, new in zip(cache["ssm"], st):
            old.copy_(new)
        x = x + 0.5 * (a + m)
    elif spec.parallel_block:
        # attention and FFN read the same normed input, summed
        return x + a + _ffn(params, xr, cfg, spec)
    else:
        x = x + a
    return x + _ffn(params, rmsnorm(params["norm2"], x, cfg.norm_eps), cfg,
                    spec)
