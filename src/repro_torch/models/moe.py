"""Mixture-of-Experts FFN with sort-based (dropping) dispatch (port of
``repro/models/moe.py``).

Tokens are routed top-k in f32, grouped by expert with a stable sort,
and gathered into an ``(E, C, d)`` dispatch buffer (``C`` the capacity;
a token past it is dropped), so the expert products cost what the active
parameters cost.  Under ``cfg.use_pallas`` the three expert products run
the ``grouped_matmul`` Hopper kernel with ``counts = min(load, C)`` per
expert, so an expert no token chose never has its weights read; without
it they are ``torch.bmm`` over every expert, as the reference's einsums
are.  The whole dispatch stays on the device: nothing is read back to
the host.

Supports top-k routing with capacity dropping, shared experts (kimi),
the dense residual branch (arctic, applied by ``blocks._ffn``) and the
load-balancing auxiliary loss.  The reference's sharding hints have no
meaning on one card and are dropped; its per-row (GShard-style) dispatch
of long batched inputs is a loop over the rows.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.kernels.grouped_matmul import grouped_matmul
from repro_torch.models.layers import mlp, mlp_defs
from repro_torch.models.params import P


def moe_defs(cfg: ModelConfig) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    defs = {
        "router": P((d, e), ("embed", None), dtype="float32"),
        "w_in": P((e, d, f), ("experts", "embed", "ff")),
        "w_gate": P((e, d, f), ("experts", "embed", "ff")),
        "w_out": P((e, f, d), ("experts", "ff", "embed")),
    }
    if cfg.n_shared_experts > 0:
        defs["shared"] = mlp_defs(d, f * cfg.n_shared_experts)
    return defs


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = -(-n_tokens * cfg.top_k // cfg.n_experts)        # ceil
    c = int(c * cfg.capacity_factor) + 1
    return -(-c // 8) * 8                                # round up to 8


class MoEStats(NamedTuple):
    aux_loss: torch.Tensor        # load-balance loss (Switch-style)
    dropped_frac: torch.Tensor    # fraction of (token, expert) slots dropped


def _expert_product(x: torch.Tensor, w: torch.Tensor, counts: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """x (E, C, a) @ w (E, a, b): the kernel under ``use_pallas``, else
    one batched product over every expert."""
    if cfg.use_pallas:
        return grouped_matmul(x, w, counts)
    return torch.bmm(x, w)


def _moe_tokens(params: dict, xt: torch.Tensor, cfg: ModelConfig,
                with_stats: bool = True):
    """Token-level MoE core: xt (T, d) -> (y (T, d), aux, dropped); the
    two statistics are None without ``with_stats``."""
    t, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    dev = xt.device

    # --- routing (f32) -----------------------------------------------------
    logits = xt.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)                       # (T, E)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)        # (T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # --- sort-based dispatch ------------------------------------------------
    c = capacity(t, cfg)
    flat_expert = expert_ids.reshape(-1)                        # (T*k,)
    order = torch.argsort(flat_expert, stable=True)             # by expert
    sorted_expert = flat_expert[order]
    first = torch.searchsorted(sorted_expert, sorted_expert)    # group start
    pos_in_e = torch.arange(t * k, device=dev) - first          # rank in group
    keep = pos_in_e < c
    dest = torch.where(keep, sorted_expert * c + pos_in_e, e * c)
    # tokens routed to each expert, from the group boundaries
    edges = torch.searchsorted(sorted_expert, torch.arange(e + 1, device=dev))
    load = edges[1:] - edges[:-1]                               # (E,)

    buf = xt.new_zeros((e * c + 1, d))          # row e*c: sink of drops
    buf[dest] = xt[order // k]
    buf = buf[:e * c].view(e, c, d)

    # --- expert computation (grouped matmul layout) -------------------------
    counts = load.clamp(max=c).to(torch.int32)
    h = _expert_product(buf, params["w_in"], counts, cfg)
    g = _expert_product(buf, params["w_gate"], counts, cfg)
    h = h * F.silu(g.float()).to(h.dtype)
    out_buf = _expert_product(h, params["w_out"], counts, cfg)  # (E, C, d)

    # --- return + combine ----------------------------------------------------
    y_sorted = out_buf.reshape(e * c, d)[torch.where(keep, dest, 0)]
    y_sorted = torch.where(keep[:, None], y_sorted, 0)
    y_flat = torch.empty_like(y_sorted)
    y_flat[order] = y_sorted
    y = (y_flat.view(t, k, d).float() * gate_vals[..., None]).sum(dim=1)
    if not with_stats:
        return y.to(xt.dtype), None, None

    # --- load-balance aux loss ---------------------------------------------
    density = load.float() / (t * k)                            # (E,)
    prop = probs.mean(dim=0)                                    # (E,)
    aux = (density * prop).sum() * e
    return y.to(xt.dtype), aux, 1.0 - keep.float().mean()


GROUPWISE_MIN_TOKENS = 256


def moe_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig,
            spec: BlockSpec, with_stats: bool = True
            ) -> tuple[torch.Tensor, Optional[MoEStats]]:
    """x: (B, S, d) -> ((B, S, d), MoEStats, or None without
    ``with_stats``: the serve path drops the aux loss, as the
    reference's engine does).

    Long batched inputs dispatch per row (the reference's GShard-style
    groups, there to keep its batch axis sharded), with capacity per
    row; short inputs (decode steps) route the whole batch at once.
    """
    b, s, d = x.shape
    if s >= GROUPWISE_MIN_TOKENS and b > 1:
        rows = [_moe_tokens(params, x[i], cfg, with_stats) for i in range(b)]
        y = torch.stack([r[0] for r in rows])
        if with_stats:
            aux = torch.stack([r[1] for r in rows]).mean()
            dropped = torch.stack([r[2] for r in rows]).mean()
    else:
        yt, aux, dropped = _moe_tokens(params, x.reshape(b * s, d), cfg,
                                       with_stats)
        y = yt.reshape(b, s, d)

    # --- shared experts (always-on) ------------------------------------------
    if "shared" in params:
        y = y + mlp(params["shared"], x)

    if not with_stats:
        return y, None
    return y, MoEStats(aux_loss=aux, dropped_frac=dropped)
