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
load-balancing auxiliary loss.  Training takes the statistics
(``with_stats``; ``blocks._ffn`` hands the aux loss up to ``loss_fn``);
under grad on the card each expert product is ``grouped_matmul``'s
autograd Function, whose backward is a Hopper kernel too.  Where the
reference pins a sharding with ``prm.tp``, a mesh's model axis cuts the
experts here (EP) and its data axes the batch, whose dispatch stays the
whole batch's (``_moe_tokens``); the per-row (GShard-style) dispatch of
long batched inputs is a loop over the rows.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.distributed import parallel
from repro_torch.kernels.grouped_matmul import grouped_matmul
from repro_torch.models.layers import mlp, mlp_defs
from repro_torch.models import params as prm
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
                with_stats: bool = True, group=None, lead=None,
                t_all: Optional[int] = None):
    """Token-level MoE core: xt (T, d) -> (y (*lead, d), aux, dropped);
    the two statistics are None without ``with_stats``.  ``lead``: the
    shape the T tokens flatten, (B, S) or (S,) (by default (T,)).  Where
    the stack's S is cut over ``model``, xt arrives gathered along S
    (``lead``'s last axis), so routing, capacity and the statistics see
    every token, and y leaves as this rank's rows of S
    (``parallel.leave``: S / m along that axis).  A rank with no token
    (an empty rank's share of a batch split) dispatches into buffers of
    no rows, so its expert products launch nothing.

    ``group``, a data-parallel process group whose ranks hold the other
    slices of the batch (in rank order), makes the dispatch the whole
    batch's: capacity from the global token count ``t_all``, each
    token's place in its expert after the earlier ranks' tokens (an
    all-gather of the per-expert counts), and the statistics over the
    global batch.  Where the model axis cuts the experts (EP), this rank
    runs only its experts' products and the combine's partial sums are
    reduced."""
    t, d = xt.shape
    lead = (t,) if lead is None else tuple(lead)
    sdim = len(lead) - 1
    e, k = cfg.n_experts, cfg.top_k
    dev = xt.device
    e_off = prm.tp(params["w_in"], -3, e)
    e_loc = params["w_in"].shape[-3]
    model = parallel.current().model if e_off is not None else None
    # the router's weights are whole on every rank, the experts' may be cut
    xin = parallel.enter(xt, model, sdim, lead)

    # --- routing (f32) -----------------------------------------------------
    logits = parallel.enter(xt, None, sdim, lead).float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)                       # (T, E)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)        # (T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # --- sort-based dispatch ------------------------------------------------
    flat_expert = expert_ids.reshape(-1)                        # (T*k,)
    order = torch.argsort(flat_expert, stable=True)             # by expert
    sorted_expert = flat_expert[order]
    first = torch.searchsorted(sorted_expert, sorted_expert)    # group start
    pos_in_e = torch.arange(t * k, device=dev) - first          # rank in group
    # tokens routed to each expert, from the group boundaries
    edges = torch.searchsorted(sorted_expert, torch.arange(e + 1, device=dev))
    load = edges[1:] - edges[:-1]                               # (E,)
    if group is None:
        t_all, load_all = t, load
        offset = torch.zeros_like(load)
    else:
        loads = parallel.all_gather(load, group)                # (n, E)
        offset = loads[:torch.distributed.get_rank(group)].sum(0)
        load_all = loads.sum(0)
    c = capacity(t_all, cfg)
    # this rank's buffer rows an expert: none where it holds no token (an
    # empty rank of a batch split), whose expert products launch nothing
    cb = c if t else 0
    keep = pos_in_e + offset[sorted_expert] < c
    # this rank's slots: its experts' rows, counted from its first token
    e0 = e_off or 0
    mine = keep & (sorted_expert >= e0) & (sorted_expert < e0 + e_loc)
    dest = torch.where(mine, (sorted_expert - e0) * cb + pos_in_e, e_loc * cb)

    buf = xt.new_zeros((e_loc * cb + 1, d))     # row e_loc*cb: sink of drops
    buf[dest] = xin[order // k]
    buf = buf[:e_loc * cb].view(e_loc, cb, d)

    # --- expert computation (grouped matmul layout) -------------------------
    counts = torch.minimum(load, (c - offset).clamp_min(0))
    counts = counts[e0:e0 + e_loc].to(torch.int32)
    h = _expert_product(buf, params["w_in"], counts, cfg)
    g = _expert_product(buf, params["w_gate"], counts, cfg)
    h = h * F.silu(g.float()).to(h.dtype)
    out_buf = _expert_product(h, params["w_out"], counts, cfg)  # (E, C, d)

    # --- return + combine ----------------------------------------------------
    y_sorted = out_buf.reshape(e_loc * cb, d)[torch.where(mine, dest, 0)]
    y_sorted = torch.where(mine[:, None], y_sorted, 0)
    y_flat = torch.empty_like(y_sorted)
    y_flat[order] = y_sorted
    gates = gate_vals if model is None else parallel.copy_to(gate_vals, model)
    y = (y_flat.view(t, k, d).float() * gates[..., None]).sum(dim=1)
    y = parallel.leave(y.view(*lead, d), model, sdim)       # (*lead, d)
    if not with_stats:
        return y.to(xt.dtype), None, None

    # --- load-balance aux loss ---------------------------------------------
    density = load_all.float() / (t_all * k)                    # (E,)
    if group is None:
        prop = probs.mean(dim=0)                                # (E,)
        dropped = 1.0 - keep.float().mean()
    else:
        prop = parallel.reduce_from(probs.sum(dim=0), group) / t_all
        dropped = 1.0 - parallel.all_reduce(keep.float().sum(),
                                            group) / (t_all * k)
    aux = (density * prop).sum() * e
    return y.to(xt.dtype), aux, dropped


GROUPWISE_MIN_TOKENS = 256


def _total(vals: list, like: torch.Tensor) -> torch.Tensor:
    """The sum of a list of 0-d f32 tensors, an f32 zero if it is empty
    (a rank that holds no row)."""
    if not vals:
        return torch.zeros((), dtype=torch.float32, device=like.device)
    return torch.stack(vals).sum()


def moe_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig,
            spec: BlockSpec, with_stats: bool = True
            ) -> tuple[torch.Tensor, Optional[MoEStats]]:
    """x: (B, S, d) -> ((B, S, d), MoEStats, or None without
    ``with_stats``: the serve path drops the aux loss, as the
    reference's engine does).  Where the stack's S is cut over
    ``model``, x is the block's gathered input and the output this
    rank's rows of S.

    Long batched inputs dispatch per row (the reference's GShard-style
    groups, there to keep its batch axis sharded), with capacity per
    row; short inputs (decode steps) route the whole batch at once.
    """
    b, s, d = x.shape
    ctx = parallel.current()
    world = ctx.row_world if ctx is not None else 1
    # the global batch's rows, which ranks may hold unevenly (a train
    # step's padded shards): every rank takes the same path
    n = ctx.global_rows(b) if ctx is not None else b
    if s >= GROUPWISE_MIN_TOKENS and n > 1:
        # one row a group; a rank with no row runs one empty group, so
        # its weights and model-axis collectives are a row's
        rows = [_moe_tokens(params, r.flatten(0, 1), cfg,
                            with_stats and r.shape[0] > 0, lead=r.shape[:2])
                for r in x.split(1)]
        y = torch.cat([r[0] for r in rows])
        if with_stats:
            aux_r = [r[1] for r in rows if r[1] is not None]
            drop_r = [r[2] for r in rows if r[2] is not None]
        if with_stats and world == 1:
            aux = torch.stack(aux_r).mean()
            dropped = torch.stack(drop_r).mean()
        elif with_stats:
            # the mean over the global batch's rows
            aux = parallel.reduce_from(_total(aux_r, x), ctx.rows) / n
            dropped = parallel.all_reduce(_total(drop_r, x), ctx.rows) / n
    else:
        y, aux, dropped = _moe_tokens(
            params, x.flatten(0, 1), cfg, with_stats,
            ctx.rows if world > 1 else None, (b, s), n * s)

    # --- shared experts (always-on) ------------------------------------------
    if "shared" in params:
        y = y + mlp(params["shared"], x,
                    cfg.d_ff_expert * cfg.n_shared_experts)

    if not with_stats:
        return y, None
    return y, MoEStats(aux_loss=aux, dropped_frac=dropped)
