"""State-space blocks (port of ``repro/models/ssm.py``): the mamba-2
(SSD) branch that runs beside attention in every hymba layer, and
xLSTM's mLSTM and sLSTM blocks.

Every matrix-state recurrence reduces to one primitive,

    h_t = a_t * h_{t-1} + k_t ⊗ v_t          (state: (dk, dv) per head)
    y_t = q_t · h_t

``chunked_linear_attention`` evaluates it chunk-parallel at prefill (the
plain PyTorch version of the ``ssm_scan`` kernel; with ``cfg.use_pallas``
the mamba branch runs the Hopper kernel itself), ``recurrent_step`` is
the O(1) decode update.  mLSTM's matrix memory is the same primitive
(with ``cfg.use_pallas`` its prefill runs the same kernel, at dk = dh
and dv = dh + 1 for the normaliser column).  Unlike the reference, a
prompt whose length is not a multiple of the chunk is served: the ragged
tail is padded as ``ops.ssm_scan`` pads it (ROADMAP §C, fault 3).  The
sLSTM's scalar memory is a sequential recurrence with no kernel in the
reference (a ``lax.scan``); here its prefill is a loop over the tokens.
Training differentiates all three: the scan under grad on the card is
``ssm_scan``'s autograd Function (a Hopper backward kernel; hymba's
head-shared q and k get full-shape gradients that autograd's expand
sums), and the sLSTM token loop runs under autograd as plain ops.

On a mesh whose model axis cuts the blocks' ``ff`` weights (tensor
parallelism, as the reference's specs cut them), every recurrence runs
whole on every model rank, with its state: the up-projections' outputs
(mamba's and the mLSTM's x | z, the sLSTM's four gates), whose layout
the cut does not follow, are gathered whole (``layers.gathered_columns``),
and the projections back into the residual (``out_proj``, ``down_proj``,
the mLSTM's q/k/v/gate rows) are row-parallel (``layers.row_parallel``);
the sLSTM's FFN is ``layers.mlp``.  No weight is gathered.  Where the
stack's S is cut over ``model`` (sequence parallelism), each block
normalises its rows (``layers.row_norm``), gathers them along S for its
recurrence (``parallel.seq_gather``), which runs over the whole
sequence on every rank as before, and adds back its rows of the output
(``parallel.leave``).

Casts follow the reference, since the bf16 results depend on them: the
dt and B/C projections in f32, silu through f32, dt folded into v in the
model dtype.  A decode step takes a ``live`` (B,) bool mask: the state
of every other row (an empty or parked slot) is returned unchanged.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import parallel
from repro_torch.kernels import ssm_scan
from repro_torch.kernels.ssm_scan import \
    ssm_scan_plain as chunked_linear_attention
from repro_torch.models.layers import (gathered_columns, mlp, rmsnorm_defs,
                                       row_norm, row_parallel)
from repro_torch.models.params import P


def recurrent_step(q, k, v, log_a, h):
    """Single-token update.  q, k: (B,1,H,dk); v: (B,1,H,dv); log_a
    (B,1,H); h: (B,H,dk,dv) f32.  Returns (y (B,1,H,dv), h_new)."""
    a = torch.exp(log_a.float())[:, 0, :, None, None]
    kv = torch.einsum("bhd,bhe->bhde", k[:, 0].float(), v[:, 0].float())
    h_new = a * h + kv
    y = torch.einsum("bhd,bhde->bhe", q[:, 0].float(), h_new)
    return y[:, None].to(v.dtype), h_new


# ---------------------------------------------------------------------------
# Causal depthwise conv (mamba front)
# ---------------------------------------------------------------------------


def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B,T,D), w: (K,D) depthwise.  Causal (pads left).  A shifted
    sum in x's dtype, as the reference: ``F.conv1d`` in f32 would go
    through cuDNN in TF32 on the card."""
    k, t = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return sum(xp[:, i:i + t] * w[i] for i in range(k))


def conv_step(x_t: torch.Tensor, w: torch.Tensor, state: torch.Tensor):
    """x_t: (B,1,D); state: (B,K-1,D) last inputs.  Returns (y (B,1,D),
    new_state)."""
    hist = torch.cat([state, x_t], dim=1)                # (B,K,D)
    y = torch.einsum("bkd,kd->bd", hist, w)[:, None]
    return y, hist[:, 1:]


# ---------------------------------------------------------------------------
# Mamba-2 (SSD) branch -- used inside hymba blocks
# ---------------------------------------------------------------------------

SSM_HEAD_DIM = 64


def mamba_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = max(1, d_inner // SSM_HEAD_DIM)
    d_inner = n_heads * SSM_HEAD_DIM
    return d_inner, n_heads, cfg.ssm_state


def mamba_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    d_inner, nh, ds = mamba_dims(cfg)
    return {
        "in_proj": P((d, 2 * d_inner), ("embed", "ff")),       # x, z
        "bc_proj": P((d, 2 * ds), ("embed", None)),            # B, C (1 group)
        "dt_proj": P((d, nh), ("embed", None)),
        "dt_bias": P((nh,), (None,), init="zeros", dtype="float32"),
        "a_log": P((nh,), (None,), init="zeros", dtype="float32"),
        "d_skip": P((nh,), (None,), init="ones", dtype="float32"),
        "conv_w": P((4, d_inner), (None, None)),
        "out_proj": P((d_inner, d), ("ff", "embed")),
    }


def _mamba_qkv(params, x, cfg):
    """Shared projections.  x: (B,T,d) -> (xs, z, B, C, dt, log_a).
    On a mesh that cuts ``in_proj``'s columns, x and z are gathered whole
    (a contiguous shard lies across the x | z boundary and across the
    64-wide heads); B, C and dt come from replicated weights, so they
    read the replicated input as it is (``parallel.enter`` of whole
    weights)."""
    xz = gathered_columns("btd,de->bte", x, params["in_proj"],
                          2 * mamba_dims(cfg)[0])
    xs, z = xz.chunk(2, dim=-1)
    x = parallel.enter(x, None)
    bc = torch.einsum("btd,de->bte", x, params["bc_proj"]).float()
    b_in, c_out = bc.chunk(2, dim=-1)                          # (B,T,ds)
    # the reference promotes the model-dtype dt_proj to f32 here
    dt = torch.einsum("btd,dh->bth", x.float(), params["dt_proj"].float())
    dt = F.softplus(dt + params["dt_bias"])                    # (B,T,nh)
    log_a = -dt * torch.exp(params["a_log"])                   # <= 0
    return xs, z, b_in, c_out, dt, log_a


class SSMState(NamedTuple):
    h: torch.Tensor       # (B, nh, ds, head_dim) f32
    conv: torch.Tensor    # (B, K-1, d_inner)


def _shared_qk(b_in, c_out, nh: int, dtype):
    """B and C, cast to the model dtype, broadcast over the SSM heads as
    views (head stride 0): one row serves all ``nh`` heads."""
    b, t, ds = b_in.shape
    q = c_out.to(dtype)[:, :, None, :].expand(b, t, nh, ds)
    k = b_in.to(dtype)[:, :, None, :].expand(b, t, nh, ds)
    return q, k


def mamba_branch(params: dict, x: torch.Tensor, cfg: ModelConfig
                 ) -> tuple[torch.Tensor, SSMState]:
    """Full-sequence mamba branch: (B,T,d) -> ((B,T,d), final state).
    With ``cfg.use_pallas`` the chunked scan is the ``ssm_scan`` kernel."""
    b, t, _ = x.shape
    d_inner, nh, ds = mamba_dims(cfg)
    xs_pre, z, b_in, c_out, dt, log_a = _mamba_qkv(params, x, cfg)
    xs = causal_conv1d(xs_pre, params["conv_w"])
    xs = F.silu(xs.float()).to(x.dtype)
    xh = xs.reshape(b, t, nh, SSM_HEAD_DIM)
    v = xh * dt[..., None].to(xh.dtype)                        # fold dt in
    q, k = _shared_qk(b_in, c_out, nh, x.dtype)
    h0 = torch.zeros((b, nh, ds, SSM_HEAD_DIM), dtype=torch.float32,
                     device=x.device)
    scan = ssm_scan if cfg.use_pallas else chunked_linear_attention
    y, h_t = scan(q, k, v, log_a, h0)
    y = y + xh * params["d_skip"][None, None, :, None].to(xh.dtype)
    y = y.reshape(b, t, d_inner)
    y = y * F.silu(z.float()).to(y.dtype)
    out = row_parallel("bte,ed->btd", y, params["out_proj"], d_inner,
                       residual=True)
    conv_k = params["conv_w"].shape[0]
    if t >= conv_k - 1:
        conv_state = xs_pre[:, t - (conv_k - 1):]
    else:
        conv_state = F.pad(xs_pre, (0, 0, conv_k - 1 - t, 0))
    return out, SSMState(h=h_t, conv=conv_state)


def init_ssm_state(batch: int, cfg: ModelConfig, dtype: torch.dtype,
                   device: torch.device) -> SSMState:
    d_inner, nh, ds = mamba_dims(cfg)
    return SSMState(
        h=torch.zeros((batch, nh, ds, SSM_HEAD_DIM), dtype=torch.float32,
                      device=device),
        conv=torch.zeros((batch, 3, d_inner), dtype=dtype, device=device))


def mamba_branch_step(params: dict, x: torch.Tensor, state: SSMState,
                      cfg: ModelConfig, live: Optional[torch.Tensor] = None
                      ) -> tuple[torch.Tensor, SSMState]:
    """Decode: x (B,1,d).  Rows outside ``live`` (B,) bool, when given,
    keep their state: the returned state holds their old ``h`` and
    ``conv``."""
    b = x.shape[0]
    d_inner, nh, ds = mamba_dims(cfg)
    xs, z, b_in, c_out, dt, log_a = _mamba_qkv(params, x, cfg)
    xs, conv_state = conv_step(xs, params["conv_w"], state.conv)
    xs = F.silu(xs.float()).to(x.dtype)
    xh = xs.reshape(b, 1, nh, SSM_HEAD_DIM)
    v = xh * dt[..., None].to(xh.dtype)
    q, k = _shared_qk(b_in, c_out, nh, x.dtype)
    y, h_new = recurrent_step(q, k, v, log_a, state.h)
    y = y + xh * params["d_skip"][None, None, :, None].to(xh.dtype)
    y = y.reshape(b, 1, d_inner)
    y = y * F.silu(z.float()).to(y.dtype)
    out = row_parallel("bte,ed->btd", y, params["out_proj"], d_inner,
                       residual=True)
    if live is not None:
        h_new = torch.where(live[:, None, None, None], h_new, state.h)
        conv_state = torch.where(live[:, None, None], conv_state, state.conv)
    return out, SSMState(h=h_new, conv=conv_state)


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM)
# ---------------------------------------------------------------------------


def mlstm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    nh = cfg.n_heads
    dh = d_inner // nh
    return d_inner, nh, dh


def mlstm_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    d_inner, nh, dh = mlstm_dims(cfg)
    return {
        "norm": rmsnorm_defs(d),
        "up_proj": P((d, 2 * d_inner), ("embed", "ff")),       # x, z
        "wq": P((d_inner, nh, dh), ("ff", "heads", None)),
        "wk": P((d_inner, nh, dh), ("ff", "heads", None)),
        "wv": P((d_inner, nh, dh), ("ff", "heads", None)),
        "w_if": P((d_inner, 2 * nh), ("ff", None)),            # i, f gates
        "gn": P((nh, dh), (None, None), init="ones", dtype="float32"),
        "down_proj": P((d_inner, d), ("ff", "embed")),
    }


@functools.lru_cache(maxsize=None)
def _sqrt_as(dh: int, dtype: torch.dtype) -> float:
    """The reference divides by ``jnp.sqrt(float(dh))``, a weakly typed
    scalar that takes the operand's dtype first: sqrt(dh) rounded to
    ``dtype``, as a host float."""
    return float(torch.tensor(math.sqrt(dh)).to(dtype))


def _mlstm_proj(params, xr, cfg):
    """q, k (the input gate folded in), v with the normaliser column, the
    forget gate's log and z.  On a mesh that cuts ``up_proj``'s columns
    x and z are gathered whole, and ``wq``/``wk``/``wv``/``w_if``, cut on
    their d_inner rows, are row-parallel: each rank's rows of x, the
    partial sums reduced."""
    d_inner, nh, dh = mlstm_dims(cfg)
    xz = gathered_columns("btd,de->bte", xr, params["up_proj"], 2 * d_inner)
    xs, z = xz.chunk(2, dim=-1)
    root = _sqrt_as(dh, xs.dtype)
    q = row_parallel("bte,ehd->bthd", xs, params["wq"], d_inner) / root
    k = row_parallel("bte,ehd->bthd", xs, params["wk"], d_inner) / root
    v = row_parallel("bte,ehd->bthd", xs, params["wv"], d_inner)
    gates = row_parallel("bte,eh->bth", xs.float(), params["w_if"].float(),
                         d_inner)
    i_g, f_g = gates.chunk(2, dim=-1)                          # (B,T,nh)
    log_a = F.logsigmoid(f_g)                                  # <= 0
    i_t = torch.sigmoid(i_g)
    # fold the input gate into k; append the normaliser ones-column to v
    k = k * i_t[..., None].to(k.dtype)
    v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    return q, k, v_aug, log_a, z


def _mlstm_out(params, y_aug, z, cfg):
    b, t = y_aug.shape[:2]
    d_inner, nh, dh = mlstm_dims(cfg)
    y, n = y_aug[..., :-1], y_aug[..., -1:]
    y = y / torch.clamp(n.abs(), min=1.0).to(y.dtype)
    # per-head group norm, in f32
    yf = y.float()
    var = yf.square().mean(dim=-1, keepdim=True)
    yf = yf * torch.rsqrt(var + 1e-6) * params["gn"]
    y = yf.to(z.dtype).reshape(b, t, d_inner)
    y = y * F.silu(z.float()).to(y.dtype)
    return row_parallel("bte,ed->btd", y, params["down_proj"], d_inner,
                        residual=True)


def mlstm_block(params: dict, x: torch.Tensor, cfg: ModelConfig
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full sequence: (B,T,d) -> ((B,T,d), final state (B, nh, dh, dh+1)
    f32).  With ``cfg.use_pallas`` the chunked scan is the ``ssm_scan``
    kernel (dk = dh, dv = dh + 1)."""
    xr = parallel.seq_gather(row_norm(params["norm"], x, cfg.norm_eps))
    q, k, v_aug, log_a, z = _mlstm_proj(params, xr, cfg)
    _, nh, dh = mlstm_dims(cfg)
    h0 = torch.zeros((x.shape[0], nh, dh, dh + 1), dtype=torch.float32,
                     device=x.device)
    scan = ssm_scan if cfg.use_pallas else chunked_linear_attention
    y_aug, h_t = scan(q, k, v_aug, log_a, h0)
    return x + _mlstm_out(params, y_aug, z, cfg), h_t


def init_mlstm_state(batch: int, cfg: ModelConfig,
                     device: torch.device) -> torch.Tensor:
    _, nh, dh = mlstm_dims(cfg)
    return torch.zeros((batch, nh, dh, dh + 1), dtype=torch.float32,
                       device=device)


def mlstm_block_step(params: dict, x: torch.Tensor, h: torch.Tensor,
                     cfg: ModelConfig, live: Optional[torch.Tensor] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode: x (B,1,d), h (B, nh, dh, dh+1) f32.  Rows outside ``live``
    keep their ``h``."""
    xr = row_norm(params["norm"], x, cfg.norm_eps)
    q, k, v_aug, log_a, z = _mlstm_proj(params, xr, cfg)
    y_aug, h_new = recurrent_step(q, k, v_aug, log_a, h)
    if live is not None:
        h_new = torch.where(live[:, None, None, None], h_new, h)
    return x + _mlstm_out(params, y_aug, z, cfg), h_new


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM) -- sequential scalar-memory recurrence
# ---------------------------------------------------------------------------


def slstm_ff(cfg: ModelConfig) -> int:
    """The sLSTM's gated FFN width, ~4d/3 rounded up to 64."""
    return -(-4 * cfg.d_model // 3 // 64) * 64


def slstm_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    nh, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    ff = slstm_ff(cfg)
    return {
        "norm": rmsnorm_defs(d),
        "w_gates": P((d, 4 * d), ("embed", "ff")),
        "r_gates": P((nh, dh, 4 * dh), (None, None, None)),  # per-head recur.
        "ffn_norm": rmsnorm_defs(d),
        "ffn_in": P((d, ff), ("embed", "ff")),
        "ffn_gate": P((d, ff), ("embed", "ff")),
        "ffn_out": P((ff, d), ("ff", "embed")),
    }


class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B, d) f32
    n: torch.Tensor   # (B, d) f32
    h: torch.Tensor   # (B, d) f32


def init_slstm_state(batch: int, cfg: ModelConfig,
                     device: torch.device) -> SLSTMState:
    def z():
        return torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                           device=device)
    return SLSTMState(c=z(), n=z(), h=z())


def _slstm_cell(params, wx_t, state: SLSTMState, nh: int, dh: int
                ) -> SLSTMState:
    """wx_t: (B, 4d) f32, the input's contribution at one step."""
    b = wx_t.shape[0]
    hr = state.h.reshape(b, nh, dh)
    rec = torch.einsum("bhd,hde->bhe", hr, params["r_gates"].float()
                       ).reshape(b, 4 * nh * dh)
    pre = (wx_t + rec).reshape(b, 4, nh * dh)
    z_t = torch.tanh(pre[:, 0])
    i_t = torch.sigmoid(pre[:, 1])
    f_t = torch.sigmoid(pre[:, 2])
    o_t = torch.sigmoid(pre[:, 3])
    c = f_t * state.c + i_t * z_t
    n = f_t * state.n + i_t
    h = o_t * c / torch.clamp(n, min=1.0)
    return SLSTMState(c=c, n=n, h=h)


def _slstm_ffn(params, x, cfg):
    """The gated FFN: ``layers.mlp`` on the FFN's weights (Megatron's
    column/row pair where the model axis cuts them)."""
    xr = parallel.seq_gather(row_norm(params["ffn_norm"], x, cfg.norm_eps))
    return x + mlp({"w_in": params["ffn_in"], "w_gate": params["ffn_gate"],
                    "w_out": params["ffn_out"]}, xr, slstm_ff(cfg))


def _slstm_wx(params, x, cfg):
    """The input's gate pre-activations (B, T, 4d) f32, once a block: on a
    mesh that cuts ``w_gates``' columns the four gates are gathered whole,
    since the recurrence reads every gate of a head."""
    xr = parallel.seq_gather(row_norm(params["norm"], x, cfg.norm_eps))
    return gathered_columns("btd,de->bte", xr.float(),
                            params["w_gates"].float(), 4 * cfg.d_model)


def slstm_block(params: dict, x: torch.Tensor, cfg: ModelConfig
                ) -> tuple[torch.Tensor, SLSTMState]:
    """Full sequence: (B,T,d) -> ((B,T,d), final state).  The recurrence
    runs token by token, as the reference's ``lax.scan``, over the whole
    sequence on every rank (T the gathered length where S is cut)."""
    b, _, d = x.shape
    nh, dh = cfg.n_heads, d // cfg.n_heads
    wx = _slstm_wx(params, x, cfg)                  # (B, T, 4d) f32
    state = init_slstm_state(b, cfg, x.device)
    hs = []
    for i in range(wx.shape[1]):
        state = _slstm_cell(params, wx[:, i], state, nh, dh)
        hs.append(state.h)
    x = x + parallel.leave(torch.stack(hs, dim=1).to(x.dtype), None)
    return _slstm_ffn(params, x, cfg), state


def slstm_block_step(params: dict, x: torch.Tensor, state: SLSTMState,
                     cfg: ModelConfig, live: Optional[torch.Tensor] = None
                     ) -> tuple[torch.Tensor, SLSTMState]:
    """Decode: x (B,1,d).  Rows outside ``live`` keep their state."""
    d = x.shape[-1]
    nh, dh = cfg.n_heads, d // cfg.n_heads
    wx = _slstm_wx(params, x, cfg)
    new = _slstm_cell(params, wx[:, 0], state, nh, dh)
    x = x + new.h[:, None].to(x.dtype)
    if live is not None:
        new = SLSTMState(*(torch.where(live[:, None], a, old)
                           for a, old in zip(new, state)))
    return _slstm_ffn(params, x, cfg), new
