"""State-space blocks (port of ``repro/models/ssm.py``), the mamba-2
(SSD) half: the branch that runs beside attention in every hymba layer.

Every matrix-state recurrence reduces to one primitive,

    h_t = a_t * h_{t-1} + k_t ⊗ v_t          (state: (dk, dv) per head)
    y_t = q_t · h_t

``chunked_linear_attention`` evaluates it chunk-parallel at prefill (the
plain PyTorch version of the ``ssm_scan`` kernel; with ``cfg.use_pallas``
the mamba branch runs the Hopper kernel itself), ``recurrent_step`` is
the O(1) decode update.  Unlike the reference, a prompt whose length is
not a multiple of the chunk is served: the ragged tail is padded as
``ops.ssm_scan`` pads it (ROADMAP §C, fault 3).

Casts follow the reference, since the bf16 results depend on them: the
dt and B/C projections in f32, silu through f32, dt folded into v in the
model dtype.  The mLSTM and sLSTM blocks (xLSTM) wait for their slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ssm_scan
from repro_torch.kernels.ssm_scan import \
    ssm_scan_plain as chunked_linear_attention
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
    """Shared projections.  x: (B,T,d) -> (xs, z, B, C, dt, log_a)."""
    xz = torch.einsum("btd,de->bte", x, params["in_proj"])
    xs, z = xz.chunk(2, dim=-1)
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
    out = torch.einsum("bte,ed->btd", y, params["out_proj"])
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
                      cfg: ModelConfig) -> tuple[torch.Tensor, SSMState]:
    """Decode: x (B,1,d)."""
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
    out = torch.einsum("bte,ed->btd", y, params["out_proj"])
    return out, SSMState(h=h_new, conv=conv_state)
