"""Shared neural building blocks (port of ``repro/models/layers.py``):
norms, rotary embeddings, the SwiGLU MLP, embeddings.  Plain functions
over parameter dicts, in the reference's weight layouts, so each einsum
keeps the reference's subscripts.

M-RoPE and the losses wait for the VLM and training slices."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import P

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_defs(d: int) -> dict:
    return {"scale": P((d,), (None,), init="ones", dtype="float32")}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"]).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    half = d_head // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    # a Python-scalar base: a tensor built from ``theta`` on the device
    # would be a host-to-device copy, which waits for the stream
    return torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: tuple[int, ...] = ()) -> torch.Tensor:
    """x: (B, S, H, dh); positions: (B, S) int32 (or (B, S, 3), of which
    the temporal stream is used)."""
    if mrope_sections:
        raise NotImplementedError(
            "M-RoPE is not ported yet (ROADMAP queue A: VLM)")
    dh = x.shape[-1]
    half = dh // 2
    if positions.ndim == 3:
        positions = positions[..., 0]
    freqs = rope_freqs(dh, theta, device=x.device)        # (half,)
    angles = positions.float()[..., None] * freqs          # (B, S, half)
    sin = torch.sin(angles)[:, :, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense MLP (SwiGLU)
# ---------------------------------------------------------------------------


def mlp_defs(d: int, ff: int) -> dict:
    return {
        "w_in": P((d, ff), ("embed", "ff")),
        "w_gate": P((d, ff), ("embed", "ff")),
        "w_out": P((ff, d), ("ff", "embed")),
    }


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.einsum("...d,df->...f", x, params["w_in"])
    g = torch.einsum("...d,df->...f", x, params["w_gate"])
    h = h * F.silu(g.float()).to(h.dtype)
    return torch.einsum("...f,fd->...d", h, params["w_out"])


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_defs(vocab: int, d: int) -> dict:
    return {"table": P((vocab, d), ("vocab", "embed"), scale=1.0)}


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def unembed_defs(d: int, vocab: int) -> dict:
    return {"w": P((d, vocab), ("embed", "vocab"))}


def _softcap(logits: torch.Tensor, softcap: float) -> torch.Tensor:
    if softcap > 0.0:
        logits = (torch.tanh(logits.float() / softcap)
                  * softcap).to(logits.dtype)
    return logits


def unembed(params: dict, x: torch.Tensor,
            softcap: float = 0.0) -> torch.Tensor:
    return _softcap(torch.einsum("...d,dv->...v", x, params["w"]), softcap)


def unembed_tied(embed_params: dict, x: torch.Tensor,
                 softcap: float = 0.0) -> torch.Tensor:
    return _softcap(torch.einsum("...d,vd->...v", x, embed_params["table"]),
                    softcap)
