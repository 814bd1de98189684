"""Shared neural building blocks (port of ``repro/models/layers.py``):
norms, rotary embeddings (M-RoPE included), the SwiGLU MLP, embeddings.
Plain functions over parameter dicts, in the reference's weight layouts,
so each einsum keeps the reference's subscripts.  On a mesh whose model
axis cuts a weight, the SwiGLU MLP is Megatron's column/row pair, and
``gathered_columns`` / ``row_parallel`` are the two halves the recurrent
blocks use around a region they run whole on every rank; where the
stack's S is cut over ``model`` (sequence parallelism) a region's input
arrives gathered along S (``parallel.seq_gather``), its output leaves as
this rank's rows (``parallel.leave``), and ``row_norm`` normalises the
residual stream's rows.  The losses
(``softmax_xent``, ``chunked_unembed_xent``) take f32 logits, mask
labels of -1 and reduce as the reference does."""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import parallel
from repro_torch.models import params as prm
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


def row_norm(params: dict, x: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """``rmsnorm`` of the residual stream.  Where the stack's S is cut over
    ``model`` each rank normalises its own rows, so the scale's gradient
    is summed over ``model`` (``parallel.seq_weight``)."""
    return rmsnorm({"scale": parallel.seq_weight(params["scale"])}, x, eps)


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
    """x: (B, S, H, dh); positions: (B, S) int32, or (B, S, 3) for M-RoPE.

    M-RoPE (qwen2-vl): the dh/2 frequency channels are split into
    ``mrope_sections`` groups, each driven by one of the (t, h, w)
    position streams.  Without sections a 3-axis ``positions`` uses its
    temporal stream."""
    b, s, _, dh = x.shape
    half = dh // 2
    freqs = rope_freqs(dh, theta, device=x.device)        # (half,)
    if mrope_sections:
        if sum(mrope_sections) != half:
            raise ValueError(f"mrope_sections {mrope_sections} must sum to "
                             f"{half}")
        if positions.ndim != 3 or positions.shape[-1] != len(mrope_sections):
            raise ValueError(f"M-RoPE needs (B, S, {len(mrope_sections)}) "
                             f"positions, got {tuple(positions.shape)}")
        # channel c takes the stream of its section; built from slices,
        # not an index tensor, so no host-to-device copy enters a
        # captured step
        pf = positions.float()
        pos = torch.cat([pf[..., i:i + 1].expand(b, s, n)
                         for i, n in enumerate(mrope_sections)], dim=-1)
    else:
        if positions.ndim == 3:
            positions = positions[..., 0]
        pos = positions.float()[..., None]                 # (B, S, 1)
    angles = pos * freqs                                   # (B, S, half)
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


def mlp(params: dict, x: torch.Tensor, ff: Optional[int] = None
        ) -> torch.Tensor:
    """SwiGLU.  ``ff`` is the full hidden width: where the model axis cuts
    it (TP: ``w_in`` and ``w_gate`` column shards, ``w_out`` a row
    shard), ``x`` enters through ``copy_to`` and the ranks' partial sums
    are reduced; where the stack's S is cut, ``x`` (B, S, d) comes
    gathered and the output leaves as this rank's rows
    (``parallel.enter`` / ``leave``)."""
    model = None
    if ff is not None and prm.tp(params["w_in"], -1, ff) is not None:
        model = parallel.current().model
    if ff is not None:
        x = parallel.enter(x, model)
    h = torch.einsum("...d,df->...f", x, params["w_in"])
    g = torch.einsum("...d,df->...f", x, params["w_gate"])
    h = h * F.silu(g.float()).to(h.dtype)
    y = torch.einsum("...f,fd->...d", h, params["w_out"])
    return y if ff is None else parallel.leave(y, model)


# ---------------------------------------------------------------------------
# Tensor-parallel projections whose outputs do not follow the cut
# ---------------------------------------------------------------------------


def gathered_columns(eq: str, x: torch.Tensor, w: torch.Tensor,
                     full: int) -> torch.Tensor:
    """``einsum(eq, x, w)`` whole along its last dim, where the model axis
    may cut ``w``'s last dim (``full`` wide) into column shards: ``x``
    enters through ``copy_to`` and the ranks' columns are gathered whole
    (``gather_keep``: backward, this rank's slice).  For an output whose
    layout the cut does not follow (the x | z halves of an up-projection,
    a recurrence's gates), which the replicated code after it reads
    whole.  ``x`` is a region's input (``parallel.enter``)."""
    if prm.tp(w, -1, full) is None:
        return torch.einsum(eq, parallel.enter(x, None), w)
    model = parallel.current().model
    y = torch.einsum(eq, parallel.enter(x, model), w)
    return parallel.gather_keep(y, -1, model)


def row_parallel(eq: str, x: torch.Tensor, w: torch.Tensor,
                 full: int, residual: bool = False) -> torch.Tensor:
    """``einsum(eq, x, w)`` contracting ``x``'s last dim (``full`` wide,
    whole on every rank) with ``w``'s first, which the model axis may cut
    into row shards: this rank takes its slice of ``x`` through
    ``copy_to`` and the ranks' partial sums are reduced
    (``reduce_from``).  ``residual``: the output goes back into the
    residual stream (``parallel.leave``: this rank's rows where the
    stack's S is cut)."""
    off = prm.tp(w, 0, full)
    if off is None:
        y = torch.einsum(eq, x, w)
        return parallel.leave(y, None) if residual else y
    model = parallel.current().model
    x = parallel.copy_to(x, model).narrow(-1, off, w.shape[0])
    y = torch.einsum(eq, x, w)
    return (parallel.leave(y, model) if residual
            else parallel.reduce_from(y, model))


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_defs(vocab: int, d: int) -> dict:
    return {"table": P((vocab, d), ("vocab", "embed"), scale=1.0)}


def embed(params: dict, tokens: torch.Tensor,
          vocab: Optional[int] = None) -> torch.Tensor:
    """Token embeddings.  ``vocab`` is the full vocabulary: where the
    model axis cuts the table's rows, each rank looks up the tokens in its
    rows (zeros elsewhere) and the ranks' rows are summed."""
    table = params["table"]
    off = prm.tp(table, -2, vocab) if vocab is not None else None
    if off is None:
        return table[tokens]
    n = table.shape[-2]
    local = tokens.long() - off
    hit = (local >= 0) & (local < n)
    x = torch.where(hit[..., None], table[local.clamp(0, n - 1)], 0)
    return parallel.reduce_from(x, parallel.current().model)


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


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy.  logits (..., V), upcast to f32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def _chunk_sums(logits_fn: Callable, xc: torch.Tensor, lc: torch.Tensor,
                mc: torch.Tensor):
    """(sum of nll * mask, sum of mask) of one sequence chunk."""
    logits = logits_fn(xc).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
    return ((logz - gold) * mc).sum(), mc.sum()


def chunked_unembed_sums(logits_fn: Callable, x: torch.Tensor,
                         labels: torch.Tensor, mask: torch.Tensor,
                         chunk: int):
    """(sum of nll * mask, sum of mask) over the sequence in ``chunk``-token
    slices, each under a non-reentrant checkpoint with grad on, as
    ``chunked_unembed_xent`` walks it: the parts a data-parallel loss
    normalises by the global token count."""
    if chunk <= 0 or x.shape[1] <= chunk:
        return _chunk_sums(logits_fn, x, labels, mask)
    pad = (-x.shape[1]) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    m_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, x.shape[1], chunk):
        args = (x[:, i:i + chunk], labels[:, i:i + chunk],
                mask[:, i:i + chunk])
        if torch.is_grad_enabled():
            nll, m = checkpoint(_chunk_sums, logits_fn, *args,
                                use_reentrant=False)
        else:
            nll, m = _chunk_sums(logits_fn, *args)
        nll_sum = nll_sum + nll
        m_sum = m_sum + m
    return nll_sum, m_sum


def chunked_unembed_xent(logits_fn: Callable, x: torch.Tensor,
                         labels: torch.Tensor, mask: torch.Tensor,
                         chunk: int) -> torch.Tensor:
    """Cross entropy without materializing the full (B, S, V) logits.

    Walks the sequence in ``chunk``-token slices (S padded to a multiple
    of ``chunk``, the padding masked); each slice computes its logits
    with ``logits_fn`` (the unembed closure) and reduces them to two f32
    scalars at once, summed in the reference's order.  Under autograd
    each slice runs inside ``torch.utils.checkpoint`` (non-reentrant), so
    its f32 logits are recomputed in the backward pass instead of being
    kept, which is the reference's intent.  Exact, not an approximation.
    """
    b, s = labels.shape
    if chunk <= 0 or s <= chunk:
        return softmax_xent(logits_fn(x), labels, mask)
    nll_sum, m_sum = chunked_unembed_sums(logits_fn, x, labels, mask, chunk)
    return nll_sum / torch.clamp(m_sum, min=1.0)
