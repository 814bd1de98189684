"""Model assembly (port of ``repro/models/transformer.py``): embeddings
→ stack-plan segments → final norm → unembed, with the serving entry
points of both KV layouts -- ring: ``init_cache(layout="ring")``,
``prefill`` and ``decode_step``; paged: ``init_cache(layout="paged")``,
``prefill_paged``, the mixed step's ``prefill_paged_padded`` and
``decode_step(tables=)`` -- and the paged <-> ring
state bridge of KV migration (``paged_extract``, ``paged_insert``).
Hybrid (hymba) and xLSTM stacks run on the ring layout only; their
caches carry an ``SSMState`` beside each ring, or an mLSTM or sLSTM
state in place of one.  An encoder-decoder model (``cfg.is_encdec``)
runs its encoder over the frame embeddings at ``prefill(frames=)``
(``encode``, no cache) and keeps each decoder layer's projected cross
K/V in its ring cache (``init_cache(enc_len=)``).  A VLM's M-RoPE takes
3-axis positions, the three streams equal for text; ``prefill`` takes
patch embeddings over the first token slots (``vision_embeds``) and
explicit ``positions``.

Training entry points: ``hidden_states``, ``forward`` and ``loss_fn``,
with the reference's signatures and return values, for every config of
the registry: the MoE layers' load-balance loss summed over the layers
as the aux loss, hymba's mamba branch and xLSTM's mLSTM through the
scan, the sLSTM token loop under autograd, a VLM's patch embeddings and
M-RoPE positions, and an encoder-decoder's encoder over ``frames``.
``cfg.remat`` runs each layer under ``torch.utils.checkpoint``
(non-reentrant), as ``jax.checkpoint`` wraps the reference's scan body;
the loss walks the sequence in ``cfg.loss_chunk`` slices.

On a mesh (``distributed.parallel.use_mesh``, set by the launch steps)
each layer's leaves that the rules cut over the batch axes are gathered
as the layer runs (FSDP), the embedding and the logits are
vocab-parallel where the model axis cuts the vocabulary, and the loss is
normalised by the global batch's token count; with no mesh none of this
runs.  Where the step's context cuts a stack's S over ``model`` (the
reference's ``_constrain_act``, ``MeshContext.seq_parallel``: train and
prefill steps with ``cfg.act_sharding``), the stack's input enters as
this rank's rows of S, each block keeps its residual stream in them
(Megatron-style sequence parallelism, so remat keeps 1/m of each layer's
input), and the output is gathered whole before the final norm; the
encoder's stack follows the same rule at its own S.  ``boundary_saves``
measures what remat keeps at the layer boundaries.

The reference runs each stacked segment with ``lax.scan``; here it is a
Python loop over the leading ``(n,)`` (or ``(repeat, n)``) dims of the
stacked parameters and pools.  The cache is updated in place: a step
returns the same pool tensors it was given, so a step captured as a CUDA
graph keeps writing the cache it was captured against.
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, Segment
from repro_torch.distributed import parallel
from repro_torch.models import params as prm
from repro_torch.models import attention as attn
from repro_torch.models.attention import KVCache, PagedKVCache
from repro_torch.models.blocks import (block_apply, block_defs,
                                       init_block_cache,
                                       init_paged_block_cache)
from repro_torch.models.layers import (chunked_unembed_sums,
                                       chunked_unembed_xent, embed,
                                       embed_defs, rmsnorm, rmsnorm_defs,
                                       unembed, unembed_defs, unembed_tied)

# ---------------------------------------------------------------------------
# Defs / parameters
# ---------------------------------------------------------------------------


def _stack_dims(seg: Segment, n: int) -> tuple[int, ...]:
    return (seg.repeat, n) if seg.repeat > 1 else (n,)


def _segment_defs(cfg: ModelConfig, seg: Segment) -> dict:
    return {f"e{j}": prm.stack(block_defs(cfg, spec), *_stack_dims(seg, n))
            for j, (spec, n) in enumerate(seg.pattern)}


def model_defs(cfg: ModelConfig) -> dict:
    defs: dict[str, Any] = {
        "embed": embed_defs(cfg.vocab, cfg.d_model),
        "final_norm": rmsnorm_defs(cfg.d_model),
        "decoder": [_segment_defs(cfg, s) for s in cfg.plan()],
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = unembed_defs(cfg.d_model, cfg.vocab)
    if cfg.is_encdec:
        defs["encoder"] = [_segment_defs(cfg, s) for s in cfg.enc_plan()]
        defs["enc_norm"] = rmsnorm_defs(cfg.d_model)
    return defs


def init(cfg: ModelConfig, generator: torch.Generator, device=None) -> dict:
    """The port's own random weights, by the reference's rule (fan-in
    scaled normal, ones for norms, f32 where the defs say so).  Draws on
    ``generator``'s device."""
    dev = prm.resolve_device(device)
    return prm.init_params(model_defs(cfg), generator,
                           prm.torch_dtype(cfg.dtype), dev)


def param_count(cfg: ModelConfig) -> int:
    return prm.count_params(model_defs(cfg))


# ---------------------------------------------------------------------------
# Stack execution
# ---------------------------------------------------------------------------


def _layer(tree, idx: tuple[int, ...]):
    """One layer's slice of a stacked tree (views, so in-place cache
    writes land in the stacked pools).  Namedtuples (``KVCache``,
    ``PagedKVCache``, ``SSMState``) keep their type."""
    if isinstance(tree, tuple):
        return type(tree)(*(t[idx] for t in tree))
    if isinstance(tree, dict):
        return {k: _layer(v, idx) for k, v in tree.items()}
    return tree[idx]


def _unbound(tree, idxs) -> dict:
    """Each layer's tree of a stacked parameter tree, keyed by its index
    in ``idxs``, from one ``unbind`` per leaf (and per repeat): under
    autograd a stacked leaf's gradient is then one stack of the layers'
    gradients, where indexing it layer by layer would zero-fill and add
    a gradient of the whole stack once a layer."""
    if isinstance(tree, dict):
        subs = {k: _unbound(v, idxs) for k, v in tree.items()}
        return {idx: {k: subs[k][idx] for k in tree} for idx in idxs}
    if len(idxs[0]) == 2:
        rows = [t.unbind(0) for t in tree.unbind(0)]
        return {(r, i): rows[r][i] for r, i in idxs}
    parts = tree.unbind(0)
    return {idx: parts[idx[0]] for idx in idxs}


# the lists ``boundary_saves`` fills, innermost last
_BOUNDARY: list = []


@contextlib.contextmanager
def boundary_saves():
    """Within the block, each layer that runs under remat appends to the
    yielded list the (shape, bytes) of its input as its checkpoint saves
    it for the backward pass, measured with
    ``torch.autograd.graph.saved_tensors_hooks`` around the checkpoint
    call (the bytes of its elements)."""
    seen: list = []
    _BOUNDARY.append(seen)
    try:
        yield seen
    finally:
        _BOUNDARY.pop()


def _saving(x: torch.Tensor):
    """The hooks that record ``x`` (a layer's input) where the checkpoint
    saves it, or nothing when no ``boundary_saves`` is open."""
    if not _BOUNDARY:
        return contextlib.nullcontext()
    seen = _BOUNDARY[-1]

    def pack(t):
        if t.data_ptr() == x.data_ptr() and t.shape == x.shape:
            seen.append((tuple(t.shape), t.numel() * t.element_size()))
        return t

    return torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t)


def _run_plan(plan, cfg: ModelConfig, params_list, x, positions, cache_list,
              tables, mode=None, live=None, memory=None):
    """Run ``plan``'s segments over ``x``.  Returns (x, aux).
    ``cache_list=None`` runs without decode state (the encoder, and
    training): then aux is the MoE layers' load-balance losses summed
    over the layers (an f32 zero without MoE), as the reference's
    ``_run_plan`` sums its scans'; with grad mode on, the layers'
    parameters come from ``_unbound`` and, with ``cfg.remat``, each layer
    runs under a non-reentrant checkpoint, which keeps only its input for
    the backward pass.  With a cache (serving) aux is None.  Where the
    current context cuts the stack's S (``seq_parallel``, decided here
    once for the stack), ``x`` is cut to this rank's rows on the way in
    (``split_to``) and gathered whole on the way out (``gather_keep``:
    every model rank then computes the same loss)."""
    cache_free = cache_list is None
    train = cache_free and torch.is_grad_enabled()
    remat = train and cfg.remat
    aux = torch.zeros((), dtype=torch.float32, device=x.device) \
        if cache_free else None
    ctx = parallel.current()
    sp = ctx.seq_parallel(x.shape[1]) if ctx is not None else None
    if sp is not None:
        x = parallel.split_to(x, 1, sp.model)
    for k, (seg, seg_params) in enumerate(zip(plan, params_list)):
        seg_cache = cache_list[k] if cache_list is not None else None
        layers = {}
        if train:
            for j, (spec, n) in enumerate(seg.pattern):
                layers[j] = _unbound(seg_params[f"e{j}"], [
                    (r, i) if seg.repeat > 1 else (i,)
                    for r in range(seg.repeat) for i in range(n)])
        for r in range(seg.repeat):
            for j, (spec, n) in enumerate(seg.pattern):
                for i in range(n):
                    idx = (r, i) if seg.repeat > 1 else (i,)
                    layer_cache = (_layer(seg_cache[f"e{j}"], idx)
                                   if seg_cache is not None else None)
                    layer = (layers[j][idx] if train
                             else _layer(seg_params[f"e{j}"], idx))
                    args = (layer, x, cfg, spec, sp, positions,
                            layer_cache, tables, mode, live, memory,
                            cache_free)
                    if remat:
                        with _saving(x):
                            out = checkpoint(_block, *args,
                                             use_reentrant=False)
                    else:
                        out = _block(*args)
                    if cache_free:
                        x, a = out
                        if a is not None:
                            aux = aux + a
                    else:
                        x = out
    if sp is not None:
        x = parallel.gather_keep(x, 1, sp.model)
    return x, aux


def _block(layer, x, cfg: ModelConfig, spec, sp, *rest):
    """``block_apply`` over one layer whose leaves the current mesh may
    hold cut over its batch axes (FSDP): each is gathered here, inside the
    layer's remat, so one layer's weights are whole at a time.  ``sp``,
    the stack's sequence-parallel context or None, is made current for
    the block here, so remat's recompute runs under it too."""
    ctx = parallel.current()
    if ctx is not None and ctx.fsdp:
        layer = ctx.fsdp_gather(layer, block_defs(cfg, spec))
    if sp is None:
        return block_apply(layer, x, cfg, spec, *rest)
    with parallel.use_mesh(sp):
        return block_apply(layer, x, cfg, spec, *rest)


# ---------------------------------------------------------------------------
# Positions / logits
# ---------------------------------------------------------------------------


def default_positions(cfg: ModelConfig, b: int, s: int, offset=None,
                      device=None) -> torch.Tensor:
    """(B, S) int32 positions from ``offset`` (B,) or 0; (B, S, 3), the
    three streams equal, for an M-RoPE model."""
    dev = offset.device if offset is not None else device
    pos = torch.arange(s, dtype=torch.int32, device=dev)[None, :].expand(b, s)
    if offset is not None:
        pos = pos + offset.to(torch.int32)[:, None]
    return _streams(cfg, pos)


def _streams(cfg: ModelConfig, pos: torch.Tensor) -> torch.Tensor:
    """(B, S) positions as the (B, S, 3) of M-RoPE, each stream equal (a
    view); unchanged for any other model."""
    if cfg.mrope_sections:
        return pos[..., None].expand(*pos.shape, len(cfg.mrope_sections))
    return pos


def _whole(t: torch.Tensor, p: prm.P) -> torch.Tensor:
    """A top-level leaf (the embedding table, the unembedding) gathered
    over the batch axes where the current mesh's rules cut it (FSDP)."""
    ctx = parallel.current()
    return ctx.fsdp_leaf(t, p) if ctx is not None and ctx.fsdp else t


def _embed(params, cfg: ModelConfig, tokens):
    table = _whole(params["embed"]["table"],
                   embed_defs(cfg.vocab, cfg.d_model)["table"])
    return embed({"table": table}, tokens, cfg.vocab)


def _embed_inputs(params, cfg: ModelConfig, tokens, vision_embeds):
    """Token embeddings; a VLM's precomputed patch embeddings (B, P, d)
    take the first P slots once a vocabulary-cut embedding's ranks are
    summed (``layers.embed``), so they enter the sum on no rank."""
    x = _embed(params, cfg, tokens)
    if vision_embeds is not None:
        p = vision_embeds.shape[1]
        x = torch.cat([vision_embeds.to(x.dtype), x[:, p:]], dim=1)
    return x


def _head(params, cfg: ModelConfig) -> torch.Tensor:
    """The unembedding weight, whole over the batch axes: the embedding
    table when tied."""
    if cfg.tie_embeddings:
        return _whole(params["embed"]["table"],
                      embed_defs(cfg.vocab, cfg.d_model)["table"])
    return _whole(params["unembed"]["w"],
                  unembed_defs(cfg.d_model, cfg.vocab)["w"])


def _logits(params, cfg: ModelConfig, x, head=None):
    """Logits over the whole vocabulary.  Where the model axis cuts the
    vocabulary, each rank's logits of its rows are gathered (backward:
    its slice), so every rank holds and scores all of them."""
    w = _head(params, cfg) if head is None else head
    vdim = -2 if cfg.tie_embeddings else -1
    model = (parallel.current().model
             if prm.tp(w, vdim, cfg.vocab) is not None else None)
    if model is not None:
        x = parallel.copy_to(x, model)
    if cfg.tie_embeddings:
        logits = unembed_tied({"table": w}, x, cfg.logit_softcap)
    else:
        logits = unembed({"w": w}, x, cfg.logit_softcap)
    return logits if model is None else parallel.gather_keep(logits, -1,
                                                               model)


# ---------------------------------------------------------------------------
# Encoder (enc-dec models; the frontend stub gives frame embeddings)
# ---------------------------------------------------------------------------


def encode(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """The encoder stack over frame embeddings (B, T, d): non-causal, no
    cache.  Returns the memory (B, T, d) the decoder's cross attention
    reads."""
    b, t, _ = frames.shape
    pos = torch.arange(t, dtype=torch.int32,
                       device=frames.device)[None].expand(b, t)
    x, _ = _run_plan(cfg.enc_plan(), cfg, params["encoder"], frames, pos,
                     None, None)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Training entry points
# ---------------------------------------------------------------------------

AUX_WEIGHT = 0.01


def hidden_states(params, cfg: ModelConfig, tokens: torch.Tensor, *,
                  positions=None, vision_embeds=None, frames=None):
    """Trunk only: embeddings -> stack -> final norm.  Returns ((B, S, D),
    aux), aux the MoE layers' summed load-balance loss (an f32 zero
    without MoE).  ``positions`` (B, S), or (B, S, 3) for M-RoPE (by
    default ``default_positions``); ``vision_embeds`` (B, P, d) over the
    first P token slots; ``frames`` (B, T_enc, d), the encoder's input,
    which an encoder-decoder model needs."""
    b, s = tokens.shape
    if cfg.is_encdec and frames is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder model: its "
                         f"encoder needs frames")
    memory = encode(params, cfg, frames) if cfg.is_encdec else None
    if positions is None:
        positions = default_positions(cfg, b, s, device=tokens.device)
    x = _embed_inputs(params, cfg, tokens, vision_embeds)
    x, aux = _run_plan(cfg.plan(), cfg, params["decoder"], x, positions,
                       None, None, memory=memory)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            positions=None, vision_embeds=None, frames=None):
    """Full-sequence forward -> (logits (B, S, V), aux)."""
    x, aux = hidden_states(params, cfg, tokens, positions=positions,
                           vision_embeds=vision_embeds, frames=frames)
    return _logits(params, cfg, x), aux


def loss_fn(params, cfg: ModelConfig, batch: dict):
    """batch: tokens (B, S), labels (B, S) (-1 = pad), optional
    positions / vision_embeds / frames.  Returns (loss, {"loss", "xent",
    "aux"}), loss = xent + AUX_WEIGHT * aux.  The unembed and cross
    entropy run in ``cfg.loss_chunk`` slices, so the (B, S, V) logits
    never exist at once."""
    x, aux = hidden_states(params, cfg, batch["tokens"],
                           positions=batch.get("positions"),
                           vision_embeds=batch.get("vision_embeds"),
                           frames=batch.get("frames"))
    labels = batch["labels"]
    mask = (labels >= 0).float()
    head = _head(params, cfg)
    ctx = parallel.current()
    if ctx is None or ctx.batch_world == 1:
        xent = chunked_unembed_xent(lambda xc: _logits(params, cfg, xc, head),
                                    x, labels.clamp_min(0), mask,
                                    cfg.loss_chunk)
    else:
        # this rank's share of the global mean: its nll over the global
        # token count, summed over the batch group (backward: identity,
        # so each rank's gradient is its own share)
        nll, m = chunked_unembed_sums(
            lambda xc: _logits(params, cfg, xc, head), x,
            labels.clamp_min(0), mask, cfg.loss_chunk)
        total = parallel.all_reduce(m.detach(), ctx.batch)
        xent = parallel.reduce_from(nll / torch.clamp(total, min=1.0),
                                    ctx.batch)
    loss = xent + AUX_WEIGHT * aux
    return loss, {"loss": loss, "xent": xent, "aux": aux}


# ---------------------------------------------------------------------------
# Cache + serving entry points
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_context: int,
               layout: str = "ring", num_pages: int = 0,
               page_size: int = 128, device=None, enc_len: int = 0,
               ring_slots=None) -> dict:
    """Decode state, stacked per segment element, plus the per-slot next
    position ``pos``.  ``layout="ring"`` (default) builds slot-contiguous
    rings (``batch`` rows, ``kv_cache_size`` slots per layer);
    ``layout="paged"`` one shared page pool per layer sized by the
    allocator's ``num_pages``, where ``max_context`` only bounds the
    block tables the engine passes.  An encoder-decoder model's ring
    cache holds the cross K/V of ``enc_len`` encoder positions.
    ``ring_slots(size)``, where given, is the K/V slots a rank holds of
    a ring of ``size`` (a serve step's sequence-sharded ring; its
    ``kpos`` keeps all ``size``)."""
    if layout not in ("ring", "paged"):
        raise ValueError(f"unknown cache layout {layout!r}")
    if layout == "paged" and num_pages <= 0:
        raise ValueError("paged cache layout needs num_pages > 0")
    dev = prm.resolve_device(device)
    dtype = prm.torch_dtype(cfg.dtype)

    def one(spec, stack):
        if layout == "paged":
            return init_paged_block_cache(cfg, spec, num_pages, page_size,
                                          dtype, dev, stack)
        return init_block_cache(cfg, spec, batch, max_context, dtype, dev,
                                stack, enc_len, ring_slots)

    segments = [{f"e{j}": one(spec, _stack_dims(seg, n))
                 for j, (spec, n) in enumerate(seg.pattern)}
                for seg in cfg.plan()]
    return {"segments": segments,
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, cache: dict, *,
            positions=None, vision_embeds=None, frames=None):
    """One-shot prefill of a ring cache from position 0.  tokens (B, S);
    ``positions`` (B, S) or, for M-RoPE, (B, S, 3), by default
    ``default_positions``; ``vision_embeds`` (B, P, d) over the first P
    token slots (a VLM); ``frames`` (B, T_enc, d), the encoder's input
    (an encoder-decoder model, whose cache was built with ``enc_len =
    T_enc``).  Returns (last-token logits (B, V), cache), the cache
    updated in place and every row's ``pos`` set to S."""
    b, s = tokens.shape
    memory = encode(params, cfg, frames) if cfg.is_encdec else None
    if positions is None:
        positions = default_positions(cfg, b, s, device=tokens.device)
    x = _embed_inputs(params, cfg, tokens, vision_embeds)
    x, _ = _run_plan(cfg.plan(), cfg, params["decoder"], x, positions,
                     cache["segments"], None, "prefill", memory=memory)
    x_last = rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    logits = _logits(params, cfg, x_last)[:, 0]
    cache["pos"].fill_(s)
    return logits, cache


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, cache: dict,
                tables: Optional[torch.Tensor] = None,
                live: Optional[torch.Tensor] = None):
    """tokens: (B, 1), one new token per sequence.  A paged cache needs
    ``tables`` (B, P), the live block tables; a ring cache takes none.
    ``live`` (B,) bool marks the slots that decode; ``None`` means all.
    Returns (logits (B, V), cache), the cache updated in place: each live
    slot's ``pos`` advanced by one and its token written.  Every other
    slot (empty, or parked on a tool call) keeps its cache state as it
    was -- its ``pos``, its ring and a recurrent layer's state -- so a
    pinned request resumes where it stopped (the reference advances every
    slot; ROADMAP §C, reference fault 4).  A decoder with cross attention
    reads the cross K/V its prefill stored."""
    pos = cache["pos"]                                   # (B,)
    x = _embed(params, cfg, tokens)
    x, _ = _run_plan(cfg.plan(), cfg, params["decoder"], x,
                     _streams(cfg, pos[:, None]), cache["segments"], tables,
                     "step", live)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _logits(params, cfg, x)[:, 0]
    if live is None:
        pos += 1
    else:
        pos += live.to(pos.dtype)
    return logits, cache


def prefill_paged(params, cfg: ModelConfig, tokens: torch.Tensor, cache: dict,
                  tables: torch.Tensor, start: torch.Tensor, slot: int):
    """Suffix prefill into the shared page pool.

    tokens (1, S): the uncached prompt suffix; start (1,) int32: its
    absolute position; tables (1, P): the sequence's block-table row
    (resident prefix pages first); slot: the batch slot whose ``pos`` to
    set.  Returns (last-token logits (1, V), cache)."""
    b, s = tokens.shape
    positions = default_positions(cfg, b, s, offset=start)
    x = _embed(params, cfg, tokens)
    x, _ = _run_plan(cfg.plan(), cfg, params["decoder"], x, positions,
                     cache["segments"], tables)
    x_last = rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    logits = _logits(params, cfg, x_last)[:, 0]
    cache["pos"][slot] = start[0] + s
    return logits, cache


def prefill_paged_padded(params, cfg: ModelConfig, tokens: torch.Tensor,
                         cache: dict, tables: torch.Tensor,
                         start: torch.Tensor, slot: torch.Tensor,
                         n: torch.Tensor):
    """Shape-stable suffix prefill: a fixed-capacity chunk buffer whose
    valid length is a device value, for the mixed step's CUDA graph.

    tokens (1, C): the chunk buffer, of which the first ``n`` tokens are
    real; ``start``, ``slot`` and ``n`` are 0-d integer tensors on the
    device (the reference's traced scalars), so nothing here reads a
    value back to the host.  Tail positions at or past ``n`` are -1:
    their KV writes land in the pool's sink page (``_phys_slots``) and
    their queries mask out.  Returns (logits of the token at ``n - 1``
    (1, V), cache), with ``pos[slot] = start + n``."""
    b, c = tokens.shape
    idx = torch.arange(c, dtype=torch.int32, device=tokens.device)[None, :]
    positions = torch.where(idx < n, start + idx, -1).to(torch.int32)
    x = _embed(params, cfg, tokens)
    x, _ = _run_plan(cfg.plan(), cfg, params["decoder"], x,
                     _streams(cfg, positions), cache["segments"], tables)
    last = (n - 1).reshape(1).long()
    x_last = rmsnorm(params["final_norm"], torch.index_select(x, 1, last),
                     cfg.norm_eps)
    logits = _logits(params, cfg, x_last)[:, 0]
    cache["pos"].index_put_((slot.reshape(1).long(),),
                            (start + n).reshape(1).to(torch.int32))
    return logits, cache


# ---------------------------------------------------------------------------
# Paged <-> ring state bridge (KV migration)
# ---------------------------------------------------------------------------


def _map_paged_kv(cache: dict, fn):
    """A copy of the cache's segment tree with ``fn`` applied to every
    PagedKVCache (leaves carry leading layer-stack dims), dict keys
    visited in sorted order."""
    return _map_paged(cache["segments"], fn)


def _map_paged(node, fn):
    # a module-level recursion: a recursive closure would be a reference
    # cycle holding ``fn`` and the device tensors it closes over until
    # the cyclic collector ran
    if isinstance(node, PagedKVCache):
        return fn(node)
    if isinstance(node, dict):
        return {k: _map_paged(node[k], fn) for k in sorted(node)}
    if isinstance(node, list):
        return [_map_paged(v, fn) for v in node]
    return node


def _ring_leaves(tree) -> list[KVCache]:
    """The KVCache leaves of a segment tree, in the walk order of
    ``_map_paged_kv`` (a tree from the reference has its dict keys
    sorted, as ``jax.tree`` rebuilds them)."""
    if isinstance(tree, KVCache):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _ring_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _ring_leaves(v)]
    return []


def _as_table(table_row, device) -> torch.Tensor:
    return torch.as_tensor(table_row, dtype=torch.int32,
                           device=device).reshape(1, -1)


def paged_extract(cfg: ModelConfig, cache: dict, table_row, ctx: int,
                  max_context: int, slot: int) -> dict:
    """One sequence of the paged pool as a batch-1 *ring*-layout cache:
    the format ring engines extract and inject, so KV migration does not
    care which layout produced it.  Every layer's ring has
    ``max_context`` slots, as the reference's."""
    dev = cache["pos"].device
    tables = _as_table(table_row, dev)

    def one(pkv: PagedKVCache) -> KVCache:
        stack = pkv.k.shape[:-4]
        kf = pkv.k.reshape((-1,) + pkv.k.shape[-4:])
        vf = pkv.v.reshape((-1,) + pkv.v.shape[-4:])
        outs = [_pool_to_ring(cfg, PagedKVCache(kf[i], vf[i]), tables, ctx,
                              max_context) for i in range(kf.shape[0])]
        return KVCache(*(torch.stack(xs).reshape(stack + xs[0].shape)
                         for xs in zip(*outs)))

    return {"segments": _map_paged_kv(cache, one),
            "pos": cache["pos"][slot:slot + 1].clone()}


def _pool_to_ring(cfg: ModelConfig, pkv: PagedKVCache, tables: torch.Tensor,
                  ctx: int, max_context: int) -> KVCache:
    view = attn.paged_view(pkv, tables)                  # (1, P*page, ...)
    ring = attn.init_kv_cache(1, max_context, pkv.k.shape[-2],
                              pkv.k.shape[-1], pkv.k.dtype, pkv.k.device)
    if ctx <= 0:
        return ring
    n = min(ctx, view.k.shape[1])
    return attn.cache_write(ring, view.k[:, :n], view.v[:, :n],
                            torch.zeros((1,), dtype=torch.int32,
                                        device=pkv.k.device))


def paged_insert(cfg: ModelConfig, cache: dict, sub: dict, table_row,
                 slot: int) -> dict:
    """Install a batch-1 ring-layout cache (from ``paged_extract`` or a
    ring engine's extract, on the device or in host memory) into the
    paged pool at ``table_row``'s pages, in place.  Ring slots scatter
    through their absolute ``kpos``, so a wrapped SWA ring lands at the
    right logical pages and empty slots hit the sink."""
    dev = cache["pos"].device
    tables = _as_table(table_row, dev)
    rings = iter(_ring_leaves(sub["segments"]))

    def one(pkv: PagedKVCache) -> PagedKVCache:
        ring = next(rings)
        kf = pkv.k.reshape((-1,) + pkv.k.shape[-4:])
        vf = pkv.v.reshape((-1,) + pkv.v.shape[-4:])
        rk = ring.k.reshape((-1,) + ring.k.shape[-4:]).to(
            dev, non_blocking=True)
        rv = ring.v.reshape((-1,) + ring.v.shape[-4:]).to(
            dev, non_blocking=True)
        rp = ring.kpos.reshape((-1,) + ring.kpos.shape[-2:]).to(
            dev, non_blocking=True)
        for i in range(kf.shape[0]):
            attn.paged_cache_write_at(PagedKVCache(kf[i], vf[i]), rk[i],
                                      rv[i], rp[i], tables)
        return pkv

    _map_paged_kv(cache, one)
    cache["pos"][slot] = sub["pos"][0].to(dev)
    return cache
