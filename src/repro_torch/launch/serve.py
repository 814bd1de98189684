"""Serving-step factories (port of ``repro/launch/serve.py``): one decode
step, or one prefill, over a ring KV cache sharded by ``cache_pspecs``.

On a mesh each rank holds its shard of the parameters (``param_pspecs``)
and of the cache: its rows of the batch (``data``/``pod``, all of them
where the batch does not split, as a long-context batch of one), its KV
heads (``model``) or all of them, and, where the spec cuts a ring's
sequence axis, its range of the ring's slots with the whole ``kpos``:
the reference's GQA fallback over ``model`` when the KV heads do not
divide it, and ``shard_seq`` over ``data`` for ``long_*``.  The ranks run
the model with the TP, EP and FSDP collectives of
``distributed.parallel``; over a sequence-sharded ring each writes the
tokens whose slots it holds, prefill attends over the prompt as on one
device, and decode attends over the rank's slots alone and combines the
ranks' partial softmaxes by their log-sum-exps (mesh-level
flash-decoding, ``models.attention.attend_range``).  With
``cfg.use_pallas`` the Hopper kernels run on the rank's local shard:
``flash_attention`` at prefill, ``decode_attention`` (with its
log-sum-exp over a slot range) and ``attention_combine`` at decode,
``grouped_matmul`` for the MoE's experts.

Every family runs over ``model``: a hybrid's SSM state, an mLSTM's or
sLSTM's state stays whole on every model rank (``cache_layout``), and an
encoder-decoder's cross K/V is cut by heads, as the spec cuts it, and
along its encoder axis where the spec cuts that too (``long_*``: each
rank attends over its range and the ranks combine, as over a ring);
its prefill step takes the frames, a VLM's its patch embeddings.  With
``cfg.act_sharding`` the prefill step's residual stream is cut along S
over ``model`` between blocks, where the reference's ``_constrain_act``
cuts it (``MeshContext.seq_parallel``); decode (S = 1) never is.

A long-context decode step's cache is laid out unlike a prefill's (the
reference's prefill step does not pass ``shard_seq``): ``cut_cache``
cuts a whole cache, from a prefill on one device, to a step's spec.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import parallel
from repro_torch.distributed import sharding as shd
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.train import _one_device, check_mesh
from repro_torch.models import params as prm
from repro_torch.models import transformer
from repro_torch.models.attention import CrossKV, KVCache


def _context_len(shape: ShapeConfig) -> int:
    return (specs_mod.decode_context(shape) if shape.kind == "decode"
            else shape.seq_len)


def _shard_seq(shape: ShapeConfig) -> bool:
    return shape.kind == "decode" and shape.name.startswith("long")


def _specs(cfg: ModelConfig, mesh, shape: ShapeConfig, rules) -> dict:
    b = shape.global_batch
    return {"params": shd.param_pspecs(cfg, mesh, rules),
            "cache": shd.cache_pspecs(cfg, b, _context_len(shape), mesh,
                                      enc_len=specs_mod.enc_len(cfg, shape),
                                      rules=rules,
                                      shard_seq=_shard_seq(shape)),
            "batch": shd.batch_pspec(mesh, rules, batch_size=b)}


def serving_context(cfg: ModelConfig, mctx, shape: ShapeConfig,
                    rules: shd.ShardingRules = shd.DEFAULT_RULES):
    """The mesh context of a serve step of ``shape``: its batch spec's
    axes, and the mesh axis its cache spec cuts each ring's sequence
    over and the cross K/V's encoder axis over (``kv_entries``, as
    ``cache_pspecs``)."""
    b_mesh = shd.cache_batch_axes(shape.global_batch, mctx.sizes, rules)
    shard_seq = _shard_seq(shape)

    def ring_seq(slots: int):
        return shd.kv_entries(slots, cfg.n_kv_heads, mctx.sizes, b_mesh,
                              rules, shard_seq)[0]

    enc = specs_mod.enc_len(cfg, shape)
    return mctx.for_serving(b_mesh, ring_seq,
                            ring_seq(enc) if enc else None)


def _plan(cfg: ModelConfig, mesh, shape: ShapeConfig, rules, device):
    """(mesh context, device, specs) of a serve step, after the refusals."""
    spec_mesh = mesh if mesh is not None else _one_device()
    specs = _specs(cfg, spec_mesh, shape, rules)
    mctx = parallel.context(mesh, rules, act_sharding=(
        shape.kind == "prefill" and cfg.act_sharding))
    if mctx is None:
        return None, prm.resolve_device(device), specs
    check_serve(cfg, mctx, specs["cache"], rules)
    parallel.check_device(device, mctx.device)
    return serving_context(cfg, mctx, shape, rules), mctx.device, specs


def check_serve(cfg: ModelConfig, mesh, cache_specs,
                rules: shd.ShardingRules = shd.DEFAULT_RULES) -> None:
    """Raise ``ValueError`` for a serve cell the port's steps do not run:
    ``check_mesh``'s refusals (a batch that does not split over the batch
    axes is served replicated, as the reference's batch spec does), and
    with ``cfg.use_pallas`` a ring or cross K/V cut over ``model`` whose
    whole GQA group (every query head over its KV heads) no decode kernel
    takes.  Shape logic only."""
    check_mesh(cfg, mesh)
    sizes = shd.mesh_axis_sizes(mesh)
    where = f"{cfg.name} on mesh {sizes}"
    if cfg.use_pallas and any("model" in parallel.entry_axes(kv[-3])
                              for kv in _kv_specs(cache_specs,
                                                  (KVCache, CrossKV))):
        from repro_torch.kernels.attention_shapes import check_decode_shape

        try:
            check_decode_shape(prm.torch_dtype(cfg.dtype), cfg.d_head,
                               cfg.n_heads // cfg.n_kv_heads)
        except ValueError as e:
            raise ValueError(f"{where}: decode over a ring cut over "
                             f"'model' attends with all {cfg.n_heads} "
                             f"query heads over {cfg.n_kv_heads} KV heads: "
                             f"{e}") from None


def _kv_specs(tree, kind) -> list:
    """The (..., B, S, Hkv, dh) specs of the ring (``KVCache``) or cross
    (``CrossKV``) K/V leaves."""
    if isinstance(tree, kind):
        return [tree.k, tree.v]
    if isinstance(tree, (KVCache, CrossKV)):
        return []
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _kv_specs(v, kind)]
    if isinstance(tree, list):
        return [s for v in tree for s in _kv_specs(v, kind)]
    return []


def local_rows(x, mctx, batch_spec=None) -> object:
    """This rank's rows of a global batch (all of them with no mesh):
    those of the mesh axes of ``batch_spec`` (a step's ``specs["batch"]``)
    where given, else of the context's row axes (a serve step's own
    context: its batch spec's)."""
    if mctx is None:
        return x
    axes = mctx.row_axes if batch_spec is None else parallel.entry_axes(
        batch_spec[0] if len(batch_spec) else None)
    world = mctx.size(axes)
    if world == 1:
        return x
    n = x.shape[0] // world
    r = mctx.coord(axes)
    return x[r * n:(r + 1) * n]


def init_cache(cfg: ModelConfig, mesh, shape: ShapeConfig,
               rules: shd.ShardingRules = shd.DEFAULT_RULES, device=None):
    """This rank's shard of the step's ring cache, zeroed, as the step's
    cache spec cuts it: its rows of the batch, its KV heads or all of
    them, of a ring whose sequence axis the spec cuts its range of the
    slots (``S / n``) with the whole ``kpos``, and of a cross K/V whose
    encoder axis the spec cuts its range of the encoder positions."""
    mctx = parallel.context(mesh, rules)
    b = shape.global_batch
    ctx_len = _context_len(shape)
    enc = specs_mod.enc_len(cfg, shape)
    if mctx is None:
        return transformer.init_cache(cfg, b, ctx_len, device=device,
                                      enc_len=enc)
    sctx = serving_context(cfg, mctx, shape, rules)
    m = mctx.size("model")
    local = cfg.replace(n_kv_heads=cfg.n_kv_heads // m) \
        if cfg.n_kv_heads % m == 0 else cfg

    def ring_slots(size: int) -> int:
        return size // sctx.size(sctx.ring_seq(size))

    return transformer.init_cache(local, b // sctx.row_world, ctx_len,
                                  device=mctx.device,
                                  enc_len=enc // sctx.size(sctx.cross_seq),
                                  ring_slots=ring_slots)


def cache_layout(cache_specs, batch_entry):
    """The cache spec as the port's serve steps hold the cache: the ring
    and cross K/V leaves as the spec cuts them, every other leaf
    (``kpos``, ``pos``, recurrent state) by its batch axis only.  The
    reference's spec takes any 4-D leaf whose third axis equals a head
    count for K/V, so at hymba's smoke width (state width 4 = 4 heads)
    it cuts the SSM state too (ROADMAP §C, reference fault 7)."""
    if shd.is_spec(cache_specs):
        return shd.PartitionSpec(*(e if e == batch_entry and e is not None
                                   else None for e in cache_specs))
    if isinstance(cache_specs, KVCache):
        return KVCache(cache_specs.k, cache_specs.v,
                       cache_layout(cache_specs.kpos, batch_entry))
    if isinstance(cache_specs, CrossKV):
        return cache_specs
    if isinstance(cache_specs, dict):
        return {k: cache_layout(v, batch_entry)
                for k, v in cache_specs.items()}
    if isinstance(cache_specs, list):
        return [cache_layout(v, batch_entry) for v in cache_specs]
    if isinstance(cache_specs, tuple):
        return type(cache_specs)(*(cache_layout(v, batch_entry)
                                   for v in cache_specs))
    return cache_specs


def cut_cache(cache, cfg: ModelConfig, mesh, shape: ShapeConfig,
              rules: shd.ShardingRules = shd.DEFAULT_RULES):
    """This rank's shard, as a serve step of ``shape`` holds its cache
    (``cache_layout`` of its spec), of a whole ring cache
    (``transformer.init_cache`` of the step's global batch and context,
    filled by a prefill on one device): how a ``long_*`` decode step,
    whose ring is cut along its sequence axis, takes a prefill's cache.
    Contiguous copies, on the mesh's device."""
    spec_mesh = mesh if mesh is not None else _one_device()
    specs = _specs(cfg, spec_mesh, shape, rules)
    batch = specs["batch"]
    specs = cache_layout(specs["cache"], batch[0] if len(batch) else None)
    mctx = parallel.context(mesh, rules)
    leaves, treedef = prm.flatten(parallel.shard_tree(cache, specs, mctx))
    if mctx is not None:
        leaves = [t.to(mctx.device) for t in leaves]
    return prm.unflatten(treedef, leaves)


def make_serve_step(cfg: ModelConfig, mesh, shape: ShapeConfig,
                    rules: shd.ShardingRules = shd.DEFAULT_RULES,
                    device=None):
    """One batched decode step: ``step(params, tokens (B, 1), cache) ->
    (logits (B_local, V), cache)``, with ``params`` and ``cache`` this
    rank's shards, ``tokens`` the global batch (the step takes its rows)
    and the logits over the whole vocabulary.  Returns (step, {"params",
    "cache", "batch"} specs), as the reference does."""
    if shape.kind != "decode":
        raise ValueError(f"make_serve_step takes a decode shape, not "
                         f"{shape.kind!r}")
    mctx, dev, specs = _plan(cfg, mesh, shape, rules, device)

    def serve_step(params, tokens, cache):
        with parallel.use_mesh(mctx):
            return transformer.decode_step(
                params, cfg, local_rows(tokens, mctx).to(dev), cache)

    return serve_step, specs


def make_prefill_step(cfg: ModelConfig, mesh, shape: ShapeConfig,
                      rules: shd.ShardingRules = shd.DEFAULT_RULES,
                      device=None):
    """One-shot prefill: ``step(params, tokens (B, S), cache[, frontend])
    -> (last-token logits (B_local, V), cache)``; a VLM's step takes
    ``vision_embeds`` and an encoder-decoder's ``frames`` (global batch,
    as ``tokens``).  The cache may be the decode step's (``init_cache``
    of a decode shape of the same prompt): its rings are cut as the
    prefill's own spec cuts a ring of that many slots.  Returns (step,
    specs)."""
    if shape.kind != "prefill":
        raise ValueError(f"make_prefill_step takes a prefill shape, not "
                         f"{shape.kind!r}")
    mctx, dev, specs = _plan(cfg, mesh, shape, rules, device)

    def prefill_step(params, tokens, cache, extra=None):
        kw = {}
        if cfg.frontend == "patch":
            kw["vision_embeds"] = local_rows(extra, mctx).to(dev)
        elif cfg.is_encdec:
            kw["frames"] = local_rows(extra, mctx).to(dev)
        with parallel.use_mesh(mctx):
            return transformer.prefill(
                params, cfg, local_rows(tokens, mctx).to(dev), cache, **kw)

    return prefill_step, specs
