"""Serving-step factories (port of ``repro/launch/serve.py``): one decode
step, or one prefill, over a ring KV cache sharded by ``cache_pspecs``.

On a mesh each rank holds its shard of the parameters (``param_pspecs``)
and of the cache: its rows of the batch (``data``/``pod``) and its KV
heads (``model``), and runs the model with the TP, EP and FSDP
collectives of ``distributed.parallel``.  With ``cfg.use_pallas`` the
Hopper kernels run on the rank's local shard: ``flash_attention`` at
prefill, ``decode_attention`` at decode, ``grouped_matmul`` for the
MoE's experts.  The port's serve steps refuse a cache whose ring
sequence axis is sharded (the reference's GQA fallback when the KV heads
do not divide the model axis, and ``shard_seq`` for ``long_*``), which
would need a softmax combine across ranks (ROADMAP A6.2).
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


def _plan(cfg: ModelConfig, mesh, shape: ShapeConfig, rules, ctx: int,
          device, shard_seq: bool = False):
    """(mesh context, device, specs) of a serve step, after the refusals."""
    b = shape.global_batch
    enc = specs_mod.enc_len(cfg, shape)
    spec_mesh = mesh if mesh is not None else _one_device()
    specs = {"params": shd.param_pspecs(cfg, spec_mesh, rules),
             "cache": shd.cache_pspecs(cfg, b, ctx, spec_mesh, enc_len=enc,
                                       rules=rules, shard_seq=shard_seq),
             "batch": shd.batch_pspec(spec_mesh, rules, batch_size=b)}
    mctx = parallel.context(mesh, rules)
    if mctx is None:
        return None, prm.resolve_device(device), specs
    check_serve(cfg, mctx, specs["cache"], b, rules)
    parallel.check_device(device, mctx.device)
    return mctx, mctx.device, specs


def check_serve(cfg: ModelConfig, mesh, cache_specs, batch: int,
                rules: shd.ShardingRules = shd.DEFAULT_RULES) -> None:
    """Raise ``ValueError`` for a serve cell the port's steps do not run:
    a cache spec that shards the ring's sequence axis, or KV heads that
    replicate while the query heads are cut (both ROADMAP A6.2), then
    ``check_mesh``'s refusals.  Shape logic only."""
    sizes = shd.mesh_axis_sizes(mesh)
    where = f"{cfg.name} on mesh {sizes}"
    for kv in _kv_specs(cache_specs):
        if shd.axes_size(kv[-3], sizes) > 1:
            raise ValueError(f"{where}: the cache spec {kv} shards the "
                             f"ring's sequence axis, which needs a softmax "
                             f"combine across ranks (ROADMAP A6.2)")
    m = sizes.get("model", 1)
    if m > 1 and cfg.n_heads % m == 0 and cfg.n_kv_heads % m:
        raise ValueError(f"{where}: {cfg.n_kv_heads} KV heads replicate "
                         f"over a model axis of {m} (ROADMAP A6.2)")
    check_mesh(cfg, mesh, batch, rules)


def _kv_specs(tree) -> list:
    """The (..., B, S, Hkv, dh) specs of the ring and cross K/V leaves."""
    if isinstance(tree, (KVCache, CrossKV)):
        return [tree.k, tree.v]
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _kv_specs(v)]
    if isinstance(tree, list):
        return [s for v in tree for s in _kv_specs(v)]
    return []


def local_rows(x, mctx) -> object:
    """This rank's rows of a global batch (all of them with no mesh)."""
    if mctx is None or mctx.batch_world == 1:
        return x
    n = x.shape[0] // mctx.batch_world
    return x[mctx.batch_rank * n:(mctx.batch_rank + 1) * n]


def init_cache(cfg: ModelConfig, mesh, shape: ShapeConfig,
               rules: shd.ShardingRules = shd.DEFAULT_RULES, device=None):
    """This rank's shard of the step's ring cache, zeroed: its rows of the
    batch and its KV heads."""
    mctx = parallel.context(mesh, rules)
    b = shape.global_batch
    ctx_len = (specs_mod.decode_context(shape) if shape.kind == "decode"
               else shape.seq_len)
    enc = specs_mod.enc_len(cfg, shape)
    if mctx is None:
        return transformer.init_cache(cfg, b, ctx_len, device=device,
                                      enc_len=enc)
    m = mctx.size("model")
    local = cfg.replace(n_kv_heads=cfg.n_kv_heads // m) \
        if cfg.n_kv_heads % m == 0 else cfg
    return transformer.init_cache(local, b // mctx.batch_world, ctx_len,
                                  device=mctx.device, enc_len=enc)


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
    mctx, dev, specs = _plan(cfg, mesh, shape, rules,
                             specs_mod.decode_context(shape), device,
                             shape.name.startswith("long"))

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
    as ``tokens``).  Returns (step, specs)."""
    if shape.kind != "prefill":
        raise ValueError(f"make_prefill_step takes a prefill shape, not "
                         f"{shape.kind!r}")
    mctx, dev, specs = _plan(cfg, mesh, shape, rules, shape.seq_len, device)

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
