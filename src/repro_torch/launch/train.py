"""Training-step factory (port of ``repro/launch/train.py``).

``make_train_step`` builds the (params, opt_state, batch) -> (params,
opt_state, metrics) update for a config, on one device or over a mesh:

* gradients of ``models.loss_fn`` by ``torch.autograd.grad`` for every
  config of the registry, with the Hopper kernels' forwards and
  backwards on the card when ``cfg.use_pallas`` is set (flash attention,
  the MoE's ``grouped_matmul``, the ``ssm_scan`` of hymba and the
  mLSTM), on each rank's local shard on a mesh;
* optional microbatch gradient accumulation in ``plan.accum_dtype``, in
  the reference's order (``a + g / k`` per microbatch);
* AdamW, optionally with int8 moments (``repro_torch.optim``), updating
  the parameters and moments in place (the port's answer to the
  reference's buffer donation).

On a mesh (a ``DeviceMesh`` from ``launch.mesh.make_mesh``) each rank
holds its shard of the parameters and moments by ``param_pspecs`` and
``opt_pspecs``, takes its rows of the global batch (``batch_pspec``),
and runs the model with the TP, EP and FSDP collectives of
``distributed.parallel``, with ``cfg.act_sharding`` its residual stream
cut along S over ``model`` between blocks where the reference's
``_constrain_act`` cuts it (sequence parallelism: remat keeps 1/m of
each layer's input); after the backward each leaf's gradient is
summed over the batch axes its spec does not cut (FSDP's gathers already
reduce-scattered the rest), and the clip's norm is summed over the
ranks.  With ``plan.compress_grads`` the sum over ``pod`` of the leaves
replicated over it goes through the int8 ``compressed_psum`` with error
feedback carried from step to step.  The reference's ``make_train_step``
never reads ``compress_grads`` (ROADMAP §C, reference fault 6).

``abstract_state`` gives the parameters and optimizer state as meta
tensors, the dry run's currency.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import collectives, parallel
from repro_torch.distributed import sharding as shd
from repro_torch.models import params as prm
from repro_torch.models import transformer
from repro_torch.models.params import (flatten, resolve_device, torch_dtype,
                                       unflatten)
from repro_torch.optim.adamw import (BLOCK, Q8, AdamWConfig, AdamWState,
                                     _is_q8, _sq_sum, adamw_init,
                                     adamw_update, global_blocks)

__all__ = ["AdamWConfig", "TrainPlan", "abstract_state", "adamw_init",
           "check_mesh", "default_plan", "held_pspecs", "init_opt_state",
           "make_compressed_grad_fn", "make_train_step", "opt_pspecs"]


@dataclass(frozen=True)
class TrainPlan:
    microbatch: int = 1              # gradient-accumulation steps
    accum_dtype: str = "float32"     # grad accumulator dtype
    compress_grads: bool = False     # int8 + EF sum over 'pod'
    int8_moments: bool = False


def default_plan(cfg: ModelConfig, shape: ShapeConfig,
                 n_chips: int = 256) -> TrainPlan:
    """The reference's memory-fitting heuristics, by parameter count."""
    n = transformer.param_count(cfg)
    if n > 100e9:
        return TrainPlan(microbatch=16, accum_dtype="bfloat16",
                         int8_moments=True)
    if n > 20e9:
        return TrainPlan(microbatch=4, int8_moments=True)
    return TrainPlan(microbatch=1)


# ---------------------------------------------------------------------------
# Sharding trees
# ---------------------------------------------------------------------------


def opt_pspecs(cfg: ModelConfig, mesh, acfg: AdamWConfig,
               rules: shd.ShardingRules = shd.DEFAULT_RULES) -> AdamWState:
    """Moments shard exactly like their parameters; int8 block scales
    inherit the param spec, the last (block) dim replicated where the
    block count does not divide over its axes."""
    p_specs = shd.param_pspecs(cfg, mesh, rules)
    flat_p, treedef = flatten(p_specs, is_leaf=shd.is_spec)
    sizes = shd.mesh_axis_sizes(mesh)
    defs = flatten(transformer.model_defs(cfg),
                   is_leaf=lambda x: isinstance(x, prm.P))[0]

    def moment(spec, p):
        if not acfg.int8_moments:
            return spec
        if not p.shape:
            return Q8(spec, shd.PartitionSpec(None))
        entries = list(spec)
        n_blocks = -(-p.shape[-1] // BLOCK)
        if entries[-1] is not None \
                and n_blocks % shd.axes_size(entries[-1], sizes):
            entries[-1] = None
        return Q8(spec, shd.PartitionSpec(*entries))

    m = unflatten(treedef, [moment(s, p) for s, p in zip(flat_p, defs)])
    v = unflatten(treedef, [moment(s, p) for s, p in zip(flat_p, defs)])
    return AdamWState(step=shd.PartitionSpec(), m=m, v=v)


def whole_blocks(shape, n_cut: int) -> bool:
    """Whether the int8 moments of a leaf of ``shape`` whose last dim is
    cut over ``n_cut`` ranks keep the whole leaf's block scales on every
    rank: its local last dim is off the 128-element blocks
    (``optim.adamw.global_blocks``)."""
    return bool(shape) and n_cut > 1 and (shape[-1] // n_cut) % BLOCK != 0


def held_pspecs(cfg: ModelConfig, mesh, acfg: AdamWConfig,
                rules: shd.ShardingRules = shd.DEFAULT_RULES):
    """The (params, opt_state) specs of the layout the sharded step holds
    (``step.shardings["state"]``, what a checkpoint of its state is saved
    and restored by): ``param_pspecs`` and ``opt_pspecs``, but the block
    scales of a ``whole_blocks`` leaf are whole on the last dim, as
    ``init_opt_state`` keeps them.  ``opt_pspecs``, equal to the
    reference's, cuts them wherever the block count divides (a (2, 64,
    192) leaf cut to 96 columns a rank has 2 blocks over 2 ranks)."""
    p_specs = shd.param_pspecs(cfg, mesh, rules)
    opt = opt_pspecs(cfg, mesh, acfg, rules)
    if not acfg.int8_moments:
        return p_specs, opt
    sizes = shd.mesh_axis_sizes(mesh)
    flat_p = flatten(p_specs, is_leaf=shd.is_spec)[0]
    defs = flatten(transformer.model_defs(cfg),
                   is_leaf=lambda x: isinstance(x, prm.P))[0]

    def held(tree):
        flat, treedef = flatten(tree, is_leaf=_is_q8)
        out = []
        for q8, spec, p in zip(flat, flat_p, defs):
            if whole_blocks(p.shape, shd.axes_size(spec[-1] if spec else None,
                                                   sizes)):
                q8 = Q8(q8.q, shd.PartitionSpec(*spec[:-1], None))
            out.append(q8)
        return unflatten(treedef, out)

    return p_specs, AdamWState(opt.step, held(opt.m), held(opt.v))


def abstract_state(cfg: ModelConfig, acfg: AdamWConfig):
    """(params, opt_state) as meta tensors: the dry run's currency."""
    dt = torch_dtype(cfg.dtype)
    p = prm.tree_map(lambda d: torch.empty(
        d.shape, dtype=torch_dtype(d.dtype) if d.dtype else dt,
        device="meta"), transformer.model_defs(cfg))
    return p, adamw_init(p, acfg)


# ---------------------------------------------------------------------------
# Per-leaf layout on a mesh
# ---------------------------------------------------------------------------


class _Leaf:
    """One parameter leaf on a mesh, from its spec: the batch axes whose
    ranks hold replicas of its gradient share (summed after the backward),
    whether this rank counts it in the clip's norm, and its int8 moments'
    blocks."""

    def __init__(self, p: prm.P, spec, ctx: parallel.MeshContext):
        cut = {a for e in spec for a in parallel.entry_axes(e)}
        self.reduce_axes = tuple(a for a in ctx.batch_axes
                                 if a not in cut and ctx.sizes[a] > 1)
        self.owner = all(ctx.coords[a] == 0 for a in ctx.names
                         if a not in cut)
        self.quant = None
        last = spec[-1] if spec else None
        n_cut = ctx.size(last)
        if whole_blocks(p.shape, n_cut):
            n = p.shape[-1] // n_cut
            group = ctx.group(last)
            self.quant = global_blocks(
                ctx.coord(last) * n, p.shape[-1],
                lambda t: parallel.all_reduce(t, group, "max"))
        self.blocks = -(-p.shape[-1] // BLOCK) if p.shape else 1


def _leaves(cfg: ModelConfig, ctx, rules) -> list[_Leaf]:
    defs = flatten(transformer.model_defs(cfg),
                   is_leaf=lambda x: isinstance(x, prm.P))[0]
    specs = flatten(shd.param_pspecs(cfg, ctx, rules), is_leaf=shd.is_spec)[0]
    return [_Leaf(p, s, ctx) for p, s in zip(defs, specs)]


def init_opt_state(params, acfg: AdamWConfig, mesh=None,
                   rules: shd.ShardingRules = shd.DEFAULT_RULES,
                   cfg: Optional[ModelConfig] = None) -> AdamWState:
    """Zero moments for ``params`` (this rank's shards on a mesh, which
    needs ``cfg``): ``adamw_init``, except that an int8 leaf whose blocks
    are the whole leaf's keeps all of its block scales."""
    state = adamw_init(params, acfg)
    ctx = parallel.context(mesh, rules)
    if ctx is None or not acfg.int8_moments:
        return state
    leaves = _leaves(cfg, ctx, rules)
    flat_p = flatten(params)[0]

    def fix(tree):
        flat, treedef = flatten(tree, is_leaf=_is_q8)
        out = []
        for q8, leaf, p in zip(flat, leaves, flat_p):
            if leaf.quant is not None:
                q8 = Q8(q8.q, torch.full((*p.shape[:-1], leaf.blocks), 1e-12,
                                         dtype=torch.float32,
                                         device=p.device))
            out.append(q8)
        return unflatten(treedef, out)

    return AdamWState(state.step, fix(state.m), fix(state.v))


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


def _has_attention(cfg: ModelConfig) -> bool:
    """Whether any block of the config attends (every kind but xLSTM's)."""
    plans = cfg.plan() + (cfg.enc_plan() if cfg.is_encdec else [])
    return any(spec.kind in ("attn", "enc", "dec", "hymba")
               for seg in plans for spec, _ in seg.pattern)


def check_mesh(cfg: ModelConfig, mesh, batch: Optional[int] = None,
               microbatch: int = 1) -> None:
    """Raise ``ValueError``, naming the config and the mesh, for what the
    port's sharded steps do not run: a global ``batch`` that
    ``microbatch`` slices do not split (``_check_microbatches``), and with
    ``cfg.use_pallas`` a local attention shape no kernel takes (the self
    attention's, and the cross attention's, whose heads are cut alike).
    A batch that does not divide over the batch axes runs, in padded
    shards (``_local_rows``), as the reference's GSPMD runs it.  Shape
    logic only: ``mesh`` is any mesh-like object (every rank's local
    attention shapes are alike)."""
    sizes = shd.mesh_axis_sizes(mesh)
    where = f"{cfg.name} on mesh {sizes}"
    m = sizes.get("model", 1)
    if batch is not None:
        _check_microbatches(batch, microbatch, f"{where}: ")
    if cfg.use_pallas and _has_attention(cfg):
        from repro_torch.kernels.attention_shapes import check_attention_shape
        from repro_torch.models.attention import local_kv_heads

        h, hkv = cfg.n_heads, cfg.n_kv_heads
        h_l = h // m if h % m == 0 else h
        if hkv % m == 0:
            kv_l = hkv // m
        elif h_l < h:
            k0, k1 = local_kv_heads(cfg, 0, h_l)
            kv_l = k1 - k0
        else:
            kv_l = hkv
        try:
            check_attention_shape(torch_dtype(cfg.dtype), cfg.d_head,
                                  h_l // kv_l)
        except ValueError as e:
            raise ValueError(f"{where}: local attention of {h_l} query "
                             f"heads over {kv_l} KV heads: {e}") from None


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def _check_microbatches(batch: int, k: int, where: str = "") -> None:
    """Raise ``ValueError`` (its message after ``where``) where ``k``
    microbatches do not split a global batch of ``batch`` rows.  The
    reference's ``slice_mb`` takes ``batch // k`` rows a microbatch and
    drops the rest (ROADMAP §C, reference fault 8); the port refuses
    instead."""
    if batch % k:
        raise ValueError(f"{where}a global batch of {batch} does not split "
                         f"into {k} microbatches")


def _local_rows(x: torch.Tensor, k: int, n: int, r: int) -> torch.Tensor:
    """Rank ``r`` of ``n``'s rows of a global batch split into ``k``
    microbatches of ``b`` rows: of each, rows ``[r c, min((r + 1) c, b))``
    with ``c = ceil(b / n)``, GSPMD's padded shard without the pads, so a
    rank may hold fewer rows than another, or none.  Its shares follow
    each other microbatch by microbatch, so its i-th local microbatch is
    its share of the global i-th; all are of one size."""
    b = x.shape[0] // k
    c = -(-b // n)
    lo, hi = min(r * c, b), min((r + 1) * c, b)
    return x.reshape(k, b, *x.shape[1:])[:, lo:hi].reshape(
        k * (hi - lo), *x.shape[1:])


def make_compressed_grad_fn(cfg: ModelConfig, mesh):
    """``xpod_mean(grads, ef) -> (mean, new_ef)``: the gradients' mean over
    the ``pod`` axis in int8 with error feedback.  Only built when the
    mesh has a ``pod`` axis, as the reference asserts."""
    if mesh is None or "pod" not in shd.mesh_axis_sizes(mesh):
        raise ValueError(f"{cfg.name}: compressed gradients need a mesh "
                         f"with a 'pod' axis, not "
                         f"{None if mesh is None else shd.mesh_axis_sizes(mesh)}")
    group = parallel.context(mesh).group("pod")

    def xpod_mean(grads, ef):
        return collectives.compressed_psum(grads, ef, group)

    return xpod_mean


def make_train_step(cfg: ModelConfig, mesh=None,
                    plan: Optional[TrainPlan] = None,
                    acfg: Optional[AdamWConfig] = None,
                    rules: shd.ShardingRules = shd.DEFAULT_RULES,
                    shape: Optional[ShapeConfig] = None, device=None):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``batch`` holds tokens and labels (B, S) and, where the
    config takes them, positions (B, S) or (B, S, 3), vision_embeds (B,
    P, d) and frames (B, T_enc, d) (numpy arrays or tensors); the global
    batch splits into ``plan.microbatch`` equal slices of every key, as
    the reference's ``slice_mb`` maps over every leaf (a B they do not
    divide raises ``ValueError``, where the reference drops rows).
    ``metrics``: loss (and xent, aux without microbatches), grad_norm and
    lr, as 0-d tensors on the device.

    ``mesh=None`` (or a shape-only mesh of one device) is one device:
    ``device``, CUDA unless the caller asks for the CPU.  A ``DeviceMesh``
    runs on its device; ``params`` and ``opt_state`` are then this rank's
    shards (``parallel.shard_tree`` by ``step.shardings["params"]``,
    ``init_opt_state``), ``batch`` the global batch, of which the step
    takes this rank's rows of each microbatch (``_local_rows``: where they
    do not divide over the batch axes some ranks hold fewer, or none, and
    run every microbatch's forward and backward, and so every collective,
    on what they hold).  ``step.shardings`` holds the params, opt
    and batch specs (the reference's), and ``"state"``, the (params,
    opt_state) specs of the layout the step holds (``held_pspecs``: a
    checkpoint of a sharded state is saved and restored by them);
    ``step.grads(params, batch)`` the reduced gradient
    shards (with ``with_metrics=True``, (metrics, grads)) and
    ``step.update(params, opt_state, grads)`` the AdamW half, so a check
    can hold the gradients of the very step it takes;
    ``step.error_feedback()`` the int8 residuals the step carries with
    ``compress_grads``."""
    plan = plan or TrainPlan()
    acfg = acfg or AdamWConfig(int8_moments=plan.int8_moments)
    ctx = parallel.context(mesh, rules, act_sharding=cfg.act_sharding)
    if ctx is None:
        dev = resolve_device(device)
    else:
        dev = ctx.device
        parallel.check_device(device, dev)
        check_mesh(cfg, ctx, shape.global_batch if shape else None,
                   max(plan.microbatch, 1))
    accum_dt = torch_dtype(plan.accum_dtype)
    leaves = _leaves(cfg, ctx, rules) if ctx is not None else None
    xpod = (make_compressed_grad_fn(cfg, ctx)
            if plan.compress_grads else None)
    carried = {"ef": None}

    def grads_of(params, mb, rows: int):
        """Loss, metrics and gradients of one (micro)batch of ``rows``
        global rows, of which ``mb`` holds this rank's.  A rank that holds
        none gets a zero gradient for a leaf its graph does not reach;
        on any other a leaf cut out of the graph raises."""
        leaves_, treedef = flatten(params)
        run_ctx = None if ctx is None else ctx.with_rows(rows)
        empty = next(iter(mb.values())).shape[0] == 0
        with torch.enable_grad(), parallel.use_mesh(run_ctx):
            live = [p.detach().requires_grad_(True) for p in leaves_]
            loss, metrics = transformer.loss_fn(unflatten(treedef, live),
                                                cfg, mb)
            grads = torch.autograd.grad(loss, live, allow_unused=empty,
                                        materialize_grads=empty)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, unflatten(treedef, list(grads))

    def reduce(grads, carry: bool = True):
        """Each leaf's gradient summed over the batch axes its spec does
        not cut; over ``pod`` in int8 with ``compress_grads``, the error
        feedback kept for the next step when ``carry``."""
        flat, treedef = flatten(grads)
        out, pod = [], []
        for g, leaf in zip(flat, leaves):
            axes = leaf.reduce_axes
            if xpod is not None and "pod" in axes:
                axes = tuple(a for a in axes if a != "pod")
                pod.append(len(out))
            out.append(parallel.all_reduce(g, ctx.group(axes)))
        if pod:
            n = ctx.size("pod")
            mean, ef = xpod([out[i] for i in pod], carried["ef"])
            if carry:
                carried["ef"] = ef
            for i, g in zip(pod, mean):
                out[i] = g * n
        return unflatten(treedef, out)

    def norm_sq(flat_g):
        total = sum(_sq_sum(g) if leaf.owner else
                    torch.zeros((), dtype=torch.float32, device=g.device)
                    for g, leaf in zip(flat_g, leaves))
        return parallel.all_reduce(total, torch.distributed.group.WORLD)

    def local(batch):
        """This rank's rows of the global ``batch`` and the global rows of
        each of its ``plan.microbatch`` slices, checked on the global
        batch before any split (the same error on every rank)."""
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        k = max(plan.microbatch, 1)
        gb = next(iter(batch.values())).shape[0]
        _check_microbatches(gb, k)
        if ctx is not None and ctx.batch_world > 1:
            batch = {n: _local_rows(x, k, ctx.batch_world, ctx.batch_rank)
                     for n, x in batch.items()}
        return batch, gb // k

    def accumulate(params, batch, rows: int):
        k = plan.microbatch
        if k <= 1:
            return grads_of(params, batch, rows)
        b = next(iter(batch.values())).shape[0] // k
        acc = None
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(k):
            mb = {n: x[i * b:(i + 1) * b] for n, x in batch.items()}
            mb_loss, _, grads = grads_of(params, mb, rows)
            g_leaves, treedef = flatten(grads)
            if acc is None:
                acc = [torch.zeros(g.shape, dtype=accum_dt, device=dev)
                       for g in g_leaves]
            acc = [a + g.to(accum_dt) / k for a, g in zip(acc, g_leaves)]
            loss = loss + mb_loss / k
        return loss, {"loss": loss}, unflatten(treedef, acc)

    def update(params, opt_state, grads, metrics=None):
        """AdamW on gradients already reduced (``step.grads``)."""
        if ctx is None:
            params, opt_state, opt_metrics = adamw_update(
                grads, opt_state, params, acfg)
        else:
            params, opt_state, opt_metrics = adamw_update(
                grads, opt_state, params, acfg, norm_sq,
                [leaf.quant for leaf in leaves])
        return params, opt_state, {**(metrics or {}), **opt_metrics}

    def grads(params, batch, with_metrics: bool = False, carry: bool = False):
        _, metrics, g = accumulate(params, *local(batch))
        g = g if ctx is None else reduce(g, carry)
        return (metrics, g) if with_metrics else g

    def step(params, opt_state, batch):
        metrics, g = grads(params, batch, with_metrics=True, carry=True)
        return update(params, opt_state, g, metrics)

    bsz = shape.global_batch if shape is not None else None
    spec_mesh = mesh if mesh is not None else _one_device()
    step.shardings = {
        "params": shd.param_pspecs(cfg, spec_mesh, rules),
        "opt": opt_pspecs(cfg, spec_mesh, acfg, rules),
        "state": held_pspecs(cfg, spec_mesh, acfg, rules),
        "batch": shd.batch_pspec(spec_mesh, rules, batch_size=bsz)}
    step.grads = grads
    step.update = update
    step.error_feedback = lambda: carried["ef"]
    step.ctx = ctx
    return step


def _one_device():
    """The (1, 1) data x model mesh, shape only: one device's specs."""
    from repro_torch.launch.mesh import ShapeMesh

    return ShapeMesh(("data", "model"), (1, 1))
