"""Sharding rules: logical parameter axes -> mesh axes (port of
``repro/distributed/sharding.py``).

The model zoo annotates every parameter with logical axes ("embed",
"heads", "kv_heads", "ff", "vocab", "experts": ``models/params.P``);
this module turns them into ``PartitionSpec``s for a mesh:

* **TP** -- heads / kv_heads / ff / vocab shard over ``model``;
* **FSDP** -- the embed dim shards over ``data`` (or ``pod`` x ``data``);
* **EP** -- expert tables shard their leading experts dim over ``model``;
* **DP** -- the batch dim of activations shards over ``data`` (and
  ``pod`` on the multi-pod mesh);
* **SP** -- long-context decode shards the KV-cache sequence dim.

Every assignment is divisibility-checked with the reference's fallbacks
(GQA with 8 KV heads on a 16-way model axis leaves the KV-head dims
replicated), and a mesh axis is used at most once per tensor.

The specs are pure shape logic: they take any mesh-like object with
``axis_names`` (or a ``DeviceMesh``'s ``mesh_dim_names``) and a
``shape`` (a dict of axis sizes, or a tuple in axis order), so the
production meshes of 256 and 512 devices need no devices at all.  The
port's ``PartitionSpec`` is a tuple of mesh-axis names, tuples of names
or ``None``, equal by value to the reference's.  The runtime that lays
tensors out by these specs is ``distributed/parallel.py``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.parallel import entry_axes
from repro_torch.models import params as prm
from repro_torch.models import transformer


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh-axis name, a tuple of names (joint
    sharding, outermost first) or ``None`` (replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


@dataclass(frozen=True)
class ShardingRules:
    """Priority-ordered (logical axis -> mesh-axis candidates)."""

    # candidates may be single mesh axes or tuples (joint sharding over
    # several axes: FSDP over pod x data on the multi-pod mesh)
    rules: tuple[tuple[str, tuple], ...] = (
        ("experts", ("model",)),
        ("heads", ("model",)),
        ("kv_heads", ("model",)),
        ("ff", ("model",)),
        ("vocab", ("model",)),
        ("embed", (("pod", "data"), "data")),
    )
    # activation batch axes, outermost first
    batch_axes: tuple[str, ...] = ("pod", "data")
    seq_axis: str = "model"          # sequence-parallel activations
    cache_seq_axis: str = "data"     # long-context KV sequence sharding

    def lookup(self, logical: str) -> tuple:
        for name, axes in self.rules:
            if name == logical:
                return axes
        return ()


DEFAULT_RULES = ShardingRules()


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a mesh-like object: the reference's meshes and
    ``FakeMesh`` (``devices``), a dict ``shape``, a ``DeviceMesh``
    (``mesh_dim_names`` and a shape tuple) or the port's ``ShapeMesh``."""
    names = getattr(mesh, "axis_names", None) or getattr(
        mesh, "mesh_dim_names", None)
    devices = getattr(mesh, "devices", None)
    if devices is not None and hasattr(devices, "shape"):
        return dict(zip(names, devices.shape))
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(names, tuple(shape)))


def axes_size(entry, sizes: dict[str, int]) -> int:
    """Devices a spec entry spans (1 for ``None``)."""
    return math.prod(sizes.get(a, 1) for a in entry_axes(entry))


def spec_for(axes: tuple[Optional[str], ...], shape: tuple[int, ...],
             mesh, rules: ShardingRules = DEFAULT_RULES) -> PartitionSpec:
    """PartitionSpec for one tensor: logical axes + divisibility + each
    mesh axis used at most once."""
    sizes = mesh_axis_sizes(mesh)
    used: set[str] = set()
    out: list = []
    for logical, dim in zip(axes, shape):
        chosen = None
        if logical is not None:
            for cand in rules.lookup(logical):
                group = cand if isinstance(cand, tuple) else (cand,)
                if any(ax not in sizes or ax in used for ax in group):
                    continue
                if dim % math.prod(sizes[ax] for ax in group) == 0:
                    chosen = cand
                    used.update(group)
                    break
        out.append(chosen)
    return PartitionSpec(*out)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def param_pspecs(cfg: ModelConfig, mesh, rules: ShardingRules = DEFAULT_RULES):
    """The params tree's PartitionSpecs, leaf for leaf of ``model_defs``."""
    return prm.tree_map(lambda p: spec_for(p.axes, p.shape, mesh, rules),
                        transformer.model_defs(cfg))


def placements(spec: PartitionSpec, mesh) -> list:
    """``spec`` as one DTensor placement per mesh dim: ``Shard(dim)`` where
    the mesh axis cuts tensor dim ``dim``, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh_axis_sizes(mesh))
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        for ax in entry_axes(entry):
            out[names.index(ax)] = Shard(dim)
    return out


def param_shardings(cfg: ModelConfig, mesh,
                    rules: ShardingRules = DEFAULT_RULES):
    """Each leaf's placements on ``mesh`` (a ``DeviceMesh`` or any
    mesh-like object), by ``param_pspecs``."""
    return prm.tree_map(lambda p: placements(
        spec_for(p.axes, p.shape, mesh, rules), mesh),
        transformer.model_defs(cfg))


# ---------------------------------------------------------------------------
# Activations / batch
# ---------------------------------------------------------------------------


def _entry(axes) -> object:
    axes = tuple(axes)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def batch_pspec(mesh, rules: ShardingRules = DEFAULT_RULES,
                batch_size: Optional[int] = None) -> PartitionSpec:
    """Leading-axis data-parallel spec: ('pod', 'data') when both exist,
    the outermost axes dropped until ``batch_size`` divides."""
    sizes = mesh_axis_sizes(mesh)
    axes = [a for a in rules.batch_axes if a in sizes]
    if batch_size is not None:
        while axes and batch_size % math.prod(sizes[a] for a in axes):
            axes.pop(0)
    return PartitionSpec(_entry(axes))


def maybe_constrain(x, spec: PartitionSpec):
    """The identity.  The reference pins a GSPMD layout here; the port's
    layout is explicit: each rank holds its shard, and the collectives of
    ``distributed/parallel.py`` sit where the shards meet (for the
    layer-boundary activations of ``activation_pspec``, the sequence
    cut of ``MeshContext.seq_parallel`` in ``models.transformer``), so
    there is nothing to constrain."""
    return x


def activation_pspec(mesh, seq: bool = True,
                     rules: ShardingRules = DEFAULT_RULES) -> PartitionSpec:
    """(B, S, D) layer-boundary activations: batch over the data axes and,
    Megatron-style sequence parallelism, S over the model axis.  What the
    port's train and prefill steps hold between blocks where the
    reference's ``_constrain_act`` cuts S (``cfg.act_sharding``, S > 1
    and a multiple of the model axis: ``MeshContext.seq_parallel``);
    ``seq=False`` is the block interior, S gathered."""
    sizes = mesh_axis_sizes(mesh)
    b_entry = _entry(a for a in rules.batch_axes if a in sizes)
    s_entry = rules.seq_axis if (seq and rules.seq_axis in sizes) else None
    return PartitionSpec(b_entry, s_entry, None)


# ---------------------------------------------------------------------------
# Decode cache
# ---------------------------------------------------------------------------


def _cache_batch_axes(cfg: ModelConfig, max_context: int, enc_len: int):
    """Locate the batch axis of every cache leaf by shape-diffing the
    port's ``init_cache`` on the meta device at batch 1 and 2."""
    c1 = transformer.init_cache(cfg, 1, max_context, device="meta",
                                enc_len=enc_len)
    c2 = transformer.init_cache(cfg, 2, max_context, device="meta",
                                enc_len=enc_len)
    l1, treedef = prm.flatten(c1)
    l2, _ = prm.flatten(c2)

    def axis(a, b):
        for i, (x, y) in enumerate(zip(a.shape, b.shape)):
            if x != y:
                return i
        raise ValueError(f"no batch axis in cache leaf {tuple(a.shape)}")

    return treedef, l1, [axis(a, b) for a, b in zip(l1, l2)]


def kv_entries(seq_len: int, heads: int, sizes: dict, used,
               rules: ShardingRules = DEFAULT_RULES,
               shard_seq: bool = False) -> tuple:
    """(sequence entry, head entry) of a ring or cross K/V leaf of
    ``seq_len`` slots and ``heads`` KV heads on a mesh of axis ``sizes``
    whose axes ``used`` already cut the batch: the rule of
    ``cache_pspecs``."""
    seq = head = None
    used = set(used)
    if shard_seq:
        cand = rules.cache_seq_axis
        if cand in sizes and cand not in used and seq_len % sizes[cand] == 0:
            seq = cand
            used.add(cand)
    if "model" in sizes and "model" not in used \
            and heads % sizes["model"] == 0:
        head = "model"
    elif "model" in sizes and "model" not in used and seq is None \
            and seq_len % sizes["model"] == 0:
        seq = "model"                         # seq-TP fallback for GQA
    return seq, head


def cache_batch_axes(batch: int, sizes: dict,
                     rules: ShardingRules = DEFAULT_RULES) -> tuple:
    """The mesh axes a cache's batch of ``batch`` rows is cut over: the
    batch axes, the outermost dropped until the batch divides."""
    b_mesh = tuple(a for a in rules.batch_axes if a in sizes)
    while b_mesh and batch % math.prod(sizes[a] for a in b_mesh):
        b_mesh = b_mesh[1:]
    return b_mesh


def cache_pspecs(cfg: ModelConfig, batch: int, max_context: int, mesh,
                 enc_len: int = 0, rules: ShardingRules = DEFAULT_RULES,
                 shard_seq: bool = False):
    """PartitionSpec tree for the decode cache.

    * batch over the data axes;
    * KV-head dim over ``model`` when divisible (TP);
    * otherwise the ring *sequence* dim over ``model`` (the GQA fallback
      of the reference: each rank holds a range of the ring's slots with
      every KV head, and the serve steps combine the ranks' partial
      softmaxes by their log-sum-exps);
    * ``shard_seq`` (long-context, batch 1): sequence over ``data`` too.
    ``kpos`` keeps its sequence axis whole.
    """
    sizes = mesh_axis_sizes(mesh)
    treedef, leaves, b_axes = _cache_batch_axes(cfg, max_context, enc_len)

    b_mesh = cache_batch_axes(batch, sizes, rules)
    b_entry = _entry(b_mesh)

    specs = []
    for leaf, b_ax in zip(leaves, b_axes):
        # ``leaves`` are the batch-1 skeleton, used for layout only
        entries: list = [None] * leaf.ndim
        used: set[str] = set()
        if b_entry is not None:
            entries[b_ax] = b_entry
            used.update(b_mesh)
        # ring KV leaves look like (..., B, S_ring, H_kv, d_head)
        is_kv = (leaf.ndim - b_ax) == 4 and leaf.shape[b_ax + 2] in (
            cfg.n_kv_heads, cfg.n_heads)
        if is_kv:
            s_ax, h_ax = b_ax + 1, b_ax + 2
            entries[s_ax], entries[h_ax] = kv_entries(
                leaf.shape[s_ax], leaf.shape[h_ax], sizes, used, rules,
                shard_seq)
        specs.append(PartitionSpec(*entries))
    return prm.unflatten(treedef, specs)
