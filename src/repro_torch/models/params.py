"""Parameter-definition trees (port of ``repro/models/params.py``).

Modules describe parameters as trees of ``P`` (shape + logical axes +
initializer), exactly as the reference does, so the port's parameter
tree has the reference's structure and shapes leaf for leaf.  Two ways
to fill it:

* ``init_params`` draws the port's own weights from a ``torch.Generator``
  with the reference's rule (fan-in scaled normal, ones for norms, f32
  where the def says so).  The numbers differ from ``jax.random``'s.
* ``load_tree`` copies a reference pytree (numpy arrays from
  ``jax.device_get(repro.models.init(cfg, key))``) into tensors, which
  is how the parity tests give both packages the same weights.

Trees are nested dicts and lists; a walk visits dict keys in sorted
order, as ``jax.tree`` flattening does.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch


@dataclass(frozen=True)
class P:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]
    init: str = "normal"            # normal | zeros | ones
    scale: float = 1.0              # stddev multiplier for 'normal'
    dtype: Optional[str] = None     # override model dtype (e.g. f32 norms)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


Tree = Any  # nested dict / list of P, tensors or arrays


def resolve_device(device) -> torch.device:
    """The port's device rule: ``None`` means CUDA, and a missing CUDA is
    an error unless the caller asked for the CPU explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch paths on the CPU")
    return dev


def tp(w: torch.Tensor, dim: int, full: int) -> Optional[int]:
    """The twin of the reference's ``prm.tp``, and the one place a model
    function asks for its local shard: None when ``w`` holds the whole of
    ``dim`` (no mesh, a model axis of one, a dim the rules replicate);
    else this rank's offset along ``dim``, its shard of the ``model``
    axis of the current mesh (``distributed.parallel.current``).  A
    weight cut with no mesh current raises."""
    n = w.shape[dim]
    if n == full:
        return None
    from repro_torch.distributed import parallel

    ctx = parallel.current()
    m = ctx.size("model") if ctx is not None else 1
    if ctx is None or n * m != full:
        raise RuntimeError(
            f"a weight of {n} of {full} along dim {dim} needs a mesh whose "
            f"model axis cuts it; current mesh: "
            f"{None if ctx is None else ctx.sizes}")
    return ctx.coord("model") * n


def torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Map ``fn`` over matching leaves of trees of dicts and lists."""
    if isinstance(tree, dict):
        for r in rest:
            if set(r) != set(tree):
                raise ValueError(f"tree keys differ: {sorted(tree)} vs "
                                 f"{sorted(r)}")
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        if any(len(r) != len(tree) for r in rest):
            raise ValueError("tree list lengths differ")
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def flatten(tree: Tree, is_leaf: Optional[Callable] = None):
    """(leaves, treedef) in ``jax.tree.flatten``'s order: dict keys
    sorted, lists and tuples in order, NamedTuples (``AdamWState``,
    ``Q8``, ``KVCache``) in field order, ``None`` an empty subtree.
    ``is_leaf(x)`` true stops the walk at ``x``."""
    leaves: list = []

    def walk(x):
        if is_leaf is not None and is_leaf(x):
            leaves.append(x)
            return ("leaf",)
        if x is None:
            return ("none",)
        if isinstance(x, dict):
            keys = sorted(x)
            return ("dict", tuple(keys), tuple(walk(x[k]) for k in keys))
        if isinstance(x, (list, tuple)):
            kind = type(x) if _is_namedtuple(x) else type(x).__name__
            return ("seq", kind, tuple(walk(v) for v in x))
        leaves.append(x)
        return ("leaf",)

    return leaves, walk(tree)


def unflatten(treedef, leaves) -> Tree:
    """The tree of ``treedef`` (from ``flatten``) over ``leaves``."""
    it = iter(leaves)

    def build(d):
        if d[0] == "leaf":
            return next(it)
        if d[0] == "none":
            return None
        if d[0] == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        kids = [build(c) for c in d[2]]
        if d[1] == "list":
            return kids
        if d[1] == "tuple":
            return tuple(kids)
        return d[1](*kids)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def stack(defs: Tree, *dims: int) -> Tree:
    """Prepend layer-stack dims (replicated axes) to every P in the tree."""
    return tree_map(lambda p: P(tuple(dims) + p.shape,
                                (None,) * len(dims) + p.axes,
                                p.init, p.scale, p.dtype), defs)


def _leaf_dtype(p: P, dtype: torch.dtype) -> torch.dtype:
    return torch_dtype(p.dtype) if p.dtype else dtype


# A leaf of more elements than this is drawn in slices along its leading
# dims, each slice at most this size, so the f32 temporary stays small:
# arctic-480b's stacked expert weights hold 8.9 G elements a leaf at two
# layers, a 35.7 GB f32 draw beside its 17.9 GB bf16 result.  The dense
# and hybrid models' leaves are all drawn whole (agent-7b's largest, its
# stacked MLP weights, holds 1.44 G).
MAX_DRAW = 2 ** 31


def _init_one(p: P, gen: torch.Generator, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    dt = _leaf_dtype(p, dtype)
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dt, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dt, device=device)
    # fan-in scaled normal on the last-but-one "input" dim heuristic
    fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
    std = p.scale / math.sqrt(max(fan_in, 1))
    # drawn in f32 on the generator's device, then moved and cast
    if math.prod(p.shape) <= MAX_DRAW:
        x = torch.randn(p.shape, generator=gen, dtype=torch.float32,
                        device=gen.device)
        return x.mul_(std).to(device=device, dtype=dt)
    lead = next(n for n in range(1, len(p.shape) + 1)
                if math.prod(p.shape[n:]) <= MAX_DRAW)
    out = torch.empty(p.shape, dtype=dt, device=device)
    for idx in itertools.product(*map(range, p.shape[:lead])):
        x = torch.randn(p.shape[lead:], generator=gen, dtype=torch.float32,
                        device=gen.device)
        out[idx] = x.mul_(std)
    return out


def init_params(defs: Tree, gen: torch.Generator, dtype: torch.dtype,
                device: torch.device) -> Tree:
    return tree_map(lambda p: _init_one(p, gen, dtype, device), defs)


def count_params(defs: Tree) -> int:
    return int(sum(np.prod(p.shape) for p in tree_leaves(defs)))


def _to_tensor(arr, p: P, dtype: Optional[torch.dtype],
               device: torch.device) -> torch.Tensor:
    a = np.asarray(arr)
    if tuple(a.shape) != tuple(p.shape):
        raise ValueError(f"reference leaf shape {a.shape} != def {p.shape}")
    bf16 = a.dtype.name == "bfloat16"       # ml_dtypes: torch can't wrap it
    t = torch.from_numpy(np.array(a.astype(np.float32) if bf16 else a))
    if dtype is None:
        dt = torch.bfloat16 if bf16 else t.dtype
    else:
        dt = _leaf_dtype(p, dtype)
    return t.to(device=device, dtype=dt)


def load_tree(defs: Tree, tree: Tree, dtype: Optional[torch.dtype],
              device: torch.device) -> Tree:
    """Copy a reference pytree of numpy arrays onto ``device``, checking
    every leaf's shape against its def.  ``dtype=None`` keeps each
    leaf's own dtype; otherwise leaves take ``dtype`` except those the
    defs pin to a dtype of their own (f32 norms)."""
    return tree_map(lambda p, a: _to_tensor(a, p, dtype, device), defs, tree)


def from_jax(cfg, tree: Tree, device=None, dtype=None) -> Tree:
    """The reference's parameter pytree for ``cfg`` (numpy arrays, e.g.
    ``jax.device_get(repro.models.init(cfg, key))``) as the port's
    parameters: the same tree and shapes, on ``device``.  ``dtype=None``
    keeps each leaf's dtype; a ``torch.dtype`` casts every leaf the defs
    do not pin to f32."""
    from repro_torch.models.transformer import model_defs

    return load_tree(model_defs(cfg), tree, dtype, resolve_device(device))


def _map_opt(x, leaf: Callable, state_type, q8_type):
    """An optimizer-state tree (an ``AdamWState`` of dicts and lists of
    f32 arrays or ``Q8``s, from either package) rebuilt in ``state_type``
    and ``q8_type`` with ``leaf`` applied to every array."""
    name = type(x).__name__
    if name == "AdamWState":
        return state_type(leaf(x.step), _map_opt(x.m, leaf, state_type,
                                                 q8_type),
                          _map_opt(x.v, leaf, state_type, q8_type))
    if name == "Q8":
        return q8_type(leaf(x.q), leaf(x.scale))
    if isinstance(x, dict):
        return {k: _map_opt(x[k], leaf, state_type, q8_type)
                for k in sorted(x)}
    if isinstance(x, list):
        return [_map_opt(v, leaf, state_type, q8_type) for v in x]
    return leaf(x)


def opt_state_from_jax(state, device=None):
    """The reference's optimizer state (``repro.optim.adamw.AdamWState``
    of numpy arrays, e.g. ``jax.device_get(adamw_init(params, cfg))``:
    f32 moments or ``Q8``) as the port's ``AdamWState`` on ``device``,
    every leaf with its own dtype: the counterpart of ``from_jax`` for
    the optimizer."""
    from repro_torch.optim.adamw import Q8, AdamWState

    dev = resolve_device(device)
    return _map_opt(state, lambda a: torch.from_numpy(np.array(a)).to(dev),
                    AdamWState, Q8)


def opt_state_to_numpy(state, state_type=None, q8_type=None):
    """The port's ``AdamWState`` as numpy arrays on the host, in the
    port's NamedTuples or in the given ``state_type`` and ``q8_type``
    (the reference's, for its ``adamw_update``)."""
    from repro_torch.optim.adamw import Q8, AdamWState

    return _map_opt(state, lambda t: t.detach().cpu().numpy(),
                    state_type or AdamWState, q8_type or Q8)
