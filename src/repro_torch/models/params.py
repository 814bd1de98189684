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
