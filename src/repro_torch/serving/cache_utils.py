"""Slot-level cache surgery (port of ``repro/serving/cache_utils.py``):
extract and insert one sequence's decode state from and into the
engine's batched ring cache.

The batch axis differs per leaf (a ring is ``(layers, B, size, Hkv,
dh)``, ``kpos`` ``(layers, B, size)``, ``pos`` ``(B,)``, and repeated
segments add a leading dim), so it is found once per configuration by
diffing the shapes of batch-1 and batch-2 skeletons, built on the
``meta`` device so that nothing is allocated.

The batch-1 ring tree is also the exchange format of KV migration.
``ring_tree_from_numpy`` and ``ring_tree_to_numpy`` carry it across the
package boundary as numpy: the reference's tree
(``jax.device_get(engine.extract_state(req)["cache"])``, whose ring
leaves are namedtuples with fields ``k``, ``v``, ``kpos``; in a hymba
layer SSM states with fields ``h``, ``conv``; in an xLSTM stack an
mLSTM layer's matrix memory, a plain array, and an sLSTM layer's state
with fields ``c``, ``n``, ``h``) into the port's, and back.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import CrossKV, KVCache
from repro_torch.models.params import resolve_device
from repro_torch.models.ssm import SLSTMState, SSMState

_STATE_TYPES = (KVCache, SSMState, SLSTMState, CrossKV)


def _leaves(tree) -> list[torch.Tensor]:
    """Tensor leaves in a fixed walk order: lists in order, dict keys
    sorted, ring caches and recurrent states field by field."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, it):
    """``tree``'s structure with its leaves taken from ``it`` in the walk
    order of ``_leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, _STATE_TYPES):
        return type(tree)(*(_rebuild(v, it) for v in tree))
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, it) for v in tree]
    return next(it)


@functools.lru_cache(maxsize=32)
def batch_axes(cfg: ModelConfig, max_context: int) -> tuple[int, ...]:
    """The batch axis of every leaf of a ring cache, in walk order."""
    c1 = models.init_cache(cfg, 1, max_context, layout="ring", device="meta")
    c2 = models.init_cache(cfg, 2, max_context, layout="ring", device="meta")

    def axis(a, b):
        for i, (x, y) in enumerate(zip(a.shape, b.shape)):
            if x != y:
                return i
        raise ValueError(f"no batch axis: {tuple(a.shape)}")

    return tuple(axis(a, b) for a, b in zip(_leaves(c1), _leaves(c2)))


def cache_extract(cache, slot: int, axes: tuple[int, ...]):
    """Slot ``slot`` as a batch-1 cache tree (a copy)."""
    it = iter([leaf.narrow(ax, slot, 1).clone()
               for leaf, ax in zip(_leaves(cache), axes)])
    return _rebuild(cache, it)


def to_host(tree):
    """``tree`` with its leaves in host memory, the counterpart of the
    reference's ``jax.device_get``: each leaf on the card is copied into
    pinned memory with one asynchronous copy, and one synchronize ends
    them all, so the copy is complete on return.  A leaf already on the
    CPU is kept as it is."""
    out, dev = [], None
    for leaf in _leaves(tree):
        if leaf.device.type == "cpu":
            out.append(leaf)
            continue
        host = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
        out.append(host.copy_(leaf, non_blocking=True))
        dev = leaf.device
    if dev is not None:
        torch.cuda.current_stream(dev).synchronize()
    return _rebuild(tree, iter(out))


def cache_insert(cache, sub, slot: int, axes: tuple[int, ...]):
    """Write a batch-1 cache tree into slot ``slot`` of ``cache``, in
    place.  Returns ``cache``.  ``sub`` may lie in host memory: pinned
    leaves copy asynchronously on the current stream.  Raises
    ``ValueError`` when a leaf of ``sub`` does not fit, naming the ring
    sizes: a ring's slot axis follows its batch axis."""
    leaves, subs = _leaves(cache), _leaves(sub)
    if len(leaves) != len(subs):
        raise ValueError(f"cache trees differ: {len(leaves)} vs "
                         f"{len(subs)} leaves")
    for leaf, s, ax in zip(leaves, subs, axes):
        want = leaf.shape[:ax] + (1,) + leaf.shape[ax + 1:]
        if s.shape != want:
            sizes = (f" (ring size {s.shape[ax + 1]} vs {leaf.shape[ax + 1]})"
                     if leaf.ndim > ax + 1 else "")
            raise ValueError(f"a leaf of shape {tuple(s.shape)} does not fit "
                             f"slot {slot} of {tuple(leaf.shape)}{sizes}")
    for leaf, s, ax in zip(leaves, subs, axes):
        leaf.narrow(ax, slot, 1).copy_(s.to(leaf.dtype), non_blocking=True)
    return cache


def cache_nbytes(cache) -> int:
    return int(sum(leaf.numel() * leaf.element_size()
                   for leaf in _leaves(cache)))


# ---------------------------------------------------------------------------
# The exchange format across the package boundary, as numpy
# ---------------------------------------------------------------------------


def _from_numpy(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: torch can't wrap it
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def ring_tree_from_numpy(tree, device=None):
    """A batch-1 ring tree of numpy arrays (the reference's
    ``extract_state(req)["cache"]`` after ``jax.device_get``) as the
    port's tree on ``device``.  Any namedtuple with fields ``k``, ``v``,
    ``kpos`` becomes a ``KVCache``, any with fields ``h``, ``conv`` an
    ``SSMState``, any with fields ``c``, ``n``, ``h`` an ``SLSTMState``;
    bf16 stays bf16."""
    dev = resolve_device(device)

    def walk(node):
        for typ in _STATE_TYPES:
            if all(hasattr(node, f) for f in typ._fields):
                return typ(*(_from_numpy(getattr(node, f), dev)
                             for f in typ._fields))
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return _from_numpy(node, dev)

    return walk(tree)


def ring_tree_to_numpy(tree, kv_type=KVCache, ssm_type=SSMState,
                       slstm_type=SLSTMState):
    """The port's batch-1 ring tree as numpy arrays, each ring as
    ``kv_type(k=, v=, kpos=)``, each SSM state as ``ssm_type(h=,
    conv=)`` and each sLSTM state as ``slstm_type(c=, n=, h=)`` (pass
    the reference's types to hand the tree to its ``inject_state``).
    bf16 leaves come out as float32, which holds their values exactly."""
    out_type = {KVCache: kv_type, SSMState: ssm_type,
                SLSTMState: slstm_type, CrossKV: CrossKV}

    def walk(node):
        if isinstance(node, _STATE_TYPES):
            return out_type[type(node)](**{f: walk(getattr(node, f))
                                           for f in node._fields})
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        t = node.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return walk(tree)
