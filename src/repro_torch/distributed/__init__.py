"""Distributed layer of the port: the sharding rules (``sharding``), the
int8 compressed all-reduce (``collectives``) and the runtime that lays
tensors out by the rules over ``torch.distributed`` (``parallel``).

Exports resolve on first use, so the model code can import
``repro_torch.distributed.parallel`` without pulling in ``sharding``
(which imports the model code)."""
from __future__ import annotations

import importlib

_EXPORTS = {
    "ShardingRules": "sharding", "DEFAULT_RULES": "sharding",
    "PartitionSpec": "sharding", "batch_pspec": "sharding",
    "cache_pspecs": "sharding", "maybe_constrain": "sharding",
    "param_pspecs": "sharding", "param_shardings": "sharding",
    "spec_for": "sharding", "activation_pspec": "sharding",
    "quantize_int8": "collectives", "compressed_psum": "collectives",
    "wire_bytes_saved": "collectives",
    "MeshContext": "parallel", "use_mesh": "parallel",
    "shard_tree": "parallel", "gather_tree": "parallel",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(
        f"{__name__}.{_EXPORTS[name]}"), name)
