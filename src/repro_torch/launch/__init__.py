"""Launch layer of the port: device meshes (``mesh``), the abstract
inputs of each cell (``specs``), the serve and prefill steps
(``serve``), the train step on one device or a mesh (``train``) and the
meta-device dry run (``dryrun``).

Exports resolve on first use, as ``repro_torch.distributed``'s do."""
from __future__ import annotations

import importlib

_EXPORTS = {
    "ShapeMesh": "mesh", "make_mesh": "mesh",
    "make_production_mesh": "mesh", "mesh_chips": "mesh",
    "decode_context": "specs", "input_pspecs": "specs",
    "input_specs": "specs",
    "make_prefill_step": "serve", "make_serve_step": "serve",
    "TrainPlan": "train", "abstract_state": "train",
    "default_plan": "train", "init_opt_state": "train",
    "make_compressed_grad_fn": "train", "make_train_step": "train",
    "opt_pspecs": "train",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(
        f"{__name__}.{_EXPORTS[name]}"), name)
