"""Device meshes (port of ``repro/launch/mesh.py``).

``make_mesh`` wraps ``torch.distributed.device_mesh.init_device_mesh``
over a process group the caller has initialised (its address, world
size and rank given explicitly); ``make_production_mesh`` is the
reference's 16 x 16 (and 2 x 16 x 16) mesh as shape only, for the specs
and the dry run, which need no devices.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.distributed.sharding import mesh_axis_sizes


@dataclass(frozen=True)
class ShapeMesh:
    """A mesh's axis names and sizes, with no devices behind it."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    """16 x 16 = 256 devices a pod; x 2 pods = 512 devices multi-pod."""
    if multi_pod:
        return ShapeMesh(("pod", "data", "model"), (2, 16, 16))
    return ShapeMesh(("data", "model"), (16, 16))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the initialised default process
    group, whose world size must be the product of ``shape``.  Raises when
    no process group is initialised or CUDA is asked for and missing."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} vs axes {axes}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device_type='cpu' "
                           "for a CPU mesh")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"make_mesh({tuple(shape)}, {tuple(axes)}) needs an initialised "
            f"process group: call torch.distributed.init_process_group with "
            f"its address, world size and rank first")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh {tuple(shape)} needs {math.prod(shape)} "
                         f"ranks, the process group has "
                         f"{dist.get_world_size()}")
    if device_type == "cuda":
        # the device this process chose (two ranks may share one card)
        torch.cuda.set_device(torch.cuda.current_device())
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def mesh_chips(mesh) -> int:
    return math.prod(mesh_axis_sizes(mesh).values())
