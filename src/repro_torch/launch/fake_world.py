"""One rank of a fake world: the dry run's stand-in for a mesh of cards.

``fake_world(shape, axes, rank)`` initialises PyTorch's ``fake``
process-group backend for a world of ``prod(shape)`` ranks, as rank
``rank``, builds the ``DeviceMesh`` over it with the reference's axis
names, and yields a ``MeshContext`` whose device is meta.  The port's
unchanged sharded steps then run on that context: every tensor is a
meta tensor (shapes and dtypes, no memory, no data), and every
collective returns at once with its output as it was (the fake backend
moves nothing).  So a step's operations, its collectives and its
allocations are this rank's own, at the production mesh's shapes, on
one CPU process.  On exit the process group is destroyed and no mesh
context is left current.

Only the dry run (``launch.dryrun``) and its tests use it.  The backend's
store, ``FakeStore``, lives in ``torch.testing._internal``; it is
imported here alone.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

from repro_torch.distributed import parallel


def _fake_store():
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            f"the dry run's fake world needs torch.testing._internal."
            f"distributed.fake_pg.FakeStore, which torch {torch.__version__} "
            f"does not have: {e}") from e
    return FakeStore()


@contextlib.contextmanager
def fake_world(shape: tuple[int, ...], axes: tuple[str, ...], rank: int = 0):
    """Rank ``rank`` of a fake world of ``prod(shape)`` ranks: yields a
    ``MeshContext`` over the ``DeviceMesh`` of ``shape`` named ``axes``,
    its device meta.  Raises when a process group is initialised
    already (one process holds one default group)."""
    from torch.distributed.device_mesh import init_device_mesh

    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} vs axes {axes}")
    world = math.prod(shape)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} of a world of {world}")
    if dist.is_initialized():
        raise RuntimeError("a fake world needs a process without an "
                           "initialised process group")
    depth = len(parallel._ACTIVE)
    dist.init_process_group("fake", store=_fake_store(), rank=rank,
                            world_size=world)
    try:
        mesh = init_device_mesh("cpu", tuple(shape),
                                mesh_dim_names=tuple(axes))
        ctx = parallel.MeshContext(mesh)
        ctx.device = torch.device("meta")
        yield ctx
    finally:
        del parallel._ACTIVE[depth:]
        dist.destroy_process_group()
