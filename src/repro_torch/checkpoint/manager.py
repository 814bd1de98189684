"""Atomic, keep-K, optionally-async checkpointing (port of
``repro/checkpoint/manager.py``).

Layout:  <dir>/step_<n>/  arrays.npz  +  meta.json  +  _COMPLETE
Atomicity: write into ``<dir>/.tmp_<n>``, fsync, then ``os.rename`` --
a crashed writer never leaves a half checkpoint that restore could pick
up (restore only considers directories with the ``_COMPLETE`` marker).

``save(..., blocking=False)`` copies the tree to host memory first and
hands the copy to a writer thread, so the train loop overlaps
checkpoint I/O with compute (and may update the saved tensors in place
meanwhile).

The files are the reference's, leaf for leaf: leaves flatten in
``jax.tree.flatten``'s order (dict keys sorted, lists in order,
NamedTuples such as ``AdamWState`` and ``Q8`` in field order), a dtype
numpy lacks (bf16) is stored as unsigned bits of its width with its name
in ``meta.json``'s ``dtypes``, so a checkpoint written by either package
restores in the other.

A sharded state.  ``shardings`` is the port's form of the reference's
pytree of ``NamedSharding``s: a pair ``(specs, mesh)``, a PartitionSpec
tree matching the state's and a ``DeviceMesh`` (``launch.mesh.make_mesh``,
spanning the process group's world) or ``MeshContext``.  The ranks share
one filesystem, as the reference's ``restore`` assumes.

* ``save`` with shardings is collective (every rank calls it): the
  ranks gather the tree one leaf at a time (``parallel.gather_leaf``,
  on the shards' device), rank 0 copying each whole leaf to host memory
  before the next is gathered, so no rank holds more than one whole leaf
  beside its shards; rank 0 writes the files, whole leaves as the
  reference's ``device_get`` writes them.  In a world of more than one rank ``save``
  without shardings raises: every rank would write its own shards to
  the same files.
* ``restore`` with shardings: every rank maps the whole leaves of the
  file, casts each to its ``like`` leaf's dtype and keeps its shard
  (``parallel.shard_leaf``) on the mesh's device; ``like`` holds this
  rank's shards, and a cut that does not give a ``like`` leaf's shape
  raises, as does a dim that does not divide over its axes (elastic
  restarts onto another mesh work as long as dims stay divisible, as in
  the reference).
* The ranks agree on the step: under shardings ``wait`` joins the writer
  and then barriers the world, so no rank reads a step before rank 0's
  rename is done, and ``latest_step`` / ``restore_latest`` take rank 0's
  step, so no two ranks resume from different steps.

``CheckpointManager(directory, keep, shardings)`` holds a default that
``save``, ``restore`` and ``restore_latest`` use when given none, so the
supervisor (``runtime.supervisor``, the reference's, unchanged) saves
and resumes a sharded ``(params, opt_state)`` given a manager built with
a sharded train step's ``step.shardings["state"]`` and its mesh.  The
error feedback of ``TrainPlan.compress_grads`` lives in the step, not in
its state, and is not checkpointed.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import threading
import zipfile
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from numpy.lib import format as npy

from repro_torch.distributed import parallel
from repro_torch.models.params import flatten, unflatten


def _to_host(x) -> tuple[np.ndarray, str]:
    """A host copy of a leaf as numpy, and its dtype's name; a torch dtype
    numpy lacks comes back as the unsigned integers of its bits."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16 or \
                t.dtype.is_floating_point and t.element_size() == 1:
            a = t.view({1: torch.int8, 2: torch.int16}[t.element_size()])
            return a.numpy().view({1: np.uint8, 2: np.uint16}[
                t.element_size()]), name
        return t.numpy(), name
    a = np.array(x, copy=True)
    return a, str(a.dtype)


def _from_bits(a: np.ndarray, name: str) -> torch.Tensor:
    """The tensor of dtype ``name`` (bf16, float8) whose bits ``a``
    holds."""
    dt = getattr(torch, name)
    signed = {1: np.int8, 2: np.int16}[a.itemsize]
    return torch.from_numpy(np.ascontiguousarray(a).view(signed)).view(dt)


class _Arrays:
    """The members of an ``.npz`` file by name.  ``np.savez`` stores
    them uncompressed, so each is a copy-on-write memory map of the file:
    a rank reads the pages of the shard it keeps, once, with no CRC pass
    (``np.load`` reads every byte through ``zipfile``).  A compressed
    member, or a ``.npy`` header of an unknown version, is read whole."""

    def __init__(self, path: Path):
        self.path = path
        self._zip = zipfile.ZipFile(path)
        self.files = [n[:-len(".npy")] for n in self._zip.namelist()
                      if n.endswith(".npy")]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._zip.close()

    def __getitem__(self, key: str) -> np.ndarray:
        info = self._zip.getinfo(f"{key}.npy")
        if info.compress_type == zipfile.ZIP_STORED:
            with open(self.path, "rb") as f:
                f.seek(info.header_offset)
                name, extra = struct.unpack("<HH", f.read(30)[26:30])
                f.seek(info.header_offset + 30 + name + extra)
                version = npy.read_magic(f)
                read = {(1, 0): npy.read_array_header_1_0,
                        (2, 0): npy.read_array_header_2_0}.get(version)
                if read is not None:
                    shape, fortran, dtype = read(f)
                    offset = f.tell()
            if read is not None and not dtype.hasobject:
                if not np.prod(shape, dtype=np.int64):
                    return np.zeros(shape, dtype)
                return np.memmap(self.path, dtype=dtype, mode="c",
                                 offset=offset, shape=shape,
                                 order="F" if fortran else "C")
        with self._zip.open(info) as f:
            return npy.read_array(f)


def _savez(path: Path, payload: dict) -> None:
    """``np.savez``'s file (uncompressed ``.npy`` members in a zip64
    archive), each member's bytes written straight from its array, where
    ``np.savez`` copies them through 16 MiB ``tobytes`` chunks."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as z:
        for key, a in payload.items():
            a = a if a.flags.c_contiguous else a.copy(order="C")
            with z.open(f"{key}.npy", "w", force_zip64=True) as f:
                npy.write_array_header_1_0(
                    f, npy.header_data_from_array_1_0(a))
                f.write(memoryview(a.reshape(-1)).cast("B"))


def _world() -> int:
    return dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1


def _rank() -> int:
    return dist.get_rank() if _world() > 1 else 0


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3,
                 shardings: Optional[tuple] = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.shardings = self._resolve(shardings)
        # whether the ranks save and resume together (a sharded save or a
        # default): ``wait`` then barriers and ``latest_step`` agrees
        self._collective = self.shardings is not None

    @staticmethod
    def _resolve(shardings):
        """(spec leaves, MeshContext) of a ``(specs, mesh)`` pair."""
        if shardings is None:
            return None
        from repro_torch.distributed.sharding import is_spec

        specs, mesh = shardings
        ctx = parallel.context(mesh)
        if ctx is None:
            raise ValueError("shardings need a DeviceMesh or MeshContext")
        return flatten(specs, is_leaf=is_spec)[0], ctx

    def _sharded(self, shardings):
        return self.shardings if shardings is None else \
            self._resolve(shardings)

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: Any, meta: Optional[dict] = None,
             blocking: bool = True, shardings: Optional[tuple] = None
             ) -> None:
        """``tree`` may hold tensors (copied to the host here) or numpy;
        with ``shardings`` (or the manager's default) this rank's shards,
        gathered here by every rank and written whole by rank 0."""
        sh = self._sharded(shardings)
        if sh is None and _world() > 1:
            raise ValueError(f"save of step {step} in a world of {_world()} "
                             f"ranks without shardings: every rank would "
                             f"write its own shards to the same files")
        self._collective |= sh is not None
        self.wait()                           # one async save at a time
        leaves, treedef = flatten(tree)
        if sh is not None and len(sh[0]) != len(leaves):
            raise ValueError(f"{len(sh[0])} specs for {len(leaves)} leaves")
        writer = sh is None or _rank() == 0
        dtypes = []
        payload = {}
        for i, x in enumerate(leaves):
            if sh is not None and isinstance(x, torch.Tensor):
                x = parallel.gather_leaf(x, sh[0][i], sh[1])
            if writer:
                a, name = _to_host(x)
                dtypes.append(name)
                payload[f"leaf_{i}"] = a
        if writer:
            meta = dict(meta or {})
            meta["step"] = step
            meta["treedef"] = str(treedef)
            meta["n_leaves"] = len(leaves)
            meta["dtypes"] = dtypes
            if blocking and sh is None:
                self._write(step, payload, meta)
            elif blocking:
                self._write_guarded(step, payload, meta)
            else:
                t = threading.Thread(target=self._write_guarded,
                                     args=(step, payload, meta), daemon=True)
                self._thread = t
                t.start()
        if blocking and sh is not None:
            self.wait()                       # the step is on disk for all

    def _write_guarded(self, step, payload, meta):
        try:
            self._write(step, payload, meta)
        except BaseException as e:          # surfaced on next wait()
            self._error = e

    def _write(self, step: int, payload: dict, meta: dict) -> None:
        tmp = self.dir / f".tmp_{step}"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        _savez(tmp / "arrays.npz", payload)
        (tmp / "meta.json").write_text(json.dumps(
            {k: v for k, v in meta.items()}, default=str))
        (tmp / "_COMPLETE").touch()
        with open(tmp / "_COMPLETE", "rb") as f:
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self) -> None:
        """Join the writer; under shardings then barrier the ranks, so
        every rank sees what rank 0 wrote."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._collective and _world() > 1:
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore -----------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "_COMPLETE").exists():
                try:
                    out.append(int(p.name.split("_", 1)[1]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        """The newest complete step; under shardings rank 0's, broadcast."""
        return self._latest(self._collective)

    def _latest(self, agree: bool) -> Optional[int]:
        s = self.steps()
        step = s[-1] if s else None
        if agree and _world() > 1:
            box = [step]
            dist.broadcast_object_list(box, src=0)
            step = box[0]
        return step

    def restore(self, step: int, like: Any, shardings: Optional[tuple] = None,
                device=None) -> tuple[Any, dict]:
        """Restore into the structure of ``like`` (a tree of tensors or
        numpy arrays), each leaf cast to its ``like`` leaf's dtype.
        Without shardings a tensor leaf lands on ``device``, by default
        its ``like`` leaf's, and a numpy leaf stays numpy.  With
        ``shardings`` (or the manager's default) ``like`` holds this
        rank's shards as tensors (meta tensors will do): each whole leaf
        is cut to this rank's shard on the mesh's device, and a cut whose
        shape is not the ``like`` leaf's raises ``ValueError``.  Raises
        ``ValueError`` when the leaf counts differ."""
        sh = self._sharded(shardings)
        path = self.dir / f"step_{step}"
        if not (path / "_COMPLETE").exists():
            raise FileNotFoundError(f"incomplete checkpoint: {path}")
        meta = json.loads((path / "meta.json").read_text())
        saved = meta.get("dtypes")
        ref, treedef = flatten(like)
        if sh is not None:
            parallel.check_device(device, sh[1].device)
            if len(sh[0]) != len(ref):
                raise ValueError(f"{len(sh[0])} specs for {len(ref)} leaves")
        out = []
        with _Arrays(path / "arrays.npz") as z:
            if len(ref) != len(z.files):
                raise ValueError(f"leaf count mismatch: ckpt {len(z.files)} "
                                 f"vs {len(ref)}")
            for i, r in enumerate(ref):
                a = z[f"leaf_{i}"]
                name = saved[i] if saved else str(a.dtype)
                bits = a.dtype.kind == "u" and not hasattr(np, name)
                if sh is None and not isinstance(r, torch.Tensor):
                    if bits:
                        a = _from_bits(a, name).float().numpy()
                    dt = getattr(r, "dtype", None)
                    out.append(a.astype(dt) if dt is not None
                               else np.array(a))
                    continue
                t = _from_bits(a, name) if bits else torch.from_numpy(a)
                if sh is None:
                    dev = r.device if device is None else device
                else:
                    t, dev = self._cut(i, t, r, sh), sh[1].device
                # a copy: a view would keep the file's pages mapped
                out.append(torch.empty(t.shape, dtype=r.dtype,
                                       device=dev).copy_(t))
        return unflatten(treedef, out), meta

    @staticmethod
    def _cut(i: int, t: torch.Tensor, r, sh) -> torch.Tensor:
        """This rank's shard (a view) of leaf ``i``, whole in ``t``."""
        specs, ctx = sh
        try:
            cut = parallel.shard_leaf(t, specs[i], ctx)
        except ValueError as e:
            raise ValueError(f"leaf {i} of shape {tuple(t.shape)}, spec "
                             f"{specs[i]}: {e}") from None
        if cut.shape != r.shape:
            raise ValueError(f"leaf {i}: the checkpoint's {tuple(t.shape)} "
                             f"cut by {specs[i]} is {tuple(cut.shape)}, not "
                             f"the like leaf's {tuple(r.shape)}")
        return cut

    def restore_latest(self, like: Any, shardings: Optional[tuple] = None,
                       device=None):
        step = self._latest(self._collective or shardings is not None)
        if step is None:
            return None
        tree, meta = self.restore(step, like, shardings, device)
        return step, tree, meta
