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
restores in the other.  ``restore`` places leaves on a device, never on
shardings (multi-GPU is ROADMAP A6).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

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


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: Any, meta: Optional[dict] = None,
             blocking: bool = True) -> None:
        """``tree`` may hold tensors (copied to the host here) or numpy."""
        self.wait()                           # one async save at a time
        leaves, treedef = flatten(tree)
        dtypes = []
        payload = {}
        for i, x in enumerate(leaves):
            a, name = _to_host(x)
            dtypes.append(name)
            payload[f"leaf_{i}"] = a
        meta = dict(meta or {})
        meta["step"] = step
        meta["treedef"] = str(treedef)
        meta["n_leaves"] = len(leaves)
        meta["dtypes"] = dtypes

        if blocking:
            self._write(step, payload, meta)
        else:
            t = threading.Thread(target=self._write_guarded,
                                 args=(step, payload, meta), daemon=True)
            self._thread = t
            t.start()

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
        np.savez(tmp / "arrays.npz", **payload)
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
        if self._thread is not None:
            self._thread.join()
            self._thread = None
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
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, like: Any,
                device=None) -> tuple[Any, dict]:
        """Restore into the structure of ``like`` (a tree of tensors or
        numpy arrays), each leaf cast to its ``like`` leaf's dtype.  A
        tensor leaf lands on ``device``, by default its ``like`` leaf's;
        a numpy leaf stays numpy.  Raises ``ValueError`` when the leaf
        counts differ."""
        path = self.dir / f"step_{step}"
        if not (path / "_COMPLETE").exists():
            raise FileNotFoundError(f"incomplete checkpoint: {path}")
        with np.load(path / "arrays.npz") as z:
            leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
        meta = json.loads((path / "meta.json").read_text())
        saved = meta.get("dtypes") or [str(a.dtype) for a in leaves]
        ref, treedef = flatten(like)
        if len(ref) != len(leaves):
            raise ValueError(f"leaf count mismatch: ckpt {len(leaves)} vs "
                             f"{len(ref)}")
        out = []
        for a, name, r in zip(leaves, saved, ref):
            bits = a.dtype.kind == "u" and not hasattr(np, name)
            if isinstance(r, torch.Tensor):
                t = _from_bits(a, name) if bits else torch.from_numpy(a)
                out.append(t.to(device=r.device if device is None
                                else device, dtype=r.dtype))
            else:
                if bits:
                    a = _from_bits(a, name).float().numpy()
                dt = getattr(r, "dtype", None)
                out.append(a.astype(dt) if dt is not None else a)
        return unflatten(treedef, out), meta

    def restore_latest(self, like: Any, device=None):
        step = self.latest_step()
        if step is None:
            return None
        tree, meta = self.restore(step, like, device)
        return step, tree, meta
