"""A serving step captured once as a CUDA graph and replayed with new
inputs: the port's counterpart of ``jax.jit`` with donated buffers.

The reference compiles each step once (fixed shapes, traced block
tables and scalars) and replays the executable.  Here a ``StepGraph``
holds the step's static input buffers, allocated once, and its body (a
function of those buffers that returns one tensor).  ``run`` copies the
host inputs into the buffers through pinned staging memory with
``non_blocking=True`` and then, on the card, replays the graph; on the
CPU (or with graphs off) it calls the body on the buffers.

Capture follows ``torch.cuda.graphs``: eager warm-up runs on a side
stream first (they do the one-time work a capture must not see:
building and loading a kernel library, reading the SM count, fetching
the CUDA driver's ``cuTensorMapEncodeTiled``, ``cudaFuncSetAttribute``),
under ``torch.cuda.set_sync_debug_mode("error")``, so a host sync in the
body fails there by name instead of breaking the capture.  A warm-up run
really executes the step, so the cache tensors the step updates from
their own values (``restore``: each slot's ``pos``, the recurrent
layers' states) are put back after each; every other write of a step (the KV of
its tokens at their positions, ``pos`` of a prefilled slot) is the same
on every run.  A capture or replay that fails raises: nothing falls back
to an eager step on the card.

The body's Python side effects run at capture only, so the kernel
wrappers' ``launches`` counters would stop counting.  The capture
records each wrapper's count delta (and takes it back: nothing launched)
and each replay adds it, so ``fn.launches`` still counts launches.  A
random generator the body draws from is registered with the graph
(``CUDAGraph.register_generator_state``), so each replay advances it.
"""
from __future__ import annotations

import gc
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import kernels

# the kernel wrappers whose launch counts replays keep exact
WRAPPERS = (kernels.paged_decode_attention, kernels.decode_attention,
            kernels.grouped_matmul, kernels.flash_attention,
            kernels.ssm_scan, kernels.paged_flash_attention)
# eager runs of a step before its capture
WARMUP_RUNS = 2


class StepGraph:
    """One step's static buffers and body, replayed as a CUDA graph when
    ``graphed``.

    ``specs`` maps each input name to its (shape, dtype); the buffers are
    allocated once on ``device`` and keep their addresses for the life of
    the object.  ``body(**buffers)`` returns the step's one output, which
    the next run overwrites under a graph: copy it out first.  ``runs``
    counts executions of the body (warm-up runs included), ``captures``
    the programs made: graph captures, or without a graph the one
    preparation of the static buffers."""

    def __init__(self, body: Callable[..., torch.Tensor],
                 specs: dict[str, tuple[tuple[int, ...], torch.dtype]],
                 device: torch.device, *, graphed: bool,
                 restore: Sequence[torch.Tensor] = (),
                 generator: Optional[torch.Generator] = None):
        if graphed and device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {device}")
        self.body = body
        self.device = device
        self.graphed = graphed
        self.static = {k: torch.zeros(shape, dtype=dtype, device=device)
                       for k, (shape, dtype) in specs.items()}
        # the host side of each copy: pinned for a CUDA device, so the
        # copy is asynchronous; the buffer itself on the CPU
        self._stage = {k: (torch.zeros(t.shape, dtype=t.dtype,
                                       pin_memory=True)
                           if device.type == "cuda" else t)
                       for k, t in self.static.items()}
        self._copied = (torch.cuda.Event() if device.type == "cuda"
                        else None)
        self._restore = list(restore)
        self._generator = generator
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._out: Optional[torch.Tensor] = None
        self._launches: list[int] = []
        self.runs = 0
        self.captures = 0

    def _load(self, arrays: dict) -> None:
        if arrays.keys() != self.static.keys():
            raise ValueError(f"step inputs {sorted(arrays)} are not "
                             f"{sorted(self.static)}")
        if self._copied is not None:
            self._copied.synchronize()      # the last copies left staging
        for k, a in arrays.items():
            np.copyto(self._stage[k].numpy(), a)
            if self._stage[k] is not self.static[k]:
                self.static[k].copy_(self._stage[k], non_blocking=True)
        if self._copied is not None:
            self._copied.record()

    def run(self, **arrays) -> torch.Tensor:
        """Load ``arrays`` (numpy arrays or scalars, one per spec) into the
        static buffers and run the step once."""
        self._load(arrays)
        if not self.graphed:
            self.captures = max(self.captures, 1)
            self.runs += 1
            return self.body(**self.static)
        if self._graph is None:
            self._capture()
        self._graph.replay()
        self.runs += 1
        for fn, n in zip(WRAPPERS, self._launches):
            fn.launches += n
        return self._out

    def _capture(self) -> None:
        current = torch.cuda.current_stream(self.device)
        saved = [t.clone() for t in self._restore]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.stream(side):
                for _ in range(WARMUP_RUNS):
                    self.body(**self.static)
                    self.runs += 1
                    for t, s in zip(self._restore, saved):
                        t.copy_(s)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        current.wait_stream(side)
        del saved
        graph = torch.cuda.CUDAGraph()
        if self._generator is not None:
            graph.register_generator_state(self._generator)
        before = [fn.launches for fn in WRAPPERS]
        # a dead engine's graph freed by the cyclic collector during the
        # capture would invalidate it (no graph may be destroyed while a
        # stream captures): collect first, and not again until the end
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                out = self.body(**self.static)
        finally:
            if collecting:
                gc.enable()
            after = [fn.launches for fn in WRAPPERS]
            for fn, n in zip(WRAPPERS, before):
                fn.launches = n             # a capture launches nothing
        self._launches = [a - b for a, b in zip(after, before)]
        self._graph, self._out = graph, out
        self.captures += 1

    def close(self) -> None:
        """Free the graph and its memory pool (the buffers stay)."""
        self._out = None
        if self._graph is not None:
            self._graph.reset()
            self._graph = None
