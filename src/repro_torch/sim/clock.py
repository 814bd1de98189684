"""Virtual time: a deterministic discrete-event loop.

Every latency-bearing component (engines, network links, agents, the
controller's poll loop) schedules callbacks on one ``EventLoop``; the
benchmarks advance virtual time until quiescence.  This is what makes the
paper's load sweeps (Fig 3/6/7) reproducible on a CPU-only container —
the *costs* come from the roofline model, the *ordering* from here.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Callable


class Clock:
    def __init__(self) -> None:
        self._now = 0.0

    def now(self) -> float:
        return self._now

    def _advance(self, t: float) -> None:
        assert t >= self._now - 1e-12, (t, self._now)
        self._now = max(self._now, t)


@dataclass(order=True)
class _Event:
    time: float
    seq: int
    fn: Callable = field(compare=False)
    cancelled: bool = field(default=False, compare=False)


class EventLoop:
    """Single-threaded discrete-event scheduler over a virtual clock."""

    def __init__(self) -> None:
        self.clock = Clock()
        self._heap: list[_Event] = []
        self._seq = itertools.count()

    def now(self) -> float:
        return self.clock.now()

    def call_at(self, t: float, fn: Callable) -> _Event:
        ev = _Event(max(t, self.now()), next(self._seq), fn)
        heapq.heappush(self._heap, ev)
        return ev

    def call_after(self, dt: float, fn: Callable) -> _Event:
        return self.call_at(self.now() + dt, fn)

    def cancel(self, ev: _Event) -> None:
        ev.cancelled = True

    def run_until(self, t_end: float = float("inf"),
                  max_events: int = 10_000_000) -> None:
        n = 0
        while self._heap and n < max_events:
            ev = self._heap[0]
            if ev.time > t_end:
                break
            heapq.heappop(self._heap)
            if ev.cancelled:
                continue
            self.clock._advance(ev.time)
            ev.fn()
            n += 1
        if t_end != float("inf"):
            self.clock._advance(t_end)

    def idle(self) -> bool:
        return not self._heap
