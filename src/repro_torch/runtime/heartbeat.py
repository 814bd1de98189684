"""Failure detection: heartbeats from every serving instance.

Engines beat on every step (and on an idle timer); the monitor marks an
instance failed after ``miss_timeout`` of silence and notifies the
controller (a push event — failures can't wait for the next poll).  The
controller's FailoverPolicy then re-routes the failed instance's
sessions and re-queues its in-flight requests elsewhere; KV state that
lived only on the failed instance is lost, so the re-queued requests
re-prefill (correct, just slower — exactly what a real pod failure
costs)."""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.sim.clock import EventLoop


class HeartbeatMonitor:
    def __init__(self, loop: EventLoop, miss_timeout: float = 1.0,
                 check_interval: float = 0.25):
        self.loop = loop
        self.miss_timeout = miss_timeout
        self.check_interval = check_interval
        self.last_beat: dict[str, float] = {}
        self.failed: set[str] = set()
        self.on_failure: Optional[Callable[[str], None]] = None
        self.on_recovery: Optional[Callable[[str], None]] = None
        self._running = False

    def beat(self, name: str) -> None:
        self.last_beat[name] = self.loop.now()
        if name in self.failed:
            self.failed.discard(name)
            if self.on_recovery:
                self.on_recovery(name)

    def watch(self, name: str) -> None:
        self.last_beat.setdefault(name, self.loop.now())

    def unwatch(self, name: str) -> None:
        self.last_beat.pop(name, None)
        self.failed.discard(name)

    def start(self) -> None:
        if not self._running:
            self._running = True
            self.loop.call_after(self.check_interval, self._check)

    def stop(self) -> None:
        self._running = False

    def _check(self) -> None:
        if not self._running:
            return
        now = self.loop.now()
        for name, t in list(self.last_beat.items()):
            if name not in self.failed and now - t > self.miss_timeout:
                self.failed.add(name)
                if self.on_failure:
                    self.on_failure(name)
        self.loop.call_after(self.check_interval, self._check)


def attach_engine(monitor: HeartbeatMonitor, engine,
                  idle_ping: float = 0.5) -> None:
    """Wrap an engine's step bookkeeping to emit heartbeats, plus an
    idle-time liveness ping (an idle instance is healthy, a crashed one
    is not — ``engine.dead`` models the crash in tests/drills)."""
    monitor.watch(engine.name)
    orig = engine._step_metrics

    def beat_and_record(duration: float) -> None:
        monitor.beat(engine.name)
        orig(duration)

    engine._step_metrics = beat_and_record

    def ping():
        if engine.name not in monitor.last_beat:
            return                      # unwatched: stop pinging
        if not getattr(engine, "dead", False):
            monitor.beat(engine.name)
        monitor.loop.call_after(idle_ping, ping)

    monitor.loop.call_after(idle_ping, ping)
