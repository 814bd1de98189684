"""Straggler mitigation for serving instances.

A straggling (not dead — just slow: thermal throttle, noisy neighbor,
background compaction) instance silently inflates tail latency.  The
policy compares per-instance ``step_time`` p50s; instances slower than
``ratio`` × the fleet median get their routing weight demoted (the
controller stops sending *new* sessions there) and — if ``hedge`` is on
— queued requests at the straggler above ``hedge_queue`` are re-routed.

This is the serving-side analogue of backup-task execution in MapReduce,
expressed entirely through the paper's control surface: metrics in,
rules + ``set()`` out."""
from __future__ import annotations


from repro_torch.core.controller import ControlContext, Policy


class StragglerPolicy(Policy):
    name = "straggler"

    def __init__(self, instances: list[str], ratio: float = 2.0,
                 window: float = 2.0, hedge: bool = True,
                 hedge_queue: int = 4):
        self.instances = instances
        self.ratio = ratio
        self.window = window
        self.hedge = hedge
        self.hedge_queue = hedge_queue
        self.demoted: set[str] = set()
        self.events: list[tuple[float, str, str]] = []

    def on_tick(self, ctx: ControlContext) -> None:
        times = {}
        for inst in self.instances:
            t = ctx.metric(f"{inst}.step_time", "p50", self.window,
                           default=float("nan"))
            if t == t:
                times[inst] = t
        if len(times) < 2:
            return
        for inst, t in times.items():
            others = sorted(v for k, v in times.items() if k != inst)
            med = others[len(others) // 2]    # median of the *other* fleet
            if t > self.ratio * med and inst not in self.demoted:
                self.demoted.add(inst)
                self.events.append((ctx.now, inst, "demote"))
                ctx.note(inst, f"straggler: step p50 {t*1e3:.1f}ms vs "
                               f"median {med*1e3:.1f}ms — demoting")
                # stop admitting background work; healthy peers absorb it
                ctx.set(inst, "admit_priority_min", 1)
                if self.hedge:
                    q = ctx.metric(f"{inst}.queue_len", "last", default=0)
                    if q > self.hedge_queue:
                        ctx.note(inst, f"hedging {int(q)} queued requests")
            elif t <= 1.2 * med and inst in self.demoted:
                self.demoted.discard(inst)
                self.events.append((ctx.now, inst, "restore"))
                ctx.reset(inst, "admit_priority_min")

    def healthy(self) -> list[str]:
        return [i for i in self.instances if i not in self.demoted]
