"""Training-side fault tolerance: checkpoint/restart supervision.

``TrainSupervisor.run`` drives a step function and transparently
survives failures: on any exception from the step (a real crash, a
``SimulatedFailure`` injected by tests, a preemption signal) it restores
the latest checkpoint — params, optimizer state, *and* the data-pipeline
cursor — and resumes.  Combined with the deterministic TokenPipeline the
post-restart trajectory is bit-identical to an uninterrupted run (the
restart test asserts exactly this)."""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

from repro_torch.checkpoint.manager import CheckpointManager


class SimulatedFailure(RuntimeError):
    """Injected by tests/chaos hooks to exercise the restart path."""


@dataclass
class SupervisorConfig:
    ckpt_every: int = 50
    max_restarts: int = 10
    async_ckpt: bool = True


class TrainSupervisor:
    def __init__(self, manager: CheckpointManager,
                 cfg: Optional[SupervisorConfig] = None):
        self.mgr = manager
        self.cfg = cfg or SupervisorConfig()
        self.restarts = 0
        self.log: list[str] = []

    def run(self, *, state: Any, pipeline, step_fn: Callable,
            total_steps: int,
            on_step: Optional[Callable] = None) -> Any:
        """state: pytree (params, opt_state, ...) — anything the step
        consumes and returns.  step_fn(state, batch, step) -> state.
        """
        step = 0
        # resume if a checkpoint exists
        restored = self.mgr.restore_latest(state)
        if restored is not None:
            step, state, meta = restored
            pipeline.load_state({"step": meta.get("data_step", step),
                                 "seed": pipeline.cfg.seed})
            self.log.append(f"resumed from step {step}")

        it = iter(pipeline)
        while step < total_steps:
            try:
                batch = next(it)
                state = step_fn(state, batch, step)
                step += 1
                if on_step is not None:
                    on_step(step, state)
                if step % self.cfg.ckpt_every == 0 or step == total_steps:
                    self.mgr.save(step, state,
                                  meta={"data_step": pipeline.step},
                                  blocking=not self.cfg.async_ckpt)
            except (SimulatedFailure, RuntimeError) as e:
                if isinstance(e, RuntimeError) \
                        and not isinstance(e, SimulatedFailure) \
                        and "checkpoint" in str(e):
                    raise            # checkpoint corruption is fatal
                self.restarts += 1
                self.log.append(f"failure at step {step}: {e!r}")
                if self.restarts > self.cfg.max_restarts:
                    raise RuntimeError("restart budget exhausted") from e
                self.mgr.wait()
                restored = self.mgr.restore_latest(state)
                if restored is None:
                    step = 0         # no checkpoint yet: start over
                    pipeline.load_state({"step": 0,
                                         "seed": pipeline.cfg.seed})
                else:
                    step, state, meta = restored
                    pipeline.load_state({"step": meta.get("data_step",
                                                          step),
                                         "seed": pipeline.cfg.seed})
                it = iter(pipeline)
                self.log.append(f"restarted at step {step}")
        self.mgr.wait()
        return state
