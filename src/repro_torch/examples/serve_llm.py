"""Serve a model with batched requests through the full stack on a
``TorchEngine``: continuous-batching engine, metrics plane, controller
with an SLO intent, and the Table-1 set()/reset() surface.  The twin of
the JAX package's ``examples/serve_llm.py``, on the same tiny model.

    PYTHONPATH=src python -m repro_torch.examples.serve_llm               # on the GPU
    PYTHONPATH=src python -m repro_torch.examples.serve_llm --device cpu  # on the CPU
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.core import Controller, Registry, compile_intent
from repro_torch.core.controller import ControlContext
from repro_torch.core.metrics import CentralPoller, Collector, StateStore
from repro_torch.core.types import Priority, Request
from repro_torch.models.params import resolve_device
from repro_torch.serving.engine import TorchEngine
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.sim.clock import EventLoop

INTENT = """
objective: minimize p95(llm-0.latency)
rule shed: when last(llm-0.queue_len) > 6 => set llm-0.admit_priority_min 1
rule open: when last(llm-0.queue_len) <= 2 => reset llm-0.admit_priority_min
"""


def make_requests(vocab: int, n: int = 10, seed: int = 0) -> list[Request]:
    """Batched requests: mixed priorities and prompt lengths."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(4, 24))
        prio = Priority.INTERACTIVE if i % 3 == 0 else Priority.LOW
        reqs.append(Request(prompt_len=plen, max_new_tokens=12, priority=prio,
                            prompt_tokens=rng.integers(
                                0, vocab, plen).astype(np.int32)))
    return reqs


def wire(eng, collector: Collector, intent: str = INTENT):
    """Control-plane wiring (the engine registers its card and knobs):
    returns (registry, poller, controller) with ``intent`` installed."""
    loop = EventLoop()
    registry = Registry()
    registry.register(eng)
    poller = CentralPoller(StateStore())
    poller.attach(collector)
    controller = Controller(loop, registry, poller)
    controller.install(compile_intent(intent))
    return registry, poller, controller


def tick(eng, poller: CentralPoller, controller: Controller) -> None:
    """Poll the metrics plane and run every policy once: the controller's
    tick, driven between steps of a wall-clock engine."""
    poller.poll(eng.now())
    ctx = ControlContext(controller)
    for pol in controller.policies:
        pol.on_tick(ctx)


def run(cfg, params, device=None, n_requests: int = 10,
        intent: str = INTENT, max_steps: int = 200):
    """Serve ``make_requests`` on one ``TorchEngine`` named ``llm-0``
    under ``intent``, ticking the controller between steps.  Returns
    (engine, requests, registry, controller)."""
    collector = Collector("serve")
    eng = TorchEngine(cfg, params,
                      SchedulerConfig(max_slots=4, num_pages=128,
                                      max_context=128),
                      name="llm-0", collector=collector, device=device)
    registry, poller, controller = wire(eng, collector, intent)
    reqs = make_requests(cfg.vocab, n_requests)
    for r in reqs:
        eng.submit(r)
    for _ in range(max_steps):
        if not eng.busy:
            break
        eng.step()
        tick(eng, poller, controller)
    return eng, reqs, registry, controller


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    cfg = get_config("tiny-agent")
    device = resolve_device(args.device)
    params = models.init(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    eng, reqs, registry, controller = run(cfg, params, device)
    print(f"registered {eng.name} on {device}: "
          f"knobs={sorted(registry.card(eng.name).knobs)}")

    done = [r for r in reqs if r.state.value == "finished"]
    print(f"\ncompleted {len(done)}/{len(reqs)} requests")
    for r in done[:4]:
        print(f"  {r.req_id}: prio={r.priority.name:11s} "
              f"prompt={r.prompt_len:3d} tokens={r.output_tokens[:8]}...")
    lat = [r.finish_time - r.arrival_time for r in done]
    print(f"latency mean={np.mean(lat):.3f}s "
          f"p95={np.quantile(lat, 0.95):.3f}s")
    print(f"controller actions: "
          f"{[(a.kind, a.detail) for a in controller.actions]}")
    # demonstrate the uniform shim: retune batch size live
    registry.set(eng.name, "max_num_seqs", 2)
    print(f"set('max_num_seqs', 2) -> engine slots now "
          f"{eng.scheduler.cfg.max_slots}")


if __name__ == "__main__":
    main()
