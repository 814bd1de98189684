"""Disaggregation plane walkthrough: software-defined engine roles.

A 3-engine fleet starts as 1 prefill / 2 decode behind a DisaggPool.
Requests prefill on the prefill-role engine (first token there), then
their KV rides the chunk-streamed handoff pipeline to a decode engine
that carries the decode tail.  An intent rule watches the fleet's
``cluster.prefill_pressure`` gauge and *conscripts* a decode engine to
prefill duty when a fan-out burst lands — then a second rule returns it
to decode duty once the backlog clears.  Engine role is just a knob:
the same ``set()`` surface every other serving attribute uses.

    PYTHONPATH=src python -m repro_torch.examples.disagg
"""
from repro_torch.configs import get_config
from repro_torch.core.controller import Controller
from repro_torch.core.intent import compile_intent
from repro_torch.core.metrics import CentralPoller, Collector, MetricBus, StateStore
from repro_torch.core.registry import Registry
from repro_torch.core.types import Request
from repro_torch.serving.disagg import DisaggPool
from repro_torch.serving.engine_sim import SimEngine
from repro_torch.serving.kv_transfer import KVTransferManager, SessionDirectory
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.sim.clock import EventLoop
from repro_torch.sim.costmodel import costmodel_for

INTENT = """
# conscript e2 the moment fleet prefill backlog exceeds half a step
rule surge on cluster.prefill_pressure > 0.5 hold 2:
    => set engine e2.role prefill; note surge: e2 conscripted to prefill
# return it to decode duty once the backlog has stayed clear
rule relax hold 2: when mean(cluster.prefill_pressure, 1.0) < 0.05
    => set engine e2.role decode
"""


def main():
    loop = EventLoop()
    bus = MetricBus()
    collector = Collector("disagg-example", bus=bus)
    store = StateStore()
    poller = CentralPoller(store)
    poller.attach(collector)
    registry = Registry()
    controller = Controller(loop, registry, poller, interval=0.05, bus=bus)

    cm = costmodel_for(get_config("agent-7b"), chips=4)
    roles = ("prefill", "decode", "decode")
    engines = [
        SimEngine(loop, cm,
                  SchedulerConfig(max_slots=8, num_pages=2048,
                                  max_context=4096, prefill_chunk=512,
                                  role=role),
                  name=f"e{i}", collector=collector)
        for i, role in enumerate(roles)]
    for e in engines:
        registry.register(e)
    kvx = KVTransferManager(loop, SessionDirectory(),
                            bytes_fn=cm.kv_transfer_bytes,
                            collector=collector)
    pool = DisaggPool(loop, engines, kvx, collector=collector)
    controller.install(compile_intent(INTENT))

    # steady trickle of requests, then a fan-out burst at t=2s
    reqs = []

    def submit(prompt, gen):
        r = Request(prompt_len=prompt, max_new_tokens=gen)
        reqs.append(r)
        pool.submit(r)

    for i in range(10):
        loop.call_at(0.2 * i, lambda: submit(256, 48))
    loop.call_at(2.0, lambda: [submit(1024, 16) for _ in range(16)])

    role_log = []

    def snap_roles():
        role_log.append((round(loop.now(), 2), dict(pool.roles())))
    for t in (1.0, 2.5, 8.0):
        loop.call_at(t, snap_roles)

    controller.start()
    loop.run_until(20.0)

    print("role timeline:")
    for t, roles_at in role_log:
        print(f"  t={t:5.2f}s  {roles_at}")
    print("controller actions:")
    for a in controller.action_log("set") + controller.action_log("note"):
        print(f"  t={a.t:5.2f}s  {a.kind:4s} {a.target}: {a.detail}")
    n_done = sum(1 for r in reqs if r.state.value == "finished")
    print(f"\nhandoffs: {pool.handoffs}  (KV bytes moved: "
          f"{kvx.handoff_bytes / 1e6:.1f} MB)")
    print(f"tasks completed: {n_done}/{len(reqs)}")
    assert n_done == len(reqs), "every request must finish"
    assert pool.handoffs > 0, "prefill->decode handoffs must occur"
    surged = any("role=prefill" in a.detail
                 for a in controller.action_log("set"))
    assert surged, "the surge rule must have flipped a role"
    print("OK")


if __name__ == "__main__":
    main()
