"""Tenancy plane walkthrough: throttle a noisy tenant from intent.

Two tenants share a 2-engine pool: ``gold`` runs small interactive
requests in closed-loop sessions, ``noisy`` floods long prompts
open-loop.  Every request is tenant-stamped; the router meters each
tenant's traffic through its token bucket, and the TenantDirectory
publishes per-tenant rollups (``tenant.gold.p95_ttft``, ...) on the
metric bus.  An intent rule watches the gold tenant's p95 TTFT and — on
breach — *throttles the noisy tenant at runtime* by setting its
``tenant.noisy.rate`` knob: the noisy prompts are held (never dropped)
at the router and drip through on refill, while the gold tenant's
latency recovers.  A second rule relaxes the throttle once gold has
stayed healthy.

    PYTHONPATH=src python -m repro_torch.examples.tenancy
"""
from repro_torch.agents.workloads import TenantLoad, TenantMix
from repro_torch.configs import get_config
from repro_torch.core.controller import Controller
from repro_torch.core.intent import compile_intent
from repro_torch.core.metrics import CentralPoller, Collector, MetricBus, StateStore
from repro_torch.core.registry import Registry
from repro_torch.core.tenancy import TenantDirectory, TenantSpec
from repro_torch.serving.disagg import DisaggPool
from repro_torch.serving.engine_sim import SimEngine
from repro_torch.serving.kv_transfer import KVTransferManager, SessionDirectory
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.sim.clock import EventLoop
from repro_torch.sim.costmodel import costmodel_for

INTENT = """
# throttle the noisy tenant the moment gold's p95 TTFT breaches
rule guard on tenant gold.p95_ttft > 0.15 hold 2:
    => set tenant noisy.rate 4000; note guard: noisy tenant throttled
# relax once gold has stayed healthy for a while
rule relax hold 8: when p95(tenant gold.ttft, 3.0) < 0.05
    => reset tenant noisy.rate
"""


def main():
    loop = EventLoop()
    bus = MetricBus()
    collector = Collector("tenancy-example", bus=bus)
    store = StateStore()
    poller = CentralPoller(store)
    poller.attach(collector)
    registry = Registry()
    controller = Controller(loop, registry, poller, interval=0.05, bus=bus)

    tenants = TenantDirectory(collector=collector, registry=registry)
    tenants.add(TenantSpec("gold", weight=4.0, slo_class="gold",
                           p95_ttft_target=0.15))
    tenants.add(TenantSpec("noisy", weight=1.0, slo_class="batch"))

    cm = costmodel_for(get_config("agent-7b"), chips=4)
    engines = [
        SimEngine(loop, cm,
                  SchedulerConfig(max_slots=8, num_pages=4096,
                                  max_context=4096, prefill_chunk=512),
                  name=f"e{i}", collector=collector)
        for i in range(2)]
    for e in engines:
        registry.register(e)
    kvx = KVTransferManager(loop, SessionDirectory(),
                            bytes_fn=cm.kv_transfer_bytes,
                            collector=collector)
    pool = DisaggPool(loop, engines, kvx, collector=collector,
                      tenants=tenants)
    controller.install(compile_intent(INTENT))

    mix = TenantMix(loop, pool.submit, [
        TenantLoad("gold", slo_class="gold", mode="closed", sessions=6,
                   think=0.05, prompt=128, gen=64),
        TenantLoad("noisy", slo_class="batch", mode="open", rate=60.0,
                   prompt=1024, gen=48),
    ], t_end=16.0, seed=0)
    TenantMix.wire_pool(pool)
    mix.start()

    controller.start()
    loop.run_until(40.0)

    noisy = tenants.get("noisy")
    gold_ttfts = sorted(
        r.first_token_time - r.arrival_time
        for r in mix.requests["gold"] if r.first_token_time is not None)
    p95 = gold_ttfts[int(0.95 * (len(gold_ttfts) - 1))] if gold_ttfts else 0

    print("controller actions:")
    for a in controller.action_log("set") + controller.action_log("note"):
        print(f"  t={a.t:5.2f}s  {a.kind:4s} {a.target}: {a.detail}")
    print(f"\ngold requests: {len(mix.requests['gold'])}  "
          f"p95 TTFT: {p95:.3f}s")
    print(f"noisy messages throttled: {noisy.throttled_count}  "
          f"(admitted {noisy.admitted_tokens:.0f} tokens)")
    n_gold = len(mix.requests["gold"])
    n_done = sum(1 for r in mix.requests["gold"]
                 if r.state.value == "finished")
    print(f"tasks completed: {n_done}/{n_gold} gold")
    assert n_done == n_gold, "every gold request must finish"
    throttled = any("tenant.noisy" in a.target
                    for a in controller.action_log("set"))
    assert throttled, "the guard rule must have throttled the noisy tenant"
    assert noisy.throttled_count > 0, "the router meter must have held work"
    print("OK")


if __name__ == "__main__":
    main()
