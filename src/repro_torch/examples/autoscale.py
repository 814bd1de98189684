"""Event-driven autoscaling from a declarative intent v2 program.

The controller no longer has to poll every metric every 50 ms tick to
notice a burst: the ``on tester-0.queue_len > 10`` trigger becomes a
MetricBus threshold subscription, so the *data plane pushes* the breach
to the control plane the moment an engine records it, and the ``scale``
action reaches the ElasticGroup through the same Table-1 ``set()``
surface as every other knob (``tester-group.replicas``).

    PYTHONPATH=src python -m repro_torch.examples.autoscale
"""
from repro_torch.agents import AgenticPipeline, PipelineConfig, WorkloadConfig
from repro_torch.agents.workloads import Phase, PhasedLoad
from repro_torch.core import compile_intent
from repro_torch.core.types import Granularity


INTENT = """
objective: maximize throughput under p95(pipeline.task_latency) <= 6.0

# event path: the bus pushes the queue-length breach between polls;
# hold 6 = at most one scale-up per 6 s
rule burst on tester-0.queue_len > 10 hold 6:
    => scale tester-group +1; note burst: grew the tester fleet

# interval path: sustained calm across the WHOLE fleet (glob pools
# every tester's series) shrinks it back; replicas clamps at 1, so
# repeated firing is safe
rule calm hold 8: when mean(tester-*.queue_len, 4.0) <= 1
    => scale tester-group -1
"""


def main():
    p = AgenticPipeline(PipelineConfig(granularity=Granularity.PIPELINE,
                                       n_testers=1))
    intent = compile_intent(INTENT)
    p.controller.install(intent)
    print("intent:", intent.objective.describe())
    print("bus subscriptions:",
          [s.metric for s in p.bus.subscriptions()])

    load = PhasedLoad(p, WorkloadConfig(think_time=0.3),
                      [Phase(10.0, 2), Phase(20.0, 40), Phase(20.0, 2)])
    load.start()
    p.run(until=55.0)

    print(f"\ntasks completed: {len(p.done)}")
    print(f"final replicas:  {p.registry.get_param('tester-group', 'replicas')}")
    print(f"rule firings:    {intent.stats()}")
    print(f"bus events:      published={p.bus.published} "
          f"delivered={p.bus.delivered}")
    print("\ncontroller audit log (event + scale actions):")
    for a in p.controller.actions:
        if a.kind in ("event", "scale"):
            print(f"  t={a.t:6.2f}s  [{a.kind}] {a.target}: {a.detail}")


if __name__ == "__main__":
    main()
