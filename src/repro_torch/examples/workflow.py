"""Workflow graph plane end-to-end: a first-class agent DAG under
critical-path scheduling, per-stage model tiering, and a stage-selector
intent program.

    PYTHONPATH=src python -m repro_torch.examples.workflow

What happens:

1. ``map_reduce(width=8)`` — planner → 8-way map fan-out → fan-in
   reducer — compiles through ``AgenticPipeline.build`` into a shared
   tier-labelled engine pool (two 7B-class instances + four 1B-class),
   one ``stage_aware`` router, a ``Channel`` per graph edge, and a
   registered ``stage.<name>`` controllable per stage.
2. The graph is a control-plane object: every engine request carries a
   deadline propagated along the DAG's edges from the critical-path
   estimate, schedulers run EDF-within-priority with a longest-
   remaining-path tie-break, and behind-schedule tasks get an admission
   priority boost.
3. An intent program uses the v2 ``stage`` selectors: when the map
   stage's own p95 gauge breaches, the bus-triggered rule re-tiers it
   to the small model through the same audited ``set()`` surface as
   every other knob — and the critical-path estimates (and therefore
   every downstream deadline) shift with it.
"""
from repro_torch.agents import (AgenticPipeline, GraphBurst, TierSpec,
                          WorkflowConfig, map_reduce)
from repro_torch.core import compile_intent

INTENT = """
objective: minimize p95(workflow.task_latency)

# stage selector, event path: the map stage publishes its own rolling
# p95 gauge; a breach pushes over the MetricBus and re-tiers the stage
rule map_slow on stage map.p95 > 0.35 hold 2:
    => set stage map.model_tier small; note map stage down-tiered

# stage selector, interval path: a calm map stage earns the big model back
rule map_calm hold 4: when p95(stage map.latency, 3.0) <= 0.1
    => reset stage map.model_tier
"""


def main():
    graph = map_reduce(width=8)          # every stage starts on "large"
    print(graph.describe())
    wp = AgenticPipeline.build(graph, WorkflowConfig(
        tiers={"large": TierSpec("agent-7b", chips=4, replicas=2),
               "small": TierSpec("agent-1b", chips=1, replicas=4)}))
    intent = compile_intent(INTENT)
    wp.controller.install(intent)
    print("intent:", intent.objective.describe())
    print(f"critical path estimate: {wp._cp_total:.3f}s "
          f"(deadline slack x{wp.cfg.deadline_slack})")

    GraphBurst(wp, n_tasks=24, stagger=0.05).start()
    wp.run(until=120.0)

    lats = sorted(wp.latencies())
    print(f"\ntasks completed: {len(wp.done)}")
    print(f"p95 task latency: {lats[int(0.95 * len(lats)) - 1]:.3f}s")
    print(f"map stage tier now: "
          f"{wp.registry.get_param('stage.map', 'model_tier')}")
    print(f"router picks won on tier match: {wp.router.tier_routed}")
    print(f"rule firings: {intent.stats()}")
    print("\ncontroller audit (stage + event actions):")
    for a in wp.controller.actions:
        if "stage." in a.target or a.kind == "event":
            print(f"  t={a.t:6.2f}s  [{a.kind}] {a.target}: {a.detail}")


if __name__ == "__main__":
    main()
