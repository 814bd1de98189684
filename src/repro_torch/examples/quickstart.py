"""Quickstart: the software-defined agentic serving stack in ~60 lines.

Builds the paper's Fig-1 pipeline (developer → shim channel → router →
tester), installs a declarative intent program on the controller, drives
a bursty workload, and prints what the control plane did.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
"""
from repro_torch.agents import AgenticPipeline, PipelineConfig, WorkloadConfig
from repro_torch.agents.workloads import Phase, PhasedLoad
from repro_torch.core import compile_intent
from repro_torch.core.types import Granularity


def main():
    # 1. the pipeline: one developer, one tester, a controllable channel
    p = AgenticPipeline(PipelineConfig(granularity=Granularity.PIPELINE,
                                       n_testers=1, stream_chunk=2))

    # 2. operator intent, not code: the controller compiles this into a
    #    closed-loop policy over the metrics plane
    intent = compile_intent("""
objective: maximize throughput under p95(pipeline.task_latency) <= 4.0

rule overload:  when mean(tester-0.queue_len, 1.0) > 12
    => granularity dev->tester batch; set tester-0.decode_first true
rule loaded:    when mean(tester-0.queue_len, 1.0) > 3
    => granularity dev->tester pipeline; reset tester-0.decode_first
rule idle:      when mean(tester-0.queue_len, 1.0) <= 3
    => granularity dev->tester stream
""")
    p.controller.install(intent)
    print("intent:", intent.objective.describe())

    # 3. load that shifts: quiet -> burst -> quiet
    load = PhasedLoad(p, WorkloadConfig(think_time=0.3),
                      [Phase(15.0, 2), Phase(15.0, 48), Phase(15.0, 2)])
    load.start()
    p.run(until=50.0)

    # 4. what happened
    lats = p.latencies()
    print(f"\ntasks completed: {len(p.done)}")
    print(f"mean latency:    {sum(lats)/len(lats):.2f}s")
    print(f"rule firings:    {intent.stats()}")
    print("\ncontroller action log (granularity switches):")
    for a in p.controller.action_log("set"):
        if "granularity" in a.detail:
            print(f"  t={a.t:6.2f}s  {a.target}: {a.detail}")


if __name__ == "__main__":
    main()
