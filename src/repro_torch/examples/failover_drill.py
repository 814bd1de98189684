"""Fault-tolerance drill: kill a tester instance mid-flight, watch the
heartbeat monitor detect it and the elastic group fail over (sessions
re-homed, in-flight work re-queued on survivors), then scale back up.

    PYTHONPATH=src python -m repro_torch.examples.failover_drill
"""
from repro_torch.agents import AgenticPipeline, PipelineConfig, WorkloadConfig
from repro_torch.agents.workloads import launch_clients
from repro_torch.core.types import Granularity
from repro_torch.runtime import HeartbeatMonitor
from repro_torch.runtime.heartbeat import attach_engine


def main():
    p = AgenticPipeline(PipelineConfig(granularity=Granularity.PIPELINE,
                                       n_testers=2))
    mon = HeartbeatMonitor(p.loop, miss_timeout=1.0)
    for t in p.testers:
        attach_engine(mon, t.engine)
    # reuse the pipeline's registered group — one drain/scale authority
    # per fleet (a second ElasticGroup would track draining separately)
    grp = p.elastic
    grp.monitor = mon

    events = []

    def on_failure(name):
        events.append((p.loop.now(), f"FAILURE detected: {name}"))
        moved = grp.fail_over(name)
        events.append((p.loop.now(),
                       f"failed over {moved} sessions/requests to "
                       f"{[t.name for t in p.testers]}"))
        # restore capacity
        new = grp.scale_up()
        events.append((p.loop.now(), f"scaled up replacement: {new}"))

    mon.on_failure = on_failure
    mon.start()

    launch_clients(p, WorkloadConfig(n_clients=8, think_time=0.2),
                   stop_at=20.0)

    # pull the plug on tester-0 at t=6s: it stops stepping (pause) and
    # stops heartbeating (unwatch happens only via failover)
    def kill():
        victim = p.testers[0]
        victim.engine.paused = True           # stops stepping...
        victim.engine.dead = True             # ...and stops liveness pings
        events.append((p.loop.now(), f"injected crash: {victim.name}"))

    p.loop.call_at(6.0, kill)
    p.run(until=40.0)

    print("timeline:")
    for t, e in events:
        print(f"  t={t:6.2f}s  {e}")
    print(f"\ntasks completed: {len(p.done)} "
          f"(work continued through the failure)")
    assert len(p.done) > 20
    assert any("FAILURE" in e for _, e in events)
    print("OK")


if __name__ == "__main__":
    main()
