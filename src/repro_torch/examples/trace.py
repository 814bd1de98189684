"""Tracing plane walkthrough: turn on request tracing from an intent at
runtime, then explain a workload from the exported trace alone.

The fig1 pipeline runs two waves of tasks.  Tracing is OFF at build
time — an intent rule watching ``developer.queue_len`` fires on the
first wave's arrival burst and enables span capture (``trace on``), so
only the second wave is sampled: tracing is a control-plane decision
made from runtime state, exactly like every other knob.  A second rule
fires mid-second-wave and flips the dev->tester channel to token
streaming; the flight recorder captures both actions and the exporter
causally links them onto the request spans they overlapped.

The trace is exported as Chrome-trace JSON and re-read by
``tools/trace_report.py`` — everything printed at the end (critical
path, dominant segments, segment-sum vs e2e tiling, linked control
actions) comes from the JSON file, not from live objects.

    PYTHONPATH=src python -m repro_torch.examples.trace
"""
import importlib.util
import sys
import tempfile
from pathlib import Path

from repro_torch.agents.pipeline import AgenticPipeline, PipelineConfig, TaskSpec
from repro_torch.core.intent import compile_intent

INTENT = """
# span capture is a runtime decision: the arrival burst itself
# enables tracing for everything sampled after this fires
rule enable on developer.queue_len > 1:
    => trace on; note tracing enabled from queue pressure
# mid-run reconfiguration while traced requests are in flight — the
# flight recorder links this action onto the spans it overlapped
rule stream on pipeline.tasks_done > 3:
    => granularity dev->tester stream; note streaming under load
"""


def _load_report_tool():
    path = Path(__file__).resolve().parents[3] / "tools" / "trace_report.py"
    spec = importlib.util.spec_from_file_location("trace_report", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def main(out_dir=None):
    pipe = AgenticPipeline(PipelineConfig(n_testers=2))
    pipe.controller.install(compile_intent(INTENT))
    pipe.recorder.watch("tester-*.queue_len")    # rolling metric windows

    assert pipe.tracer.enabled is False          # off until the rule fires
    for i in range(3):                           # wave 1: triggers `enable`
        pipe.submit(TaskSpec(session=f"s{i}", n_functions=4))
    pipe.loop.call_after(2.0, lambda: [
        pipe.submit(TaskSpec(session=f"s{3 + i}", n_functions=4))
        for i in range(5)])                      # wave 2: fully traced
    pipe.run(until=60.0)

    assert pipe.tracer.enabled, "intent never enabled tracing"
    assert len(pipe.done) == 8, f"only {len(pipe.done)}/8 tasks finished"
    traced = [a for a in pipe.controller.action_log("trace")]
    assert traced, "no trace action in the audit log"

    out = Path(out_dir or tempfile.mkdtemp(prefix="trace_example_")) \
        / "TRACE_fig1.json"
    doc = pipe.tracer.export(out, recorder=pipe.recorder)
    assert doc["otherData"]["links"] >= 1, "no action causally linked"

    rpt = _load_report_tool()
    loaded = rpt.load(out)
    assert rpt.validate(loaded) == [], "exported trace failed schema check"
    print(rpt.report(loaded, limit=3))
    checks = rpt.decomposition_check(rpt.spans_from(loaded))
    assert checks, "no closed request spans in the export"
    for span, seg_sum, dur in checks:
        assert abs(seg_sum - dur) <= 0.01 * max(dur, 1e-9), (
            f"{span.name}: segments {seg_sum:.4f}s != e2e {dur:.4f}s")
    win = pipe.recorder.window("tester-0.queue_len")
    print(f"recorder: {len(pipe.recorder.actions)} control actions, "
          f"{len(win)} samples of tester-0.queue_len")
    print(f"tasks completed: {len(pipe.done)}")


if __name__ == "__main__":
    main()
