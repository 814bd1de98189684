"""The port's sim planes against the JAX package.

``sim/costmodel.py`` and ``sim/calibration.py`` are ported: the same
classes, functions and formulas, priced for one NVIDIA H100.  With the
port's device figures set to the reference's (read from
``repro.sim.costmodel``; the port reads its figures through its module
when a cost is computed, so setting them there is enough), every cost
function equals the reference's on every registry config; with its own
figures a step costs the H100 roofline.  The same measured points give
the same fit in both packages.  ``serving/{router,kv_transfer,
engine_sim,disagg}.py`` are copies: the disaggregated fleet of
``tests/test_disagg.py`` gives the same handoffs, finish times and
controller action log in both packages.

Tolerances: costs 1e-12 relative (the same arithmetic in the same
order); fits 1e-12 relative; sim runs exact (the same event order on
the same virtual clock).
"""
import itertools
import json
import math
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import repro.core.types as jtypes  # noqa: E402
import repro.sim.calibration as jcal  # noqa: E402
import repro.sim.costmodel as jcm  # noqa: E402
import repro_torch.core.types as ttypes  # noqa: E402
import repro_torch.sim.calibration as tcal  # noqa: E402
import repro_torch.sim.costmodel as tcm  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FIGURES = ("PEAK_FLOPS", "HBM_BW", "HOST_BW", "STEP_OVERHEAD")
CONFIGS = jconfigs.ARCHS + ("tiny-agent", "agent-1b", "agent-7b", "lm-100m")
# (prompt tokens, resident context, batch, mean decode context)
SHAPES = [(1, 0, 1, 1.0), (7, 100, 3, 517.5), (512, 2048, 8, 4096.0),
          (4096, 0, 32, 100_000.0)]


@pytest.fixture
def aligned(monkeypatch):
    """The port's device figures set to the JAX package's, and both
    packages' id counters restarted at 0."""
    for name in FIGURES:
        monkeypatch.setattr(tcm, name, getattr(jcm, name))
    monkeypatch.setattr(jtypes, "_ids", itertools.count())
    monkeypatch.setattr(ttypes, "_ids", itertools.count())


def costs(cm, shape) -> dict:
    """Every cost function of a ``CostModel`` at one shape."""
    n, ctx, b, mctx = shape
    return {
        "n_params": cm.n_params(), "n_active": cm.n_active_params(),
        "kv_per_token": cm.kv_bytes_per_token(),
        "state": cm.state_bytes(),
        "kv_transfer": cm.kv_transfer_bytes(n + ctx),
        "handoff": cm.handoff_time(n + ctx),
        "handoff_overlap": cm.handoff_time(n + ctx, overlap_s=1e-3),
        "offload": cm.offload_time(n + ctx),
        "restore": cm.restore_time(n + ctx),
        "prefill_cost": cm.prefill_cost(n, b, ctx),
        "prefill": cm.prefill_time(n, b, ctx),
        "decode_cost": cm.decode_cost(b, mctx),
        "decode": cm.decode_time(b, mctx),
        "mixed_cost": cm.mixed_cost(n, ctx, b, mctx),
        "mixed_alone": cm.mixed_cost(n, ctx, 0, 0.0),
        "mixed": cm.mixed_time(n, ctx, b, mctx),
        "call": cm.call_time(n, 16, ctx, b),
    }


# ---------------------------------------------------------------------------
# The cost model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chips", [1, 4])
@pytest.mark.parametrize("name", CONFIGS)
def test_costs_equal_the_reference_with_its_figures(aligned, name, chips):
    jm = jcm.CostModel(jconfigs.get_config(name), chips)
    tm = tcm.CostModel(tconfigs.get_config(name), chips)
    assert tm.step_overhead == jm.step_overhead
    for shape in SHAPES:
        want, got = costs(jm, shape), costs(tm, shape)
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert np.asarray(got[k]) == pytest.approx(
                np.asarray(w), rel=1e-12, abs=0), (k, shape)


@pytest.mark.parametrize("name", ["agent-7b", "agent-1b", "hymba-1.5b",
                                  "arctic-480b", "xlstm-350m"])
def test_step_times_are_the_h100_roofline(name):
    """With the port's own figures, a prefill or decode step costs its
    FLOPs at 989 TFLOP/s or its bytes at 3.35 TB/s, whichever is longer,
    plus the step overhead, per chip."""
    assert tcm.PEAK_FLOPS == 989e12 and tcm.HBM_BW == 3.35e12
    cfg = tconfigs.get_config(name)
    for chips in (1, 4):
        cm = tcm.CostModel(cfg, chips)
        assert cm.step_overhead == tcm.STEP_OVERHEAD
        for n, ctx, b, mctx in SHAPES:
            f, by = cm.prefill_cost(n, b, ctx)
            assert cm.prefill_time(n, b, ctx) == pytest.approx(
                max(f / 989e12, by / 3.35e12) / chips + tcm.STEP_OVERHEAD,
                rel=1e-12)
            f, by = cm.decode_cost(b, mctx)
            assert cm.decode_time(b, mctx) == pytest.approx(
                max(f / 989e12, by / 3.35e12) / chips + tcm.STEP_OVERHEAD,
                rel=1e-12)
        ctx = 1000
        assert cm.offload_time(ctx) == pytest.approx(
            cm.kv_transfer_bytes(ctx) / tcm.HOST_BW + 0.5e-3, rel=1e-12)
        assert cm.restore_time(ctx, bandwidth=1e9) == pytest.approx(
            cm.kv_transfer_bytes(ctx) / 1e9 + 0.5e-3, rel=1e-12)


def test_figures_are_the_cards():
    """No figure of another device is left in the port, and each device
    figure of the cost model names the H100 data sheet or a measurement
    on a named card at a stated power limit."""
    pattern = re.compile(r"197e12|819e9|ICI_BW|DCN_BW|v5e")
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            assert not pattern.search(line), f"{path.name}:{i}: {line}"
    src = (ROOT / "src/repro_torch/sim/costmodel.py").read_text()
    for name in ("PEAK_FLOPS", "HBM_BW"):
        (line,) = [x for x in src.splitlines() if x.startswith(name + " =")]
        assert "H100 SXM data sheet" in line
    for name in ("HOST_BW", "STEP_OVERHEAD"):
        block = src[:src.index(f"\n{name} =")].rsplit("\n\n", 1)[-1]
        assert "NVIDIA H100 80GB HBM3" in block and "700 W" in block, name
        assert getattr(tcm, name) > 0
    assert not hasattr(tcm, "ICI_BW") and not hasattr(tcm, "DCN_BW")


def test_from_dryrun_matches_the_reference(aligned, tmp_path):
    art = tmp_path / "dryrun.json"
    art.write_text(json.dumps({"model_flops": 2.0e15, "flops": 3.1e15}))
    for name in ("agent-7b", "kimi-k2-1t-a32b"):
        jm = jcm.CostModel.from_dryrun(jconfigs.get_config(name), 4, art)
        tm = tcm.CostModel.from_dryrun(tconfigs.get_config(name), 4, art)
        assert (tm.flops_scale, tm.bytes_scale, tm.step_overhead) == (
            jm.flops_scale, jm.bytes_scale, jm.step_overhead)
        assert tm.flops_scale == pytest.approx(1.55)
    assert tcm.CostModel.from_dryrun(
        tconfigs.get_config("agent-7b"), 1, tmp_path / "none").flops_scale == 1


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

GRID = ([("prefill", 1, n) for n in (64, 128, 256, 512)]
        + [("decode", b, c) for b, c in ((1, 128), (1, 512), (2, 256),
                                         (4, 512), (8, 1024))])


def points(cal, cm, scales, noise=0.0, seed=0):
    """``GRID``'s points of calibration module ``cal``, priced by ``cm``
    through ``max(fs t_c, bs t_m) + c`` at ``scales`` and its package's
    figures, with a relative noise drawn from a seed."""
    fs, bs, c = scales
    fig = tcm if cal is tcal else jcm
    rng = np.random.default_rng(seed)
    out = []
    for kind, b, n in GRID:
        f, by = (cm.prefill_cost(n) if kind == "prefill"
                 else cm.decode_cost(b, n))
        t = max(fs * f / fig.PEAK_FLOPS, bs * by / fig.HBM_BW) / cm.chips + c
        out.append(cal.CalibrationPoint(
            kind, b, n, f, by, t * (1 + noise * rng.uniform(-1, 1))))
    return out


def test_the_same_points_give_the_same_fit(aligned):
    cfg = "agent-7b"
    pts = points(jcal, jcm.CostModel(jconfigs.get_config(cfg)),
                 (1.6, 2.7, 4e-4), noise=0.2)
    want = jcal.calibrate(cfg, "gpu", pts)
    got = tcal.calibrate(cfg, "cuda", [tcal.CalibrationPoint(**vars(p))
                                       for p in pts])
    for k in ("flops_scale", "bytes_scale", "step_overhead", "max_rel_err"):
        assert getattr(got, k) == pytest.approx(getattr(want, k), rel=1e-12)
    assert got.tolerance == want.tolerance == 0.35
    assert got.within_tolerance == want.within_tolerance
    assert got.rel_errors() == pytest.approx(want.rel_errors(), rel=1e-12)


@pytest.mark.parametrize("scales", [(1.0, 1.0, 0.0), (1.6, 2.7, 4e-4),
                                    (2.5, 2.0, 1e-3)])
def test_fit_recovers_scales_at_the_cards_figures(scales):
    """Noiseless points priced at the port's own figures give back the
    scales they were made with."""
    cm = tcm.CostModel(tconfigs.get_config("agent-7b"))
    calib = tcal.calibrate("agent-7b", "cuda", points(tcal, cm, scales))
    assert (calib.flops_scale, calib.bytes_scale,
            calib.step_overhead) == pytest.approx(scales, rel=1e-9,
                                                  abs=1e-12)
    assert calib.max_rel_err < 1e-9 and calib.within_tolerance


def test_tolerance_bands_by_device_type():
    assert tcal.TOLERANCE == {"gpu": 0.35, "cpu": 0.75}
    pts = points(tcal, tcm.CostModel(tconfigs.get_config("agent-1b")),
                 (1.2, 2.0, 1e-4))
    assert tcal.calibrate("m", "cuda", pts).tolerance == 0.35
    assert tcal.calibrate("m", "cpu", pts).tolerance == 0.75
    assert tcal.calibrate("m", "cuda", pts, tolerance=0.1).tolerance == 0.1
    assert "tpu" not in tcal.TOLERANCE


def test_artifact_round_trips(tmp_path):
    pts = points(tcal, tcm.CostModel(tconfigs.get_config("agent-7b")),
                 (1.6, 2.7, 4e-4), noise=0.1)
    calib = tcal.calibrate("agent-7b", torch.zeros(1).device.type, pts)
    assert calib.backend == "cpu"
    path = tcal.save_calibration(calib, tmp_path / "x" / "CALIB_agent-7b.json")
    assert tcal.load_calibration(path) == calib
    data = json.loads(path.read_text())
    assert data["version"] == tcal.CALIB_VERSION == jcal.CALIB_VERSION
    # the reference's artifact format: its loader reads the port's file
    assert vars(jcal.load_calibration(path)) == {
        **vars(calib), "points": [jcal.CalibrationPoint(**vars(p))
                                  for p in calib.points]}
    cm = tcm.CostModel.from_calibration(tconfigs.get_config("agent-7b"), 1,
                                        path)
    assert (cm.flops_scale, cm.bytes_scale, cm.step_overhead) == (
        calib.flops_scale, calib.bytes_scale, calib.step_overhead)
    path.write_text(json.dumps({**data, "version": 99}))
    assert tcal.load_calibration(path) is None
    path.write_text("{not json")
    assert tcal.load_calibration(path) is None
    assert tcal.load_calibration(tmp_path / "missing.json") is None


def test_each_package_reads_only_its_own_fits(monkeypatch, tmp_path):
    """The port's calibration directory and variable differ from the
    reference's: a fit in one package's place is never read by the
    other."""
    assert tcm.DEFAULT_CALIB_DIR != jcm.DEFAULT_CALIB_DIR
    assert tcm.CALIB_DIR_ENV == "REPRO_TORCH_CALIB_DIR"
    pts = points(tcal, tcm.CostModel(tconfigs.get_config("agent-7b")),
                 (1.6, 2.7, 4e-4))
    tcal.save_calibration(tcal.calibrate("agent-7b", "cuda", pts),
                          tmp_path / "CALIB_agent-7b.json")
    jcfg, tcfg = jconfigs.get_config("agent-7b"), tconfigs.get_config(
        "agent-7b")
    monkeypatch.delenv("REPRO_TORCH_CALIB_DIR", raising=False)
    monkeypatch.setenv("REPRO_CALIB_DIR", str(tmp_path))
    assert jcm.costmodel_for(jcfg).bytes_scale == pytest.approx(2.7)
    assert tcm.costmodel_for(tcfg).bytes_scale == 1.0
    monkeypatch.delenv("REPRO_CALIB_DIR")
    monkeypatch.setenv("REPRO_TORCH_CALIB_DIR", str(tmp_path))
    assert tcm.costmodel_for(tcfg).bytes_scale == pytest.approx(2.7)
    assert jcm.costmodel_for(jcfg).bytes_scale == 1.0
    assert tcm.costmodel_for(tcfg, calib_dir=tmp_path / "none"
                             ).bytes_scale == 1.0


# ---------------------------------------------------------------------------
# Router, KV transfer, sim engine, disaggregation: tests/test_disagg.py's
# fleet in both packages
# ---------------------------------------------------------------------------

def package(root: str) -> SimpleNamespace:
    """The modules of one package the fleet is built from."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(
        get_config=mod("configs").get_config,
        Controller=mod("core.controller").Controller,
        compile_intent=mod("core.intent").compile_intent,
        metrics=mod("core.metrics"),
        RoleBalancerPolicy=mod("core.policies").RoleBalancerPolicy,
        Registry=mod("core.registry").Registry,
        Request=mod("core.types").Request,
        DisaggPool=mod("serving.disagg").DisaggPool,
        SimEngine=mod("serving.engine_sim").SimEngine,
        kvt=mod("serving.kv_transfer"),
        SchedulerConfig=mod("serving.scheduler").SchedulerConfig,
        EventLoop=mod("sim.clock").EventLoop,
        CostModel=mod("sim.costmodel").CostModel)


def fleet(pk, roles, controller=False, slots=8):
    """``tests/test_disagg.py::_fleet`` over ``pk``'s modules."""
    loop = pk.EventLoop()
    bus = pk.metrics.MetricBus()
    col = pk.metrics.Collector("t", bus=bus)
    cm = pk.CostModel(pk.get_config("agent-7b"), chips=4)
    engines = [pk.SimEngine(loop, cm, pk.SchedulerConfig(
        max_slots=slots, num_pages=2048, max_context=4096, role=r),
        name=f"e{i}", collector=col) for i, r in enumerate(roles)]
    kvx = pk.kvt.KVTransferManager(loop, pk.kvt.SessionDirectory(),
                                   bytes_fn=cm.kv_transfer_bytes,
                                   collector=col)
    pool = pk.DisaggPool(loop, engines, kvx, collector=col)
    ctl = None
    if controller:
        poller = pk.metrics.CentralPoller(pk.metrics.StateStore())
        poller.attach(col)
        registry = pk.Registry()
        for e in engines:
            registry.register(e)
        ctl = pk.Controller(loop, registry, poller, interval=0.05, bus=bus)
    return SimpleNamespace(loop=loop, engines=engines, kvx=kvx, pool=pool,
                           ctl=ctl)


def scenario_end_to_end(pk):
    f = fleet(pk, ("prefill", "decode", "decode"))
    reqs = [pk.Request(prompt_len=256, max_new_tokens=16) for _ in range(8)]
    for r in reqs:
        f.pool.submit(r)
    f.loop.run_until(60.0)
    return f, reqs


def scenario_chunk_streaming(pk):
    f = fleet(pk, ("prefill", "decode"))
    f.engines[0].set_param("prefill_chunk", 128)
    reqs = [pk.Request(prompt_len=1024, max_new_tokens=4),
            pk.Request(prompt_len=300, max_new_tokens=9)]
    for r in reqs:
        f.pool.submit(r)
    f.loop.run_until(30.0)
    return f, reqs


def scenario_flips_via_set(pk):
    f = fleet(pk, ("unified", "unified", "unified"))
    reqs = [pk.Request(prompt_len=128, max_new_tokens=48) for _ in range(12)]
    for i, r in enumerate(reqs):
        f.loop.call_at(0.005 * i, lambda r=r: f.pool.submit(r))
    e = f.engines
    f.loop.call_at(0.1, lambda: e[0].set_param("role", "prefill"))
    f.loop.call_at(0.2, lambda: e[1].set_param("role", "decode"))
    f.loop.call_at(0.6, lambda: e[1].set_param("role", "unified"))
    f.loop.run_until(120.0)
    return f, reqs


def scenario_intent_rule(pk):
    f = fleet(pk, ("prefill", "decode", "decode"), controller=True)
    f.ctl.install(pk.compile_intent(
        "rule surge on cluster.prefill_pressure > 2 hold 1:\n"
        "    => set engine e1.role prefill\n"))
    f.ctl.start()
    reqs = [pk.Request(prompt_len=2048, max_new_tokens=8) for _ in range(24)]
    f.loop.call_at(0.5, lambda: [f.pool.submit(r) for r in reqs])
    f.loop.run_until(120.0)
    return f, reqs


def scenario_role_balancer(pk):
    f = fleet(pk, ("prefill", "decode", "decode"), controller=True)
    f.ctl.install(pk.RoleBalancerPolicy(
        [e.name for e in f.engines], pressure_hi=1.0, pressure_lo=0.05,
        min_prefill=1, min_decode=1, dwell=0.2, release_dwell=0.2,
        window=0.3, slot_profile={"prefill": 8, "decode": 8}))
    f.ctl.start()
    reqs = [pk.Request(prompt_len=2048, max_new_tokens=4) for _ in range(64)]
    for i, r in enumerate(reqs):
        f.loop.call_at(0.02 * i, lambda r=r: f.pool.submit(r))
    f.loop.run_until(120.0)
    return f, reqs


SCENARIOS = {"end_to_end": scenario_end_to_end,
             "chunk_streaming": scenario_chunk_streaming,
             "flips_via_set": scenario_flips_via_set,
             "intent_rule": scenario_intent_rule,
             "role_balancer": scenario_role_balancer}


def outcome(f, reqs) -> dict:
    """What a fleet run did: per request its times, tokens, state and
    reroutes; the pool's and the fabric's counters; each engine's steps
    and role; the controller's action log."""
    return {
        "requests": [(r.state.value, r.first_token_time, r.finish_time,
                      list(r.output_tokens), r.meta.get("disagg_reroutes"))
                     for r in reqs],
        "pool": (f.pool.handoffs, f.pool.migrations, len(f.pool.finished),
                 f.pool.roles(), f.pool.router.disagg_routed),
        "kvx": (f.kvx.handoffs, f.kvx.handoff_bytes, f.kvx.bytes_moved,
                f.kvx.transfers, sorted(f.kvx.handoff_records)),
        "engines": [(e.name, e.role, e.steps, e.prefill_steps,
                     e.decode_steps, e.tokens_generated, e.busy_time)
                    for e in f.engines],
        "actions": [] if f.ctl is None else [
            (a.t, a.kind, a.target, a.detail) for a in f.ctl.actions],
        "now": f.loop.now(),
    }


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fleet_runs_as_the_reference(aligned, name):
    want = outcome(*SCENARIOS[name](package("repro")))
    got = outcome(*SCENARIOS[name](package("repro_torch")))
    assert got == want
    assert all(r[0] == "finished" for r in got["requests"])
    if name == "end_to_end":
        assert got["pool"][0] == 8
    if name in ("intent_rule", "role_balancer"):
        assert got["actions"]


def test_session_transfers_land_as_the_reference(aligned):
    """``KVTransferManager.transfer`` (reactive and proactive) and the
    session directory deliver at the same virtual times."""
    log = {}
    for root in ("repro", "repro_torch"):
        pk = package(root)
        loop = pk.EventLoop()
        cm = pk.CostModel(pk.get_config("hymba-1.5b"))
        d = pk.kvt.SessionDirectory()
        kvx = pk.kvt.KVTransferManager(loop, d, bytes_fn=cm.kv_transfer_bytes)
        seen = []
        for i in range(4):
            d.ensure(f"s{i}", "a")
            d.grow(f"s{i}", 500 * (i + 1))
            loop.call_at(0.01 * i, lambda i=i: seen.append(("sent", i, kvx.transfer(
                f"s{i}", "a", "b" if i % 2 else "c", proactive=i == 3,
                on_done=lambda i=i: seen.append(("done", i, loop.now()))))))
        loop.run_until(5.0)
        log[root] = (seen, kvx.transfers, kvx.bytes_moved,
                     [kvx.wait_time(f"s{i}", "b") for i in range(4)],
                     {s: (r.instance, r.context_len, r.ready_at)
                      for s, r in d.records.items()})
    assert log["repro_torch"] == log["repro"]
    assert math.isfinite(log["repro"][0][-1][2])
