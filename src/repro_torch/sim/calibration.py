"""Measured calibration of the roofline CostModel.

``chip_smoke.py``'s calibrate phase times the step programs the live
engine dispatches -- ``models.prefill`` on a fresh ring cache, and
``models.decode_step`` replayed as a CUDA graph as ``TorchEngine``
replays decode -- across a (batch × context) grid, pairs each
measurement with the analytic (FLOPs, bytes) that
``CostModel.prefill_cost`` / ``decode_cost`` charge for that shape, and
this module fits the three roofline free parameters

    t = max(flops_scale · t_c, bytes_scale · t_m) + step_overhead

by alternating least squares: classify every point compute- or
memory-bound under the current scales, solve the resulting *linear*
system (weighted by 1/measured so small decode steps count as much as
big prefills), re-classify, repeat to a fixed point.  ``t_c`` and
``t_m`` use the cost model's ``PEAK_FLOPS`` and ``HBM_BW``, read when
the fit runs.  The fitted ``Calibration`` round-trips through
``CALIB_*.json`` artifacts that ``CostModel.from_calibration`` loads --
closing the loop between the sim plane's predictions and what the card
(or the CPU) really ran.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from repro_torch.sim import costmodel

CALIB_VERSION = 1

# Fit-quality gates declared in the artifact (a "cuda" backend takes the
# gpu band): step times measured on the card are stable enough for a
# tight band; CPU timings (the CPU rehearsal) jitter more and go
# superlinear at larger shapes (cache effects the roofline's max() cannot
# express), so the cpu gate is looser rather than flaky -- it validates
# the plumbing.
TOLERANCE = {"gpu": 0.35, "cpu": 0.75}


@dataclass
class CalibrationPoint:
    """One measured grid point: a step shape, its analytic cost, and the
    wall-clock the step actually took."""

    kind: str              # "prefill" | "decode"
    batch: int
    context: int           # prompt length (prefill) / resident KV (decode)
    flops: float           # analytic FLOPs (CostModel.*_cost, unscaled)
    bytes: float           # analytic bytes moved
    measured_s: float      # measured wall-clock of one step


@dataclass
class Calibration:
    """Fitted roofline parameters + the evidence they were fitted to."""

    model: str
    chips: int
    backend: str           # device type of the measured step: "cuda" | "cpu"
    flops_scale: float
    bytes_scale: float
    step_overhead: float
    tolerance: float
    max_rel_err: float
    within_tolerance: bool
    points: list[CalibrationPoint] = field(default_factory=list)

    def predict(self, p: CalibrationPoint) -> float:
        t_c = p.flops * self.flops_scale / (self.chips
                                            * costmodel.PEAK_FLOPS)
        t_m = p.bytes * self.bytes_scale / (self.chips * costmodel.HBM_BW)
        return max(t_c, t_m) + self.step_overhead

    def rel_errors(self) -> list[float]:
        return [abs(self.predict(p) - p.measured_s) / max(p.measured_s, 1e-12)
                for p in self.points]


# ---------------------------------------------------------------------------
# Fitting
# ---------------------------------------------------------------------------
def fit_roofline(points: Sequence[CalibrationPoint], chips: int = 1,
                 max_iters: int = 64) -> tuple[float, float, float]:
    """Fit (flops_scale, bytes_scale, step_overhead) to measured points.

    The roofline is piecewise-linear in the parameters once each point's
    binding resource is known, so we alternate: assign each point to the
    compute or memory branch under the current scales, weighted-least-
    squares the now-linear model (weights 1/measured ⇒ relative-error
    objective), and iterate until the assignment is a fixed point.
    """
    if not points:
        return 1.0, 1.0, 0.0
    t_c = np.array([p.flops / (chips * costmodel.PEAK_FLOPS)
                    for p in points])
    t_m = np.array([p.bytes / (chips * costmodel.HBM_BW) for p in points])
    y = np.array([p.measured_s for p in points])
    w = 1.0 / np.maximum(y, 1e-12)          # relative-error weighting
    fs, bs, c = 1.0, 1.0, 0.0
    assign = t_c >= t_m                     # start from the raw roofline

    def solve(mask: np.ndarray) -> tuple[float, float, float]:
        cols = [np.where(mask, t_c, 0.0), np.where(~mask, t_m, 0.0),
                np.ones_like(y)]
        a = np.stack(cols, axis=1) * w[:, None]
        sol, *_ = np.linalg.lstsq(a, y * w, rcond=None)
        if sol[2] < 0.0:                    # overhead can't be negative:
            sol, *_ = np.linalg.lstsq(a[:, :2], y * w, rcond=None)
            sol = np.array([sol[0], sol[1], 0.0])
        return float(sol[0]), float(sol[1]), float(sol[2])

    for _ in range(max_iters):
        nfs, nbs, nc = solve(assign)
        # a branch with no assigned points is unconstrained by the data —
        # keep its previous scale instead of trusting lstsq's null answer
        if assign.any():
            fs = max(nfs, 1e-12)
        if (~assign).any():
            bs = max(nbs, 1e-12)
        c = max(nc, 0.0)
        new_assign = fs * t_c >= bs * t_m
        if bool(np.all(new_assign == assign)):
            break
        assign = new_assign
    return fs, bs, c


def calibrate(model: str, backend: str,
              points: Sequence[CalibrationPoint], chips: int = 1,
              tolerance: Optional[float] = None) -> Calibration:
    """Fit + evaluate: returns a Calibration whose ``within_tolerance``
    says whether every grid point's prediction landed inside the band."""
    fs, bs, c = fit_roofline(points, chips)
    band = "gpu" if backend == "cuda" else backend
    tol = TOLERANCE.get(band, TOLERANCE["cpu"]) \
        if tolerance is None else tolerance
    calib = Calibration(model=model, chips=chips, backend=backend,
                        flops_scale=fs, bytes_scale=bs, step_overhead=c,
                        tolerance=tol, max_rel_err=0.0,
                        within_tolerance=True, points=list(points))
    errs = calib.rel_errors()
    calib.max_rel_err = max(errs) if errs else 0.0
    calib.within_tolerance = calib.max_rel_err <= tol
    return calib


# ---------------------------------------------------------------------------
# Artifact I/O
# ---------------------------------------------------------------------------
def save_calibration(calib: Calibration, path: Path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"version": CALIB_VERSION, **asdict(calib)}
    path.write_text(json.dumps(payload, indent=2) + "\n")
    return path


def load_calibration(path) -> Optional[Calibration]:
    """Load a CALIB_*.json; None for missing/invalid/unknown-version
    artifacts so callers fall back to the analytic constants."""
    path = Path(path)
    if not path.exists():
        return None
    try:
        data = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return None
    if data.get("version") != CALIB_VERSION:
        return None
    try:
        points = [CalibrationPoint(**p) for p in data.get("points", [])]
        return Calibration(
            model=data["model"], chips=data["chips"],
            backend=data["backend"], flops_scale=data["flops_scale"],
            bytes_scale=data["bytes_scale"],
            step_overhead=data["step_overhead"],
            tolerance=data["tolerance"], max_rel_err=data["max_rel_err"],
            within_tolerance=data["within_tolerance"], points=points)
    except (KeyError, TypeError):
        return None
