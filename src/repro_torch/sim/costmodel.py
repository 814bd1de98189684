"""Roofline-derived engine cost model, priced for one NVIDIA H100 SXM.

Step latencies for the sim engine come from a three-term roofline:

    t_step = max(FLOPs / (chips·peak), bytes / (chips·hbm_bw)) + overhead

Two calibration entry points close the loop between this analytic form
and the card:

* ``from_dryrun`` rescales the analytic FLOPs with a dry-run artifact's
  compiled/model FLOPs ratio (static: what the compiler built);
* ``from_calibration`` loads a ``CALIB_*.json`` artifact written by
  ``chip_smoke.py``'s calibrate phase -- ``flops_scale`` /
  ``bytes_scale`` / ``step_overhead`` least-squares-fitted to *measured*
  step times of ``models.prefill`` and of ``models.decode_step``
  replayed as a CUDA graph (dynamic: what the card ran; see
  sim/calibration.py).

The device figures are module attributes that the cost functions and the
calibration fit read when they run, so a caller may set them (the parity
tests set them to another package's).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from repro_torch.configs.base import ModelConfig

PEAK_FLOPS = 989e12        # bf16 FLOP/s, dense (NVIDIA H100 SXM data sheet)
HBM_BW = 3.35e12           # B/s HBM3 (NVIDIA H100 SXM data sheet)
# B/s of a copy from pinned host memory into device memory: the host
# tier's inject that chip_smoke.py's serve control phase measured, 512.5
# MiB in 14.716 ms, on an NVIDIA H100 80GB HBM3 at a 700 W power limit
# (PERF.md)
HOST_BW = 36.52e9
# s of fixed cost per engine step: the step_overhead of the agent-7b fit
# (chip_smoke.py's calibrate phase) on an NVIDIA H100 80GB HBM3 at a
# 700 W power limit (PERF.md)
STEP_OVERHEAD = 9.80917e-3
BYTES_PER_PARAM = 2        # bf16 weights


@dataclass
class CostModel:
    cfg: ModelConfig
    chips: int = 1
    # measured / roofline time on the compute branch, fitted by
    # sim/calibration.py to the card's step times (or a dry-run's
    # compiled / model FLOPs ratio)
    flops_scale: float = 1.0
    bytes_scale: float = 1.0      # the same on the memory branch
    # per-step fixed cost (s); None takes the module's STEP_OVERHEAD
    step_overhead: Optional[float] = None

    def __post_init__(self):
        if self.step_overhead is None:
            self.step_overhead = STEP_OVERHEAD

    # -- static quantities ---------------------------------------------------
    def n_params(self) -> int:
        from repro_torch.models import param_count
        return param_count(self.cfg)

    def n_active_params(self) -> int:
        """MoE: only top_k (+shared, +dense-residual) experts per token."""
        cfg = self.cfg
        if cfg.n_experts == 0:
            return self.n_params()
        from repro_torch.models import param_count
        dense_equiv = cfg.replace(
            n_experts=cfg.top_k, top_k=cfg.top_k)
        return param_count(dense_equiv)

    def kv_bytes_per_token(self) -> int:
        cfg = self.cfg
        if cfg.family == "ssm":
            return 0  # constant-size state, no per-token growth
        per_layer = 2 * cfg.n_kv_heads * cfg.d_head * BYTES_PER_PARAM
        n_kv_layers = cfg.n_layers
        return per_layer * n_kv_layers

    def state_bytes(self) -> int:
        """Constant-size recurrent state (SSM/hybrid archs)."""
        cfg = self.cfg
        if cfg.family == "ssm":
            d_inner = cfg.ssm_expand * cfg.d_model
            dh = d_inner // max(cfg.n_heads, 1)
            return cfg.n_layers * cfg.n_heads * dh * (dh + 1) * 4
        if cfg.family == "hybrid":
            d_inner = cfg.ssm_expand * cfg.d_model
            return cfg.n_layers * d_inner * cfg.ssm_state * 4
        return 0

    def kv_transfer_bytes(self, context_len: int) -> int:
        """Bytes moved when migrating a request's decode state — bounded by
        the window for SWA layers (the controller's Fig-7 policy consumes
        this: SSM state is ~free to move, 500k dense KV is not)."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return self.state_bytes()
        eff = context_len
        if cfg.window > 0 and not cfg.local_global_ratio:
            eff = min(context_len, cfg.window)
        return self.kv_bytes_per_token() * eff + self.state_bytes()

    def handoff_time(self, context_len: int, bandwidth: float = 12.5e9,
                     latency: float = 1.0e-3, overlap_s: float = 0.0) -> float:
        """Critical-path cost of a prefill→decode KV handoff.  The raw
        transfer moves ``kv_transfer_bytes(context_len)`` over the
        interconnect; ``overlap_s`` is the window the transfer ran
        concurrently with something useful (chunk-streamed handoffs
        overlap the tail of prefill), so only the non-overlapped
        remainder — floored at one link latency — is exposed to TTFT.
        Role-balancing policies consume this number when deciding
        whether flipping an engine's role pays."""
        raw = self.kv_transfer_bytes(context_len) / bandwidth + latency
        return max(raw - overlap_s, latency)

    def offload_time(self, context_len: int,
                     bandwidth: Optional[float] = None,
                     latency: float = 0.5e-3) -> float:
        """HBM→host spill of a suspended sequence's KV over the host
        link (``HOST_BW`` by default).  Off the critical path (the slot
        is already released when the copy runs), but OffloadPolicy
        charges it when deciding whether a suspend pays for itself."""
        bw = HOST_BW if bandwidth is None else bandwidth
        return self.kv_transfer_bytes(context_len) / bw + latency

    def restore_time(self, context_len: int,
                     bandwidth: Optional[float] = None,
                     latency: float = 0.5e-3) -> float:
        """Host→HBM refill on resume — the post-tool TTFT tax a warm
        restore pays instead of a full recompute prefill."""
        bw = HOST_BW if bandwidth is None else bandwidth
        return self.kv_transfer_bytes(context_len) / bw + latency

    # -- step times -----------------------------------------------------------
    def _roofline(self, flops: float, bytes_: float) -> float:
        t_c = flops * self.flops_scale / (self.chips * PEAK_FLOPS)
        t_m = bytes_ * self.bytes_scale / (self.chips * HBM_BW)
        return max(t_c, t_m) + self.step_overhead

    def prefill_cost(self, prompt_tokens: int, batch: int = 1,
                     context: int = 0) -> tuple[float, float]:
        """Analytic (FLOPs, bytes) of one prefill step — the unscaled
        quantities the calibration fit regresses measured times onto."""
        n = self.n_active_params()
        toks = prompt_tokens * batch
        flops = 2.0 * n * toks
        # attention term (quadratic unless windowed); keys span the
        # resident context plus the new tokens
        cfg = self.cfg
        s_eff = context + prompt_tokens
        if cfg.window > 0:
            s_eff = min(s_eff, cfg.window)
        attn_flops = (4.0 * cfg.n_layers * cfg.n_heads * cfg.d_head
                      * prompt_tokens * s_eff * batch)
        bytes_ = (n * BYTES_PER_PARAM
                  + (toks + context * batch) * self.kv_bytes_per_token())
        return flops + attn_flops, bytes_

    def prefill_time(self, prompt_tokens: int, batch: int = 1,
                     context: int = 0) -> float:
        """Time to prefill ``prompt_tokens`` *new* tokens.  ``context`` is
        KV already resident (a cached shared prefix, or earlier chunks of
        a chunked prefill): it is not recomputed, but the new tokens
        attend over it, so it contributes attention FLOPs and KV reads —
        this is what makes prefix-cache savings hardware-honest rather
        than free."""
        return self._roofline(*self.prefill_cost(prompt_tokens, batch,
                                                 context))

    def decode_cost(self, batch: int,
                    mean_context: float) -> tuple[float, float]:
        """Analytic (FLOPs, bytes) of one decode step."""
        n = self.n_active_params()
        flops = 2.0 * n * batch
        cfg = self.cfg
        ctx = mean_context
        if cfg.window > 0 and not cfg.local_global_ratio:
            ctx = min(mean_context, cfg.window)
        # attention FLOPs over the resident context — symmetric with
        # prefill_cost's attention term (one new token, s_eff = ctx);
        # without it only the KV-read *bytes* were charged, so a
        # compute-bound long-context decode was mispriced as flat
        if cfg.family != "ssm":
            flops += 4.0 * cfg.n_layers * cfg.n_heads * cfg.d_head \
                * ctx * batch
        kv_read = batch * ctx * self.kv_bytes_per_token()
        bytes_ = n * BYTES_PER_PARAM + kv_read + batch * self.state_bytes()
        return flops, bytes_

    def decode_time(self, batch: int, mean_context: float) -> float:
        return self._roofline(*self.decode_cost(batch, mean_context))

    def mixed_cost(self, prefill_tokens: int, context: int, batch: int,
                   mean_context: float) -> tuple[float, float]:
        """Analytic (FLOPs, bytes) of one *mixed* step: a prefill chunk
        co-running with ``batch`` decode slots in a single fused forward.
        FLOPs add; bytes add MINUS one full weight read — the fusion
        saving that makes mixed batching cheaper than a prefill step
        plus a decode step run back to back (the weights stream through
        the chip once, amortized over both workloads)."""
        pf_f, pf_b = self.prefill_cost(prefill_tokens, context=context)
        if batch <= 0:
            return pf_f, pf_b
        dc_f, dc_b = self.decode_cost(batch, mean_context)
        weight_read = self.n_active_params() * BYTES_PER_PARAM
        return pf_f + dc_f, pf_b + dc_b - weight_read

    def mixed_time(self, prefill_tokens: int, context: int, batch: int,
                   mean_context: float) -> float:
        return self._roofline(*self.mixed_cost(prefill_tokens, context,
                                               batch, mean_context))

    def call_time(self, prompt_tokens: int, new_tokens: int,
                  context: int = 0, batch: int = 1) -> float:
        """Estimated end-to-end time of one agent call: prefill the
        prompt, then decode ``new_tokens`` one step each at the mean
        context reached while generating.  The workflow graph plane uses
        this as the per-stage cost when deriving critical-path
        priorities and edge-propagated deadlines — an *estimate* (real
        steps batch with co-resident requests), but the relative stage
        weights are what the scheduler needs."""
        t = self.prefill_time(prompt_tokens, batch=batch, context=context)
        mean_ctx = context + prompt_tokens + new_tokens / 2.0
        return t + new_tokens * self.decode_time(batch, mean_ctx)

    # -- calibration -----------------------------------------------------------
    @classmethod
    def from_dryrun(cls, cfg: ModelConfig, chips: int,
                    artifact: Optional[Path]) -> "CostModel":
        """Static calibration: rescale analytic FLOPs by a dry-run
        artifact's compiled/model FLOPs ratio (its ``flops`` over its
        ``model_flops``)."""
        cm = cls(cfg, chips)
        if artifact and Path(artifact).exists():
            data = json.loads(Path(artifact).read_text())
            model_flops = data.get("model_flops")
            hlo_flops = data.get("flops")
            if model_flops and hlo_flops and model_flops > 0:
                cm.flops_scale = max(1.0, hlo_flops / model_flops)
        return cm

    @classmethod
    def from_calibration(cls, cfg: ModelConfig, chips: int,
                         artifact: Optional[Path]) -> "CostModel":
        """Measured calibration: load the fitted ``flops_scale`` /
        ``bytes_scale`` / ``step_overhead`` from a ``CALIB_*.json``
        artifact (``chip_smoke.py``'s calibrate phase).  Missing/invalid
        artifacts fall back to the module's roofline figures."""
        cm = cls(cfg, chips)
        if not artifact:
            return cm
        from repro_torch.sim.calibration import load_calibration
        calib = load_calibration(artifact)
        if calib is None:
            return cm
        cm.flops_scale = calib.flops_scale
        cm.bytes_scale = calib.bytes_scale
        cm.step_overhead = calib.step_overhead
        return cm


# the port's own fits: never the JAX package's directory or variable, so
# a fit of one device is never read by the other package
DEFAULT_CALIB_DIR = "artifacts/torch"
CALIB_DIR_ENV = "REPRO_TORCH_CALIB_DIR"


def costmodel_for(cfg: ModelConfig, chips: int = 1,
                  calib_dir=None) -> CostModel:
    """The one constructor sim engines should use: resolve the per-model
    measured-calibration artifact ``CALIB_{cfg.name}.json`` (written by
    ``chip_smoke.py``'s calibrate phase) under ``calib_dir``, the
    ``REPRO_TORCH_CALIB_DIR`` environment variable, or
    ``artifacts/torch``, and build the CostModel from it.
    Missing/invalid artifacts fall back to the analytic roofline
    figures, so sims stay runnable on a fresh checkout."""
    import os
    if calib_dir is None:
        calib_dir = os.environ.get(CALIB_DIR_ENV, DEFAULT_CALIB_DIR)
    artifact = Path(calib_dir) / f"CALIB_{cfg.name}.json"
    return CostModel.from_calibration(cfg, chips, artifact)
