#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises, so the exit
code is non-zero and the final JSON line is not printed:

1. device     -- needs CUDA; prints the card's name and power limit.
2. build      -- compiles every CUDA source of ``src/repro_torch/kernels/
                 csrc`` (one nvcc each, in parallel) into ``build/``.
3. kernels    -- each kernel (paged decode, flash, ring decode, SSM scan,
                 grouped matmul) against its plain PyTorch version on the
                 card, in f32 and bf16, at agent-7b's, hymba-1.5b's,
                 arctic-480b's and kimi-k2's heads and expert shapes, the
                 attention kernels also at head dim 120 with groups 6, 12
                 and 16, which no config combines, and at the shapes the
                 reference pads (ROADMAP A7): Gemma 3 12B's and 4B's heads
                 (dh 256), Llama 3.2 3B's (G 3), dh 100 and 48 query
                 heads over 1, each timed beside SDPA; the SSM scan at
                 mLSTM's width (dk 512, dv 513); with its time at
                 the main path's shapes, the plain version's, a PyTorch
                 library call's where one exists, and its bound; and
                 grouped matmul's unit shapes and split of d timed
                 against each other; ring decode with its log-sum-exp
                 over a slot range and attention_combine (a
                 sequence-sharded ring's ranks), held to their plain
                 versions and timed at llama3-405b's decode_32k rank
                 shape with their bounds; paged flash (suffix prefill and
                 the mixed step's chunk: 512 rows at 1024, 8 of them pad
                 rows, at agent-7b's, gemma3-27b's windowed, kimi-k2's,
                 arctic's and Gemma 3 12B's heads, pages of 16, dh 512
                 and dh 100), each timed beside its plain version, the
                 gather path it replaces and SDPA over the gathered K/V.
4. parity     -- agent-7b width at 2 layers in f32: TorchEngine's greedy
                 tokens are equal across the paged layout with and
                 without its kernel and the ring layout with and without
                 its kernels, also for a sliding window whose ring wraps.
5. migrate    -- the same model: ring->paged, paged->ring and ring->ring
                 migration continue with an unmigrated run's tokens;
                 paged->ring with a window is refused.
14. mixed parity -- (after 5) the same model, paged: the mixed step
                 replayed as a CUDA graph gives the serialized eager run's
                 greedy tokens, kernels on and off, over two waves (the
                 second over one 256-token prefix, after a prefill_chunk
                 move), also with a PrefixCache attached; the mixed step
                 is captured once, its warm-up under sync debug "error".
17. control parity -- (after 14) the same model, paged (serialized and
                 mixed) and ring: a request pinned in its slot, or
                 offloaded to pinned host memory and resumed or migrated
                 to a sibling engine, while another decodes beside it,
                 continues with an unsuspended run's greedy tokens.
6. serve      -- agent-7b in full (32 layers, bf16), paged layout, serves
                 8 requests; the paged decode kernel launches once per
                 layer per decode step, paged flash once per layer per
                 prefill chunk; a profile of four decode steps follows.
7. serve ring -- the same weights and requests on the ring layout: the
                 flash kernel launches once per layer per prefill, the
                 ring decode kernel once per layer per decode step, and
                 the paged kernel never; profiles of four decode steps
                 and of the longest prompt's prefill follow.
15. serve mixed -- (after 7) the same weights, paged, mixed, prefill_chunk
                 512, a PrefixCache: the 8 requests, then 8 over one
                 1024-token system prompt with 64-256-token suffixes;
                 prefill tokens computed against the uncached count, step
                 times, profiles of decode and mixed steps (the mixed
                 step's attention share: paged flash and paged decode).
18. serve control -- (after 15) the same weights on two paged mixed
                 engines, llm-0 and llm-1, under the control plane: 16
                 requests (every third INTERACTIVE) on llm-0, a Registry,
                 a Collector -> CentralPoller -> StateStore metrics plane,
                 a Controller ticking serve_llm's intent between steps
                 (admit_priority_min and the captured mixed step's
                 prefill_chunk set and reset), a Tracer on both engines;
                 requests 0 and 1 pinned and 2 and 3 offloaded to pinned
                 host memory after 16 tokens, held 24 steps, then 0-2
                 resumed and 3 migrated to llm-1.  Every request
                 finishes, the pinned slots' pos holds, the offload frees
                 device memory, one capture per step kind per engine,
                 the expected action log, exact launch counts; graph and
                 eager runs with equal tokens, and an unsuspended run
                 each resumed request's tokens are counted against.
25. calibrate  -- (after 18) the same weights: the port's twin of
                 benchmarks/calibrate.py's measuring loop: models.prefill
                 at 64-512 tokens on a fresh ring cache (flash), and
                 models.decode_step at (batch, context) (1, 128) to (8,
                 1024) on a full ring replayed as a CUDA graph (ring
                 decode), medians of 5 synchronized reps; the port's
                 calibrate(backend="cuda") fits flops_scale, bytes_scale
                 and step_overhead, one line per point and the fit
                 (max_rel_err against the gpu band 0.35: a miss is
                 printed, not failed); CALIB_agent-7b.json under
                 chiprun_out/, read back through costmodel_for; exact
                 launches.  Then agent-1b's fit, the workflow's small tier.
26. serve disagg -- (after 25) the reference's DisaggPool over two live
                 agent-7b paged engines, a prefill-role and a decode-role
                 one, a KVTransferManager on an EventLoop: the 8 serve
                 requests, 64 new tokens; greedy tokens equal a unified
                 paged engine's, 8 handoffs, each state in pinned host
                 memory, the decode engine's graph replayed; extract and
                 inject ms and GB/s per handoff.
27. sim on the card's fit -- the quickstart AgenticPipeline and the
                 workflow example's WorkflowPipeline (the port's example
                 twins) with every SimEngine priced by phase 25's fits:
                 tasks done, engine steps, latency percentiles (simulated
                 time at the costs fitted on the card).
8. hymba      -- hymba-1.5b width at 3 layers in f32 on the ring layout:
                 greedy tokens equal with and without the kernels, for
                 full attention and a window whose ring wraps, prompts
                 longer than 128 and ragged; ring->ring migration with
                 the SSM state continues an unmigrated run's tokens.
9. serve hymba -- hymba-1.5b in full (32 layers, bf16), ring layout,
                 serves 8 requests: flash and the SSM scan launch once
                 per layer per prefill, ring decode once per layer per
                 decode step; profiles of decode and of a prefill follow.
10. parity arctic -- arctic-480b width at 1 layer in f32 (128 experts,
                 top-2, a dense residual MLP): greedy tokens equal across
                 both layouts with and without their kernels, full
                 attention and a window whose ring wraps.
11. serve arctic -- arctic-480b at 2 of its 35 layers, bf16, serves 8
                 requests in the paged and then the ring layout:
                 grouped_matmul launches three times per MoE layer per
                 forward, the attention kernels as for agent-7b; then 16
                 tokens each with the kernels off, where every expert
                 product reads all 128 experts; each with a profile.
16. serve mixed arctic -- (after 11) phase 15's run at arctic's 2
                 layers: grouped_matmul inside the replayed mixed graphs.
12. parity kimi -- kimi-k2 width at 1 layer in f32 (its dense first
                 layer; attention at head dim 112, G = 8): greedy tokens
                 equal across both layouts with and without their kernels,
                 full attention and a window whose ring wraps.
13. serve kimi -- kimi-k2 at 2 of its 61 layers, bf16 (the dense layer and
                 an MoE layer of 384 experts, top-8, a shared expert),
                 serves 8 requests in the paged and then the ring layout
                 with exact launch counts of all four kernels it runs;
                 each with a profile.
19. new paths  -- each kernel on the paths of the architectures below
                 against its plain version, f32 and bf16: both decode
                 kernels and causal flash at gemma3-27b's, h2o-danube-3's,
                 llama3-405b's, command-r-plus's and qwen2-vl's heads;
                 flash non-causal at seamless-m4t's encoder (T = 1000)
                 and cross prefill; ring decode as a decode step's cross
                 attention; the SSM scan at an xlstm-350m mLSTM layer's
                 inputs (dk 512, dv 513).
20. parity    -- one layer at each of those widths in f32 (gemma3: one
                 local and one global; xlstm: one mLSTM and one sLSTM),
                 and at Gemma 3 12B's (2 layers) and Llama 3.2 3B's (1)
                 widths: greedy tokens equal across both layouts (ring
                 only for xlstm) with and without the kernels, and graph
                 and eager.
21. serve xlstm -- xlstm-350m at 8 of its 24 layers (one whole 7:1 cycle,
                 bf16), ring layout, 8
                 requests: the SSM scan launches once per mLSTM layer per
                 prefill; a prefill profile gives the scan's and the
                 sLSTM layers' shares.
22. serve qwen2-vl -- qwen2-vl-2b in full (28 layers, bf16; M-RoPE's
                 3-axis positions): paged, ring and serve mixed; then at
                 the model level a prefill of 256 patch embeddings at
                 (t, h, w) positions and 16 decode steps, kernels on
                 against off: greedy tokens equal in f32 at 2 layers, and
                 at full depth in bf16 every kernel call held to its
                 plain version on the path's inputs (a random-init stack
                 amplifies rounding layer by layer, so a deep stack's
                 tokens are not comparable).
23. serve dense -- gemma3-27b in full (62 layers, 56.8 GB bf16; 128 pages,
                 1536-slot rings), h2o-danube-3-4b in full (24 layers),
                 llama3-405b and command-r-plus-104b at 2 layers: paged
                 and ring.
24. encdec    -- seamless-m4t-large-v2 in full (24 + 24 layers) at the
                 model level: encode 8 x 1000 frames, prefill, 64 decode
                 steps, kernels on against off: greedy tokens equal in
                 f32 at 1 + 1 layers, every kernel call held at full
                 depth in bf16, as phase 22.
39. wide heads -- (after 24) the shapes the reference pads, at full
                 width: Gemma 3 12B's (dh 256, G 2; gemma3-27b with its
                 widths, 6 of 48 layers) and Llama 3.2 3B's (G 3;
                 llama3-405b with its widths, 4 of 28 layers), bf16,
                 kernels on: 8 requests paged, ring and mixed, the eager
                 runs' every attention kernel call held to its plain
                 version; a remat train step at 2 layers, B 1 x S 4096,
                 every flash forward and backward call held.

28. flash backward -- (in 3) the backward kernels (LSE from the forward,
                 dq, dk, dv) against the plain version's autograd in f32
                 and bf16 at agent-7b's, gemma3's windowed, danube's dh
                 120, llama3's G 16 and command-r's G 12 heads, a ragged
                 S, dh 32 and 64, rows with no valid key and non-causal,
                 each output within 2e-5 / 2e-2 of its largest
                 magnitude; timed against SDPA's backward and the bound.
29. train parity -- (after 24) agent-7b's width at 2 layers, f32 and bf16:
                 loss and every gradient leaf with the kernels on against
                 off, every flash call held to its plain version, then
                 one make_train_step with f32 and one with int8 moments
                 (the same parameters after one step).
30. train     -- agent-7b in full (32 layers, bf16, remat, int8 moments),
                 B 2 x S 4096 from the token pipeline: a warm-up and 4
                 timed steps, exact launch counts (64 forwards and 32
                 backwards a step), every leaf changed, the first and
                 last layer's backward held to the plain one, tokens/s,
                 the model-FLOPs share of the bf16 peak, peak memory and
                 one profiled step; then the dry run's step pass of the
                 same step (meta tensors on the host, a world of one):
                 its MemTracker peak within 10% of max_memory_allocated,
                 its counted kernel calls equal to a step's launches.
31. train agent-1b -- full depth, two microbatches of B 1 x S 4096, f32
                 moments and accumulators: step ms and peak memory.
32. train_lm  -- the train_lm twin at lm-100m, 75 steps with --chaos and
                 once uninterrupted, under deterministic algorithms: one
                 restart, equal losses bit for bit, the twin's gain.
33. kernels backward -- (after 3) the grouped_matmul backward (dX, dW) at
                 arctic-480b's and kimi-k2's expert shapes, decode and
                 training capacities, counts of 0, C and ragged, f32 and
                 bf16, and the ssm_scan backward (dq, dk, dv, dlog_a,
                 dh0) at hymba's training scan and mLSTM's width, a ragged
                 T, a non-zero h0 and a gradient of h_T: each output
                 within 2e-5 (1e-4 the scan) / 2e-2 of its largest
                 magnitude against the plain version's autograd, two runs
                 equal bit for bit; timed against the bound and (the
                 grouped matmul) two bmm calls.
34. train parity families -- (after 32) arctic-480b's width at 1 layer
                 with 16 experts, kimi-k2's at 2 layers with 16, hymba at
                 3, xlstm with one mLSTM and one sLSTM layer, qwen2-vl at
                 2, seamless at 1 + 1, f32: loss and every gradient leaf,
                 kernels on against off, exact launches, every
                 grouped_matmul and ssm_scan call (forward and backward)
                 held to its plain version; one make_train_step each.
35. train moe -- arctic-480b at full width, 1 of 35 layers, bf16, remat,
                 B 1 x S 4096: the gradient at all 128 experts (exact
                 launches, live experts' gradients non-zero, backward
                 calls held on a slice of the experts, peak memory), then
                 make_train_step with int8 moments at 64 experts.
36. train ssm -- hymba-1.5b in full, B 2 x S 4096, and xlstm-350m at 8 of
                 its 24 layers (one 7:1 cycle), B 4 x S 512: bf16,
                 remat, f32 moments, a warm-up and two
                 timed steps, exact launches, tokens/s, peak memory; then
                 one profiled hymba step: the ssm_scan backward's device
                 time and its share of the step.
37. train vlm encdec -- qwen2-vl-2b in full, B 2 x S 4096 with 256 patch
                 embeddings a row at (t, h, w) positions, and
                 seamless-m4t-large-v2 in full, B 2 x 1000 frames x 1024
                 tokens: as 36.
38. sharded   -- the launch layer over torch.distributed.  (a) A world
                 of one over NCCL, make_mesh((1, 1)), agent-7b in full,
                 bf16, kernels on: make_prefill_step and make_serve_step
                 over 8 sequences give transformer.prefill's and
                 decode_step's logits bit for bit, and one
                 make_train_step(cfg, mesh) step at B 2 x S 4096 with int8
                 moments gives the mesh-less step's parameters, moments
                 and metrics bit for bit.  (b) Two gloo ranks spawned on
                 the one card (NCCL refuses two ranks on one device), f32,
                 kernels on, mesh (1, 2): agent-7b's width at 2 layers
                 (TP) and arctic's at 1 layer with 8 experts (EP); prefill
                 and 16 greedy tokens equal the unsharded run's, one train
                 step's loss and every gradient leaf within phase 29's
                 bands, every kernel call on a rank's shards held to its
                 plain version, each kernel's launches printed.  (c) The
                 same ranks on (2, 1), DP + FSDP, agent-7b's width at 2
                 layers: the train-step check; (c') the same, B 2 in 2
                 microbatches of one row (rank 1 holds none and
                 launches nothing), and at arctic's width.  (d) The same
                 ranks serve
                 over a ring whose sequence axis the cache spec cuts over
                 model (the GQA fallback), agent-7b's width at 2 layers
                 with 16 query heads over one KV head (G 16, as each
                 rank of llama3-405b's fallback decodes), a 200-token
                 prompt over 2 x 164 slots;
                 (e) on (2, 1) a long-named decode shape, agent-7b's
                 width at 2 layers, B 1, a 2100-token prompt prefilled on
                 one device and cut into 2 x 2048 slots (the weights
                 whole on each rank: rules without FSDP, which over
                 gloo would take 42 s): 16 greedy tokens
                 each equal the unsharded run's, every ring decode (with
                 its log-sum-exp) and attention_combine call on a shard
                 within the f32 band of its plain version, both kernels
                 launched on every rank.  (f) The same ranks on (1, 2),
                 tensor parallelism over model of the other families at
                 full width and cut depth: hymba-1.5b at 2 layers (its
                 rings cut over model under whole query heads, so ring
                 decode's log-sum-exp and attention_combine run),
                 xlstm-350m as one mLSTM and one sLSTM layer, qwen2-vl-2b
                 at 1 layer with patch embeddings and M-RoPE positions,
                 seamless-m4t-large-v2 at 1 + 1 layers with frames: (b)'s
                 serve and train checks, and each config's kernels
                 (flash and its backward, ring decode, ssm_scan and its
                 backward, attention_combine) launched on both ranks.
                 In (b), (c) and (f) every rank holds its own gradient
                 shards to the unsharded model's.  (b) and (f) train
                 sequence parallel (``act_sharding``: each rank keeps
                 its S / 2 rows of the residual stream between blocks),
                 and each rank prints what remat kept at the layer
                 boundaries (measured with saved_tensors_hooks), 1/2 of
                 the whole-S figure beside it (computed), and
                 max_memory_allocated over the train step; (c) has no
                 model axis to cut over and keeps S whole.  (g) On
                 (2, 1) a long-named decode shape, seamless-m4t-large-v2
                 at full width, 1 + 1 layers, B 1, (e)'s ring and prompt:
                 the cross K/V cut along its 992 encoder positions over
                 data, 15 greedy steps equal the unsharded run's, every
                 ring decode (with its log-sum-exp) and attention_combine
                 call held to its plain version.  (b) to (g) times are
                 two processes sharing one card, not a multi-GPU figure.
                 In (b), (c) and (c') each rank records the collectives of
                 its train step (kind, result bytes, group size, in
                 order); they equal those of the dry run's fake pass of
                 the same step as that rank (meta tensors, a fake world
                 of two), which this process runs while the ranks do, and
                 in (c') rank 0's in kind and group size.

Every engine phase (4 to 23, 39) replays its decode and mixed steps as
CUDA graphs, captured once per engine, and the serve phases (6, 7, 9,
11, 13, 15, 16, 21-23, 39) run each request set a second time on an eager
engine for its first 16 new tokens: those greedy tokens equal the graph
run's, and the mean step times of both are printed, with the profiles
of the graph runs and of agent-7b's eager runs (``EAGER_PROFILES``).  Each
phase's wall time is printed on a ``[time]`` line.  A launch count includes a capture's
eager warm-up runs and each replay (``serving/graphs.py``).  The last
two lines are a JSON object of kernel numbers and ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import io
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from repro_torch import models  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import params as prm  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.core import Tracer  # noqa: E402
from repro_torch.core.metrics import Collector  # noqa: E402
from repro_torch.core.types import Priority, Request, RequestState  # noqa: E402
from repro_torch.agents.pipeline import ServingFabric  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.examples import quickstart, train_lm, workflow  # noqa: E402
from repro_torch.examples.serve_llm import tick, wire  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.layers import rmsnorm  # noqa: E402
from repro_torch.models.moe import capacity  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import work  # noqa: E402
# the formulas' parts that tests/test_torch_chip_smoke.py reads here
from repro_torch.kernels.work import (flash_valid_keys,  # noqa: E402,F401
                                      stored_bytes)
from repro_torch.kernels.attention_combine import (  # noqa: E402
    attention_combine, attention_combine_plain)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_plain, decode_splits)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_backward, flash_attention_backward_plain,
    flash_attention_forward, flash_attention_lse_plain, flash_attention_plain)
from repro_torch.kernels.grouped_matmul import (  # noqa: E402
    grouped_matmul, grouped_matmul_backward, grouped_matmul_backward_plain,
    grouped_matmul_plain)
from repro_torch.kernels.grouped_matmul import (  # noqa: E402
    _launch_backward as gm_launch_backward)
from repro_torch.kernels.paged_decode_attention import (  # noqa: E402
    paged_decode_attention, paged_decode_attention_plain, paged_decode_splits)
from repro_torch.kernels.paged_flash_attention import (  # noqa: E402
    paged_flash_attention, paged_flash_attention_plain)
from repro_torch.kernels.paged_flash_attention import (  # noqa: E402
    live_rows as paged_live_rows, valid_counts as paged_valid_counts)
from repro_torch.kernels.ssm_scan import (  # noqa: E402
    ssm_scan, ssm_scan_backward, ssm_scan_backward_plain, ssm_scan_plain)
scan_mod = importlib.import_module("repro_torch.kernels.ssm_scan")
import torch.distributed as dist  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed import parallel  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import serve as serve_launch  # noqa: E402
from repro_torch.launch import specs as specs_launch  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.serve import (make_prefill_step,  # noqa: E402
                                      make_serve_step)
from repro_torch.launch.train import (AdamWConfig, TrainPlan,  # noqa: E402
                                      abstract_state, init_opt_state,
                                      make_train_step)
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.runtime.supervisor import (  # noqa: E402
    SimulatedFailure, SupervisorConfig, TrainSupervisor)
from repro_torch.optim.adamw import adamw_init  # noqa: E402
from repro_torch.serving import cache_utils  # noqa: E402
from repro_torch.serving.disagg import DisaggPool  # noqa: E402
from repro_torch.serving.engine import TorchEngine  # noqa: E402
from repro_torch.serving.engine_sim import SimEngine  # noqa: E402
from repro_torch.serving.graphs import WARMUP_RUNS, StepGraph  # noqa: E402
from repro_torch.serving.kv_transfer import (  # noqa: E402
    KVTransferManager, SessionDirectory)
from repro_torch.serving.prefix_cache import PrefixCache  # noqa: E402
from repro_torch.serving.scheduler import (SchedulerConfig,  # noqa: E402
                                           StepKind)
from repro_torch.sim import costmodel  # noqa: E402
from repro_torch.sim.calibration import (  # noqa: E402
    CalibrationPoint, calibrate, load_calibration, save_calibration)
from repro_torch.sim.clock import EventLoop  # noqa: E402
from repro_torch.sim.costmodel import costmodel_for  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12            # f32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # bf16 tensor cores, dense
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# ssm_scan in f32: the reference's own band for that kernel
# (tests/test_kernels.py:253), chunked and sequential sums differ in order
SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


@contextlib.contextmanager
def timed_phase(name: str):
    """A ``[time]`` line with the block's wall time."""
    t0 = time.perf_counter()
    yield
    log("time", f"{name}: {time.perf_counter() - t0:.1f} s")


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them ('a
    CPU' where there is no card, as in the CPU rehearsals)."""
    if not torch.cuda.is_available():
        return "a CPU"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# the stream is held ~100 us per timed call (at up to 2 GHz) while the
# host enqueues the calls
SLEEP_CYCLES_PER_CALL = 200_000


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls.  A
    sleep kernel holds the stream while the host enqueues them, so a
    kernel shorter than its wrapper's host overhead runs back to back
    and is not timed at the host's pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms3(fn, iters: int, warmup: int = 3) -> tuple[float, float]:
    """The median of three ``cuda_ms`` readings and their spread (the
    largest less the smallest), in ms."""
    xs = sorted(cuda_ms(fn, iters, warmup) for _ in range(3))
    return xs[1], xs[2] - xs[0]


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

# the main path's decode shapes: 8 slots, agent-7b heads (Hkv 8, G 4,
# dh 128), max_context 4096.  Rows 0-3 share a 1024-token prefix, rows 6
# and 7 are identical (their outputs must be bit-identical), row 5 is an
# inactive slot (ctx 0, all -1), and short rows carry -1 tails.
CTX = [4096, 4001, 2085, 1500, 777, 0, 3333, 3333]
SHARED_TOKENS = 1024


def ops_rate(dtype) -> float:
    return BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S


def bound_of(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    """The larger of the byte time at HBM rate and the operation time at
    the card's peak rate for ``dtype``, in ms, and which one it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_rate(dtype)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check(name: str, err: float, dtype, what: str, tol=None) -> None:
    tol = TOL[dtype] if tol is None else tol
    log("kernels", f"{name} {what}: max |kernel - plain| {err:.3e} "
        f"(tolerance {tol:.0e})")
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"({what}): {err} > {tol}")


# (Hkv, G, dh) of the served models' paged decode, then dh 120 (as
# h2o-danube-3's) with G 6 (qwen2-vl's), 12 (command-r-plus's) and 16
# (llama3-405b's), which no config combines; phase 19 takes each
# config's own heads
PAGED_HEADS = (8, 4, 128)                               # agent-7b
ARCTIC_PAGED_HEADS = (8, 7, 128)
KIMI_HEADS = (8, 8, 112)                                # kimi-k2: 7168 / 64
UNSERVED_HEADS = [(8, 6, 120), (8, 12, 120), (8, 16, 120)]
# the shapes the reference pads (ROADMAP A7), as (Hkv, G, dh): Gemma 3
# 12B's heads, Gemma 3 4B's, Llama 3.2 3B's (G 3), a head dim of 100 (not
# a multiple of 8) and StarCoder's multi-query 48 heads over 1
GEMMA12_HEADS = (8, 2, 256)
LLAMA3B_HEADS = (8, 3, 128)
WIDE_HEADS = [GEMMA12_HEADS, (4, 2, 256), LLAMA3B_HEADS, (8, 4, 100),
              (1, 48, 128)]
# heads past 256 (ROADMAP A7.1), in column blocks, as (Hkv, G, dh):
# agent-7b's width at d_head 512 (G 2), G 3 at dh 384, dh 300 (element by
# element in decode, padded to 304 in flash) and 16 query heads over 1 at
# 512; then a small shape at dh 1024, held in f32 and bf16 and not timed
PAST_HEADS = [(8, 2, 512), (4, 3, 384), (8, 4, 300), (1, 16, 512)]
DH1024_HEADS = (2, 2, 1024)


def kernel_case(dtype, page: int, gen: torch.Generator, dev,
                heads=PAGED_HEADS, ctx=None):
    """Pages and tables of the rows of contexts ``ctx`` (default CTX; rows
    0-3 share their first SHARED_TOKENS, rows 6 and 7 are one) at
    ``heads`` (Hkv, G, dh): agent-7b's (8, 4, 128) by default."""
    hkv, g, dh = heads
    ctx = CTX if ctx is None else ctx
    b, max_ctx = len(ctx), 4096
    p_max = max_ctx // page
    n_shared = SHARED_TOKENS // page
    rows, nxt = [], n_shared
    for r, c in enumerate(ctx):
        need = -(-c // page)
        if r == 7:
            rows.append(list(rows[6]))
            continue
        head = list(range(min(n_shared, need))) if r < 4 else []
        own = need - len(head)
        rows.append(head + list(range(nxt, nxt + own)))
        nxt += own
    n_pool = nxt + 1                                  # + the sink page
    perm = torch.randperm(nxt, generator=gen, device=dev).cpu().numpy()
    tables = np.full((b, p_max), -1, np.int32)
    for r, ids in enumerate(rows):
        tables[r, :len(ids)] = perm[ids]              # scattered pages
    q = torch.randn((b, 1, hkv * g, dh), generator=gen, device=dev)
    q[7] = q[6]
    kp = torch.randn((n_pool, page, hkv, dh), generator=gen, device=dev)
    vp = torch.randn((n_pool, page, hkv, dh), generator=gen, device=dev)
    return (q.to(dtype), kp.to(dtype), vp.to(dtype),
            torch.from_numpy(tables).to(dev),
            torch.tensor(ctx, dtype=torch.int32, device=dev))


def needed_keys(window: int) -> list[int]:
    return [min(c, window) if window > 0 else c for c in CTX]


def bound(args, window: int) -> tuple[float, str]:
    """Least time for this call: bytes it must move (K/V of the valid
    keys, q, out, tables, ctx) at HBM rate vs its f32 operations
    (``work.paged_decode``)."""
    q, kp, _, bt, ctx = args
    return bound_of(*work.paged_decode(q, kp, bt, ctx,
                                       sum(needed_keys(window))))


def sdpa_inputs(args, window: int):
    """The same attention as one dense call: K/V gathered into (B, H, T,
    dh) and a boolean mask.  Built outside the timed region."""
    q, kp, vp, bt, ctx = args
    b, _, h, dh = q.shape
    page, hkv = kp.shape[1], kp.shape[2]
    t = bt.shape[1] * page
    ids = bt.long().clamp(min=0)
    k = kp[ids].reshape(b, t, hkv, dh).transpose(1, 2)
    v = vp[ids].reshape(b, t, hkv, dh).transpose(1, 2)
    k = k.repeat_interleave(h // hkv, dim=1).contiguous()
    v = v.repeat_interleave(h // hkv, dim=1).contiguous()
    kpos = torch.arange(t, device=q.device)[None]
    valid = kpos < ctx[:, None]
    if window > 0:
        valid &= kpos >= ctx[:, None] - window
    return q.transpose(1, 2).contiguous(), k, v, valid[:, None, None, :]


def phase_kernels(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    live = torch.tensor([c > 0 for c in CTX], device=dev)
    worst = 0.0
    timed = {}
    all_heads = (PAGED_HEADS, ARCTIC_PAGED_HEADS, KIMI_HEADS,
                 *UNSERVED_HEADS, *WIDE_HEADS, *PAST_HEADS, DH1024_HEADS)
    worst_past = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for heads in all_heads:
            for page in (128, 16):
                for window in (-1, 512):
                    args = kernel_case(dtype, page, gen, dev, heads)
                    out = paged_decode_attention(*args, window=window)
                    torch.cuda.synchronize()
                    want = paged_decode_attention_plain(*args, window=window)
                    err = (out.float() - want.float())[live].abs().max()
                    err = err.item()
                    splits, per = paged_decode_splits(
                        len(CTX), heads[0], args[3].shape[1], page)
                    check("paged_decode_attention", err, dtype,
                          f"{dtype} Hkv={heads[0]} G={heads[1]} "
                          f"dh={heads[2]} page {page} window {window} "
                          f"({splits} splits of {per} pages), live rows")
                    if not torch.equal(out[6], out[7]):
                        raise AssertionError("identical rows 6 and 7 differ")
                    if out[~live].any():
                        raise AssertionError("paged_decode_attention: the "
                                             "ctx 0 row is not zero")
                    if not torch.isfinite(out).all():
                        raise AssertionError("non-finite kernel output")
                    if dtype == torch.bfloat16 and heads[2] > 256:
                        worst_past = max(worst_past, err)
                    elif dtype == torch.bfloat16:
                        worst = max(worst, err)
                    if (dtype, page, window) == (torch.bfloat16, 128, -1) \
                            and heads != DH1024_HEADS:
                        timed[heads] = args
                    del args

    # times at the serve phases' decode shapes: bf16, pages of 128;
    # arctic-480b's and kimi-k2's heads for PERF.md, then the JSON row at
    # agent-7b's
    time_paged(timed[ARCTIC_PAGED_HEADS], live)
    time_paged(timed[KIMI_HEADS], live)
    for heads in WIDE_HEADS:
        time_paged(timed[heads], live)
    past = [time_paged(timed[heads], live) for heads in PAST_HEADS]
    ms, plain_ms, library_ms, bound_ms, bound_by = time_paged(
        timed[PAGED_HEADS], live)
    row = {"name": "paged_decode_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/"
                     "paged_decode_attention.cu",
           "replaces": "src/repro/kernels/paged_decode_attention.py:89",
           "launches": None, "max_abs_err": worst, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms,
           "shapes": head_shapes([h for h in all_heads if h[2] <= 256],
                                 "Hkv G dh")}
    return [row, past_row(row, "paged_decode_attention past dh 256",
                          worst_past, past[0], head_shapes(
                              PAST_HEADS + [DH1024_HEADS], "Hkv G dh"))]


def past_row(row: dict, name: str, worst: float, times, shapes) -> dict:
    """The JSON row of a kernel's bodies past the old limits (ROADMAP
    A7.1): ``row``'s route, source and TPU kernel, ``name``, the worst
    bf16 error over those shapes and the times of ``times`` (kernel,
    plain, library, bound, bound by) at the first of ``shapes``."""
    ms, plain_ms, library_ms, bound_ms, bound_by = times
    return {**{k: row[k] for k in ("route", "source", "replaces")},
            "name": name, "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "shapes": shapes}


def head_shapes(heads, names: str) -> list:
    """The head shapes a kernel was held at, as strings ('Hkv=8 G=2
    dh=256'), each once, in order: the JSON line's ``shapes``."""
    out = []
    for h in heads:
        text = " ".join(f"{n}={x}" for n, x in zip(names.split(), h))
        if text not in out:
            out.append(text)
    return out


def time_paged(args, live):
    """Kernel, plain and SDPA times of full-attention paged decode over
    ``args``, and the bound; SDPA is held to the kernel's function."""
    window = -1
    ms = cuda_ms(lambda: paged_decode_attention(*args, window=window), 50)
    plain_ms = cuda_ms(
        lambda: paged_decode_attention_plain(*args, window=window), 10)
    sq, sk, sv, mask = sdpa_inputs(args, window)
    ref = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask)
    lib_err = (ref.transpose(1, 2).float() - paged_decode_attention(
        *args, window=window).float())[live].abs().max().item()
    if lib_err > TOL[torch.bfloat16]:
        raise AssertionError(f"library yardstick computes another "
                             f"function: {lib_err}")
    library_ms = cuda_ms(
        lambda: F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask),
        50)
    bound_ms, bound_by = bound(args, window)
    _, _, hkv, dh = args[1].shape
    log("kernels", f"paged_decode_attention bf16 B=8 Hkv={hkv} "
        f"G={args[0].shape[2] // hkv} dh={dh} page=128 ctx={CTX}, {card()}: "
        f"kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"SDPA over the gathered view {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}); kernel at "
        f"{100 * bound_ms / ms:.1f}% of bound")
    return ms, plain_ms, library_ms, bound_ms, bound_by


# flash attention at agent-7b's heads: the ring prefill of one prompt
FLASH_HEADS = (32, 8, 128)                          # H, Hkv, dh
FLASH_CASES = [(1024, 1024, True, -1), (1024, 1024, True, 512),
               (900, 900, True, -1), (900, 900, True, 512),
               (1024, 900, False, -1)]              # S, T, causal, window
# and at hymba-1.5b's: G = 5, dh 64, its window of 1024 and a shorter one
HYMBA_HEADS = (25, 5, 64)
HYMBA_FLASH_CASES = [(1024, 1024, True, -1), (1000, 1000, True, 1024),
                     (1000, 1000, True, 300), (700, 900, False, -1)]
# and at arctic-480b's: G = 7, dh 128; at kimi-k2's: G = 8, dh 112 (on
# the 128-wide body with zero columns); at dh 120 with G 6, 12 and 16
ARCTIC_HEADS = (56, 8, 128)
ARCTIC_FLASH_CASES = [(1024, 1024, True, -1), (900, 900, True, 512),
                      (300, 700, False, -1)]
KIMI_FLASH_HEADS = (64, 8, 112)
UNSERVED_FLASH_HEADS = [(48, 8, 120), (96, 8, 120), (128, 8, 120)]
UNSERVED_FLASH_CASES = [(1024, 1024, True, -1), (300, 700, False, -1)]
# the shapes the reference pads (WIDE_HEADS) as (H, Hkv, dh), with Gemma
# 3's window of 1024 and a shorter one
WIDE_FLASH_HEADS = [(hkv * g, hkv, dh) for hkv, g, dh in WIDE_HEADS]
WIDE_FLASH_CASES = [(1024, 1024, True, -1), (1500, 1500, True, 1024),
                    (900, 900, True, 300), (300, 700, False, -1)]
# past 256 (PAST_HEADS), as (H, Hkv, dh), and dh 1024 at short sequences
PAST_FLASH_HEADS = [(hkv * g, hkv, dh) for hkv, g, dh in PAST_HEADS]
PAST_FLASH_CASES = [(1024, 1024, True, -1), (900, 900, True, 300),
                    (300, 700, False, -1)]
DH1024_FLASH = ((4, 2, 1024), [(256, 256, True, -1), (200, 90, False, -1)])
# the edges of the tensor-core tiles (64 query rows, 64-key tiles): dh 32,
# ragged S and T, B = 2, S > T under a window (rows 955.. have no valid
# key and come out as zeros), non-causal T of 90 and under one tile
SMALL_HEADS = (8, 2, 32)
EDGE_FLASH_CASES = [(SMALL_HEADS, 1, 77, 77, True, -1),   # heads, B, S, T,
                    (SMALL_HEADS, 1, 900, 900, True, -1),  # causal, window
                    (SMALL_HEADS, 2, 77, 77, True, 5),
                    (FLASH_HEADS, 2, 300, 300, True, -1),
                    (HYMBA_HEADS, 1, 1100, 700, True, 256),
                    (FLASH_HEADS, 1, 200, 90, False, -1),
                    (ARCTIC_HEADS, 1, 100, 40, False, -1)]


def flash_case(dtype, s: int, t: int, gen: torch.Generator, dev, b: int = 1,
               heads=None):
    h, hkv, dh = FLASH_HEADS if heads is None else heads
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((b, s, h, dh), (b, t, hkv, dh), (b, t, hkv, dh))]


def flash_live_rows(s: int, t: int, causal: bool, window: int) -> np.ndarray:
    """(S,) bool: the query rows with at least one valid key.  The kernel
    writes zeros for the others, the plain version a uniform average."""
    if not causal:
        return np.ones(s, bool)
    i = np.arange(s)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros_like(i)
    return lo <= np.minimum(i, t - 1)


def flash_bound(args, causal: bool, window: int) -> tuple[float, str]:
    """q, k, v read once and out written once, against 4 * dh operations
    per valid (row, head, key) (``work.flash``)."""
    q, k, _ = args
    return bound_of(*work.flash(q, k, causal, window))


def flash_sdpa_inputs(args, causal: bool, window: int):
    """The same attention as one SDPA call: (B, H, S, dh) with K/V
    repeated to H heads, and a boolean mask where a window needs one."""
    q, k, v = args
    s, h = q.shape[1], q.shape[2]
    t, hkv = k.shape[1], k.shape[2]
    kr = k.transpose(1, 2).repeat_interleave(h // hkv, dim=1).contiguous()
    vr = v.transpose(1, 2).repeat_interleave(h // hkv, dim=1).contiguous()
    mask = None
    if causal and window > 0:
        i = torch.arange(s, device=q.device)[:, None]
        j = torch.arange(t, device=q.device)[None, :]
        mask = (j <= i) & (j > i - window)
    return (q.transpose(1, 2).contiguous(), kr, vr, mask,
            causal and mask is None)


def time_flash(args, label: str):
    """Kernel, plain and SDPA times of causal prefill attention on
    ``args``, and the bound; SDPA is held to the kernel's function."""
    ms = cuda_ms(lambda: flash_attention(*args, causal=True), 20)
    plain_ms = cuda_ms(lambda: flash_attention_plain(*args, causal=True), 5)
    sq, sk, sv, mask, is_causal = flash_sdpa_inputs(args, True, -1)

    def sdpa():
        return F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask,
                                              is_causal=is_causal)
    lib_err = (sdpa().transpose(1, 2).float() - flash_attention(
        *args, causal=True).float()).abs().max().item()
    if lib_err > TOL[torch.bfloat16]:
        raise AssertionError(f"library yardstick computes another "
                             f"function: {lib_err}")
    library_ms = cuda_ms(sdpa, 20)
    bound_ms, bound_by = flash_bound(args, True, -1)
    log("kernels", f"flash_attention bf16 {label} causal, {card()}: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, "
        f"bound "
        f"{bound_ms:.4f} ms ({bound_by}); kernel at "
        f"{100 * bound_ms / ms:.2f}% of bound")
    return ms, plain_ms, library_ms, bound_ms, bound_by


def check_flash(dtype, heads, b: int, s: int, t: int, causal: bool,
                window: int, gen: torch.Generator, dev) -> float:
    """The kernel against its plain version on the rows with a valid key;
    the others must be zeros.  Returns max |kernel - plain|."""
    args = flash_case(dtype, s, t, gen, dev, b=b, heads=heads)
    out = flash_attention(*args, causal=causal, window=window)
    torch.cuda.synchronize()
    want = flash_attention_plain(*args, causal=causal, window=window)
    live = torch.from_numpy(flash_live_rows(s, t, causal, window)).to(dev)
    err = (out.float() - want.float())[:, live].abs().max().item()
    dead = int((~live).sum())
    check("flash_attention", err, dtype,
          f"{dtype} B={b} H={heads[0]} Hkv={heads[1]} dh={heads[2]} S={s} "
          f"T={t} causal={causal} window={window}"
          + (f", {dead} rows with no valid key" if dead else ""))
    if dead and out[:, ~live].any():
        raise AssertionError("flash_attention: a row with no valid key is "
                             "not zero")
    if not torch.isfinite(out).all():
        raise AssertionError("non-finite kernel output")
    return err


def phase_flash(dev) -> list:
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = worst_past = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        cases = [(heads, 1, *case) for heads, cases in (
            (FLASH_HEADS, FLASH_CASES), (HYMBA_HEADS, HYMBA_FLASH_CASES),
            (ARCTIC_HEADS, ARCTIC_FLASH_CASES),
            (KIMI_FLASH_HEADS, ARCTIC_FLASH_CASES),
            *((h, UNSERVED_FLASH_CASES) for h in UNSERVED_FLASH_HEADS),
            *((h, WIDE_FLASH_CASES) for h in WIDE_FLASH_HEADS),
            *((h, PAST_FLASH_CASES) for h in PAST_FLASH_HEADS),
            DH1024_FLASH)
            for case in cases]
        for case in cases + EDGE_FLASH_CASES:
            err = check_flash(dtype, *case, gen, dev)
            if dtype == torch.bfloat16 and case[0][2] > 256:
                worst_past = max(worst_past, err)
            elif dtype == torch.bfloat16:
                worst = max(worst, err)
    held = [case[0] for case in cases + EDGE_FLASH_CASES]

    # hymba's, arctic's and kimi's ring prefill of their longest prompt,
    # for PERF.md
    time_flash(flash_case(torch.bfloat16, 1024, 1024, gen, dev,
                          heads=HYMBA_HEADS),
               "B=1 S=T=1024 H=25 Hkv=5 dh=64")
    time_flash(flash_case(torch.bfloat16, 1024, 1024, gen, dev,
                          heads=ARCTIC_HEADS),
               "B=1 S=T=1024 H=56 Hkv=8 dh=128")
    time_flash(flash_case(torch.bfloat16, 1024, 1024, gen, dev,
                          heads=KIMI_FLASH_HEADS),
               "B=1 S=T=1024 H=64 Hkv=8 dh=112")
    for h, hkv, dh in WIDE_FLASH_HEADS:
        time_flash(flash_case(torch.bfloat16, 1024, 1024, gen, dev,
                              heads=(h, hkv, dh)),
                   f"B=1 S=T=1024 H={h} Hkv={hkv} dh={dh}")
    past = [time_flash(flash_case(torch.bfloat16, 1024, 1024, gen, dev,
                                  heads=(h, hkv, dh)),
                       f"B=1 S=T=1024 H={h} Hkv={hkv} dh={dh}")
            for h, hkv, dh in PAST_FLASH_HEADS]
    # the train step's forward call: agent-7b's heads at B 2 x S 4096
    time_flash(flash_case(torch.bfloat16, TRAIN_SEQ, TRAIN_SEQ, gen, dev,
                          b=TRAIN_BATCH),
               f"B={TRAIN_BATCH} S=T={TRAIN_SEQ} H=32 Hkv=8 dh=128 (the "
               f"train step's)")

    # the JSON row: agent-7b's ring prefill of its longest prompt
    ms, plain_ms, library_ms, bound_ms, bound_by = time_flash(
        flash_case(torch.bfloat16, 1024, 1024, gen, dev),
        "B=1 S=T=1024 H=32 Hkv=8 dh=128")
    row = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:90",
           "launches": None, "max_abs_err": worst, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms,
           "shapes": head_shapes([h for h in held if h[2] <= 256],
                                 "H Hkv dh")}
    return [row, past_row(row, "flash_attention past dh 256", worst_past,
                          past[0], head_shapes([h for h in held
                                                if h[2] > 256], "H Hkv dh"))]


# paged flash (suffix prefill and the mixed step's chunk), each case:
# label, (Hkv, G, dh), page, window.  A chunk of 512 rows at start 1024,
# its last 8 rows pad rows (q_pos -1), as serve mixed's buffer pads a
# chunk; page ids shuffled over the pool, the table 4096 slots wide with
# its tail unmapped.  agent-7b's heads at the scheduler's page of 128 (the
# JSON row), gemma3-27b's with its 1024 window, kimi-k2's G 8 (dh 112),
# arctic's 56 over 8, Gemma 3 12B's dh 256, pages of 16 (eight boxes a
# tile), a head past 256 (agent-7b's width at d_head 512) and a dh of 100
# (read in place, on the CUDA-core body)
PAGED_FLASH_CASES = [("agent-7b", PAGED_HEADS, 128, -1),
                     ("gemma3-27b window 1024", (16, 2, 128), 128, 1024),
                     ("kimi-k2", KIMI_HEADS, 128, -1),
                     ("arctic-480b", ARCTIC_PAGED_HEADS, 128, -1),
                     ("Gemma 3 12B", GEMMA12_HEADS, 128, -1),
                     ("agent-7b pages of 16", PAGED_HEADS, 16, -1),
                     ("agent-7b at d_head 512", (8, 2, 512), 128, -1),
                     ("dh 100", (8, 4, 100), 128, -1)]
CHUNK_START, CHUNK_ROWS, CHUNK_PAD, CHUNK_WIDTH = 1024, 512, 8, 4096


def paged_flash_case(dtype, heads, page: int, gen: torch.Generator, dev):
    """(q, k_pages, v_pages, block_tables, q_pos) of one mixed chunk:
    ``CHUNK_ROWS`` query rows, the first ``CHUNK_ROWS - CHUNK_PAD`` at
    positions ``CHUNK_START`` onward, the rest -1; the sequence's pages
    shuffled over a pool of just those pages and the sink, its table
    ``CHUNK_WIDTH`` slots wide."""
    hkv, g, dh = heads
    start, rows, width = CHUNK_START, CHUNK_ROWS, CHUNK_WIDTH
    fill = rows - CHUNK_PAD
    need = -(-(start + fill) // page)
    perm = torch.randperm(need, generator=gen, device=dev).cpu()
    bt = torch.full((1, width // page), -1, dtype=torch.int32)
    bt[0, :need] = perm.to(torch.int32)
    q_pos = torch.full((1, rows), -1, dtype=torch.int32)
    q_pos[0, :fill] = start + torch.arange(fill, dtype=torch.int32)
    q = torch.randn((1, rows, hkv * g, dh), generator=gen, device=dev)
    kp = torch.randn((need + 1, page, hkv, dh), generator=gen, device=dev)
    vp = torch.randn((need + 1, page, hkv, dh), generator=gen, device=dev)
    return (q.to(dtype), kp.to(dtype), vp.to(dtype), bt.to(dev),
            q_pos.to(dev))


def paged_flash_bound(args, window: int) -> tuple[float, str]:
    """The valid pairs' operations and the live keys' K/V, q, out, table
    and q_pos bytes (``work.paged_flash``) of this call's inputs."""
    q, kp, _, bt, q_pos = args
    pairs, keys = paged_valid_counts(bt, q_pos, kp.shape[1], window)
    return bound_of(*work.paged_flash(q, kp, bt, q_pos, pairs, keys))


def gather_path(args, window: int):
    """What the paged path ran before the kernel, and still runs with
    the kernels off: ``paged_view`` + ``attention_cached``."""
    q, kp, vp, bt, q_pos = args
    view = attention.paged_view(attention.PagedKVCache(kp, vp), bt)
    return attention.attention_cached(q, view, q_pos, window=window)


def check_paged_flash(label: str, dtype, heads, page: int, window: int,
                      gen: torch.Generator, dev):
    """The kernel against its plain version on the live rows, twice with
    equal bits, zeros on the pad rows.  Returns (max |kernel - plain|,
    the inputs)."""
    args = paged_flash_case(dtype, heads, page, gen, dev)
    out = paged_flash_attention(*args, window=window)
    again = paged_flash_attention(*args, window=window)
    torch.cuda.synchronize()
    want = paged_flash_attention_plain(*args, window=window)
    live = paged_live_rows(args[3], args[4], page, window)
    err = (out.float() - want.float())[live].abs().max().item()
    check("paged_flash_attention", err, dtype,
          f"{dtype} {label} Hkv={heads[0]} G={heads[1]} dh={heads[2]} page "
          f"{page} window {window}, {CHUNK_ROWS} rows at {CHUNK_START} "
          f"({CHUNK_PAD} pad rows), live rows")
    if out[~live].any():
        raise AssertionError("paged_flash_attention: a pad row is not zero")
    if not torch.equal(out, again):
        raise AssertionError("paged_flash_attention: two calls differ")
    if not torch.isfinite(out).all():
        raise AssertionError("non-finite kernel output")
    return err, args


def time_paged_flash(label: str, args, window: int):
    """Kernel, plain, gather path and SDPA times of one chunk, and the
    bound; SDPA runs over the K/V already gathered contiguous (the
    view's, heads repeated) with the valid pairs as its mask, and is held
    to the kernel's function on the live rows."""
    q, kp, vp, bt, q_pos = args
    page, hkv = kp.shape[1], kp.shape[2]
    h = q.shape[2]
    ms = cuda_ms(lambda: paged_flash_attention(*args, window=window), 20)
    plain_ms = cuda_ms(lambda: paged_flash_attention_plain(
        *args, window=window), 3)
    gather_ms = cuda_ms(lambda: gather_path(args, window), 3)
    view = attention.paged_view(attention.PagedKVCache(kp, vp), bt)
    sk, sv = (x.transpose(1, 2).repeat_interleave(h // hkv, dim=1)
              .contiguous() for x in (view.k, view.v))
    sq = q.transpose(1, 2).contiguous()
    kpos = view.kpos[:, None, :].long()
    qp = q_pos.long()[:, :, None]
    mask = (kpos >= 0) & (kpos <= qp)
    if window > 0:
        mask &= kpos > qp - window
    mask = mask[:, None]

    def sdpa():
        return F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask)
    live = paged_live_rows(bt, q_pos, page, window)
    lib_err = (sdpa().transpose(1, 2).float() - paged_flash_attention(
        *args, window=window).float())[live].abs().max().item()
    if lib_err > TOL[torch.bfloat16]:
        raise AssertionError(f"library yardstick computes another "
                             f"function: {lib_err}")
    library_ms = cuda_ms(sdpa, 10)
    bound_ms, bound_by = paged_flash_bound(args, window)
    log("kernels", f"paged_flash_attention bf16 {label} Hkv={hkv} "
        f"G={h // hkv} dh={q.shape[3]} page={page} window={window}, "
        f"{CHUNK_ROWS} rows at {CHUNK_START} ({CHUNK_PAD} pad rows), "
        f"{card()}: kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}), plain {plain_ms:.4f} ms, the gather path it "
        f"replaces (paged_view + attention_cached) {gather_ms:.4f} ms, SDPA "
        f"over the gathered contiguous K/V {library_ms:.4f} ms; kernel at "
        f"{100 * bound_ms / ms:.1f}% of bound")
    return ms, plain_ms, library_ms, bound_ms, bound_by


def phase_paged_flash(dev) -> list:
    """[kernels] paged flash: every PAGED_FLASH_CASES case in f32 and
    bf16 against the plain version, each bf16 case timed; the JSON rows
    of agent-7b's chunk and of the head past 256."""
    gen = torch.Generator(device=dev).manual_seed(2)
    worst = worst_past = 0.0
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        for label, heads, page, window in PAGED_FLASH_CASES:
            err, args = check_paged_flash(label, dtype, heads, page, window,
                                          gen, dev)
            if dtype == torch.bfloat16:
                times[label] = time_paged_flash(label, args, window)
                if heads[2] > 256:
                    worst_past = max(worst_past, err)
                else:
                    worst = max(worst, err)
            del args
    ms, plain_ms, library_ms, bound_ms, bound_by = times["agent-7b"]
    row = {"name": "paged_flash_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/paged_flash_attention.cu",
           "replaces": "src/repro/models/attention.py:352 (port-side: "
                       "self_attention_paged's gather path, paged_view + "
                       "attention_cached, for Sq > 1; no Pallas kernel)",
           "launches": None, "max_abs_err": worst, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms,
           "shapes": head_shapes([c[1] for c in PAGED_FLASH_CASES
                                  if c[1][2] <= 256], "Hkv G dh")}
    return [row, past_row(row, "paged_flash_attention past dh 256",
                          worst_past, times["agent-7b at d_head 512"],
                          head_shapes([c[1] for c in PAGED_FLASH_CASES
                                       if c[1][2] > 256], "Hkv G dh"))]


# the flash backward (training's attention gradient), each case: heads
# (H, Hkv, dh), B, S, T, causal, window.  agent-7b's heads at the forward
# row's shape; gemma3-27b's (G 2) under its 1024 window; h2o-danube-3's
# dh 120 under its 4096 window; llama3-405b's G 16 and command-r-plus's
# G 12; a ragged S with a window; dh 32 and 64 with B 2; S > T under a
# window (rows 955.. have no valid key: zero dq, -inf LSE); non-causal.
BWD_CASES = [((32, 8, 128), 1, 1024, 1024, True, -1),
             ((32, 16, 128), 1, 1536, 1536, True, 1024),
             ((32, 8, 120), 1, 1024, 1024, True, 4096),
             ((128, 8, 128), 1, 512, 512, True, -1),
             ((96, 8, 128), 1, 512, 512, True, -1),
             ((32, 8, 128), 1, 1000, 1000, True, 300),
             (SMALL_HEADS, 2, 77, 77, True, 5),
             (HYMBA_HEADS, 2, 333, 333, True, -1),
             (HYMBA_HEADS, 1, 1100, 700, True, 256),
             ((32, 8, 128), 1, 300, 700, False, -1),
             # the shapes the reference pads: Gemma 3 12B's heads (dh 256)
             # under its 1024 window and without, Gemma 3 4B's, Llama 3.2
             # 3B's G 3, dh 100 and 200, 48 query heads over 1
             ((16, 8, 256), 1, 1536, 1536, True, 1024),
             ((16, 8, 256), 2, 333, 333, True, -1),
             ((8, 4, 256), 1, 1000, 1000, True, 300),
             ((16, 8, 256), 1, 300, 700, False, -1),
             ((24, 8, 128), 1, 1024, 1024, True, -1),
             ((32, 8, 100), 1, 777, 777, True, -1),
             ((16, 8, 200), 1, 600, 600, True, 256),
             ((48, 1, 128), 1, 512, 512, True, -1),
             # past 256 (PAST_HEADS; column blocks of 64), and dh 1024
             ((16, 8, 512), 1, 512, 512, True, -1),
             ((12, 4, 384), 1, 600, 600, True, 256),
             ((32, 8, 300), 1, 300, 700, False, -1),
             ((16, 1, 512), 2, 333, 333, True, -1),
             ((4, 2, 1024), 1, 256, 256, True, -1)]
# the backward's timed shapes beside agent-7b's: Gemma 3 12B's heads,
# Llama 3.2 3B's and dh 100, then the heads past 256, each at B 1 x S
# 1024 causal
WIDE_BWD_TIMED = [(16, 8, 256), (24, 8, 128), (32, 8, 100),
                  *PAST_FLASH_HEADS]


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the largest |want|, as the scan's checks; 0
    for an empty output (a call on a rank that holds no row)."""
    if not want.numel():
        return 0.0
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def bwd_case(dtype, heads, b, s, t, causal, window, gen, dev):
    """(q, k, v, out, lse, dout) on the card; dout is zero on the rows
    with no valid key (whose plain gradient is the uniform average's)."""
    q, k, v = flash_case(dtype, s, t, gen, dev, b=b, heads=heads)
    out, lse = flash_attention_forward(q, k, v, causal=causal, window=window)
    live = torch.from_numpy(flash_live_rows(s, t, causal, window)).to(dev)
    dout = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
    dout[:, ~live] = 0
    return (q, k, v, out, lse, dout), live


def check_flash_backward(dtype, heads, b, s, t, causal, window, gen,
                         dev) -> float:
    """LSE, dq, dk and dv of the kernels against the plain version's
    autograd on the same (q, k, v, dout), each relative to its largest
    magnitude.  Returns the worst of the four."""
    (q, k, v, out, lse, dout), live = bwd_case(dtype, heads, b, s, t,
                                               causal, window, gen, dev)
    dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout,
                                          causal=causal, window=window)
    again = flash_attention_backward(q, k, v, out, lse, dout, causal=causal,
                                     window=window)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip((dq, dk, dv), again)):
        raise AssertionError(f"flash_attention_backward: two runs differ "
                             f"({dtype} B={b} S={s} T={t} heads {heads})")
    del again
    want = flash_attention_backward_plain(q, k, v, dout, causal=causal,
                                          window=window)
    want_lse = flash_attention_lse_plain(q, k, causal=causal, window=window)
    errs = {"lse": rel_err(lse[..., live], want_lse[..., live]),
            "dq": rel_err(dq[:, live], want[0][:, live]),
            "dk": rel_err(dk, want[1]), "dv": rel_err(dv, want[2])}
    dead = int((~live).sum())
    what = (f"{dtype} B={b} H={heads[0]} Hkv={heads[1]} dh={heads[2]} S={s} "
            f"T={t} causal={causal} window={window}"
            + (f", {dead} rows with no valid key" if dead else "")
            + "; two runs equal bit for bit")
    for name, err in errs.items():
        check(f"flash_attention_backward {name}", err, dtype, what)
    if dead and (dq[:, ~live].any()
                 or not torch.isneginf(lse[..., ~live]).all()):
        raise AssertionError("flash_attention_backward: a row with no valid "
                             "key has a gradient or a finite LSE")
    if not all(torch.isfinite(x).all() for x in (dq, dk, dv)):
        raise AssertionError("non-finite backward output")
    return max(errs.values())


def bwd_bound(q, k, causal: bool, window: int) -> tuple[float, str]:
    """q, k, v, out, dout read once, lse and D, dq, dk, dv written once;
    10 * dh operations per valid (row, head, key)
    (``work.flash_backward``)."""
    return bound_of(*work.flash_backward(q, k, causal, window))


def time_flash_backward(args, causal: bool, window: int, label: str):
    """Kernel, plain and SDPA backward times on one case, and the bound.
    SDPA's backward (repeated K/V, its own forward saved) is the
    yardstick, pinned to PyTorch's flash-attention backend so that the
    reading does not move with the dispatcher's choice; the port never
    calls it.  Kernel and SDPA: the median of three readings, with their
    spread."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, v, out, lse, dout = args
    ms, spread = cuda_ms3(lambda: flash_attention_backward(
        q, k, v, out, lse, dout, causal=causal, window=window), 10)
    plain_ms = cuda_ms(lambda: flash_attention_backward_plain(
        q, k, v, dout, causal=causal, window=window), 3)
    sq, sk, sv, mask, is_causal = flash_sdpa_inputs((q, k, v), causal,
                                                    window)
    sq, sk, sv = (x.requires_grad_(True) for x in (sq, sk, sv))
    # a head dim that is not a multiple of 8, or past the flash backend's
    # 256, goes to the dispatcher's pick
    dh = q.shape[-1]
    backend = (SDPBackend.FLASH_ATTENTION if dh % 8 == 0 and dh <= 256
               else None)
    with torch.enable_grad(), (sdpa_kernel(backend) if backend is not None
                               else contextlib.nullcontext()):
        so = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask,
                                            is_causal=is_causal)
    sdo = dout.transpose(1, 2).contiguous()
    got = torch.autograd.grad(so, sq, sdo, retain_graph=True)[0]
    dq = flash_attention_backward(q, k, v, out, lse, dout, causal=causal,
                                  window=window)[0]
    lib_err = rel_err(got.transpose(1, 2), dq)
    if lib_err > TOL[torch.bfloat16]:
        raise AssertionError(f"library yardstick computes another "
                             f"function: {lib_err}")
    library_ms, lib_spread = cuda_ms3(lambda: torch.autograd.grad(
        so, (sq, sk, sv), sdo, retain_graph=True), 10)
    bound_ms, bound_by = bwd_bound(q, k, causal, window)
    log("kernels", f"flash_attention_backward {q.dtype} {label}, "
        f"{card()}: kernel "
        f"{ms:.4f} ms (median of 3, spread {spread:.4f}), plain "
        f"{plain_ms:.4f} ms, SDPA backward {library_ms:.4f} ms (backend "
        f"{backend.name if backend is not None else 'the default'}, median "
        f"of 3, spread {lib_spread:.4f}), bound "
        f"{bound_ms:.4f} ms ({bound_by}); kernel at "
        f"{100 * bound_ms / ms:.2f}% of bound, "
        f"{ms / library_ms:.2f}x SDPA's backward")
    return ms, plain_ms, library_ms, bound_ms, bound_by


def phase_flash_backward(dev) -> list:
    """[kernels] flash backward: every case in f32 and bf16, then the
    timed rows at agent-7b's heads and past dh 256."""
    gen = torch.Generator(device=dev).manual_seed(7)
    worst = worst_past = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for case in BWD_CASES:
            err = check_flash_backward(dtype, *case, gen, dev)
            if dtype == torch.bfloat16 and case[0][2] > 256:
                worst_past = max(worst_past, err)
            elif dtype == torch.bfloat16:
                worst = max(worst, err)
    args, _ = bwd_case(torch.bfloat16, FLASH_HEADS, 1, 1024, 1024, True, -1,
                       gen, dev)
    ms, plain_ms, library_ms, bound_ms, bound_by = time_flash_backward(
        args, True, -1, "B=1 S=T=1024 H=32 Hkv=8 dh=128 causal")
    # the training step's shape: agent-7b's heads at B 2, S 4096
    time_flash_backward(bwd_case(torch.bfloat16, FLASH_HEADS, 2, 4096, 4096,
                                 True, -1, gen, dev)[0], True, -1,
                        "B=2 S=T=4096 H=32 Hkv=8 dh=128 causal (train)")
    timed = {}
    for h, hkv, dh in WIDE_BWD_TIMED:
        timed[h, hkv, dh] = time_flash_backward(
            bwd_case(torch.bfloat16, (h, hkv, dh), 1, 1024, 1024, True, -1,
                     gen, dev)[0], True, -1,
            f"B=1 S=T=1024 H={h} Hkv={hkv} dh={dh} causal")
    row = {"name": "flash_attention_backward", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
           "replaces": "src/repro/kernels/flash_attention.py:90",
           "launches": None, "max_abs_err": worst, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms,
           "shapes": head_shapes([c[0] for c in BWD_CASES
                                  if c[0][2] <= 256], "H Hkv dh")}
    return [row, past_row(row, "flash_attention_backward past dh 256",
                          worst_past, timed[PAST_FLASH_HEADS[0]],
                          head_shapes([c[0] for c in BWD_CASES
                                       if c[0][2] > 256], "H Hkv dh"))]


# ring decode at the serve phase's shapes: 8 slots, agent-7b heads, a
# 4096-slot full-attention ring with the contexts CTX, and a 1536-slot
# ring of a 512-token window whose positions wrapped; then hymba-1.5b's
# heads with its global ring and the 2048-slot ring of its 1024 window.
# The split planner (decode_splits) cuts the 4096-slot rings into 16
# ranges of 256; 3000 slots leave a ragged last range, 64 slots make one
# range (no merge), and 1000 slots at hymba's heads make ranges of 64.
RING_HEADS = (8, 4, 128)                            # Hkv, G, dh
RING_CASES = [(4096, -1), (1536, 512), (3000, -1), (64, -1)]  # slots, window
HYMBA_RING_HEADS = (5, 5, 64)
HYMBA_RING_CASES = [(4096, -1), (2048, 1024), (1000, 300)]
ARCTIC_RING_HEADS = (8, 7, 128)
UNSERVED_RING_CASES = [(4096, -1), (1536, 512)]


def ring_case(dtype, slots: int, gen: torch.Generator, dev, heads=None,
              ctx=None):
    """Rings after writing positions 0..c-1 of each row's context c (of
    ``ctx``, default CTX) at slot ``pos % slots``; q_pos = c - 1 (a row
    with c = 0, as row 5 of CTX, has no valid slot).  Returns q, k, v,
    kpos, q_pos."""
    hkv, g, dh = RING_HEADS if heads is None else heads
    ctx = CTX if ctx is None else ctx
    b = len(ctx)
    last = np.asarray(ctx)[:, None] - 1
    s = np.arange(slots)[None, :]
    kpos = last - np.mod(last - s, slots)
    kpos = np.where(kpos >= 0, kpos, -1).astype(np.int32)
    q = torch.randn((b, 1, hkv * g, dh), generator=gen, device=dev)
    k = torch.randn((b, slots, hkv, dh), generator=gen, device=dev)
    v = torch.randn((b, slots, hkv, dh), generator=gen, device=dev)
    return (q.to(dtype), k.to(dtype), v.to(dtype),
            torch.from_numpy(kpos).to(dev),
            torch.tensor(last[:, 0], dtype=torch.int32, device=dev))


def ring_valid(args, window: int) -> torch.Tensor:
    """(B, T) bool: the slots the validity rule keeps."""
    kpos, q_pos = args[3].long(), args[4].long()[:, None]
    valid = (kpos >= 0) & (kpos <= q_pos)
    if window > 0:
        valid &= kpos > q_pos - window
    return valid


def ring_bound(args, window: int) -> tuple[float, str]:
    """K/V of the valid slots, q, out, kpos and q_pos, against 4 * G *
    dh f32 operations per valid slot and KV head (``work.ring_decode``)."""
    q, k, _, kpos, q_pos = args
    return bound_of(*work.ring_decode(q, k, kpos, q_pos,
                                      int(ring_valid(args, window).sum())))


def time_ring_decode(args, live, label: str):
    """Kernel, plain and SDPA times of ring decode over ``args`` (full
    attention), and the bound; SDPA is held to the kernel's function."""
    ms = cuda_ms(lambda: decode_attention(*args), 50)
    plain_ms = cuda_ms(lambda: decode_attention_plain(*args), 10)
    q, k, v = args[:3]
    h, hkv = q.shape[2], k.shape[2]
    sq = q.transpose(1, 2).contiguous()
    sk = k.transpose(1, 2).repeat_interleave(h // hkv, dim=1).contiguous()
    sv = v.transpose(1, 2).repeat_interleave(h // hkv, dim=1).contiguous()
    mask = ring_valid(args, -1)[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask)
    lib_err = (sdpa().transpose(1, 2).float() - decode_attention(
        *args).float())[live].abs().max().item()
    if lib_err > TOL[torch.bfloat16]:
        raise AssertionError(f"library yardstick computes another "
                             f"function: {lib_err}")
    library_ms = cuda_ms(sdpa, 50)
    bound_ms, bound_by = ring_bound(args, -1)
    log("kernels", f"decode_attention bf16 {label}, 4096-slot ring, "
        f"ctx={CTX}, {card()}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"SDPA with "
        f"a slot mask {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}); kernel at {100 * bound_ms / ms:.1f}% of bound")
    return ms, plain_ms, library_ms, bound_ms, bound_by


# a decode step of the serve phases: 8 rows of ~515 tokens in a
# 4096-slot ring, where most of the planner's ranges hold no valid slot
SERVE_CTX = [515, 517, 513, 520, 515, 516, 514, 519]
RANGE_LENS = (512, 256, 128)                  # ring slots per CTA


def time_ranges(gen: torch.Generator, dev) -> None:
    """Ring decode bf16 with each of RANGE_LENS in place of the planner's
    range, on the CTX rings and at SERVE_CTX, at each head shape: the
    numbers behind decode_splits' target (PERF.md)."""
    planner = sys.modules[decode_attention.__module__]
    plan = planner.decode_splits
    for heads in (RING_HEADS, HYMBA_RING_HEADS, ARCTIC_RING_HEADS):
        for label, ctx in (("CTX", CTX), ("serve", SERVE_CTX)):
            args = ring_case(torch.bfloat16, 4096, gen, dev, heads=heads,
                             ctx=ctx)
            live = args[4] >= 0
            want = decode_attention_plain(*args).float()[live]
            times = []
            for n in RANGE_LENS:
                planner.decode_splits = lambda b, h, t, n=n: (-(-t // n), n)
                try:
                    err = (decode_attention(*args).float()[live]
                           - want).abs().max().item()
                    check("decode_attention", err, torch.bfloat16,
                          f"{label} contexts, ranges of {n}")
                    times.append(cuda_ms(lambda: decode_attention(*args),
                                         100))
                finally:
                    planner.decode_splits = plan
            log("kernels", f"decode_attention bf16 Hkv={heads[0]} "
                f"G={heads[1]} dh={heads[2]}, 4096-slot ring, {label} "
                f"contexts, ranges of {'/'.join(map(str, RANGE_LENS))} "
                f"slots: {' / '.join(f'{t:.4f}' for t in times)} ms "
                f"(the planner takes {plan(len(ctx), heads[0], 4096)[1]})")


def phase_ring_decode(dev) -> list:
    gen = torch.Generator(device=dev).manual_seed(2)
    live = torch.tensor([c > 0 for c in CTX], device=dev)
    worst = worst_past = 0.0
    ring_heads = ((RING_HEADS, RING_CASES),
                  (HYMBA_RING_HEADS, HYMBA_RING_CASES),
                  (ARCTIC_RING_HEADS, RING_CASES), (KIMI_HEADS, RING_CASES),
                  *((h, UNSERVED_RING_CASES)
                    for h in UNSERVED_HEADS + WIDE_HEADS + PAST_HEADS
                    + [DH1024_HEADS]))
    for dtype in (torch.float32, torch.bfloat16):
        for heads, cases in ring_heads:
            for slots, window in cases:
                args = ring_case(dtype, slots, gen, dev, heads=heads)
                out = decode_attention(*args, window=window)
                torch.cuda.synchronize()
                want = decode_attention_plain(*args, window=window)
                err = (out.float() - want.float())[live].abs().max().item()
                splits, per = decode_splits(len(CTX), heads[0], slots)
                check("decode_attention", err, dtype,
                      f"{dtype} Hkv={heads[0]} G={heads[1]} dh={heads[2]} "
                      f"{slots} slots window {window} ({splits} splits of "
                      f"{per}), live rows")
                if not torch.isfinite(out).all():
                    raise AssertionError("non-finite kernel output")
                if out[~live].any():
                    raise AssertionError("decode_attention: the row with no "
                                         "valid slot is not zero")
                if dtype == torch.bfloat16 and heads[2] > 256:
                    worst_past = max(worst_past, err)
                elif dtype == torch.bfloat16:
                    worst = max(worst, err)

    # hymba's global ring, arctic's and kimi's, for PERF.md
    time_ring_decode(ring_case(torch.bfloat16, 4096, gen, dev,
                               heads=HYMBA_RING_HEADS), live,
                     "B=8 Hkv=5 G=5 dh=64")
    time_ring_decode(ring_case(torch.bfloat16, 4096, gen, dev,
                               heads=ARCTIC_RING_HEADS), live,
                     "B=8 Hkv=8 G=7 dh=128")
    time_ring_decode(ring_case(torch.bfloat16, 4096, gen, dev,
                               heads=KIMI_HEADS), live,
                     "B=8 Hkv=8 G=8 dh=112")
    for hkv, g, dh in WIDE_HEADS:
        time_ring_decode(ring_case(torch.bfloat16, 4096, gen, dev,
                                   heads=(hkv, g, dh)), live,
                         f"B=8 Hkv={hkv} G={g} dh={dh}")
    past = [time_ring_decode(ring_case(torch.bfloat16, 4096, gen, dev,
                                       heads=(hkv, g, dh)), live,
                             f"B=8 Hkv={hkv} G={g} dh={dh}")
            for hkv, g, dh in PAST_HEADS]
    time_ranges(gen, dev)
    # the JSON row: agent-7b's full-attention ring
    ms, plain_ms, library_ms, bound_ms, bound_by = time_ring_decode(
        ring_case(torch.bfloat16, 4096, gen, dev), live,
        "B=8 Hkv=8 G=4 dh=128")
    row = {"name": "decode_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
           "replaces": "src/repro/kernels/decode_attention.py:75",
           "launches": None, "max_abs_err": worst, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms,
           "shapes": head_shapes([h for h, _ in ring_heads if h[2] <= 256],
                                 "Hkv G dh")}
    return [row, past_row(row, "decode_attention past dh 256", worst_past,
                          past[0], head_shapes([h for h, _ in ring_heads
                                                if h[2] > 256], "Hkv G dh"))]


# a rank's share of llama3-405b's decode_32k ring on the production mesh,
# cut over the 16-way model axis (the GQA fallback; ROADMAP A6.2): 8 rows,
# all 128 query heads over its 8 KV heads (G 16, dh 128) and ~2048 of the
# 32896 slots, every slot valid; then the combine of the 16 ranks' partial
# outputs of the rank's own 8 heads.  COMBINE_EMPTY ranks hold no valid
# key for row 0 (as at a context short of the ring's end), and row 1 has
# none on any rank.
LSE_DECODE = (8, 2048, 8, 16, 128)               # B, slots, Hkv, G, dh
COMBINE = (16, 8, 8, 128)                        # R, B, H, dh
COMBINE_EMPTY = 5


def lse_decode_case(dtype, gen: torch.Generator, dev):
    """Ring decode over one rank's full slot range: positions lo .. lo +
    slots - 1 of a longer context, q_pos past them."""
    b, slots, hkv, g, dh = LSE_DECODE
    lo = 7 * slots
    q = torch.randn((b, 1, hkv * g, dh), generator=gen, device=dev)
    k = torch.randn((b, slots, hkv, dh), generator=gen, device=dev)
    v = torch.randn((b, slots, hkv, dh), generator=gen, device=dev)
    kpos = (lo + torch.arange(slots, dtype=torch.int32, device=dev))[
        None].expand(b, slots).contiguous()
    q_pos = torch.full((b,), lo + 3 * slots, dtype=torch.int32, device=dev)
    return q.to(dtype), k.to(dtype), v.to(dtype), kpos, q_pos


def combine_case(dtype, gen: torch.Generator, dev, dh=None):
    r, b, h, dh0 = COMBINE
    dh = dh0 if dh is None else dh
    outs = torch.randn((r, b, h, dh), generator=gen, device=dev).to(dtype)
    lses = 4 * torch.randn((r, b, h), generator=gen, device=dev)
    lses[r - COMBINE_EMPTY:, 0] = attention.NEG_INF
    lses[:, 1] = attention.NEG_INF
    return outs, lses


def combine_bound(outs, lses) -> tuple[float, str]:
    """Each rank's partial and log-sum-exp read once, the output written
    once; about 4 operations per rank and element (``work.combine``)."""
    return bound_of(*work.combine(outs, lses))


def phase_combine(dev) -> dict:
    """[kernels] decode_attention with its log-sum-exp and
    attention_combine against their plain versions (f32 and bf16, the
    empty ranges and the row empty everywhere), then both timed at
    llama3-405b's decode_32k local shape against their bounds, with the
    card's name and power limit: the decode in bf16 (the model's
    dtype), the combine in f32 (the serve path gathers and combines the
    partials in f32).  The row's max_abs_err is the combine's in f32."""
    gen = torch.Generator(device=dev).manual_seed(27)
    worst = worst_c = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        # ring decode over a range, empty for row 2 and a windowed ring
        # after its wrap (CTX's rings), with and without the log-sum-exp
        for heads, slots, window in ((RING_HEADS, 4096, -1),
                                     (RING_HEADS, 1536, 512),
                                     ((8, 16, 128), 2048, -1),
                                     *((h, 2048, -1) for h in WIDE_HEADS)):
            args = ring_case(dtype, slots, gen, dev, heads=heads)
            half = slots // 2
            for lo in (0, half):
                # a rank's range, as its own contiguous shard
                sub = (args[0], *(t[:, lo:lo + half].contiguous()
                                  for t in args[1:4]), args[4])
                out, lse = decode_attention(*sub, window=window,
                                            with_lse=True)
                plain = decode_attention(*sub, window=window)
                if not torch.equal(out, plain):
                    raise AssertionError("decode_attention: out with the "
                                         "log-sum-exp differs from without")
                err = call_err((out, lse), decode_attention_plain(
                    *sub, window=window, with_lse=True)).item()
                check("decode_attention", err, dtype,
                      f"with its log-sum-exp, {dtype} Hkv={heads[0]} "
                      f"G={heads[1]} slots [{lo}, {lo + half}) of {slots} "
                      f"window {window}")
                if dtype == torch.bfloat16:
                    worst = max(worst, err)
        for r, dh in ((2, None), (COMBINE[0], None),
                      (COMBINE[0], 256)):     # and Gemma 3's head dim
            outs, lses = combine_case(dtype, gen, dev, dh)
            outs, lses = outs[:r].contiguous(), lses[:r].contiguous()
            got = attention_combine(outs, lses)
            err = call_err(got, attention_combine_plain(outs, lses)).item()
            check("attention_combine", err, dtype,
                  f"{dtype} R={r} B={COMBINE[1]} H={COMBINE[2]} "
                  f"dh={outs.shape[-1]}, empty ranks and an empty row")
            if got[1].any():
                raise AssertionError("attention_combine: the row empty on "
                                     "every rank is not zero")
            if dtype == torch.float32:          # the path's partials
                worst_c = max(worst_c, err)
    gpu = card()
    # the LSE mode at the local shape, beside the mode without it
    args = lse_decode_case(torch.bfloat16, gen, dev)
    b, slots, hkv, g, dh = LSE_DECODE
    ms = cuda_ms(lambda: decode_attention(*args, with_lse=True), 50)
    no_lse_ms = cuda_ms(lambda: decode_attention(*args), 50)
    plain_ms = cuda_ms(lambda: decode_attention_plain(*args, with_lse=True),
                       10)
    bound_ms, bound_by = ring_bound(args, -1)
    log("kernels", f"decode_attention bf16 with its log-sum-exp at "
        f"llama3-405b's decode_32k rank shape (B={b}, {slots} slots of "
        f"the rank, Hkv={hkv}, G={g}, dh={dh}), {gpu}: kernel {ms:.4f} ms "
        f"(without the log-sum-exp {no_lse_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
        f"kernel at {100 * bound_ms / ms:.1f}% of bound")
    # the serve path gathers and combines the partials in f32
    outs, lses = combine_case(torch.float32, gen, dev)
    c_ms = cuda_ms(lambda: attention_combine(outs, lses), 100)
    c_plain = cuda_ms(lambda: attention_combine_plain(outs, lses), 20)
    c_bound, c_by = combine_bound(outs, lses)
    log("kernels", f"attention_combine f32 at llama3-405b's decode_32k "
        f"(R={COMBINE[0]} ranks, B={COMBINE[1]}, {COMBINE[2]} own heads, "
        f"dh={COMBINE[3]}), {gpu}: kernel {c_ms:.4f} ms, plain "
        f"{c_plain:.4f} ms, bound {c_bound:.4f} ms ({c_by}); kernel at "
        f"{100 * c_bound / c_ms:.1f}% of bound; no single PyTorch call "
        f"computes it")
    return {"name": "attention_combine", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/attention_combine.cu",
            "replaces": "src/repro/distributed/sharding.py:241 (port-side: "
                        "the softmax GSPMD reduces over a sequence-sharded "
                        "cache; no Pallas kernel)",
            "launches": None, "max_abs_err": worst_c, "ms": c_ms,
            "plain_ms": c_plain, "bound_ms": c_bound, "bound_by": c_by,
            "library_ms": None}


# the SSM scan: hymba's prefill (B = 1, 50 heads, dk 16, dv 64, one B/C
# row broadcast over the heads, decay from softplus as at a_log = 0), a
# ragged T, the JAX sweep (tests/test_kernels.py:237-241), a non-zero h0,
# and mLSTM's width (xlstm-350m: dk 512, dv 513 with the normaliser
# column, q and k scaled by dk^-1/2 as mLSTM scales them) on the tiled
# CUDA-core path.  b, t, h, dk, dv, chunk, shared q/k, decay, h0 scale;
# decay None draws log_a = -softplus(N(0, 1))
SCAN_CASES = [(1, 1024, 50, 16, 64, 128, True, None, 0.0),
              (1, 1000, 50, 16, 64, 128, True, None, 0.0),
              (1, 128, 2, 16, 16, 32, False, 0.1, 0.0),
              (2, 96, 4, 32, 16, 32, False, 0.1, 0.0),
              (1, 64, 1, 64, 64, 64, False, 0.1, 0.0),
              (1, 64, 2, 16, 16, 16, False, 0.05, 0.5),
              (1, 300, 2, 512, 513, 128, False, 0.1, 0.3),
              (1, 200, 2, 128, 129, 64, False, 0.1, 0.3),
              # xLSTM's mLSTM at the 1.3B width (d_model 2048) and the
              # 2.7B (2560), past the old 512 and 1024
              (1, 300, 2, 1024, 1025, 128, False, 0.1, 0.3),
              (1, 200, 2, 1280, 1281, 64, False, 0.1, 0.3)]
MLSTM_SCAN = (1, 1024, 4, 512, 513, 128, False, 0.1, 0.0)   # xlstm-350m
MLSTM_13B_SCAN = (1, 1024, 4, 1024, 1025, 128, False, 0.1, 0.0)


def scan_case(dtype, b, t, h, dk, dv, shared, decay, h0_scale,
              gen: torch.Generator, dev):
    """q, k, v, log_a, h0 in model layout; ``shared`` makes q and k one
    row broadcast over the heads (head stride 0), as hymba's are.  q and
    k are 0.3 N(0, 1) up to dk 64 and N(0, 1) / sqrt(dk) past it, so the
    outputs stay O(1) at mLSTM's widths."""
    nq = 1 if shared else h
    scale = 0.3 if dk <= 64 else dk ** -0.5

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    q = (scale * randn(b, t, nq, dk)).to(dtype)
    k = (scale * randn(b, t, nq, dk)).to(dtype)
    v = (0.3 * randn(b, t, h, dv)).to(dtype)
    if decay is None:
        log_a = -F.softplus(randn(b, t, h))
    else:
        log_a = -decay * torch.rand((b, t, h), generator=gen, device=dev)
    h0 = h0_scale * randn(b, h, dk, dv)
    if shared:
        q, k = q.expand(b, t, h, dk), k.expand(b, t, h, dk)
    return q, k, v, log_a, h0


def scan_bound(args, chunk: int) -> tuple[float, str]:
    """q, k (once per broadcast row), v, log_a and h0 read once, y and
    h_T written once, against the operations of the chunked form
    (``work.scan``)."""
    return bound_of(*work.scan(*args, chunk))


def phase_ssm_scan(dev) -> list:
    gen = torch.Generator(device=dev).manual_seed(3)
    worst = worst_past = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for b, t, h, dk, dv, chunk, shared, decay, h0s in SCAN_CASES:
            args = scan_case(dtype, b, t, h, dk, dv, shared, decay, h0s, gen,
                             dev)
            y, h_t = ssm_scan(*args, chunk=chunk)
            torch.cuda.synchronize()
            want_y, want_h = ssm_scan_plain(*args, chunk=chunk)
            if not (torch.isfinite(y).all() and torch.isfinite(h_t).all()):
                raise AssertionError("non-finite kernel output")
            err = max((y.float() - want_y.float()).abs().max().item(),
                      (h_t - want_h).abs().max().item())
            check("ssm_scan", err, dtype,
                  f"{dtype} B={b} T={t} H={h} dk={dk} dv={dv} chunk={chunk} "
                  f"shared q/k={shared} h0={h0s} (y and h_T)",
                  tol=SCAN_TOL[dtype])
            if dtype == torch.bfloat16 and (dk > 512 or dv > 1024):
                worst_past = max(worst_past, err)
            elif dtype == torch.bfloat16:
                worst = max(worst, err)

    # times at hymba's prefill of its longest prompt: bf16, T = 1024
    b, t, h, dk, dv, chunk, shared, decay, h0s = SCAN_CASES[0]
    args = scan_case(torch.bfloat16, b, t, h, dk, dv, shared, decay, h0s, gen,
                     dev)
    ms = cuda_ms(lambda: ssm_scan(*args, chunk=chunk), 50)
    plain_ms = cuda_ms(lambda: ssm_scan_plain(*args, chunk=chunk), 10)
    bound_ms, bound_by = scan_bound(args, chunk)
    log("kernels", f"ssm_scan bf16 B=1 T=1024 H=50 dk=16 dv=64 chunk=128, "
        f"q/k broadcast over heads: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, no library call computes it, bound "
        f"{bound_ms:.4f} ms ({bound_by}); kernel at "
        f"{100 * bound_ms / ms:.1f}% of bound")
    # and at mLSTM's width, on the tiled CUDA-core path
    b, t, h, dk, dv, chunk, shared, decay, h0s = MLSTM_SCAN
    margs = scan_case(torch.bfloat16, b, t, h, dk, dv, shared, decay, h0s,
                      gen, dev)
    m_ms = cuda_ms(lambda: ssm_scan(*margs, chunk=chunk), 10)
    m_plain = cuda_ms(lambda: ssm_scan_plain(*margs, chunk=chunk), 3)
    m_bound, m_by = scan_bound(margs, chunk)
    log("kernels", f"ssm_scan bf16 B={b} T={t} H={h} dk={dk} dv={dv} "
        f"chunk={chunk} (mLSTM's width): kernel {m_ms:.4f} ms, plain "
        f"{m_plain:.4f} ms, bound {m_bound:.4f} ms ({m_by}); kernel at "
        f"{100 * m_bound / m_ms:.1f}% of bound")
    # and at the mLSTM's 1.3B width
    b, t, h, dk, dv, chunk, shared, decay, h0s = MLSTM_13B_SCAN
    margs = scan_case(torch.bfloat16, b, t, h, dk, dv, shared, decay, h0s,
                      gen, dev)
    m_ms = cuda_ms(lambda: ssm_scan(*margs, chunk=chunk), 5)
    m_plain = cuda_ms(lambda: ssm_scan_plain(*margs, chunk=chunk), 2)
    m_bound, m_by = scan_bound(margs, chunk)
    log("kernels", f"ssm_scan bf16 B={b} T={t} H={h} dk={dk} dv={dv} "
        f"chunk={chunk} (the mLSTM at xLSTM's 1.3B width), {card()}: "
        f"kernel {m_ms:.4f} ms, plain {m_plain:.4f} ms, bound "
        f"{m_bound:.4f} ms ({m_by}); kernel at "
        f"{100 * m_bound / m_ms:.1f}% of bound")
    del margs
    row = {"name": "ssm_scan", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
           "replaces": "src/repro/kernels/ssm_scan.py:69",
           "launches": None, "max_abs_err": worst, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": None}
    return [row, past_row(row, "ssm_scan at xLSTM's 1.3B width", worst_past,
                          (m_ms, m_plain, None, m_bound, m_by),
                          ["dk=1024 dv=1025", "dk=1280 dv=1281"])]


# grouped_matmul at arctic-480b's expert shapes: E 128, d_model 7168,
# d_ff_expert 4864; w_in and w_gate take d -> f, w_out f -> d.  C is 8 at
# a decode step over 8 slots and 24 at a 900-1024-token prefill, and the
# counts come from a top-2 routing of 8 and 1024 tokens.  f32 runs the
# full d and f with 16 experts; the ragged counts hold 0, 1, C and the
# middle.  kimi-k2's: E 384, d 7168, f 2048, top-8, C 8 at decode and 32
# at a 1024-token prefill.
ARCTIC_EXPERTS = (128, 7168, 4864)                 # E, d, f
KIMI_EXPERTS = (384, 7168, 2048)
GM_RAGGED = [0, 1, 24, 13, 0, 7, 24, 2, 19, 0, 5, 24, 1, 11, 0, 23]


def routed_counts(tokens: int, e: int, c: int, gen: torch.Generator,
                  dev, top_k: int = 2) -> torch.Tensor:
    """Per-expert loads of a top-k routing of ``tokens`` tokens (softmax
    of random logits), clamped to the capacity ``c``, as moe.py builds
    them."""
    logits = torch.randn((tokens, e), generator=gen, device=dev)
    ids = torch.topk(torch.softmax(logits, -1), top_k, dim=-1).indices
    load = torch.zeros(e, dtype=torch.int64, device=dev)
    load.index_add_(0, ids.reshape(-1), torch.ones_like(ids.reshape(-1)))
    return load.clamp(max=c).to(torch.int32)


def gm_weights(dtype, e: int, d: int, f: int, gen: torch.Generator, dev):
    """Expert weights scaled by 1/sqrt(d), as the model's, drawn one
    expert at a time (no f32 copy of the whole tensor)."""
    w = torch.empty((e, d, f), dtype=dtype, device=dev)
    for i in range(e):
        w[i] = torch.randn((d, f), generator=gen, device=dev).mul_(d ** -0.5)
    return w


def gm_buffer(dtype, counts: torch.Tensor, c: int, d: int,
              gen: torch.Generator, dev) -> torch.Tensor:
    """An (E, C, d) dispatch buffer: rows past each count are zero, as
    the routing leaves them."""
    x = torch.randn((counts.numel(), c, d), generator=gen, device=dev)
    row = torch.arange(c, device=dev)[None, :, None]
    return torch.where(row < counts[:, None, None], x, 0.0).to(dtype)


def gm_bound(x, w, counts) -> tuple[float, str]:
    """The weights of the live experts, the live rows of x, all of out and
    counts, against 2 * sum(min(counts, C)) * d * f operations
    (``work.grouped_matmul``)."""
    return bound_of(*work.grouped_matmul(
        x, w, counts, *work.live_rows(counts, x.shape[1])))


def gm_errors(got, want) -> tuple[float, float]:
    """Max |got - want|, and max |got - want| / (1 + |want|): the band of
    ``torch.testing.assert_close`` with atol = rtol.  The products are
    O(1) and reach |y| ~ 5 at these sizes, where one bf16 unit in the last
    place is 0.03125, so either of two right roundings passes only a band
    that grows with |y|."""
    diff = (got.float() - want.float()).abs()
    rel = diff / (1 + want.float().abs())
    return diff.max().item(), rel.max().item()


def check_gm(x, w, counts, what: str) -> float:
    """The kernel against its plain version within TOL as atol and rtol;
    rows past each count zero.  Returns max |kernel - plain|."""
    out = grouped_matmul(x, w, counts)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError("non-finite kernel output")
    for i, n in enumerate(counts.tolist()):
        if out[i, max(n, 0):].any():
            raise AssertionError(f"grouped_matmul: expert {i}'s rows past "
                                 f"its count {n} are not zero")
    err, rel = gm_errors(out, grouped_matmul_plain(x, w, counts))
    tol = TOL[x.dtype]
    log("kernels", f"grouped_matmul {x.dtype} E={x.shape[0]} C={x.shape[1]} "
        f"d={x.shape[2]} f={w.shape[2]} {what}, counts "
        f"{sorted(set(counts.tolist()))}: max |kernel - plain| {err:.3e}, "
        f"max |kernel - plain| / (1 + |plain|) {rel:.3e} (tolerance "
        f"{tol:.0e})")
    if not math.isfinite(rel) or rel > tol:
        raise AssertionError(f"grouped_matmul disagrees with its plain "
                             f"version ({what}): {rel} > {tol}")
    return err


def time_gm(x, w, counts, label: str):
    """Kernel, plain and ``torch.bmm`` times over the zero-padded buffer,
    and the bound; bmm is held to the kernel's function."""
    ms = cuda_ms(lambda: grouped_matmul(x, w, counts), 20)
    plain_ms = cuda_ms(lambda: grouped_matmul_plain(x, w, counts), 3)
    _, lib_err = gm_errors(torch.bmm(x, w), grouped_matmul(x, w, counts))
    if lib_err > TOL[x.dtype]:
        raise AssertionError(f"library yardstick computes another "
                             f"function: {lib_err}")
    library_ms = cuda_ms(lambda: torch.bmm(x, w), 10)
    bound_ms, bound_by = gm_bound(x, w, counts)
    e, c, d = x.shape
    log("kernels", f"grouped_matmul {x.dtype} {label} E={e} C={c} d={d} "
        f"f={w.shape[2]}, {int((counts > 0).sum())} experts live, "
        f"{int(counts.sum())} rows: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, bmm over every expert {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}); kernel at "
        f"{100 * bound_ms / ms:.1f}% of bound")
    return ms, plain_ms, library_ms, bound_ms, bound_by


def phase_grouped_matmul(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(4)
    e, d, f = ARCTIC_EXPERTS
    ragged = torch.tensor(GM_RAGGED, dtype=torch.int32, device=dev)
    few = routed_counts(8, len(GM_RAGGED), 8, gen, dev)
    for a, b in ((d, f), (f, d)):                  # w_in's and w_out's
        w = gm_weights(torch.float32, len(GM_RAGGED), a, b, gen, dev)
        for counts, c, what in ((ragged, 24, "ragged"),
                                (few, 8, "8 tokens routed")):
            check_gm(gm_buffer(torch.float32, counts, c, a, gen, dev), w,
                     counts, what)
        check_gm(gm_buffer(torch.bfloat16, ragged, 24, a, gen, dev),
                 w.bfloat16(), ragged, "ragged")
        del w

    worst, row = 0.0, None
    for name, (e, d, f), top_k in (("arctic", ARCTIC_EXPERTS, 2),
                                   ("kimi", KIMI_EXPERTS, 8)):
        cfg_c = {"arctic": get_config("arctic-480b"),
                 "kimi": get_config("kimi-k2-1t-a32b")}[name]
        steps = [("decode", 8, routed_counts(8, e, capacity(8, cfg_c), gen,
                                              dev, top_k)),
                 ("prefill", 1024, routed_counts(1024, e,
                                                 capacity(1024, cfg_c), gen,
                                                 dev, top_k))]
        for a, b, wname in ((d, f, "w_in"), (f, d, "w_out")):
            w = gm_weights(torch.bfloat16, e, a, b, gen, dev)
            for step, tokens, counts in steps:
                c = capacity(tokens, cfg_c)
                x = gm_buffer(torch.bfloat16, counts, c, a, gen, dev)
                what = f"{name} {wname} {step}"
                worst = max(worst, check_gm(x, w, counts, what))
                times = time_gm(x, w, counts, what)
                if (name, wname, step) == ("arctic", "w_in", "decode"):
                    row = times
                    # one live expert: 38 units for 132 CTAs
                    one = torch.zeros_like(counts)
                    one[0] = c
                    x1 = gm_buffer(torch.bfloat16, one, c, a, gen, dev)
                    check_gm(x1, w, one, f"{what}, one expert live")
                    del x1
            del w, x
            torch.cuda.empty_cache()
    # the JSON row: arctic's w_in (and w_gate) product at a decode step,
    # the launch the main path makes most
    ms, plain_ms, library_ms, bound_ms, bound_by = row
    return {"name": "grouped_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/grouped_matmul.cu",
            "replaces": "src/repro/kernels/grouped_matmul.py:59",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


# ---------------------------------------------------------------------------
# Phases 4 to 9: the engine
# ---------------------------------------------------------------------------


def make_requests(lens, max_new: int, vocab: int, seed: int):
    rng = np.random.default_rng(seed)
    return [Request(prompt_len=n, max_new_tokens=max_new,
                    prompt_tokens=rng.integers(0, vocab, n).astype(np.int32))
            for n in lens]


def serve(eng: TorchEngine, reqs, stagger: bool = False) -> dict:
    """Submit ``reqs`` and step the engine until idle (the loop of
    ``run_until_idle``), timing each step kind apart.  With ``stagger``
    the first request is prefilled alone before the others arrive, so
    that a prompt prefix it shares with them is cached for them.  A step
    that made a program (a graph capture, or without graphs the first
    run of the step's static buffers) is timed apart as ``build_s``, not
    in its kind's mean."""
    waiting = list(reqs)
    if stagger:
        eng.submit(waiting.pop(0))
    times = {"prefill": 0.0, "decode": 0.0, "mixed": 0.0}
    steps = dict.fromkeys(times, 0)
    tokens = dict.fromkeys(times, 0)
    decode_tokens, build_s = 0, 0.0
    while eng.busy or waiting:
        if waiting and (not stagger or reqs[0].state in (
                RequestState.RUNNING, RequestState.FINISHED)):
            for r in waiting:
                eng.submit(r)
            waiting = []
        before = eng.tokens_generated
        made = sum(eng.step_captures.values())
        t0 = time.perf_counter()
        kind = eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if kind.value in ("decode", "mixed"):
            decode_tokens += eng.tokens_generated - before
        if sum(eng.step_captures.values()) > made:
            build_s += dt
        elif kind.value in times:
            times[kind.value] += dt
            steps[kind.value] += 1
            tokens[kind.value] += eng.tokens_generated - before
    for r in reqs:
        if r.state != RequestState.FINISHED or \
                len(r.output_tokens) != r.max_new_tokens:
            raise AssertionError(f"{r.req_id} ended {r.state} with "
                                 f"{len(r.output_tokens)} tokens")
        if not all(0 <= t < eng.cfg.vocab for t in r.output_tokens):
            raise AssertionError(f"{r.req_id} emitted an out-of-vocab id")
    return {"times": times, "steps": steps, "tokens": tokens,
            "build_s": build_s, "decode_tokens": decode_tokens}


def mean_ms(res: dict, kind: str) -> float:
    """Mean wall time of ``kind``'s steps in a ``serve`` result, ms."""
    return 1e3 * res["times"][kind] / max(res["steps"][kind], 1)


KERNELS = {"paged_decode_attention": paged_decode_attention,
           "paged_flash_attention": paged_flash_attention,
           "flash_attention": flash_attention,
           "decode_attention": decode_attention,
           "ssm_scan": ssm_scan,
           "grouped_matmul": grouped_matmul}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def moe_layers(cfg) -> int:
    return sum(seg.repeat * n for seg in cfg.plan()
               for spec, n in seg.pattern if spec.moe)


def kind_layers(cfg, kinds) -> int:
    """Decoder layers whose block kind is one of ``kinds``."""
    return sum(seg.repeat * n for seg in cfg.plan()
               for spec, n in seg.pattern if spec.kind in kinds)


def expected_launches(eng: TorchEngine, prefills: int, decodes: int,
                      mixed: int = 0, single: int = 0) -> dict:
    """Launches of each kernel on a run of ``eng`` that ran ``prefills``
    serialized prefill forwards (the ring layout one per prompt; the
    paged layout one per chunk, and the scheduler's token budget splits a
    step's prompts into chunks), ``single`` of them a paged chunk of one
    token, and ``decodes`` and ``mixed`` bodies of the decode and mixed
    steps (a graph's warm-up runs and replays, or the eager calls): one
    per attention layer per prefill (flash; ring) or per decode row set
    (the layout's decode kernel; a mixed step's decode rows), one paged
    flash per attention layer per paged prefill chunk of more than one
    token and per mixed step's chunk (a chunk of one token runs the
    paged decode kernel), one SSM scan per prefill in each layer with a
    matrix memory (a hybrid's mamba branch, an mLSTM layer; ring), and
    three grouped_matmul per MoE layer per forward (either layout; a
    mixed step is two forwards, its decode rows and its chunk); none
    without the flag, and none on the CPU, where the wrappers take the
    plain versions."""
    want = dict.fromkeys(KERNELS, 0)
    if eng.cfg.use_pallas and eng.device.type == "cuda":
        n = kind_layers(eng.cfg, ("attn", "dec", "hymba"))
        if eng.cache_layout == "paged":
            want["paged_decode_attention"] = n * (decodes + mixed + single)
            want["paged_flash_attention"] = n * (prefills - single + mixed)
        else:
            want["flash_attention"] = n * prefills
            want["decode_attention"] = n * decodes
            want["ssm_scan"] = kind_layers(eng.cfg,
                                           ("hymba", "mlstm")) * prefills
        want["grouped_matmul"] = (3 * moe_layers(eng.cfg)
                                  * (prefills + decodes + 2 * mixed))
    return want


def count_prefill_work(eng: TorchEngine) -> list:
    """Count the serialized prefill work items and the prefill tokens
    (serialized or in a mixed step's chunk) the scheduler hands ``eng``
    from now on: each serialized item is one forward (a whole prompt on
    the ring layout, a chunk on the paged one).  Returns ``[forwards,
    tokens, single]``, updated as the engine steps; ``single`` counts the
    paged forwards of one token (``TorchEngine._run_prefill_paged``'s
    chunk, the prompt's last token where the rest was cached)."""
    count = [0, 0, 0]
    plan_step = eng.scheduler.plan_step

    def counted():
        plan = plan_step()
        if plan.kind == StepKind.PREFILL:
            count[0] += len(plan.prefills)
            for w in plan.prefills:
                start = min(w.req.prefilled, w.req.prompt_len - 1)
                count[2] += min(w.chunk, w.req.prompt_len - start) == 1
        count[1] += sum(w.chunk for w in plan.prefills)
        return plan
    eng.scheduler.plan_step = counted
    return count


def served_counts(eng: TorchEngine, reqs, before: dict,
                  stagger: bool = False) -> dict:
    """Serve ``reqs`` and check each kernel's launches on that run."""
    forwards = count_prefill_work(eng)
    runs = dict(eng.step_runs)
    res = serve(eng, reqs, stagger)
    runs = {k: eng.step_runs[k] - runs.get(k, 0) for k in ("decode", "mixed")}
    after = launch_counts()
    used = {k: after[k] - before[k] for k in KERNELS}
    if eng.scheduler.preempt_count:
        raise AssertionError(f"{eng.name}: unexpected preemption")
    if eng.cache_layout == "ring" and forwards[0] != len(reqs):
        raise AssertionError(f"{eng.name}: {forwards[0]} ring prefills for "
                             f"{len(reqs)} prompts")
    res["prefill_forwards"], res["prefill_tokens"] = forwards[:2]
    res["runs"] = runs
    want = expected_launches(eng, forwards[0], runs["decode"], runs["mixed"],
                             0 if eng.cache_layout == "ring" else forwards[2])
    if used != want:
        raise AssertionError(f"{eng.name}: kernel launches {used}, "
                             f"expected {want}")
    res["launches"] = used
    return res


PARITY_LENS = [100, 333, 517, 700]
PARITY_SCHED = dict(max_slots=4, num_pages=40, page_size=128,
                    max_context=1024)
PARITY_SWA = (256, 128)          # window, attn_chunk: a 384-slot ring
MIGRATE_LEN = 517
LAYOUTS = [("paged", True), ("paged", False), ("ring", True),
           ("ring", False)]


def small_engine(cfg, params, layout: str, use_pallas: bool, dev,
                 name: str, graphs: bool = True, **sched) -> TorchEngine:
    return TorchEngine(cfg.replace(use_pallas=use_pallas), params,
                       SchedulerConfig(**PARITY_SCHED, **sched), name=name,
                       cache_layout=layout, device=dev,
                       cuda_graphs=None if graphs else False)


def phase_parity(dev, cfg, params, layouts=LAYOUTS,
                 label: str = "agent-7b width, 2 layers", windows=None,
                 eager: bool = False) -> None:
    """Greedy tokens equal across ``layouts`` (layout, kernels on or
    off), for each (window, attn_chunk) of ``windows``: by default full
    attention and the ``PARITY_SWA`` window, whose ring is shorter than
    the longer prompts.  A window of None keeps the config's own.  With
    ``eager`` the first of ``layouts`` also runs without CUDA graphs."""
    if windows is None:
        windows = ((-1, cfg.attn_chunk), PARITY_SWA)
    runs = [(lay, on, True) for lay, on in layouts]
    if eager:
        runs.append((*layouts[0], False))
    for window, chunk in windows:
        c = cfg.replace(attn_chunk=chunk)
        if window is not None:
            c = c.replace(window=window)
        outs = {}
        for layout, use_pallas, graphs in runs:
            eng = small_engine(c, params, layout, use_pallas, dev,
                               f"parity-{layout}-{use_pallas}", graphs)
            if layout == "ring" and c.window > 0:
                size = min(e["kv"].k.shape[-3] for seg in
                           eng.cache["segments"] for e in seg.values()
                           if "kv" in e)
                if not size < max(PARITY_LENS):
                    raise AssertionError(f"ring of {size} slots does not "
                                         f"wrap")
            reqs = make_requests(PARITY_LENS, 16, cfg.vocab, seed=1)
            served_counts(eng, reqs, launch_counts())
            outs[layout, use_pallas, graphs] = [list(r.output_tokens)
                                                for r in reqs]
            release(eng)
        first = outs[runs[0]]
        for key, got in outs.items():
            if got != first:
                raise AssertionError(f"window {c.window}: {key} disagrees "
                                     f"with {runs[0]}:\n{got}\n{first}")
        how = ("paged and ring, with and without their kernels"
               if len({lay for lay, _ in layouts}) > 1
               else f"{layouts[0][0]}, with and without its kernels")
        if eager:
            how += ", graph and eager"
        log("parity", f"{label}, f32, window {c.window}, attn_chunk {chunk}, "
            f"prompts {PARITY_LENS}: greedy tokens equal across {how} "
            f"({sum(map(len, first))} tokens each)")


def start_and_extract(eng: TorchEngine, prompt, at: int, max_new: int):
    """Serve ``prompt`` until ``at`` tokens are out, then export it and
    drop it from ``eng``.  Returns (state, tokens so far)."""
    r = Request(prompt_len=len(prompt), max_new_tokens=max_new,
                prompt_tokens=prompt)
    eng.submit(r)
    while r.generated < at:
        eng.step()
    state = eng.extract_state(r)
    first = list(r.output_tokens)
    eng.scheduler.preempt_one()
    return state, first


def admit_migrated(eng: TorchEngine, prompt, at: int, max_new: int):
    r = Request(prompt_len=len(prompt), max_new_tokens=max_new,
                prompt_tokens=prompt)
    r.generated = at
    r.prefilled = r.prompt_len
    if not eng.scheduler.admit_direct(r):
        raise AssertionError(f"{eng.name}: no room for the migrated request")
    return r


def phase_migrate(dev, cfg, params) -> None:
    at, max_new = 4, 16
    prompt = make_requests([MIGRATE_LEN], max_new, cfg.vocab,
                           seed=5)[0].prompt_tokens

    def fresh(layout, name, c=cfg):
        return small_engine(c, params, layout, True, dev, name)

    want = {}
    for layout in ("ring", "paged"):
        r = make_requests([MIGRATE_LEN], max_new, cfg.vocab, seed=5)[0]
        serve(fresh(layout, f"unmigrated-{layout}"), [r])
        want[layout] = list(r.output_tokens)
    for src, dst in (("ring", "paged"), ("paged", "ring"), ("ring", "ring")):
        state, first = start_and_extract(fresh(src, f"{src}-src"), prompt, at,
                                         max_new)
        eng = fresh(dst, f"{dst}-dst")
        r = admit_migrated(eng, prompt, at, max_new)
        eng.inject_state(r, state)
        eng.run_until_idle()
        if first + r.output_tokens != want[src]:
            raise AssertionError(f"{src}->{dst} migration changed the tokens:"
                                 f"\n{first + r.output_tokens}\n{want[src]}")
        log("migrate", f"{src}->{dst} after {at} tokens "
            f"({state['nbytes'] / 2**20:.1f} MiB of state): the continued "
            f"{max_new - at} tokens equal the unmigrated run's")

    window, chunk = PARITY_SWA
    swa = cfg.replace(window=window, attn_chunk=chunk)
    state, _ = start_and_extract(fresh("paged", "swa-src", swa), prompt, at,
                                 max_new)
    eng = fresh("ring", "swa-dst", swa)
    r = admit_migrated(eng, prompt, at, max_new)
    try:
        eng.inject_state(r, state)
    except ValueError as e:
        log("migrate", f"paged->ring with window {window} refused: {e}")
    else:
        raise AssertionError("paged->ring with a window was not refused")


def phase_hymba_migrate(dev, cfg, params) -> None:
    """Ring->ring migration of a hybrid: the exported tree carries every
    layer's SSM state beside its ring, and the continued tokens equal an
    unmigrated run's."""
    at, max_new = 4, 16
    r = make_requests([MIGRATE_LEN], max_new, cfg.vocab, seed=5)[0]
    serve(small_engine(cfg, params, "ring", True, dev, "unmigrated"), [r])
    want = list(r.output_tokens)
    state, first = start_and_extract(
        small_engine(cfg, params, "ring", True, dev, "hymba-src"),
        r.prompt_tokens, at, max_new)
    ssm_bytes = sum(cache_utils.cache_nbytes(e["ssm"]) for seg in
                    state["cache"]["segments"] for e in seg.values())
    eng = small_engine(cfg, params, "ring", True, dev, "hymba-dst")
    r2 = admit_migrated(eng, r.prompt_tokens, at, max_new)
    eng.inject_state(r2, state)
    eng.run_until_idle()
    if first + r2.output_tokens != want:
        raise AssertionError(f"hymba ring->ring migration changed the "
                             f"tokens:\n{first + r2.output_tokens}\n{want}")
    log("migrate", f"hymba ring->ring after {at} tokens "
        f"({state['nbytes'] / 2**20:.1f} MiB of state, of which "
        f"{ssm_bytes / 2**20:.2f} MiB SSM state): the continued "
        f"{max_new - at} tokens equal the unmigrated run's")


SERVE_SCHED = dict(max_slots=8, num_pages=512, page_size=128,
                   max_context=4096)


SERVE_LENS = [int(x) for x in np.random.default_rng(2).integers(256, 1025,
                                                                  8)]


# the eager reruns of the serve phases: the first 16 new tokens of each
# request, held to the graph run's
EAGER_NEW = 16
# the eager reruns' profiles (each admits 8 more sequences and decodes 14
# eager steps beside the 4 it profiles) run in agent-7b's paged and ring
# serve phases only; every other eager rerun keeps its token and launch
# checks, and every graph run its profile (cut for phase 38's time)
EAGER_PROFILES = ("serve", "serve ring")


def release(eng: TorchEngine) -> None:
    """Free ``eng``'s graphs (their memory pools) and its cache."""
    eng.release_graphs()
    eng.cache = None
    gc.collect()
    torch.cuda.empty_cache()


def held_run(how: str, hold: bool):
    """The block's kernel calls held to their plain versions
    (``kernelwise`` with paged decode, paged flash and the scan) where
    ``hold`` and ``how`` is the eager run, whose steps call the wrappers
    (a graph run replays them); else a block that holds nothing."""
    if hold and how == "eager":
        return kernelwise(paged=True, scan=True)
    return contextlib.nullcontext()


def report_held(phase: str, kw) -> None:
    """Hold ``held_run``'s calls to the bf16 band and print them."""
    if not isinstance(kw, kernelwise):
        return
    err = kw.max_err()
    if not err <= TOL[torch.bfloat16]:
        raise AssertionError(f"{phase}: a kernel call differs from its "
                             f"plain version by {err} (relative)")
    log(phase, f"eager run: every kernel call held to its plain version on "
        f"the path's inputs ({kw.calls}): max |kernel - plain| {err:.3e} of "
        f"the output's largest magnitude (tolerance "
        f"{TOL[torch.bfloat16]:.0e})")


def phase_serve(dev, cfg, params, layout: str, phase: str,
                max_new: int = 64, prefill_profile: bool = False,
                sched=None, hold: bool = False) -> dict:
    """The full model serves the 8 requests on ``layout``, its decode
    steps replayed as CUDA graphs, then an eager engine serves the same
    prompts for their first ``EAGER_NEW`` tokens: those greedy tokens are
    equal, and every kernel of the path launches exactly as often as
    expected in both runs.  Returns the
    counts of the graph run.  A profile of four decode steps follows
    the graph run (and the eager run in ``EAGER_PROFILES``' phases), and
    with ``prefill_profile`` one of the longest prompt's prefill the
    graph run.  With ``hold`` every attention kernel call of the eager
    run is held to its plain version on its own inputs
    (``held_run``)."""
    out = {}
    for how in ("graph", "eager"):
        eng = TorchEngine(cfg, params,
                          SchedulerConfig(**(sched or SERVE_SCHED)),
                          name=f"serve-{layout}-{how}", cache_layout=layout,
                          device=dev,
                          cuda_graphs=None if how == "graph" else False)
        n_new = max_new if how == "graph" else min(max_new, EAGER_NEW)
        reqs = make_requests(SERVE_LENS, n_new, cfg.vocab, seed=3)
        torch.cuda.reset_peak_memory_stats()
        if how == "graph":
            for fn in KERNELS.values():         # the main path's counts
                fn.launches = 0
        with held_run(how, hold) as kw:
            res = served_counts(eng, reqs, launch_counts())
        report_held(phase, kw)
        dec = res["times"]["decode"]
        log(phase, f"{layout} layout, kernels "
            f"{'on' if cfg.use_pallas else 'off'}, {how} decode steps, 8 "
            f"requests, prompts {SERVE_LENS}, {n_new} new tokens each: all "
            f"FINISHED; {eng.prefill_steps} prefill steps "
            f"{res['times']['prefill']:.3f} s, {eng.decode_steps} decode "
            f"steps, mean decode step {mean_ms(res, 'decode'):.2f} ms over "
            f"the {res['steps']['decode']} after the first (which took "
            f"{res['build_s']:.3f} s; a graph run captures there), decode "
            f"{res['tokens']['decode'] / dec:.1f} tokens/s; captures "
            f"{dict(eng.step_captures)}; kernel launches {res['launches']} "
            f"({cfg.n_layers} layers, {len(reqs)} prompts in "
            f"{res['prefill_forwards']} prefill forwards, decode bodies "
            f"{res['runs']['decode']}); max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if how == "graph" or phase in EAGER_PROFILES:
            profile_decode(eng, mean_ms(res, "decode"), phase, how)
        if prefill_profile and how == "graph":
            profile_prefill(eng, max(SERVE_LENS), phase)
        out[how] = ([list(r.output_tokens) for r in reqs], res)
        release(eng)
    compare_runs(phase, out)
    return out["graph"][1]["launches"]


def compare_runs(phase: str, out: dict) -> None:
    """The graph and eager runs' greedy tokens are equal over the eager
    run's tokens (its first ``EAGER_NEW`` of each request); their mean
    step times side by side."""
    (g_tok, g), (e_tok, e) = out["graph"], out["eager"]
    g_tok = [t[:len(u)] for t, u in zip(g_tok, e_tok)]   # eager's first
    if g_tok != e_tok:
        raise AssertionError(f"{phase}: graph and eager tokens differ:\n"
                             f"{g_tok}\n{e_tok}")
    times = ", ".join(
        f"{kind} step {mean_ms(g, kind):.2f} vs {mean_ms(e, kind):.2f} ms "
        f"({mean_ms(e, kind) / mean_ms(g, kind):.2f}x)"
        for kind in ("decode", "mixed") if g["steps"][kind])
    log(phase, f"graph vs eager: mean {times}; greedy tokens equal "
        f"({sum(map(len, g_tok))} tokens)")


# the mixed parity phase: a second wave of prompts over one 256-token
# prefix (two pages of 128), after a chunk move
MIXED_PREFIX = 256
MIXED_SUFFIXES = [60, 200, 450, 131]
MIXED_CHUNK = 200


def attach_prefix_cache(eng: TorchEngine) -> PrefixCache:
    """A PrefixCache over the engine's allocator, blocks of one page."""
    page = eng.scheduler.cfg.page_size
    return eng.attach_cache(PrefixCache(
        eng.scheduler.alloc, name=f"{eng.name}.cache", instance=eng.name,
        block_tokens=page, reserve_frac=0.8))


def shared_prefix_requests(n_prefix: int, suffixes, max_new: int,
                           vocab: int, seed: int):
    """Requests whose prompts share one ``n_prefix``-token prefix, each
    with its own suffix of the given lengths."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, n_prefix).astype(np.int32)
    return [Request(prompt_len=n_prefix + n, max_new_tokens=max_new,
                    prompt_tokens=np.concatenate(
                        [prefix, rng.integers(0, vocab, n).astype(np.int32)]))
            for n in suffixes]


def phase_mixed_parity(dev, cfg, params) -> None:
    """The mixed step with its CUDA graphs against the serialized eager
    run, kernels on and off: wave 1 the parity prompts, wave 2 prompts
    over one 256-token prefix after a ``prefill_chunk`` move, once
    without and once with a PrefixCache (wave 2's first prompt prefilled
    alone, so the others find its prefix).  Greedy tokens are equal,
    every launch count is exact, and the mixed step is captured once.
    Each capture's warm-up runs under sync debug mode "error"."""
    def waves():
        return (make_requests(PARITY_LENS, 16, cfg.vocab, seed=1),
                shared_prefix_requests(MIXED_PREFIX, MIXED_SUFFIXES, 16,
                                       cfg.vocab, seed=8))

    for use_pallas in (True, False):
        c = cfg.replace(use_pallas=use_pallas)
        tokens = {}
        for how in ("serialized eager", "mixed graph", "mixed graph cached"):
            mixed = how != "serialized eager"
            eng = TorchEngine(c, params, SchedulerConfig(
                **PARITY_SCHED, mixed=mixed), name=f"parity-{how}",
                cache_layout="paged", device=dev,
                cuda_graphs=None if mixed else False)
            if how.endswith("cached"):
                attach_prefix_cache(eng)
            w1, w2 = waves()
            served_counts(eng, w1, launch_counts())
            eng.set_param("prefill_chunk", MIXED_CHUNK)
            res = served_counts(eng, w2, launch_counts(), stagger=True)
            tokens[how] = [list(r.output_tokens) for r in w1 + w2]
            cached = sum(r.meta.get("cached_prompt_tokens", 0) for r in w2)
            if mixed and eng.mixed_step_traces != 1:
                raise AssertionError(f"{how}: {eng.mixed_step_traces} "
                                     f"captures of the mixed step")
            if how.endswith("cached") and cached == 0:
                raise AssertionError("wave 2 found no cached prefix")
            log("mixed parity", f"kernels {'on' if use_pallas else 'off'}, "
                f"{how}: wave 2 prefilled {res['prefill_tokens']} of "
                f"{sum(r.prompt_len for r in w2)} prompt tokens ({cached} "
                f"cached); captures {dict(eng.step_captures)}, body runs "
                f"{dict(eng.step_runs)}")
            release(eng)
        want = tokens["serialized eager"]
        for how, got in tokens.items():
            if got != want:
                raise AssertionError(f"{how} disagrees with the serialized "
                                     f"eager run:\n{got}\n{want}")
        log("mixed parity", f"agent-7b width, 2 layers, f32, kernels "
            f"{'on' if use_pallas else 'off'}: greedy tokens equal across "
            f"{list(tokens)} ({sum(map(len, want))} tokens each); the mixed "
            f"step captured once across two waves and a prefill_chunk move")


# serve mixed: prefill_chunk 512 and a token budget of one chunk beside
# the 8 decode rows, so the chunk buffer (the budget) pads a chunk by at
# most 8 tokens beyond its fill
MIXED_SCHED = dict(SERVE_SCHED, mixed=True, prefill_chunk=512,
                   max_batch_tokens=520)
SYSTEM_PROMPT = 1024


def phase_serve_mixed(dev, cfg, params, phase: str,
                      max_new: int = 64, hold: bool = False) -> dict:
    """The full model serves, paged, with the mixed step and a
    PrefixCache: the 8 requests of phase 6, then 8 requests over one
    1024-token system prompt with their own 64-256-token suffixes (the
    first prefilled alone), every decode and mixed step replayed as a
    CUDA graph; then an eager engine serves the same prompts for their
    first ``EAGER_NEW`` tokens.  Those greedy tokens are equal and every
    launch count is exact in both runs.  With ``hold`` the eager run's
    attention kernel calls are held to their plain versions
    (``held_run``).  Returns the graph run's counts."""
    out = {}
    for how in ("graph", "eager"):
        eng = TorchEngine(cfg, params, SchedulerConfig(**MIXED_SCHED),
                          name=f"mixed-{how}", cache_layout="paged",
                          device=dev,
                          cuda_graphs=None if how == "graph" else False)
        attach_prefix_cache(eng)
        n_new = max_new if how == "graph" else min(max_new, EAGER_NEW)
        w1 = make_requests(SERVE_LENS, n_new, cfg.vocab, seed=3)
        suffixes = np.random.default_rng(9).integers(64, 257, 8)
        w2 = shared_prefix_requests(SYSTEM_PROMPT, suffixes, n_new,
                                    cfg.vocab, seed=10)
        torch.cuda.reset_peak_memory_stats()
        if how == "graph":
            for fn in KERNELS.values():         # the main path's counts
                fn.launches = 0
        t0 = time.perf_counter()
        with held_run(how, hold) as kw:
            r1 = served_counts(eng, w1, launch_counts())
            r2 = served_counts(eng, w2, launch_counts(), stagger=True)
        wall = time.perf_counter() - t0
        report_held(phase, kw)
        launches = launch_counts()
        res = {k: {kind: r1[k][kind] + r2[k][kind] for kind in r1[k]}
               for k in ("times", "steps", "tokens")}
        computed = r1["prefill_tokens"] + r2["prefill_tokens"]
        uncached = sum(r.prompt_len for r in w1 + w2)
        log(phase, f"{how} steps, mixed, prefill_chunk 512, a PrefixCache; "
            f"wave 1: the 8 prompts {SERVE_LENS}; wave 2: 8 prompts of a "
            f"{SYSTEM_PROMPT}-token system prompt and suffixes "
            f"{suffixes.tolist()}; {n_new} new tokens each: all FINISHED "
            f"in {wall:.3f} s; prefill tokens computed {computed} of "
            f"{uncached} uncached (wave 2: {r2['prefill_tokens']} of "
            f"{sum(r.prompt_len for r in w2)}); mean decode step "
            f"{mean_ms(res, 'decode'):.2f} ms ({res['steps']['decode']} "
            f"steps), mean mixed step {mean_ms(res, 'mixed'):.2f} ms "
            f"({res['steps']['mixed']} steps), the first step of each kind "
            f"(a graph run's captures) {r1['build_s'] + r2['build_s']:.3f} "
            f"s; "
            f"{sum(res['tokens'].values()) / sum(res['times'].values()):.1f}"
            f" tokens/s over the decode and mixed steps; captures "
            f"{dict(eng.step_captures)}; kernel launches {launches} (body "
            f"runs {dict(eng.step_runs)}); max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if how == "graph" or phase in EAGER_PROFILES:
            profile_decode(eng, mean_ms(res, "decode"), phase, how)
            profile_mixed(eng, mean_ms(res, "mixed"), phase, how)
        out[how] = ([list(r.output_tokens) for r in w1 + w2], res)
        if how == "graph":
            main = launches
        release(eng)
    compare_runs(phase, out)
    return main


# ---------------------------------------------------------------------------
# The control plane and tool-call suspend/resume over live engines
# ---------------------------------------------------------------------------

# a request parks after CONTROL_AT of its tokens, for CONTROL_HOLD steps
# of other traffic
CONTROL_AT = 4
CONTROL_HOLD = 8
CONTROL_TRAFFIC = 333                # the prompt decoding beside a parked one


def host_gates(eng: TorchEngine, req: Request, mem_before: int) -> int:
    """A host-tier suspend left pinned CPU tensors of ``nbytes`` in the
    engine's host store, and the device holds no more memory than before
    it.  Returns the bytes."""
    state = eng._host_store[req.req_id]
    leaves = cache_utils._leaves(state["cache"])
    bad = [tuple(t.shape) for t in leaves if t.device.type != "cpu"
           or (eng.device.type == "cuda" and not t.is_pinned())]
    if bad:
        raise AssertionError(f"{eng.name}: host-tier leaves not in pinned "
                             f"host memory: {bad[:4]}")
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    if nbytes != state["nbytes"]:
        raise AssertionError(f"host store {nbytes} B, nbytes "
                             f"{state['nbytes']}")
    if torch.cuda.memory_allocated() > mem_before:
        raise AssertionError(f"{eng.name}: device memory grew across the "
                             f"offload ({mem_before} -> "
                             f"{torch.cuda.memory_allocated()} B)")
    return nbytes


def park(eng: TorchEngine, prompt, max_new: int) -> Request:
    """Serve ``prompt`` until ``CONTROL_AT`` tokens are out."""
    r = Request(prompt_len=len(prompt), max_new_tokens=max_new,
                prompt_tokens=prompt)
    eng.submit(r)
    while r.generated < CONTROL_AT:
        eng.step()
    return r


def phase_control_parity(dev, cfg, params) -> None:
    """Tool-call suspend/resume on live engines in f32: a request parked
    in its slot (pin) or in pinned host memory (host) while another
    decodes beside it, then resumed on its engine or migrated to a
    sibling from the host tier, continues with an unsuspended run's
    greedy tokens; paged (serialized and mixed) and ring, kernels on.
    The pinned slot's ``pos`` does not move across the hold."""
    max_new = 16
    prompt, other = (r.prompt_tokens for r in make_requests(
        [MIGRATE_LEN, CONTROL_TRAFFIC], max_new, cfg.vocab, seed=5))
    for layout, mixed in (("paged", False), ("paged", True),
                          ("ring", False)):
        def fresh(name):
            return small_engine(cfg, params, layout, True, dev, name,
                                mixed=mixed, host_capacity_pages=16)

        r = Request(prompt_len=len(prompt), max_new_tokens=max_new,
                    prompt_tokens=prompt)
        serve(fresh("unsuspended"), [r])
        want = list(r.output_tokens)
        what = f"{layout}{' mixed' if mixed else ''}"
        for tier in ("pin", "host", "migrate"):
            eng = fresh(f"control-{tier}")
            r = park(eng, prompt, max_new)
            pos = int(eng.cache["pos"][r.slot])
            mem = torch.cuda.memory_allocated()
            got = eng.suspend_request(r, offload=tier != "pin")
            if got != ("pin" if tier == "pin" else "host"):
                raise AssertionError(f"{what} {tier}: suspended to {got}")
            nbytes = host_gates(eng, r, mem) if tier != "pin" else 0
            eng.submit(Request(prompt_len=len(other), max_new_tokens=max_new,
                               prompt_tokens=other))
            for _ in range(CONTROL_HOLD):
                eng.step()
            if tier == "pin":
                if int(eng.cache["pos"][r.slot]) != pos:
                    raise AssertionError(
                        f"{what}: the pinned slot's pos moved from {pos} "
                        f"to {int(eng.cache['pos'][r.slot])}")
                home = eng
                landed = eng.resume_suspended(r)
            elif tier == "host":
                home = eng
                landed = eng.resume_suspended(r)
            else:
                home = fresh("control-dst")
                landed = "hit" if eng.migrate_suspended(r, home) else "none"
            if landed != ("pin" if tier == "pin" else "hit"):
                raise AssertionError(f"{what} {tier}: resumed as {landed}")
            eng.run_until_idle()
            home.run_until_idle()
            if list(r.output_tokens) != want:
                raise AssertionError(
                    f"{what} {tier}: tokens changed across the suspend:\n"
                    f"{list(r.output_tokens)}\n{want}")
            if any(v != 1 for e in {eng, home}
                   for v in e.step_captures.values()):
                raise AssertionError(f"{what} {tier}: captures "
                                     f"{dict(eng.step_captures)}")
            log("control parity", f"agent-7b width, 2 layers, f32, {what}: "
                f"{tier} after {CONTROL_AT} tokens, {CONTROL_HOLD} steps of "
                f"a {CONTROL_TRAFFIC}-token request beside it"
                + (f", {nbytes / 2**20:.1f} MiB in pinned host memory"
                   if nbytes else f", pos held at {pos}")
                + f": the {max_new} tokens equal the unsuspended run's")
            release(eng)
            if home is not eng:
                release(home)


# serve control: two engines over one set of weights, llm-0 taking the
# traffic, llm-1 the migrated request
CONTROL_SCHED = dict(MIXED_SCHED, host_capacity_pages=64)
CONTROL_LENS = [int(x) for x in np.random.default_rng(4).integers(256, 1025,
                                                                   16)]
CONTROL_PARK_AT = 16                 # tokens out before a request parks
CONTROL_PARK_FOR = 24                # steps of llm-0 it stays parked
# serve_llm's intent, its two rules also moving the chunk knob of the
# captured mixed step, and a rule first that reopens admission when
# llm-0 runs nothing: the shed rule holds every LOW request, and with
# eight of them waiting queue_len never falls to 2 by itself
CONTROL_INTENT = """
objective: minimize p95(llm-0.latency)
rule drain: when last(llm-0.num_running) <= 0
    => reset llm-0.admit_priority_min
rule shed: when last(llm-0.queue_len) > 6
    => set llm-0.admit_priority_min 1; set llm-0.prefill_chunk 256
rule open: when last(llm-0.queue_len) <= 2
    => reset llm-0.admit_priority_min; reset llm-0.prefill_chunk
"""
CONTROL_ACTIONS = [("set", "llm-0", "admit_priority_min=1"),
                   ("set", "llm-0", "prefill_chunk=256"),
                   ("reset", "llm-0", "admit_priority_min"),
                   ("reset", "llm-0", "prefill_chunk")]


def control_requests(vocab: int) -> list:
    """16 requests, every third INTERACTIVE and the rest LOW."""
    reqs = make_requests(CONTROL_LENS, 64, vocab, seed=4)
    for i, r in enumerate(reqs):
        r.priority = Priority.INTERACTIVE if i % 3 == 0 else Priority.LOW
    return reqs


def serve_control(dev, cfg, params, how: str, suspend: bool) -> dict:
    """Serve the 16 requests on llm-0 under ``CONTROL_INTENT``, the
    controller ticking between steps as serve_llm's loop does, a Tracer
    on both engines.  With ``suspend`` requests 0 and 1 are pinned and
    2 and 3 offloaded to the host after ``CONTROL_PARK_AT`` tokens, held
    ``CONTROL_PARK_FOR`` steps; then 0-2 resume on llm-0 and 3 migrates
    to llm-1.  Returns the run's tokens, times and counts."""
    engines, collector = [], Collector("serve")
    for name in ("llm-0", "llm-1"):
        engines.append(TorchEngine(
            cfg, params, SchedulerConfig(**CONTROL_SCHED), name=name,
            collector=collector, cache_layout="paged", device=dev,
            cuda_graphs=None if how == "graph" else False))
    llm0, llm1 = engines
    registry, poller, controller = wire(llm0, collector, CONTROL_INTENT)
    registry.register(llm1)
    tracer = Tracer(llm0.now)
    tracer.set_scope(None, 1.0)
    for e in engines:
        e.tracer = tracer
    reqs = control_requests(cfg.vocab)
    parked = {}                             # index -> (tier, step, pos)
    moves, times = [], {"decode": [], "mixed": [], "control": []}
    runs = {e.name: dict(e.step_runs) for e in engines}
    forwards = {e.name: count_prefill_work(e) for e in engines}
    torch.cuda.reset_peak_memory_stats()
    for r in reqs:
        llm0.submit(r)
    t0 = time.perf_counter()
    while any(e.busy for e in engines):
        for e in engines:
            if not e.busy:
                continue
            made = sum(e.step_captures.values())
            t = time.perf_counter()
            kind = e.step()
            torch.cuda.synchronize()
            if sum(e.step_captures.values()) == made and \
                    kind.value in ("decode", "mixed") and e is llm0:
                times[kind.value].append(time.perf_counter() - t)
        t = time.perf_counter()
        tick(llm0, poller, controller)
        times["control"].append(time.perf_counter() - t)
        if not suspend:
            continue
        for i, r in enumerate(reqs[:4]):
            if i not in parked and r.generated >= CONTROL_PARK_AT:
                tier = "pin" if i < 2 else "host"
                pos = int(llm0.cache["pos"][r.slot])
                mem = torch.cuda.memory_allocated()
                t = time.perf_counter()
                got = llm0.suspend_request(r, offload=tier == "host")
                dt = time.perf_counter() - t
                if got != tier:
                    raise AssertionError(f"request {i} suspended to {got}")
                parked[i] = (tier, llm0.steps, pos)
                if tier == "host":
                    moves.append((i, "extract", host_gates(llm0, r, mem),
                                  dt))
            elif i in parked and parked[i][1] is not None and \
                    llm0.steps - parked[i][1] >= CONTROL_PARK_FOR:
                tier, _, pos = parked[i]
                if tier == "pin" and int(llm0.cache["pos"][r.slot]) != pos:
                    raise AssertionError(
                        f"request {i}: the pinned slot's pos moved from "
                        f"{pos} to {int(llm0.cache['pos'][r.slot])}")
                nbytes = llm0._host_store.get(r.req_id, {}).get("nbytes", 0)
                t = time.perf_counter()
                if i == 3:
                    landed = "hit" if llm0.migrate_suspended(r, llm1) \
                        else "none"
                else:
                    landed = llm0.resume_suspended(r)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t
                if landed != ("pin" if tier == "pin" else "hit"):
                    raise AssertionError(f"request {i} resumed as {landed}")
                parked[i] = (tier, None, pos)
                if tier == "host":
                    moves.append((i, "inject" if i < 3 else "migrate",
                                  nbytes, dt))
    wall = time.perf_counter() - t0
    for r in reqs:
        if r.state != RequestState.FINISHED or \
                len(r.output_tokens) != r.max_new_tokens:
            raise AssertionError(f"{r.req_id} ended {r.state} with "
                                 f"{len(r.output_tokens)} tokens")
    if suspend and sorted(parked) != [0, 1, 2, 3]:
        raise AssertionError(f"parked only {sorted(parked)}")
    log_ = [(a.kind, a.target, a.detail) for a in controller.actions]
    if log_ != CONTROL_ACTIONS:
        raise AssertionError(f"controller actions {log_}, expected "
                             f"{CONTROL_ACTIONS}")
    for e in engines:
        caps = dict(e.step_captures)
        if any(v != 1 for v in caps.values()) or (
                e is llm0 and set(caps) != {"decode", "mixed"}):
            raise AssertionError(f"{e.name}: captures {caps}")
    used = {e.name: {k: e.step_runs[k] - runs[e.name].get(k, 0)
                     for k in ("decode", "mixed")} for e in engines}
    want = dict.fromkeys(KERNELS, 0)
    for e in engines:
        pf = forwards[e.name]
        for k, v in expected_launches(e, pf[0], used[e.name]["decode"],
                                      used[e.name]["mixed"], pf[2]).items():
            want[k] += v
    return {"tokens": [list(r.output_tokens) for r in reqs], "times": times,
            "moves": moves, "wall": wall, "runs": used, "want": want,
            "pins": {i: p[2] for i, p in parked.items() if p[0] == "pin"},
            "captures": {e.name: dict(e.step_captures) for e in engines},
            "spans": tracer.spans_total, "engines": engines,
            "peak": torch.cuda.max_memory_allocated()}


def ms(xs) -> float:
    return 1e3 * sum(xs) / max(len(xs), 1)


def phase_serve_control(dev, cfg, params, phase: str = "serve control"
                        ) -> dict:
    """The control plane over two live engines at full agent-7b: the
    suspended run with its CUDA graphs, the same run eager, and an
    unsuspended graph run; every gate of ``serve_control``, exact
    kernel launch counts, graph and eager tokens equal, and each resumed
    request's tokens against the unsuspended run's.  Returns the graph
    run's launches."""
    out, gpu = {}, card()
    for how, suspend in (("graph", True), ("eager", True),
                         ("unsuspended", False)):
        if how == "graph":
            for fn in KERNELS.values():         # the main path's counts
                fn.launches = 0
        before = launch_counts()
        res = serve_control(dev, cfg, params,
                            "eager" if how == "eager" else "graph", suspend)
        after = launch_counts()
        used = {k: after[k] - before[k] for k in KERNELS}
        if used != res["want"]:
            raise AssertionError(f"{phase} {how}: kernel launches {used}, "
                                 f"expected {res['want']}")
        t = res["times"]
        log(phase, f"{how}, {gpu}: 16 requests (prompts {CONTROL_LENS}, "
            f"64 new tokens, every third INTERACTIVE) on llm-0, all "
            f"FINISHED in {res['wall']:.3f} s; mean decode step {ms(t['decode']):.2f} ms "
            f"({len(t['decode'])} steps), mean mixed step "
            f"{ms(t['mixed']):.2f} ms ({len(t['mixed'])} steps), controller "
            f"poll + tick {ms(t['control']):.3f} ms a step "
            f"({len(t['control'])} ticks); captures {res['captures']}; "
            f"body runs {res['runs']}; kernel launches {used}; tracer spans "
            f"{res['spans']}; max_memory_allocated "
            f"{res['peak'] / 2**30:.2f} GiB")
        for i, kind, nbytes, dt in res["moves"]:
            log(phase, f"{how}: request {i} host tier {kind} "
                f"{nbytes / 2**20:.1f} MiB in {1e3 * dt:.3f} ms, "
                f"{nbytes / dt / 1e9:.2f} GB/s (pinned host memory)")
        for i, pos in res["pins"].items():
            log(phase, f"{how}: request {i} pinned at pos {pos}, held "
                f"across {CONTROL_PARK_FOR} steps")
        for e in res.pop("engines"):
            release(e)
        out[how] = res
        if how == "graph":
            main = used
    g, e, u = (out[k]["tokens"] for k in ("graph", "eager", "unsuspended"))
    if g != e:
        raise AssertionError(f"{phase}: graph and eager tokens differ")
    for i in range(4):
        same = sum(a == b for a, b in zip(g[i], u[i]))
        first = next((k for k, (a, b) in enumerate(zip(g[i], u[i]))
                      if a != b), None)
        log(phase, f"request {i} ({('pin', 'pin', 'host', 'migrate')[i]}): "
            f"{same} of {len(u[i])} tokens equal the unsuspended run's"
            + ("" if first is None else f"; first differs at token {first}"))
    log(phase, f"graph vs eager: mean decode step "
        f"{ms(out['graph']['times']['decode']):.2f} vs "
        f"{ms(out['eager']['times']['decode']):.2f} ms, mixed step "
        f"{ms(out['graph']['times']['mixed']):.2f} vs "
        f"{ms(out['eager']['times']['mixed']):.2f} ms; greedy tokens equal "
        f"({sum(map(len, g))} tokens)")
    return main


# the decode attention kernels' names in a profile: the split kernels of
# either layout and the merge they share
DECODE_KERNELS = ("paged_split_kernel", "decode_split_kernel",
                  "split_merge_kernel")


# the prompts of the profiled windows: a prompt is one 512-token chunk
PROFILE_LEN = 512


def profile_steps(eng: TorchEngine, steps: int):
    """Profile the engine's next ``steps`` steps: (their kinds, device
    rows)."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        kinds = [eng.step() for _ in range(steps)]
        torch.cuda.synchronize()
    return kinds, device_rows(prof)


def log_profile(phase: str, what: str, rows, step_ms: float,
                steps: int) -> bool:
    """The busy and idle share of ``steps`` profiled steps against the
    unprofiled mean step time; False if the profile lists no device
    time (CUPTI showing no kernel of a replayed graph)."""
    device_ms = sum(r[0] for r in rows) / 1e3 / steps
    if device_ms == 0:
        log("profile", f"{phase}: {what}: the profile lists no device "
            f"time (no kernel of a replayed graph); see the eager step")
        return False
    log("profile", f"{phase}: {what}: device busy {device_ms:.2f} ms of "
        f"{step_ms:.2f} ms unprofiled ({100 * device_ms / step_ms:.1f}% "
        f"busy, {100 * (1 - device_ms / step_ms):.1f}% idle); "
        f"{sum(r[1] for r in rows) / steps:.0f} kernels and copies per "
        f"step")
    return True


def profile_decode(eng: TorchEngine, step_ms: float, phase: str,
                   how: str = "eager", steps: int = 4) -> None:
    """Where a decode step's time goes, after the counted run: device
    time by kernel over ``steps`` decode steps (``how``: graph replays or
    eager) of 8 fresh ``PROFILE_LEN``-token sequences, against the
    unprofiled mean decode step time."""
    # a mixed engine's first sequences decode while the last prefill
    reqs = make_requests([PROFILE_LEN] * 8, steps + 10, eng.cfg.vocab,
                         seed=4)
    for r in reqs:
        eng.submit(r)
    while any(r.state in (RequestState.QUEUED, RequestState.PREFILL)
              for r in reqs):
        eng.step()                                   # admit + prefill
    kinds, rows = profile_steps(eng, steps)
    eng.run_until_idle()
    if any(k != StepKind.DECODE for k in kinds):
        raise AssertionError(f"profiled {kinds}, not decode steps")
    if not log_profile(phase, f"decode step ({how})", rows, step_ms, steps):
        return
    attn = [r for r in rows if any(k in r[2] for k in DECODE_KERNELS)]
    log("profile", f"{phase}: decode attention kernels (split and merge): "
        f"{sum(r[0] for r in attn) / 1e3 / steps:.3f} ms/step in "
        f"{sum(r[1] for r in attn) / steps:.0f} calls/step")
    for us, count, key in sorted(rows, reverse=True)[:8]:
        log("profile", f"  {phase}: {us / 1e3 / steps:8.3f} ms/step  "
            f"{count / steps:6.0f} calls/step  {key[:90]}")


def profile_mixed(eng: TorchEngine, step_ms: float, phase: str, how: str,
                  steps: int = 4) -> None:
    """Where a mixed step's time goes: 8 fresh ``PROFILE_LEN``-token
    prompts, the first prefilled alone, then ``steps`` mixed steps (a
    chunk beside one to four decode rows) profiled, against the
    unprofiled mean mixed step time of the served run."""
    reqs = make_requests([PROFILE_LEN] * 8, 2, eng.cfg.vocab, seed=4)
    for r in reqs:
        eng.submit(r)
    eng.step()                              # the first chunk, no decode row
    kinds, rows = profile_steps(eng, steps)
    eng.run_until_idle()
    if any(k != StepKind.MIXED for k in kinds):
        raise AssertionError(f"profiled {kinds}, not mixed steps")
    if not log_profile(phase, f"mixed step ({how})", rows, step_ms, steps):
        return
    busy = sum(r[0] for r in rows)
    by_class: dict = {}
    for us, _, key in rows:
        by_class[kernel_class(key)] = by_class.get(kernel_class(key), 0) + us
    dec = sum(r[0] for r in rows if any(k in r[2] for k in DECODE_KERNELS))
    flash = by_class.get("flash", 0)
    log("profile", f"{phase}: mixed step ({how}) attention: the chunk's "
        f"paged flash (class flash) {flash / 1e3 / steps:.3f} ms/step "
        f"({100 * flash / busy:.1f}% of the device time), the decode rows' "
        f"paged decode {dec / 1e3 / steps:.3f} ms/step "
        f"({100 * dec / busy:.1f}%); by class: "
        + ", ".join(f"{k} {v / 1e3 / steps:.3f} ms/step" for k, v in
                    sorted(by_class.items(), key=lambda kv: -kv[1])))
    for us, count, key in sorted(rows, reverse=True)[:6]:
        log("profile", f"  {phase} mixed: {us / 1e3 / steps:8.3f} ms/step  "
            f"{count / steps:6.0f} calls/step  {key[:90]}")


def device_rows(prof) -> list:
    """(device us, calls, name) of each kernel and copy in a profile.
    Device-side events only: a CPU op's self device time repeats the time
    of the kernels it launched."""
    return [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]


SCAN_KERNELS = ("ssm_chunk_state_kernel", "ssm_state_pass_kernel",
                "ssm_chunk_output")


def profile_prefill(eng: TorchEngine, prompt_len: int, phase: str) -> None:
    """Where a ring prefill's time goes: one ``prompt_len``-token prompt
    prefilled alone, once unprofiled for its wall time (and, in a model
    with sLSTM layers, their share of it, between CUDA events around
    each layer), then once under the profiler for device time by kernel
    and the flash and SSM scan shares."""
    def prefill(prof=None) -> float:
        r = make_requests([prompt_len], 2, eng.cfg.vocab, seed=6)[0]
        eng.submit(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while r.state != RequestState.RUNNING:
            eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if prof is not None:
            prof.stop()
        eng.run_until_idle()
        return 1e3 * dt

    with slstm_timer() as slstm:
        wall_ms = prefill()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts, acc_events=True)
    prof.start()
    prefill(prof)
    rows = device_rows(prof)
    device_ms = sum(r[0] for r in rows) / 1e3
    flash_ms = sum(r[0] for r in rows if kernel_class(r[2]) == "flash") / 1e3
    log("profile", f"{phase}: prefill of one {prompt_len}-token prompt: "
        f"device busy {device_ms:.2f} ms of {wall_ms:.2f} ms unprofiled "
        f"({100 * device_ms / wall_ms:.1f}% busy); flash_attention "
        f"{flash_ms:.3f} ms ({100 * flash_ms / device_ms:.1f}% of the "
        f"device time, {100 * flash_ms / wall_ms:.1f}% of the wall time); "
        f"{sum(r[1] for r in rows)} kernels and copies")
    scan = [r for r in rows if any(k in r[2] for k in SCAN_KERNELS)]
    if scan:
        scan_ms = sum(r[0] for r in scan) / 1e3
        share = 100 * scan_ms / device_ms
        log("profile", f"{phase}: prefill's ssm_scan kernels (chunk states, "
            f"state pass, chunk outputs): {scan_ms:.3f} ms in "
            f"{sum(r[1] for r in scan)} launches ({share:.1f}% of the "
            f"device time, {100 * scan_ms / wall_ms:.1f}% of the wall "
            f"time)")
    if slstm.calls:
        log("profile", f"{phase}: prefill's sLSTM layers (a token loop of "
            f"plain PyTorch ops, no kernel of their own): {slstm.ms:.2f} ms "
            f"between events in {slstm.calls} layers, "
            f"{100 * slstm.ms / wall_ms:.1f}% of the wall time")
    for us, count, key in sorted(rows, reverse=True)[:8]:
        log("profile", f"  {phase} prefill: {us / 1e3:8.3f} ms  {count:6d} "
            f"calls  {key[:90]}")


class slstm_timer:
    """Within the block, every ``ssm.slstm_block`` call (an sLSTM layer's
    prefill) runs between two CUDA events; ``ms`` sums their spans and
    ``calls`` counts them."""

    def __enter__(self):
        self.calls, self._spans, self._real = 0, [], ssm.slstm_block

        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self._real(*args, **kw)
            end.record()
            self._spans.append((start, end))
            self.calls += 1
            return out
        ssm.slstm_block = timed
        return self

    def __exit__(self, *exc):
        ssm.slstm_block = self._real
        torch.cuda.synchronize()
        self.ms = sum(a.elapsed_time(b) for a, b in self._spans)
        return False


# ---------------------------------------------------------------------------
# Every architecture of the repo: the kernels on this slice's paths, the
# VLM's patch path and the encoder-decoder at the model level
# ---------------------------------------------------------------------------

# the dense configs this slice serves, and the seamless encoder's frames
SLICE_DENSE = ("gemma3-27b", "h2o-danube-3-4b", "llama3-405b",
               "command-r-plus-104b", "qwen2-vl-2b")
ENC_FRAMES = 1000                # not a multiple of 128
ENC_BATCH = 8
ENC_PROMPT = 32                  # decoder prompt tokens
ENC_STEPS = 64
VISION_GRID = (16, 16)           # 256 patch embeddings
VISION_TEXT = 64
def config_heads(name: str) -> tuple[int, int, int]:
    """(Hkv, G, dh) of a config's attention."""
    c = get_config(name)
    return c.n_kv_heads, c.n_heads // c.n_kv_heads, c.d_head


def phase_new_paths(dev) -> None:
    """Each kernel on this slice's paths against its plain version at the
    shapes those paths give it, f32 and bf16: both decode kernels and
    causal flash at each new dense config's heads (qwen2-vl's G 6,
    command-r's 12, llama3's 16, danube's dh 120, gemma3's G 2), flash
    non-causal at the seamless encoder's self attention (T = 1000) and
    its prefill's cross attention, ring decode as the cross attention of
    a decode step (all 1000 keys valid), and the SSM scan at the inputs
    an mLSTM layer of xlstm-350m gives it (dk 512, dv 513); then G 6's
    chunk timed against the others (``time_group_chunks``)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    live = torch.tensor([c > 0 for c in CTX], device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        for name in SLICE_DENSE:
            hkv, g, dh = heads = config_heads(name)
            for window in (-1, 512):
                args = kernel_case(dtype, 128, gen, dev, heads)
                err = (paged_decode_attention(*args, window=window).float()
                       - paged_decode_attention_plain(
                           *args, window=window).float())[live]
                check("paged_decode_attention", err.abs().max().item(), dtype,
                      f"{dtype} {name} Hkv={hkv} G={g} dh={dh} window "
                      f"{window}, live rows")
                args = ring_case(dtype, 4096, gen, dev, heads=heads)
                err = (decode_attention(*args, window=window).float()
                       - decode_attention_plain(*args, window=window).float()
                       )[live]
                check("decode_attention", err.abs().max().item(), dtype,
                      f"{dtype} {name} Hkv={hkv} G={g} dh={dh} 4096 slots "
                      f"window {window}, live rows")
            check_flash(dtype, (hkv * g, hkv, dh), 1, 700, 700, True, -1,
                        gen, dev)
        enc = config_heads("seamless-m4t-large-v2")
        enc_heads = (enc[0] * enc[1], enc[0], enc[2])
        check_flash(dtype, enc_heads, 2, ENC_FRAMES, ENC_FRAMES, False, -1,
                    gen, dev)
        check_flash(dtype, enc_heads, 2, 300, ENC_FRAMES, False, -1, gen, dev)
        q, k, v, _, _ = ring_case(dtype, ENC_FRAMES, gen, dev, heads=enc)
        b = q.shape[0]
        kpos = torch.arange(ENC_FRAMES, dtype=torch.int32,
                            device=dev)[None].expand(b, -1).contiguous()
        q_pos = torch.full((b,), ENC_FRAMES - 1, dtype=torch.int32,
                           device=dev)
        out = decode_attention(q, k, v, kpos, q_pos)
        err = (out.float() - decode_attention_plain(q, k, v, kpos, q_pos)
               .float()).abs().max().item()
        check("decode_attention", err, dtype, f"{dtype} cross attention of "
              f"a seamless decode step: B={b} Hkv={enc[0]} G={enc[1]} "
              f"dh={enc[2]}, all {ENC_FRAMES} keys valid")
        cfg = get_config("xlstm-350m").replace(
            dtype=str(dtype).removeprefix("torch."))
        p = prm.init_params(ssm.mlstm_defs(cfg), gen, dtype, dev)
        x = torch.randn((1, ENC_FRAMES, cfg.d_model), generator=gen,
                        device=dev).to(dtype)
        xr = rmsnorm(p["norm"], x, cfg.norm_eps)
        q, k, v_aug, log_a, _ = ssm._mlstm_proj(p, xr, cfg)
        _, nh, dh = ssm.mlstm_dims(cfg)
        h0 = torch.zeros((1, nh, dh, dh + 1), device=dev)
        y, h_t = ssm_scan(q, k, v_aug, log_a, h0)
        want_y, want_h = ssm_scan_plain(q, k, v_aug, log_a, h0)
        # v is unscaled here (|v| ~ 20 at the reference's init, |y| ~
        # 1e3), so the error is taken relative to the largest |y|, |h_T|
        err = max(((y.float() - want_y.float()).abs().max()
                   / want_y.float().abs().max()).item(),
                  ((h_t - want_h).abs().max() / want_h.abs().max()).item())
        check("ssm_scan", err, dtype, f"{dtype} inside an xlstm-350m mLSTM "
              f"layer: T={ENC_FRAMES} H={nh} dk={dh} dv={dh + 1} (y and h_T, "
              f"relative to their largest magnitude, "
              f"{want_y.float().abs().max().item():.1f} and "
              f"{want_h.abs().max().item():.1f})", tol=SCAN_TOL[dtype])
    time_group_chunks(gen, dev)


# the query heads a decode CTA takes at G = 6 (the kernels instantiate
# chunks of 1 to 5; group_chunk takes 3, two chunks of 3)
GROUP_CHUNKS = (2, 3, 4, 5)


def time_group_chunks(gen: torch.Generator, dev) -> None:
    """Both decode kernels, bf16, at qwen2-vl's heads (Hkv 2, G 6, dh
    128) with each chunk of GROUP_CHUNKS in place of group_chunk's, on
    the CTX rows and at SERVE_CTX, each held to its plain version: the
    numbers behind G 6's chunk (PERF.md)."""
    heads = config_heads("qwen2-vl-2b")
    mods = [sys.modules[f.__module__]
            for f in (paged_decode_attention, decode_attention)]
    chosen = mods[0].group_chunk(heads[1])
    for label, ctx in (("CTX", CTX), ("serve", SERVE_CTX)):
        live = torch.tensor([c > 0 for c in ctx], device=dev)
        cases = [("paged", paged_decode_attention,
                  kernel_case(torch.bfloat16, 128, gen, dev, heads, ctx=ctx),
                  paged_decode_attention_plain),
                 ("ring", decode_attention,
                  ring_case(torch.bfloat16, 4096, gen, dev, heads=heads,
                            ctx=ctx), decode_attention_plain)]
        times = {}
        for kernel, fn, args, plain in cases:
            want = plain(*args).float()[live]
            for gc in GROUP_CHUNKS:
                real = [m.group_chunk for m in mods]
                for m in mods:
                    m.group_chunk = lambda g, gc=gc: gc
                try:
                    err = (fn(*args).float()[live] - want).abs().max().item()
                    check(fn.__name__, err, torch.bfloat16,
                          f"qwen2-vl heads, {label} contexts, chunks of {gc}")
                    times[kernel, gc] = cuda_ms(lambda: fn(*args), 100)
                finally:
                    for m, r in zip(mods, real):
                        m.group_chunk = r
            ms = " / ".join(f"{times[kernel, gc]:.4f}" for gc in GROUP_CHUNKS)
            log("kernels", f"{fn.__name__} bf16 Hkv={heads[0]} G={heads[1]} "
                f"dh={heads[2]}, {label} contexts, chunks of "
                f"{'/'.join(map(str, GROUP_CHUNKS))} heads: {ms} ms "
                f"(group_chunk takes {chosen})")


def greedy_run(params, cfg, prefill, steps: int, forced=None):
    """Prefill (``prefill(cfg, params)`` -> (logits, cache)) and ``steps``
    decode steps of greedy tokens; with ``forced`` (B, steps + 1) the
    tokens fed are those instead.  Returns the greedy tokens (B, steps +
    1)."""
    logits, cache = prefill(cfg, params)
    toks = []
    for i in range(steps + 1):
        tok = logits.argmax(-1)
        toks.append(tok)
        if i == steps:
            break
        feed = tok if forced is None else forced[:, i]
        logits, cache = models.decode_step(params, cfg, feed[:, None], cache)
    return torch.stack(toks, 1)


def greedy_equal_check(phase: str, params, cfg, prefill, steps: int,
                       what: str) -> None:
    """f32, at a depth where rounding does not decide a token: the greedy
    tokens with the kernels on and off are equal."""
    t_on = greedy_run(params, cfg.replace(use_pallas=True), prefill, steps)
    t_off = greedy_run(params, cfg.replace(use_pallas=False), prefill, steps)
    if not torch.equal(t_on, t_off):
        raise AssertionError(f"{phase}: greedy tokens differ, kernels on vs "
                             f"off:\n{t_on}\n{t_off}")
    log(phase, f"{what}, f32: greedy tokens equal, kernels on vs off "
        f"({t_on.numel()} tokens)")


def ring_rows(q, k, v, kpos, q_pos, *, window: int = -1, **_):
    """(B,) bool: the ring decode rows with a valid slot."""
    kp, qp = kpos.long(), q_pos.long()[:, None]
    valid = (kp >= 0) & (kp <= qp)
    if window > 0:
        valid &= kp > qp - window
    return valid.any(-1)


def paged_rows(q, k_pages, v_pages, block_tables, ctx_lens, **_):
    """(B,) bool: the paged decode rows with a context (a served batch's
    idle slots have none)."""
    return ctx_lens > 0


def paged_flash_rows(q, k_pages, v_pages, block_tables, q_pos, *,
                     window: int = -1):
    """(B, S) bool: the paged flash rows with a valid key (a mixed chunk's
    pad tail has none)."""
    return paged_live_rows(block_tables, q_pos, k_pages.shape[1], window)


def live_only(x, rows):
    """``x`` (an output, or an (out, lse) pair) with its rows that have
    no valid key zeroed: the kernel writes zeros there, the plain version
    the uniform average of an all-masked softmax.  ``rows`` is (B,) or,
    for a call of many query rows, (B, S)."""
    if isinstance(x, tuple):
        return (live_only(x[0], rows), x[1])
    return torch.where(rows.view(*rows.shape, *[1] * (x.dim() - rows.dim())),
                       x.float(), 0.0)


class kernelwise:
    """Within the block, every call the model makes to the flash and ring
    decode wrappers and to the combine of a sequence-sharded ring also
    runs the wrapper's plain version on the same inputs; ``max_err()`` is
    the largest |kernel - plain| over the plain output's largest
    magnitude (the path's activations reach ~30, where one bf16 unit is
    0.125) and, for ring decode with its log-sum-exp, the largest
    |kernel - plain| of the log-sum-exps of the rows with a valid key
    (the empty rows' NEG_INF must agree exactly); ``calls`` counts the
    calls held.  The combine is held with ``combine=True`` (a
    sequence-sharded ring's serve steps), paged decode and paged flash
    with ``paged=True`` (a served batch's eager steps); the rows with no
    valid key (idle slots, a mixed chunk's pad tail) are not held."""

    KERNELS = {"flash_attention": flash_attention_plain,
               "decode_attention": decode_attention_plain}
    # the rows of a call held (the others come out as zeros from the
    # kernel): ring and paged decode's rows with a valid key
    ROWS = {"decode_attention": ring_rows,
            "paged_decode_attention": paged_rows,
            "paged_flash_attention": paged_flash_rows}

    def __init__(self, combine: bool = False, paged: bool = False,
                 scan: bool = False):
        self.scan = scan
        if combine:
            self.KERNELS = {**self.KERNELS,
                            "attention_combine": attention_combine_plain}
        if paged:
            self.KERNELS = {**self.KERNELS,
                            "paged_decode_attention":
                                paged_decode_attention_plain,
                            "paged_flash_attention":
                                paged_flash_attention_plain}

    def __enter__(self):
        self.errs, self.calls = [], dict.fromkeys(self.KERNELS, 0)
        self._real = {n: getattr(attention, n) for n in self.KERNELS}
        for name, plain in self.KERNELS.items():
            def both(*args, _real=self._real[name], _plain=plain,
                     _name=name, **kw):
                out = _real(*args, **kw)
                with torch.no_grad():
                    got, want = out, _plain(*args, **kw)
                    if _name in self.ROWS:
                        rows = self.ROWS[_name](*args, **kw)
                        got, want = live_only(got, rows), live_only(want,
                                                                    rows)
                    self.errs.append(call_err(got, want))
                self.calls[_name] += 1
                return out
            setattr(attention, name, both)
        if self.scan:                 # the matrix memories' chunked scan
            self._scan = ssm.ssm_scan
            self.calls["ssm_scan"] = 0

            def scan_both(*args, **kw):
                y, h_t = self._scan(*args, **kw)
                with torch.no_grad():
                    want_y, want_h = ssm_scan_plain(*args, **kw)
                    self.errs.append(torch.maximum(call_err(y, want_y),
                                                   call_err(h_t, want_h)))
                self.calls["ssm_scan"] += 1
                return y, h_t
            ssm.ssm_scan = scan_both
        return self

    def __exit__(self, *exc):
        for name, real in self._real.items():
            setattr(attention, name, real)
        if self.scan:
            ssm.ssm_scan = self._scan
        return False

    def max_err(self) -> float:
        return torch.stack(self.errs).max().item() if self.errs else 0.0


def call_err(got, want) -> torch.Tensor:
    """A kernel call's output against its plain version's: |difference|
    over the plain output's largest magnitude; with a log-sum-exp (an
    (out, lse) pair), the larger of that and the log-sum-exps' largest
    |difference| over the rows with a valid key, infinite where the two
    disagree on which rows are empty."""
    if isinstance(got, tuple):
        (out, lse), (w_out, w_lse) = got, want
        empty = w_lse <= 0.5 * attention.NEG_INF
        if not torch.equal(lse <= 0.5 * attention.NEG_INF, empty):
            return torch.tensor(float("inf"), device=out.device)
        d = (lse - w_lse).abs()[~empty]
        return torch.maximum(call_err(out, w_out),
                             d.max() if d.numel() else torch.zeros(
                                 (), device=out.device))
    want = want.float()
    if not want.numel():         # a call on a rank that holds no row
        return torch.zeros((), device=want.device)
    return ((got.detach().float() - want).abs().max()
            / want.abs().max().clamp_min(1e-30))


def kernelwise_check(phase: str, params, cfg, prefill, steps: int,
                     what: str) -> dict:
    """The full model with the kernels on, every attention kernel call
    held to its plain version on the inputs the path gives it (relative
    to the output's magnitude, within the bf16 band of 2e-2).

    The model's own tokens are not compared with the kernels off at this
    depth: at the reference's init rule attention is close to a hard max
    (q and k projections drawn with the head count as fan-in: scores of
    standard deviation 64 to 314 at seamless's, agent-7b's and
    qwen2-vl's heads), so a rounding difference in one layer's output
    moves the next layer's scores by O(0.1) and a random-init stack
    amplifies it layer by layer (at qwen2-vl's width a kernels-on and a
    kernels-off f32 prefill differ by 0, 6.7e-6, 2.2e-4, 0.18 and 1.6 in
    logits of ~3.7 at 1, 2, 4, 8 and 12 layers on the CPU; in bf16 one
    seamless decoder layer's output already moves by up to 3% of its
    norm between the two paths on the card).  The cut-depth f32 runs
    (``greedy_equal_check``) hold the tokens.  Returns the run's
    launches."""
    before = launch_counts()
    t0 = time.perf_counter()
    with kernelwise() as kw:
        greedy_run(params, cfg.replace(use_pallas=True), prefill, steps)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    err = kw.max_err()
    if not err <= TOL[torch.bfloat16]:
        raise AssertionError(f"{phase}: a kernel call differs from its "
                             f"plain version by {err} (relative)")
    log(phase, f"{what}, {cfg.dtype}, kernels on: "
        f"{time.perf_counter() - t0:.2f} s with the checks, kernel launches "
        f"{launched}; every call held to its plain version on the path's "
        f"inputs ({kw.calls}): max |kernel - plain| {err:.3e} of the "
        f"output's largest magnitude (tolerance "
        f"{TOL[torch.bfloat16]:.0e})")
    return launched


def cut_depth(params, n: int, dtype: torch.dtype):
    """The first ``n`` layers of each single-segment stack (decoder, and
    the encoder where there is one), cast to ``dtype``."""
    out = prm.tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                       {k: v for k, v in params.items()
                        if k not in ("decoder", "encoder")})
    for part in ("decoder", "encoder"):
        if part in params:
            out[part] = [prm.tree_map(lambda t: t[:n].to(dtype), seg)
                         for seg in params[part]]
    return out


def vision_positions(b: int, n_text: int, dev,
                     grid: tuple | None = None) -> torch.Tensor:
    """(B, P + n_text, 3) int32: the patches of ``grid`` (VISION_GRID by
    default) at (0, row, col), then text whose three streams run on
    together from max(grid)."""
    gh, gw = grid or VISION_GRID
    hh, ww = torch.meshgrid(torch.arange(gh, device=dev),
                            torch.arange(gw, device=dev), indexing="ij")
    vis = torch.stack([torch.zeros_like(hh), hh, ww], -1).reshape(gh * gw,
                                                                  3)
    text = (max(gh, gw) + torch.arange(n_text, device=dev))[:, None]
    pos = torch.cat([vis, text.expand(-1, 3)]).to(torch.int32)
    return pos[None].expand(b, -1, -1).contiguous()


def phase_vision(dev, cfg, params) -> None:
    """qwen2-vl at the model level: a prefill whose first 256 slots are
    patch embeddings at 3-axis (t, h, w) positions over a 16 x 16 grid,
    then 64 text tokens whose three streams run on together, and 16
    decode steps; kernels on against off, in f32 at 2 layers (greedy
    tokens equal) and in the served bf16 at full depth
    (``kernelwise_check``)."""
    gh, gw = VISION_GRID
    p = gh * gw
    gen = torch.Generator(device=dev).manual_seed(11)
    b = 2
    tokens = torch.randint(0, cfg.vocab, (b, p + VISION_TEXT), generator=gen,
                           device=dev)
    emb = torch.randn((b, p, cfg.d_model), generator=gen, device=dev)
    pos = vision_positions(b, VISION_TEXT, dev)

    def prefill(cc, pp):
        cache = models.init_cache(cc, b, p + VISION_TEXT + 32, device=dev)
        return models.prefill(pp, cc, tokens, cache, positions=pos,
                              vision_embeds=emb.to(prm.torch_dtype(cc.dtype)))
    what = (f"{p} patch embeddings at 3-axis positions + {VISION_TEXT} text "
            f"tokens, B={b}, 16 decode steps")
    small = cut_depth(params, 2, torch.float32)
    greedy_equal_check("vision", small, cfg.replace(n_layers=2,
                                                    dtype="float32"),
                       prefill, 16, f"qwen2-vl-2b, 2 layers, {what}")
    free(small)
    launched = kernelwise_check("vision", params, cfg, prefill, 16,
                                f"qwen2-vl-2b, {cfg.n_layers} layers, "
                                f"{what}")
    n = cfg.n_layers if dev.type == "cuda" else 0   # the CPU: plain versions
    if launched["flash_attention"] != n or \
            launched["decode_attention"] != 16 * n:
        raise AssertionError(f"vision: kernel launches {launched}")


def phase_encdec(dev, cfg, params) -> dict:
    """seamless-m4t at the model level: the encoder over 8 x 1000 frame
    embeddings (non-causal flash), a 32-token decoder prefill (causal
    flash over the prompt, non-causal flash over the memory) and 64
    decode steps (ring decode over each layer's own ring and over its
    cross K/V); kernels on against off, in f32 at 1 + 1 layers (greedy
    tokens equal; at 2 + 2 the f32 logits already differ by up to 0.19
    of 5.8 on the card and 3 of 520 near ties flip) and in the served
    bf16 at full depth (``kernelwise_check``).  Returns the full-depth
    kernels-on run's launches."""
    gen = torch.Generator(device=dev).manual_seed(12)
    frames = torch.randn((ENC_BATCH, ENC_FRAMES, cfg.d_model), generator=gen,
                         device=dev)
    tokens = torch.randint(0, cfg.vocab, (ENC_BATCH, ENC_PROMPT),
                           generator=gen, device=dev)

    def prefill(cc, pp):
        cache = models.init_cache(cc, ENC_BATCH, ENC_PROMPT + ENC_STEPS + 1,
                                  device=dev, enc_len=ENC_FRAMES)
        return models.prefill(pp, cc, tokens, cache,
                              frames=frames.to(prm.torch_dtype(cc.dtype)))
    what = (f"{ENC_BATCH} x {ENC_FRAMES} frames, {ENC_PROMPT}-token prompts, "
            f"{ENC_STEPS} decode steps")
    small = cut_depth(params, 1, torch.float32)
    greedy_equal_check("encdec", small, cfg.replace(
        n_layers=1, enc_layers=1, dtype="float32"), prefill, ENC_STEPS,
        f"seamless-m4t-large-v2, 1 + 1 layers, {what}")
    free(small)
    launched = kernelwise_check(
        "encdec", params, cfg, prefill, ENC_STEPS,
        f"seamless-m4t-large-v2, {cfg.enc_layers} + {cfg.n_layers} layers, "
        f"{what}")
    n, e = cfg.n_layers, cfg.enc_layers
    if dev.type != "cuda":                   # the CPU: plain versions
        n = e = 0
    want = {"flash_attention": e + 2 * n,
            "decode_attention": 2 * n * ENC_STEPS}
    if any(launched[k] != v for k, v in want.items()):
        raise AssertionError(f"encdec: kernel launches {launched}, expected "
                             f"{want}")
    return launched


# Gemma 3 12B's and Llama 3.2 3B's published widths and attention (the
# models' config.json: hidden_size, num_attention_heads,
# num_key_value_heads, head_dim, intermediate_size), made with .replace
# on the repo's gemma3-27b and llama3-405b, whose structure they share
# (5:1 local:global over a 1024 window, qk-norm and softcap; plain GQA)
GEMMA3_12B = dict(d_model=3840, n_heads=16, n_kv_heads=8, d_head=256,
                  d_ff=15360)
LLAMA32_3B = dict(d_model=3072, n_heads=24, n_kv_heads=8, d_head=128,
                  d_ff=8192)
# past the kernels' old limits (ROADMAP A7.1): agent-7b's width with heads
# of 512 (8 query heads over 4 KV heads, G 2); xlstm-350m at the xLSTM
# paper's 1.3B width (arXiv:2405.04517: d_model 2048, with the repo's 4
# heads and ssm_expand 2 an mLSTM of dk 1024, dv 1025)
AGENT7B_D512 = dict(d_head=512, n_heads=8, n_kv_heads=4)
XLSTM_13B = dict(d_model=2048)
# one layer at each new width, f32 (gemma3: one local layer, its window
# cut to PARITY_SWA's so its ring wraps, and one global; xlstm: one mLSTM
# and one sLSTM layer; danube's window cut likewise): (config, cut,
# windows for phase_parity, layouts)
WIDTH_PARITY = [
    ("gemma3-27b", dict(n_layers=2, local_global_ratio=1), [PARITY_SWA],
     LAYOUTS),
    ("h2o-danube-3-4b", dict(n_layers=1), [PARITY_SWA], LAYOUTS),
    ("llama3-405b", dict(n_layers=1), [(None, 1024)], LAYOUTS),
    ("command-r-plus-104b", dict(n_layers=1), [(None, 1024)], LAYOUTS),
    ("qwen2-vl-2b", dict(n_layers=1), [(None, 1024)], LAYOUTS),
    ("xlstm-350m", dict(n_layers=2, mlstm_ratio=1), [(None, 1024)],
     [("ring", True), ("ring", False)]),
    # the shapes the reference pads, at their models' widths: Gemma 3
    # 12B's dh 256 (one local and one global layer), Llama 3.2 3B's G 3
    ("gemma3-27b", dict(GEMMA3_12B, n_layers=2, local_global_ratio=1),
     [PARITY_SWA], LAYOUTS, "Gemma 3 12B's shape"),
    ("llama3-405b", dict(LLAMA32_3B, n_layers=1), [(None, 1024)], LAYOUTS,
     "Llama 3.2 3B's shape"),
]
# gemma3-27b's 56.8 GB of weights leave room for a pool of 128 pages (62
# MiB a page across its 62 layers) and rings of 1536 slots
GEMMA_SCHED = dict(SERVE_SCHED, num_pages=128, max_context=1536)
# the dense serve phases: (config, cut, scheduler, new tokens)
SLICE_SERVE = [
    ("gemma3-27b", {}, GEMMA_SCHED, 64),
    ("h2o-danube-3-4b", {}, None, 64),
    ("llama3-405b", dict(n_layers=2), None, 16),
    ("command-r-plus-104b", dict(n_layers=2), None, 16),
]


# the shapes the reference pads and those past the kernels' old limits,
# served and trained at full width: Gemma 3 12B's shape at 6 of its 48
# layers (one whole 5:1 cycle, ~3.4 B parameters; a 512-page pool of 3.2
# GB), Llama 3.2 3B's at 4 of its 28, agent-7b's width at d_head 512 at 4
# of its 32 (1.0 B parameters), each paged, ring and mixed with a train
# step at 2 layers, B 1 x S 4096 (Gemma: one local and one global); and
# xlstm-350m at the 1.3B width at 8 of the paper's 48 blocks (one 7:1
# cycle, 0.77 B parameters) on the ring only, the layout the port serves
# xLSTM on, with its train step at those 8 layers, B 2 x S 512 (S 1024,
# its sLSTM token loop twice as long, took 6.9 s more on an H100 80GB HBM3
# at 700 W: tools/smoke_cuts.py):
# (label, config, widths, layers, layouts, train (layers, B, S))
SERVE_LAYOUTS = ("paged", "ring", "mixed")
WIDE_MODELS = [("Gemma 3 12B's shape", "gemma3-27b", GEMMA3_12B, 6,
                SERVE_LAYOUTS, (2, 1, 4096)),
               ("Llama 3.2 3B's shape", "llama3-405b", LLAMA32_3B, 4,
                SERVE_LAYOUTS, (2, 1, 4096)),
               ("agent-7b at d_head 512", "agent-7b", AGENT7B_D512, 4,
                SERVE_LAYOUTS, (2, 1, 4096)),
               ("xLSTM 1.3B's width", "xlstm-350m", XLSTM_13B, 8, ("ring",),
                (8, 2, 512))]
# new tokens a request of the graph runs (the eager runs: EAGER_NEW)
WIDE_NEW = 64


def phase_wide(dev) -> dict:
    """[wide heads]: each of WIDE_MODELS served at full width, bf16,
    kernels on, in its layouts: 8 requests (graph runs, then eager runs
    whose greedy tokens equal theirs and whose every attention and scan
    kernel call is held to its plain version on its own inputs), exact
    launch counts; then a bf16 remat train step (finite loss, every leaf
    moved, exact launches), every flash and ssm_scan call, forward and
    backward, held to its plain version.  Returns each entry's launches
    by run: {label: {layout: the graph run's, "train": the step's}}."""
    out = {}
    for label, name, widths, layers, layouts, train in WIDE_MODELS:
        phase = f"wide heads {label}"
        cfg = get_config(name).replace(use_pallas=True, n_layers=layers,
                                       **widths)
        params = init_full(cfg, dev, phase)
        runs = out[label] = {}
        for layout in layouts:
            if layout == "mixed":
                runs[layout] = phase_serve_mixed(
                    dev, cfg, params, f"{phase} mixed", max_new=WIDE_NEW,
                    hold=True)
            else:
                runs[layout] = phase_serve(
                    dev, cfg, params, layout, f"{phase} {layout}",
                    max_new=WIDE_NEW, hold=True)
        free(params)
        n, b, seq = train
        tcfg = cfg.replace(n_layers=n, **({"local_global_ratio": 1}
                                          if cfg.local_global_ratio else {}))
        with record_flash(True) as fwd, record_flash(False) as bwd, \
                record_training_kernels() as scans:
            used = train_full(dev, f"{phase} train", tcfg, b, seq)
        worst = max(hold_flash_calls(f"{phase} train", fwd, bwd,
                                     torch.bfloat16),
                    hold_training_calls(f"{phase} train", scans,
                                        torch.bfloat16))
        log(phase, f"train: {len(fwd)} flash forward and {len(bwd)} "
            f"backward calls, {len(scans['scan_fwd'])} ssm_scan forward "
            f"and {len(scans['scan_bwd'])} backward calls held to their "
            f"plain versions, worst {worst:.3e} (relative)")
        del fwd, bwd, scans
        torch.cuda.empty_cache()
        runs["train"] = used
    return out


def init_full(cfg, dev, phase: str):
    """Random weights of ``cfg`` at full size from a seeded generator."""
    t0 = time.perf_counter()
    params = models.init(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    log(phase, f"{cfg.name}: {models.param_count(cfg) / 1e9:.3f} B params, "
        f"{cfg.n_layers} layers, {cfg.dtype}; init "
        f"{time.perf_counter() - t0:.1f} s")
    return params


def free(params) -> None:
    """Drop the last reference to ``params`` and return the memory."""
    params.clear()
    gc.collect()
    torch.cuda.empty_cache()


# the kernels of the port's redesigns, whose instantiations phase 2 lists
NEW_KERNELS = ("paged_split_kernel", "decode_split_kernel",
               "flash_fwd_tma_kernel", "flash_attention_kernel",
               "split_merge_kernel", "grouped_matmul_tma_kernel",
               "ssm_chunk_state_kernel", "ssm_state_pass_kernel",
               "ssm_chunk_output_kernel", "ssm_chunk_output_mma_kernel",
               "flash_bwd_dot_kernel", "flash_bwd_dq_f32_kernel",
               "flash_bwd_dkdv_f32_kernel", "flash_bwd_dq_tma_kernel",
               "flash_bwd_dkdv_tma_kernel", "gm_bwd_", "scan_bwd_",
               "decode_wide_kernel", "paged_wide_kernel", "flash_wide_",
               "flash_bwd_wide_")


def ptxas_entries(text: str) -> list:
    """(kernel, registers, spill-store bytes) of each entry function in
    ``nvcc -Xptxas -v`` output, names demangled where c++filt exists."""
    entries, name, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            entries.append([name, int(m.group(1)), spill])
            name = None
    if entries and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(
            e[0] for e in entries), capture_output=True, text=True,
            timeout=60).stdout.splitlines()
        if len(out) == len(entries):
            for e, n in zip(entries, out):
                e[0] = n.replace("(anonymous namespace)::", "")
    return [tuple(e) for e in entries]


# ---------------------------------------------------------------------------
# Training: the dense decoder's train step, the optimizer, checkpoints,
# the data pipeline and the supervisor, with the flash forward and
# backward kernels doing the attention
# ---------------------------------------------------------------------------

# the f32 gradient band of the 2-layer parity: the JAX package's own f32
# gradients stand up to 4.3e-3 (of each leaf's largest magnitude) from
# float64 ones at a 1024-wide cut of agent-7b on the CPU, and the
# port's two attention paths 6.7e-4 from each other there
TRAIN_F32_GRAD_TOL = 1e-2
# train: agent-7b, B 2 x S 4096 (SHAPES["train_4k"]'s sequence; its global
# batch of 256 cut to 2 for one card's step time), 1 warm-up and 4 timed
# steps; agent-1b two microbatches of B 1 x S 4096
TRAIN_MODEL, TRAIN_1B_MODEL = "agent-7b", "agent-1b"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS = 4096, 2, 1, 4
TRAIN_1B_STEPS = 2
# parity: agent-7b's width at 2 layers, B 1 x S 1024
TRAIN_PARITY_MODEL, TRAIN_PARITY_LAYERS, TRAIN_PARITY_SEQ = \
    "agent-7b", 2, 1024
# train_lm: the twin's own model and sizes, 75 steps: its failure (at
# step 50, 2/3 of the run) lands on a checkpoint (every 50 steps), so the
# resumed run replays no step (the twin appends a replayed step's loss
# again, as the reference's does)
TRAIN_LM_MODEL, TRAIN_LM_STEPS, TRAIN_LM_BATCH, TRAIN_LM_SEQ = \
    "lm-100m", 75, 8, 256


def train_batches(cfg, seq: int, batch: int, seed: int = 0):
    """The token pipeline's batches for ``cfg`` (background prefetch)."""
    return TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=batch, seed=seed))


@contextlib.contextmanager
def record_calls(module: str, name: str, keep=None):
    """Every call of ``module.name`` made inside the block, as (args,
    result), in call order, or as ``keep(args, result)`` returns them
    (a call it returns None for is not kept).  The arguments are kept
    by reference: a training step's inputs are parameters and
    activations that nothing writes in place."""
    mod = sys.modules[module]
    orig = getattr(mod, name)
    calls = []

    def rec(*args, **kw):
        res = orig(*args, **kw)
        kept = (args, res) if keep is None else keep(args, res)
        if kept is not None:
            calls.append(kept)
        return res

    setattr(mod, name, rec)
    try:
        yield calls
    finally:
        setattr(mod, name, orig)


@contextlib.contextmanager
def record_flash(forward: bool, picks=None):
    """Record the flash kernel calls made inside the block: each call's
    inputs and outputs (clones), in call order, for the calls whose
    0-based index is in ``picks`` (every call when None).  The recorded
    call still counts one launch."""
    seen = itertools.count()

    def keep(args, res):
        i = next(seen)
        if picks is not None and i not in picks:
            return None
        clone = lambda x: x.detach().clone() \
            if isinstance(x, torch.Tensor) else x  # noqa: E731
        return (i, [clone(a) for a in args],
                [clone(r) for r in (res if isinstance(res, tuple)
                                    else (res,))])

    with record_calls("repro_torch.kernels.flash_attention",
                      "_launch" if forward else "_launch_backward",
                      keep) as calls:
        yield calls


def hold_flash_calls(phase: str, fwd_calls, bwd_calls, dtype,
                     held: bool = True) -> float:
    """Each recorded forward (out, LSE) and backward (dq, dk, dv) call
    against the plain versions on that call's own inputs, relative to
    each output's largest magnitude; ``held=False`` prints the errors
    without holding them to the band.  Returns the worst error."""
    worst = 0.0

    def report(name, err, what):
        if held:
            check(name, err, dtype, what)
        else:
            log("kernels", f"{name} {what}: max |kernel - plain| "
                f"{err:.3e} (printed, not held)")
    for i, (q, k, v, causal, window, *_), (out, *lse) in fwd_calls:
        errs = [rel_err(out, flash_attention_plain(
            q, k, v, causal=causal, window=window))]
        if lse:
            errs.append(rel_err(lse[0], flash_attention_lse_plain(
                q, k, causal=causal, window=window)))
        report("flash_attention", max(errs),
               f"{phase} forward call {i}, out and LSE, relative")
        worst = max(worst, *errs)
    for i, (q, k, v, _, _, dout, causal, window), got in bwd_calls:
        want = flash_attention_backward_plain(q, k, v, dout, causal=causal,
                                              window=window)
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        report("flash_attention_backward", max(errs),
               f"{phase} backward call {i}, dq/dk/dv "
               + "/".join(f"{e:.2e}" for e in errs) + ", relative")
        worst = max(worst, *errs)
        del want
    return worst


def grads_and_loss(cfg, params, batch):
    """(loss, grads) of ``models.loss_fn`` on the card."""
    leaves, treedef = prm.flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    loss, _ = models.loss_fn(prm.unflatten(treedef, live), cfg, batch)
    return loss.detach(), torch.autograd.grad(loss, live)


def phase_train_parity(dev) -> None:
    """[train parity]: agent-7b's width at 2 layers, f32 and bf16: loss and
    every gradient leaf with the kernels on against off; every flash
    call of the kernels-on step held to its plain version; then one
    make_train_step with f32 and one with int8 moments from the same
    weights, which after one step give the same parameters."""
    phase = "train parity"
    base = get_config(TRAIN_PARITY_MODEL)
    pipe = train_batches(base, TRAIN_PARITY_SEQ, 1, seed=3)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in pipe.batch_at(0).items()}
    card_runs = dev.type == "cuda"         # the CPU: plain versions only
    n = TRAIN_PARITY_LAYERS
    for dtype in ("float32", "bfloat16"):
        cfg = base.replace(n_layers=n, dtype=dtype)
        params = models.init(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
        out = {}
        for kernels in (True, False):
            c = cfg.replace(use_pallas=kernels)
            f0, b0 = flash_attention.launches, \
                flash_attention_backward.launches
            with record_flash(True) as fw, record_flash(False) as bw:
                out[kernels] = grads_and_loss(c, params, batch)
                torch.cuda.synchronize()
            used = (flash_attention.launches - f0,
                    flash_attention_backward.launches - b0)
            if used != ((2 * n, n) if kernels and card_runs else (0, 0)):
                raise AssertionError(f"{phase}: flash launches {used}, "
                                     f"kernels {kernels} ({n} layers, remat: "
                                     f"2 forwards and 1 backward a layer)")
            if kernels:
                # f32 at this width: a random-init layer's scores have a
                # std near 120, so f32 rounding of a score moves P by
                # about 1e-4 on either side; the f32 calls are printed
                # and [kernels] holds the kernels at 2e-5 on unit inputs
                worst = hold_flash_calls(f"{phase} {dtype}", fw, bw,
                                         prm.torch_dtype(dtype),
                                         held=dtype == "bfloat16")
            del fw, bw
        (l_on, g_on), (l_off, g_off) = out[True], out[False]
        errs = [rel_err(a, b) for a, b in zip(g_on, g_off)]
        finite = all(torch.isfinite(g).all() for g in g_on + g_off)
        log(phase, f"{cfg.name} width, {n} layers, {dtype}, B 1 x S "
            f"{TRAIN_PARITY_SEQ}: "
            f"loss kernels on {l_on.item():.6f}, off {l_off.item():.6f}; "
            f"gradient leaves, |on - off| over the leaf's largest: max "
            f"{max(errs):.3e}, median {float(np.median(errs)):.3e} "
            f"({len(errs)} leaves); each kernel call within "
            f"{worst:.3e} of its plain version")
        if not finite or not torch.isfinite(l_on):
            raise AssertionError(f"{phase}: non-finite loss or gradient")
        if dtype == "float32":
            if abs(l_on.item() - l_off.item()) > 1e-4 \
                    or max(errs) > TRAIN_F32_GRAD_TOL:
                raise AssertionError(f"{phase}: f32 kernels on and off "
                                     f"disagree: {max(errs)}")
        elif abs(l_on.item() - l_off.item()) > TOL[torch.bfloat16]:
            # bf16 gradients of a random-init model at this width are
            # rounding-dominated on either path (ROADMAP §C): the leaves
            # are printed, the loss and every kernel call are held
            raise AssertionError(f"{phase}: bf16 losses disagree")
        del out, g_on, g_off

        c = cfg.replace(use_pallas=True)
        steps = {}
        for int8 in (False, True):
            acfg = AdamWConfig(lr=1e-3, warmup_steps=0, int8_moments=int8)
            p = prm.unflatten(prm.flatten(params)[1],
                              [x.clone() for x in prm.flatten(params)[0]])
            step = make_train_step(c, None, TrainPlan(int8_moments=int8),
                                   acfg, device=dev)
            p, opt, m = step(p, adamw_init(p, acfg), batch)
            torch.cuda.synchronize()
            steps[int8] = (p, m)
            log(phase, f"{dtype} make_train_step, "
                f"{'int8' if int8 else 'f32'} moments: loss "
                f"{m['loss'].item():.6f}, grad_norm "
                f"{m['grad_norm'].item():.4f}, lr {m['lr'].item():.2e}; "
                f"moments {opt_bytes(opt) / 2**20:.1f} MiB")
            del opt
        same = all(torch.equal(a, b) for a, b in zip(
            prm.flatten(steps[False][0])[0], prm.flatten(steps[True][0])[0]))
        if not same:
            raise AssertionError(f"{phase}: one step from the same weights "
                                 f"differs between f32 and int8 moments")
        log(phase, f"{dtype}: after one step the parameters of the f32- and "
            f"int8-moment runs are equal bit for bit (the first update "
            f"reads the unquantized moments)")
        del steps
        free(params)
    pipe.close()


def opt_bytes(opt) -> int:
    return sum(x.numel() * x.element_size()
               for x in prm.flatten((opt.m, opt.v))[0])


LEAF_SAMPLE = 2 ** 20


def leaf_sample(p: torch.Tensor) -> torch.Tensor:
    """A strided copy of up to ``LEAF_SAMPLE`` elements of a leaf, which
    counts as changed when its sample did: a step of AdamW moves nearly
    every element by about lr, and the copies of agent-7b's 11.9 GB of
    weights stay small."""
    flat = p.reshape(-1)
    return flat[::max(1, flat.numel() // LEAF_SAMPLE)].clone()


def model_flops(cfg, b: int, s: int) -> tuple[float, float]:
    """(model FLOPs, executed FLOPs with remat) of one train step: 6 per
    parameter of every matmul per token plus attention's 12 * dh per
    (head, causal query-key pair, layer); remat runs the forward again
    (2 per parameter per token, 4 * dh per pair)."""
    n_mat = models.param_count(cfg) - cfg.vocab * cfg.d_model   # no lookup
    pairs = b * s * (s + 1) / 2
    attn = cfg.n_layers * cfg.n_heads * cfg.d_head * pairs
    model = 6 * n_mat * b * s + 12 * attn
    return model, model + 2 * n_mat * b * s + 4 * attn


def init_train(cfg, dev, phase: str):
    """Seeded random weights for the full-depth train phases: the
    reference's rule (``init_full``), then the attention projections at
    their true fan-in (``attention.rescale_to_true_fan_in``).  With the
    rule alone agent-7b's gradients grow about 6x a layer downwards, to
    4e20 at layer 1, and the global norm (5.6e22) overflows the f32 clip
    of either package (ROADMAP §C, reference fault 5)."""
    params = init_full(cfg, dev, phase)
    attention.rescale_to_true_fan_in(params)
    return params


def kernel_class(key: str) -> str:
    """A profiled kernel's class for the train step's breakdown."""
    if "flash" in key:
        return "flash"
    if any(k in key for k in ("nvjet", "gemm", "cutlass", "xmma")):
        return "matmul"
    if any(k in key for k in ("elementwise", "copy", "Fill", "reduce",
                              "Reduce", "index", "scatter", "gather")):
        return "elementwise, copies, reductions"
    return "other"


def phase_train(dev) -> dict:
    """[train]: agent-7b in full, bf16, remat, int8 moments, B 2 x S 4096
    from the token pipeline, on ``init_train``'s weights: a warm-up step (its first and last layer's
    backward calls recorded and held to the plain backward), 4 timed
    steps with exact launch counts, one profiled step.  Returns the flash
    launches of the warm-up and timed steps."""
    phase = "train"
    cfg = get_config(TRAIN_MODEL).replace(use_pallas=True)
    card_runs = dev.type == "cuda"
    params = init_train(cfg, dev, phase)
    acfg = AdamWConfig(lr=1e-3, warmup_steps=0, int8_moments=True)
    plan = TrainPlan(microbatch=1, int8_moments=True)
    step = make_train_step(cfg, None, plan, acfg, device=dev)
    opt = adamw_init(params, acfg)
    before = [leaf_sample(p) for p in prm.flatten(params)[0]]
    pipe = train_batches(cfg, TRAIN_SEQ, TRAIN_BATCH)
    it = iter(pipe)
    torch.cuda.synchronize()
    if card_runs:
        torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:
        KERNELS[k].launches = 0
    flash_attention_backward.launches = 0
    times, losses, norms = [], [], []
    n_layers = cfg.n_layers
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        batch = next(it)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            with record_flash(False, picks={0, n_layers - 1}) as calls:
                params, opt, m = step(params, opt, batch)
                torch.cuda.synchronize()
        else:
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    used = launch_counts()
    used["flash_attention_backward"] = flash_attention_backward.launches
    peak = torch.cuda.max_memory_allocated() if card_runs else 0
    steps = TRAIN_WARMUP + TRAIN_STEPS
    want = dict.fromkeys(used, 0)
    if card_runs:
        want["flash_attention"] = 2 * n_layers * steps
        want["flash_attention_backward"] = n_layers * steps
        if [c[0] for c in calls] != [0, n_layers - 1]:
            raise AssertionError(f"{phase}: recorded backward calls "
                                 f"{[c[0] for c in calls]}")
    if used != want:
        raise AssertionError(f"{phase}: kernel launches {used}, expected "
                             f"{want} (remat: 2 forwards and 1 backward a "
                             f"layer a step)")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"{phase}: non-finite loss or grad norm: "
                             f"{losses}, {norms}")
    unchanged = [i for i, (a, p) in enumerate(zip(
        before, prm.flatten(params)[0])) if torch.equal(a, leaf_sample(p))]
    del before
    if unchanged:
        raise AssertionError(f"{phase}: parameter leaves {unchanged} did not "
                             f"change")
    gpu = card() if card_runs else "a CPU"
    timed = times[TRAIN_WARMUP:]
    step_s = float(np.mean(timed))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mf, hf = model_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    log(phase, f"{cfg.name}, {models.param_count(cfg) / 1e9:.3f} B params, "
        f"{n_layers} layers, bf16, remat, int8 moments "
        f"({opt_bytes(opt) / 1e9:.2f} GB of moments), B {TRAIN_BATCH} x S "
        f"{TRAIN_SEQ}, {gpu}: steps "
        + ", ".join(f"{1e3 * t:.1f}" for t in times)
        + f" ms (the first a warm-up); mean timed step {1e3 * step_s:.1f} "
        f"ms, {tokens / step_s:.0f} tokens/s; losses "
        + ", ".join(f"{x:.4f}" for x in losses) + "; grad norms "
        + ", ".join(f"{x:.3f}" for x in norms)
        + f"; max_memory_allocated {peak / 1e9:.2f} GB; kernel launches "
        f"{used} (= {2 * n_layers} forwards and {n_layers} backwards a "
        f"step); every one of {len(prm.flatten(params)[0])} parameter "
        f"leaves changed (a strided sample of up to {LEAF_SAMPLE} elements "
        f"of each)")
    log(phase, f"{gpu}: model FLOPs {mf:.3e} a step ({mf / step_s / 1e12:.1f} "
        f"TFLOP/s, {100 * mf / step_s / BF16_OPS_PER_S:.1f}% of the "
        f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s bf16 peak); executed with "
        f"remat {hf:.3e} ({100 * hf / step_s / BF16_OPS_PER_S:.1f}%)")
    hold_flash_calls(phase, [], sorted(calls), torch.bfloat16)
    log(phase, f"the backward calls of layers {n_layers} and 1 (calls 0 and "
        f"{n_layers - 1} of the warm-up step) held to the plain backward on "
        f"their own inputs")
    del calls
    step_pass_check(phase, cfg, plan, peak, {k: v // steps
                                             for k, v in want.items()})

    # one profiled step: device busy against the unprofiled step time
    batch = next(it)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    log_profile(phase, "train step", rows, 1e3 * step_s, 1)
    for us, count, key in sorted(rows, reverse=True)[:8]:
        log("profile", f"  {phase}: {us / 1e3:9.3f} ms/step  {count:6d} "
            f"calls/step  {key[:90]}")
    classes: dict = {}
    for us, count, key in rows:
        c = kernel_class(key)
        ms_, n_ = classes.get(c, (0.0, 0))
        classes[c] = (ms_ + us / 1e3, n_ + count)
    busy = sum(v[0] for v in classes.values())
    log("profile", f"{phase}: device time by class: " + "; ".join(
        f"{c} {ms_:.1f} ms ({100 * ms_ / busy:.1f}%, {n_} calls)"
        for c, (ms_, n_) in sorted(classes.items(),
                                   key=lambda kv: -kv[1][0])))
    fwd = [(us, count) for us, count, key in rows
           if "flash" in key and "flash_bwd" not in key]
    fwd_ms = sum(us for us, _ in fwd) / 1e3
    log("profile", f"{phase}: the flash forward's kernel {fwd_ms:.1f} ms in "
        f"{sum(c for _, c in fwd)} launches, "
        f"{100 * fwd_ms / max(busy, 1e-9):.1f}% of the step's device time")
    bwd = [(us, count) for us, count, key in rows if "flash_bwd" in key]
    bwd_ms = sum(us for us, _ in bwd) / 1e3
    log("profile", f"{phase}: the flash backward's kernels (D pre-pass, "
        f"dK/dV, dQ) {bwd_ms:.1f} ms in {sum(c for _, c in bwd)} launches, "
        f"{100 * bwd_ms / max(busy, 1e-9):.1f}% of the step's device time")
    pipe.close()
    del opt
    free(params)
    return used


# the dry run's step pass must hold the card's peak within this share
STEP_PASS_PEAK_TOL = 0.10


def step_pass_check(phase: str, cfg, plan, peak: int, per_step: dict) -> None:
    """The dry run's step pass (``launch.dryrun.step_pass``, a world of
    one on meta tensors, on the host) of this phase's step: its
    ``MemTracker`` peak within STEP_PASS_PEAK_TOL of the card's
    ``max_memory_allocated`` ``peak``, and its counted kernel calls equal
    to the launches of one step ``per_step`` (on the CPU, where nothing
    launches and no peak is read, the pass runs and is printed)."""
    t0 = time.perf_counter()
    res = dryrun.step_pass(cfg, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH,
                                            "train"), None, plan,
                           costs=False)
    meta = res["memory"]["peak_bytes"]
    calls = {k: v["calls"] for k, v in res["kernels"].items()}
    seconds = time.perf_counter() - t0
    if peak:
        if abs(meta - peak) > STEP_PASS_PEAK_TOL * peak:
            raise AssertionError(f"{phase}: the step pass's peak {meta} B is "
                                 f"not within {STEP_PASS_PEAK_TOL:.0%} of "
                                 f"max_memory_allocated {peak} B")
        want = {k: v for k, v in per_step.items() if v}
        if calls != want:
            raise AssertionError(f"{phase}: the step pass counted kernel "
                                 f"calls {calls}, a step launched {want}")
    log(phase, f"the dry run's step pass of this step (meta tensors, a world "
        f"of one, on the host, counted from shapes): peak "
        f"{meta / 1e9:.2f} GB (arguments "
        f"{res['memory']['argument_bytes'] / 1e9:.2f} GB) against "
        + (f"max_memory_allocated {peak / 1e9:.2f} GB "
           f"({100 * (meta - peak) / peak:+.1f}%, within "
           f"{STEP_PASS_PEAK_TOL:.0%})" if peak else "no card")
        + f"; kernel calls {calls}"
        + (" equal to a step's launches" if peak else "")
        + f"; {seconds:.1f} s")


def phase_train_1b(dev) -> None:
    """[train agent-1b]: full depth, two microbatches of B 1 x S 4096, f32
    moments and f32 accumulators: step ms and peak memory."""
    phase = "train agent-1b"
    cfg = get_config(TRAIN_1B_MODEL).replace(use_pallas=True)
    card_runs = dev.type == "cuda"
    params = init_train(cfg, dev, phase)
    acfg = AdamWConfig(lr=1e-3, warmup_steps=0)
    step = make_train_step(cfg, None, TrainPlan(microbatch=2), acfg,
                           device=dev)
    opt = adamw_init(params, acfg)
    pipe = train_batches(cfg, TRAIN_SEQ, 2, seed=1)
    it = iter(pipe)
    torch.cuda.synchronize()
    if card_runs:
        torch.cuda.reset_peak_memory_stats()
    f0, b0 = flash_attention.launches, flash_attention_backward.launches
    times, losses = [], []
    for _ in range(1 + TRAIN_1B_STEPS):
        batch = next(it)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"].item())
    used = (flash_attention.launches - f0,
            flash_attention_backward.launches - b0)
    n = (1 + TRAIN_1B_STEPS) * card_runs
    if used != (2 * 2 * cfg.n_layers * n, 2 * cfg.n_layers * n):
        raise AssertionError(f"{phase}: flash launches {used}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{phase}: non-finite loss {losses}")
    step_s = float(np.mean(times[1:]))
    log(phase, f"{cfg.name}, {models.param_count(cfg) / 1e9:.3f} B params, "
        f"{cfg.n_layers} layers, bf16, remat, f32 moments and f32 "
        f"accumulators, 2 microbatches of B 1 x S {TRAIN_SEQ}, "
        f"{card() if card_runs else 'a CPU'}: "
        f"steps " + ", ".join(f"{1e3 * t:.1f}" for t in times)
        + f" ms (the first a warm-up), mean {1e3 * step_s:.1f} ms, "
        f"{2 * TRAIN_SEQ / step_s:.0f} tokens/s; losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f"; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9 if card_runs else 0:.2f} "
        f"GB; flash launches "
        f"{used} (2 microbatches x {cfg.n_layers} layers x (2, 1) a step)")
    pipe.close()
    del opt
    free(params)


def phase_train_lm(dev) -> None:
    """[train_lm]: the train_lm twin at lm-100m, 75 steps with --chaos
    (one failure at step 50, resumed from the step-50 checkpoint) and
    once uninterrupted, both under torch.use_deterministic_algorithms
    (the embedding's backward otherwise adds with atomics): the resumed
    run's losses equal the uninterrupted run's bit for bit, and the loss
    improves (by 0.04 nats at least under 150 steps, 0.2 from 150: the
    twin asserts it)."""
    phase = "train_lm"
    runs = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for chaos in (True, False):
            ckpt = ROOT / "build" / f"train_lm_{'chaos' if chaos else 'plain'}"
            shutil.rmtree(ckpt, ignore_errors=True)
            t0 = time.perf_counter()
            res = train_lm.main(
                ["--model", TRAIN_LM_MODEL, "--steps", str(TRAIN_LM_STEPS),
                 "--batch", str(TRAIN_LM_BATCH), "--seq", str(TRAIN_LM_SEQ),
                 "--ckpt-dir", str(ckpt), "--device", str(dev)]
                + (["--chaos"] if chaos else []))
            res["wall"] = time.perf_counter() - t0
            runs[chaos] = res
            shutil.rmtree(ckpt, ignore_errors=True)
    finally:
        torch.use_deterministic_algorithms(False)
    got, want = runs[True], runs[False]
    if got["restarts"] != 1 or want["restarts"] != 0:
        raise AssertionError(f"{phase}: restarts {got['restarts']}, "
                             f"{want['restarts']}")
    if got["losses"] != want["losses"]:
        first = next(i for i, (a, b) in enumerate(zip(
            got["losses"], want["losses"])) if a != b)
        raise AssertionError(f"{phase}: the resumed run's loss differs from "
                             f"the uninterrupted run's at step {first}")
    gpu = card() if dev.type == "cuda" else "a CPU"
    log(phase, f"{TRAIN_LM_MODEL}, {gpu}: {TRAIN_LM_STEPS} steps of B "
        f"{TRAIN_LM_BATCH} x S {TRAIN_LM_SEQ}, "
        f"loss {got['first']:.3f} -> {got['last']:.3f} (improved "
        f"{got['first'] - got['last']:.3f} nats); chaos run survived "
        f"{got['restarts']} failure ({got['log']}) in {got['wall']:.1f} s, "
        f"its {len(got['losses'])} losses equal the uninterrupted run's "
        f"({want['wall']:.1f} s) bit for bit (deterministic algorithms)")


# ---------------------------------------------------------------------------
# Training of every other family: the backward kernels of grouped_matmul
# and ssm_scan, each family's parity at its width, and each family
# trained at full width on one card
# ---------------------------------------------------------------------------

BACKWARDS = {"flash_attention_backward": flash_attention_backward,
             "grouped_matmul_backward": grouped_matmul_backward,
             "ssm_scan_backward": ssm_scan_backward}


def all_counts() -> dict:
    """Launch counts of every kernel, forward and backward."""
    return {name: fn.launches for name, fn in {**KERNELS,
                                               **BACKWARDS}.items()}


# the grouped_matmul backward: arctic-480b's w_in at a decode step (C 8)
# and at the training step of B 1 x S 4096 (capacity 88), kimi-k2's at
# the same two, counts from a top-k routing with experts 0, 1 and 2 set
# to no row, all C rows and C / 3 rows; f32 with 16 experts.  The plain
# backward's f32 copies of every expert would not fit beside the kernel's
# outputs, so the outputs are held on the first GM_BWD_HELD experts.
GM_BWD_HELD = 8


def gm_bwd_inputs(dtype, e: int, d: int, f: int, tokens: int, top_k: int,
                  cfg_c, gen: torch.Generator, dev, w=None):
    """(x, w, counts, dout): dispatch buffer and output gradient zero past
    each count (what the routing's gather leaves), counts of 0, C and C /
    3 on experts 0-2."""
    c = capacity(tokens, cfg_c)
    counts = routed_counts(tokens, e, c, gen, dev, top_k)
    counts[0], counts[1], counts[2] = 0, c, c // 3
    x = gm_buffer(dtype, counts, c, d, gen, dev)
    dout = gm_buffer(dtype, counts, c, f, gen, dev)
    if w is None:
        w = gm_weights(dtype, e, d, f, gen, dev)
    return x, w, counts, dout


def check_gm_backward(x, w, counts, dout, what: str,
                      held: int | None = None) -> float:
    """dx and dw of the backward kernels against the plain backward on the
    first ``held`` experts (all when None), each relative to its largest
    magnitude; dx past each count and the dw of an expert no token chose
    exactly zero; two runs equal bit for bit.  Returns the worst error."""
    dx, dw = grouped_matmul_backward(x, w, counts, dout)
    again = grouped_matmul_backward(x, w, counts, dout)
    torch.cuda.synchronize()
    if not (torch.equal(dx, again[0]) and torch.equal(dw, again[1])):
        raise AssertionError(f"grouped_matmul_backward ({what}): two runs "
                             f"differ")
    del again
    c = x.shape[1]
    dead = torch.arange(c, device=x.device)[None, :] >= counts[:, None]
    if dx[dead].any() or dw[counts == 0].any():
        raise AssertionError(f"grouped_matmul_backward ({what}): a dead row "
                             f"or an empty expert has a gradient")
    if not (torch.isfinite(dx).all() and torch.isfinite(dw).all()):
        raise AssertionError("non-finite backward output")
    sl = slice(0, held)
    want = grouped_matmul_backward_plain(x[sl], w[sl], counts[sl], dout[sl])
    errs = [rel_err(dx[sl], want[0]), rel_err(dw[sl], want[1])]
    check("grouped_matmul_backward", max(errs), x.dtype,
          f"{x.dtype} E={x.shape[0]} C={c} d={x.shape[2]} f={w.shape[2]} "
          f"{what}, counts {sorted(set(counts.tolist()))[:6]}..., dx/dw "
          f"{errs[0]:.2e}/{errs[1]:.2e} of the largest magnitude"
          + (f" (experts 0-{held - 1})" if held else "")
          + "; two runs equal bit for bit")
    return max(errs)


def gm_bwd_bound(x, w, counts, part: str = "both") -> tuple[float, str]:
    """The bound of dX and dW together (``part`` "both"), of dX alone
    ("dx") or of dW alone ("dw") (``work.grouped_matmul_backward``)."""
    return bound_of(*work.grouped_matmul_backward(
        x, w, counts, *work.live_rows(counts, x.shape[1]), part))


def gm_backward_part(x, w, counts, dout, part: str):
    """One of the backward's two kernels alone ("dx" or "dw"): the C entry
    point takes a null pointer for the output it does not compute."""
    return gm_launch_backward(x, w, counts, dout, part == "dx",
                              part == "dw")


def time_gm_backward(x, w, counts, dout, label: str, plain: bool = True):
    """Kernel (dX and dW together, and each alone), plain (when ``plain``)
    and the two bmm calls' times (together and each alone), and the
    bounds; the bmm pair is held to the kernel's function (dout and x are
    zero past each count, so it computes the same dx and dw): all of dx,
    dw on the first GM_BWD_HELD experts.  Kernel and bmm times: the
    median of three readings, with their spread.  Returns the together
    row."""
    ms, spread = cuda_ms3(lambda: grouped_matmul_backward(x, w, counts,
                                                          dout), 5)
    part_ms = {p: cuda_ms3(lambda p=p: gm_backward_part(x, w, counts, dout,
                                                        p), 5)[0]
               for p in ("dx", "dw")}
    plain_ms = cuda_ms(lambda: grouped_matmul_backward_plain(
        x, w, counts, dout), 1, warmup=1) if plain else None
    torch.cuda.empty_cache()

    def lib_dx():
        return torch.bmm(dout, w.transpose(1, 2))

    def lib_dw():
        return torch.bmm(x.transpose(1, 2), dout)

    def library():
        return lib_dx(), lib_dw()
    got = grouped_matmul_backward(x, w, counts, dout)
    lib = library()
    held = slice(0, GM_BWD_HELD)      # dW's f32 difference: a slice
    lib_err = max(gm_errors(lib[0], got[0])[1],
                  gm_errors(lib[1][held], got[1][held])[1])
    del got, lib
    if lib_err > TOL[x.dtype]:
        raise AssertionError(f"library yardstick computes another "
                             f"function: {lib_err}")
    library_ms, lib_spread = cuda_ms3(library, 5)
    lib_part = {"dx": cuda_ms3(lib_dx, 5)[0], "dw": cuda_ms3(lib_dw, 5)[0]}
    bound_ms, bound_by = gm_bwd_bound(x, w, counts)
    bounds = {p: gm_bwd_bound(x, w, counts, p) for p in ("dx", "dw")}
    e, c, d = x.shape
    log("kernels", f"grouped_matmul_backward {x.dtype} {label} E={e} C={c} "
        f"d={d} f={w.shape[2]}, {int((counts > 0).sum())} experts live, "
        f"{int(counts.sum())} rows: kernel {ms:.4f} ms (dX and dW; median "
        f"of 3, spread {spread:.4f}), plain "
        + (f"{plain_ms:.4f} ms" if plain else "not timed (its f32 copies "
           "would not fit)")
        + f", two bmm over every expert {library_ms:.4f} ms (spread "
        f"{lib_spread:.4f}), bound {bound_ms:.4f} ms ({bound_by}); kernel "
        f"at {100 * bound_ms / ms:.1f}% of bound, "
        f"{ms / library_ms:.2f}x the bmm pair")
    for p, name in (("dx", "dX"), ("dw", "dW")):
        log("kernels", f"grouped_matmul_backward {label} {name} alone: "
            f"kernel {part_ms[p]:.4f} ms, bmm {lib_part[p]:.4f} ms, bound "
            f"{bounds[p][0]:.4f} ms ({bounds[p][1]}); kernel at "
            f"{100 * bounds[p][0] / part_ms[p]:.1f}% of bound")
    return ms, plain_ms, library_ms, bound_ms, bound_by


# the ssm_scan backward: hymba-1.5b's training scan (B 2, T 4096, 50
# heads, dk 16, dv 64, q/k shared over the heads) and mLSTM's (xlstm-350m:
# B 4, T 1024, 4 heads, dk 512, dv 513), each also with a ragged T, a
# non-zero h0 and a gradient of h_T; b, t, h, dk, dv, chunk, shared,
# decay, h0 scale, dH_T
SCAN_BWD_CASES = [(2, 4096, 50, 16, 64, 128, True, None, 0.0, False),
                  (1, 1000, 50, 16, 64, 128, True, None, 0.5, True),
                  (4, 1024, 4, 512, 513, 128, False, 0.1, 0.0, False),
                  (1, 300, 2, 512, 513, 128, False, 0.1, 0.3, True),
                  # the mLSTM at xLSTM's 1.3B and 2.7B widths
                  (1, 300, 2, 1024, 1025, 128, False, 0.1, 0.3, True),
                  (1, 200, 2, 1280, 1281, 64, False, 0.1, 0.3, True)]
# timed: the mLSTM's train shape at xLSTM's 1.3B width (phase 39's step)
MLSTM_13B_BWD = (2, 1024, 4, 1024, 1025, 128, False, 0.1, 0.0, False)


def scan_bwd_args(dtype, case, gen: torch.Generator, dev):
    """(q, k, v, log_a, h0, dy, dh_T or None) of a case."""
    b, t, h, dk, dv, chunk, shared, decay, h0s, dht = case
    args = scan_case(dtype, b, t, h, dk, dv, shared, decay, h0s, gen, dev)
    dy = torch.randn((b, t, h, dv), generator=gen, device=dev).to(dtype)
    dh_t = (torch.randn((b, h, dk, dv), generator=gen, device=dev)
            if dht else None)
    return (*args, dy, dh_t)


def check_scan_backward(dtype, case, gen, dev) -> float:
    """dq, dk, dv, dlog_a and dh0 of the backward kernels against the
    plain backward, each within SCAN_TOL of its largest magnitude; two
    runs equal bit for bit.  Returns the worst error."""
    chunk = case[5]
    q, k, v, la, h0, dy, dh_t = scan_bwd_args(dtype, case, gen, dev)
    got = ssm_scan_backward(q, k, v, la, h0, dy, dh_t, chunk=chunk)
    again = ssm_scan_backward(q, k, v, la, h0, dy, dh_t, chunk=chunk)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("ssm_scan_backward: two runs differ")
    if not all(torch.isfinite(x).all() for x in got):
        raise AssertionError("non-finite backward output")
    want = ssm_scan_backward_plain(q, k, v, la, h0, dy, dh_t, chunk=chunk)
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    b, t, h, dk, dv, _, shared, _, h0s, dht = case
    check("ssm_scan_backward", max(errs), dtype,
          f"{dtype} B={b} T={t} H={h} dk={dk} dv={dv} chunk={chunk} shared "
          f"q/k={shared} h0={h0s} dH_T={dht}: dq/dk/dv/dlog_a/dh0 "
          + "/".join(f"{e:.2e}" for e in errs)
          + " of the largest magnitude; two runs equal bit for bit",
          tol=SCAN_TOL[dtype])
    return max(errs)


def scan_bwd_bound(q, k, v, states) -> tuple[float, str]:
    """q, k (once per broadcast row), v, dy, log_a and the forward's chunk
    states read; dq, dk (full shape), dv and dlog_a written; against the
    chunked form's operations (``work.scan_backward``)."""
    return bound_of(*work.scan_backward(q, k, v, states))


def time_scan_backward(dtype, case, gen, dev, label: str):
    """The backward kernels' time alone (the forward's states made once
    before), the plain backward's (autograd through the plain scan, its
    forward included: the plain version has no other way), the bound;
    no PyTorch call computes it."""
    chunk = case[5]
    q, k, v, la, h0, dy, dh_t = scan_bwd_args(dtype, case, gen, dev)
    _, h_t, states = scan_mod._launch(q, k, v, la, h0, chunk,
                                      keep_states=True)
    la32 = la.float().contiguous()
    ms = cuda_ms(lambda: scan_mod._launch_backward(
        q, k, v, la32, states, h_t, dy, dh_t, chunk), 5)
    plain_ms = cuda_ms(lambda: ssm_scan_backward_plain(
        q, k, v, la, h0, dy, dh_t, chunk=chunk), 2, warmup=1)
    bound_ms, bound_by = scan_bwd_bound(q, k, v, states)
    log("kernels", f"ssm_scan_backward {dtype} {label}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, no library call computes it, bound "
        f"{bound_ms:.4f} ms ({bound_by}); kernel at "
        f"{100 * bound_ms / ms:.1f}% of bound")
    return ms, plain_ms, None, bound_ms, bound_by


def phase_backward_kernels(dev) -> list:
    """[kernels] backward: the grouped_matmul and ssm_scan backward kernels
    against the plain backward, deterministic, timed; returns their two
    JSON rows."""
    gen = torch.Generator(device=dev).manual_seed(13)
    arctic, kimi = get_config("arctic-480b"), get_config("kimi-k2-1t-a32b")
    e, d, f = ARCTIC_EXPERTS
    x, w, counts, dout = gm_bwd_inputs(torch.float32, 16, d, f, TRAIN_SEQ,
                                       2, arctic, gen, dev)
    check_gm_backward(x, w, counts, dout, "arctic width, 16 experts, train C")
    del x, w, counts, dout
    worst, row = 0.0, None
    for name, (e, d, f), top_k, cfg_c in (("arctic", ARCTIC_EXPERTS, 2,
                                           arctic),
                                          ("kimi", KIMI_EXPERTS, 8, kimi)):
        w = gm_weights(torch.bfloat16, e, d, f, gen, dev)
        for step, tokens in (("decode", 8), ("train", TRAIN_SEQ)):
            x, _, counts, dout = gm_bwd_inputs(torch.bfloat16, e, d, f,
                                               tokens, top_k, cfg_c, gen, dev,
                                               w=w)
            what = f"{name} w_in {step}"
            worst = max(worst, check_gm_backward(x, w, counts, dout, what,
                                                 GM_BWD_HELD))
            torch.cuda.empty_cache()
            times = time_gm_backward(x, w, counts, dout, what,
                                     plain=name == "arctic")
            if (name, step) == ("arctic", "train"):
                row = times
            del x, counts, dout
            torch.cuda.empty_cache()
        del w
        torch.cuda.empty_cache()
    ms, plain_ms, library_ms, bound_ms, bound_by = row
    gm_row = {"name": "grouped_matmul_backward", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/grouped_matmul_bwd.cu",
              "replaces": "src/repro/kernels/grouped_matmul.py:59",
              "launches": None, "max_abs_err": worst, "ms": ms,
              "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "library_ms": library_ms}

    worst = worst_past = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for case in SCAN_BWD_CASES:
            err = check_scan_backward(dtype, case, gen, dev)
            if dtype == torch.bfloat16 and (case[3] > 512 or case[4] > 1024):
                worst_past = max(worst_past, err)
            elif dtype == torch.bfloat16:
                worst = max(worst, err)
            torch.cuda.empty_cache()
    ms, plain_ms, library_ms, bound_ms, bound_by = time_scan_backward(
        torch.bfloat16, SCAN_BWD_CASES[0], gen, dev,
        "B=2 T=4096 H=50 dk=16 dv=64 chunk=128, q/k shared (hymba train)")
    time_scan_backward(torch.bfloat16, SCAN_BWD_CASES[2], gen, dev,
                       "B=4 T=1024 H=4 dk=512 dv=513 chunk=128 (mLSTM train)")
    past = time_scan_backward(torch.bfloat16, MLSTM_13B_BWD, gen, dev,
                              "B=2 T=1024 H=4 dk=1024 dv=1025 chunk=128 "
                              "(the mLSTM's train at xLSTM's 1.3B width)")
    scan_row = {"name": "ssm_scan_backward", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
                "replaces": "src/repro/kernels/ssm_scan.py:69",
                "launches": None, "max_abs_err": worst, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms}
    return [gm_row, scan_row,
            past_row(scan_row, "ssm_scan_backward at xLSTM's 1.3B width",
                     worst_past, past, ["dk=1024 dv=1025",
                                        "dk=1280 dv=1281"])]


GM_MOD = "repro_torch.kernels.grouped_matmul"
SCAN_MOD = "repro_torch.kernels.ssm_scan"


@contextlib.contextmanager
def record_training_kernels():
    """The grouped_matmul and ssm_scan launches, forward and backward,
    made inside the block: {"gm_fwd", "gm_bwd", "scan_fwd", "scan_bwd"}."""
    with record_calls(GM_MOD, "_launch") as gf, \
            record_calls(GM_MOD, "_launch_backward") as gb, \
            record_calls(SCAN_MOD, "_launch") as sf, \
            record_calls(SCAN_MOD, "_launch_backward") as sb:
        yield {"gm_fwd": gf, "gm_bwd": gb, "scan_fwd": sf, "scan_bwd": sb}


def hold_training_calls(phase: str, calls: dict, dtype,
                        held: int | None = None, first: int = 0) -> float:
    """Each recorded grouped_matmul and ssm_scan call, forward and
    backward, against its plain version on that call's own inputs,
    relative to each output's largest magnitude (grouped_matmul on its
    first ``held`` experts when given); the calls are numbered from
    ``first`` in the log.  Returns the worst error."""
    worst = 0.0
    sl = slice(0, held)
    for i, ((x, w, counts), out) in enumerate(calls["gm_fwd"], first):
        err = rel_err(out[sl], grouped_matmul_plain(x[sl], w[sl],
                                                    counts[sl]))
        check("grouped_matmul", err, dtype, f"{phase} forward call {i}, "
              f"relative")
        worst = max(worst, err)
    for i, ((x, w, counts, dout, need_dx, need_dw), got) in enumerate(
            calls["gm_bwd"], first):
        want = grouped_matmul_backward_plain(x[sl], w[sl], counts[sl],
                                             dout[sl])
        errs = [rel_err(g[sl], wv) for g, wv, need in zip(
            got, want, (need_dx, need_dw)) if need]
        check("grouped_matmul_backward", max(errs), dtype,
              f"{phase} backward call {i}, dx/dw "
              + "/".join(f"{e:.2e}" for e in errs) + ", relative")
        worst = max(worst, *errs)
        del want
    for i, (args, res) in enumerate(calls["scan_fwd"], first):
        q, k, v, log_a, h0, chunk = args[:6]
        want = ssm_scan_plain(q, k, v, log_a, h0, chunk=chunk)
        errs = [rel_err(res[0], want[0]), rel_err(res[1], want[1])]
        check("ssm_scan", max(errs), dtype, f"{phase} forward call {i}, y/h_T "
              + "/".join(f"{e:.2e}" for e in errs) + ", relative",
              tol=SCAN_TOL[dtype])
        worst = max(worst, *errs)
    for i, (args, got) in enumerate(calls["scan_bwd"], first):
        q, k, v, la, states, h_t, dy, dh_t, chunk = args
        want = ssm_scan_backward_plain(q, k, v, la, states[:, :, 0], dy,
                                       dh_t, chunk=chunk)
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        check("ssm_scan_backward", max(errs), dtype,
              f"{phase} backward call {i}, dq/dk/dv/dlog_a/dh0 "
              + "/".join(f"{e:.2e}" for e in errs) + ", relative",
              tol=SCAN_TOL[dtype])
        worst = max(worst, *errs)
    return worst


def train_launches(cfg, steps: int = 1) -> dict:
    """Each kernel's launches in ``steps`` forward-and-backward passes of
    ``loss_fn`` on the card with the kernels on: per layer, one flash
    call per attention (self attention of every attention kind, the
    decoder's cross attention, the encoder's), one scan per matrix-memory
    layer (hymba's mamba branch, mLSTM) and three grouped_matmul per MoE
    layer, each with one backward, and a second forward under remat."""
    fwd = 2 if cfg.remat else 1
    attn = kind_layers(cfg, ("attn", "dec", "hymba"))
    cross = sum(seg.repeat * n for seg in cfg.plan()
                for spec, n in seg.pattern if spec.cross_attention)
    enc = sum(seg.repeat * n for seg in cfg.enc_plan()
              for _, n in seg.pattern) if cfg.is_encdec else 0
    flash = attn + cross + enc
    scan = kind_layers(cfg, ("hymba", "mlstm"))
    gm = 3 * moe_layers(cfg)
    want = dict.fromkeys(all_counts(), 0)
    want.update(flash_attention=fwd * flash * steps,
                flash_attention_backward=flash * steps,
                ssm_scan=fwd * scan * steps, ssm_scan_backward=scan * steps,
                grouped_matmul=fwd * gm * steps,
                grouped_matmul_backward=gm * steps)
    return want


def family_batch(cfg, b: int, s: int, gen: torch.Generator, dev,
                 frames: int = 0, grid: tuple | None = None) -> dict:
    """Tokens and next-token labels (the last -1) of B x S, plus a VLM's
    ``grid`` (VISION_GRID by default) of patch embeddings over the first
    slots at (t, h, w) positions and an encoder-decoder's ``frames``
    frame embeddings."""
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev,
                           dtype=torch.int32)
    labels = torch.roll(tokens, -1, 1)
    labels[:, -1] = -1
    batch = {"tokens": tokens, "labels": labels}
    if cfg.frontend == "patch":
        gh, gw = grid or VISION_GRID
        batch["vision_embeds"] = torch.randn(
            (b, gh * gw, cfg.d_model), generator=gen, device=dev).to(
                prm.torch_dtype(cfg.dtype))
        batch["positions"] = vision_positions(b, s - gh * gw, dev, grid)
    if cfg.is_encdec:
        batch["frames"] = torch.randn(
            (b, frames, cfg.d_model), generator=gen, device=dev).to(
                prm.torch_dtype(cfg.dtype))
    return batch


# train parity of the families, f32, B 1 x S 512 (seamless: 512 frames):
# (config, cut)
TRAIN_FAMILIES = [
    ("arctic-480b", dict(n_layers=1, n_experts=16)),
    ("kimi-k2-1t-a32b", dict(n_layers=2, n_experts=16)),
    ("hymba-1.5b", dict(n_layers=3, global_layers=(0, 2))),
    ("xlstm-350m", dict(n_layers=2, mlstm_ratio=1)),
    ("qwen2-vl-2b", dict(n_layers=2)),
    ("seamless-m4t-large-v2", dict(n_layers=1, enc_layers=1)),
]
FAMILY_SEQ = 512


def phase_train_families(dev) -> None:
    """[train parity families]: each family at its width and a cut depth,
    f32, on ``init_train``'s weights (at the true fan-in the scores stay
    moderate, so f32 flash calls hold the 2e-5 band here, unlike phase
    29's): loss and every gradient leaf with the kernels on against off,
    exact launches, every grouped_matmul, ssm_scan and flash call
    (forward and backward) held to its plain version; then one
    make_train_step (f32 moments) with every leaf moved."""
    phase = "train parity families"
    card_runs = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(14)
    for name, cut in TRAIN_FAMILIES:
        cfg = get_config(name).replace(dtype="float32", **cut)
        params = init_train(cfg, dev, phase)
        batch = family_batch(cfg, 1, FAMILY_SEQ, gen, dev,
                             frames=FAMILY_SEQ)
        out = {}
        for kernels in (True, False):
            c = cfg.replace(use_pallas=kernels)
            before = all_counts()
            with record_training_kernels() as calls, \
                    record_flash(True) as fw, record_flash(False) as bw:
                out[kernels] = grads_and_loss(c, params, batch)
                torch.cuda.synchronize()
            used = {k: v - before[k] for k, v in all_counts().items()}
            want = train_launches(cfg) if kernels and card_runs \
                else dict.fromkeys(used, 0)
            if used != want:
                raise AssertionError(f"{phase} {name}: launches {used}, "
                                     f"expected {want}")
            if kernels:
                worst = hold_training_calls(f"{phase} {name}", calls,
                                            torch.float32)
                flash_err = hold_flash_calls(f"{phase} {name}", fw, bw,
                                             torch.float32)
            del calls, fw, bw
        (l_on, g_on), (l_off, g_off) = out[True], out[False]
        errs = [rel_err(a, b) for a, b in zip(g_on, g_off)]
        finite = all(torch.isfinite(g).all() for g in g_on + g_off)
        log(phase, f"{name} width, {cut}, f32, B 1 x S {FAMILY_SEQ}: loss "
            f"kernels on {l_on.item():.6f}, off {l_off.item():.6f}; gradient "
            f"leaves, |on - off| over the leaf's largest: max "
            f"{max(errs):.3e}, median {float(np.median(errs)):.3e} "
            f"({len(errs)} leaves); launches "
            f"{ {k: v for k, v in want.items() if v} }; grouped_matmul and "
            f"ssm_scan calls within {worst:.3e} of their plain versions, "
            f"flash calls {flash_err:.3e}")
        if not finite or not torch.isfinite(l_on):
            raise AssertionError(f"{phase} {name}: non-finite loss or "
                                 f"gradient")
        if abs(l_on.item() - l_off.item()) > 1e-4 \
                or max(errs) > TRAIN_F32_GRAD_TOL:
            raise AssertionError(f"{phase} {name}: kernels on and off "
                                 f"disagree: {max(errs)}")
        del out, g_on, g_off
        acfg = AdamWConfig(lr=1e-3, warmup_steps=0)
        c = cfg.replace(use_pallas=True)
        before = [leaf_sample(p) for p in prm.flatten(params)[0]]
        step = make_train_step(c, None, TrainPlan(), acfg, device=dev)
        params, opt, m = step(params, adamw_init(params, acfg), batch)
        torch.cuda.synchronize()
        moved = sum(not torch.equal(a, leaf_sample(p)) for a, p in zip(
            before, prm.flatten(params)[0]))
        if moved != len(before) or not math.isfinite(m["loss"].item()):
            raise AssertionError(f"{phase} {name}: {moved} of {len(before)} "
                                 f"leaves moved, loss {m['loss'].item()}")
        log(phase, f"{name}: make_train_step, f32 moments: loss "
            f"{m['loss'].item():.6f}, aux {m['aux'].item():.6f}, grad_norm "
            f"{m['grad_norm'].item():.4f}; every one of {moved} leaves "
            f"moved")
        del opt, before
        free(params)


def all_finite(x: torch.Tensor) -> bool:
    """Every element finite, checked 2^26 at a time (a full-size bool
    temporary of an expert gradient would be 4.5 GB)."""
    return all(bool(torch.isfinite(part).all())
               for part in x.reshape(-1).split(1 << 26))


def hold_live_experts(phase: str, grads, cfg, counts) -> None:
    """The MoE layer's expert-weight gradients: finite, non-zero for each
    expert a token chose (its count), zero for the others."""
    leaves = prm.flatten(grads)[0]
    e = cfg.n_experts
    experts = [g for g in leaves if g.ndim == 4 and g.shape[1] == e]
    if len(experts) != 3:
        raise AssertionError(f"{phase}: {len(experts)} expert leaves")
    live = counts > 0
    for g in experts:
        flat = g.reshape(e, -1)          # no full-size temporaries
        nz = (flat.amax(1) != 0) | (flat.amin(1) != 0)
        if not torch.equal(nz, live):
            raise AssertionError(f"{phase}: expert gradients non-zero at "
                                 f"{nz.sum().item()} experts, "
                                 f"{live.sum().item()} live")


# train moe: arctic-480b at full width, 1 of 35 layers, bf16, remat, B 1 x
# S 4096: the gradient at all 128 experts (no optimizer state: weights
# and gradients are 56.3 GB), then the whole step with int8 moments at 64
MOE_TRAIN_MODEL, MOE_TRAIN_EXPERTS = "arctic-480b", 64
TRAIN_FULL_STEPS = 2


def peak_gb(card_runs: bool) -> float:
    return torch.cuda.max_memory_allocated() / 1e9 if card_runs else 0.0


def phase_train_moe(dev) -> dict:
    """[train moe]: (a) arctic-480b's gradient at full width, 1 layer, all
    128 experts, bf16, remat, B 1 x S 4096: exact launches, every
    gradient finite, the experts a token chose with non-zero gradients
    and the others zero, each backward call held to the plain backward on
    its first GM_BWD_HELD experts; time and peak memory.  (b) the whole
    make_train_step with int8 moments at 64 experts: a warm-up and
    TRAIN_FULL_STEPS timed steps (``train_full``).  Returns (b)'s
    launches."""
    phase = "train moe"
    card_runs = dev.type == "cuda"
    gpu = card() if card_runs else "a CPU"
    gen = torch.Generator(device=dev).manual_seed(15)
    cfg = get_config(MOE_TRAIN_MODEL).replace(n_layers=1, use_pallas=True)
    params = init_train(cfg, dev, phase)
    batch = family_batch(cfg, 1, TRAIN_SEQ, gen, dev)
    torch.cuda.synchronize()
    if card_runs:
        torch.cuda.reset_peak_memory_stats()
    before = all_counts()
    t0 = time.perf_counter()
    def first_experts(args, res):
        # each call's dW is 8.9 GB: only the held experts' are kept
        return args, tuple(None if r is None else r[:GM_BWD_HELD].clone()
                           for r in res)
    with record_calls(GM_MOD, "_launch_backward", first_experts) as gb:
        loss, grads = grads_and_loss(cfg, params, batch)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = peak_gb(card_runs)
    used = {k: v - before[k] for k, v in all_counts().items()}
    want = train_launches(cfg) if card_runs else dict.fromkeys(used, 0)
    if used != want:
        raise AssertionError(f"{phase}: launches {used}, expected {want}")
    if not torch.isfinite(loss) or not all(all_finite(g) for g in grads):
        raise AssertionError(f"{phase}: non-finite loss or gradient")
    param_gb = sum(p.numel() * p.element_size()
                   for p in prm.flatten(params)[0]) / 1e9
    grad_gb = sum(g.numel() * g.element_size() for g in grads) / 1e9
    log(phase, f"after the backward: memory_allocated "
        f"{torch.cuda.memory_allocated() / 1e9 if card_runs else 0:.2f} "
        f"GB, of which parameters {param_gb:.2f} GB and gradients "
        f"{grad_gb:.2f} GB")
    treedef = prm.flatten(params)[1]
    if card_runs:
        hold_live_experts(phase, prm.unflatten(treedef, list(grads)), cfg,
                          gb[0][0][2])
        worst = hold_training_calls(phase, {"gm_fwd": [], "gm_bwd": gb,
                                            "scan_fwd": [], "scan_bwd": []},
                                    torch.bfloat16, held=GM_BWD_HELD)
        live = int((gb[0][0][2] > 0).sum())
    else:
        worst, live = 0.0, 0
    log(phase, f"{cfg.name} at full width, 1 of 35 layers, "
        f"{models.param_count(cfg) / 1e9:.3f} B params, all "
        f"{cfg.n_experts} experts, bf16, remat, B 1 x S {TRAIN_SEQ}, {gpu}: "
        f"loss and backward {1e3 * wall:.1f} ms (the first pass: no "
        f"warm-up), loss {loss.item():.4f}; every gradient finite; "
        f"{live} experts chosen, each with non-zero expert gradients and "
        f"the others zero; launches {used} (exact); the backward calls "
        f"held on experts 0-{GM_BWD_HELD - 1} within {worst:.3e}; "
        f"max_memory_allocated {peak:.2f} GB")
    del grads
    if card_runs:
        # the backward calls again on their own inputs, each timed alone
        # (one warm-up call): their share of the loss and backward
        bwd_ms = [cuda_ms(lambda a=args: gm_launch_backward(*a), 1,
                          warmup=1) for args, _ in gb]
        log(phase, f"the {len(gb)} grouped_matmul backward calls, replayed "
            f"on their own inputs: " + ", ".join(f"{t:.3f}" for t in bwd_ms)
            + f" ms, {sum(bwd_ms):.3f} ms together, "
            f"{100 * sum(bwd_ms) / (1e3 * wall):.1f}% of the loss and "
            f"backward's {1e3 * wall:.1f} ms")
    del gb, loss
    free(params)
    cfg = cfg.replace(n_experts=MOE_TRAIN_EXPERTS)
    return train_full(dev, phase, cfg, 1, TRAIN_SEQ, int8=True)


def train_full(dev, phase: str, cfg, b: int, s: int, int8: bool = False,
               frames: int = 0, profile: str = "") -> dict:
    """``cfg`` (use_pallas) trained on ``init_train``'s weights, bf16,
    remat, B x S from the seeded generator: a warm-up and
    TRAIN_FULL_STEPS timed steps of make_train_step (f32 or int8
    moments), exact launches, finite losses, every leaf moved; tokens/s
    and peak memory.  With ``profile`` (a kernel name prefix), one more
    step under the profiler prints the device time of the kernels so
    named against the step's.  Returns the run's launches (the profiled
    step's not among them)."""
    card_runs = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(16)
    cfg = cfg.replace(use_pallas=True)
    params = init_train(cfg, dev, phase)
    acfg = AdamWConfig(lr=1e-3, warmup_steps=0, int8_moments=int8)
    step = make_train_step(cfg, None, TrainPlan(int8_moments=int8), acfg,
                           device=dev)
    opt = adamw_init(params, acfg)
    before = [leaf_sample(p) for p in prm.flatten(params)[0]]
    batches = [family_batch(cfg, b, s, gen, dev, frames=frames)
               for _ in range(1 + TRAIN_FULL_STEPS)]
    torch.cuda.synchronize()
    if card_runs:
        torch.cuda.reset_peak_memory_stats()
    start = all_counts()
    times, losses, norms = [], [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    used = {k: v - start[k] for k, v in all_counts().items()}
    want = train_launches(cfg, len(batches)) if card_runs \
        else dict.fromkeys(used, 0)
    if used != want:
        raise AssertionError(f"{phase} {cfg.name}: launches {used}, "
                             f"expected {want}")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"{phase} {cfg.name}: non-finite loss or norm: "
                             f"{losses}, {norms}")
    moved = sum(not torch.equal(a, leaf_sample(p)) for a, p in zip(
        before, prm.flatten(params)[0]))
    if moved != len(before):
        raise AssertionError(f"{phase} {cfg.name}: {moved} of {len(before)} "
                             f"leaves moved")
    step_s = float(np.mean(times[1:]))
    extra = f" (and {frames} frames a row)" if frames else ""
    log(phase, f"{cfg.name}, {models.param_count(cfg) / 1e9:.3f} B params, "
        f"{cfg.n_layers} layers"
        + (f" + {cfg.enc_layers} encoder layers" if cfg.is_encdec else "")
        + (f", {cfg.n_experts} experts" if cfg.n_experts else "")
        + f", bf16, remat, {'int8' if int8 else 'f32'} moments "
        f"({opt_bytes(opt) / 1e9:.2f} GB), B {b} x S {s}{extra}, "
        f"{card() if card_runs else 'a CPU'}: steps "
        + ", ".join(f"{1e3 * t:.1f}" for t in times)
        + f" ms (the first a warm-up); mean timed step {1e3 * step_s:.1f} "
        f"ms, {b * s / step_s:.0f} tokens/s; losses "
        + ", ".join(f"{x:.4f}" for x in losses) + "; grad norms "
        + ", ".join(f"{x:.3f}" for x in norms)
        + f"; max_memory_allocated {peak_gb(card_runs):.2f} GB; launches "
        f"{ {k: v for k, v in used.items() if v} } (exact); every one of "
        f"{moved} leaves moved")
    if profile and card_runs:
        profile_train_step(phase, cfg, step, params, opt,
                           family_batch(cfg, b, s, gen, dev, frames=frames),
                           1e3 * step_s, profile)
    del opt, before, batches
    free(params)
    return used


def profile_train_step(phase: str, cfg, step, params, opt, batch,
                       step_ms: float, prefix: str) -> None:
    """One more step under the profiler: device busy against the
    unprofiled mean step, and the device time and launches of the kernels
    whose names start with ``prefix``, their share of both."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        step(params, opt, batch)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    log_profile(phase, f"{cfg.name} train step", rows, step_ms, 1)
    busy = sum(us for us, _, _ in rows) / 1e3
    named = [(us, n) for us, n, key in rows
             if re.sub(r"^void |\(anonymous namespace\)::", "",
                       key).startswith(prefix)]
    ms = sum(us for us, _ in named) / 1e3
    log(phase, f"{cfg.name}: the {prefix}* kernels (the ssm_scan "
        f"backward) {ms:.2f} ms of device time in {sum(n for _, n in named)}"
        f" launches in one profiled step: {100 * ms / max(busy, 1e-9):.1f}% "
        f"of its {busy:.1f} ms device time, {100 * ms / step_ms:.1f}% of "
        f"the {step_ms:.1f} ms mean step ({card()})")


# train ssm: hymba-1.5b in full, B 2 x S 4096; xlstm-350m at one whole
# 7:1 cycle (8 of its 24 layers; the sLSTM token loop under autograd took
# 10.7 s a step in full), B 4 x S 512 (the loop's host time grows with S:
# S 1024 took 7.5 s a step; cut to pay for the dry run's step passes in
# phases 30 and 38): (config, B, S[, cut])
SSM_TRAIN = [("hymba-1.5b", 2, 4096), ("xlstm-350m", 4, 512,
                                      {"n_layers": 8})]
# train vlm encdec: qwen2-vl-2b in full, B 2 x S 4096 with 256 patch
# embeddings a row; seamless-m4t-large-v2 in full, B 2 x 1000 frames x
# 1024 target tokens
VLM_TRAIN = ("qwen2-vl-2b", 2, 4096)
ENCDEC_TRAIN = ("seamless-m4t-large-v2", 2, 1024, 1000)


def phase_train_ssm(dev) -> dict:
    """[train ssm]: hymba-1.5b and xlstm-350m trained in full
    (``train_full``), one more hymba step profiled for the ssm_scan
    backward's share.  Returns hymba's launches."""
    runs = {name: train_full(dev, "train ssm",
                             get_config(name).replace(**(cut or [{}])[0]),
                             b, s, profile="scan_bwd_" if i == 0 else "")
            for i, (name, b, s, *cut) in enumerate(SSM_TRAIN)}
    return runs[SSM_TRAIN[0][0]]


def phase_train_vlm_encdec(dev) -> None:
    """[train vlm encdec]: qwen2-vl-2b and seamless-m4t-large-v2 trained
    in full (``train_full``)."""
    name, b, s = VLM_TRAIN
    train_full(dev, "train vlm encdec", get_config(name), b, s)
    name, b, s, frames = ENCDEC_TRAIN
    train_full(dev, "train vlm encdec", get_config(name), b, s,
               frames=frames)


# ---------------------------------------------------------------------------
# The agent planes: the cost model fitted on the card, the sim fleet priced
# by that fit, and the disaggregated pool over two live engines
# ---------------------------------------------------------------------------

# benchmarks/calibrate.py's grid: prompt lengths, and (batch, context)
CALIB_PREFILL_LENS = (64, 128, 256, 512)
CALIB_DECODE_GRID = ((1, 128), (1, 512), (2, 256), (4, 512), (8, 1024))
CALIB_REPS = 5
CALIB_WARMUP = 2
# where the fits go: CALIB_<model>.json, read back by costmodel_for
CALIB_DIR = ROOT / "chiprun_out"
# the workflow example's tiers, each priced by its own fit
SIM_MODELS = ("agent-7b", "agent-1b")


def median_s(fn, reps: int, warmup: int, sync) -> float:
    """Median of ``reps`` synchronized host-clock times of ``fn()``,
    after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def fill_ring(cache: dict, ctx: int) -> None:
    """Mark every ring slot of ``cache`` as holding a position below
    ``ctx``, so a decode step at position ``ctx`` attends over ``ctx``
    keys, the context ``CostModel.decode_cost`` charges."""
    for kv in transformer._ring_leaves(cache["segments"]):
        size = kv.kpos.shape[-1]
        kv.kpos.copy_(torch.arange(size, dtype=kv.kpos.dtype,
                                   device=kv.kpos.device).expand_as(kv.kpos))


@torch.inference_mode()
def measure_points(dev, cfg, params, prefill_lens, decode_grid,
                   reps: int = CALIB_REPS) -> list:
    """The port's twin of ``benchmarks/calibrate.py::measure_points``:
    ``models.prefill`` of a prompt on a fresh ring cache of its length,
    and ``models.decode_step`` on a ring of ``max_context = ctx`` whose
    slots all hold keys, replayed as a CUDA graph on the card (a
    ``StepGraph``, as ``TorchEngine`` replays decode); the median of
    ``reps`` synchronized host-clock times after warm-up, each paired
    with the cost model's analytic (FLOPs, bytes) of that shape."""
    cm = costmodel.CostModel(cfg, chips=1)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    pts = []
    for length in prefill_lens:
        cache = models.init_cache(cfg, 1, length, device=dev)
        tokens = torch.zeros((1, length), dtype=torch.int32, device=dev)
        t = median_s(lambda: models.prefill(params, cfg, tokens, cache),
                     reps, CALIB_WARMUP, sync)
        flops, nbytes = cm.prefill_cost(length)
        pts.append(CalibrationPoint("prefill", 1, length, flops, nbytes, t))
        del cache
    for batch, ctx in decode_grid:
        cache = models.init_cache(cfg, batch, ctx, device=dev)
        fill_ring(cache, ctx)

        def body(tokens, cache=cache, ctx=ctx):
            cache["pos"].fill_(ctx)          # the same step on every replay
            return models.decode_step(params, cfg, tokens, cache)[0]
        graph = StepGraph(body, {"tokens": ((batch, 1), torch.int32)}, dev,
                          graphed=dev.type == "cuda")
        zeros = np.zeros((batch, 1), np.int32)
        t = median_s(lambda: graph.run(tokens=zeros), reps, CALIB_WARMUP,
                     sync)
        graph.close()
        flops, nbytes = cm.decode_cost(batch, ctx)
        pts.append(CalibrationPoint("decode", batch, ctx, flops, nbytes, t))
        del cache
    return pts


@torch.inference_mode()
def prefill_device_ms(dev, cfg, params, length: int) -> tuple[float, int]:
    """Device time (ms) and kernels of one ``models.prefill`` of a
    ``length``-token prompt on a fresh ring cache, under the profiler."""
    cache = models.init_cache(cfg, 1, length, device=dev)
    tokens = torch.zeros((1, length), dtype=torch.int32, device=dev)
    models.prefill(params, cfg, tokens, cache)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        models.prefill(params, cfg, tokens, cache)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    return sum(r[0] for r in rows) / 1e3, sum(r[1] for r in rows)


def phase_calibrate(dev, cfg, params, out_dir: Path,
                    phase: str = "calibrate"):
    """Fit the port's cost model to ``cfg``'s steps measured on the card
    (``measure_points``) with ``calibrate(backend=<device type>)``; one
    line per point (measured, predicted, relative error) and the fit;
    save ``CALIB_<model>.json`` under ``out_dir`` and read it back
    through ``costmodel_for``.  A fit whose largest error passes the
    band is reported, not failed (the band is not widened).  On the
    card each prompt length's device busy time follows, from one more
    prefill under the profiler.  The kernels of the path (flash at each prefill, ring decode at each
    decode replay) launch exactly as often as the calls made."""
    for fn in KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    pts = measure_points(dev, cfg, params, CALIB_PREFILL_LENS,
                         CALIB_DECODE_GRID)
    backend = params["embed"]["table"].device.type
    calib = calibrate(cfg.name, backend, pts, chips=1)
    path = save_calibration(calib, out_dir / f"CALIB_{cfg.name}.json")
    gpu = card() if dev.type == "cuda" else "a CPU"
    for p, err in zip(calib.points, calib.rel_errors()):
        log(phase, f"{cfg.name} {p.kind} batch {p.batch} context "
            f"{p.context}: measured {1e3 * p.measured_s:.4f} ms, predicted "
            f"{1e3 * calib.predict(p):.4f} ms, relative error {err:.4f}")
    verdict = ("within" if calib.within_tolerance
               else "MISSES (recorded, the band is not widened)")
    log(phase, f"{cfg.name} fit on {gpu}, backend {backend}: flops_scale "
        f"{calib.flops_scale:.6g}, bytes_scale {calib.bytes_scale:.6g}, "
        f"step_overhead {1e3 * calib.step_overhead:.6g} ms; max_rel_err "
        f"{calib.max_rel_err:.4f} {verdict} the band {calib.tolerance} "
        f"({len(pts)} points, {CALIB_REPS} reps each, "
        f"median; {time.perf_counter() - t0:.1f} s); saved {path.name}")
    if dev.type == "cuda":
        for p in calib.points[:len(CALIB_PREFILL_LENS)]:
            ms_dev, kernels = prefill_device_ms(dev, cfg, params, p.context)
            log(phase, f"{cfg.name} prefill of {p.context} tokens: device "
                f"busy {ms_dev:.3f} ms of the {1e3 * p.measured_s:.3f} ms "
                f"measured ({100e-3 * ms_dev / p.measured_s:.1f}% busy), "
                f"{kernels} kernels and copies")
    cm = costmodel_for(cfg, calib_dir=out_dir)
    got = (cm.flops_scale, cm.bytes_scale, cm.step_overhead)
    if got != (calib.flops_scale, calib.bytes_scale, calib.step_overhead):
        raise AssertionError(f"{phase}: costmodel_for read {got} from "
                             f"{path}, the fit is {calib}")
    n = kind_layers(cfg, ("attn", "dec", "hymba")) if (
        cfg.use_pallas and dev.type == "cuda") else 0
    calls = CALIB_WARMUP + CALIB_REPS
    want = dict.fromkeys(KERNELS, 0)
    # and on the card two more prefills of each length, the profiled one
    # and its warm-up (prefill_device_ms)
    want["flash_attention"] = n * (calls + 2) * len(CALIB_PREFILL_LENS)
    # a graph's capture warm-up runs, then each replay
    runs = calls + (WARMUP_RUNS if dev.type == "cuda" else 0)
    want["decode_attention"] = n * runs * len(CALIB_DECODE_GRID)
    if launch_counts() != want:
        raise AssertionError(f"{phase}: kernel launches {launch_counts()}, "
                             f"expected {want}")
    log(phase, f"{cfg.name}: costmodel_for read the fit back; kernel "
        f"launches of this path {launch_counts()}")
    return calib


class captured_pipelines:
    """Keep each pipeline that runs inside the block (``ServingFabric.run``
    records its pipeline), restoring the method on exit."""

    def __enter__(self) -> list:
        self.pipelines, self._run = [], ServingFabric.run
        pipelines, run = self.pipelines, self._run

        def recorded(fabric, until):
            pipelines.append(fabric)
            return run(fabric, until)
        ServingFabric.run = recorded
        return self.pipelines

    def __exit__(self, *exc) -> None:
        ServingFabric.run = self._run


def phase_sim(calib_dir: Path, gpu: str, phase: str = "sim on the card's fit"
              ) -> None:
    """The quickstart ``AgenticPipeline`` and the workflow example's
    ``WorkflowPipeline`` (the port's example twins, unchanged), every
    ``SimEngine`` priced by the fits under ``calib_dir``
    (``REPRO_TORCH_CALIB_DIR``): tasks done, engine steps and latency
    percentiles, simulated at the costs fitted on ``gpu``.  Gates: every
    sim engine carries its model's fitted scales, the quickstart's
    intent switches the channel's granularity, and the workflow's 24
    graph tasks all finish."""
    fits = {p.stem[len("CALIB_"):]: load_calibration(p)
            for p in sorted(calib_dir.glob("CALIB_*.json"))}
    saved = os.environ.get(costmodel.CALIB_DIR_ENV)
    os.environ[costmodel.CALIB_DIR_ENV] = str(calib_dir)
    try:
        for name, example in (("quickstart", quickstart),
                              ("workflow", workflow)):
            out = io.StringIO()
            t0 = time.perf_counter()
            with captured_pipelines() as runs, \
                    contextlib.redirect_stdout(out):
                example.main()
            wall = time.perf_counter() - t0
            for line in out.getvalue().splitlines():
                if line.strip():
                    log(phase, f"{name} | {line}")
            (p,) = runs
            engines = [p.registry.get(n) for n in p.registry.names()
                       if isinstance(p.registry.get(n), SimEngine)]
            for e in engines:
                fit = fits.get(e.cm.cfg.name)
                if fit is None or (e.cm.flops_scale, e.cm.bytes_scale,
                                   e.cm.step_overhead) != (
                        fit.flops_scale, fit.bytes_scale, fit.step_overhead):
                    raise AssertionError(f"{phase}: {e.name} "
                                         f"({e.cm.cfg.name}) is not priced "
                                         f"by a fit under {calib_dir}")
            lat = np.array(p.latencies())
            if name == "quickstart" and not any(
                    "granularity" in a.detail
                    for a in p.controller.action_log("set")):
                raise AssertionError(f"{phase}: the quickstart intent "
                                     f"never switched the granularity")
            if name == "workflow" and len(p.done) != 24:
                raise AssertionError(f"{phase}: {len(p.done)} of 24 "
                                     f"workflow tasks finished")
            if not len(lat):
                raise AssertionError(f"{phase}: {name} finished no task")
            p50, p95, p99 = np.percentile(lat, [50, 95, 99])
            log(phase, f"{name}, simulated at the costs fitted on {gpu}: "
                f"{len(p.done)} tasks done by t = {p.loop.now():.1f} s "
                f"(virtual); {len(engines)} sim engines "
                f"({', '.join(sorted({e.cm.cfg.name for e in engines}))}) "
                f"ran {sum(e.steps for e in engines)} steps "
                f"({sum(e.prefill_steps for e in engines)} prefill, "
                f"{sum(e.decode_steps for e in engines)} decode); task "
                f"latency p50 {p50:.4f} s, p95 {p95:.4f} s, p99 "
                f"{p99:.4f} s; {wall:.2f} s of host time")
    finally:
        if saved is None:
            os.environ.pop(costmodel.CALIB_DIR_ENV, None)
        else:
            os.environ[costmodel.CALIB_DIR_ENV] = saved


def drive_pool(loop, engines, reqs, max_rounds: int = 100_000) -> int:
    """Drive a ``DisaggPool`` of live engines: run the event loop until
    its queue is empty (routed prompts land, finished handoffs arrive at
    their decode engine), then step each busy engine once; until every
    request has finished.  Returns the rounds taken."""
    for n in range(max_rounds):
        loop.run_until()
        if all(r.state == RequestState.FINISHED for r in reqs):
            return n
        busy = [e for e in engines if e.busy]
        if not busy:
            raise AssertionError(f"no engine busy, requests "
                                 f"{[r.state.value for r in reqs]}")
        for e in busy:
            e.step()
    raise AssertionError(f"unfinished after {max_rounds} rounds")


def timed(fn, sync, record: list):
    """``fn`` with each call kept in ``record`` as (synchronized seconds,
    arguments, result)."""
    def wrapped(*args):
        sync()
        t0 = time.perf_counter()
        out = fn(*args)
        sync()
        record.append((time.perf_counter() - t0, args, out))
        return out
    return wrapped


def phase_serve_disagg(dev, cfg, params, phase: str = "serve disagg") -> dict:
    """The reference's ``DisaggPool`` over two live paged engines on one
    set of weights, a prefill-role and a decode-role one, with a
    ``KVTransferManager`` on an ``EventLoop`` moving the cost model's
    bytes (``drive_pool``): the 8 serve requests, 64 new tokens each.
    Gates: every request's greedy tokens equal a unified paged engine's
    on the same requests; 8 handoffs, each state extracted into pinned
    host memory (``cache_utils.to_host``) on the prefill engine and
    injected on the decode engine; the decode engine replays its
    captured decode graph, the prefill engine never decodes; exact
    kernel launches.  Prints each handoff's extract and inject time and
    rate.  Returns the run's launches."""
    gpu = card() if dev.type == "cuda" else "a CPU"
    graphs = None if dev.type == "cuda" else False
    unified = TorchEngine(cfg, params, SchedulerConfig(**SERVE_SCHED),
                          name="unified", cache_layout="paged", device=dev,
                          cuda_graphs=graphs)
    reqs = make_requests(SERVE_LENS, 64, cfg.vocab, seed=3)
    serve(unified, reqs)
    want_tokens = [list(r.output_tokens) for r in reqs]
    release(unified)

    loop = EventLoop()
    engines = [TorchEngine(cfg, params,
                           SchedulerConfig(**SERVE_SCHED, role=role),
                           name=f"{role}-0", cache_layout="paged",
                           device=dev, cuda_graphs=graphs)
               for role in ("prefill", "decode")]
    pre, dec = engines
    cm = costmodel_for(cfg, calib_dir=CALIB_DIR)
    kvx = KVTransferManager(loop, SessionDirectory(),
                            bytes_fn=cm.kv_transfer_bytes)
    pool = DisaggPool(loop, engines, kvx)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    extracts, injects = [], []
    pre.extract_state = timed(pre.extract_state, sync, extracts)
    dec.inject_state = timed(dec.inject_state, sync, injects)
    forwards = count_prefill_work(pre)
    reqs = make_requests(SERVE_LENS, 64, cfg.vocab, seed=3)
    for fn in KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        pool.submit(r)
    rounds = drive_pool(loop, engines, reqs)
    wall = time.perf_counter() - t0
    used = launch_counts()

    got = [list(r.output_tokens) for r in reqs]
    if got != want_tokens:
        bad = [i for i, (a, b) in enumerate(zip(got, want_tokens)) if a != b]
        raise AssertionError(f"{phase}: requests {bad} differ from the "
                             f"unified run's tokens")
    if pool.handoffs != len(reqs) or kvx.handoffs != len(reqs) or \
            len(extracts) != len(reqs) or len(injects) != len(reqs):
        raise AssertionError(f"{phase}: {pool.handoffs} handoffs, "
                             f"{len(extracts)} extracts, {len(injects)} "
                             f"injects for {len(reqs)} requests")
    for _, _, state in extracts:
        leaves = cache_utils._leaves(state["cache"])
        bad = [tuple(t.shape) for t in leaves if t.device.type != "cpu"
               or (dev.type == "cuda" and not t.is_pinned())]
        if bad:
            raise AssertionError(f"{phase}: handoff state not in pinned "
                                 f"host memory: {bad[:4]}")
    if pre.decode_steps or dec.prefill_steps or \
            pre.tokens_generated != len(reqs):
        raise AssertionError(f"{phase}: prefill engine {pre.decode_steps} "
                             f"decode steps, {pre.tokens_generated} tokens; "
                             f"decode engine {dec.prefill_steps} prefill "
                             f"steps")
    if dev.type == "cuda" and dict(dec.step_captures) != {"decode": 1}:
        raise AssertionError(f"{phase}: decode engine captures "
                             f"{dict(dec.step_captures)}")
    want = dict.fromkeys(KERNELS, 0)
    for e, pf, runs, single in ((pre, forwards[0], 0, forwards[2]),
                                (dec, 0, dec.step_runs["decode"], 0)):
        for k, v in expected_launches(e, pf, runs, 0, single).items():
            want[k] += v
    if used != want:
        raise AssertionError(f"{phase}: kernel launches {used}, expected "
                             f"{want}")
    log(phase, f"{cfg.name}, {gpu}: a prefill-role and a decode-role paged "
        f"engine over one set of weights behind a DisaggPool, 8 requests "
        f"(prompts {SERVE_LENS}, 64 new tokens): all FINISHED in "
        f"{wall:.3f} s ({rounds} rounds of drive_pool), greedy tokens equal "
        f"the unified paged run's ({sum(map(len, got))} tokens); "
        f"{pool.handoffs} handoffs through pinned host memory; prefill "
        f"engine {pre.prefill_steps} prefill steps in {forwards[0]} "
        f"forwards, decode engine {dec.decode_steps} decode steps, "
        f"captures {dict(dec.step_captures)}, body runs "
        f"{dec.step_runs['decode']}; the link priced "
        f"{kvx.handoff_bytes / 1e9:.3f} GB; kernel launches {used}")
    injected = {args[0].req_id: dt for dt, args, _ in injects}
    for i, (te, (req,), state) in enumerate(extracts):
        nbytes, ti = state["nbytes"], injected[req.req_id]
        log(phase, f"{gpu}: handoff {i}: {nbytes / 2**20:.1f} MiB, extract "
            f"to pinned host memory {1e3 * te:.3f} ms "
            f"({nbytes / te / 1e9:.2f} GB/s), inject "
            f"{1e3 * ti:.3f} ms ({nbytes / ti / 1e9:.2f} GB/s)")
    release(pre)
    release(dec)
    return used


# ---------------------------------------------------------------------------
# Sharded steps (phase 38): the launch layer's mesh-aware serve, prefill
# and train steps, world 1 over NCCL, then two gloo ranks on the one card
# ---------------------------------------------------------------------------

# (a) agent-7b in full, bf16: 8 sequences of 128 tokens and 8 decode steps,
# one train step at B 2 x S 4096 with int8 moments
SHARDED_FULL, SHARDED_B, SHARDED_PROMPT, SHARDED_DECODE = "agent-7b", 8, 128, 8
# (b), (c) two gloo ranks sharing the card, f32: agent-7b's width at 2
# layers, arctic's at 1 layer with 8 of its 128 experts (both ranks keep
# the unsharded model beside their shards: 128 would take 2 x 62 GB);
# prefill of B 2 x 64 then 16 greedy tokens, a train step at B 2 x S 512
SHARDED_TP = ("agent-7b", dict(n_layers=2))
SHARDED_EP = ("arctic-480b", dict(n_layers=1, n_experts=8))
SHARDED_SERVE_B, SHARDED_SERVE_PROMPT, SHARDED_NEW = 2, 64, 16
SHARDED_TRAIN_B, SHARDED_TRAIN_SEQ = 2, 512
# f32 logits through a 2-layer random-init stack: the ranks' partial sums
# reduce in another order than one device's einsum; the parity phases'
# decode band (ROADMAP §C: f32 decode logits drift ~1e-4 in both packages)
SHARDED_LOGIT_TOL = 2e-3
SHARDED_DIR = ROOT / "build" / "sharded"
# (d), (e) sequence-sharded rings on the same two ranks, f32, kernels on
# (ROADMAP A6.2).  (d) mesh (1, 2), the GQA fallback: agent-7b's width
# (d 4096, dh 128) at 2 layers with 16 query heads over one KV head (KV
# heads that do not divide a model axis of 2 must be odd, and no config
# of the repo has a single KV head; 32 heads over one would be a GQA
# group of 32, which no decode kernel takes, while 16 is llama3-405b's
# group, what each rank decodes with in its fallback), B 2, a 200-token
# prompt in a 328-slot ring, 164 slots a rank, so both ranks hold keys.
# (e) mesh (2, 1), a ``long``-named decode shape: agent-7b's width at 2
# layers (32 heads, 8 KV heads, d 4096), B 1, a 4096-slot ring, 2048 slots
# a rank, a 2100-token prompt prefilled on one device and cut to the
# step's spec; 16 greedy tokens each.  (e) serves under rules that keep
# the weights whole on every rank (the default rules' FSDP cuts them
# over ``data``, and gloo would carry 2.5 GB of gathered weights a
# decode step: 2.6 s, 42 s for the 16 steps); (c) holds FSDP on the card
# and tests/test_torch_launch.py serves long_* with it on the CPU
SHARDED_GQA = ("agent-7b", dict(n_layers=2, n_heads=16, n_kv_heads=1))
SHARDED_GQA_B, SHARDED_GQA_PROMPT = 2, 200
SHARDED_LONG = ("agent-7b", dict(n_layers=2))
SHARDED_LONG_RING, SHARDED_LONG_PROMPT = 4096, 2100
SHARDED_LONG_RULES = shd.ShardingRules(rules=tuple(
    r for r in shd.DEFAULT_RULES.rules if r[0] != "embed"))
# (f) tensor parallelism over ``model`` of the other families on the same
# ranks, mesh (1, 2), f32, kernels on, (b)'s sizes, each config at its
# full width at cut depth: hymba-1.5b at 2 layers, one global and one
# windowed (its 25 heads and 5 KV heads stay whole at a model axis of 2,
# so each 192-slot ring is cut over ``model``: a rank decodes with whole
# query heads over its 96 slots and the ranks combine; in_proj, out_proj
# and the MLP are cut), xlstm-350m as one mLSTM and one sLSTM layer,
# qwen2-vl-2b at 1 layer (6 heads over 1 KV head a rank) with 16 patch
# embeddings in the prompt and 256 in the train rows at M-RoPE (t, h, w)
# positions, seamless-m4t-large-v2 at 1 + 1 layers (8 heads a rank in
# the encoder, the decoder and the cross attention, whose K/V is cut by
# heads) with the prompt's 16 frames and SHARDED_FRAMES in training
SHARDED_FAMILIES = [
    ("hymba-1.5b", dict(n_layers=2, global_layers=(0,))),
    ("xlstm-350m", dict(n_layers=2, mlstm_ratio=1)),
    ("qwen2-vl-2b", dict(n_layers=1)),
    ("seamless-m4t-large-v2", dict(n_layers=1, enc_layers=1)),
]
SHARDED_PATCHES = 16
SHARDED_FRAMES = 512
# (g) mesh (2, 1), a ``long``-named decode shape: seamless-m4t-large-v2 at
# full width, 1 + 1 layers, B 1, (e)'s 4096-slot ring and 2100-token
# prompt, whose 992 frames (``enc_len`` of the shape) the cache spec cuts
# along the cross K/V's encoder axis over ``data``, 496 a rank; prefilled
# on one device and cut to the step's spec, 15 greedy steps, each rank
# attending over its encoder range and the ranks combining
SHARDED_CROSS = ("seamless-m4t-large-v2", dict(n_layers=1, enc_layers=1))
# (c') the same ranks on (2, 1), DP + FSDP, a batch split that does not
# divide over them (ROADMAP §C, port fault 7): (b)'s B 2 x S 512 in
# SHARDED_UNEVEN_MICRO microbatches of one row, so rank 1 holds no row of
# either and runs both microbatches' forward and backward on empty
# tensors (GSPMD's padded shards), at agent-7b's width at 2 layers and at
# arctic's at 1 layer with 8 experts (a microbatch of one global row
# routes on the MoE's global dispatch, as the reference's does); f32
# moments, each rank held to the mesh-less step with the same plan
SHARDED_UNEVEN_MICRO = 2
# (h) checkpoints of a sharded train state on the same ranks: (c)'s state
# saved from (2, 1) and restored three ways, a TP step from it; then
# TrainSupervisor over the TP step (1, 2) at agent-7b's width at 1 layer,
# bf16, B 2 x S 128, 6 steps, a checkpoint every 2 (async), a failure on
# both ranks right after the step-4 checkpoint: (config, cut, B, S,
# steps, interval, failure)
SHARDED_SUP = ("agent-7b", dict(n_layers=1), 2, 128, 6, 2, 4)
# the kernels each (f) config runs on its shards: every rank launches
# each of them on the path
SHARDED_FAMILY_KERNELS = {
    "hymba-1.5b": {"flash_attention", "flash_attention_backward",
                   "decode_attention", "attention_combine", "ssm_scan",
                   "ssm_scan_backward"},
    "xlstm-350m": {"ssm_scan", "ssm_scan_backward"},
    "qwen2-vl-2b": {"flash_attention", "flash_attention_backward",
                    "decode_attention"},
    "seamless-m4t-large-v2": {"flash_attention", "flash_attention_backward",
                              "decode_attention"},
}


def sync(dev) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize()


def sharded_store(name: str) -> str:
    """A FileStore path under SHARDED_DIR (no TCP port), made fresh."""
    SHARDED_DIR.mkdir(parents=True, exist_ok=True)
    path = SHARDED_DIR / name
    path.unlink(missing_ok=True)
    return f"file://{path}"


def sharded_world1(dev) -> dict:
    """(a) World 1 over NCCL (gloo on the CPU), ``make_mesh((1, 1))``:
    agent-7b in full, bf16, kernels on.  make_prefill_step and
    make_serve_step over 8 sequences give transformer.prefill's and
    decode_step's logits bit for bit; one make_train_step(cfg, mesh) step
    at B 2 x S 4096 with int8 moments gives the mesh-less step's loss,
    parameters and moments bit for bit (both under deterministic
    algorithms).  Returns the mesh run's launches."""
    phase = "sharded"
    backend = "nccl" if dev.type == "cuda" else "gloo"
    marks = [("start", time.perf_counter())]
    dist.init_process_group(backend, init_method=sharded_store("world1"),
                            world_size=1, rank=0)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type=dev.type)
        marks.append(("process group and mesh", time.perf_counter()))
        cfg = get_config(SHARDED_FULL).replace(use_pallas=True)
        params = init_train(cfg, dev, phase)
        sync(dev)
        marks.append(("init", time.perf_counter()))
        b, s = SHARDED_B, SHARDED_PROMPT
        shape_d = ShapeConfig("sharded", s, b, "decode")
        pre, _ = make_prefill_step(cfg, mesh, ShapeConfig("sharded", s, b,
                                                          "prefill"))
        dec, _ = make_serve_step(cfg, mesh, shape_d)
        gen = torch.Generator(device=dev).manual_seed(38)
        toks = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                             device=dev)
        cache = serve_launch.init_cache(cfg, mesh, shape_d)
        ref_cache = models.init_cache(cfg, b, specs_launch.decode_context(
            shape_d), device=dev)
        start = all_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            got, cache = pre(params, toks, cache)
            want, ref_cache = models.prefill(params, cfg, toks, ref_cache)
            equal = [torch.equal(got, want)]
            for _ in range(SHARDED_DECODE):
                nxt = want.argmax(-1)[:, None]
                got, cache = dec(params, nxt, cache)
                want, ref_cache = models.decode_step(params, cfg, nxt,
                                                     ref_cache)
                equal.append(torch.equal(got, want))
        sync(dev)
        serve_s = time.perf_counter() - t0
        used = {k: v - start[k] for k, v in all_counts().items()}
        if not all(equal):
            raise AssertionError(f"{phase}: world-1 mesh serve logits differ "
                                 f"from the mesh-less steps': {equal}")
        del cache, ref_cache
        marks.append(("serve", time.perf_counter()))
        acfg = AdamWConfig(lr=1e-3, warmup_steps=0, int8_moments=True)
        plan = TrainPlan(int8_moments=True)
        batch = family_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, gen, dev)
        # two copies of the weights and moments (2 x 18 GB), made before
        # either step
        t0 = time.perf_counter()
        states = [(params, adamw_init(params, acfg))]
        states.append(tuple(prm.unflatten(d, [t.clone() for t in leaves])
                            for leaves, d in (prm.flatten(x)
                                              for x in states[0])))
        sync(dev)
        states_s = time.perf_counter() - t0
        runs = {}
        for name, (p, opt), m in zip(("mesh-less", "mesh"), states,
                                     (None, mesh)):
            step = make_train_step(cfg, m, plan, acfg, device=dev,
                                   shape=ShapeConfig("sharded", TRAIN_SEQ,
                                                     TRAIN_BATCH, "train"))
            gc.collect()
            sync(dev)
            mem = (torch.cuda.memory_allocated() / 1e9
                   if dev.type == "cuda" else 0.0)
            t0 = time.perf_counter()
            p, opt, metrics = step(p, opt, batch)
            sync(dev)
            runs[name] = (p, opt, metrics, time.perf_counter() - t0, mem)
            del step
        del states
        marks.append(("two train steps", time.perf_counter()))
        (p0, o0, m0, t_0, _), (p1, o1, m1, t_1, mem) = runs["mesh-less"], \
            runs["mesh"]
        same = all(torch.equal(a, c) for a, c in zip(
            prm.flatten((p0, o0))[0], prm.flatten((p1, o1))[0]))
        same_m = all(torch.equal(m0[k], m1[k]) for k in m0)
        if not (same and same_m):
            raise AssertionError(f"{phase}: the world-1 mesh train step "
                                 f"differs from the mesh-less step "
                                 f"(leaves equal {same}, metrics {same_m})")
        marks.append(("compare", time.perf_counter()))
        gpu = card() if dev.type == "cuda" else "a CPU"
        log(phase, f"(a) world 1, {backend}, mesh (1, 1), {cfg.name} in "
            f"full ({cfg.n_layers} layers, bf16, kernels on), {gpu}: "
            f"make_prefill_step + {SHARDED_DECODE} make_serve_step steps "
            f"over {b} sequences of {s} tokens ({serve_s:.2f} s with the "
            f"mesh-less twins) give transformer.prefill's and "
            f"decode_step's logits bit for bit; one make_train_step(cfg, "
            f"mesh) step at B {TRAIN_BATCH} x S {TRAIN_SEQ}, int8 moments, "
            f"{1e3 * t_1:.1f} ms (mesh-less {1e3 * t_0:.1f} ms, each the "
            f"first of its step), loss {m1['loss'].item():.6f}, gives the "
            f"mesh-less step's loss, grad_norm, parameters and moments bit "
            f"for bit (deterministic algorithms; {mem:.2f} GB allocated "
            f"before the second step; the two states made in "
            f"{states_s:.1f} s); serve launches "
            f"{ {k: v for k, v in used.items() if v} }; "
            + ", ".join(f"{name} {b - a:.1f} s" for (_, a), (name, b)
                        in zip(marks, marks[1:])))
        del runs, p0, p1, o0, o1
        free(params)
        return used
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()


class hold_sharded_calls:
    """Within the block, every flash, ring decode (with its log-sum-exp
    over a ring cut over ``model``), attention_combine, grouped_matmul
    and ssm_scan call a rank makes on its local shard, forward (served or
    trained) and backward, is held to its plain version on the call's own
    inputs as it is made, within the band of ``dtype`` (``kernelwise``,
    ``hold_flash_calls``, ``hold_training_calls``; the scan within
    SCAN_TOL), so no call's inputs outlive it (a step's FSDP-gathered
    expert weights, 1.1 GB a call at arctic's width, would not fit two
    ranks' calls on one card); ``check()`` returns the worst error.
    ``where`` names the phase in the log and in a failure."""

    def __init__(self, where: str, dtype=torch.float32):
        self.where, self.dtype, self.worst = where, dtype, 0.0

    def _flash(self, forward: bool):
        seen = itertools.count()

        def hold(args, res):
            call = (next(seen), list(args),
                    list(res if isinstance(res, tuple) else (res,)))
            self.worst = max(self.worst, hold_flash_calls(
                self.where, [call] if forward else [],
                [] if forward else [call], self.dtype))
        return record_calls("repro_torch.kernels.flash_attention",
                            "_launch" if forward else "_launch_backward",
                            hold)

    def _training(self, module: str, name: str, kind: str):
        seen = itertools.count()

        def hold(args, res):
            calls = dict.fromkeys(("gm_fwd", "gm_bwd", "scan_fwd",
                                   "scan_bwd"), [])
            calls[kind] = [(args, res)]
            self.worst = max(self.worst, hold_training_calls(
                self.where, calls, self.dtype, first=next(seen)))
        return record_calls(module, name, hold)

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        self.kw = self._stack.enter_context(kernelwise(combine=True))
        for forward in (True, False):
            self._stack.enter_context(self._flash(forward))
        for module, name, kind in (
                (GM_MOD, "_launch", "gm_fwd"),
                (GM_MOD, "_launch_backward", "gm_bwd"),
                (SCAN_MOD, "_launch", "scan_fwd"),
                (SCAN_MOD, "_launch_backward", "scan_bwd")):
            self._stack.enter_context(self._training(module, name, kind))
        return self

    def __exit__(self, *exc):
        return self._stack.__exit__(*exc)

    def check(self) -> float:
        err = self.kw.max_err()
        if not err <= TOL[self.dtype]:
            raise AssertionError(f"{self.where}: a served kernel call "
                                 f"differs from its plain version by {err}")
        return max(err, self.worst)


def sharded_frontend(cfg, b: int, patches: int, enc: int,
                     gen: torch.Generator, dev) -> list:
    """The prefill step's extra input for a config that takes one: a
    VLM's ``patches`` patch embeddings (B, P, d) over the first slots, an
    encoder-decoder's ``enc`` frame embeddings (B, enc, d)."""
    if cfg.frontend == "patch":
        n = patches
    elif cfg.is_encdec:
        n = enc
    else:
        return []
    return [torch.randn((b, n, cfg.d_model), generator=gen,
                        device=dev).to(prm.torch_dtype(cfg.dtype))]


def sharded_cfg(name: str, cut: dict):
    """A phase 38 config: the registry's (or a ``smoke:`` name's smoke),
    f32, kernels on, cut by ``cut``."""
    cfg = (get_smoke(name[len("smoke:"):]) if name.startswith("smoke:")
           else get_config(name))
    return cfg.replace(dtype="float32", use_pallas=True, **cut)


def sharded_case(mesh, name: str, cut: dict, dev, phase: str, sizes: dict,
                 serve: bool = True, keep: dict | None = None) -> dict:
    """One config on ``mesh`` in a gloo rank, kernels on, f32: prefill of
    B 2 x 64 (with a VLM's patch embeddings or an encoder-decoder's
    frames, ``sharded_frontend``) and SHARDED_NEW greedy tokens through
    make_prefill_step / make_serve_step, and one make_train_step (its
    gradients, then its AdamW half on them; ``family_batch``, with
    SHARDED_FRAMES frames for an encoder-decoder), every kernel call on
    the rank's shards held to its plain version.  Rank 0 also serves the
    unsharded model, on the card they share: the greedy tokens equal its
    (logits within SHARDED_LOGIT_TOL); the phase holds the other rank's
    tokens and loss to rank 0's.  Every rank takes the unsharded model's
    loss and gradients and holds its step's loss (within 1e-4) and each
    of its gradient shards to them (each leaf within phase 29's band of
    the whole leaf's largest magnitude), so no gradient crosses gloo.
    Returns the results, stage times and launches; ``keep`` (a dict)
    receives the step, its state after the update, the config, the AdamW
    config and the batch, for (h) to checkpoint."""
    cfg = sharded_cfg(name, cut)
    ref = dist.get_rank() == 0
    marks = [("start", time.perf_counter())]
    gen = torch.Generator(device=dev).manual_seed(0)
    full = models.init(cfg, gen, device=dev)
    attention.rescale_to_true_fan_in(full)
    where = f"{phase} {cfg.name} on {dict(parallel.context(mesh).sizes)}"
    out = {"config": f"{cfg.name} width, {cfg.n_layers} layer(s)"
           + (f" + {cfg.enc_layers} encoder layer(s)" if cfg.is_encdec
              else "")
           + (f", {cfg.n_experts} experts" if cfg.n_experts else "")}
    worst = 0.0
    gen = torch.Generator(device=dev).manual_seed(1)
    sync(dev)
    marks.append(("init", time.perf_counter()))

    def counts() -> dict:
        return {**all_counts(),
                "attention_combine": attention_combine.launches}

    start = counts()
    if serve:
        b, s = sizes["serve_b"], sizes["prompt"]
        shape_d = ShapeConfig("sharded", s, b, "decode")
        pre, specs = make_prefill_step(cfg, mesh, ShapeConfig(
            "sharded", s, b, "prefill"))
        dec, _ = make_serve_step(cfg, mesh, shape_d)
        params = parallel.shard_tree(full, specs["params"], mesh)
        toks = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                             device=dev)
        enc = specs_launch.enc_len(cfg, shape_d)
        extra = sharded_frontend(cfg, b, sizes["patches"], enc, gen, dev)
        rows = serve_launch.local_rows(torch.arange(b, device=dev),
                                       parallel.context(mesh))
        cache = serve_launch.init_cache(cfg, mesh, shape_d)
        got_t, logits = [], []
        with torch.no_grad():
            with hold_sharded_calls(where) as held:
                got, cache = pre(params, toks, cache, *extra)
            worst = max(worst, held.check())
            nxt = torch.zeros((b, 1), dtype=torch.long, device=dev)
            for i in range(sizes["new"]):
                got_t.append(got.argmax(-1))
                logits.append(got)
                if i == sizes["new"] - 1:
                    break
                nxt[rows] = got_t[-1][:, None]
                with hold_sharded_calls(where) as held:
                    got, cache = dec(params, nxt, cache)
                worst = max(worst, held.check())
            del params, cache
            used = {k: v - start[k] for k, v in counts().items()}
            if ref:
                ref_cache = models.init_cache(
                    cfg, b, specs_launch.decode_context(shape_d), device=dev,
                    enc_len=enc)
                kw = {}
                if extra:
                    kw["vision_embeds" if cfg.frontend == "patch"
                       else "frames"] = extra[0]
                want, ref_cache = models.prefill(full, cfg, toks, ref_cache,
                                                 **kw)
                diffs, same = [], True
                for i, (g, t) in enumerate(zip(logits, got_t)):
                    if i:
                        want, ref_cache = models.decode_step(
                            full, cfg, want.argmax(-1)[:, None], ref_cache)
                    diffs.append((g - want[rows]).abs().max().item())
                    same &= torch.equal(t, want[rows].argmax(-1))
                if not same:
                    raise AssertionError(f"{where}: greedy tokens differ "
                                         f"from the unsharded run's")
                if max(diffs) > SHARDED_LOGIT_TOL:
                    raise AssertionError(f"{where}: logits differ by "
                                         f"{max(diffs)}")
                out["logits"] = max(diffs)
                del ref_cache
        out["tokens"] = torch.stack(got_t, 1).tolist()
        sync(dev)
        marks.append(("serve", time.perf_counter()))
    acfg = AdamWConfig(lr=1e-3, warmup_steps=0, int8_moments=True)
    b, s = sizes["train_b"], sizes["train_seq"]
    batch = family_batch(cfg, b, s, gen, dev,
                         frames=sizes["frames"] if cfg.is_encdec else 0,
                         grid=sizes["grid"])
    start = counts()
    step = make_train_step(cfg, mesh, TrainPlan(int8_moments=True), acfg,
                           shape=ShapeConfig("sharded", s, b, "train"))
    specs = step.shardings["params"]
    params = parallel.shard_tree(full, specs, mesh)
    opt = init_opt_state(params, acfg, mesh, cfg=cfg)
    if dev.type == "cuda":
        sync(dev)
        torch.cuda.reset_peak_memory_stats()
    with hold_sharded_calls(where) as held, \
            models.boundary_saves() as saved, \
            parallel.record_collectives() as coll:
        metrics, grads = step.grads(params, batch, with_metrics=True)
    worst = max(worst, held.check())
    del held
    sync(dev)
    out.update(boundary_bytes(cfg, step.ctx, saved, b, s,
                              sizes["frames"] if cfg.is_encdec else 0, where))
    out["peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                      if dev.type == "cuda" else None)
    marks.append(("sharded gradients, held", time.perf_counter()))
    launches = {k: v - start[k] + (used[k] if serve else 0)
                for k, v in counts().items()}
    # the step's AdamW half on the gradients just held
    with parallel.record_collectives() as coll_update:
        params, opt, m = step.update(params, opt, grads, metrics)
    sync(dev)
    out["collectives"] = [list(c) for c in coll + coll_update]
    marks.append(("update", time.perf_counter()))
    if not all(torch.isfinite(t).all() for t in prm.flatten(params)[0]):
        raise AssertionError(f"{where}: non-finite parameters after a step")
    if keep is not None:
        keep.update(step=step, state=(params, opt), cfg=cfg, acfg=acfg,
                    batch=batch)
    del params, opt
    ref_loss, ref_g = grads_and_loss(cfg, full, batch)
    treedef = prm.flatten(full)[1]
    mine = prm.flatten(parallel.shard_tree(prm.unflatten(treedef, list(
        ref_g)), specs, mesh))[0]
    errs = [((g.float() - r.float()).abs().max()
             / w.float().abs().max().clamp_min(1e-30)).item()
            for g, r, w in zip(prm.flatten(grads)[0], mine, ref_g)]
    loss_err = abs(m["loss"].item() - ref_loss.item())
    if loss_err > 1e-4 or max(errs) > TRAIN_F32_GRAD_TOL:
        raise AssertionError(f"{where}: train step loss off by {loss_err}, "
                             f"gradient shards by up to {max(errs)}")
    out.update(loss_err=loss_err, grad_err=max(errs), leaves=len(errs))
    del grads, ref_g, mine
    sync(dev)
    marks.append(("unsharded run", time.perf_counter()))
    free(full)
    out["stages"] = ", ".join(f"{name} {b - a:.1f} s" for (_, a), (name, b)
                              in zip(marks, marks[1:]))
    out.update(loss=m["loss"].item(), kernel_err=worst,
               launches={k: v for k, v in launches.items() if v})
    return out


def sharded_uneven_case(mesh, name: str, cut: dict, dev, phase: str,
                        sizes: dict) -> dict:
    """(c') in a gloo rank: one train step of B 2 x S 512 in
    SHARDED_UNEVEN_MICRO microbatches on ``mesh`` (2, 1), kernels on, f32,
    so rank 0 holds each microbatch's row and rank 1 none: its loss and
    each of its gradient shards held to the mesh-less step with the same
    plan on the same weights and batch (the loss within 1e-4, each leaf
    within phase 29's band of the whole leaf's largest magnitude), every
    kernel call of the sharded step held to its plain version, its
    launches and its collectives (around the gradients and the AdamW
    half) returned."""
    cfg = sharded_cfg(name, cut)
    marks = [("start", time.perf_counter())]
    full = models.init(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    attention.rescale_to_true_fan_in(full)
    where = f"{phase} {cfg.name} on {dict(parallel.context(mesh).sizes)}"
    plan = TrainPlan(microbatch=SHARDED_UNEVEN_MICRO)
    acfg = AdamWConfig(lr=1e-3, warmup_steps=0)
    b, s = sizes["train_b"], sizes["train_seq"]
    batch = family_batch(cfg, b, s, torch.Generator(device=dev).manual_seed(1),
                         dev)
    sync(dev)
    marks.append(("init", time.perf_counter()))
    start = all_counts()
    step = make_train_step(cfg, mesh, plan, acfg,
                           shape=ShapeConfig("sharded", s, b, "train"))
    specs = step.shardings["params"]
    params = parallel.shard_tree(full, specs, mesh)
    opt = init_opt_state(params, acfg, mesh, cfg=cfg)
    with hold_sharded_calls(where) as held, \
            parallel.record_collectives() as coll:
        metrics, grads = step.grads(params, batch, with_metrics=True)
    kernel_err = held.check()
    del held
    with parallel.record_collectives() as coll_update:
        params, opt, m = step.update(params, opt, grads, metrics)
    sync(dev)
    launches = {k: v - start[k] for k, v in all_counts().items()}
    marks.append(("sharded step, held", time.perf_counter()))
    if not all(torch.isfinite(t).all() for t in prm.flatten(params)[0]):
        raise AssertionError(f"{where}: non-finite parameters after a step")
    del params, opt
    ref = make_train_step(cfg, None, plan, acfg, device=dev)
    ref_m, ref_g = ref.grads(full, batch, with_metrics=True)
    mine = prm.flatten(parallel.shard_tree(ref_g, specs, mesh))[0]
    errs = [((g.float() - r.float()).abs().max()
             / w.float().abs().max().clamp_min(1e-30)).item()
            for g, r, w in zip(prm.flatten(grads)[0], mine,
                               prm.flatten(ref_g)[0])]
    loss_err = abs(m["loss"].item() - ref_m["loss"].item())
    if loss_err > 1e-4 or max(errs) > TRAIN_F32_GRAD_TOL:
        raise AssertionError(f"{where}: train step loss off by {loss_err}, "
                             f"gradient shards by up to {max(errs)}")
    del grads, ref_g, mine
    sync(dev)
    marks.append(("mesh-less step", time.perf_counter()))
    rows = int(train_launch._local_rows(
        torch.arange(b), plan.microbatch, step.ctx.batch_world,
        step.ctx.batch_rank).numel()) // plan.microbatch
    free(full)
    return {"config": f"{cfg.name} width, {cfg.n_layers} layer(s)"
            + (f", {cfg.n_experts} experts" if cfg.n_experts else ""),
            "rows": rows, "loss": m["loss"].item(), "loss_err": loss_err,
            "grad_err": max(errs), "leaves": len(errs),
            "kernel_err": kernel_err,
            "launches": {k: v for k, v in launches.items() if v},
            "collectives": [list(c) for c in coll + coll_update],
            "stages": ", ".join(f"{n} {t1 - t0:.1f} s" for (_, t0), (n, t1)
                                in zip(marks, marks[1:]))}


def boundary_bytes(cfg, ctx, saved: list, b: int, s: int, frames: int,
                   where: str) -> dict:
    """What remat kept at the layer boundaries of one sharded train step
    (``models.boundary_saves``: each layer's input as its checkpoint
    saved it, measured with saved_tensors_hooks) against the whole-S
    figure, computed: each stack's layers x B_local x S x d x 4 (f32),
    the decoder's at S and an encoder's at its ``frames``.  Where the
    reference's rule cuts a stack's S over the model axis (m ranks) its
    layers must have kept exactly 1/m of that; elsewhere all of it."""
    m = ctx.size("model")
    b_local = b // ctx.batch_world
    stacks = [(cfg.n_layers, s)] + ([(cfg.enc_layers, frames)]
                                    if cfg.is_encdec else [])
    whole = sum(n * b_local * t * cfg.d_model * 4 for n, t in stacks)
    want = sum(n * b_local * (t // m if ctx.seq_parallel(t) else t)
               * cfg.d_model * 4 for n, t in stacks)
    got = sum(n for _, n in saved)
    if got != want or len(saved) != sum(n for n, _ in stacks):
        raise AssertionError(f"{where}: remat kept {got} B in "
                             f"{len(saved)} layer inputs, expected {want}")
    return {"saved_bytes": got, "whole_bytes": whole, "m": m,
            "saved_shapes": sorted({str(list(sh)) for sh, _ in saved})}


def sharded_seq_case(mesh, name: str, cut: dict, dev, phase: str, b: int,
                     prompt: int, ring: int, new: int, long: bool,
                     rules: shd.ShardingRules = shd.DEFAULT_RULES) -> dict:
    """One config served over a sequence-sharded ring in a gloo rank,
    kernels on, f32: prefill (the mesh's prefill step; with ``long`` one
    device's prefill, cut to the decode step's spec by ``cut_cache``)
    and ``new`` greedy tokens through make_serve_step under ``rules``, every decode,
    log-sum-exp decode and combine call on the rank's shard held to its
    plain version within the f32 band (``kernelwise``).  Rank 0 also
    runs the unsharded model: greedy tokens equal, logits within
    SHARDED_LOGIT_TOL.  Returns the results, the rank's slots and the
    launches of the decode steps, counted from 0 just before them."""
    cfg = sharded_cfg(name, cut)
    ref = dist.get_rank() == 0
    marks = [("start", time.perf_counter())]
    full = models.init(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    attention.rescale_to_true_fan_in(full)
    mctx = parallel.context(mesh, rules)
    where = f"{phase} {cfg.name} on {dict(mctx.sizes)}"
    shape_d = ShapeConfig("long_sharded" if long else "sharded",
                          ring - specs_launch.DECODE_CACHE_PAD, b, "decode")
    dec, dspecs = make_serve_step(cfg, mesh, shape_d, rules)
    params = parallel.shard_tree(full, dspecs["params"], mesh)
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (b, prompt), generator=gen,
                         device=dev)
    # an encoder-decoder's frames, as many as the decode shape's cache
    # holds (its cross K/V's encoder axis)
    enc = specs_launch.enc_len(cfg, shape_d)
    extra = sharded_frontend(cfg, b, 0, enc, gen, dev)
    fkw = {"frames": extra[0]} if extra else {}
    rows = serve_launch.local_rows(torch.arange(b, device=dev), mctx,
                                   dspecs["batch"])
    worst = 0.0
    sync(dev)
    marks.append(("init", time.perf_counter()))
    with torch.no_grad():
        if long:
            whole = models.init_cache(cfg, b, ring, device=dev, enc_len=enc)
            got, whole = models.prefill(full, cfg, toks, whole, **fkw)
            got = got[rows]
            cache = serve_launch.cut_cache(whole, cfg, mesh, shape_d, rules)
            del whole
        else:
            pre, _ = make_prefill_step(cfg, mesh, ShapeConfig(
                "sharded", prompt, b, "prefill"))
            cache = serve_launch.init_cache(cfg, mesh, shape_d)
            with kernelwise(combine=True) as kw:
                got, cache = pre(params, toks, cache, *extra)
            worst = kw.max_err()
        kv = cache["segments"][0]["e0"]["kv"]
        slots = (kv.k.shape[-3], kv.kpos.shape[-1])
        cross = cache["segments"][0]["e0"].get("cross")
        sync(dev)
        marks.append(("prefill", time.perf_counter()))
        got_t, logits = [], []
        nxt = torch.zeros((b, 1), dtype=torch.long, device=dev)
        for fn in (*KERNELS.values(), attention_combine):  # the main path's
            fn.launches = 0
        calls = {}
        for i in range(new):
            got_t.append(got.argmax(-1))
            logits.append(got)
            if i == new - 1:
                break
            nxt[rows] = got_t[-1][:, None]
            with kernelwise(combine=True) as kw:
                got, cache = dec(params, nxt, cache)
            worst = max(worst, kw.max_err())
            calls = {k: calls.get(k, 0) + v for k, v in kw.calls.items()}
        used = {**launch_counts(), "attention_combine":
                attention_combine.launches}
        sync(dev)
        marks.append(("decode, held", time.perf_counter()))
        del params, cache
        if not worst <= TOL[torch.float32]:
            raise AssertionError(f"{where}: a kernel call on the rank's "
                                 f"shard differs from its plain version "
                                 f"by {worst}")
        layers = f"{cfg.n_layers} layers" + (
            f" + {cfg.enc_layers} encoder layer(s)" if cfg.is_encdec else "")
        out = {"config": f"{cfg.name} width, {layers}, "
                         f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV "
                         f"head(s)" + ("" if rules == shd.DEFAULT_RULES
                                       else ", weights whole on each rank"),
               "slots": list(slots), "kernel_err": worst, "calls": calls,
               "launches": {k: v for k, v in used.items() if v},
               "tokens": torch.stack(got_t, 1).tolist()}
        if cross is not None:
            out["cross"] = [cross.k.shape[-3], enc]
        if ref:
            ref_cache = models.init_cache(cfg, b, ring, device=dev,
                                          enc_len=enc)
            want, ref_cache = models.prefill(full, cfg, toks, ref_cache,
                                             **fkw)
            diffs, same = [], True
            for i, (g, t) in enumerate(zip(logits, got_t)):
                if i:
                    want, ref_cache = models.decode_step(
                        full, cfg, want.argmax(-1)[:, None], ref_cache)
                diffs.append((g - want[rows]).abs().max().item())
                same &= torch.equal(t, want[rows].argmax(-1))
            if not same:
                raise AssertionError(f"{where}: greedy tokens differ from "
                                     f"the unsharded run's")
            if max(diffs) > SHARDED_LOGIT_TOL:
                raise AssertionError(f"{where}: logits differ by "
                                     f"{max(diffs)}")
            out["logits"] = max(diffs)
            del ref_cache
            sync(dev)
            marks.append(("unsharded run", time.perf_counter()))
    free(full)
    out["stages"] = ", ".join(f"{name} {b - a:.1f} s" for (_, a), (name, b)
                              in zip(marks, marks[1:]))
    return out


def sharded_ckpt_case(tp, kept: dict, dev, phase: str, sizes: dict,
                      out_dir: str) -> dict:
    """(h) in a gloo rank: checkpoints of a sharded train state.  (c)'s
    state after its step (``kept``: agent-7b's width at 2 layers, f32,
    int8 moments, DP + FSDP on (2, 1)) is saved, async, by its step's
    held specs (``step.shardings["state"]``): the ranks gather it leaf by
    leaf and rank 0 writes it under ``out_dir/ckpt``.  It is restored
    with no shardings (a world of one): every leaf bit-equal to (c)'s
    state gathered; onto the (1, 2) mesh ``tp`` by the TP step's held
    specs: every leaf of every rank bit-equal to the whole restore cut
    by them; onto (2, 1) again: bit-equal to (c)'s shards.  One TP train
    step from the restored state, kernels on: its loss within 1e-4 and
    its gradient shards within phase 29's band of the single-device
    step's from the whole restore, every kernel call held to its plain
    version.  Then ``TrainSupervisor`` over the TP step
    (``sizes["sup"]``: config, cut, B, S, steps, checkpoint interval,
    failure), async checkpoints by its held specs, a ``SimulatedFailure``
    raised on both ranks right after a checkpoint, under deterministic
    algorithms: one restart, and the losses by step and every final
    shard bit-equal to an uninterrupted supervised run's.  Returns the
    results, the checkpoint's bytes, the stage times and the TP step's
    launches."""
    cfg, step_c, state_c = kept["cfg"], kept["step"], kept["state"]
    acfg, batch = kept["acfg"], kept["batch"]
    where = f"{phase} {cfg.name}"
    ckpt = Path(out_dir) / "ckpt"
    ctx_c = step_c.ctx
    held_c = prm.flatten(step_c.shardings["state"], is_leaf=shd.is_spec)[0]
    c_leaves = prm.flatten(state_c)[0]
    out = {"config": f"{cfg.name} width, {cfg.n_layers} layer(s), f32, "
           f"int8 moments"}
    times = {}

    def mark(name: str, t0: float) -> float:
        sync(dev)
        now = time.perf_counter()
        times[name] = now - t0
        return now

    t = time.perf_counter()
    mgr = CheckpointManager(ckpt, shardings=(step_c.shardings["state"],
                                             ctx_c))
    mgr.save(1, state_c, meta={"data_step": 1}, blocking=False)
    t = mark("gather", t)
    mgr.wait()
    t = mark("write", t)
    out["bytes"] = (ckpt / "step_1" / "arrays.npz").stat().st_size
    out["leaves"] = len(c_leaves)
    # a world of one: the whole tree, like meta tensors of its shapes
    whole_like = abstract_state(cfg, acfg)
    whole, _ = CheckpointManager(ckpt).restore(1, whole_like, device=dev)
    t = mark("restore whole", t)
    w_leaves = prm.flatten(whole)[0]
    bad = [i for i, (c, spec, w) in enumerate(zip(c_leaves, held_c,
                                                  w_leaves))
           if not torch.equal(parallel.gather_leaf(c, spec, ctx_c), w)]
    if bad:
        raise AssertionError(f"{where}: the whole restore's leaves {bad} "
                             f"differ from (c)'s state gathered")
    t = mark("compare whole", t)
    plan = TrainPlan(int8_moments=True)
    b, s = sizes["train_b"], sizes["train_seq"]
    step_t = make_train_step(cfg, tp, plan, acfg,
                             shape=ShapeConfig("sharded", s, b, "train"))
    ctx_t = step_t.ctx
    held_t = step_t.shardings["state"]
    tp_state, _ = CheckpointManager(ckpt).restore(
        1, parallel.shard_tree(whole_like, held_t, ctx_t),
        shardings=(held_t, ctx_t))
    t = mark("restore onto (1, 2)", t)
    bad = [i for i, (w, spec, g) in enumerate(zip(
        w_leaves, prm.flatten(held_t, is_leaf=shd.is_spec)[0],
        prm.flatten(tp_state)[0]))
        if not torch.equal(parallel.shard_leaf(w, spec, ctx_t), g)]
    if bad:
        raise AssertionError(f"{where}: the (1, 2) restore's leaves {bad} "
                             f"differ from the whole restore cut by the TP "
                             f"step's held specs")
    dp_state, _ = mgr.restore(1, state_c)
    t = mark("restore onto (2, 1)", t)
    bad = [i for i, (g, c) in enumerate(zip(prm.flatten(dp_state)[0],
                                            c_leaves))
           if not torch.equal(g, c)]
    if bad:
        raise AssertionError(f"{where}: the (2, 1) restore's leaves {bad} "
                             f"differ from (c)'s shards")
    del dp_state
    # one TP step from the restored state against one device's
    start = all_counts()
    with hold_sharded_calls(where) as held:
        metrics, grads = step_t.grads(tp_state[0], batch, with_metrics=True)
    out["kernel_err"] = held.check()
    del held
    out["launches"] = {k: v - start[k] for k, v in all_counts().items()
                       if v - start[k]}
    params_t, opt_t, m = step_t.update(*tp_state, grads, metrics)
    t = mark("TP step", t)
    if not all(torch.isfinite(x).all() for x in prm.flatten(params_t)[0]):
        raise AssertionError(f"{where}: non-finite parameters after the "
                             f"step from the restored state")
    del tp_state, params_t, opt_t
    ref_loss, ref_g = grads_and_loss(cfg, whole[0], batch)
    mine = prm.flatten(parallel.shard_tree(prm.unflatten(
        prm.flatten(whole[0])[1], list(ref_g)), step_t.shardings["params"],
        ctx_t))[0]
    errs = [((g.float() - r.float()).abs().max()
             / w.float().abs().max().clamp_min(1e-30)).item()
            for g, r, w in zip(prm.flatten(grads)[0], mine, ref_g)]
    loss_err = abs(m["loss"].item() - ref_loss.item())
    if loss_err > 1e-4 or max(errs) > TRAIN_F32_GRAD_TOL:
        raise AssertionError(f"{where}: the step from the restored state: "
                             f"loss off by {loss_err}, gradient shards by up "
                             f"to {max(errs)}")
    out.update(loss=m["loss"].item(), loss_err=loss_err, grad_err=max(errs),
               grad_leaves=len(errs))
    del whole, grads, ref_g, mine, m, metrics
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = mark("unsharded step", t)
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(ckpt, ignore_errors=True)
    out.update(sharded_supervised(tp, dev, where, sizes["sup"], out_dir))
    t = mark("supervised runs", t)
    out["times"] = times
    return out


def sharded_supervised(tp, dev, where: str, sup: tuple, out_dir: str
                       ) -> dict:
    """(h)'s supervised runs: ``TrainSupervisor`` over the TP train step
    of ``sup`` (name, cut, B, S, steps, checkpoint interval, the step a
    failure is raised at on every rank), each from seed 0's weights,
    bf16, kernels on, int8 moments, async checkpoints (keep 1) by the
    step's held specs, under deterministic algorithms (the embedding's
    backward adds with atomics otherwise): once with the failure, and
    once uninterrupted with one checkpoint, at its end (checkpoints do
    not touch the trajectory; the failing run's are what is held).
    Raises unless the failing run restarts once and its losses by step
    and every final shard equal the uninterrupted run's."""
    name, cut, b, s, steps, every, fail = sup
    cfg = (get_smoke(name[len("smoke:"):]) if name.startswith("smoke:")
           else get_config(name)).replace(use_pallas=True, **cut)
    acfg = AdamWConfig(lr=1e-3, warmup_steps=0, int8_moments=True)

    def run(sub: str, fail_at: tuple, every: int):
        step_fn = make_train_step(cfg, tp, TrainPlan(int8_moments=True),
                                  acfg, shape=ShapeConfig("sup", s, b,
                                                          "train"))
        full = models.init(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
        attention.rescale_to_true_fan_in(full)
        params = parallel.shard_tree(full, step_fn.shardings["params"],
                                     step_fn.ctx)
        free(full)
        pending, losses = set(fail_at), {}

        def one(state, batch, i):
            if i in pending:
                pending.discard(i)
                raise SimulatedFailure(f"chaos at step {i}")
            p, o, m = step_fn(*state, batch)
            losses[i] = m["loss"].item()
            return (p, o)

        d = Path(out_dir) / sub
        sup_ = TrainSupervisor(
            CheckpointManager(d, keep=1, shardings=(
                step_fn.shardings["state"], step_fn.ctx)),
            SupervisorConfig(ckpt_every=every, async_ckpt=True))
        pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=s,
                                        global_batch=b, seed=38))
        t0 = time.perf_counter()
        state = sup_.run(state=(params, init_opt_state(
            params, acfg, step_fn.ctx, cfg=cfg)), pipeline=pipe,
            step_fn=one, total_steps=steps)
        sync(dev)
        seconds = time.perf_counter() - t0
        pipe.close()
        dist.barrier()
        if dist.get_rank() == 0:
            shutil.rmtree(d, ignore_errors=True)
        return state, losses, sup_, seconds

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ref, ref_losses, _, ref_s = run("sup-ref", (), steps)
        got, losses, sup_, got_s = run("sup-crashy", (fail,), every)
    finally:
        torch.use_deterministic_algorithms(False)
    same = all(torch.equal(x, y) for x, y in zip(prm.flatten(got)[0],
                                                 prm.flatten(ref)[0]))
    if sup_.restarts != 1 or losses != ref_losses or len(losses) != steps \
            or not same:
        raise AssertionError(f"{where} supervised: restarts {sup_.restarts}, "
                             f"losses equal {losses == ref_losses} "
                             f"({len(losses)} steps), final shards equal "
                             f"{same}; {sup_.log}")
    return {"sup_config": f"{cfg.name} width, {cfg.n_layers} layer(s), "
            f"bf16, int8 moments, B {b} x S {s}, {steps} steps, "
            f"checkpoints every {every} (async; the uninterrupted run's "
            f"only at its end)",
            "sup_log": sup_.log, "sup_losses": [losses[i]
                                                for i in range(steps)],
            "sup_seconds": [ref_s, got_s],
            "sup_leaves": len(prm.flatten(got)[0])}


def sharded_rank(rank: int, world: int, store: str, out_dir: str,
                 device_type: str, sizes: dict) -> None:
    """A gloo rank of phase 38 (b) to (g), spawned by the phase (which
    passes the configs and sizes in ``sizes``): on the card both ranks
    share CUDA device 0."""
    if rank:
        sys.stdout = open(os.devnull, "w")
    if device_type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device_type, 0) if device_type == "cuda" \
        else torch.device("cpu")
    dist.init_process_group("gloo", init_method=store, world_size=world,
                            rank=rank)
    res: dict = {}
    try:
        t0 = time.perf_counter()
        tp = make_mesh((1, world), ("data", "model"), device_type)
        res["tp"] = sharded_case(tp, *sizes["tp"], dev, "sharded (b) TP",
                                 sizes)
        res["ep"] = sharded_case(tp, *sizes["ep"], dev, "sharded (b) EP",
                                 sizes)
        res["gqa"] = sharded_seq_case(
            tp, *sizes["gqa"], dev, "sharded (d) GQA fallback",
            sizes["gqa_b"], sizes["gqa_prompt"],
            sizes["gqa_prompt"] + specs_launch.DECODE_CACHE_PAD,
            sizes["new"], long=False)
        dp = make_mesh((world, 1), ("data", "model"), device_type)
        kept: dict = {}
        res["dp"] = sharded_case(dp, *sizes["tp"], dev, "sharded (c) DP",
                                 sizes, serve=False, keep=kept)
        for key in ("tp", "ep"):
            res[f"uneven-{key}"] = sharded_uneven_case(
                dp, *sizes[key], dev, "sharded (c') DP, a rank with no row",
                sizes)
        res["ckpt"] = sharded_ckpt_case(tp, kept, dev,
                                        "sharded (h) checkpoints", sizes,
                                        out_dir)
        kept.clear()
        res["long"] = sharded_seq_case(
            dp, *sizes["long"], dev, "sharded (e) long", 1,
            sizes["long_prompt"], sizes["long_ring"], sizes["new"],
            long=True, rules=SHARDED_LONG_RULES)
        res["families"] = [sharded_case(tp, name, cut, dev,
                                        "sharded (f) TP", sizes)
                           for name, cut in sizes["families"]]
        res["cross"] = sharded_seq_case(
            dp, *sizes["cross"], dev, "sharded (g) long cross", 1,
            sizes["long_prompt"], sizes["long_ring"], sizes["new"],
            long=True, rules=SHARDED_LONG_RULES)
        res["seconds"] = time.perf_counter() - t0
    except Exception:
        import traceback
        res["error"] = traceback.format_exc()[-4000:]
    finally:
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))
        dist.destroy_process_group()


def phase_sharded(dev) -> dict:
    """[sharded]: (b) two gloo ranks sharing the card on mesh (1, 2):
    agent-7b's width at 2 layers (TP) and arctic's at 1 layer (EP); (c)
    the same ranks on (2, 1) (DP + FSDP), agent-7b's width at 2 layers,
    train only (``sharded_world2``, ``sharded_case``); (d) and (e) the
    same ranks serving over a sequence-sharded ring, the GQA fallback on
    (1, 2) and a ``long`` shape on (2, 1) (``sharded_seq_case``); (f) the
    same ranks on (1, 2), TP of hymba, xlstm, qwen2-vl and seamless at
    full width (``sharded_case``), (b) and (f) sequence parallel; (g) the
    same ranks serving seamless under a ``long`` shape on (2, 1), its
    cross K/V cut along the encoder axis (``sharded_seq_case``); then (a)
    world-1 NCCL steps bit-equal to mesh-less at agent-7b's full depth
    (``sharded_world1``), whose 50 GB would not leave the ranks room.  Times
    of (b) to (f) are two processes sharing one H100 over gloo, not a
    multi-GPU figure.  Returns (d)'s and (e)'s decode launches."""
    seq = sharded_world2(dev)
    sharded_world1(dev)
    return seq


# (b), (c) and (c'): the cases whose train steps the dry run's fake
# passes hold, (key, mesh, label, the config's key in ``sizes``, plan)
FAKE_CASES = [
    ("tp", (1, 2), "(b) TP", "tp", TrainPlan(int8_moments=True)),
    ("ep", (1, 2), "(b) EP", "ep", TrainPlan(int8_moments=True)),
    ("dp", (2, 1), "(c) DP + FSDP", "tp", TrainPlan(int8_moments=True)),
    ("uneven-tp", (2, 1), "(c') agent-7b's width, rank 1 empty", "tp",
     TrainPlan(microbatch=SHARDED_UNEVEN_MICRO)),
    ("uneven-ep", (2, 1), "(c') arctic's width, rank 1 empty", "ep",
     TrainPlan(microbatch=SHARDED_UNEVEN_MICRO))]


def fake_collectives(sizes: dict) -> dict:
    """The collectives of the dry run's fake pass (``launch.dryrun.
    rank_pass``: meta tensors, one rank of a fake world of the mesh's
    two) of each FAKE_CASES train step as each rank, {(key, rank): [(kind,
    bytes, group size)]}, and the passes' seconds.  Run on this host while
    the gloo ranks run, so the phase waits no longer."""
    t0 = time.perf_counter()
    b, s = sizes["train_b"], sizes["train_seq"]
    out = {}
    for key, mesh, _, model, plan in FAKE_CASES:
        cfg = sharded_cfg(*sizes[model])
        for r in range(2):
            fake = dryrun.rank_pass(
                cfg, ShapeConfig("sharded", s, b, "train"),
                dict(zip(("data", "model"), mesh)), r, plan, memory=False,
                costs=False)
            out[key, r] = [list(c) for c in fake["calls"]]
    out["seconds"] = time.perf_counter() - t0
    return out


def hold_fake_collectives(phase: str, res: list, fake: dict) -> None:
    """(b) and (c): the collectives each rank made over its train step
    (``parallel.record_collectives`` around the gradients and the AdamW
    half: kind, result bytes and group size, in order) equal those of the
    dry run's fake pass of the same step as that rank
    (``fake_collectives``)."""
    for key, mesh, what, _, _ in FAKE_CASES:
        for r, got in enumerate(res):
            want = fake[key, r]
            if got[key]["collectives"] != want:
                raise AssertionError(
                    f"{phase} {what}: rank {r}'s train step made the "
                    f"collectives {got[key]['collectives']}, the dry run's "
                    f"fake pass of it {want}")
            kinds = dryrun.collective_bytes(want)
            log(phase, f"{what}, rank {r}: the train step's {len(want)} "
                f"collectives equal the dry run's fake pass of the step as "
                f"rank {r} of a fake world on {mesh}, call by call (kind, "
                f"bytes, group size): " + ", ".join(
                    f"{k} {v} B" for k, v in kinds.items()
                    if v and k not in ("count", "total")))
    log(phase, f"the fake passes took {fake['seconds']:.1f} s on the host, "
        f"while the ranks ran")


def sharded_world2(dev) -> dict:
    """(b) to (g): two gloo ranks spawned on the card (``sharded_rank``),
    their results printed and held.  Returns the launches of (d)'s, (e)'s
    and (g)'s decode steps, summed over the ranks: the main path of
    ``attention_combine`` and of ring decode with its log-sum-exp."""
    phase = "sharded"
    import torch.multiprocessing as mp

    # the ranks share the card with this process: return its cache first
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        log(phase, f"this process holds {torch.cuda.memory_reserved() / 1e9:.2f}"
            f" GB of the card before the ranks start")
    out_dir = SHARDED_DIR / "ranks"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    sizes = {"tp": SHARDED_TP, "ep": SHARDED_EP, "serve_b": SHARDED_SERVE_B,
             "prompt": SHARDED_SERVE_PROMPT, "new": SHARDED_NEW,
             "train_b": SHARDED_TRAIN_B, "train_seq": SHARDED_TRAIN_SEQ,
             "gqa": SHARDED_GQA, "gqa_b": SHARDED_GQA_B,
             "gqa_prompt": SHARDED_GQA_PROMPT, "long": SHARDED_LONG,
             "long_ring": SHARDED_LONG_RING,
             "long_prompt": SHARDED_LONG_PROMPT,
             "families": SHARDED_FAMILIES, "frames": SHARDED_FRAMES,
             "patches": SHARDED_PATCHES, "grid": VISION_GRID,
             "cross": SHARDED_CROSS, "sup": SHARDED_SUP}
    ranks = mp.start_processes(sharded_rank, args=(
        2, sharded_store("world2"), str(out_dir), dev.type, sizes),
        nprocs=2, start_method="spawn", join=False)
    try:
        fake = fake_collectives(sizes)
    finally:
        while not ranks.join():
            pass
    wall = time.perf_counter() - t0
    res = [json.loads((out_dir / f"rank{r}.json").read_text())
           for r in range(2)]
    failed = [f"rank {r} failed:\n{got['error']}"
              for r, got in enumerate(res) if "error" in got]
    if failed:
        # every rank's: the first to fail ends the others' collectives
        raise AssertionError(f"{phase}: " + "\n".join(failed))
    label = ("two processes sharing one " + card() + " over gloo"
             if dev.type == "cuda" else "two CPU processes over gloo")
    cases = [(("tp",), "(b) mesh (1, 2), TP", None),
             (("ep",), "(b) mesh (1, 2), EP", None),
             (("dp",), "(c) mesh (2, 1), DP + FSDP", None)]
    cases += [(("families", i), "(f) mesh (1, 2), TP of " + arch,
               SHARDED_FAMILY_KERNELS[arch])
              for i, arch in enumerate(name.removeprefix("smoke:")
                                       for name, _ in SHARDED_FAMILIES)]
    for key, what, kernels in cases:
        def pick(got):
            return got[key[0]] if len(key) == 1 else got[key[0]][key[1]]
        c0 = pick(res[0])
        for r, got in enumerate(res):
            c = pick(got)
            if c.get("tokens") != c0.get("tokens") \
                    or c["loss"] != c0["loss"] \
                    or c["launches"] != c0["launches"]:
                raise AssertionError(f"{phase} {what}: rank {r}'s tokens, "
                                     f"loss or launches differ from rank "
                                     f"0's")
            n_tok = sum(map(len, c.get("tokens", [])))
            served = (f"prefill + {sizes['new']} greedy tokens ({n_tok}) "
                      f"equal rank 0's; " if r and n_tok else "")
            if not r and n_tok:
                served = (f"prefill + {sizes['new']} greedy tokens equal the "
                          f"unsharded run's ({n_tok} tokens), logits within "
                          f"{c['logits']:.3e}; ")
            held = (f"train step loss {c['loss']:.6f} (|diff| "
                    f"{c['loss_err']:.2e}), its {c['leaves']} gradient "
                    f"shards within {c['grad_err']:.3e} of their leaf's "
                    f"largest magnitude")
            # sequence parallelism over the model axis: every stack's S
            # divides it here, so remat keeps 1/m of the whole-S figure
            if c["saved_bytes"] * c["m"] != c["whole_bytes"]:
                raise AssertionError(f"{phase} {what}: rank {r} kept "
                                     f"{c['saved_bytes']} B at the layer "
                                     f"boundaries, not 1/{c['m']} of "
                                     f"{c['whole_bytes']}")
            peak = ("not measured" if c["peak_gb"] is None
                    else f"{c['peak_gb']:.3f} GB")
            held += (f"; remat kept {c['saved_bytes']} B "
                     f"({c['saved_bytes'] / 1e6:.3f} MB) at the layer "
                     f"boundaries (inputs {', '.join(c['saved_shapes'])}), "
                     f"1/{c['m']} of the whole-S figure {c['whole_bytes']} B "
                     f"(computed: layers x B_local x S x d x 4); "
                     f"max_memory_allocated over the train step {peak}")
            log(phase, f"{what}, rank {r}: {c['config']}, f32, kernels on: "
                f"{served}{held}; every kernel call on the rank's shards "
                f"within {c['kernel_err']:.3e} of its plain version; "
                f"launches on the sharded path {c['launches']}; "
                f"{c['stages']}")
            if dev.type == "cuda":
                want = kernels or {"flash_attention",
                                   "flash_attention_backward"} | (
                    {"decode_attention"} if "tokens" in c else set()) | (
                    {"grouped_matmul", "grouped_matmul_backward"}
                    if key == ("ep",) else set())
                if not want <= set(c["launches"]):
                    raise AssertionError(f"{phase} {what}: rank {r} "
                                         f"launched {c['launches']}, "
                                         f"expected each of {sorted(want)}")
    for key, what in (("uneven-tp", "(c') mesh (2, 1), DP + FSDP, B 2 in 2 "
                                    "microbatches of one row"),
                      ("uneven-ep", "(c') mesh (2, 1), DP + FSDP, B 2 in 2 "
                                    "microbatches of one row, the MoE's "
                                    "global dispatch")):
        c0 = res[0][key]
        kinds = [(k, n) for k, _, n in c0["collectives"]]
        for r, got in enumerate(res):
            c = got[key]
            if c["loss"] != c0["loss"] or c["rows"] != (0 if r else 1):
                raise AssertionError(f"{phase} {what}: rank {r} holds "
                                     f"{c['rows']} rows, loss {c['loss']} "
                                     f"against rank 0's {c0['loss']}")
            if [(k, n) for k, _, n in c["collectives"]] != kinds:
                raise AssertionError(f"{phase} {what}: rank {r}'s "
                                     f"collectives differ from rank 0's")
            if dev.type == "cuda":
                want = {"flash_attention", "flash_attention_backward"} | (
                    {"grouped_matmul", "grouped_matmul_backward"}
                    if key == "uneven-ep" else set())
                if (r and c["launches"]) or (
                        not r and not want <= set(c["launches"])):
                    raise AssertionError(
                        f"{phase} {what}: rank {r} launched "
                        f"{c['launches']}; rank 0 must launch each of "
                        f"{sorted(want)}, rank 1 (no row) nothing")
            log(phase, f"{what}, rank {r}: {c['config']}, f32, kernels on, "
                f"{c['rows']} row(s) of each microbatch: train step loss "
                f"{c['loss']:.6f} (|diff| {c['loss_err']:.2e} against the "
                f"mesh-less step with the same plan), its {c['leaves']} "
                f"gradient shards within {c['grad_err']:.3e} of their "
                f"leaf's largest magnitude; every kernel call within "
                f"{c['kernel_err']:.3e} of its plain version; launches "
                f"{c['launches'] or 'none'}; its {len(c['collectives'])} "
                f"collectives equal rank 0's in kind and group size, in "
                f"order; {c['stages']}")
    hold_fake_collectives(phase, res, fake)
    seq = {}
    for key, what in (("gqa", "(d) mesh (1, 2), GQA fallback: the ring cut "
                              "over model"),
                      ("long", "(e) mesh (2, 1), long: the ring cut over "
                               "data"),
                      ("cross", "(g) mesh (2, 1), long: the ring and the "
                                "cross K/V cut over data")):
        c0 = res[0][key]
        for r, got in enumerate(res):
            c = got[key]
            if c["tokens"] != c0["tokens"]:
                raise AssertionError(f"{phase} {what}: rank {r}'s tokens "
                                     f"differ from rank 0's")
            local, total = c["slots"]
            if local * 2 != total:
                raise AssertionError(f"{phase} {what}: rank {r} holds "
                                     f"{local} of {total} slots")
            n_tok = sum(map(len, c["tokens"]))
            served = (f"greedy tokens equal the unsharded run's ({n_tok} "
                      f"tokens), logits within {c['logits']:.3e}"
                      if not r else f"greedy tokens equal rank 0's")
            if "cross" in c:
                if c["cross"][0] * 2 != c["cross"][1]:
                    raise AssertionError(f"{phase} {what}: rank {r} holds "
                                         f"{c['cross'][0]} of "
                                         f"{c['cross'][1]} frames")
                served += (f"; the cross K/V {c['cross'][0]} of the "
                           f"{c['cross'][1]} encoder positions")
            log(phase, f"{what}, rank {r}: {c['config']}, f32, kernels on, "
                f"{local} of the ring's {total} slots: prefill + "
                f"{sizes['new']} greedy tokens, {served}; every decode "
                f"(with its log-sum-exp) and combine call on the rank's "
                f"shard {c['calls']} within {c['kernel_err']:.3e} of its "
                f"plain version; launches of the decode steps "
                f"{c['launches']}; {c['stages']}")
            if dev.type == "cuda":
                want = {"decode_attention", "attention_combine"}
                if not want <= set(c["launches"]):
                    raise AssertionError(f"{phase} {what}: rank {r} "
                                         f"launched {c['launches']}, "
                                         f"expected each of {sorted(want)}")
            for k, v in c["launches"].items():
                seq[k] = seq.get(k, 0) + v
    c0 = res[0]["ckpt"]
    for r, got in enumerate(res):
        c = got["ckpt"]
        if c["loss"] != c0["loss"] or c["sup_losses"] != c0["sup_losses"]:
            raise AssertionError(f"{phase} (h): rank {r}'s losses differ "
                                 f"from rank 0's")
        tm = c["times"]
        gb = c["bytes"] / 1e9
        wrote = (f"written by this rank in {tm['write']:.2f} s "
                 f"({gb / tm['write']:.3f} GB/s, page cache, {card()})"
                 if not r else f"rank 0's write awaited {tm['write']:.2f} s")
        log(phase, f"(h) checkpoints, rank {r}: (c)'s state ({c['config']}, "
            f"{c['leaves']} leaves), saved async by the held specs: "
            f"{c['bytes']} B ({gb:.3f} GB), gathered leaf by leaf in "
            f"{tm['gather']:.2f} s, {wrote}; restored with no shardings in "
            f"{tm['restore whole']:.2f} s, every leaf bit-equal to (c)'s "
            f"state gathered ({tm['compare whole']:.2f} s); onto (1, 2) in "
            f"{tm['restore onto (1, 2)']:.2f} s, bit-equal to the whole "
            f"restore cut by the TP step's held specs; onto (2, 1) in "
            f"{tm['restore onto (2, 1)']:.2f} s, bit-equal to (c)'s shards; "
            f"a TP step from the restored state ({tm['TP step']:.2f} s): "
            f"loss {c['loss']:.6f} (|diff| {c['loss_err']:.2e}), its "
            f"{c['grad_leaves']} gradient shards within {c['grad_err']:.3e} "
            f"of their leaf's largest magnitude in the single-device step "
            f"from the whole restore ({tm['unsharded step']:.2f} s), every "
            f"kernel call within {c['kernel_err']:.3e} of its plain "
            f"version, launches {c['launches']}")
        log(phase, f"(h) supervised, rank {r}: TrainSupervisor over the TP "
            f"step, {c['sup_config']}: uninterrupted "
            f"{c['sup_seconds'][0]:.2f} s, with a failure "
            f"{c['sup_seconds'][1]:.2f} s ({'; '.join(c['sup_log'])}): the "
            f"losses by step {[round(x, 6) for x in c['sup_losses']]} and "
            f"all {c['sup_leaves']} final shards bit-equal to the "
            f"uninterrupted run's (deterministic algorithms); both runs "
            f"{tm['supervised runs']:.2f} s")
    log(phase, f"(b) to (g): {wall:.1f} s of wall time for the spawn, "
        f"{max(r['seconds'] for r in res):.1f} s in the ranks ({label}; "
        f"not a multi-GPU figure)")
    return seq



def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA GPU")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = card()
    print(gpu, flush=True)
    log("device", f"{torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    t_all = time.perf_counter()

    with timed_phase("2 build"):
        t0 = time.perf_counter()
        logs = build.build_all()
        log("build", f"{sorted(logs)} built in "
            f"{time.perf_counter() - t0:.1f} s")
        for name, text in logs.items():
            entries = ptxas_entries(text)
            regs = [e[1] for e in entries]
            spills = [e[2] for e in entries]
            log("build", f"{name}: {len(regs)} instantiations, "
                f"{min(regs, default=0)}-{max(regs, default=0)} registers; "
                f"{sum(n > 0 for n in spills)} spill, at most "
                f"{max(spills, default=0)} bytes")
            # each instantiation of the redesigned kernels on its own line
            for fn, n_regs, spill in entries:
                if any(k in fn for k in NEW_KERNELS):
                    log("build", f"  {fn}: {n_regs} registers, {spill} "
                        f"bytes spill stores")

    with timed_phase("3, 28 kernels"):
        rows = [*phase_kernels(dev), *phase_flash(dev),
                *phase_paged_flash(dev),
                *phase_flash_backward(dev), *phase_ring_decode(dev),
                *phase_ssm_scan(dev), phase_grouped_matmul(dev),
                phase_combine(dev)]
    with timed_phase("33 kernels backward"):
        rows += phase_backward_kernels(dev)

    small = get_config("agent-7b").replace(n_layers=2, dtype="float32")
    params = models.init(small, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    with timed_phase("4 parity"):
        phase_parity(dev, small, params)
    with timed_phase("5 migrate"):
        phase_migrate(dev, small, params)
    with timed_phase("14 mixed parity"):
        phase_mixed_parity(dev, small, params)
    with timed_phase("17 control parity"):
        phase_control_parity(dev, small, params)
    free(params)

    cfg = get_config("agent-7b").replace(use_pallas=True)
    params = init_full(cfg, dev, "serve")
    with timed_phase("6 serve"):
        phase_serve(dev, cfg, params, "paged", "serve")
    with timed_phase("7 serve ring"):
        phase_serve(dev, cfg, params, "ring", "serve ring",
                    prefill_profile=True)
    with timed_phase("15 serve mixed"):
        phase_serve_mixed(dev, cfg, params, "serve mixed")
    with timed_phase("18 serve control"):
        control = phase_serve_control(dev, cfg, params)
    # the agent planes: the cost model fitted to agent-7b's steps, the
    # disaggregated pool over two live engines, then the fit of agent-1b
    # (the workflow's small tier) and the sim fleet priced by both fits
    with timed_phase("25 calibrate agent-7b"):
        phase_calibrate(dev, cfg, params, CALIB_DIR)
    with timed_phase("26 serve disagg"):
        phase_serve_disagg(dev, cfg, params)
    free(params)
    with timed_phase("25 calibrate agent-1b"):
        cfg = get_config(SIM_MODELS[1]).replace(use_pallas=True)
        params = init_full(cfg, dev, "calibrate")
        phase_calibrate(dev, cfg, params, CALIB_DIR)
        free(params)
    with timed_phase("27 sim on the card's fit"):
        phase_sim(CALIB_DIR, gpu)

    # hymba-1.5b width at 3 layers (global, SWA, global); PARITY_SWA's
    # window gives its middle layer a ring the longer prompts wrap
    with timed_phase("8 hymba"):
        small = get_config("hymba-1.5b").replace(
            n_layers=3, global_layers=(0, 2), dtype="float32")
        params = models.init(small, torch.Generator(
            device=dev).manual_seed(0), device=dev)
        phase_parity(dev, small, params, [("ring", True), ("ring", False)],
                     "hymba-1.5b width, 3 layers")
        phase_hymba_migrate(dev, small.replace(window=PARITY_SWA[0],
                                               attn_chunk=PARITY_SWA[1]),
                            params)
        free(params)

    with timed_phase("9 serve hymba"):
        cfg = get_config("hymba-1.5b").replace(use_pallas=True)
        params = init_full(cfg, dev, "serve hymba")
        hymba = phase_serve(dev, cfg, params, "ring", "serve hymba",
                            prefill_profile=True)
        free(params)

    # arctic-480b width at 1 layer in f32 (56.3 GB of weights): greedy
    # tokens equal across layouts and kernel paths
    with timed_phase("10 parity arctic"):
        small = get_config("arctic-480b").replace(n_layers=1,
                                                  dtype="float32")
        params = init_full(small, dev, "parity arctic")
        phase_parity(dev, small, params, label="arctic-480b width, 1 layer")
        free(params)

    # arctic-480b at 2 of its 35 layers, bf16 (55.4 GB): paged, ring, and
    # paged with the kernels off (every expert product a bmm over all 128
    # experts) for the step it costs
    cfg = get_config("arctic-480b").replace(n_layers=2, use_pallas=True)
    params = init_full(cfg, dev, "serve arctic")
    with timed_phase("11 serve arctic"):
        phase_serve(dev, cfg, params, "paged", "serve arctic")
        phase_serve(dev, cfg, params, "ring", "serve arctic ring")
        phase_serve(dev, cfg.replace(use_pallas=False), params, "paged",
                    "serve arctic off", max_new=16)
    with timed_phase("16 serve mixed arctic"):
        arctic = phase_serve_mixed(dev, cfg, params, "serve mixed arctic")
    free(params)

    # kimi-k2-1t-a32b width at 1 layer in f32 (its dense first layer,
    # 10.8 GB): greedy tokens equal across layouts and kernel paths at
    # head dim 112 and G = 8
    with timed_phase("12 parity kimi"):
        small = get_config("kimi-k2-1t-a32b").replace(n_layers=1,
                                                      dtype="float32")
        params = init_full(small, dev, "parity kimi")
        phase_parity(dev, small, params, label="kimi-k2 width, 1 layer")
        free(params)

    # kimi-k2 at 2 of its 61 layers, bf16: the dense layer and one MoE
    # layer of 384 experts, paged then ring
    with timed_phase("13 serve kimi"):
        cfg = get_config("kimi-k2-1t-a32b").replace(n_layers=2,
                                                    use_pallas=True)
        params = init_full(cfg, dev, "serve kimi")
        phase_serve(dev, cfg, params, "paged", "serve kimi")
        phase_serve(dev, cfg, params, "ring", "serve kimi ring")
        free(params)

    # every architecture of the repo
    with timed_phase("19 new paths"):
        phase_new_paths(dev)
    with timed_phase("20 parity at each width"):
        for name, cut, windows, layouts, *label in WIDTH_PARITY:
            small = get_config(name).replace(dtype="float32", **cut)
            params = init_full(small, dev, "parity")
            phase_parity(dev, small, params, layouts,
                         f"{label[0] if label else name} width, "
                         f"{small.n_layers} layer(s)", windows, eager=True)
            free(params)

    # xlstm-350m at one whole 7:1 cycle of its 24 layers (one sLSTM
    # layer, whose token loop took most of a full-depth prefill's time)
    with timed_phase("21 serve xlstm"):
        cfg = get_config("xlstm-350m").replace(use_pallas=True, n_layers=8)
        params = init_full(cfg, dev, "serve xlstm")
        xlstm = phase_serve(dev, cfg, params, "ring", "serve xlstm",
                            prefill_profile=True)
        log("serve xlstm", f"ssm_scan launches on the xlstm serve path "
            f"(graph run): {xlstm['ssm_scan']} "
            f"({kind_layers(cfg, ('mlstm',))} mLSTM layers, one launch each "
            f"per prefill)")
        free(params)

    with timed_phase("22 serve qwen2-vl"):
        cfg = get_config("qwen2-vl-2b").replace(use_pallas=True)
        params = init_full(cfg, dev, "serve qwen2-vl")
        phase_serve(dev, cfg, params, "paged", "serve qwen2-vl")
        phase_serve(dev, cfg, params, "ring", "serve qwen2-vl ring")
        phase_serve_mixed(dev, cfg, params, "serve mixed qwen2-vl")
        phase_vision(dev, cfg, params)
        free(params)

    with timed_phase("23 serve dense"):
        for name, cut, sched, max_new in SLICE_SERVE:
            cfg = get_config(name).replace(use_pallas=True, **cut)
            params = init_full(cfg, dev, f"serve {name}")
            for layout in ("paged", "ring"):
                phase_serve(dev, cfg, params, layout,
                            f"serve {name} {layout}", max_new=max_new,
                            sched=sched)
            free(params)

    with timed_phase("24 encdec"):
        cfg = get_config("seamless-m4t-large-v2").replace(use_pallas=True)
        params = init_full(cfg, dev, "encdec")
        phase_encdec(dev, cfg, params)
        free(params)

    # the shapes the reference pads, served and trained at full width
    with timed_phase("39 wide heads"):
        wide = phase_wide(dev)

    # training the dense decoders on the card
    with timed_phase("29 train parity"):
        phase_train_parity(dev)
    with timed_phase("30 train"):
        train = phase_train(dev)
    with timed_phase("31 train agent-1b"):
        phase_train_1b(dev)
    with timed_phase("32 train_lm"):
        phase_train_lm(dev)

    # training every other family on the card
    with timed_phase("34 train parity families"):
        phase_train_families(dev)
    with timed_phase("35 train moe"):
        moe = phase_train_moe(dev)
    with timed_phase("36 train ssm"):
        ssm_run = phase_train_ssm(dev)
    with timed_phase("37 train vlm encdec"):
        phase_train_vlm_encdec(dev)

    # the launch layer over torch.distributed: world 1 over NCCL, then two
    # gloo ranks sharing the card
    with timed_phase("38 sharded"):
        seq = phase_sharded(dev)
    log("time", f"all phases: {time.perf_counter() - t_all:.1f} s")

    main_path = {"paged_decode_attention": control,
                 "paged_flash_attention": control, "flash_attention": hymba,
                 "decode_attention": hymba, "ssm_scan": hymba,
                 "grouped_matmul": arctic, "flash_attention_backward": train,
                 "grouped_matmul_backward": moe,
                 "ssm_scan_backward": ssm_run, "attention_combine": seq}
    # the bodies past the old limits: phase 39's runs at agent-7b's width
    # with heads of 512 (paged, its prefill chunks on paged flash; ring;
    # its train step) and xLSTM's 1.3B width (ring and its train step)
    d512, x13 = wide["agent-7b at d_head 512"], wide["xLSTM 1.3B's width"]
    past_path = {"paged_decode_attention": d512["paged"],
                 "paged_flash_attention": d512["paged"],
                 "decode_attention": d512["ring"],
                 "flash_attention": d512["ring"],
                 "flash_attention_backward": d512["train"],
                 "ssm_scan": x13["ring"], "ssm_scan_backward": x13["train"]}
    for row in rows:
        kernel = row["name"].split()[0]
        path = main_path if kernel == row["name"] else past_path
        row["launches"] = path[kernel][kernel]
        if not row["launches"]:
            raise AssertionError(f"{row['name']}: no launch on its path")

    print(card(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
