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
                 attention kernels also at head dim 120 and groups 6, 12
                 and 16 and the SSM scan at mLSTM's width (dk 512, dv
                 513), which no ported config uses yet; with its time at
                 the main path's shapes, the plain version's, a PyTorch
                 library call's where one exists, and its bound; and
                 grouped matmul's unit shapes and split of d timed
                 against each other.
4. parity     -- agent-7b width at 2 layers in f32: TorchEngine's greedy
                 tokens are equal across the paged layout with and
                 without its kernel and the ring layout with and without
                 its kernels, also for a sliding window whose ring wraps.
5. migrate    -- the same model: ring->paged, paged->ring and ring->ring
                 migration continue with an unmigrated run's tokens;
                 paged->ring with a window is refused.
6. serve      -- agent-7b in full (32 layers, bf16), paged layout, serves
                 8 requests; the paged kernel launches once per layer per
                 decode step; a profile of four decode steps follows.
7. serve ring -- the same weights and requests on the ring layout: the
                 flash kernel launches once per layer per prefill, the
                 ring decode kernel once per layer per decode step, and
                 the paged kernel never; profiles of four decode steps
                 and of the longest prompt's prefill follow.
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
12. parity kimi -- kimi-k2 width at 1 layer in f32 (its dense first
                 layer; attention at head dim 112, G = 8): greedy tokens
                 equal across both layouts with and without their kernels,
                 full attention and a window whose ring wraps.
13. serve kimi -- kimi-k2 at 2 of its 61 layers, bf16 (the dense layer and
                 an MoE layer of 384 experts, top-8, a shared expert),
                 serves 8 requests in the paged and then the ring layout
                 with exact launch counts of all four kernels it runs;
                 each with a profile.

The last two lines are a JSON object of kernel numbers and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import math
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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.types import Request, RequestState  # noqa: E402
from repro_torch.models.moe import capacity  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_plain, decode_splits)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.kernels.grouped_matmul import (  # noqa: E402
    grouped_matmul, grouped_matmul_plain)
from repro_torch.kernels.paged_decode_attention import (  # noqa: E402
    paged_decode_attention, paged_decode_attention_plain, paged_decode_splits)
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_plain  # noqa: E402
from repro_torch.serving import cache_utils  # noqa: E402
from repro_torch.serving.engine import TorchEngine  # noqa: E402
from repro_torch.serving.scheduler import SchedulerConfig  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12            # f32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # bf16 tensor cores, dense
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# ssm_scan in f32: the reference's own band for that kernel
# (tests/test_kernels.py:253), chunked and sequential sums differ in order
SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card() -> str:
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


# (Hkv, G, dh) of the served models' paged decode, then the shapes no
# ported config uses yet (dh 120: h2o-danube-3; G 6: qwen2-vl; 12:
# command-r-plus; 16: llama3-405b)
PAGED_HEADS = (8, 4, 128)                               # agent-7b
ARCTIC_PAGED_HEADS = (8, 7, 128)
KIMI_HEADS = (8, 8, 112)                                # kimi-k2: 7168 / 64
UNSERVED_HEADS = [(8, 6, 120), (8, 12, 120), (8, 16, 120)]


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
    keys, q, out, tables, ctx) at HBM rate vs its f32 operations."""
    q, kp, _, bt, ctx = args
    _, _, hkv, dh = kp.shape
    g = q.shape[2] // hkv
    keys = sum(needed_keys(window))
    nbytes = (2 * keys * hkv * dh * kp.element_size()
              + 2 * q.numel() * q.element_size()
              + bt.numel() * 4 + ctx.numel() * 4)
    return bound_of(nbytes, 4 * g * dh * keys * hkv, torch.float32)


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
    for dtype in (torch.float32, torch.bfloat16):
        for heads in (PAGED_HEADS, ARCTIC_PAGED_HEADS, KIMI_HEADS,
                      *UNSERVED_HEADS):
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
                    if dtype == torch.bfloat16:
                        worst = max(worst, err)
                    if (dtype, page, window) == (torch.bfloat16, 128, -1):
                        timed[heads] = args

    # times at the serve phases' decode shapes: bf16, pages of 128;
    # arctic-480b's and kimi-k2's heads for PERF.md, then the JSON row at
    # agent-7b's
    time_paged(timed[ARCTIC_PAGED_HEADS], live)
    time_paged(timed[KIMI_HEADS], live)
    ms, plain_ms, library_ms, bound_ms, bound_by = time_paged(
        timed[PAGED_HEADS], live)
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/"
                      "paged_decode_attention.cu",
            "replaces": "src/repro/kernels/paged_decode_attention.py:89",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


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
        f"G={args[0].shape[2] // hkv} dh={dh} page=128 ctx={CTX}: kernel "
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
# the 128-wide body with zero columns); at the shapes no ported config
# uses yet: dh 120 with G 6, 12 and 16
ARCTIC_HEADS = (56, 8, 128)
ARCTIC_FLASH_CASES = [(1024, 1024, True, -1), (900, 900, True, 512),
                      (300, 700, False, -1)]
KIMI_FLASH_HEADS = (64, 8, 112)
UNSERVED_FLASH_HEADS = [(48, 8, 120), (96, 8, 120), (128, 8, 120)]
UNSERVED_FLASH_CASES = [(1024, 1024, True, -1), (300, 700, False, -1)]
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


def flash_valid_keys(s: int, t: int, causal: bool, window: int) -> int:
    """Valid (query row, key) pairs of one head."""
    if not causal:
        return s * t
    i = np.arange(s)
    hi = np.minimum(i, t - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros_like(i)
    return int(np.maximum(hi - lo + 1, 0).sum())


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
    per valid (row, head, key): two for q.k, two for p.v."""
    q, k, _ = args
    b, s, h, dh = q.shape
    t = k.shape[1]
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    ops = 4 * dh * b * h * flash_valid_keys(s, t, causal, window)
    return bound_of(nbytes, ops, q.dtype)


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
    log("kernels", f"flash_attention bf16 {label} causal: kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound "
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


def phase_flash(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        cases = [(heads, 1, *case) for heads, cases in (
            (FLASH_HEADS, FLASH_CASES), (HYMBA_HEADS, HYMBA_FLASH_CASES),
            (ARCTIC_HEADS, ARCTIC_FLASH_CASES),
            (KIMI_FLASH_HEADS, ARCTIC_FLASH_CASES),
            *((h, UNSERVED_FLASH_CASES) for h in UNSERVED_FLASH_HEADS))
            for case in cases]
        for case in cases + EDGE_FLASH_CASES:
            err = check_flash(dtype, *case, gen, dev)
            if dtype == torch.bfloat16:
                worst = max(worst, err)

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

    # the JSON row: agent-7b's ring prefill of its longest prompt
    ms, plain_ms, library_ms, bound_ms, bound_by = time_flash(
        flash_case(torch.bfloat16, 1024, 1024, gen, dev),
        "B=1 S=T=1024 H=32 Hkv=8 dh=128")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:90",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


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
    dh f32 operations per valid slot and KV head."""
    q, k, _, kpos, q_pos = args
    hkv, dh = k.shape[2], k.shape[3]
    g = q.shape[2] // hkv
    keys = int(ring_valid(args, window).sum())
    nbytes = (2 * keys * hkv * dh * k.element_size()
              + 2 * q.numel() * q.element_size()
              + kpos.numel() * 4 + q_pos.numel() * 4)
    return bound_of(nbytes, 4 * g * dh * keys * hkv, torch.float32)


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
        f"ctx={CTX}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA with "
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


def phase_ring_decode(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(2)
    live = torch.tensor([c > 0 for c in CTX], device=dev)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for heads, cases in ((RING_HEADS, RING_CASES),
                             (HYMBA_RING_HEADS, HYMBA_RING_CASES),
                             (ARCTIC_RING_HEADS, RING_CASES),
                             (KIMI_HEADS, RING_CASES),
                             *((h, UNSERVED_RING_CASES)
                               for h in UNSERVED_HEADS)):
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
                if dtype == torch.bfloat16:
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
    time_ranges(gen, dev)
    # the JSON row: agent-7b's full-attention ring
    ms, plain_ms, library_ms, bound_ms, bound_by = time_ring_decode(
        ring_case(torch.bfloat16, 4096, gen, dev), live,
        "B=8 Hkv=8 G=4 dh=128")
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:75",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


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
              (1, 200, 2, 128, 129, 64, False, 0.1, 0.3)]
MLSTM_SCAN = (1, 1024, 4, 512, 513, 128, False, 0.1, 0.0)   # xlstm-350m


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


def stored_bytes(x: torch.Tensor) -> int:
    """Bytes a call must read of ``x``: a broadcast head axis once."""
    n = x.numel() // x.shape[2] if x.ndim == 4 and x.stride(2) == 0 \
        else x.numel()
    return n * x.element_size()


def scan_bound(args, chunk: int) -> tuple[float, str]:
    """q, k (once per broadcast row), v, log_a and h0 read once, y and
    h_T written once, against the operations of the chunked form: 2 *
    (dk + dv) per causal (i, j) pair of a chunk for the scores and the
    intra-chunk y, 4 * dk * dv per token for the inter-chunk y and the
    state update."""
    q, k, v, log_a, h0 = args
    b, t, h, dk = q.shape
    dv = v.shape[3]
    pairs = sum(n * (n + 1) // 2 for n in
                (min(chunk, t - c0) for c0 in range(0, t, chunk)))
    nbytes = (sum(stored_bytes(x) for x in args)
              + v.numel() * v.element_size() + h0.numel() * 4)
    ops = b * h * (2 * (dk + dv) * pairs + 4 * t * dk * dv)
    return bound_of(nbytes, ops, q.dtype)


def phase_ssm_scan(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(3)
    worst = 0.0
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
            if dtype == torch.bfloat16:
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
    return {"name": "ssm_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
            "replaces": "src/repro/kernels/ssm_scan.py:69",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


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
    counts, against 2 * sum(min(counts, C)) * d * f operations."""
    e, c, d = x.shape
    f = w.shape[2]
    rows = int(counts.clamp(0, c).sum())
    live = int((counts > 0).sum())
    nbytes = ((live * d * f + rows * d + e * c * f) * x.element_size()
              + counts.numel() * 4)
    return bound_of(nbytes, 2 * rows * d * f, x.dtype)


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


def serve(eng: TorchEngine, reqs) -> dict:
    """Submit ``reqs`` and step the engine until idle (the loop of
    ``run_until_idle``), timing prefill and decode steps apart."""
    for r in reqs:
        eng.submit(r)
    times = {"prefill": 0.0, "decode": 0.0}
    decode_tokens = 0
    while eng.busy:
        before = eng.tokens_generated
        t0 = time.perf_counter()
        kind = eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if kind.value in times:
            times[kind.value] += dt
        if kind.value == "decode":
            decode_tokens += eng.tokens_generated - before
    for r in reqs:
        if r.state != RequestState.FINISHED or \
                len(r.output_tokens) != r.max_new_tokens:
            raise AssertionError(f"{r.req_id} ended {r.state} with "
                                 f"{len(r.output_tokens)} tokens")
        if not all(0 <= t < eng.cfg.vocab for t in r.output_tokens):
            raise AssertionError(f"{r.req_id} emitted an out-of-vocab id")
    return {"times": times, "decode_tokens": decode_tokens}


KERNELS = {"paged_decode_attention": paged_decode_attention,
           "flash_attention": flash_attention,
           "decode_attention": decode_attention,
           "ssm_scan": ssm_scan,
           "grouped_matmul": grouped_matmul}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def moe_layers(cfg) -> int:
    return sum(seg.repeat * n for seg in cfg.plan()
               for spec, n in seg.pattern if spec.moe)


def expected_launches(eng: TorchEngine, prefills: int) -> dict:
    """Launches of each kernel on a run of ``eng`` that ran ``prefills``
    prefill forwards (the ring layout one per prompt; the paged layout
    one per chunk, and the scheduler's token budget splits a step's
    prompts into chunks): one per layer per prefill (flash and, in a
    hybrid's mamba branch, the SSM scan; ring) or per decode step (the
    layout's decode kernel), and three per MoE layer per forward
    (grouped_matmul, either layout); none without the flag, and none on
    the CPU, where the wrappers take the plain versions."""
    want = dict.fromkeys(KERNELS, 0)
    if eng.cfg.use_pallas and eng.device.type == "cuda":
        n = eng.cfg.n_layers
        if eng.cache_layout == "paged":
            want["paged_decode_attention"] = n * eng.decode_steps
        else:
            want["flash_attention"] = n * prefills
            want["decode_attention"] = n * eng.decode_steps
            if eng.cfg.family == "hybrid":
                want["ssm_scan"] = n * prefills
        want["grouped_matmul"] = (3 * moe_layers(eng.cfg)
                                  * (prefills + eng.decode_steps))
    return want


def count_prefill_work(eng: TorchEngine) -> list:
    """Count the prefill work items the scheduler hands ``eng`` from now
    on: each is one forward (a whole prompt on the ring layout, a chunk
    on the paged one).  Returns a one-element list holding the count."""
    count = [0]
    plan_step = eng.scheduler.plan_step

    def counted():
        plan = plan_step()
        count[0] += len(plan.prefills)
        return plan
    eng.scheduler.plan_step = counted
    return count


def served_counts(eng: TorchEngine, reqs, before: dict) -> dict:
    """Serve ``reqs`` and check each kernel's launches on that run."""
    forwards = count_prefill_work(eng)
    res = serve(eng, reqs)
    after = launch_counts()
    used = {k: after[k] - before[k] for k in KERNELS}
    if eng.scheduler.preempt_count:
        raise AssertionError(f"{eng.name}: unexpected preemption")
    if eng.cache_layout == "ring" and forwards[0] != len(reqs):
        raise AssertionError(f"{eng.name}: {forwards[0]} ring prefills for "
                             f"{len(reqs)} prompts")
    res["prefill_forwards"] = forwards[0]
    want = expected_launches(eng, forwards[0])
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
                 name: str) -> TorchEngine:
    return TorchEngine(cfg.replace(use_pallas=use_pallas), params,
                       SchedulerConfig(**PARITY_SCHED), name=name,
                       cache_layout=layout, device=dev)


def phase_parity(dev, cfg, params, layouts=LAYOUTS,
                 label: str = "agent-7b width, 2 layers") -> None:
    """Greedy tokens equal across ``layouts`` (layout, kernels on or
    off), for full attention and for the ``PARITY_SWA`` window, whose
    ring is shorter than the longer prompts."""
    for window, chunk in ((-1, cfg.attn_chunk), PARITY_SWA):
        c = cfg.replace(window=window, attn_chunk=chunk)
        outs = {}
        for layout, use_pallas in layouts:
            eng = small_engine(c, params, layout, use_pallas, dev,
                               f"parity-{layout}-{use_pallas}")
            if layout == "ring" and window > 0:
                size = min(e["kv"].k.shape[-3] for seg in
                           eng.cache["segments"] for e in seg.values())
                if not size < max(PARITY_LENS):
                    raise AssertionError(f"ring of {size} slots does not "
                                         f"wrap")
            reqs = make_requests(PARITY_LENS, 16, cfg.vocab, seed=1)
            served_counts(eng, reqs, launch_counts())
            outs[layout, use_pallas] = [list(r.output_tokens) for r in reqs]
        first = outs[layouts[0]]
        for key, got in outs.items():
            if got != first:
                raise AssertionError(f"window {window}: {key} disagrees with "
                                     f"{layouts[0]}:\n{got}\n{first}")
        how = ("paged and ring, with and without their kernels"
               if len({lay for lay, _ in layouts}) > 1
               else f"{layouts[0][0]}, with and without its kernels")
        log("parity", f"{label}, f32, window {window}, attn_chunk {chunk}, "
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


def phase_serve(dev, cfg, params, layout: str, phase: str,
                max_new: int = 64, prefill_profile: bool = False) -> dict:
    """The full model serves the 8 requests on ``layout``; every kernel
    of the path launches exactly as often as expected.  Returns the
    counts of that run.  A profile of four decode steps follows, and with
    ``prefill_profile`` one of the longest prompt's prefill."""
    eng = TorchEngine(cfg, params, SchedulerConfig(**SERVE_SCHED),
                      name=f"serve-{layout}", cache_layout=layout,
                      device=dev)
    lens = [int(x) for x in np.random.default_rng(2).integers(256, 1025, 8)]
    reqs = make_requests(lens, max_new, cfg.vocab, seed=3)
    torch.cuda.reset_peak_memory_stats()
    for fn in KERNELS.values():                 # the main path's counts
        fn.launches = 0
    res = served_counts(eng, reqs, launch_counts())
    launches = res["launches"]
    dec = res["times"]["decode"]
    log(phase, f"{layout} layout, kernels {'on' if cfg.use_pallas else 'off'}"
        f", 8 requests, prompts {lens}, {max_new} new tokens each: all "
        f"FINISHED; {eng.prefill_steps} prefill steps "
        f"{res['times']['prefill']:.3f} s, {eng.decode_steps} decode steps "
        f"{dec:.3f} s, mean decode step {1e3 * dec / eng.decode_steps:.2f} "
        f"ms, decode {res['decode_tokens'] / dec:.1f} tokens/s; kernel "
        f"launches {launches} ({cfg.n_layers} layers, {len(reqs)} "
        f"prompts in {res['prefill_forwards']} prefill forwards, "
        f"{eng.decode_steps} decode steps); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_decode(eng, 1e3 * dec / eng.decode_steps, phase)
    if prefill_profile:
        profile_prefill(eng, max(lens), phase)
    return launches


# the decode attention kernels' names in a profile: the split kernels of
# either layout and the merge they share
DECODE_KERNELS = ("paged_split_kernel", "decode_split_kernel",
                  "split_merge_kernel")


def profile_decode(eng: TorchEngine, step_ms: float, phase: str,
                   steps: int = 4) -> None:
    """Where a decode step's time goes, after the counted run: device
    time by kernel over ``steps`` decode steps of 8 fresh 512-token
    sequences, against the unprofiled mean decode step time."""
    reqs = make_requests([512] * 8, steps + 2, eng.cfg.vocab, seed=4)
    for r in reqs:
        eng.submit(r)
    while any(r.state != RequestState.RUNNING for r in reqs):
        eng.step()                                   # admit + prefill
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    eng.run_until_idle()
    rows = device_rows(prof)
    device_ms = sum(r[0] for r in rows) / 1e3 / steps
    log("profile", f"{phase}: decode step: device busy {device_ms:.2f} ms of "
        f"{step_ms:.2f} ms unprofiled ({100 * device_ms / step_ms:.1f}% "
        f"busy, {100 * (1 - device_ms / step_ms):.1f}% idle); "
        f"{sum(r[1] for r in rows) / steps:.0f} kernels and copies per "
        f"step")
    attn = [r for r in rows if any(k in r[2] for k in DECODE_KERNELS)]
    log("profile", f"{phase}: decode attention kernels (split and merge): "
        f"{sum(r[0] for r in attn) / 1e3 / steps:.3f} ms/step in "
        f"{sum(r[1] for r in attn) / steps:.0f} calls/step")
    for us, count, key in sorted(rows, reverse=True)[:8]:
        log("profile", f"  {phase}: {us / 1e3 / steps:8.3f} ms/step  "
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
    prefilled alone, once unprofiled for its wall time, then once under
    the profiler for device time by kernel and flash_attention's share."""
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

    wall_ms = prefill()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts, acc_events=True)
    prof.start()
    prefill(prof)
    rows = device_rows(prof)
    device_ms = sum(r[0] for r in rows) / 1e3
    flash_ms = sum(r[0] for r in rows if "flash_attention" in r[2]) / 1e3
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
            f"device time)")
    for us, count, key in sorted(rows, reverse=True)[:8]:
        log("profile", f"  {phase} prefill: {us / 1e3:8.3f} ms  {count:6d} "
            f"calls  {key[:90]}")


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
               "flash_attention_mma_kernel", "flash_attention_kernel",
               "split_merge_kernel", "grouped_matmul_tma_kernel",
               "ssm_chunk_state_kernel", "ssm_state_pass_kernel",
               "ssm_chunk_output_kernel", "ssm_chunk_output_mma_kernel")


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

    t0 = time.perf_counter()
    logs = build.build_all()
    log("build", f"{sorted(logs)} built in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        entries = ptxas_entries(text)
        regs = [e[1] for e in entries]
        spills = [e[2] for e in entries]
        log("build", f"{name}: {len(regs)} instantiations, "
            f"{min(regs, default=0)}-{max(regs, default=0)} registers; "
            f"{sum(n > 0 for n in spills)} spill, at most "
            f"{max(spills, default=0)} bytes")
        # each instantiation of the redesigned kernels on a line of its own
        for fn, n_regs, spill in entries:
            if any(k in fn for k in NEW_KERNELS):
                log("build", f"  {fn}: {n_regs} registers, {spill} bytes "
                    f"spill stores")

    rows = [phase_kernels(dev), phase_flash(dev), phase_ring_decode(dev),
            phase_ssm_scan(dev), phase_grouped_matmul(dev)]

    small = get_config("agent-7b").replace(n_layers=2, dtype="float32")
    params = models.init(small, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    phase_parity(dev, small, params)
    phase_migrate(dev, small, params)
    free(params)

    cfg = get_config("agent-7b").replace(use_pallas=True)
    params = init_full(cfg, dev, "serve")
    paged = phase_serve(dev, cfg, params, "paged", "serve")
    gc.collect()                             # the paged engine is gone
    torch.cuda.empty_cache()
    phase_serve(dev, cfg, params, "ring", "serve ring",
                prefill_profile=True)
    free(params)

    # hymba-1.5b width at 3 layers (global, SWA, global); PARITY_SWA's
    # window gives its middle layer a ring the longer prompts wrap
    small = get_config("hymba-1.5b").replace(n_layers=3, global_layers=(0, 2),
                                             dtype="float32")
    params = models.init(small, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    phase_parity(dev, small, params, [("ring", True), ("ring", False)],
                 "hymba-1.5b width, 3 layers")
    phase_hymba_migrate(dev, small.replace(window=PARITY_SWA[0],
                                           attn_chunk=PARITY_SWA[1]), params)
    free(params)

    cfg = get_config("hymba-1.5b").replace(use_pallas=True)
    params = init_full(cfg, dev, "serve hymba")
    hymba = phase_serve(dev, cfg, params, "ring", "serve hymba",
                        prefill_profile=True)
    free(params)

    # arctic-480b width at 1 layer in f32 (56.3 GB of weights): greedy
    # tokens equal across layouts and kernel paths
    small = get_config("arctic-480b").replace(n_layers=1, dtype="float32")
    params = init_full(small, dev, "parity arctic")
    phase_parity(dev, small, params, label="arctic-480b width, 1 layer")
    free(params)

    # arctic-480b at 2 of its 35 layers, bf16 (55.4 GB): paged, ring, and
    # paged with the kernels off (every expert product a bmm over all 128
    # experts) for the step it costs
    cfg = get_config("arctic-480b").replace(n_layers=2, use_pallas=True)
    params = init_full(cfg, dev, "serve arctic")
    arctic = phase_serve(dev, cfg, params, "paged", "serve arctic")
    gc.collect()
    torch.cuda.empty_cache()
    phase_serve(dev, cfg, params, "ring", "serve arctic ring")
    gc.collect()
    torch.cuda.empty_cache()
    phase_serve(dev, cfg.replace(use_pallas=False), params, "paged",
                "serve arctic off", max_new=16)
    free(params)

    # kimi-k2-1t-a32b width at 1 layer in f32 (its dense first layer,
    # 10.8 GB): greedy tokens equal across layouts and kernel paths at
    # head dim 112 and G = 8
    small = get_config("kimi-k2-1t-a32b").replace(n_layers=1,
                                                  dtype="float32")
    params = init_full(small, dev, "parity kimi")
    phase_parity(dev, small, params, label="kimi-k2 width, 1 layer")
    free(params)

    # kimi-k2 at 2 of its 61 layers, bf16: the dense layer and one MoE
    # layer of 384 experts, paged then ring
    cfg = get_config("kimi-k2-1t-a32b").replace(n_layers=2, use_pallas=True)
    params = init_full(cfg, dev, "serve kimi")
    phase_serve(dev, cfg, params, "paged", "serve kimi")
    gc.collect()
    torch.cuda.empty_cache()
    phase_serve(dev, cfg, params, "ring", "serve kimi ring")
    free(params)

    main_path = {"paged_decode_attention": paged, "flash_attention": hymba,
                 "decode_attention": hymba, "ssm_scan": hymba,
                 "grouped_matmul": arctic}
    for row in rows:
        row["launches"] = main_path[row["name"]][row["name"]]

    print(card(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
