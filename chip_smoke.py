#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises, so the exit
code is non-zero and the final JSON line is not printed:

1. device   -- needs CUDA; prints the card's name and power limit.
2. build    -- compiles every CUDA source of ``src/repro_torch/kernels/
               csrc`` (one nvcc each, in parallel) into ``build/``.
3. kernels  -- each kernel against its plain PyTorch version on the card,
               at the main path's shapes, with its time, the plain
               version's, a PyTorch library call's, and its bound.
4. parity   -- agent-7b width at 2 layers in f32: TorchEngine's greedy
               tokens with the kernel equal those of the gather path.
5. serve    -- agent-7b in full (32 layers, bf16) serves 8 requests; the
               kernel must launch once per layer per decode step.

The last two lines are a JSON object of kernel numbers and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
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
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.paged_decode_attention import (  # noqa: E402
    paged_decode_attention, paged_decode_attention_plain)
from repro_torch.serving.engine import TorchEngine  # noqa: E402
from repro_torch.serving.scheduler import SchedulerConfig  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12            # f32 outside the tensor cores
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# Phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------

# the main path's decode shapes: 8 slots, agent-7b heads (Hkv 8, G 4,
# dh 128), max_context 4096.  Rows 0-3 share a 1024-token prefix, rows 6
# and 7 are identical (their outputs must be bit-identical), row 5 is an
# inactive slot (ctx 0, all -1), and short rows carry -1 tails.
CTX = [4096, 4001, 2085, 1500, 777, 0, 3333, 3333]
SHARED_TOKENS = 1024


def kernel_case(dtype, page: int, gen: torch.Generator, dev):
    b, hkv, g, dh, max_ctx = len(CTX), 8, 4, 128, 4096
    p_max = max_ctx // page
    n_shared = SHARED_TOKENS // page
    rows, nxt = [], n_shared
    for r, c in enumerate(CTX):
        need = -(-c // page)
        if r == 7:
            rows.append(list(rows[6]))
            continue
        head = list(range(n_shared)) if r < 4 else []
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
            torch.tensor(CTX, dtype=torch.int32, device=dev))


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
    ops = 4 * g * dh * keys * hkv
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


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
    timed = None
    for dtype in (torch.float32, torch.bfloat16):
        for page in (128, 16):
            for window in (-1, 512):
                args = kernel_case(dtype, page, gen, dev)
                out = paged_decode_attention(*args, window=window)
                torch.cuda.synchronize()
                want = paged_decode_attention_plain(*args, window=window)
                err = (out.float() - want.float())[live].abs().max().item()
                log("kernels", f"{dtype} page {page} window {window}: "
                    f"max |kernel - plain| on live rows {err:.3e} "
                    f"(tolerance {TOL[dtype]:.0e})")
                if not math.isfinite(err) or err > TOL[dtype]:
                    raise AssertionError(
                        f"paged_decode_attention disagrees with its plain "
                        f"version: {err} > {TOL[dtype]}")
                if not torch.equal(out[6], out[7]):
                    raise AssertionError("identical rows 6 and 7 differ")
                if not torch.isfinite(out).all():
                    raise AssertionError("non-finite kernel output")
                if dtype == torch.bfloat16:
                    worst = max(worst, err)
                if (dtype, page, window) == (torch.bfloat16, 128, -1):
                    timed = (args, window)

    # times at the serve phase's decode shapes: bf16, pages of 128
    args, window = timed
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
    log("kernels", f"bf16 B=8 Hkv=8 G=4 dh=128 page=128 ctx={CTX}: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA over the "
        f"gathered view {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}); kernel at {100 * bound_ms / ms:.1f}% of bound")
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/"
                      "paged_decode_attention.cu",
            "replaces": "src/repro/kernels/paged_decode_attention.py:89",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


# ---------------------------------------------------------------------------
# Phases 4 and 5: the engine
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


def phase_parity(dev) -> None:
    cfg = get_config("agent-7b").replace(n_layers=2, dtype="float32")
    params = models.init(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    lens = [100, 333, 517, 700]
    outs = {}
    for use_pallas in (True, False):
        c = cfg.replace(use_pallas=use_pallas)
        eng = TorchEngine(c, params, SchedulerConfig(
            max_slots=4, num_pages=40, page_size=128, max_context=1024),
            name=f"parity-{use_pallas}", device=dev)
        reqs = make_requests(lens, 16, cfg.vocab, seed=1)
        launches = paged_decode_attention.launches
        serve(eng, reqs)
        used = paged_decode_attention.launches - launches
        want = cfg.n_layers * eng.decode_steps if use_pallas else 0
        if used != want:
            raise AssertionError(f"kernel launched {used} times, "
                                 f"expected {want}")
        outs[use_pallas] = [list(r.output_tokens) for r in reqs]
    if outs[True] != outs[False]:
        raise AssertionError(f"kernel and gather paths disagree:\n"
                             f"{outs[True]}\n{outs[False]}")
    log("parity", f"agent-7b width, 2 layers, f32, prompts {lens}: greedy "
        f"tokens equal with and without the kernel "
        f"({sum(map(len, outs[True]))} tokens)")


def phase_serve(dev) -> int:
    cfg = get_config("agent-7b").replace(use_pallas=True)
    t0 = time.perf_counter()
    params = models.init(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    log("serve", f"agent-7b: {models.param_count(cfg) / 1e9:.3f} B params, "
        f"{cfg.n_layers} layers, {cfg.dtype}; init "
        f"{time.perf_counter() - t0:.1f} s")
    eng = TorchEngine(cfg, params, SchedulerConfig(
        max_slots=8, num_pages=512, page_size=128, max_context=4096),
        name="serve", device=dev)
    lens = [int(x) for x in np.random.default_rng(2).integers(256, 1025, 8)]
    reqs = make_requests(lens, 64, cfg.vocab, seed=3)
    torch.cuda.reset_peak_memory_stats()
    paged_decode_attention.launches = 0          # the main path's count
    res = serve(eng, reqs)
    launches = paged_decode_attention.launches
    want = cfg.n_layers * eng.decode_steps
    if launches != want:
        raise AssertionError(f"kernel launched {launches} times, expected "
                             f"{want} = {cfg.n_layers} x {eng.decode_steps}")
    dec = res["times"]["decode"]
    log("serve", f"8 requests, prompts {lens}, 64 new tokens each: all "
        f"FINISHED; {eng.prefill_steps} prefill steps "
        f"{res['times']['prefill']:.3f} s, {eng.decode_steps} decode steps "
        f"{dec:.3f} s, mean decode step {1e3 * dec / eng.decode_steps:.2f} "
        f"ms, decode {res['decode_tokens'] / dec:.1f} tokens/s; kernel "
        f"launches {launches} = {cfg.n_layers} x {eng.decode_steps}; "
        f"max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_decode(eng, 1e3 * dec / eng.decode_steps)
    return launches


def profile_decode(eng: TorchEngine, step_ms: float, steps: int = 4) -> None:
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
    # device-side events only: a CPU op's self device time repeats the
    # time of the kernels it launched
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    device_ms = sum(r[0] for r in rows) / 1e3 / steps
    log("profile", f"decode step: device busy {device_ms:.2f} ms of "
        f"{step_ms:.2f} ms unprofiled ({100 * device_ms / step_ms:.1f}% "
        f"busy, {100 * (1 - device_ms / step_ms):.1f}% idle); "
        f"{sum(r[1] for r in rows) / steps:.0f} kernels and copies per "
        f"step")
    for us, count, key in sorted(rows, reverse=True)[:8]:
        log("profile", f"  {us / 1e3 / steps:8.3f} ms/step  "
            f"{count / steps:6.0f} calls/step  {key[:90]}")


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
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"{name}: {line.strip()}")

    row = phase_kernels(dev)
    phase_parity(dev)
    torch.cuda.empty_cache()
    row["launches"] = phase_serve(dev)

    print(card(), flush=True)
    print(json.dumps({"kernels": [row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
