"""Wall times of the paged layout's prefill and mixed steps at a served
config, for one source tree, so two versions compare in one call on one
card (parent, change, change, parent).

Builds the tree's kernels, makes agent-7b's random weights (seed 0; in
full, bf16, kernels on) and serves, as ``chip_smoke.py``'s serve phases
do:

1. a paged engine, its decode steps replayed as CUDA graphs: the smoke's
   8 serve prompts (``SERVE_LENS``), 16 new tokens each; ``prefill_s`` is
   the wall time of its serialized paged prefill steps (each step
   synchronized), the smoke's "prefill of the 8", on a second engine
   after a first has served the same prompts (the process's first
   prefills also pay its one-time work: loading the kernel libraries,
   the math libraries' handles);
2. a paged mixed engine (``prefill_chunk`` 512, a token budget of 520, a
   ``PrefixCache``): the 8 prompts, then 8 over one 1024-token system
   prompt with 64-256-token suffixes, the first prefilled alone, 16 new
   tokens each; ``mixed_ms`` is the mean of its mixed steps after the
   first (which captures the step's graph), ``decode_ms`` the same of its
   decode steps;
3. four mixed steps of 8 fresh 512-token prompts under the profiler:
   ``mixed_device_ms``, the device time of a mixed step, and
   ``mixed_flash_ms``, that of the kernels whose name holds "flash" (the
   chunk's paged flash kernel; nothing where the chunk takes the gather
   path).

    python tools/paged_serve_times.py --src build/parent/src
    python tools/paged_serve_times.py

Prints one JSON object: the card (``nvidia-smi`` name and power limit),
the tree and each figure.  Needs a CUDA card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
MODEL, NEW = "agent-7b", 16
# copies of chip_smoke.py's SERVE_LENS, SERVE_SCHED, MIXED_SCHED and
# SYSTEM_PROMPT, and of serve mixed's wave 2 suffixes (seed 9); the tool
# cannot import the smoke, which imports this checkout's repro_torch and
# not --src's.  tests/test_torch_chip_smoke.py holds them, and the
# prompts of requests(), equal to the smoke's.
SERVE_LENS = [int(x) for x in np.random.default_rng(2).integers(256, 1025,
                                                                  8)]
SERVE_SCHED = dict(max_slots=8, num_pages=512, page_size=128,
                   max_context=4096)
MIXED_SCHED = dict(SERVE_SCHED, mixed=True, prefill_chunk=512,
                   max_batch_tokens=520)
SYSTEM_PROMPT = 1024
SUFFIXES = [int(x) for x in np.random.default_rng(9).integers(64, 257, 8)]


def requests(request, vocab: int, lens, seed: int, prefix_len: int = 0):
    """``request`` objects (``core.types.Request``) of prompts drawn
    from ``seed``: one shared ``prefix_len``-token head, then a tail of
    each length in ``lens``, as chip_smoke.py's ``make_requests`` (no
    head) and ``shared_prefix_requests`` draw them."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, prefix_len).astype(np.int32)
    return [request(prompt_len=prefix_len + n, max_new_tokens=NEW,
                    prompt_tokens=np.concatenate(
                        [head, rng.integers(0, vocab, n).astype(np.int32)]))
            for n in lens]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    models = importlib.import_module("repro_torch.models")
    configs = importlib.import_module("repro_torch.configs")
    build = importlib.import_module("repro_torch.kernels.build")
    engine = importlib.import_module("repro_torch.serving.engine")
    sched = importlib.import_module("repro_torch.serving.scheduler")
    prefix = importlib.import_module("repro_torch.serving.prefix_cache")
    types = importlib.import_module("repro_torch.core.types")
    dev = torch.device("cuda")
    build.build_all()
    cfg = configs.get_config(MODEL).replace(use_pallas=True)
    params = models.init(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)

    def reqs(lens, seed, prefix_len=0):
        return requests(types.Request, cfg.vocab, lens, seed, prefix_len)

    def run(eng, reqs, stagger=False):
        """Serve ``reqs``; each step kind's wall times, the first step of
        a kind that captured apart."""
        times = {"prefill": [], "decode": [], "mixed": []}
        waiting = list(reqs)
        if stagger:
            eng.submit(waiting.pop(0))
        while eng.busy or waiting:
            if waiting and (not stagger or reqs[0].state.value in (
                    "running", "finished")):
                for r in waiting:
                    eng.submit(r)
                waiting = []
            made = sum(eng.step_captures.values())
            t0 = time.perf_counter()
            kind = eng.step()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if sum(eng.step_captures.values()) == made and \
                    kind.value in times:
                times[kind.value].append(dt)
        return times

    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0], "src": args.src,
        "model": MODEL}
    for _ in ("warm-up", "timed"):
        eng = engine.TorchEngine(cfg, params, sched.SchedulerConfig(
            **SERVE_SCHED), name="paged", cache_layout="paged", device=dev)
        t = run(eng, reqs(SERVE_LENS, 3))
        eng.release_graphs()
        del eng
        torch.cuda.empty_cache()
    out["prefill_s"] = sum(t["prefill"])
    out["prefill_steps"] = len(t["prefill"])

    eng = engine.TorchEngine(cfg, params, sched.SchedulerConfig(
        **MIXED_SCHED), name="mixed", cache_layout="paged", device=dev)
    eng.attach_cache(prefix.PrefixCache(
        eng.scheduler.alloc, name="mixed.cache", instance="mixed",
        block_tokens=SERVE_SCHED["page_size"], reserve_frac=0.8))
    t1 = run(eng, reqs(SERVE_LENS, 3))
    t2 = run(eng, reqs(SUFFIXES, 10, SYSTEM_PROMPT), stagger=True)
    for kind in ("mixed", "decode"):
        xs = t1[kind] + t2[kind]
        out[f"{kind}_ms"] = 1e3 * sum(xs) / max(len(xs), 1)
        out[f"{kind}_steps"] = len(xs)
    # four profiled mixed steps of fresh prompts
    for r in reqs([512] * 8, 4):
        eng.submit(r)
    eng.step()                          # the first chunk, no decode row
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        kinds = [eng.step().value for _ in range(4)]
        torch.cuda.synchronize()
    eng.run_until_idle()
    rows = [(e.self_device_time_total, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    out["profiled_kinds"] = kinds
    out["mixed_device_ms"] = sum(r[0] for r in rows) / 1e3 / 4
    out["mixed_flash_ms"] = sum(r[0] for r in rows
                                if "flash" in r[1]) / 1e3 / 4
    print(json.dumps(out), flush=True)
    eng.release_graphs()
    return 0


if __name__ == "__main__":
    sys.exit(main())
