"""Device times of the ``ssm_scan`` backward kernels on one card.

Times ``repro_torch.kernels.ssm_scan._launch_backward`` (the backward's
launches alone; the forward's chunk states are made once before) at the
training shapes of ``chip_smoke.py``'s ``SCAN_BWD_CASES``, in f32 and
bf16, as medians of three readings of back-to-back calls behind a sleep
kernel (the method of ``chip_smoke.py::cuda_ms``).  ``--src`` names the
source tree whose ``repro_torch`` is timed (default: this checkout's), so
two versions compare in one call on one card:

    python tools/scan_backward_times.py --src /path/to/other/src
    python tools/scan_backward_times.py

Prints one JSON object a line: the card (``nvidia-smi`` name and power
limit), then one per case and dtype; with ``--profile`` each of those also
holds the device time of each of the call's kernels, from one more call
under ``torch.profiler``.  Needs a CUDA card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import importlib
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# b, t, h, dk, dv, chunk, shared q/k, decay (None: hymba's softplus), h0
# scale, dH_T: chip_smoke.py's SCAN_BWD_CASES
CASES = [(2, 4096, 50, 16, 64, 128, True, None, 0.0, False),
         (1, 1000, 50, 16, 64, 128, True, None, 0.5, True),
         (4, 1024, 4, 512, 513, 128, False, 0.1, 0.0, False),
         (1, 300, 2, 512, 513, 128, False, 0.1, 0.3, True)]
SLEEP_CYCLES_PER_CALL = 200_000


def inputs(torch, dtype, case, gen, dev):
    """q, k, v, log_a, h0, dy, dH_T as chip_smoke.py's scan_bwd_args."""
    b, t, h, dk, dv, _, shared, decay, h0s, dht = case
    nq = 1 if shared else h
    scale = 0.3 if dk <= 64 else dk ** -0.5

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    q = (scale * randn(b, t, nq, dk)).to(dtype)
    k = (scale * randn(b, t, nq, dk)).to(dtype)
    v = (0.3 * randn(b, t, h, dv)).to(dtype)
    if decay is None:
        log_a = -torch.nn.functional.softplus(randn(b, t, h))
    else:
        log_a = -decay * torch.rand((b, t, h), generator=gen, device=dev)
    h0 = h0s * randn(b, h, dk, dv)
    if shared:
        q, k = q.expand(b, t, h, dk), k.expand(b, t, h, dk)
    dy = randn(b, t, h, dv).to(dtype)
    dh_t = randn(b, h, dk, dv) if dht else None
    return q, k, v, log_a, h0, dy, dh_t


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
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


def kernel_times(torch, fn) -> dict:
    """Device microseconds of each kernel of one call of ``fn``, by name
    (template arguments kept, parameter lists dropped)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = e.self_device_time_total
        if us > 0:
            name = re.sub(r"^void |\(anonymous namespace\)::", "", e.key)
            out[name.split("(")[0]] = round(us, 1)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the source tree whose repro_torch is timed")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--profile", action="store_true",
                    help="also each kernel's device time, from one call "
                         "under the profiler")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    scan_mod = importlib.import_module("repro_torch.kernels.ssm_scan")

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    print(json.dumps({"card": gpu.strip().splitlines()[0],
                      "src": str(Path(scan_mod.__file__).resolve())}),
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(13)
    for dtype in (torch.float32, torch.bfloat16):
        for case in CASES:
            q, k, v, la, h0, dy, dh_t = inputs(torch, dtype, case, gen, dev)
            chunk = case[5]
            _, h_t, states = scan_mod._launch(q, k, v, la, h0, chunk,
                                              keep_states=True)
            la32 = la.float().contiguous()

            def call():
                scan_mod._launch_backward(q, k, v, la32, states, h_t, dy,
                                          dh_t, chunk)
            xs = sorted(cuda_ms(torch, call, args.iters) for _ in range(3))
            row = {"dtype": str(dtype).split(".")[1], "case": list(case),
                   "ms": xs[1], "spread": xs[2] - xs[0]}
            if args.profile:
                row["kernels_us"] = kernel_times(torch, call)
            print(json.dumps(row), flush=True)
            del q, k, v, la, h0, dy, dh_t, states, h_t, la32
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
