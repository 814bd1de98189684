"""Bit-level digests of the two decode kernels' outputs on fixed inputs.

Runs ``decode_attention`` (the ring) and ``paged_decode_attention`` (the
page pool) of a source tree's ``repro_torch`` on inputs drawn from fixed
numpy seeds (the cases of ``tests/test_torch_cuda.py``'s digest tests),
in f32 and bf16, one split and several, and prints the first 16 hex
digits of the SHA-256 of each output's bytes.  ``--src`` names the tree
(default: this checkout's), so two versions compare in one call on one
card; a change that keeps the kernels' arithmetic prints the same
digests:

    python tools/decode_digests.py --src /path/to/other/src
    python tools/decode_digests.py

Prints one JSON object a line: the card (``nvidia-smi`` name and power
limit), then one per case.  Needs a CUDA card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (kernel, dtype, (B, Hkv, G, dh), ring slots or page size, contexts)
CASES = [("ring", "float32", (3, 2, 4, 128), 64, [50, 9, 64]),
         ("ring", "bfloat16", (3, 2, 4, 128), 64, [50, 9, 64]),
         ("ring", "float32", (3, 8, 16, 128), 4096, [4000, 700, 2049]),
         ("ring", "bfloat16", (3, 8, 5, 64), 4096, [4000, 700, 2049]),
         ("paged", "float32", (3, 2, 4, 128), 16, [50, 9, 64]),
         ("paged", "bfloat16", (3, 8, 7, 128), 128, [3000, 700, 129]),
         ("paged", "bfloat16", (3, 8, 16, 128), 16, [1500, 33, 900])]


def inputs(torch, dev, kind, dtype, heads, n, ctx):
    """The ring (q, k, v, kpos, q_pos), rows written at positions 0 ..
    c - 1 of each context c, or the pool (q, k_pages, v_pages, block
    tables, ctx), each row's pages in a permuted physical order."""
    import numpy as np

    b, hkv, g, dh = heads
    rng = np.random.default_rng(1234)
    dt = getattr(torch, dtype)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(dev, dt)
    q = draw(b, 1, hkv * g, dh)
    if kind == "ring":
        last = np.asarray(ctx)[:, None] - 1
        kpos = last - np.mod(last - np.arange(n)[None], n)
        kpos = np.where(kpos >= 0, kpos, -1).astype(np.int32)
        return (q, draw(b, n, hkv, dh), draw(b, n, hkv, dh),
                torch.from_numpy(kpos).to(dev),
                torch.tensor([c - 1 for c in ctx], dtype=torch.int32,
                             device=dev))
    pages = [-(-c // n) for c in ctx]
    perm = rng.permutation(sum(pages))
    p_max = max(pages)
    bt = np.full((b, p_max), -1, np.int32)
    at = 0
    for r, p in enumerate(pages):
        bt[r, :p] = perm[at:at + p]
        at += p
    pool = sum(pages) + 1
    return (q, draw(pool, n, hkv, dh), draw(pool, n, hkv, dh),
            torch.from_numpy(bt).to(dev),
            torch.tensor(ctx, dtype=torch.int32, device=dev))


def digest(torch, t) -> str:
    """The first 16 hex digits of the SHA-256 of ``t``'s bytes."""
    raw = t.detach().contiguous().cpu().view(-1).view(torch.uint8)
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()[:16]


def run(torch, kernels, dev, case) -> str:
    """The digest of one case's output."""
    kind, dtype, heads, n, ctx = case
    x = inputs(torch, dev, kind, dtype, heads, n, ctx)
    fn = (kernels.decode_attention if kind == "ring"
          else kernels.paged_decode_attention)
    with torch.no_grad():
        out = fn(*x, window=-1)
    torch.cuda.synchronize()
    return digest(torch, out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    kernels = importlib.import_module("repro_torch.kernels")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": gpu, "src": args.src}), flush=True)
    dev = torch.device("cuda")
    for case in CASES:
        kind, dtype, heads, n, ctx = case
        print(json.dumps({"kernel": kind, "dtype": dtype, "heads": heads,
                          "n": n, "ctx": ctx,
                          "digest": run(torch, kernels, dev, case)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
