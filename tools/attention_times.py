"""Device times and output digests of the four attention kernels.

Runs ``flash_attention`` (forward), its backward, ``paged_decode_attention``
and ``decode_attention`` (the ring) of a source tree's ``repro_torch`` on
inputs drawn from one seeded generator, at the head shapes of
``chip_smoke.py``'s timed rows (agent-7b's, hymba-1.5b's, kimi-k2's dh
112, in bf16 and f32) and at the shapes the reference pads (Gemma 3 12B's
dh 256, Llama 3.2 3B's G 3, dh 100, 48 query heads over 1), and past
dh 256 (``WIDE_CASES``; ``--cases wide`` runs only those).  For each
case it prints the median of three readings of back-to-back calls behind
a sleep kernel (the method of ``chip_smoke.py::cuda_ms``) and the first 16
hex digits of the SHA-256 of the output's bytes.  ``--src`` names the
tree (default: this checkout's), so two versions compare in one call on
one card, parent, change, change, parent; a case the tree's kernels do
not take prints its error instead.  A forward case also prints
``sdpa_ms``, PyTorch's ``scaled_dot_product_attention`` on the same
inputs timed the same way.  ``--kinds flash`` runs the forward's cases
alone (every head shape ``chip_smoke.py`` times, the train shape,
agent-7b's heads at B 2 x S 4096, and three shapes at one head, where
the grid's heaviest item runs alone on one SM).  ``--kinds paged_flash``
runs the paged flash kernel at ``chip_smoke.py``'s mixed-chunk cases
(``PAGED_FLASH_CASES``: 512 rows at position 1024, 8 of them pad rows,
pages shuffled over the pool), each row with ``sdpa_ms`` (SDPA over the
K/V already gathered contiguous, with the valid pairs as its mask) and
``gather_ms`` (the gather path the kernel replaces, ``paged_view`` +
``attention_cached``); and agent-7b's 1024-token prompt prefilled whole
through the table, beside the flash forward's contiguous case:

    python tools/attention_times.py --src /path/to/other/src --kinds flash
    python tools/attention_times.py --kinds flash
    python tools/attention_times.py --kinds paged_flash

The card is warmed once per process (two seconds of bf16 matmuls) before
the first timed case, so the first case is not timed while the clocks
ramp.

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
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SLEEP_CYCLES_PER_CALL = 200_000
# chip_smoke.py's CTX: the contexts of the eight decode rows
CTX = [4096, 4001, 2085, 1500, 777, 0, 3333, 3333]

# (kernel, dtype, heads, B, S or slots or page, T): flash heads are (H,
# Hkv, dh), decode heads (Hkv, G, dh), and every WIDE_CASES' heads (Hkv,
# G, dh)
CASES = [("flash", "bfloat16", (32, 8, 128), 1, 1024, 1024),
         ("flash", "bfloat16", (25, 5, 64), 1, 1024, 1024),
         ("flash", "bfloat16", (64, 8, 112), 1, 1024, 1024),
         ("flash", "float32", (32, 8, 128), 1, 1024, 1024),
         ("flash_bwd", "bfloat16", (32, 8, 128), 1, 1024, 1024),
         ("flash_bwd", "bfloat16", (32, 8, 128), 2, 4096, 4096),
         ("flash_bwd", "bfloat16", (25, 5, 64), 2, 333, 333),
         ("flash_bwd", "float32", (32, 8, 128), 1, 512, 512),
         ("paged", "bfloat16", (8, 4, 128), 8, 128, 0),
         ("paged", "bfloat16", (8, 7, 128), 8, 128, 0),
         ("paged", "bfloat16", (8, 8, 112), 8, 128, 0),
         ("paged", "float32", (8, 4, 128), 8, 16, 0),
         ("ring", "bfloat16", (8, 4, 128), 8, 4096, 0),
         ("ring", "bfloat16", (5, 5, 64), 8, 4096, 0),
         ("ring", "bfloat16", (8, 8, 112), 8, 4096, 0),
         ("ring", "float32", (8, 4, 128), 8, 4096, 0),
         # the shapes the reference pads
         ("flash", "bfloat16", (16, 8, 256), 1, 1024, 1024),
         ("flash", "bfloat16", (24, 8, 128), 1, 1024, 1024),
         ("flash", "bfloat16", (32, 8, 100), 1, 1024, 1024),
         ("flash", "float32", (16, 8, 256), 1, 1024, 1024),
         ("flash_bwd", "bfloat16", (16, 8, 256), 1, 1024, 1024),
         ("flash_bwd", "bfloat16", (16, 8, 256), 1, 4096, 4096),
         ("flash_bwd", "bfloat16", (24, 8, 128), 1, 1024, 1024),
         ("flash_bwd", "float32", (16, 8, 256), 1, 512, 512),
         ("paged", "bfloat16", (8, 2, 256), 8, 128, 0),
         ("paged", "bfloat16", (8, 3, 128), 8, 128, 0),
         ("paged", "bfloat16", (8, 4, 100), 8, 128, 0),
         ("paged", "float32", (8, 2, 256), 8, 128, 0),
         ("ring", "bfloat16", (8, 2, 256), 8, 4096, 0),
         ("ring", "bfloat16", (1, 48, 128), 8, 4096, 0),
         ("ring", "float32", (8, 2, 256), 8, 4096, 0),
         # the rest of chip_smoke.py's timed flash heads (arctic-480b's,
         # Gemma 3 4B's, 48 query heads over 1) and the train shape:
         # agent-7b's heads at B 2 x S 4096
         ("flash", "bfloat16", (56, 8, 128), 1, 1024, 1024),
         ("flash", "bfloat16", (8, 4, 256), 1, 1024, 1024),
         ("flash", "bfloat16", (48, 1, 128), 1, 1024, 1024),
         ("flash", "bfloat16", (32, 8, 128), 2, 4096, 4096),
         # one head: the heaviest (last) 128-row block alone bounds the
         # whole shape's time when the grid has about one item an SM
         ("flash", "bfloat16", (1, 1, 128), 1, 1024, 1024),
         ("flash", "bfloat16", (1, 1, 256), 1, 1024, 1024),
         ("flash", "bfloat16", (1, 1, 128), 2, 4096, 4096)]
# paged flash at a mixed chunk (kernel, dtype, (Hkv, G, dh), page, window);
# the bf16 chunk cases are chip_smoke.py's PAGED_FLASH_CASES, and CHUNK_*
# its CHUNK_* (tests/test_torch_chip_smoke.py holds them equal):
# agent-7b's heads at pages of 128 and 16 (bf16 and f32), gemma3-27b's
# under its 1024 window, kimi-k2's G 8 at dh 112, arctic's 56 over 8,
# Gemma 3 12B's dh 256, agent-7b's width at d_head 512, dh 100; then
# (..., start, rows, pad rows) agent-7b's 1024-token prompt prefilled
# whole through the table, the flash forward's timed shape (B 1, S = T =
# 1024 causal)
PAGED_FLASH_CASES = [("paged_flash", "bfloat16", (8, 4, 128), 128, -1),
                     ("paged_flash", "bfloat16", (8, 4, 128), 16, -1),
                     ("paged_flash", "bfloat16", (16, 2, 128), 128, 1024),
                     ("paged_flash", "bfloat16", (8, 8, 112), 128, -1),
                     ("paged_flash", "bfloat16", (8, 7, 128), 128, -1),
                     ("paged_flash", "bfloat16", (8, 2, 256), 128, -1),
                     ("paged_flash", "bfloat16", (8, 2, 512), 128, -1),
                     ("paged_flash", "bfloat16", (8, 4, 100), 128, -1),
                     ("paged_flash", "float32", (8, 4, 128), 128, -1),
                     ("paged_flash", "bfloat16", (8, 4, 128), 128, -1, 0,
                      1024, 0)]
# the chunk: rows at positions CHUNK_START onward, the last CHUNK_PAD
# pad rows, a table CHUNK_WIDTH slots wide
CHUNK_START, CHUNK_ROWS, CHUNK_PAD, CHUNK_WIDTH = 1024, 512, 8, 4096
# heads past 256, in column blocks: agent-7b's width at d_head 512 (16
# over 8), G 3 at 384, dh 300, 16 heads over 1; f32 at 512, and dh 1024
WIDE_CASES = [(kind, dtype, heads, b, n, t)
              for kind, b, n, t in (("flash", 1, 1024, 1024),
                                    ("flash_bwd", 1, 1024, 1024),
                                    ("paged", 8, 128, 0),
                                    ("ring", 8, 4096, 0))
              for dtype, heads in (
                  [("bfloat16", h) for h in ((8, 2, 512), (4, 3, 384),
                                             (8, 4, 300), (1, 16, 512))]
                  + [("float32", (8, 2, 512)), ("bfloat16", (2, 2, 1024)),
                     ("float32", (2, 2, 1024))])]


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


def digest(torch, outs) -> str:
    """The first 16 hex digits of the SHA-256 of the outputs' bytes."""
    h = hashlib.sha256()
    for t in outs:
        raw = t.detach().contiguous().cpu().view(-1).view(torch.uint8)
        h.update(raw.numpy().tobytes())
    return h.hexdigest()[:16]


def warm(torch, dev, seconds: float = 2.0) -> None:
    """Keep the card busy with bf16 matmuls for ``seconds``, so the first
    timed case does not run while its clocks ramp."""
    a = torch.randn((4096, 4096), device=dev, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()


def paged_flash_call(torch, k, dev, case, how: str = "kernel"):
    """A paged flash case's inputs (a mixed chunk drawn the way
    ``chip_smoke.py``'s ``paged_flash_case`` draws it, from another seed:
    a generator seeded by the case) and its call: ``how`` "kernel",
    "sdpa" (SDPA over the gathered contiguous K/V, the valid pairs its
    mask) or "gather" (``paged_view`` + ``attention_cached``)."""
    from repro_torch.models import attention

    _, dtype, (hkv, g, dh), page, window, *chunk = case
    start, rows, pad = chunk or (CHUNK_START, CHUNK_ROWS, CHUNK_PAD)
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(
        zlib.crc32(str(case).encode()))
    fill = rows - pad
    need = -(-(start + fill) // page)
    bt = torch.full((1, CHUNK_WIDTH // page), -1, dtype=torch.int32,
                    device=dev)
    bt[0, :need] = torch.randperm(need, generator=gen,
                                  device=dev).to(torch.int32)
    q_pos = torch.full((1, rows), -1, dtype=torch.int32, device=dev)
    q_pos[0, :fill] = start + torch.arange(fill, device=dev,
                                           dtype=torch.int32)
    q = torch.randn((1, rows, hkv * g, dh), generator=gen,
                    device=dev).to(dt)
    kp, vp = (torch.randn((need + 1, page, hkv, dh), generator=gen,
                          device=dev).to(dt) for _ in range(2))
    if how == "kernel":
        return lambda: (k.paged_flash_attention(q, kp, vp, bt, q_pos,
                                                window=window),)
    view = attention.paged_view(attention.PagedKVCache(kp, vp), bt)
    if how == "gather":
        return lambda: (attention.attention_cached(q, view, q_pos,
                                                   window=window),)
    sk, sv = (x.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
              for x in (view.k, view.v))
    sq = q.transpose(1, 2).contiguous()
    kpos, qp = view.kpos[:, None, :].long(), q_pos.long()[:, :, None]
    mask = (kpos >= 0) & (kpos <= qp)
    if window > 0:
        mask &= kpos > qp - window
    mask = mask[:, None]
    return lambda: (torch.nn.functional.scaled_dot_product_attention(
        sq, sk, sv, attn_mask=mask),)


def call_of(torch, k, dev, case, sdpa: bool = False):
    """The case's inputs, drawn from a generator seeded by the case, and
    a function of no arguments that makes the kernel call (with
    ``sdpa``, a forward case's SDPA call on the same inputs)."""
    if case[0] == "paged_flash":
        return paged_flash_call(torch, k, dev, case,
                                "sdpa" if sdpa else "kernel")
    kind, dtype, heads, b, n, t = case
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(
        zlib.crc32(str(case).encode()))

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)
    if kind in ("flash", "flash_bwd"):
        if len(heads) == 3 and case in WIDE_CASES:   # (Hkv, G, dh)
            heads = (heads[0] * heads[1], heads[0], heads[2])
        h, hkv, dh = heads
        q, kk, v = randn(b, n, h, dh), randn(b, t, hkv, dh), \
            randn(b, t, hkv, dh)
        if kind == "flash" and sdpa:
            sq = q.transpose(1, 2).contiguous()
            sk, sv = (x.transpose(1, 2).repeat_interleave(h // hkv, dim=1)
                      .contiguous() for x in (kk, v))
            return lambda: (torch.nn.functional.scaled_dot_product_attention(
                sq, sk, sv, is_causal=True),)
        if kind == "flash":
            return lambda: (k.flash_attention(q, kk, v, causal=True),)
        from repro_torch.kernels.flash_attention import (
            flash_attention_backward, flash_attention_forward)
        out, lse = flash_attention_forward(q, kk, v, causal=True)
        dout = randn(b, n, h, dh)
        return lambda: flash_attention_backward(q, kk, v, out, lse, dout,
                                                causal=True)
    hkv, g, dh = heads
    q = randn(b, 1, hkv * g, dh)
    if kind == "ring":
        last = torch.tensor(CTX, device=dev)[:, None] - 1
        slot = torch.arange(n, device=dev)[None]
        kpos = last - torch.remainder(last - slot, n)
        kpos = torch.where(kpos >= 0, kpos, -1).to(torch.int32)
        kc, vc = randn(b, n, hkv, dh), randn(b, n, hkv, dh)
        q_pos = (last[:, 0]).to(torch.int32)
        return lambda: (k.decode_attention(q, kc, vc, kpos, q_pos),)
    page = n
    pages = [-(-c // page) for c in CTX]
    p_max = 4096 // page
    perm = torch.randperm(sum(pages), generator=gen, device=dev)
    bt = torch.full((b, p_max), -1, dtype=torch.int32, device=dev)
    at = 0
    for r, p in enumerate(pages):
        bt[r, :p] = perm[at:at + p].to(torch.int32)
        at += p
    kp = randn(sum(pages) + 1, page, hkv, dh)
    vp = randn(sum(pages) + 1, page, hkv, dh)
    ctx = torch.tensor(CTX, dtype=torch.int32, device=dev)
    return lambda: (k.paged_decode_attention(q, kp, vp, bt, ctx),)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the source tree whose repro_torch is timed")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cases", choices=("old", "wide", "all"),
                    default="all", help="the shapes up to dh 256, those "
                    "past it, or both")
    ap.add_argument("--kinds", default="flash,flash_bwd,paged,ring",
                    help="the kernels to run, comma-separated (also "
                    "paged_flash)")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    k = importlib.import_module("repro_torch.kernels")
    dev = torch.device("cuda")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    print(json.dumps({"card": gpu.strip().splitlines()[0],
                      "src": str(Path(k.__file__).resolve())}), flush=True)
    kinds = set(args.kinds.split(","))
    cases = [c for c in {"old": CASES + PAGED_FLASH_CASES,
                         "wide": WIDE_CASES,
                         "all": CASES + WIDE_CASES + PAGED_FLASH_CASES
                         }[args.cases] if c[0] in kinds]
    if cases:
        warm(torch, dev)
    for case in cases:
        row = {"case": list(case)}
        try:
            call = call_of(torch, k, dev, case)
            with torch.no_grad():
                row["digest"] = digest(torch, call())
                iters = max(1, args.iters // (4 if case[0] == "flash_bwd"
                                              else 1))
                xs = sorted(cuda_ms(torch, call, iters) for _ in range(3))
            row.update(ms=xs[1], spread=xs[2] - xs[0])
            if case[0] in ("flash", "paged_flash"):
                call = call_of(torch, k, dev, case, sdpa=True)
                with torch.no_grad():
                    xs = sorted(cuda_ms(torch, call, iters)
                                for _ in range(3))
                row["sdpa_ms"] = xs[1]
            if case[0] == "paged_flash":
                call = paged_flash_call(torch, k, dev, case, "gather")
                with torch.no_grad():
                    xs = sorted(cuda_ms(torch, call, max(1, iters // 4))
                                for _ in range(3))
                row["gather_ms"] = xs[1]
        except (ValueError, RuntimeError, AttributeError) as e:
            row["error"] = str(e).splitlines()[0]
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
