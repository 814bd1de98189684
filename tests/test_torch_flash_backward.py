"""The flash backward's block loops, emulated on the CPU.

The CUDA kernels of ``csrc/flash_attention_bwd.cu`` cannot run here, so
this file emulates their walks in PyTorch and holds them to autograd
through ``flash_attention_plain`` (the backward's plain version), on the
same (q, k, v, dout):

* the D pre-pass: D = rowsum(dout * out), f32, ``out`` the forward's
  output in q's dtype;
* pass (a), dK/dV: one CTA per (b, KV head, block of keys) walks the G
  query heads of its group (or, where 128-key blocks would leave SMs
  idle, two warpgroups over 64 keys each walk half of them and add their
  sums) and, for each, the query tiles that can see its keys (the kernel's bounds: from the block's first key when causal,
  to its last key + window - 1 with a window), recomputing P from the
  forward's log-sum-exp; bf16 rounds P^T before P^T dout and dS^T before
  dS^T q, and a warpgroup (64 keys) skips a tile none of its pairs
  needs;
* pass (b), dQ: one CTA per (b, head, block of query rows) over the key
  tiles of the forward's walk, dS rounded to bf16, a warpgroup (64 rows)
  skipping a tile none of its pairs needs.

Tiles: bf16 (TMA + wgmma) takes 128-key dK/dV blocks of two 64-key
warpgroups over 64-query tiles, and 128-row dQ blocks of two 64-row
warpgroups over 64-key tiles, at every head width; f32 takes 32-key
blocks and 32-query tiles, and 64-row dQ blocks over 32-key tiles.
Cases: windows, a ragged S, T not a multiple of 128, G 12 and 16, dh
112 and 120, non-causal, and S > T under a window (rows with no valid
key: zero dq).  Tolerance, relative to each gradient's largest
magnitude: 2e-2 bf16, 2e-5 f32 (the repo's bands).
"""
import math

import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.kernels import (flash_attention,  # noqa: E402
                                 flash_attention_backward_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_lse_plain, flash_attention_plain)

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
WG_ROWS = 64              # bf16: keys (a) or query rows (b) of a warpgroup


def tiles(dtype, dh: int = 128) -> dict:
    """The kernels' tile sizes: keys per dK/dV block, queries per tile,
    query rows per dQ block, keys per dQ tile.  bf16 past dh 128 (the
    DH-256 body) takes one 64-row block a CTA in both passes; f32 there
    takes 16-row tiles and 32-row dQ blocks."""
    if dtype == torch.bfloat16:
        if dh > 128:
            return {"kb": 64, "qt": 64, "bq": 64, "kt": 64}
        return {"kb": 128, "qt": 64, "bq": 128, "kt": 64}
    if dh > 128:
        return {"kb": 32, "qt": 16, "bq": 32, "kt": 16}
    return {"kb": 32, "qt": 32, "bq": 64, "kt": 32}


def valid(i, j, s, t, causal, window):
    """(len(i), len(j)) bool: query rows i see keys j."""
    i, j = i[:, None], j[None, :]
    m = (i < s) & (j < t)
    if causal:
        m &= j <= i
        if window > 0:
            m &= j > i - window
    return m


def emulate(q, k, v, dout, causal, window, split_heads=False):
    """(dq, dk, dv) by the kernels' walks, in q's dtype.  bf16 past dh
    128 walks as the DH-256 body: P and dS once a tile, each of the two
    warpgroups adding its half of dh's columns (0-127 and the rest) of
    dK, dV and dQ."""
    b, s, h, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(dh)
    bf16 = q.dtype == torch.bfloat16
    rnd = (lambda x: x.to(torch.bfloat16).float()) if bf16 else (
        lambda x: x)
    tl = tiles(q.dtype, dh)
    # the warpgroups' columns: the whole dh, or its two halves
    halves = ([slice(0, 128), slice(128, dh)] if bf16 and dh > 128
              else [slice(0, dh)])
    out = flash_attention_plain(q, k, v, causal=causal, window=window)
    lse = flash_attention_lse_plain(q, k, causal=causal, window=window)
    d = (dout.float() * out.float()).sum(-1).transpose(1, 2)   # (B, H, S)
    qf, kf, vf, df = (x.float() for x in (q, k, v, dout))
    dq = torch.zeros(qf.shape)
    dk = torch.zeros(kf.shape)
    dv = torch.zeros(vf.shape)

    # pass (a): dK/dV; with ``split_heads`` 64-key blocks whose two
    # warpgroups take the first ceil(G / 2) heads and the rest, their sums
    # added in that order
    kb, qt = tl["kb"], tl["qt"]
    warp = WG_ROWS if bf16 else kb
    groups = [range(g)]
    if split_heads:
        kb, warp = WG_ROWS, WG_ROWS
        groups = [range(0, (g + 1) // 2), range((g + 1) // 2, g)]
    for bi in range(b):
        for kh in range(hkv):
            for k0 in range(0, t, kb):
                k1 = min(k0 + kb, t)
                q_begin, q_end = 0, s
                if causal:
                    q_begin = k0
                    if window > 0:
                        q_end = min(s, k1 - 1 + window)
                q_begin = q_begin // qt * qt
                parts = []
                for heads in groups:
                    pk = torch.zeros((k1 - k0, dh))
                    pv = torch.zeros((k1 - k0, dh))
                    for gi in heads:
                        hh = kh * g + gi
                        for i0 in range(q_begin, q_end, qt):
                            i = torch.arange(i0, min(i0 + qt, s))
                            for w0 in range(k0, k1, warp):
                                j = torch.arange(w0, min(w0 + warp, t))
                                m = valid(i, j, s, t, causal, window).T
                                if not m.any():   # the warp skips the tile
                                    continue
                                sc = kf[bi, j, kh] @ qf[bi, i, hh].T * scale
                                p = torch.where(
                                    m, torch.exp(sc - lse[bi, hh, i]), 0.0)
                                dp = vf[bi, j, kh] @ df[bi, i, hh].T
                                ds = p * (dp - d[bi, hh, i])
                                for c in halves:
                                    pv[j - k0, c] += rnd(p) @ df[bi, i, hh, c]
                                    pk[j - k0, c] += rnd(ds) @ qf[bi, i, hh, c]
                    parts.append((pk, pv))
                for pk, pv in parts:
                    dk[bi, k0:k1, kh] += pk
                    dv[bi, k0:k1, kh] += pv

    # pass (b): dQ
    bq, kt = tl["bq"], tl["kt"]
    warp = WG_ROWS if bf16 else 8 if dh <= 128 else 4
    for bi in range(b):
        for hh in range(h):
            kh = hh // g
            for q0 in range(0, s, bq):
                k_begin, k_end = 0, t
                if causal:
                    k_end = min(min(q0 + bq, s), t)
                    if window > 0:
                        k_begin = max(q0 - window + 1, 0)
                k_begin = k_begin // kt * kt
                for w0 in range(q0, min(q0 + bq, s), warp):
                    i = torch.arange(w0, min(w0 + warp, s))
                    for k0 in range(k_begin, k_end, kt):
                        j = torch.arange(k0, min(k0 + kt, t))
                        m = valid(i, j, s, t, causal, window)
                        if not m.any():
                            continue
                        sc = qf[bi, i, hh] @ kf[bi, j, kh].T * scale
                        p = torch.where(m, torch.exp(sc - lse[bi, hh, i, None]),
                                        0.0)
                        dp = df[bi, i, hh] @ vf[bi, j, kh].T
                        ds = p * (dp - d[bi, hh, i, None])
                        for c in halves:
                            dq[bi, i, hh, c] += rnd(ds) @ kf[bi, j, kh, c]
    return tuple(x.to(q.dtype) for x in (dq * scale, dk * scale, dv))


def live_rows(s, t, causal, window):
    i = torch.arange(s)
    return valid(i, torch.arange(t), s, t, causal, window).any(1)


def inputs(dtype, b, s, t, h, hkv, dh, causal, window, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen).to(dtype)
               for shape in ((b, s, h, dh), (b, t, hkv, dh), (b, t, hkv, dh)))
    dout = torch.randn((b, s, h, dh), generator=gen).to(dtype)
    # a row with no valid key: the plain version's uniform average would
    # give the keys a gradient the kernels (zeros) never give
    dout[:, ~live_rows(s, t, causal, window)] = 0
    return q, k, v, dout


def rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


CASES = [  # b, s, t, h, hkv, dh, causal, window
    (1, 200, 200, 8, 2, 32, True, -1),
    (2, 150, 150, 8, 2, 64, True, 40),
    (1, 77, 77, 4, 2, 32, True, -1),           # a ragged S
    (1, 130, 130, 12, 1, 120, True, 50),       # G 12, dh 120
    (1, 100, 100, 16, 1, 64, True, -1),        # G 16
    (1, 90, 170, 4, 2, 32, False, -1),         # non-causal, S < T
    (1, 170, 100, 8, 2, 64, True, 30),         # S > T: rows with no key
    (1, 190, 190, 8, 2, 128, True, -1),        # T not a multiple of 128
    (1, 150, 150, 16, 2, 112, True, 70),       # dh 112
    (1, 100, 260, 8, 2, 120, False, -1),       # dh 120, non-causal
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,t,h,hkv,dh,causal,window", CASES)
def test_backward_walks_match_plain_autograd(dtype, b, s, t, h, hkv, dh,
                                             causal, window):
    q, k, v, dout = inputs(dtype, b, s, t, h, hkv, dh, causal, window)
    got = emulate(q, k, v, dout, causal, window)
    want = flash_attention_backward_plain(q, k, v, dout, causal=causal,
                                          window=window)
    live = live_rows(s, t, causal, window)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        if name == "dq":
            assert not x[:, ~live].any()
            x, y = x[:, live], y[:, live]
        assert rel(x, y) <= TOL[dtype], name


@pytest.mark.parametrize("b,s,t,h,hkv,dh,causal,window", [
    (1, 200, 200, 8, 2, 64, True, -1),         # G 4
    (1, 100, 100, 10, 2, 64, True, 30),        # G 5: an odd split
    (1, 130, 130, 12, 1, 120, True, -1),       # G 12, dh 120
    (1, 90, 170, 4, 2, 112, False, -1)])       # G 2, non-causal, dh 112
def test_backward_heads_split_walk_matches_plain_autograd(b, s, t, h, hkv,
                                                          dh, causal,
                                                          window):
    """bf16's dK/dV pass where 128-key blocks would leave SMs idle: 64-key
    blocks whose two warpgroups split the group's heads and add their
    sums in one order; dq is the dQ pass's as before."""
    dtype = torch.bfloat16
    q, k, v, dout = inputs(dtype, b, s, t, h, hkv, dh, causal, window)
    got = emulate(q, k, v, dout, causal, window, split_heads=True)
    want = flash_attention_backward_plain(q, k, v, dout, causal=causal,
                                          window=window)
    live = live_rows(s, t, causal, window)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        if name == "dq":
            x, y = x[:, live], y[:, live]
        assert rel(x, y) <= TOL[dtype], name


def test_lse_plain_is_the_log_partition_of_the_forward():
    """out = exp(S - lse) V: the LSE the backward recomputes P from."""
    q, k, v, _ = inputs(torch.float32, 1, 50, 50, 4, 2, 32, True, 9)
    scale = 1 / math.sqrt(32)
    lse = flash_attention_lse_plain(q, k, causal=True, window=9)
    sc = torch.einsum("bshd,bthd->bhst", q,
                      k.repeat_interleave(2, dim=2)) * scale
    m = valid(torch.arange(50), torch.arange(50), 50, 50, True, 9)
    p = torch.where(m, torch.exp(sc - lse[..., None]), 0.0)
    out = torch.einsum("bhst,bthd->bshd", p, v.repeat_interleave(2, dim=2))
    torch.testing.assert_close(out, flash_attention_plain(q, k, v, window=9),
                               rtol=0, atol=1e-5)


def test_cpu_autograd_goes_through_the_plain_version():
    """On the CPU the wrapper is the plain version, which autograd
    differentiates; the backward's plain version is that gradient."""
    q, k, v, dout = inputs(torch.float32, 1, 40, 40, 4, 2, 32, True, -1)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad(out, leaves, dout)
    for x, y in zip(grads, flash_attention_backward_plain(q, k, v, dout)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
