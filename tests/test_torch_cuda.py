"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips without a GPU (a
CUDA kernel has no CPU mode).  The file imports no JAX, so it runs on a
machine with the card and no JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: 2e-5 f32, 2e-2 bf16, as the reference's kernel tests; 1e-4
f32 for ``ssm_scan``, the reference's own band for that kernel
(tests/test_kernels.py:253).  ``grouped_matmul``'s weights are scaled by
1/sqrt(d), as the model's are, so its outputs are O(1) and the absolute
bands mean what they mean for attention.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.kernels import (attention_combine,  # noqa: E402
                                 attention_combine_plain, decode_attention,
                                 flash_attention, grouped_matmul,
                                 paged_decode_attention, ssm_scan)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_plain)
from repro_torch.kernels.grouped_matmul import (  # noqa: E402
    grouped_matmul_plain)
from repro_torch.kernels.paged_decode_attention import (  # noqa: E402
    paged_decode_attention_plain)
from repro_torch.kernels.ssm_scan import ssm_scan_plain  # noqa: E402
from repro_torch.serving.graphs import WARMUP_RUNS  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def case(dev, dtype, b, hkv, g, dh, page, ctx, shared=1, seed=0):
    """Pool and block tables: ``shared`` leading pages common to every
    row, then private pages in a random physical order, -1 tails."""
    rng = np.random.default_rng(seed)
    p_max = -(-max(ctx) // page) + 1
    rows, nxt = [], shared
    for c in ctx:
        own = max(-(-c // page) - shared, 0)
        rows.append(list(range(shared)) + list(range(nxt, nxt + own)))
        nxt += own
    perm = rng.permutation(nxt)
    bt = np.full((b, p_max), -1, np.int32)
    for r, ids in enumerate(rows):
        if ctx[r] > 0:
            bt[r, :len(ids)] = perm[ids]
    q = rng.standard_normal((b, 1, hkv * g, dh))
    kp = rng.standard_normal((nxt + 1, page, hkv, dh))
    vp = rng.standard_normal((nxt + 1, page, hkv, dh))
    return ([torch.from_numpy(a).to(dev, dtype) for a in (q, kp, vp)]
            + [torch.from_numpy(bt).to(dev),
               torch.tensor(ctx, dtype=torch.int32, device=dev)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("g,dh,page,window", [(4, 128, 128, -1),
                                              (4, 128, 16, 512),
                                              (2, 32, 16, 24),
                                              (8, 64, 16, -1),
                                              (7, 128, 128, -1),  # arctic
                                              (7, 128, 16, 512),
                                              (1, 128, 32, 40)])
def test_paged_decode_kernel_matches_plain(cuda_device, dtype, g, dh, page,
                                           window):
    ctx = [1000, 999, 130, 1, 0]                    # row 4: inactive slot
    args = case(cuda_device, dtype, len(ctx), 2, g, dh, page, ctx)
    before = paged_decode_attention.launches
    out = paged_decode_attention(*args, window=window)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    want = paged_decode_attention_plain(*args, window=window)
    live = torch.tensor([c > 0 for c in ctx], device=cuda_device)
    torch.testing.assert_close(out[live].float(), want[live].float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.isfinite(out).all()


HEAD_DIMS = [32, 64, 100, 112, 120, 128, 200, 256]
ALL_GROUPS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 16, 48]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("g", ALL_GROUPS)
def test_paged_decode_split_kernel_every_head_dim_and_group(cuda_device,
                                                            dtype, dh, g):
    """The split-KV kernel at every head dim and group of the repo's
    configs, pages of 16 and 128, full attention and a window: live rows
    within the band, zeros for the ctx 0 row, and bit-identical outputs
    for the two identical rows 5 and 6."""
    ctx = [1000, 999, 130, 1, 0, 777, 777]
    live = torch.tensor([c > 0 for c in ctx], device=cuda_device)
    for page in (16, 128):
        args = case(cuda_device, dtype, len(ctx), 2, g, dh, page, ctx,
                    seed=g * 1000 + dh)
        args[0][6] = args[0][5]                     # the same query ...
        args[3][6] = args[3][5]                     # ... over the same pages
        for window in (-1, 200):
            before = paged_decode_attention.launches
            out = paged_decode_attention(*args, window=window)
            torch.cuda.synchronize()
            assert paged_decode_attention.launches == before + 1
            want = paged_decode_attention_plain(*args, window=window)
            torch.testing.assert_close(out[live].float(), want[live].float(),
                                       atol=TOL[dtype], rtol=TOL[dtype])
            assert torch.isfinite(out).all()
            assert not out[4].any()                 # no valid key: zeros
            assert torch.equal(out[5], out[6])


@pytest.mark.cuda
def test_paged_decode_kernel_rejects_unsupported(cuda_device):
    args = case(cuda_device, torch.float32, 2, 2, 2, 264, 16, [40, 17])
    with pytest.raises(ValueError, match="dh from 1 to 256"):   # past 256
        paged_decode_attention(*args)
    args = case(cuda_device, torch.float32, 2, 2, 2, 64, 16, [40, 17])
    args[1] = args[1].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        paged_decode_attention(*args)


def flash_case(dev, dtype, b, s, t, hkv, g, dh, seed=1):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape)).to(dev, dtype)
            for shape in ((b, s, hkv * g, dh), (b, t, hkv, dh),
                          (b, t, hkv, dh))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,t,g,dh,causal,window", [
    (1, 300, 300, 4, 128, True, -1),
    (2, 130, 130, 2, 64, True, 48),
    (1, 77, 77, 8, 32, True, 5),
    (1, 300, 300, 5, 64, True, 100),               # hymba-1.5b's G and dh
    (1, 300, 300, 7, 128, True, -1),               # arctic-480b's
    (1, 130, 130, 7, 128, True, 48),
    (1, 200, 90, 1, 128, False, -1),
    (2, 64, 64, 4, 64, False, -1),
    # the tensor-core tiles' edges: dh 32 ragged, B = 2, S > T under a
    # window (rows 263.. have no valid key), T under one 64-key tile
    (1, 77, 77, 4, 32, True, -1),
    (1, 900, 900, 4, 32, True, -1),
    (2, 300, 300, 4, 128, True, -1),
    (1, 400, 200, 5, 64, True, 64),
    (1, 64, 40, 2, 64, False, -1),
    # head dims on the 128-wide body with zero columns (kimi-k2's 112,
    # h2o-danube-3's 120) and groups 6, 12 and 16
    (1, 300, 300, 8, 112, True, -1),
    (2, 130, 130, 8, 112, True, 48),
    (1, 200, 90, 8, 112, False, -1),
    (1, 300, 300, 4, 120, True, -1),
    (1, 77, 77, 6, 120, True, 5),
    (1, 300, 300, 6, 64, True, -1),
    (1, 300, 300, 12, 128, True, 100),
    (1, 130, 130, 12, 120, True, -1),
    (1, 300, 300, 16, 128, True, -1),
    (1, 64, 40, 16, 120, False, -1),
    (1, 100, 100, 2, 40, True, -1),                 # dh 40 on the 64 body
    # the shapes the reference pads: dh 256 (Gemma 3) and 200 on the 256
    # body, dh 100 and 36 padded to 104 and 40, G 3, 9 and 48
    (1, 300, 300, 2, 256, True, -1),
    (2, 130, 130, 2, 256, True, 48),
    (1, 200, 90, 2, 256, False, -1),
    (1, 77, 77, 3, 200, True, 5),
    (1, 300, 300, 3, 128, True, -1),
    (1, 130, 130, 9, 100, True, 48),
    (1, 64, 40, 48, 128, False, -1),
    (1, 300, 300, 48, 36, True, -1)])
def test_flash_kernel_matches_plain(cuda_device, dtype, b, s, t, g, dh,
                                    causal, window):
    args = flash_case(cuda_device, dtype, b, s, t, 2, g, dh)
    before = flash_attention.launches
    out = flash_attention(*args, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(*args, causal=causal, window=window)
    # a row with no valid key: zeros from the kernel, the uniform average
    # from the plain version
    i = torch.arange(s, device=cuda_device)
    live = (torch.clamp(i - window + 1, min=0) <= torch.clamp(i, max=t - 1)
            if causal and window > 0 else torch.ones_like(i, dtype=bool))
    torch.testing.assert_close(out[:, live].float(), want[:, live].float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    assert not out[:, ~live].any()
    assert torch.isfinite(out).all()


def ring_case(dev, dtype, q_pos, slots, hkv, g, dh, seed=2):
    """Rings after writing positions 0..q_pos[b] at slot ``pos % slots``
    (wrapped where q_pos >= slots)."""
    rng = np.random.default_rng(seed)
    b = len(q_pos)
    last = np.asarray(q_pos)[:, None]
    kpos = last - np.mod(last - np.arange(slots)[None], slots)
    kpos = np.where(kpos >= 0, kpos, -1).astype(np.int32)
    return ([torch.from_numpy(rng.standard_normal(shape)).to(dev, dtype)
             for shape in ((b, 1, hkv * g, dh), (b, slots, hkv, dh),
                           (b, slots, hkv, dh))]
            + [torch.from_numpy(kpos).to(dev),
               torch.tensor(q_pos, dtype=torch.int32, device=dev)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("g,dh,slots,window", [(4, 128, 1024, -1),
                                               (4, 128, 384, 256),
                                               (2, 32, 64, 24),
                                               (8, 64, 300, -1),
                                               (5, 64, 384, 256),
                                               (7, 128, 1024, -1),
                                               (7, 128, 384, 256),
                                               (1, 128, 96, 40),
                                               # split-KV: 64 ranges of 64,
                                               # a ragged last range, one
                                               # range, hymba's wrapped
                                               # window ring
                                               (4, 128, 4096, -1),
                                               (4, 128, 3000, -1),
                                               (4, 128, 64, -1),
                                               (5, 64, 2048, 1024),
                                               # dh 112 and 120 with idle
                                               # tail lanes; G 6, and 12
                                               # and 16 as two chunks
                                               (8, 112, 1024, -1),
                                               (8, 112, 384, 256),
                                               (4, 120, 3000, -1),
                                               (6, 120, 384, 256),
                                               (6, 64, 1024, -1),
                                               (12, 128, 4096, -1),
                                               (12, 120, 384, 256),
                                               (16, 128, 1024, -1),
                                               (16, 112, 64, -1),
                                               (16, 120, 3000, -1),
                                               (2, 40, 300, -1),
                                               # dh 256 and 200 on the
                                               # 256 lanes (two loads a
                                               # lane in f32), dh 100 and
                                               # 36 element by element,
                                               # G 3, 9 and 48
                                               (2, 256, 1024, -1),
                                               (2, 256, 384, 256),
                                               (3, 200, 3000, -1),
                                               (3, 128, 1024, -1),
                                               (9, 100, 384, 256),
                                               (48, 128, 1024, -1),
                                               (4, 36, 64, -1),
                                               (48, 256, 300, -1)])
def test_decode_kernel_matches_plain(cuda_device, dtype, g, dh, slots,
                                     window):
    q_pos = [999, 998, 129, 0, 5000]
    args = ring_case(cuda_device, dtype, q_pos, slots, 2, g, dh)
    before = decode_attention.launches
    out = decode_attention(*args, window=window)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    want = decode_attention_plain(*args, window=window)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert torch.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("slots", [64, 1024])      # one split; sixteen
def test_decode_kernel_row_without_valid_slot_is_zero(cuda_device, dtype,
                                                      slots):
    """Row 1 (q_pos -1) has no valid slot, so every split of it is empty:
    the kernel writes zeros there and the other rows are untouched."""
    args = ring_case(cuda_device, dtype, [700, -1, 3000], slots, 2, 4, 128)
    out = decode_attention(*args)
    torch.cuda.synchronize()
    want = decode_attention_plain(*args)
    live = torch.tensor([True, False, True], device=cuda_device)
    torch.testing.assert_close(out[live].float(), want[live].float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    assert not out[1].any()


# ---------------------------------------------------------------------------
# A sequence-sharded ring: decode over a slot range with its log-sum-exp,
# and the ranks' combine
# ---------------------------------------------------------------------------


def lse_err(got, want) -> float:
    """|kernel - plain| of the log-sum-exps of the rows with a valid key;
    the empty rows' NEG_INF must agree exactly."""
    empty = want <= -5e29
    assert torch.equal(got <= -5e29, empty)
    return float((got - want).abs()[~empty].max()) if (~empty).any() else 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("g,dh,slots,window", [(4, 128, 1024, -1),
                                               (4, 128, 64, -1),
                                               (16, 128, 4096, -1),
                                               (5, 64, 2048, 1024),
                                               (1, 128, 384, 40),
                                               (8, 112, 1024, -1),
                                               (2, 256, 1024, -1),
                                               (3, 128, 4096, -1),
                                               (9, 100, 384, 40)])
@pytest.mark.parametrize("n", [2, 4])
def test_decode_kernel_with_lse_over_slot_ranges(cuda_device, dtype, g, dh,
                                                 slots, window, n):
    """Each of n ranges of the ring, as a rank of a sequence-sharded ring
    holds it: out and lse against the plain version, ranges empty for
    some rows (row 2 has no valid slot at all), the window's ring
    wrapped; out bit-equal to the call without the log-sum-exp; and the
    ranges' partials combined equal the whole ring's decode."""
    args = ring_case(cuda_device, dtype, [999, 130, -1, 5000], slots, 2, g,
                     dh)
    q, k, v, kpos, q_pos = args
    local = slots // n
    outs, lses = [], []
    for r in range(n):
        sl = slice(r * local, (r + 1) * local)
        # the rank's range, as its own contiguous shard
        sub = (q, *(t[:, sl].contiguous() for t in (k, v, kpos)), q_pos)
        before = decode_attention.launches
        out, lse = decode_attention(*sub, window=window, with_lse=True)
        torch.cuda.synchronize()
        assert decode_attention.launches == before + 1
        want, want_lse = decode_attention_plain(*sub, window=window,
                                                with_lse=True)
        torch.testing.assert_close(out.float(), want.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
        assert lse_err(lse, want_lse) <= 1e-4
        assert lse.dtype == torch.float32 and lse.shape == q.shape[::2]
        assert torch.equal(out, decode_attention(*sub, window=window))
        outs.append(out[:, 0])
        lses.append(lse)
    got = attention_combine(torch.stack(outs), torch.stack(lses))
    whole = decode_attention_plain(*args, window=window)[:, 0]
    live = torch.tensor([True, True, False, True], device=cuda_device)
    torch.testing.assert_close(got[live].float(), whole[live].float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    assert not got[~live].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_decode_kernel_on_a_view_of_some_kv_heads(cuda_device, dtype):
    """The KV heads a rank's query heads read, as a view of a ring that
    holds them all (a slot stride past Hkv * dh): bit-equal to the same
    heads copied out, with and without the log-sum-exp."""
    q, k, v, kpos, q_pos = ring_case(cuda_device, dtype, [700, 40, 3000],
                                     1024, 8, 4, 128)
    q2 = q[:, :, 8:16].contiguous()          # the query heads of KV 2, 3
    kv = (k[:, :, 2:4], v[:, :, 2:4])
    assert not kv[0].is_contiguous()
    for lse in (False, True):
        got = decode_attention(q2, *kv, kpos, q_pos, with_lse=lse)
        want = decode_attention(q2, *(t.contiguous() for t in kv), kpos,
                                q_pos, with_lse=lse)
        for a, b in zip(*((got, want) if lse else ((got,), (want,)))):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="contiguous ring"):
        decode_attention(q2, k[:, :, ::4], v[:, :, ::4], kpos, q_pos)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("r,b,h,dh", [(2, 8, 8, 128), (16, 8, 8, 128),
                                      (16, 3, 5, 64), (4, 2, 3, 112),
                                      (1, 4, 4, 32), (16, 8, 16, 256),
                                      (4, 3, 9, 100)])
def test_attention_combine_kernel_matches_plain(cuda_device, dtype, r, b, h,
                                                dh):
    """R ranks' partials of (B, H) rows: ranks with no valid key (NEG_INF)
    weigh 0, a row empty on every rank is zeros; launched once a call."""
    gen = torch.Generator(device=cuda_device).manual_seed(r * 100 + dh)
    outs = torch.randn((r, b, h, dh), generator=gen,
                       device=cuda_device).to(dtype)
    lses = 5 * torch.randn((r, b, h), generator=gen, device=cuda_device)
    lses[r // 2:, 0] = -1e30
    lses[:, 1] = -1e30
    before = attention_combine.launches
    got = attention_combine(outs, lses)
    torch.cuda.synchronize()
    assert attention_combine.launches == before + 1
    want = attention_combine_plain(outs, lses)
    assert got.dtype == dtype and got.shape == (b, h, dh)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert not got[1].any()


# tools/decode_digests.py on the parent tree (before the log-sum-exp),
# NVIDIA H100 80GB HBM3, 700.00 W; the tree with it printed the same
DIGESTS_BEFORE_LSE = {
    0: "de3dcf51d6b7326c",
    1: "6b0f91dd84ac9ead",
    2: "71b1be15f391a280",
    3: "5c5ba157cff0c2c7",
    4: "0a45af2b5b50494b",
    5: "fdede08bb3e5d43c",
    6: "30224fa02ca69e83",
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(7))
def test_decode_kernels_bit_equal_to_before_the_lse(cuda_device, case):
    """Both decode kernels' outputs on ``tools/decode_digests.py``'s fixed
    inputs, as digests of their bytes, equal those the kernels gave
    before ``common.cuh`` learnt the log-sum-exp (the same tool on the
    parent tree, on an H100)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import decode_digests
    from repro_torch import kernels

    spec = decode_digests.CASES[case]
    got = decode_digests.run(torch, kernels, cuda_device, spec)
    assert got == DIGESTS_BEFORE_LSE[case], spec


@pytest.mark.cuda
def test_ring_kernels_reject_unsupported(cuda_device):
    before = (flash_attention.launches, decode_attention.launches)
    with pytest.raises(ValueError, match="dh from 1 to 256"):  # past 256
        flash_attention(*flash_case(cuda_device, torch.float32, 1, 40, 40,
                                    2, 2, 264))
    with pytest.raises(ValueError, match="dh from 1 to 256"):
        decode_attention(*ring_case(cuda_device, torch.float32, [30, 17],
                                    64, 2, 2, 264))
    fargs = flash_case(cuda_device, torch.float32, 1, 40, 40, 2, 2, 64)
    fargs[1] = fargs[1].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(*fargs)
    assert (flash_attention.launches, decode_attention.launches) == before


def scan_case(dev, dtype, b, t, h, dk, dv, seed=3, shared_qk=False,
              decay=0.1, h0_scale=0.0):
    """The sweep's inputs; ``shared_qk`` broadcasts one q/k row over the
    heads with stride 0, as hymba's mamba branch does."""
    rng = np.random.default_rng(seed)
    nq = 1 if shared_qk else h
    q = torch.from_numpy(rng.standard_normal((b, t, nq, dk)) * 0.3)
    k = torch.from_numpy(rng.standard_normal((b, t, nq, dk)) * 0.3)
    v = torch.from_numpy(rng.standard_normal((b, t, h, dv)) * 0.3)
    la = torch.from_numpy(-rng.uniform(0, decay, (b, t, h)))
    h0 = torch.from_numpy(rng.standard_normal((b, h, dk, dv)) * h0_scale)
    q, k, v = (x.to(dev, dtype) for x in (q, k, v))
    if shared_qk:
        q, k = q.expand(b, t, h, dk), k.expand(b, t, h, dk)
    return q, k, v, la.to(dev, torch.float32), h0.to(dev, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,h,dk,dv,chunk,shared,decay,h0", [
    (1, 128, 2, 16, 16, 32, False, 0.1, 0.0),      # the JAX sweep
    (2, 96, 4, 32, 16, 32, False, 0.1, 0.0),
    (1, 64, 1, 64, 64, 64, False, 0.1, 0.0),
    (1, 64, 2, 16, 16, 16, False, 0.05, 0.5),      # non-zero h0
    (1, 1000, 50, 16, 64, 128, True, 1.0, 0.0),    # hymba, ragged, L ~ -60
    (2, 7, 3, 5, 33, 128, True, 0.5, 0.2)])        # odd sizes, one chunk
def test_ssm_scan_kernel_matches_plain(cuda_device, dtype, b, t, h, dk, dv,
                                       chunk, shared, decay, h0):
    args = scan_case(cuda_device, dtype, b, t, h, dk, dv, shared_qk=shared,
                     decay=decay, h0_scale=h0)
    before = ssm_scan.launches
    y, h_t = ssm_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + 1
    want_y, want_h = ssm_scan_plain(*args, chunk=chunk)
    tol = 1e-4 if dtype == torch.float32 else TOL[dtype]
    torch.testing.assert_close(y.float(), want_y.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h_t, want_h, atol=tol, rtol=tol)
    assert torch.isfinite(y).all() and y.dtype == dtype


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,h,dk,dv,chunk,decay,h0", [
    (1, 150, 2, 65, 513, 64, 0.1, 0.0),            # past the fast path's dk
    (1, 200, 2, 128, 513, 128, 0.1, 0.3),          # h0 != 0, ragged T
    (1, 100, 2, 512, 513, 32, 0.1, 0.2),           # mLSTM's widths
    (2, 77, 3, 512, 513, 128, 5.0, 0.0),           # strong decay, one chunk
    (1, 300, 4, 16, 64, 32, 5.0, 0.3),             # hymba widths, chunk 32
    (1, 130, 4, 64, 1024, 64, 0.1, 0.0),           # dv at its limit
    (1, 129, 2, 32, 40, 128, 0.1, 0.5)])           # a one-row last chunk
def test_ssm_scan_kernel_wide_states(cuda_device, dtype, b, t, h, dk, dv,
                                     chunk, decay, h0):
    """mLSTM's widths (dk 512, dv 513) and others past 64 on the tiled
    CUDA-core path, and the tensor-core path at chunks of 32, 64 and 128:
    q and k scaled by dk^-1/2 past 64, as mLSTM scales them, so y stays
    O(1)."""
    args = list(scan_case(cuda_device, dtype, b, t, h, dk, dv, decay=decay,
                          h0_scale=h0))
    if dk > 64:
        args[0] = (args[0].float() * (dk ** -0.5 / 0.3)).to(dtype)
        args[1] = (args[1].float() * (dk ** -0.5 / 0.3)).to(dtype)
    before = ssm_scan.launches
    y, h_t = ssm_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + 1
    want_y, want_h = ssm_scan_plain(*args, chunk=chunk)
    tol = 1e-4 if dtype == torch.float32 else TOL[dtype]
    torch.testing.assert_close(y.float(), want_y.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h_t, want_h, atol=tol, rtol=tol)
    assert torch.isfinite(y).all() and tuple(y.shape) == (b, t, h, dv)


@pytest.mark.cuda
def test_ssm_scan_kernel_is_deterministic(cuda_device):
    """No atomics: two calls give the same bits, on both phase-3 paths."""
    for dtype, dk in ((torch.bfloat16, 16), (torch.bfloat16, 128),
                      (torch.float32, 16)):
        args = scan_case(cuda_device, dtype, 1, 300, 3, dk, 64,
                         shared_qk=True, h0_scale=0.3)
        y1, h1 = ssm_scan(*args, chunk=128)
        y2, h2 = ssm_scan(*args, chunk=128)
        torch.cuda.synchronize()
        assert torch.equal(y1, y2) and torch.equal(h1, h2)


@pytest.mark.cuda
def test_ssm_scan_kernel_rejects_unsupported(cuda_device):
    before = ssm_scan.launches
    with pytest.raises(ValueError, match="dk 513"):       # past MAX_DK
        ssm_scan(*scan_case(cuda_device, torch.float32, 1, 40, 2, 513, 16))
    with pytest.raises(ValueError, match="dv 1025"):      # past MAX_DV
        ssm_scan(*scan_case(cuda_device, torch.float32, 1, 40, 1, 16, 1025))
    args = list(scan_case(cuda_device, torch.float32, 1, 40, 2, 16, 16))
    args[0] = args[0].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="unit stride"):
        ssm_scan(*args)
    with pytest.raises(ValueError, match="chunk"):
        ssm_scan(*scan_case(cuda_device, torch.float32, 1, 400, 2, 16, 16),
                 chunk=256)
    with pytest.raises(ValueError, match="no kernel"):
        ssm_scan(*(x.half() if i < 3 else x for i, x in enumerate(
            scan_case(cuda_device, torch.float32, 1, 40, 2, 16, 16))))
    assert ssm_scan.launches == before


def gm_case(dev, dtype, e, c, d, f, counts, seed=4, poison=False):
    """The dispatch buffer and expert weights (scaled by 1/sqrt(d), as
    the model's); ``poison`` puts NaN in the rows past each count and in
    the weights of every empty expert, which the kernel must not read."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((e, c, d)))
    w = torch.from_numpy(rng.standard_normal((e, d, f)) / np.sqrt(d))
    cnt = torch.tensor(counts, dtype=torch.int32)
    if poison:
        rows = torch.arange(c)[None, :] >= cnt[:, None]
        x[rows] = float("nan")
        w[cnt == 0] = float("nan")
    return x.to(dev, dtype), w.to(dev, dtype), cnt.to(dev)


def ref_counts(e, c):
    """The reference sweep's counts (tests/test_kernels.py:213-215)."""
    return [min(c, max(0, c - i * (c // max(e - 1, 1)))) for i in range(e)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("e,c,d,f,counts", [
    (4, 64, 128, 256, None),                       # the reference sweep
    (8, 32, 64, 64, None),
    (2, 128, 256, 128, None),
    (8, 8, 64, 96, [8, 0, 1, 5, 8, 0, 3, 2]),      # arctic smoke widths
    (8, 24, 64, 32, [24, 0, 1, 13, 7, 0, 24, 9]),  # kimi smoke widths
    (9, 40, 100, 33, [40, 33, 32, 31, 0, 1, 17, 8, 9]),  # ragged f and d
    (3, 5, 70, 130, [5, 2, 0]),                    # C below a row tile
    (4, 16, 72, 136, [16, 9, 0, 1]),               # d and f past a tile
    (3, 40, 64, 128, [40, 33, 7]),                 # two row blocks
    (4, 8, 7168, 4864, [0, 1, 8, 5]),              # arctic decode
    (3, 24, 4864, 7168, [24, 0, 17])])             # arctic w_out, prefill
def test_grouped_matmul_kernel_matches_plain(cuda_device, dtype, e, c, d, f,
                                             counts):
    counts = ref_counts(e, c) if counts is None else counts
    x, w, cnt = gm_case(cuda_device, dtype, e, c, d, f, counts)
    before = grouped_matmul.launches
    out = grouped_matmul(x, w, cnt)
    torch.cuda.synchronize()
    assert grouped_matmul.launches == before + 1
    assert out.dtype == dtype and tuple(out.shape) == (e, c, f)
    want = grouped_matmul_plain(x, w, cnt)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_grouped_matmul_kernel_reads_no_dead_row_or_expert(cuda_device,
                                                           dtype):
    """NaN in the rows past each count and in the empty experts' weights:
    the kernel's output is finite and zero there, as the TPU kernel's
    skip of empty row blocks implies."""
    counts = [16, 0, 3, 0, 9]
    x, w, cnt = gm_case(cuda_device, dtype, 5, 16, 96, 200, counts,
                        poison=True)
    out = grouped_matmul(x, w, cnt)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    for i, n in enumerate(counts):
        assert (out[i, n:] == 0).all()
    live = torch.arange(16, device=cuda_device)[None, :] < cnt[:, None]
    want = grouped_matmul_plain(torch.nan_to_num(x), w.nan_to_num(), cnt)
    torch.testing.assert_close(out[live].float(), want[live].float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
def test_grouped_matmul_kernel_rejects_unsupported(cuda_device):
    x, w, cnt = gm_case(cuda_device, torch.float32, 2, 8, 32, 16, [8, 1])
    before = grouped_matmul.launches
    with pytest.raises(ValueError, match="no kernel"):
        grouped_matmul(x.half(), w.half(), cnt)
    with pytest.raises(ValueError, match="int32"):
        grouped_matmul(x, w, cnt.long())
    with pytest.raises(ValueError, match="contiguous"):
        grouped_matmul(x.transpose(1, 2).contiguous().transpose(1, 2),
                       w, cnt)
    with pytest.raises(ValueError, match="share a dtype"):
        grouped_matmul(x, w.bfloat16(), cnt)
    assert grouped_matmul.launches == before


def gm_device_case(dev, e, c, d, f, counts, seed=5):
    """Expert-width inputs drawn on the card (kimi's weights are 11 GB in
    bf16): the dispatch buffer with NaN past each count, weights scaled
    by 1/sqrt(d) with NaN in every empty expert's."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    cnt = torch.tensor(counts, dtype=torch.int32, device=dev)
    x = torch.randn((e, c, d), generator=gen, device=dev).bfloat16()
    x[torch.arange(c, device=dev)[None, :] >= cnt[:, None]] = float("nan")
    w = torch.empty((e, d, f), dtype=torch.bfloat16, device=dev)
    for i in range(e):
        w[i] = torch.randn((d, f), generator=gen, device=dev).mul_(d ** -0.5)
    w[cnt == 0] = float("nan")
    return x, w, cnt


def routed(tokens, e, c, top_k, seed=6):
    """Per-expert loads of a top-k routing of ``tokens`` tokens (numpy),
    clamped to the capacity ``c``."""
    rng = np.random.default_rng(seed)
    ids = np.argsort(-rng.standard_normal((tokens, e)), axis=1)[:, :top_k]
    return np.minimum(np.bincount(ids.ravel(), minlength=e), c).tolist()


def check_live_rows(out, x, w, cnt):
    """Finite, zero past each count, and the live rows within the bf16
    band of the plain version."""
    assert torch.isfinite(out).all()
    c = x.shape[1]
    live = torch.arange(c, device=x.device)[None, :] < cnt[:, None]
    assert not out[~live].any()
    want = grouped_matmul_plain(torch.nan_to_num(x), torch.nan_to_num(w),
                                cnt)
    torch.testing.assert_close(out[live].float(), want[live].float(),
                               atol=TOL[torch.bfloat16],
                               rtol=TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("d,f", [(7168, 2048), (2048, 7168)],
                         ids=["w_in", "w_out"])
@pytest.mark.parametrize("tokens,c", [(8, 8), (1024, 32)],
                         ids=["decode", "prefill"])
def test_grouped_matmul_kernel_at_kimi_experts(cuda_device, d, f, tokens,
                                               c):
    """kimi-k2's expert products: 384 experts, d 7168 <-> f 2048, top-8,
    C 8 from a routing of 8 tokens and C 32 from 1024."""
    counts = routed(tokens, 384, c, 8)
    x, w, cnt = gm_device_case(cuda_device, 384, c, d, f, counts)
    before = grouped_matmul.launches
    out = grouped_matmul(x, w, cnt)
    torch.cuda.synchronize()
    assert grouped_matmul.launches == before + 1
    check_live_rows(out, x, w, cnt)


@pytest.mark.cuda
@pytest.mark.parametrize("counts", [[0] * 12, [0] * 11 + [8],
                                    [8] + [0] * 11, [3] + [0] * 11],
                         ids=["all-dead", "last-live", "first-live",
                              "one-row"])
def test_grouped_matmul_kernel_dead_and_single_experts(cuda_device, counts):
    """Every expert dead (zeros, no weight read), or one live: 7 units of
    128 columns for 132 CTAs."""
    x, w, cnt = gm_device_case(cuda_device, 12, 8, 4096, 896, counts)
    out = grouped_matmul(x, w, cnt)
    torch.cuda.synchronize()
    check_live_rows(out, x, w, cnt)


@pytest.mark.cuda
@pytest.mark.parametrize("n_live,extra", [(0, 1), (0, -1), (-4, 0)],
                         ids=["ragged-tail", "half-tile", "fewer-than-sms"])
def test_grouped_matmul_kernel_units_not_dividing_sms(cuda_device, n_live,
                                                      extra):
    """Units that do not divide the CTAs: 7 column tiles per live expert
    and SMs / 7 live experts, give or take, so the stride walk ends
    ragged (or, with fewer units than CTAs, leaves CTAs idle)."""
    from repro_torch.kernels.grouped_matmul import sm_count
    sms = sm_count(cuda_device)
    live = max(1, sms // 7 + n_live)
    f = 7 * 128 + 8 * extra if extra > 0 else 7 * 128
    if extra < 0:
        f -= 64                          # a half tile at the end
    e, c, d = live + 3, 8, 1024
    counts = [1 + i % 8 for i in range(live)] + [0, 0, 0]
    x, w, cnt = gm_device_case(cuda_device, e, c, d, f, counts)
    out = grouped_matmul(x, w, cnt)
    torch.cuda.synchronize()
    check_live_rows(out, x, w, cnt)


@pytest.mark.cuda
@pytest.mark.parametrize("counts", [[8, 0, 3, 1, 0, 5, 2, 8, 7, 6, 4, 8],
                                    [8] + [0] * 11],
                         ids=["several", "one-live"])
def test_grouped_matmul_kernel_is_bit_identical(cuda_device, counts):
    """Two calls give the same bits: the unit walk is fixed and each
    output is one CTA's sum over d in order, with no float atomics.  Ten
    live experts make 160 units, one makes 16."""
    x, w, cnt = gm_device_case(cuda_device, 12, 8, 7168, 2048, counts)
    a = grouped_matmul(x, w, cnt)
    b = grouped_matmul(x, w, cnt)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("c", range(8, 80, 8))
def test_grouped_matmul_kernel_every_row_count(cuda_device, c):
    """Every instantiated unit height (C 8 .. 64, and 72 as a block of 64
    and one of 8), with 128-column units up to C 16 and 256 past it,
    against the plain version with ragged rows."""
    counts = [c, 0, 1, c // 2 + 1, 0, c - 3]
    x, w, cnt = gm_device_case(cuda_device, 6, c, 1024, 640, counts)
    out = grouped_matmul(x, w, cnt)
    torch.cuda.synchronize()
    check_live_rows(out, x, w, cnt)


# ---------------------------------------------------------------------------
# Serving steps replayed as CUDA graphs (serving/graphs.py)
# ---------------------------------------------------------------------------

def graph_case(dev, name):
    from repro_torch import models
    from repro_torch.configs import get_config, get_smoke

    cfg = (get_config(name) if name == "tiny-agent" else get_smoke(name))
    cfg = cfg.replace(dtype="bfloat16", use_pallas=True)
    params = models.init(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    return cfg, params


def step_engine(cfg, params, dev, layout, graphs, mixed=False):
    from repro_torch.serving.engine import TorchEngine
    from repro_torch.serving.scheduler import SchedulerConfig

    return TorchEngine(cfg, params, SchedulerConfig(
        max_slots=4, num_pages=64, page_size=16, max_context=256,
        max_batch_tokens=96, prefill_chunk=24 if mixed else 0, mixed=mixed),
        cache_layout=layout, device=dev, cuda_graphs=graphs)


def served_tokens(eng, lens=(40, 77, 19, 130, 64), max_new=8, seed=3):
    from repro_torch.core.types import Request

    rng = np.random.default_rng(seed)
    reqs = [Request(prompt_len=n, max_new_tokens=max_new,
                    prompt_tokens=rng.integers(0, eng.cfg.vocab, n)
                    .astype(np.int32)) for n in lens]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    assert all(len(r.output_tokens) == max_new for r in reqs)
    return [list(r.output_tokens) for r in reqs]


def moe_layers(cfg):
    return sum(seg.repeat * n for seg in cfg.plan()
               for spec, n in seg.pattern if spec.moe)


@pytest.mark.cuda
@pytest.mark.parametrize("name,layout,mixed", [
    ("tiny-agent", "paged", False), ("tiny-agent", "ring", False),
    ("tiny-agent", "paged", True), ("hymba-1.5b", "ring", False),
    ("arctic-480b", "paged", True), ("arctic-480b", "ring", False)])
def test_graph_replay_matches_eager_step(cuda_device, name, layout, mixed):
    """bf16, kernels on: the decode (and mixed) steps replayed as CUDA
    graphs give the eager steps' greedy ids, bit for bit, with five
    requests over four slots (admission churn); each step is captured
    once, and the decode kernels and grouped_matmul count exactly one
    launch per layer (three per MoE layer per forward) per body run,
    warm-up runs and replays alike."""
    cfg, params = graph_case(cuda_device, name)
    n, moe = cfg.n_layers, moe_layers(cfg)
    toks = {}
    for graphs in (True, False):
        eng = step_engine(cfg, params, cuda_device, layout, graphs, mixed)
        before = (paged_decode_attention.launches, decode_attention.launches,
                  grouped_matmul.launches)
        toks[graphs] = served_tokens(eng)
        torch.cuda.synchronize()
        runs = eng.step_runs
        assert eng.step_captures == ({"decode": 1, "mixed": 1} if mixed
                                     else {"decode": 1})
        if not mixed:                   # a graph adds its warm-up runs
            assert runs["decode"] == eng.decode_steps + (
                WARMUP_RUNS if graphs else 0)
        dec_kernel = (paged_decode_attention.launches - before[0]
                      if layout == "paged"
                      else decode_attention.launches - before[1])
        assert dec_kernel == n * (runs["decode"] + runs["mixed"])
        if moe and (mixed or layout == "ring"):
            prefills = 0 if mixed else 5            # ring: one per prompt
            assert grouped_matmul.launches - before[2] == 3 * moe * (
                prefills + runs["decode"] + 2 * runs["mixed"])
        eng.release_graphs()
    assert toks[True] == toks[False]


@pytest.mark.cuda
def test_graph_temperature_knob_and_generator(cuda_device):
    """The temperature knob moves at the next replay with no new capture,
    and the registered generator advances on every replay."""
    cfg, params = graph_case(cuda_device, "tiny-agent")
    greedy = served_tokens(step_engine(cfg, params, cuda_device, "paged",
                                       True), lens=(30,), max_new=12)
    eng = step_engine(cfg, params, cuda_device, "paged", True)
    from repro_torch.core.types import Request
    p = np.random.default_rng(3).integers(0, cfg.vocab, 30).astype(np.int32)
    r = Request(prompt_len=30, max_new_tokens=12, prompt_tokens=p)
    eng.submit(r)
    offsets = []
    while r.state.value != "finished":
        if r.generated == 4:
            eng.set_param("temperature", 1e4)
        eng.step()
        offsets.append(eng._gen.get_offset())
    assert eng.step_captures["decode"] == 1
    assert r.output_tokens[:4] == greedy[0][:4]
    assert r.output_tokens[4:] != greedy[0][4:]
    assert all(b > a for a, b in zip(offsets[2:], offsets[3:]))


@pytest.mark.cuda
def test_failed_capture_raises(cuda_device):
    """No fallback: a host sync in the body fails the eager warm-up (sync
    debug mode "error"), and one that shows only inside the capture
    fails the capture; both raise, and nothing is counted as captured."""
    from repro_torch.serving.graphs import StepGraph

    spec = {"a": ((4,), torch.float32)}
    g = StepGraph(lambda a: a * 2 + a.sum().item(), spec, cuda_device,
                  graphed=True)
    with pytest.raises(RuntimeError):
        g.run(a=np.ones(4, np.float32))
    assert g.captures == 0
    assert torch.cuda.get_sync_debug_mode() == 0

    def late_sync(a):
        if torch.cuda.is_current_stream_capturing():
            a.sum().item()
        return a * 2

    g = StepGraph(late_sync, spec, cuda_device, graphed=True)
    with pytest.raises(RuntimeError):
        g.run(a=np.ones(4, np.float32))
    assert g.captures == 0
    ok = StepGraph(lambda a: a * 2, spec, cuda_device, graphed=True)
    assert ok.run(a=np.arange(4, dtype=np.float32)).tolist() == [0, 2, 4, 6]


# ---------------------------------------------------------------------------
# Tool-call suspend on the card: the host tier and the pin tier
# ---------------------------------------------------------------------------

def parked_run(eng, tier, at=4, hold=6, max_new=12):
    """Serve one request; after ``at`` tokens suspend it to ``tier``
    ("pin" or "host"), run ``hold`` steps of a second request beside it,
    resume and finish.  Returns (its tokens, the host-store leaves at
    the suspend, device memory before and after it, ``pos`` of the slot
    at the suspend and at the resume)."""
    from repro_torch.core.types import Request
    from repro_torch.serving import cache_utils

    rng = np.random.default_rng(3)
    p, q = (rng.integers(0, eng.cfg.vocab, n).astype(np.int32)
            for n in (40, 77))
    r = Request(prompt_len=40, max_new_tokens=max_new, prompt_tokens=p)
    eng.submit(r)
    while r.generated < at:
        eng.step()
    eng.set_param("host_capacity_pages", 32)
    pos = [int(eng.cache["pos"][r.slot])]
    mem = [torch.cuda.memory_allocated()]
    assert eng.suspend_request(r, offload=tier == "host") == tier
    mem.append(torch.cuda.memory_allocated())
    leaves = (cache_utils._leaves(eng._host_store[r.req_id]["cache"])
              if tier == "host" else [])
    eng.submit(Request(prompt_len=77, max_new_tokens=max_new,
                       prompt_tokens=q))
    for _ in range(hold):
        eng.step()
    if tier == "pin":
        pos.append(int(eng.cache["pos"][r.slot]))
    assert eng.resume_suspended(r) == ("pin" if tier == "pin" else "hit")
    eng.run_until_idle()
    return list(r.output_tokens), leaves, mem, pos


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["paged", "ring"])
def test_host_tier_is_pinned_and_round_trips(cuda_device, layout):
    """A host-tier suspend copies the request's state into pinned host
    memory (its bytes the state's ``nbytes``) and frees device memory;
    the resume copies it back and the tokens are the unsuspended
    run's."""
    cfg, params = graph_case(cuda_device, "tiny-agent")
    want = served_tokens(step_engine(cfg, params, cuda_device, layout, True),
                         lens=(40,), max_new=12)[0]
    eng = step_engine(cfg, params, cuda_device, layout, True)
    got, leaves, mem, _ = parked_run(eng, "host")
    assert leaves and all(t.device.type == "cpu" and t.is_pinned()
                          for t in leaves)
    assert mem[1] <= mem[0]
    assert got == want


@pytest.mark.cuda
@pytest.mark.parametrize("mixed", [False, True], ids=["decode", "mixed"])
def test_pinned_slot_kept_across_replays(cuda_device, mixed):
    """A slot pinned while the captured decode (and mixed) graphs replay
    with another request's rows live: the live mask changes between
    replays, the pinned slot's ``pos`` does not, each step is captured
    once, and the resumed request gives the unsuspended run's tokens."""
    cfg, params = graph_case(cuda_device, "tiny-agent")
    want = served_tokens(step_engine(cfg, params, cuda_device, "paged", True,
                                     mixed), lens=(40,), max_new=12)[0]
    eng = step_engine(cfg, params, cuda_device, "paged", True, mixed)
    got, _, _, pos = parked_run(eng, "pin")
    assert pos[1] == pos[0] == 40 + 3
    assert eng.step_captures == ({"decode": 1, "mixed": 1} if mixed
                                 else {"decode": 1})
    assert got == want


# ---------------------------------------------------------------------------
# Every architecture: the kernels on the paths of xLSTM, the VLM, the
# encoder-decoder and the dense configs
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s,t", [(1000, 1000), (300, 1000), (1, 1000),
                                 (77, 130)])
def test_flash_non_causal_at_encoder_shapes(cuda_device, dtype, s, t):
    """seamless-m4t's encoder self attention (16 heads, dh 64, MHA) over
    T = 1000 frames, not a multiple of 128, and its decoder's cross
    attention of a prompt block over that memory: every key valid."""
    args = flash_case(cuda_device, dtype, 2, s, t, 16, 1, 64)
    out = flash_attention(*args, causal=False)
    torch.cuda.synchronize()
    want = flash_attention_plain(*args, causal=False)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cross_attention_decode_runs_the_ring_kernel(cuda_device, dtype):
    """A decode step's cross attention over 1000 encoder positions: the
    ring decode kernel with every key valid, against the masked core."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention, params as prm

    cfg = get_config("seamless-m4t-large-v2").replace(
        dtype=str(dtype).removeprefix("torch."))
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    p = prm.init_params(attention.attn_defs(cfg, cross=True), gen, dtype,
                        cuda_device)
    mem = torch.randn((4, 1000, cfg.d_model), generator=gen,
                      device=cuda_device).to(dtype)
    x = torch.randn((4, 1, cfg.d_model), generator=gen,
                    device=cuda_device).to(dtype)
    ckv = attention.cross_kv_precompute(p, mem)
    before = decode_attention.launches
    got = attention.cross_attention_cached(p, x, ckv,
                                           cfg.replace(use_pallas=True))
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    want = attention.cross_attention_cached(p, x, ckv, cfg)
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got.float() / scale, want.float() / scale,
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [300, 1000])
def test_ssm_scan_inside_mlstm_block(cuda_device, dtype, t):
    """An xlstm-350m mLSTM layer at full width (4 heads, dk 512, dv 513):
    the block with the kernel (one launch) against the block with the
    plain scan; the scan's outputs are large (|y| ~ 1e3 at the
    reference's init), so both are compared relative to their largest
    magnitude, with the scan's bands."""
    from repro_torch.configs import get_config
    from repro_torch.models import params as prm, ssm

    cfg = get_config("xlstm-350m").replace(
        dtype=str(dtype).removeprefix("torch."))
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    p = prm.init_params(ssm.mlstm_defs(cfg), gen, dtype, cuda_device)
    x = torch.randn((2, t, cfg.d_model), generator=gen,
                    device=cuda_device).to(dtype)
    before = ssm_scan.launches
    y, h = ssm.mlstm_block(p, x, cfg.replace(use_pallas=True))
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + 1
    want_y, want_h = ssm.mlstm_block(p, x, cfg)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    h_scale = want_h.abs().max()
    torch.testing.assert_close(h / h_scale, want_h / h_scale, atol=tol,
                               rtol=tol)
    # the block's output: the normalised y through the group norm and
    # down_proj, O(1)
    torch.testing.assert_close(y.float(), want_y.float(), atol=5 * tol,
                               rtol=5 * tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["qwen2-vl-2b", "command-r-plus-104b",
                                  "llama3-405b", "h2o-danube-3-4b",
                                  "gemma3-27b"])
def test_decode_kernels_at_served_heads(cuda_device, dtype, name):
    """Both decode kernels at the heads of the configs that serve them
    (G 6, 12, 16; danube's dh 120 with G 4; gemma3's G 2), at serve
    contexts, a wrapped window ring included."""
    from repro_torch.configs import get_config

    cfg = get_config(name)
    hkv, g, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.d_head
    ctx = [1000, 515, 130, 1, 0]
    args = case(cuda_device, dtype, len(ctx), hkv, g, dh, 128, ctx)
    live = args[4] > 0
    for window in (-1, 512):
        out = paged_decode_attention(*args, window=window)
        want = paged_decode_attention_plain(*args, window=window)
        torch.testing.assert_close(out[live].float(), want[live].float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
    for slots, window in ((1024, -1), (384, 256)):
        rargs = ring_case(cuda_device, dtype, [999, 514, 129, 0], slots, hkv,
                          g, dh)
        out = decode_attention(*rargs, window=window)
        want = decode_attention_plain(*rargs, window=window)
        torch.testing.assert_close(out.float(), want.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("name,layout,mixed", [
    ("xlstm-350m", "ring", False), ("qwen2-vl-2b", "paged", True),
    ("qwen2-vl-2b", "ring", False), ("gemma3-27b", "ring", False)])
def test_graph_replay_of_new_architectures(cuda_device, name, layout, mixed):
    """bf16, kernels on, at smoke size: replayed steps give the eager
    steps' greedy ids (the mLSTM and sLSTM states restored after a
    capture's warm-up; M-RoPE's 3-axis positions inside the mixed
    step's graph)."""
    cfg, params = graph_case(cuda_device, name)
    toks = {}
    for graphs in (True, False):
        eng = step_engine(cfg, params, cuda_device, layout, graphs, mixed)
        before = ssm_scan.launches
        toks[graphs] = served_tokens(eng)
        if name == "xlstm-350m":            # 4 mLSTM layers, 5 prompts
            assert ssm_scan.launches - before == 4 * 5
        eng.release_graphs()
    assert toks[True] == toks[False]


# ---------------------------------------------------------------------------
# Training: the flash backward, autograd and the gradient guard
# ---------------------------------------------------------------------------

def rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,t,g,dh,causal,window", [
    (1, 300, 300, 4, 128, True, -1),
    (2, 130, 130, 2, 64, True, 48),
    (1, 77, 77, 8, 32, True, 5),                   # a ragged S
    (1, 300, 300, 12, 120, True, 100),             # G 12, dh 120
    (1, 200, 200, 16, 128, True, -1),              # G 16
    (1, 200, 90, 4, 128, False, -1),               # non-causal
    (1, 400, 200, 5, 64, True, 64),                # rows with no valid key
    # 2 KV heads x B 2 x 36 blocks of 128 keys fill 132 SMs: the dK/dV
    # pass keeps 128-key blocks (every case above splits the heads)
    (2, 4600, 4600, 2, 64, True, 700),
    (2, 4600, 4600, 1, 128, True, -1),
    # the shapes the reference pads: dh 256 and 200 (one 64-row block a
    # CTA, each warpgroup half of dh's columns), dh 100 and 36 padded to
    # 104 and 40, G 3, 9 and 48
    (1, 300, 300, 2, 256, True, -1),
    (2, 130, 130, 3, 256, True, 48),
    (1, 200, 90, 2, 256, False, -1),
    (1, 400, 200, 2, 200, True, 64),
    (1, 300, 300, 3, 128, True, -1),
    (1, 333, 333, 9, 100, True, 100),
    (1, 200, 200, 48, 128, True, -1),
    (1, 77, 77, 3, 36, True, 5)])
def test_flash_backward_kernel_matches_plain(cuda_device, dtype, b, s, t, g,
                                             dh, causal, window):
    """dq, dk and dv of the backward kernels against autograd through
    the plain version, each within the band of its largest magnitude;
    dout is zero on rows with no valid key, whose dq is zero.  bf16 takes
    both ways of the dK/dV pass: 64-key blocks with the group's heads
    split between the warpgroups where 128-key blocks would leave SMs
    idle, and 128-key blocks otherwise (or at G = 1)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_backward_plain,
        flash_attention_forward)
    q, k, v = flash_case(cuda_device, dtype, b, s, t, 2, g, dh)
    out, lse = flash_attention_forward(q, k, v, causal=causal, window=window)
    i = torch.arange(s, device=cuda_device)
    live = (torch.clamp(i - window + 1, min=0) <= torch.clamp(i, max=t - 1)
            if causal and window > 0 else torch.ones_like(i, dtype=bool))
    dout = torch.randn(q.shape, generator=torch.Generator(
        device=cuda_device).manual_seed(3), device=cuda_device).to(dtype)
    dout[:, ~live] = 0
    got = flash_attention_backward(q, k, v, out, lse, dout, causal=causal,
                                   window=window)
    want = flash_attention_backward_plain(q, k, v, dout, causal=causal,
                                          window=window)
    torch.cuda.synchronize()
    assert rel_err(got[0][:, live], want[0][:, live]) <= TOL[dtype]
    assert not got[0][:, ~live].any()
    assert rel_err(got[1], want[1]) <= TOL[dtype]
    assert rel_err(got[2], want[2]) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,t,g,dh,causal,window", [
    (2, 300, 300, 4, 128, True, -1),
    (1, 333, 333, 5, 64, True, 100),
    (1, 200, 90, 8, 112, False, -1),
    (1, 300, 300, 2, 256, True, -1),
    (1, 130, 130, 3, 100, True, 48)])
def test_flash_backward_kernel_is_bit_identical(cuda_device, dtype, b, s, t,
                                                g, dh, causal, window):
    """Two calls on the same inputs give the same bits: no atomics, every
    sum in one fixed order (a supervised restart replays training)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_forward)
    q, k, v = flash_case(cuda_device, dtype, b, s, t, 2, g, dh)
    out, lse = flash_attention_forward(q, k, v, causal=causal, window=window)
    dout = torch.randn(q.shape, generator=torch.Generator(
        device=cuda_device).manual_seed(4), device=cuda_device).to(dtype)
    first = flash_attention_backward(q, k, v, out, lse, dout, causal=causal,
                                     window=window)
    again = flash_attention_backward(q, k, v, out, lse, dout, causal=causal,
                                     window=window)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [112, 120, 200])
@pytest.mark.parametrize("hkv,g,causal,window", [(8, 8, True, -1),
                                                 (3, 4, True, 70),
                                                 (2, 12, False, -1)])
def test_flash_backward_kernel_dh_past_a_box(cuda_device, dh, hkv, g,
                                             causal, window):
    """bf16 at dh 112 and 120 (kimi-k2's and h2o-danube-3's) on the
    128-wide body and 200 on the 256-wide one, random values in every
    head: a tensor-map box that
    read past dh into the next head's columns, or wrote past them, would
    change dq, dk or dv of a neighbouring head, the last one included."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_backward_plain,
        flash_attention_forward)
    dtype = torch.bfloat16
    q, k, v = flash_case(cuda_device, dtype, 1, 190, 190, hkv, g, dh, seed=6)
    out, lse = flash_attention_forward(q, k, v, causal=causal, window=window)
    dout = torch.randn(q.shape, generator=torch.Generator(
        device=cuda_device).manual_seed(8), device=cuda_device).to(dtype)
    got = flash_attention_backward(q, k, v, out, lse, dout, causal=causal,
                                   window=window)
    want = flash_attention_backward_plain(q, k, v, dout, causal=causal,
                                          window=window)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        for head in (0, x.shape[2] - 1):        # the first and last heads
            assert rel_err(x[:, :, head], y[:, :, head]) <= TOL[dtype]
        assert rel_err(x, y) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_under_grad_is_the_kernel_pair(cuda_device, dtype):
    """Under grad the wrapper launches the forward (with its LSE) and,
    in backward, the backward kernel, never the plain autograd; without
    grad it launches the forward alone."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_backward_plain)
    q, k, v = (x.requires_grad_(True) for x in flash_case(
        cuda_device, dtype, 2, 130, 130, 2, 4, 64))
    f0, b0 = flash_attention.launches, flash_attention_backward.launches
    out = flash_attention(q, k, v, causal=True, window=48)
    assert out.grad_fn is not None
    dout = torch.randn_like(out)
    got = torch.autograd.grad(out, (q, k, v), dout)
    assert (flash_attention.launches, flash_attention_backward.launches) \
        == (f0 + 1, b0 + 1)
    want = flash_attention_backward_plain(q, k, v, dout, causal=True,
                                          window=48)
    for x, y in zip(got, want):
        assert rel_err(x, y) <= TOL[dtype]
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None
    assert flash_attention_backward.launches == b0 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["paged_decode_attention",
                                   "decode_attention", "decode_with_lse",
                                   "attention_combine"])
def test_kernels_without_backward_refuse_grad(cuda_device, which):
    """The two decode wrappers and the combine, which have no backward,
    raise under grad, naming the ROADMAP item, instead of returning an
    output cut from the graph; under no_grad they launch as before."""
    dev, f32 = cuda_device, torch.float32
    if which == "paged_decode_attention":
        args = case(dev, f32, 2, 2, 4, 64, 16, [40, 7])
        fn, kw = paged_decode_attention, {"window": -1}
    elif which == "decode_with_lse":
        args = ring_case(dev, f32, [39, 6], 64, 2, 4, 64)
        fn, kw = decode_attention, {"window": -1, "with_lse": True}
    elif which == "attention_combine":
        args = [torch.randn((2, 3, 4, 64), device=dev),
                torch.randn((2, 3, 4), device=dev)]
        fn, kw = attention_combine, {}
    else:
        args = ring_case(dev, f32, [39, 6], 64, 2, 4, 64)
        fn, kw = decode_attention, {"window": -1}
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="ROADMAP A4.5"):
        fn(*args, **kw)
    before = fn.launches
    with torch.no_grad():
        fn(*args, **kw)
    assert fn.launches == before + 1


def gm_dout(x, f, seed=5):
    e, c = x.shape[:2]
    g = torch.Generator(device=x.device).manual_seed(seed)
    return torch.randn((e, c, f), generator=g, device=x.device).to(x.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("e,c,d,f,counts", [
    (4, 8, 64, 32, [8, 3, 0, 5]),                  # 0, C and ragged
    (3, 88, 256, 192, [88, 40, 0]),                # arctic's training C
    (2, 130, 72, 40, [130, 129]),                  # two dX row blocks
    (3, 24, 60, 36, [24, 0, 7]),                   # widths not of 8
    (5, 16, 128, 96, [0, 0, 0, 0, 0])])            # no token at all
def test_grouped_matmul_backward_kernel_matches_plain(cuda_device, dtype, e,
                                                      c, d, f, counts):
    """dx and dw of the backward kernels against autograd through the
    plain version, each within the band of its largest magnitude; rows
    past each count of dx and the dw of an expert no token chose are
    exactly zero.  The rows past the counts and the empty experts'
    weights hold NaN, which the kernels must not read."""
    from repro_torch.kernels.grouped_matmul import (
        grouped_matmul_backward, grouped_matmul_backward_plain)
    x, w, cnt = gm_case(cuda_device, dtype, e, c, d, f, counts, poison=True)
    dout = gm_dout(x, f)
    got = grouped_matmul_backward(x, w, cnt, dout)
    xs = torch.nan_to_num(x)
    ws = torch.nan_to_num(w)
    want = grouped_matmul_backward_plain(xs, ws, cnt, dout)
    torch.cuda.synchronize()
    rows = torch.arange(c, device=cuda_device)[None, :] \
        >= cnt[:, None]
    assert not got[0][rows].any()
    assert not got[1][cnt == 0].any()
    if any(counts):
        assert rel_err(got[0], want[0]) <= TOL[dtype]
        assert rel_err(got[1], want[1]) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("e,c,d,f,counts", [
    (6, 40, 136, 264, [0, 1, 15, 16, 17, 40]),     # the 16-row edges
    (3, 88, 7168, 512, [88, 0, 29]),               # arctic's d, train C
    (2, 200, 256, 520, [200, 65]),                 # stages and dX blocks
    # past the 1024 experts of dX's shared live list: every expert walked
    (1100, 8, 64, 32, [i % 9 for i in range(1100)])])
def test_grouped_matmul_backward_past_counts_and_bits(cuda_device, dtype, e,
                                                      c, d, f, counts):
    """x and dout hold NaN past every count and the empty experts'
    weights NaN: dx and dw stay finite and equal the plain backward's on
    the cleaned inputs (dW zeroes the rows from a count up to its
    multiple of 16 before the product); two calls give the same bits."""
    from repro_torch.kernels.grouped_matmul import (
        grouped_matmul_backward, grouped_matmul_backward_plain)
    x, w, cnt = gm_case(cuda_device, dtype, e, c, d, f, counts, poison=True)
    dout = gm_dout(x, f)
    dead = torch.arange(c, device=cuda_device)[None, :] >= cnt[:, None]
    dout[dead] = float("nan")
    got = grouped_matmul_backward(x, w, cnt, dout)
    again = grouped_matmul_backward(x, w, cnt, dout)
    want = grouped_matmul_backward_plain(torch.nan_to_num(x),
                                         torch.nan_to_num(w), cnt,
                                         torch.nan_to_num(dout))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.isfinite(g).all() for g in got)
    assert not got[0][dead].any() and not got[1][cnt == 0].any()
    assert rel_err(got[0], want[0]) <= TOL[dtype]
    assert rel_err(got[1], want[1]) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_grouped_matmul_under_grad_is_the_kernel_pair(cuda_device, dtype):
    """Under grad the wrapper launches the forward and, in backward, the
    backward kernels (one count), never the plain autograd; the
    gradients equal the direct backward call's bit for bit, twice."""
    from repro_torch.kernels.grouped_matmul import grouped_matmul_backward
    x, w, cnt = gm_case(cuda_device, dtype, 4, 24, 128, 64, [24, 9, 0, 1])
    x.requires_grad_(True)
    w.requires_grad_(True)
    f0, b0 = grouped_matmul.launches, grouped_matmul_backward.launches
    out = grouped_matmul(x, w, cnt)
    assert out.grad_fn is not None
    dout = gm_dout(x, 64)
    got = torch.autograd.grad(out, (x, w), dout)
    assert (grouped_matmul.launches, grouped_matmul_backward.launches) \
        == (f0 + 1, b0 + 1)
    for _ in range(2):
        again = grouped_matmul_backward(x.detach(), w.detach(), cnt, dout)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def scan_grads(x_shape, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(x_shape, generator=g, device=dev).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,h,dk,dv,chunk,shared,decay,h0,dh_t", [
    (1, 128, 2, 16, 16, 32, False, 0.1, 0.0, False),
    (2, 100, 3, 16, 64, 32, True, 0.5, 0.0, False),   # hymba's shared q/k
    (1, 77, 2, 8, 24, 16, False, 1.0, 0.5, True),     # ragged T, h0, dH_T
    (1, 260, 50, 16, 64, 128, True, 2.0, 0.0, False),  # hymba's heads
    (1, 200, 2, 512, 513, 128, False, 0.05, 0.2, True),  # mLSTM's width
    (1, 300, 3, 32, 64, 128, False, 0.3, 0.2, True),   # the dk 32 template
    (2, 200, 2, 64, 48, 128, False, 0.5, 0.0, True),   # the dk 64 template
    (1, 150, 2, 16, 72, 64, False, 0.3, 0.1, True),    # dv 72: tiled
    (2, 300, 2, 512, 513, 128, False, 0.1, 0.3, True)])  # mLSTM, 3 chunks
def test_scan_backward_kernel_matches_plain(cuda_device, dtype, b, t, h, dk,
                                            dv, chunk, shared, decay, h0,
                                            dh_t):
    """dq, dk, dv, dlog_a and dh0 of the backward kernels against autograd
    through the plain version, within 1e-4 (f32) / 2e-2 (bf16) of each
    output's largest magnitude; with q and k shared over the heads
    (stride 0) both give full-shape gradients, which autograd's expand
    sums in a model."""
    from repro_torch.kernels.ssm_scan import (ssm_scan_backward,
                                              ssm_scan_backward_plain)
    q, k, v, la, h0_ = scan_case(cuda_device, dtype, b, t, h, dk, dv,
                                 shared_qk=shared, decay=decay,
                                 h0_scale=h0)
    dy = scan_grads(v.shape, dtype, cuda_device, 6)
    dht = (scan_grads(h0_.shape, torch.float32, cuda_device, 7)
           if dh_t else None)
    got = ssm_scan_backward(q, k, v, la, h0_, dy, dht, chunk=chunk)
    want = ssm_scan_backward_plain(q, k, v, la, h0_, dy, dht, chunk=chunk)
    torch.cuda.synchronize()
    band = 1e-4 if dtype == torch.float32 else 2e-2
    for x, y in zip(got, want):
        assert x.shape == y.shape
        assert rel_err(x, y) <= band


@pytest.mark.cuda
def test_scan_backward_kernel_is_deterministic_at_mlstm_width(cuda_device):
    """Two bf16 runs of the tiled pass at the mLSTM's width (dk 512, dv
    513, three chunks, dH_T) give the same bits: no atomics, every sum
    in a fixed order, r's parts added in tile order."""
    from repro_torch.kernels.ssm_scan import ssm_scan_backward
    q, k, v, la, h0_ = scan_case(cuda_device, torch.bfloat16, 2, 300, 4,
                                 512, 513, decay=0.1, h0_scale=0.3)
    dy = scan_grads(v.shape, torch.bfloat16, cuda_device, 9)
    dht = scan_grads(h0_.shape, torch.float32, cuda_device, 10)
    first = ssm_scan_backward(q, k, v, la, h0_, dy, dht, chunk=128)
    again = ssm_scan_backward(q, k, v, la, h0_, dy, dht, chunk=128)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_scan_backward_at_hymba_width_allocates_no_pair_scratch(cuda_device):
    """One hymba-shaped bf16 backward call (B 1, T 1024, H 50, dk 16, dv
    64, q/k shared) raises the peak of allocated memory by no more than
    its outputs, its reverse chunk states (the size of the forward's) and
    8 MB: the fused pass writes no chunk x chunk pair matrices (52 MB at
    this shape in f32) and no f32 dq/dk."""
    scan_mod = importlib.import_module("repro_torch.kernels.ssm_scan")
    q, k, v, la, h0_ = scan_case(cuda_device, torch.bfloat16, 1, 1024, 50,
                                 16, 64, shared_qk=True, decay=1.0)
    dy = scan_grads(v.shape, torch.bfloat16, cuda_device, 11)
    _, h_t, states = scan_mod._launch(q, k, v, la, h0_, 128,
                                      keep_states=True)
    scan_mod._launch_backward(q, k, v, la, states, h_t, dy, None, 128)
    torch.cuda.synchronize()              # built and loaded
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    outs = scan_mod._launch_backward(q, k, v, la, states, h_t, dy, None, 128)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    out_bytes = sum(x.numel() * x.element_size() for x in outs)
    pair_bytes = 50 * 8 * 2 * 128 * 128 * 4
    assert rise <= out_bytes + states.numel() * 4 + 8 * 2 ** 20 < pair_bytes


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_scan_under_grad_is_the_kernel_pair(cuda_device, dtype):
    """Under grad the wrapper launches the forward and, in backward, the
    backward kernels (one count each), with no gradient for h_T when
    only y is used; the gradients equal a second run's bit for bit."""
    from repro_torch.kernels.ssm_scan import ssm_scan_backward
    args = scan_case(cuda_device, dtype, 2, 150, 4, 32, 48, h0_scale=0.3)
    runs = []
    for _ in range(2):
        xs = [a.detach().clone().requires_grad_(True) for a in args]
        f0, b0 = ssm_scan.launches, ssm_scan_backward.launches
        y, h_t = ssm_scan(*xs, chunk=64)
        assert y.grad_fn is not None
        dy = scan_grads(y.shape, dtype, cuda_device, 8)
        runs.append(torch.autograd.grad(y, xs, dy))
        assert (ssm_scan.launches, ssm_scan_backward.launches) \
            == (f0 + 1, b0 + 1)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["arctic-480b", "hymba-1.5b", "xlstm-350m",
                                  "qwen2-vl-2b", "seamless-m4t-large-v2"])
def test_family_gradients_on_the_card_match_the_plain_path(cuda_device,
                                                           name):
    """Each family's smoke, f32, with the kernels on against the plain
    path from the same weights: the loss within 1e-4 and every gradient
    leaf within 1e-2 of its largest magnitude (a backward that dropped or
    garbled a gradient is off by O(1)), with at least one forward and one
    backward launch of each kernel the family runs."""
    from repro_torch import models
    from repro_torch.configs import get_smoke
    from repro_torch.kernels.flash_attention import flash_attention_backward
    from repro_torch.kernels.grouped_matmul import grouped_matmul_backward
    from repro_torch.kernels.ssm_scan import ssm_scan_backward
    from repro_torch.models.params import flatten, unflatten

    base = get_smoke(name).replace(dtype="float32")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, base.vocab, (2, 40)).astype(
        np.int32)).to(cuda_device)
    batch = {"tokens": toks, "labels": toks}
    if base.frontend == "patch":
        batch["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, 8, base.d_model)).astype(np.float32)).to(cuda_device)
    if base.is_encdec:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, 24, base.d_model)).astype(np.float32)).to(cuda_device)
    params = models.init(base, torch.Generator(
        device=cuda_device).manual_seed(0), device=cuda_device)
    leaves, treedef = flatten(params)
    kinds = {spec.kind for seg in base.plan() for spec, _ in seg.pattern}
    fns = []
    if kinds - {"mlstm", "slstm"}:          # xlstm has no attention
        fns += [flash_attention, flash_attention_backward]
    if base.n_experts:
        fns += [grouped_matmul, grouped_matmul_backward]
    if base.family in ("hybrid", "ssm"):
        fns += [ssm_scan, ssm_scan_backward]
    runs = {}
    for kernels in (True, False):
        cfg = base.replace(use_pallas=kernels)
        before = [fn.launches for fn in fns]
        live = [p.detach().clone().requires_grad_(True) for p in leaves]
        loss, _ = models.loss_fn(unflatten(treedef, live), cfg, batch)
        grads = torch.autograd.grad(loss, live)
        torch.cuda.synchronize()
        runs[kernels] = (loss.item(), grads)
        used = [fn.launches - n for fn, n in zip(fns, before)]
        assert all(u > 0 for u in used) if kernels else not any(used)
    assert abs(runs[True][0] - runs[False][0]) <= 1e-4
    for x, y in zip(runs[True][1], runs[False][1]):
        assert rel_err(x, y) <= 1e-2


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_plain_path(cuda_device):
    """tiny-agent, f32, with the kernels on against the plain path
    (``use_pallas=False``) from the same weights: the loss within 1e-5
    and every gradient leaf within 1e-3 of its largest magnitude (a
    backward that dropped or garbled a gradient is off by O(1)); 2
    forward and 2 backward launches (2 layers, remat off); then one
    ``make_train_step`` on the card, its loss the same."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_backward
    from repro_torch.launch.train import (AdamWConfig, TrainPlan,
                                          make_train_step)
    from repro_torch.models.params import flatten, unflatten
    from repro_torch.optim.adamw import adamw_init

    base = get_config("tiny-agent").replace(dtype="float32", remat=False)
    toks = np.random.default_rng(0).integers(0, base.vocab, (2, 64))
    toks = torch.from_numpy(toks.astype(np.int32)).to(cuda_device)
    batch = {"tokens": toks, "labels": toks}
    params = models.init(base, torch.Generator(
        device=cuda_device).manual_seed(0), device=cuda_device)
    leaves, treedef = flatten(params)
    runs = {}
    for kernels in (True, False):
        cfg = base.replace(use_pallas=kernels)
        f0 = flash_attention.launches
        b0 = flash_attention_backward.launches
        live = [p.detach().clone().requires_grad_(True) for p in leaves]
        loss, _ = models.loss_fn(unflatten(treedef, live), cfg, batch)
        grads = torch.autograd.grad(loss, live)
        torch.cuda.synchronize()
        runs[kernels] = (loss.item(), grads)
        launched = (flash_attention.launches - f0,
                    flash_attention_backward.launches - b0)
        assert launched == ((2, 2) if kernels else (0, 0))
    assert abs(runs[True][0] - runs[False][0]) <= 1e-5
    for x, y in zip(runs[True][1], runs[False][1]):
        assert rel_err(x, y) <= 1e-3
    cfg = base.replace(use_pallas=True)
    acfg = AdamWConfig(lr=1e-3, warmup_steps=0)
    step = make_train_step(cfg, None, TrainPlan(), acfg, device=cuda_device)
    _, _, m = step(params, adamw_init(params, acfg), batch)
    assert abs(m["loss"].item() - runs[True][0]) <= 1e-5


@pytest.mark.cuda
def test_world1_nccl_mesh_steps_bit_equal_to_mesh_less(cuda_device,
                                                       tmp_path):
    """A world of one over NCCL, ``make_mesh((1, 1))``: tiny-agent with the
    kernels on, bf16.  make_prefill_step and make_serve_step give
    transformer.prefill's and decode_step's logits bit for bit, and one
    make_train_step(cfg, mesh) step with int8 moments gives the mesh-less
    step's parameters, moments and metrics bit for bit (deterministic
    algorithms)."""
    import torch.distributed as dist

    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import (AdamWConfig, TrainPlan,
                                          make_train_step)
    from repro_torch.models.params import flatten
    from repro_torch.optim.adamw import adamw_init

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        cfg = get_config("tiny-agent").replace(use_pallas=True)
        params = models.init(cfg, torch.Generator(
            device=cuda_device).manual_seed(0), device=cuda_device)
        b, s = 4, 48
        shape = ShapeConfig("d", s, b, "decode")
        pre, _ = serve.make_prefill_step(cfg, mesh, ShapeConfig(
            "p", s, b, "prefill"))
        dec, _ = serve.make_serve_step(cfg, mesh, shape)
        toks = torch.randint(0, cfg.vocab, (b, s), device=cuda_device)
        cache = serve.init_cache(cfg, mesh, shape)
        ref_cache = models.init_cache(cfg, b, s + 128, device=cuda_device)
        with torch.no_grad():
            got, cache = pre(params, toks, cache)
            want, ref_cache = models.prefill(params, cfg, toks, ref_cache)
            assert torch.equal(got, want)
            for _ in range(4):
                nxt = want.argmax(-1)[:, None]
                got, cache = dec(params, nxt, cache)
                want, ref_cache = models.decode_step(params, cfg, nxt,
                                                     ref_cache)
                assert torch.equal(got, want)
        acfg = AdamWConfig(lr=1e-3, warmup_steps=0, int8_moments=True)
        batch = {"tokens": toks[:2, :32], "labels": toks[:2, 1:33]}
        out = []
        for m in (None, mesh):
            p = models.init(cfg, torch.Generator(
                device=cuda_device).manual_seed(0), device=cuda_device)
            step = make_train_step(cfg, m, TrainPlan(int8_moments=True),
                                   acfg, device=cuda_device)
            out.append(step(p, adamw_init(p, acfg), batch))
        (p0, o0, m0), (p1, o1, m1) = out
        assert all(torch.equal(x, y) for x, y in zip(
            flatten((p0, o0))[0], flatten((p1, o1))[0]))
        assert all(torch.equal(m0[k], m1[k]) for k in m0)
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()


@pytest.mark.cuda
def test_two_gloo_ranks_share_the_card(cuda_device, tmp_path, monkeypatch):
    """chip_smoke's phase 38 ranks at smoke sizes: two gloo processes on
    the one card, TP and EP on (1, 2), DP + FSDP on (2, 1) and TP of the
    hymba, xlstm, qwen2-vl and seamless smokes on (1, 2), each config's
    tokens, loss and every gradient shard held to the unsharded model
    and every kernel call on a shard to its plain version; the (1, 2)
    train steps sequence parallel, remat keeping half the whole-S bytes
    at the layer boundaries; (g) the seamless smoke under a long shape
    on (2, 1), its cross K/V cut along the encoder axis; and (h) the
    (2, 1) state checkpointed and restored, and a supervised TP run
    resumed after a failure."""
    import json
    from pathlib import Path

    import torch.multiprocessing as mp

    root = Path(__file__).resolve().parents[1]
    monkeypatch.syspath_prepend(str(root))
    import chip_smoke

    sizes = {"tp": ("tiny-agent", {}), "ep": ("smoke:arctic-480b", {}),
             "serve_b": 2, "prompt": 16, "new": 16, "train_b": 2,
             "train_seq": 64, "gqa": ("tiny-agent", {"n_kv_heads": 1}),
             "gqa_b": 2, "gqa_prompt": 136, "long": ("tiny-agent", {}),
             "long_ring": 192, "long_prompt": 100,
             "families": [("smoke:hymba-1.5b", {}), ("smoke:xlstm-350m", {}),
                          ("smoke:qwen2-vl-2b", {}),
                          ("smoke:seamless-m4t-large-v2", {})],
             "frames": 12, "patches": 4, "grid": (2, 3),
             "cross": ("smoke:seamless-m4t-large-v2", {}),
             "sup": ("tiny-agent", {}, 2, 16, 6, 2, 4)}
    mp.start_processes(chip_smoke.sharded_rank,
                       args=(2, f"file://{tmp_path}/store", str(tmp_path),
                             "cuda", sizes), nprocs=2, start_method="spawn")
    res = [json.loads((tmp_path / f"rank{r}.json").read_text())
           for r in range(2)]
    for got in res:
        assert "error" not in got, got["error"]
    for key in ("tp", "ep", "dp"):
        # each rank holds its gradient shards to the unsharded model's
        for got in res:
            assert got[key]["grad_err"] <= 1e-2
            assert got[key]["loss_err"] <= 1e-4
        assert res[1][key]["loss"] == res[0][key]["loss"]
        assert res[1][key]["launches"] == res[0][key]["launches"]
        assert res[0][key]["launches"].get("flash_attention", 0) > 0
    for key in ("tp", "ep"):
        assert res[1][key]["tokens"] == res[0][key]["tokens"]
        assert sum(map(len, res[0][key]["tokens"])) == 32
    assert res[0]["ep"]["launches"].get("grouped_matmul", 0) > 0
    # sequence parallel on (1, 2): half the whole-S bytes; whole on (2, 1)
    for got in res:
        for c in [got["tp"], got["ep"], *got["families"]]:
            assert c["m"] == 2 and 2 * c["saved_bytes"] == c["whole_bytes"]
            assert c["peak_gb"] > 0
        assert got["dp"]["saved_bytes"] == got["dp"]["whole_bytes"]
    # (d), (e), (g): serving over a sequence-sharded ring (and in (g) a
    # cross K/V cut along its encoder axis), both ranks holding keys, the
    # log-sum-exp decode and the combine launched on each
    for got in res:
        assert got["cross"]["cross"] == [8, 16]
    for key, slots in (("gqa", [132, 264]), ("long", [96, 192]),
                       ("cross", [96, 192])):
        assert res[1][key]["tokens"] == res[0][key]["tokens"]
        assert res[0][key]["logits"] <= chip_smoke.SHARDED_LOGIT_TOL
        for got in res:
            assert got[key]["slots"] == slots
            assert got[key]["kernel_err"] <= 2e-5
            assert got[key]["launches"].get("decode_attention", 0) > 0
            assert got[key]["launches"].get("attention_combine", 0) > 0
    # (f): TP of the other families, each kernel of its path launched
    # (h): (c)'s state saved from (2, 1), restored three ways bit for bit
    # (the case raises otherwise), a TP step from it within its bands, and
    # a supervised run resumed after a failure bit-equal to one without
    for got in res:
        c = got["ckpt"]
        assert c["leaves"] == 61 and c["bytes"] > 0
        assert c["loss_err"] <= 1e-4 and c["grad_err"] <= 1e-2
        assert c["launches"].get("flash_attention", 0) > 0
        assert c["sup_losses"] == res[0]["ckpt"]["sup_losses"]
        assert c["sup_log"][-1] == "restarted at step 4"
    for i, (name, _) in enumerate(sizes["families"]):
        c0 = res[0]["families"][i]
        assert c0["logits"] <= chip_smoke.SHARDED_LOGIT_TOL
        for got in res:
            c = got["families"][i]
            assert c["tokens"] == c0["tokens"] and c["loss"] == c0["loss"]
            assert c["grad_err"] <= 1e-2 and c["loss_err"] <= 1e-4
            assert c["kernel_err"] <= 1e-4
            # at smoke width hymba's 2 KV heads divide the model axis, so
            # its rings are cut by heads and no combine runs
            want = chip_smoke.SHARDED_FAMILY_KERNELS[
                name.removeprefix("smoke:")] - {"attention_combine"}
            assert want <= set(c["launches"]), (name, c["launches"])


def _sp_card_rank(rank: int, tmp: str, out: str) -> None:
    """A gloo rank on the card (both ranks on CUDA device 0): the
    sequence-parallel collectives on CUDA tensors against their
    definitions, and the cross attention of a decode step over this
    rank's half of the encoder axis (ring decode with its log-sum-exp,
    then the combine kernel) against the whole K/V on one rank."""
    import json

    import torch.distributed as dist

    from repro_torch.configs import get_smoke
    from repro_torch.distributed import parallel
    from repro_torch.models import attention, init
    from repro_torch.models.attention import CrossKV

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            world_size=2, rank=rank)
    res = {}
    try:
        g = dist.group.WORLD

        def draw(seed, rows):
            return torch.from_numpy(np.random.default_rng(seed).normal(
                size=(2, rows, 3)).astype(np.float32)).to(dev)

        def run(fn, x, up):
            x = x.clone().requires_grad_(True)
            y = fn(x)
            y.backward(up)
            return y.detach(), x.grad

        whole = draw(0, 8)
        y, gx = run(lambda x: parallel.split_to(x, 1, g), whole,
                    draw(10 + rank, 4))
        res["split_to"] = max(
            (y - whole[:, 4 * rank:4 * rank + 4]).abs().max().item(),
            (gx - torch.cat([draw(10, 4), draw(11, 4)], 1)).abs().max()
            .item())
        y, gx = run(lambda x: parallel.scatter_from(x, 1, g),
                    draw(20 + rank, 8), draw(30 + rank, 4))
        res["scatter_from"] = max(
            (y - (draw(20, 8) + draw(21, 8))[:, 4 * rank:4 * rank + 4])
            .abs().max().item(),
            (gx - torch.cat([draw(30, 4), draw(31, 4)], 1)).abs().max()
            .item())
        y, gx = run(lambda x: parallel.own_rows(x, 1, g), whole,
                    draw(40, 8))
        res["own_rows"] = (gx[:, 4 * rank:4 * rank + 4]
                           - draw(40, 8)[:, 4 * rank:4 * rank + 4]
                           ).abs().max().item() + gx[
            :, 4 * (1 - rank):4 * (1 - rank) + 4].abs().max().item()

        cfg = get_smoke("seamless-m4t-large-v2").replace(
            dtype="float32", use_pallas=True)
        p = init(cfg, torch.Generator(device=dev).manual_seed(0),
                 device=dev)["decoder"][0]["e0"]["cross"]
        p = {k: v[0] for k, v in p.items()}
        attention.rescale_to_true_fan_in(p)
        gen = torch.Generator(device=dev).manual_seed(1)
        t = 16
        x = torch.randn((3, 1, cfg.d_model), generator=gen, device=dev)
        mem = torch.randn((3, t, cfg.d_model), generator=gen, device=dev)
        ckv = attention.cross_kv_precompute(p, mem, cfg)
        local = t // 2
        shard = parallel.RingShard(g, 2, rank, rank * local, local, t,
                                   "data")
        mine = CrossKV(*(u[:, rank * local:(rank + 1) * local].contiguous()
                         for u in ckv))
        d0, c0 = decode_attention.launches, attention_combine.launches
        got = attention.cross_attention_cached(p, x, mine, cfg, shard)
        res["launches"] = [decode_attention.launches - d0,
                           attention_combine.launches - c0]
        want = attention.cross_attention_cached(p, x, ckv, cfg)
        plain = attention.cross_attention_cached(
            p, x, mine, cfg.replace(use_pallas=False), shard)
        res["cross"] = (got - want).abs().max().item()
        res["cross_plain"] = (got - plain).abs().max().item()
    finally:
        from pathlib import Path
        Path(out, f"rank{rank}.json").write_text(json.dumps(res))
        dist.destroy_process_group()


@pytest.mark.cuda
def test_sequence_parallel_collectives_and_encoder_cut_cross_attention(
        cuda_device, tmp_path):
    """Two gloo ranks on the card: ``split_to``, ``scatter_from`` and
    ``own_rows`` along S on CUDA tensors, forward and backward, equal
    their definitions; a decode step's cross attention over each rank's
    half of a 16-position encoder axis (ring decode with its
    log-sum-exp, and the combine kernel) equals the whole K/V's on one
    rank within the f32 band, and its plain version's."""
    import json

    import torch.multiprocessing as mp

    from repro_torch.kernels import build

    build.build_all(["decode_attention", "attention_combine"])
    mp.start_processes(_sp_card_rank, args=(str(tmp_path), str(tmp_path)),
                       nprocs=2, start_method="spawn")
    for r in range(2):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert got["split_to"] == 0 and got["own_rows"] == 0, got
        assert got["scatter_from"] <= 1e-6, got
        assert got["launches"] == [1, 1], got
        assert got["cross"] <= TOL[torch.float32], got
        assert got["cross_plain"] <= TOL[torch.float32], got
