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
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (decode_attention,  # noqa: E402
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


HEAD_DIMS = [32, 64, 112, 120, 128]
ALL_GROUPS = [1, 2, 4, 5, 6, 7, 8, 12, 16]


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
    args = case(cuda_device, torch.float32, 2, 2, 3, 64, 16, [40, 17])
    with pytest.raises(ValueError, match="no kernel"):   # G = 3
        paged_decode_attention(*args)
    for dh in (100, 136):               # not a multiple of 8; past 128
        args = case(cuda_device, torch.float32, 2, 2, 2, dh, 16, [40, 17])
        with pytest.raises(ValueError, match="a multiple of 8 up to 128"):
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
    (1, 100, 100, 2, 40, True, -1)])                # dh 40 on the 64 body
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
                                               (2, 40, 300, -1)])
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


@pytest.mark.cuda
def test_ring_kernels_reject_unsupported(cuda_device):
    fargs = flash_case(cuda_device, torch.float32, 1, 40, 40, 2, 3, 64)
    dargs = ring_case(cuda_device, torch.float32, [30, 17], 64, 2, 3, 64)
    before = (flash_attention.launches, decode_attention.launches)
    with pytest.raises(ValueError, match="no kernel"):       # G = 3
        flash_attention(*fargs)
    with pytest.raises(ValueError, match="no kernel"):
        decode_attention(*dargs)
    for dh in (100, 136):               # not a multiple of 8; past 128
        with pytest.raises(ValueError, match="a multiple of 8 up to 128"):
            flash_attention(*flash_case(cuda_device, torch.float32, 1, 40,
                                        40, 2, 2, dh))
        with pytest.raises(ValueError, match="a multiple of 8 up to 128"):
            decode_attention(*ring_case(cuda_device, torch.float32,
                                        [30, 17], 64, 2, 2, dh))
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
