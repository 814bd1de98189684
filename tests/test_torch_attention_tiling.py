"""The arithmetic the attention kernels rest on, emulated on the CPU.

The CUDA kernels cannot run here, so this file holds emulations of their
designs in PyTorch and checks them against the plain versions:

* ring decode splits the ring into ranges of slots (``decode_splits``),
  each CTA's warps take 32-slot chunks of its range, and the partial
  softmax states (m in log2 units, l, unnormalised acc) merge by the
  rules of ``split_merge_kernel`` (``csrc/common.cuh``): an empty range
  writes m = NEG_INF, l = 0 and no acc, and a row with no valid slot comes
  out as zeros.  Held to ``decode_attention_plain`` within 1e-5 (f32).
* bf16 flash attention on the tensor cores walks 64-row query blocks of
  four 16-row warps over 64-key tiles with an online softmax in exp2
  units, masks only the tiles a warp does not wholly see as valid, skips
  the tiles none of its rows needs, and rounds P to bf16 before P V.
  Held to ``flash_attention_plain`` within the bf16 band 2e-2.
* paged decode splits each row's block table into ranges of whole pages
  (``paged_decode_splits``); each CTA takes one range, one KV head and a
  group chunk (past 5 heads, chunks of at most 4), walks the range's
  valid keys in four contiguous warp parts through its page ids, and the
  partial states merge as ring decode's do.  Held to
  ``paged_decode_attention_plain`` within 1e-5 (f32), with the scratch
  filled with NaN where no CTA writes.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.attention_shapes import (  # noqa: E402
    GROUPS, group_chunk)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    SPLIT_LENS, TARGET_CTAS, decode_attention_plain, decode_splits)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_plain)
from repro_torch.kernels.paged_decode_attention import (  # noqa: E402
    MAX_PAGES, paged_decode_attention_plain, paged_decode_splits)

NEG_INF = -1e30
LOG2E = 1.0 / math.log(2.0)
SPLIT_MAX = 1024           # csrc/decode_attention.cu: most slots of a CTA
NWARPS = 4                 # warps of a decode CTA
TQ, TK, WQ = 64, 64, 16    # flash: query rows, keys of a tile, rows a warp


# ---------------------------------------------------------------------------
# decode_splits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,hkv,t,want", [
    (8, 8, 4096, (16, 256)),       # agent-7b's and arctic's serve rings
    (8, 5, 4096, (16, 256)),       # hymba-1.5b's global ring
    (8, 5, 2048, (16, 128)),       # hymba's 1024-window ring
    (8, 8, 3000, (12, 256)),       # a ragged last range of 184 slots
    (5, 2, 1000, (16, 64)),        # too few rows for the target: 64 a CTA
    (8, 8, 64, (1, 64)),           # one range, no merge
    (2, 1, 40, (1, 64)),           # T under the smallest range
    (64, 8, 4096, (4, 1024))])     # many rows: the largest range
def test_decode_splits_at_serve_and_test_shapes(b, hkv, t, want):
    assert decode_splits(b, hkv, t) == want


def test_decode_splits_rule_over_a_grid():
    """splits = ceil(T / n); n is the largest of SPLIT_LENS that reaches
    TARGET_CTAS CTAs, else the smallest; never past the kernel's range."""
    for b in (1, 2, 5, 8, 33):
        for hkv in (1, 2, 5, 8):
            for t in (1, 40, 63, 64, 65, 300, 1000, 1536, 4096, 5000):
                splits, n = decode_splits(b, hkv, t)
                assert n in SPLIT_LENS and n <= SPLIT_MAX
                assert splits == -(-t // n) >= 1
                reach = [m for m in SPLIT_LENS
                         if b * hkv * -(-t // m) >= TARGET_CTAS]
                assert n == (max(reach) if reach else min(SPLIT_LENS))


@pytest.mark.parametrize("bad", [torch.tensor(8), np.int64(8), 8.0, True])
def test_decode_splits_takes_only_ints(bad):
    """The planner never reads a tensor (no host sync in a decode step):
    a tensor, a numpy scalar, a float or a bool is refused."""
    with pytest.raises(TypeError, match="takes ints"):
        decode_splits(bad, 8, 4096)
    with pytest.raises(TypeError, match="takes ints"):
        decode_splits(8, 8, bad)
    with pytest.raises(ValueError, match="positive"):
        decode_splits(8, 0, 4096)


# ---------------------------------------------------------------------------
# split-KV decode: split, then merge
# ---------------------------------------------------------------------------

def ring_inputs(q_pos, slots, hkv, g, dh, seed=0):
    """Rings after writing positions 0..q_pos[b] at slot ``pos % slots``;
    a row with q_pos -1 has no valid slot."""
    rng = np.random.default_rng(seed)
    b = len(q_pos)
    last = np.asarray(q_pos)[:, None]
    kpos = last - np.mod(last - np.arange(slots)[None], slots)
    kpos = np.where(kpos >= 0, kpos, -1).astype(np.int32)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)).float()
               for shape in ((b, 1, hkv * g, dh), (b, slots, hkv, dh),
                             (b, slots, hkv, dh)))
    return (q, k, v, torch.from_numpy(kpos),
            torch.tensor(q_pos, dtype=torch.int32))


def merge(states):
    """Fold partial states (m, l, acc) by the merge rule: weights
    exp2(m_s - M); a state with l = 0 contributes nothing and its acc is
    never read.  Returns the merged (m, l, acc)."""
    mx = torch.stack([m for m, _, _ in states]).amax(0)
    lsum = torch.zeros_like(mx)
    acc = torch.zeros(mx.shape + states[0][2].shape[-1:])
    for m, l, a in states:
        w = torch.exp2(m - mx)
        lsum = lsum + torch.where(l > 0, l * w, 0.0)
        acc = acc + torch.where((l > 0)[..., None], a * w[..., None], 0.0)
    return mx, lsum, acc


def partial(s, v, keep):
    """The partial state of the slots ``keep`` (B, Hkv, T) bool: scores
    ``s`` (B, Hkv, G, T) in log2 units, m from the finite NEG_INF.  Where
    no slot is kept, m = NEG_INF, l = 0 and acc is NaN (never read)."""
    s = s.masked_fill(~keep[:, :, None, :], -math.inf)
    m = torch.clamp(s.amax(-1), min=NEG_INF)
    p = torch.exp2(s - m[..., None])
    acc = torch.einsum("bhgt,bthd->bhgd", p, v)
    empty = ~keep.any(-1)[:, :, None]
    return (m.masked_fill(empty, NEG_INF), p.sum(-1).masked_fill(empty, 0.0),
            acc.masked_fill(empty[..., None], math.nan))


def split_decode_emulation(q, k, v, kpos, q_pos, window, split_len):
    """Ring decode as the split kernel and its merge compute it: ranges
    of ``split_len`` slots; in each, the warps' 32-slot chunks dealt
    round NWARPS warps, merged in shared memory; then the ranges."""
    b, _, h, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qs = q.reshape(b, hkv, h // hkv, dh) * (LOG2E / math.sqrt(dh))
    s = torch.einsum("bhgd,bthd->bhgt", qs, k)
    kp, qp = kpos.long(), q_pos.long()[:, None]
    valid = (kp >= 0) & (kp <= qp)
    if window > 0:
        valid &= kp > qp - window
    slot = torch.arange(t)
    chunk_warp = (slot % split_len) // 32 % NWARPS
    ranges = []
    for s0 in range(0, t, split_len):
        in_range = (slot >= s0) & (slot < s0 + split_len)
        warps = [partial(s, v, (valid & in_range & (chunk_warp == w))[:, None]
                         .expand(b, hkv, t))
                 for w in range(NWARPS)]
        m, l, acc = merge(warps)
        empty = l == 0                         # the CTA wrote only (m, l)
        ranges.append((m.masked_fill(empty, NEG_INF), l,
                       acc.masked_fill(empty[..., None], math.nan)))
    _, lsum, acc = merge(ranges)
    out = torch.where((lsum > 0)[..., None], acc / lsum[..., None], 0.0)
    return out.reshape(b, 1, h, dh)


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("slots,window,split_len", [
    (1024, -1, None),        # the planner's split
    (300, -1, 64),           # a ragged last range
    (384, 256, None),        # a wrapped ring under a window
    (2048, 1024, 256),       # hymba's window ring, wrapped
    (64, -1, 64),            # one range
    (1000, 40, 128)])        # a narrow window: most ranges empty
def test_split_then_merge_matches_plain(g, slots, window, split_len):
    q_pos = [999, 5000, 129, 0, -1, 3]           # row 4: no valid slot
    args = ring_inputs(q_pos, slots, 2, g, 32, seed=g)
    if split_len is None:
        split_len = decode_splits(len(q_pos), 2, slots)[1]
    got = split_decode_emulation(*args, window, split_len)
    want = decode_attention_plain(*args, window=window)
    live = torch.tensor(q_pos) >= 0
    assert torch.isfinite(got).all()             # no empty range poisons
    torch.testing.assert_close(got[live], want[live], atol=1e-5, rtol=1e-5)
    assert not got[~live].any()                  # zeros, not the average


def test_merge_of_empty_ranges_only_is_zero():
    """Two empty ranges (m = NEG_INF, l = 0, acc NaN) merge to l = 0, and
    the row comes out as zeros; one live range beside them wins alone."""
    empty = (torch.tensor([NEG_INF]), torch.tensor([0.0]),
             torch.full((1, 4), math.nan))
    live = (torch.tensor([3.0]), torch.tensor([2.0]),
            torch.tensor([[2.0, 4.0, 6.0, 8.0]]))
    _, l, acc = merge([empty, empty])
    assert l.item() == 0.0 and not acc.any()
    m, l, acc = merge([empty, live, empty])
    assert (m.item(), l.item()) == (3.0, 2.0)
    assert torch.equal(acc / l[:, None], torch.tensor([[1.0, 2.0, 3.0, 4.0]]))


# ---------------------------------------------------------------------------
# bf16 flash attention: the tensor-core tile loop
# ---------------------------------------------------------------------------

def warp_tile(w0, s, t, k0, causal, window):
    """The kernel's warp-uniform test of a tile: (need, full).  ``need``:
    some live row of the warp's 16 has a valid key in the tile; ``full``:
    every (row, key) pair of the tile is valid for the warp's live rows."""
    w_last = min(w0 + WQ - 1, s - 1)
    need, full = w0 < s, k0 + TK <= t
    if causal:
        need = need and k0 <= w_last
        full = full and k0 + TK - 1 <= w0
        if window > 0:
            need = need and k0 + TK - 1 > w0 - window
            full = full and k0 > w_last - window
    return need, full


def flash_tiles_emulation(q, k, v, causal, window):
    """bf16 flash attention as the tensor-core kernel computes it: f32
    scores of bf16 operands, masks only on tiles that are not full, the
    online softmax in exp2 units from the finite NEG_INF, P rounded to
    bf16 before P V, zeros for a row with no valid key."""
    b, s, h, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    c = LOG2E / math.sqrt(dh)
    out = torch.zeros(b, s, h, dh)
    for bi in range(b):
        for hi in range(h):
            kh = hi // g
            kf, vf = k[bi, :, kh].float(), v[bi, :, kh].float()
            for q0 in range(0, s, TQ):
                rows = torch.arange(q0, q0 + TQ)
                qf = torch.zeros(TQ, dh)
                qf[:min(TQ, s - q0)] = q[bi, q0:q0 + TQ, hi].float()
                k_begin, k_end = 0, t
                if causal:
                    k_end = min(q0 + TQ, s, t)
                    if window > 0:
                        k_begin = max(q0 - window + 1, 0)
                k_begin = k_begin // TK * TK
                m = torch.full((TQ,), NEG_INF)
                l = torch.zeros(TQ)
                acc = torch.zeros(TQ, dh)
                for k0 in range(k_begin, k_end, TK):
                    keys = torch.arange(k0, k0 + TK)
                    kt = torch.zeros(TK, dh)
                    vt = torch.zeros(TK, dh)    # ragged: zero-filled rows
                    kt[:min(TK, t - k0)] = kf[k0:k0 + TK]
                    vt[:min(TK, t - k0)] = vf[k0:k0 + TK]
                    sc = qf @ kt.T
                    ok = (keys < t)[None, :].expand(TQ, TK).clone()
                    if causal:
                        ok &= keys[None, :] <= rows[:, None]
                        if window > 0:
                            ok &= keys[None, :] > rows[:, None] - window
                    upd = torch.zeros(TQ, dtype=torch.bool)
                    for w in range(TQ // WQ):
                        r = slice(w * WQ, (w + 1) * WQ)
                        w0 = q0 + w * WQ
                        need, full = warp_tile(w0, s, t, k0, causal, window)
                        live = rows[r] < s
                        if not need:     # no live row of the warp is valid
                            assert not ok[r][live].any()
                            continue
                        if full:         # no mask: every pair is valid
                            assert ok[r][live].all()
                        else:
                            sc[r] = sc[r].masked_fill(~ok[r], -math.inf)
                        upd[r] = True
                    mx = torch.maximum(m, sc.amax(1))
                    alpha = torch.exp2((m - mx) * c)
                    p = torch.exp2(sc * c - (mx * c)[:, None])
                    pv = p.to(torch.bfloat16).float() @ vt
                    m = torch.where(upd, mx, m)
                    l = torch.where(upd, l * alpha + p.sum(1), l)
                    acc = torch.where(upd[:, None],
                                      acc * alpha[:, None] + pv, acc)
                o = torch.where((l > 0)[:, None],
                                acc / torch.clamp(l, min=1e-30)[:, None], 0.0)
                n = min(TQ, s - q0)
                out[bi, q0:q0 + n, hi] = o[:n]
    return out.to(torch.bfloat16)


def flash_inputs(b, s, t, h, hkv, dh, seed=1):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape)).to(torch.bfloat16)
            for shape in ((b, s, h, dh), (b, t, hkv, dh), (b, t, hkv, dh))]


def live_rows(s, t, causal, window):
    i = torch.arange(s)
    if not (causal and window > 0):
        return torch.ones(s, dtype=torch.bool)
    return torch.clamp(i - window + 1, min=0) <= torch.clamp(i, max=t - 1)


@pytest.mark.parametrize("dh", [32, 64, 128])
def test_flash_tiles_bf16_match_plain_at_1024(dh):
    """The 2-head cut of a 1024-token causal prefill: two query heads over
    one KV head, every tile of the causal triangle."""
    args = flash_inputs(1, 1024, 1024, 2, 1, dh, seed=dh)
    got = flash_tiles_emulation(*args, True, -1)
    want = flash_attention_plain(*args, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("b,s,t,dh,causal,window", [
    (1, 1000, 1000, 64, True, -1),     # ragged last query block and tile
    (2, 77, 77, 32, True, 5),          # B = 2, a narrow window
    (1, 900, 900, 128, True, 512),     # window-edge tiles
    (1, 400, 200, 64, True, 64),       # S > T: rows 263.. have no key
    (1, 200, 90, 128, False, -1),      # non-causal, ragged second tile
    (1, 64, 40, 32, False, -1)])       # non-causal, T under one tile
def test_flash_tiles_bf16_edges(b, s, t, dh, causal, window):
    args = flash_inputs(b, s, t, 2, 1, dh, seed=s)
    got = flash_tiles_emulation(*args, causal, window)
    want = flash_attention_plain(*args, causal=causal, window=window)
    live = live_rows(s, t, causal, window)
    torch.testing.assert_close(got[:, live].float(), want[:, live].float(),
                               atol=2e-2, rtol=2e-2)
    assert not got[:, ~live].any()


# ---------------------------------------------------------------------------
# paged_decode_splits and split-KV paged decode: split, then merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,hkv,p_max,page,want", [
    (8, 8, 32, 128, (16, 2)),      # the serve shapes: ranges of 2 pages
    (8, 8, 256, 16, (16, 16)),     # pages of 16: the same 256 slots
    (8, 8, 33, 128, (9, 4)),       # a ragged last range of one page
    (8, 8, 250, 16, (16, 16)),     # ... of 10 pages
    (8, 5, 8, 128, (8, 1)),        # one page a range, too few rows
    (2, 1, 3, 16, (1, 4)),         # one range, no merge
    (64, 8, 32, 128, (4, 8)),      # many rows: ranges of 1024 slots
    (1, 1, 4, 2048, (4, 1))])      # a page past the largest range
def test_paged_decode_splits_at_serve_and_test_shapes(b, hkv, p_max, page,
                                                      want):
    assert paged_decode_splits(b, hkv, p_max, page) == want


def test_paged_decode_splits_rule_over_a_grid():
    """Whole pages: per = min(max(n // page, 1), MAX_PAGES) for the
    largest n of SPLIT_LENS that reaches TARGET_CTAS, else the smallest;
    splits = ceil(P / per)."""
    for b in (1, 3, 8, 33):
        for hkv in (1, 5, 8):
            for p_max in (1, 7, 32, 33, 250, 1024):
                for page in (1, 16, 128, 256):
                    splits, per = paged_decode_splits(b, hkv, p_max, page)
                    cands = [min(max(n // page, 1), MAX_PAGES)
                             for n in SPLIT_LENS]
                    reach = [c for c in cands
                             if b * hkv * -(-p_max // c) >= TARGET_CTAS]
                    assert per == (reach[0] if reach else cands[-1])
                    assert 1 <= per <= MAX_PAGES
                    assert splits == -(-p_max // per) >= 1


@pytest.mark.parametrize("bad", [torch.tensor(8), np.int64(8), 8.0, True])
def test_paged_decode_splits_takes_only_ints(bad):
    """Shapes only: a tensor, a numpy scalar, a float or a bool is
    refused, so a decode step never syncs on a length."""
    for i in range(4):
        args = [8, 8, 32, 128]
        args[i] = bad
        with pytest.raises(TypeError, match="takes ints"):
            paged_decode_splits(*args)
    with pytest.raises(ValueError, match="positive"):
        paged_decode_splits(8, 8, 0, 128)


@pytest.mark.parametrize("g,chunk", [(1, 1), (2, 2), (4, 4), (5, 5),
                                     (6, 3), (7, 4), (8, 4), (12, 4),
                                     (16, 4), (9, 3), (10, 4)])
def test_group_chunk(g, chunk):
    """The whole group up to 5 heads, else the fewest chunks of at most 4;
    every chunk size of the repo's groups is an instantiated one."""
    assert group_chunk(g) == chunk
    if g in GROUPS:
        assert chunk in (1, 2, 3, 4, 5)


@pytest.mark.parametrize("bad", [torch.tensor(8), np.int64(8), 8.0])
def test_group_chunk_takes_only_ints(bad):
    with pytest.raises(TypeError, match="takes ints"):
        group_chunk(bad)
    with pytest.raises(ValueError, match="positive"):
        group_chunk(0)


def paged_split_emulation(q, kp, vp, bt, ctx, window, per):
    """Paged decode as the split kernel and its merge compute it: each
    (range of ``per`` pages, KV head, group chunk, row) is one CTA, which
    walks only the range's valid keys [s0, s1) in four contiguous warp
    parts through its page ids; a range with no valid key writes only (m,
    l) = (NEG_INF, 0).  The scratch starts as NaN, so a read of anything
    a CTA did not write would show.  Then split_merge_kernel."""
    b, _, h, dh = q.shape
    n_pool, page, hkv, _ = kp.shape
    g = h // hkv
    gc = group_chunk(g)
    p_max = bt.shape[1]
    splits = -(-p_max // per)
    qs = q[:, 0] * (LOG2E / math.sqrt(dh))                  # (B, H, dh)
    part_m = torch.full((b, h, splits), math.nan)
    part_l = torch.full((b, h, splits), math.nan)
    part_acc = torch.full((b, h, splits, dh), math.nan)
    out = torch.full((b, h, dh), math.nan)
    # (KV head, its query rows) of each CTA: a group chunk of KV head kh
    ctas = [(kh, slice(kh * g + c0, kh * g + min(c0 + gc, g)))
            for kh in range(hkv) for c0 in range(0, g, gc)]
    for bi in range(b):
        c = int(ctx[bi])
        hi = min(c, p_max * page)
        lo = max(c - window, 0) if window > 0 else 0
        for sp in range(splits):
            s0 = max(sp * per * page, lo)
            s1 = min((sp + 1) * per * page, hi)
            for kh, rows in ctas:                          # CTAs of the row
                if s0 >= s1:
                    if splits == 1:
                        out[bi, rows] = 0.0
                    else:
                        part_m[bi, rows, sp] = NEG_INF
                        part_l[bi, rows, sp] = 0.0
                    continue
                t = torch.arange(s0, s1)
                pids = bt[bi, t // page].long().clamp(0, n_pool - 1)
                k = kp[pids, t % page, kh]                  # (n, dh)
                v = vp[pids, t % page, kh]
                s = qs[bi, rows] @ k.T                      # (heads, n)
                wper = -(-(s1 - s0) // 4)
                warps = []
                for w in range(4):
                    part = slice(w * wper, min((w + 1) * wper, s1 - s0))
                    sw = s[:, part]
                    if sw.shape[1] == 0:                    # an idle warp
                        n = s.shape[0]
                        warps.append((torch.full((n,), NEG_INF),
                                      torch.zeros(n), torch.zeros(n, dh)))
                        continue
                    m = sw.amax(1)
                    p = torch.exp2(sw - m[:, None])
                    warps.append((m, p.sum(1), p @ v[part]))
                m, l, acc = merge(warps)
                if splits == 1:
                    out[bi, rows] = torch.where((l > 0)[:, None],
                                                acc / l[:, None], 0.0)
                else:
                    part_m[bi, rows, sp] = m
                    part_l[bi, rows, sp] = l
                    part_acc[bi, rows, sp] = acc
    if splits > 1:
        _, lsum, acc = merge([(part_m[..., sp], part_l[..., sp],
                               part_acc[..., sp, :])
                              for sp in range(splits)])
        out = torch.where((lsum > 0)[..., None], acc / lsum[..., None], 0.0)
    return out.reshape(b, 1, h, dh)


def paged_tables(ctx, page, p_max, rng, n_shared=1):
    """Tables of ``p_max`` entries: ``n_shared`` leading pages shared by
    every live row, then private pages in a shuffled order, -1 tails and
    an all -1 row where ctx is 0.  Returns (tables, pool pages)."""
    rows, nxt = [], n_shared
    for c in ctx:
        own = max(-(-c // page) - n_shared, 0)
        rows.append(list(range(n_shared)) + list(range(nxt, nxt + own))
                    if c > 0 else [])
        nxt += own
    perm = rng.permutation(nxt)
    bt = np.full((len(ctx), p_max), -1, np.int32)
    for r, ids in enumerate(rows):
        bt[r, :len(ids)] = perm[ids]
    return torch.from_numpy(bt), nxt + 1                 # + the sink page


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("page,p_max,window,per", [
    (16, 12, -1, None),        # the planner's split (one range here)
    (16, 12, -1, 2),           # ranges of 2 pages: 6 splits
    (16, 13, 24, 3),           # a window, a ragged last range of 1 page
    (8, 20, 40, 4),            # a window wider than some contexts
    (32, 6, -1, 5)])           # two ranges, the second of 1 page
def test_paged_split_then_merge_matches_plain(g, page, p_max, window, per):
    """ctx not a multiple of the page, a ctx 0 row (zeros), ctx 1, -1
    tails; G past 5 runs as chunks of at most 4 heads (6 as 3 + 3, 7 as
    4 + 3)."""
    rng = np.random.default_rng(g)
    cap = p_max * page
    ctx = [cap - 5, 0, 1, cap // 2 + 3, 2 * page, page + 1]
    bt, n_pool = paged_tables(ctx, page, p_max, rng)
    hkv, dh = 2, 16
    q, kp, vp = (torch.from_numpy(rng.standard_normal(shape)).float()
                 for shape in ((len(ctx), 1, hkv * g, dh),
                               (n_pool, page, hkv, dh),
                               (n_pool, page, hkv, dh)))
    ctx_t = torch.tensor(ctx, dtype=torch.int32)
    if per is None:
        per = paged_decode_splits(len(ctx), hkv, p_max, page)[1]
    got = paged_split_emulation(q, kp, vp, bt, ctx_t, window, per)
    want = paged_decode_attention_plain(q, kp, vp, bt, ctx_t, window=window)
    live = ctx_t > 0
    assert torch.isfinite(got).all()             # no unwritten scratch read
    torch.testing.assert_close(got[live], want[live], atol=1e-5, rtol=1e-5)
    assert not got[~live].any()                  # zeros, not the average


def test_paged_split_emulation_reads_page_zero_for_minus_one():
    """A -1 entry inside ctx reads page 0, masked by position only, as
    the reference does; an id past the pool is clamped to the sink."""
    rng = np.random.default_rng(3)
    page, hkv, g, dh = 8, 1, 4, 16
    bt = torch.tensor([[2, -1, 1], [0, 9, -1]], dtype=torch.int32)
    q, kp, vp = (torch.from_numpy(rng.standard_normal(shape)).float()
                 for shape in ((2, 1, hkv * g, dh), (4, page, hkv, dh),
                               (4, page, hkv, dh)))
    ctx = torch.tensor([20, 12], dtype=torch.int32)
    got = paged_split_emulation(q, kp, vp, bt, ctx, -1, 1)
    clamped = bt.clamp(max=3)
    want = paged_decode_attention_plain(q, kp, vp, clamped, ctx)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
