"""The paged flash kernel's function on the CPU: its plain version against
the reference's gather path, its tile walk emulated, and the model and
engine paths that reach it with ``use_pallas`` on.

``kernels.paged_flash_attention`` computes, over the page pool in place,
what the reference's ``self_attention_paged`` computes for Sq > 1 with
``paged_view`` + ``attention_cached`` (``repro/models/attention.py``).
On CPU tensors the wrapper runs its plain version, which is held here to
those JAX functions over head groups, head dims (100 and 112 not
multiples of 8 or 128, 512 past 256), windows, page sizes, shuffled
page ids, unmapped pages and pad rows (q_pos -1).  Live rows only: a row
with no valid key is the uniform average in the reference and the plain
version, zeros from the kernel.  Tolerance: 2e-5 f32, 2e-2 bf16
(tests/test_kernels.py).  The kernel itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jmodels  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs.base import BlockSpec  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs.base import BlockSpec as TBlockSpec  # noqa: E402
from repro_torch.kernels import (paged_flash_attention,  # noqa: E402
                                 paged_flash_attention_plain, work)
from repro_torch.kernels.paged_flash_attention import (  # noqa: E402
    live_rows, valid_counts)
from repro_torch.models import attention as tattn  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
NEG_INF = -1e30
LOG2E = 1.0 / math.log(2.0)


def paged_case(hkv, g, dh, page, starts, fills, s, p_max, seed=0,
               hole=None):
    """numpy inputs of one call: row r attends back into ``starts[r]``
    resident tokens and holds ``fills[r]`` query rows at positions
    ``starts[r]`` onward, the rest of its ``s`` rows pad rows (q_pos -1).
    Each row's pages are private and scattered over the pool (shuffled
    ids), its table -1 past them; ``hole`` (row, entry) unmaps one page
    inside a row's range.  The pool's last page is the sink."""
    rng = np.random.default_rng(seed)
    b = len(starts)
    need = [-(-(st + n) // page) for st, n in zip(starts, fills)]
    n_pages = sum(need)
    perm = rng.permutation(n_pages)
    bt = np.full((b, p_max), -1, np.int32)
    at = 0
    for r, n in enumerate(need):
        bt[r, :n] = perm[at:at + n]
        at += n
    if hole is not None:
        bt[hole] = -1
    q_pos = np.full((b, s), -1, np.int32)
    for r, (st, n) in enumerate(zip(starts, fills)):
        q_pos[r, :n] = st + np.arange(n)
    q = rng.standard_normal((b, s, hkv * g, dh)).astype(np.float32)
    kp = rng.standard_normal((n_pages + 1, page, hkv, dh)).astype(np.float32)
    vp = rng.standard_normal((n_pages + 1, page, hkv, dh)).astype(np.float32)
    return q, kp, vp, bt, q_pos


def _torch(a, dtype="float32"):
    t = torch.from_numpy(a)
    return t.to(getattr(torch, dtype)) if a.dtype == np.float32 else t


def _jax(a, dtype="float32"):
    return jnp.asarray(a, dtype=getattr(jnp, dtype)) \
        if a.dtype == np.float32 else jnp.asarray(a)


def reference(q, kp, vp, bt, q_pos, window, dtype):
    """The reference's gather path: ``paged_view`` + ``attention_cached``."""
    view = jattn.paged_view(jattn.PagedKVCache(_jax(kp, dtype),
                                               _jax(vp, dtype)), _jax(bt))
    out = jattn.attention_cached(_jax(q, dtype), view, _jax(q_pos),
                                 window=window)
    return np.asarray(out.astype(jnp.float32))


# ---------------------------------------------------------------------------
# The plain version against the reference's gather path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("page", [4, 16, 48, 128])
@pytest.mark.parametrize("dh", [64, 100, 112, 128, 256, 512])
@pytest.mark.parametrize("hkv,g", [(2, 1), (2, 4), (1, 8)])
def test_plain_matches_reference_gather(hkv, g, dh, page):
    """Two rows: a suffix of 13 rows over 37 resident tokens with 3 pad
    rows, and a fresh prompt of 16 rows with one page of its range
    unmapped (a hole past the first page); tables wider than the pages
    used.  f32 and bf16, no window and a window of 20."""
    p_max = -(-53 // page) + 2
    hole = (1, 1) if -(-16 // page) > 1 else None
    case = paged_case(hkv, g, dh, page, starts=[37, 0], fills=[13, 16],
                      s=16, p_max=p_max, seed=dh + page + g, hole=hole)
    bt, q_pos = _torch(case[3]), _torch(case[4])
    for window in (0, 20):
        live = live_rows(bt, q_pos, page, window).numpy()
        assert live[0, :13].all() and not live[0, 13:].any()
        for dtype in ("float32", "bfloat16"):
            got = paged_flash_attention(
                *[_torch(a, dtype) for a in case[:3]], bt, q_pos,
                window=window)
            want = reference(*case, window, dtype)
            assert got.dtype == getattr(torch, dtype)
            np.testing.assert_allclose(got.float().numpy()[live],
                                       want[live], atol=TOL[dtype],
                                       rtol=TOL[dtype])


def test_plain_at_the_mixed_chunk_shape():
    """agent-7b's heads (8 over 2 here, dh 128) at a mixed chunk's form: a
    buffer of 40 rows filled to 32 at start 70, pages of 16 shuffled over
    the pool, the table's tail unmapped; the pad rows' plain output is the
    uniform average of the row's keys, as the reference's."""
    case = paged_case(2, 4, 128, 16, starts=[70], fills=[32], s=40,
                      p_max=12, seed=3)
    bt, q_pos = _torch(case[3]), _torch(case[4])
    got = paged_flash_attention(*[_torch(a) for a in case[:3]], bt, q_pos,
                                window=-1)
    want = reference(*case, -1, "float32")
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    assert live_rows(bt, q_pos, 16).sum() == 32


def test_valid_counts_against_brute_force():
    """The pairs and live keys the bound counts, against a loop."""
    case = paged_case(1, 2, 64, 16, starts=[37, 0], fills=[13, 16], s=16,
                      p_max=6, hole=(1, 0))
    bt, q_pos = case[3], case[4]
    for window in (-1, 20):
        pairs, keys = valid_counts(_torch(bt), _torch(q_pos), 16, window)
        want_pairs, want_keys = 0, 0
        for r in range(2):
            seen = set()
            for p in q_pos[r]:
                for j in range(6 * 16):
                    ok = bt[r, j // 16] >= 0 and j <= p and p >= 0
                    ok = ok and (window <= 0 or j > p - window)
                    if ok:
                        want_pairs += 1
                        seen.add(j)
            want_keys += len(seen)
        assert (pairs, keys) == (want_pairs, want_keys)


# ---------------------------------------------------------------------------
# The bf16 TMA body's walk, emulated
# ---------------------------------------------------------------------------

CTA_ROWS, WG_ROWS = 128, 64


def key_tile(dh):
    """BN of the body that takes ``dh``: 128 keys up to a width of 128,
    64 at the 256 one."""
    return 64 if dh > 128 else 128


def tma_walk_emulation(q, kp, vp, bt, q_pos, window):
    """The paged bf16 body as it computes, item by item: an item is (query
    head, batch row, 128 query rows); its tiles run from its live rows'
    lowest position (less the window) to their highest, BN keys each,
    loaded as boxes of gcd(page, BN) rows at (slot, page id) from the
    table (an unmapped box from the sink page, its bit clear in the
    tile's mask); each 64-row warpgroup needs a tile where a live row
    may see it, takes it whole (no element mask) only where every box is
    mapped and every row in the sequence sees every key, masks by
    position and mapped box otherwise, keeps an online softmax in exp2
    units from the finite NEG_INF, and rounds P to bf16 before P V.  A
    row with no valid key is zeros.  Asserts the walk's invariants on
    the way: a box never crosses a page, the needed tiles of a
    warpgroup are one run, the item's tiles hold every valid pair, a
    whole tile has no invalid pair and a tile not needed no valid one."""
    b, s, h, dh = q.shape
    n_pool, page, hkv, _ = kp.shape
    g = h // hkv
    p_max = bt.shape[1]
    t_len, sink = p_max * page, n_pool - 1
    bn = key_tile(dh)
    rows = min(page & -page, bn)
    assert rows % 8 == 0 and math.gcd(page, bn) == rows
    nbox = bn // rows
    c = LOG2E / math.sqrt(dh)
    valid_all = (torch.repeat_interleave(bt >= 0, page, dim=1)[:, None, :]
                 & (torch.arange(t_len) <= q_pos.long()[:, :, None]))
    if window > 0:
        valid_all &= torch.arange(t_len) > q_pos.long()[:, :, None] - window
    out = torch.zeros(b, s, h, dh)
    for bi in range(b):
        for hi in range(h):
            kh = hi // g
            for q0 in range(0, s, CTA_ROWS):
                n = min(CTA_ROWS, s - q0)
                pos = torch.full((CTA_ROWS,), -1, dtype=torch.long)
                pos[:n] = q_pos[bi, q0:q0 + n].long()
                inside = torch.arange(CTA_ROWS) < n
                live = pos >= 0
                if not live.any():
                    continue                     # no tile: zeros
                lo, hi_ = int(pos[live].min()), int(pos[live].max())
                k_begin = max(lo - window + 1, 0) if window > 0 else 0
                k_end = min(hi_ + 1, t_len)
                k_begin = k_begin // bn * bn
                tiles = list(range(k_begin, k_end, bn))
                keys_valid = valid_all[bi, q0:q0 + n]
                assert not keys_valid[:, :k_begin].any()
                assert not keys_valid[:, k_end:].any()
                qf = torch.zeros(CTA_ROWS, dh)
                qf[:n] = q[bi, q0:q0 + n, hi].float()
                m = torch.full((CTA_ROWS,), NEG_INF)
                l = torch.zeros(CTA_ROWS)
                acc = torch.zeros(CTA_ROWS, dh)
                needed = {0: [], 1: []}
                for ti, t0 in enumerate(tiles):
                    kt, vt = torch.zeros(bn, dh), torch.zeros(bn, dh)
                    bits = 0
                    for x in range(nbox):
                        key0 = t0 + x * rows
                        pid = int(bt[bi, key0 // page]) if key0 < t_len \
                            else -1
                        bits |= (pid >= 0) << x
                        src, slot = (pid if pid >= 0 else sink), key0 % page
                        assert slot + rows <= page
                        kt[x * rows:(x + 1) * rows] = \
                            kp[src, slot:slot + rows, kh].float()
                        vt[x * rows:(x + 1) * rows] = \
                            vp[src, slot:slot + rows, kh].float()
                    keys = torch.arange(t0, t0 + bn)
                    boxed = torch.tensor([(bits >> (j // rows)) & 1
                                          for j in range(bn)], dtype=bool)
                    ok = (keys < t_len) & boxed
                    ok = ok[None, :] & (keys[None, :] <= pos[:, None])
                    if window > 0:
                        ok &= keys[None, :] > pos[:, None] - window
                    for w in (0, 1):
                        r = slice(w * WG_ROWS, (w + 1) * WG_ROWS)
                        wpos, win = pos[r], inside[r]
                        wlive = wpos >= 0
                        if not wlive.any():
                            assert not ok[r].any()
                            continue
                        wlo = int(wpos[wlive].min())
                        whi = int(wpos[wlive].max())
                        lo_all = int(wpos[win].min())
                        need = t0 <= whi and (window <= 0
                                              or t0 + bn - 1 > wlo - window)
                        if not need:
                            assert not ok[r].any()
                            continue
                        needed[w].append(ti)
                        whole = (t0 + bn <= t_len and bits == (1 << nbox) - 1
                                 and t0 + bn - 1 <= lo_all
                                 and (window <= 0 or t0 > whi - window))
                        sc = qf[r] @ kt.T
                        if whole:
                            assert ok[r][win].all()
                        else:
                            sc = sc.masked_fill(~ok[r], -math.inf)
                        mx = torch.maximum(m[r], sc.amax(1))
                        alpha = torch.exp2((m[r] - mx) * c)
                        p = torch.exp2(sc * c - (mx * c)[:, None])
                        pv = p.to(torch.bfloat16).float() @ vt
                        m[r] = mx
                        l[r] = l[r] * alpha + p.sum(1)
                        acc[r] = acc[r] * alpha[:, None] + pv
                for w in (0, 1):
                    run = needed[w]
                    assert run == list(range(run[0], run[-1] + 1)) \
                        if run else True
                o = torch.where((l > 0)[:, None],
                                acc / torch.clamp(l, min=1e-30)[:, None], 0.0)
                out[bi, q0:q0 + n, hi] = o[:n]
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("dh,page,window,starts,fills,s", [
    (128, 128, -1, [1024 - 896, 0], [200, 77], 200),   # one box a tile
    (128, 16, -1, [300, 5], [140, 60], 150),           # 8 boxes a tile
    (64, 48, 30, [100, 0], [70, 33], 70),              # boxes of 16, window
    (256, 128, -1, [200, 10], [130, 64], 140),         # 64-key tiles, 2 a page
    (256, 16, 100, [90, 0], [64, 20], 70),             # 4 boxes, window
    (128, 8, -1, [33, 0], [40, 9], 48)])               # boxes of 8 rows
def test_tma_walk_matches_plain(dh, page, window, starts, fills, s):
    """Two rows, G 2 over one KV head, shuffled pages with a hole in the
    second row's range and an unmapped tail, pad rows past each fill:
    the emulated walk against the plain version on live rows (bf16 band)
    and zeros elsewhere."""
    p_max = -(-(max(st + n for st, n in zip(starts, fills))) // page) + 2
    hole = (1, 1) if -(-(starts[1] + fills[1]) // page) > 2 else None
    case = paged_case(1, 2, dh, page, starts, fills, s, p_max, seed=page,
                      hole=hole)
    q, kp, vp = (_torch(a, "bfloat16") for a in case[:3])
    bt, q_pos = _torch(case[3]), _torch(case[4])
    got = tma_walk_emulation(q, kp, vp, bt, q_pos, window)
    want = paged_flash_attention_plain(q, kp, vp, bt, q_pos, window=window)
    live = live_rows(bt, q_pos, page, window)
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               atol=2e-2, rtol=2e-2)
    assert not got[~live].any()


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

def small_args(dtype=torch.float32, device="cpu"):
    case = paged_case(2, 2, 32, 16, starts=[20, 0], fills=[10, 7], s=12,
                      p_max=4)
    return ([_torch(a).to(dtype).to(device) for a in case[:3]]
            + [_torch(a).to(device) for a in case[3:]])


def test_wrapper_cpu_takes_plain_version_and_counts_no_launch():
    args = small_args()
    before = paged_flash_attention.launches
    got = paged_flash_attention(*args, window=8)
    assert paged_flash_attention.launches == before
    assert torch.equal(got, paged_flash_attention_plain(*args, window=8))


def test_wrapper_meta_counts_work_at_full_context():
    """Meta tensors: the output's shape and dtype, one counted call with
    every row at full context (within the window) and every page read,
    no launch and no plain version."""
    args = small_args(torch.bfloat16, "meta")
    before = paged_flash_attention.launches
    with work.count_calls() as counted:
        out = paged_flash_attention(*args, window=8)
    assert out.device.type == "meta" and out.shape == args[0].shape
    assert out.dtype == torch.bfloat16
    assert paged_flash_attention.launches == before
    want = work.paged_flash(args[0], args[1], args[3], args[4],
                            2 * 12 * 8, 2 * 64)
    assert counted == {"paged_flash_attention": {
        "calls": 1, "ops": want.ops, "bytes": want.nbytes}}
    assert want.ops == 4 * 32 * 4 * 2 * 12 * 8
    # B 0: no launch, nothing counted
    empty = [torch.empty((0, 12, 4, 32), device="meta"),
             args[1].float(), args[2].float(),
             torch.empty((0, 4), dtype=torch.int32, device="meta"),
             torch.empty((0, 12), dtype=torch.int32, device="meta")]
    with work.count_calls() as counted:
        out = paged_flash_attention(*empty, window=-1)
    assert counted == {} and out.shape == (0, 12, 4, 32)


def test_wrapper_refuses_grad_on_meta_tensors():
    args = small_args(device="meta")
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="ROADMAP A4.5"):
        paged_flash_attention(*args)
    with torch.no_grad():
        paged_flash_attention(*args)


@pytest.mark.parametrize("bad", ["q_rank", "pool_shape", "pool_dh",
                                 "group", "table_dtype", "pos_shape",
                                 "dtype_mix", "empty_s", "device"])
def test_wrapper_rejects_bad_inputs(bad):
    q, kp, vp, bt, q_pos = small_args()
    if bad == "q_rank":
        q = q[0]
    elif bad == "pool_shape":
        vp = vp[:-1]
    elif bad == "pool_dh":
        kp, vp = kp[..., :16], vp[..., :16]
    elif bad == "group":
        q = torch.zeros((2, 12, 3, 32))
    elif bad == "table_dtype":
        bt = bt.long()
    elif bad == "pos_shape":
        q_pos = q_pos[:, :5]
    elif bad == "dtype_mix":
        q = q.to(torch.bfloat16)
    elif bad == "empty_s":
        q, q_pos = q[:, :0], q_pos[:, :0]
    else:
        bt = bt.to("meta")
    with pytest.raises(ValueError):
        paged_flash_attention(q, kp, vp, bt, q_pos)


# ---------------------------------------------------------------------------
# The model paths with use_pallas on, against the reference
# ---------------------------------------------------------------------------

def tiny(**kw):
    return (jget("tiny-agent").replace(dtype="float32", **kw),
            tget("tiny-agent").replace(dtype="float32", use_pallas=True,
                                       **kw))


@pytest.mark.parametrize("window", [-1, 24])
def test_self_attention_paged_suffix_rows(window):
    """``self_attention_paged`` at Sq > 1 with ``use_pallas``: two rows'
    suffixes over resident pages, the second row's tail at position -1
    (a padded chunk); live rows' outputs and the written pool against
    the reference."""
    jcfg, tcfg = tiny(window=window)
    rng = np.random.default_rng(5)
    d, h, hkv, dh = tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads, tcfg.d_head
    params = {"wq": rng.standard_normal((d, h, dh)) / np.sqrt(d),
              "wk": rng.standard_normal((d, hkv, dh)) / np.sqrt(d),
              "wv": rng.standard_normal((d, hkv, dh)) / np.sqrt(d),
              "wo": rng.standard_normal((h, dh, d)) / np.sqrt(h * dh)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    page, n = 16, 9
    kp = rng.standard_normal((n + 1, page, hkv, dh)).astype(np.float32)
    vp = rng.standard_normal((n + 1, page, hkv, dh)).astype(np.float32)
    tables = np.asarray([[4, 0, 7, 2, -1], [5, 1, 3, -1, -1]], np.int32)
    pos = np.stack([40 + np.arange(20),
                    np.where(np.arange(20) < 14, 25 + np.arange(20), -1)]
                   ).astype(np.int32)
    x = rng.standard_normal((2, 20, d)).astype(np.float32)
    jout, jcache = jattn.self_attention_paged(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        jattn.PagedKVCache(jnp.asarray(kp), jnp.asarray(vp)), jcfg,
        BlockSpec(window=window), jnp.asarray(pos), jnp.asarray(tables))
    tout, tcache = tattn.self_attention_paged(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x),
        tattn.PagedKVCache(torch.from_numpy(kp.copy()),
                           torch.from_numpy(vp.copy())), tcfg,
        TBlockSpec(window=window), torch.from_numpy(pos),
        torch.from_numpy(tables))
    live = pos >= 0
    np.testing.assert_allclose(tout.numpy()[live], np.asarray(jout)[live],
                               atol=1e-4, rtol=1e-4)
    for t, j in zip(tcache, jcache):        # real pages; the sink aside
        np.testing.assert_allclose(t.numpy()[:n], np.asarray(j)[:n],
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("window", [-1, 24])
def test_prefill_paged_logits_kernels_on(window):
    """``prefill_paged`` (a 23-token prompt, then its 17-token suffix over
    the resident pages) and ``prefill_paged_padded`` (a 20-token chunk in
    a 32-token buffer) with ``use_pallas``: logits within 1e-4 of the
    reference's and ``pos`` as its."""
    jcfg, tcfg = tiny(window=window)
    tree = jax.device_get(jmodels.init(jcfg, jax.random.key(0)))
    tparams = tmodels.from_jax(tcfg, tree, device="cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (1, 60)
                                             ).astype(np.int32)
    tables = np.asarray([[3, 0, 7, 1, 5, -1]], np.int32)
    jcache = jmodels.init_cache(jcfg, 2, 96, layout="paged", num_pages=8,
                                page_size=16)
    tcache = tmodels.init_cache(tcfg, 2, 96, layout="paged", num_pages=8,
                                page_size=16, device="cpu")
    jt, tt = jnp.asarray(tables), torch.from_numpy(tables)
    for start, n in ((0, 23), (23, 17)):
        lj, jcache = jtfm.prefill_paged(
            jparams, jcfg, jnp.asarray(toks[:, start:start + n]), jcache, jt,
            jnp.full((1,), start, jnp.int32), jnp.int32(1))
        lt, tcache = tmodels.prefill_paged(
            tparams, tcfg, torch.from_numpy(toks[:, start:start + n]).long(),
            tcache, tt, torch.full((1,), start, dtype=torch.int32), 1)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                                   atol=1e-4)
    start, n, cap = 40, 20, 32
    buf = np.zeros((1, cap), np.int32)
    buf[0, :n] = toks[0, start:start + n]
    lj, jcache = jtfm.prefill_paged_padded(
        jparams, jcfg, jnp.asarray(buf), jcache, jt, jnp.int32(start),
        jnp.int32(1), jnp.int32(n))
    lt, tcache = tmodels.prefill_paged_padded(
        tparams, tcfg, torch.from_numpy(buf).long(), tcache, tt,
        torch.tensor(start, dtype=torch.int32),
        torch.tensor(1, dtype=torch.int32), torch.tensor(n,
                                                         dtype=torch.int32))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                               atol=1e-4)
    assert tcache["pos"].tolist() == [0, start + n]


def test_model_routes_sq_above_one_to_the_wrapper(monkeypatch):
    """With ``use_pallas`` every Sq > 1 call of ``self_attention_paged``
    goes to ``paged_flash_attention`` and none gathers a view; Sq = 1 goes
    to ``paged_decode_attention``; without the flag the gather path."""
    jcfg, tcfg = tiny()
    tree = jax.device_get(jmodels.init(jcfg, jax.random.key(0)))
    tparams = tmodels.from_jax(tcfg, tree, device="cpu")
    calls = []
    for name in ("paged_flash_attention", "paged_decode_attention",
                 "paged_view"):
        real = getattr(tattn, name)
        monkeypatch.setattr(tattn, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    tables = torch.tensor([[3, 0, 7, 1, 5, -1]], dtype=torch.int32)
    for use_pallas in (True, False):
        calls.clear()
        cfg = tcfg.replace(use_pallas=use_pallas)
        cache = tmodels.init_cache(cfg, 1, 96, layout="paged", num_pages=8,
                                   page_size=16, device="cpu")
        toks = torch.arange(30)[None] % cfg.vocab
        _, cache = tmodels.prefill_paged(tparams, cfg, toks, cache, tables,
                                         torch.zeros(1, dtype=torch.int32),
                                         0)
        tmodels.decode_step(tparams, cfg, toks[:, :1], cache, tables)
        n = cfg.n_layers
        assert calls == (["paged_flash_attention"] * n
                         + ["paged_decode_attention"] * n if use_pallas
                         else ["paged_view"] * 2 * n)
