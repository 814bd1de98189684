"""A sequence-sharded ring on the CPU: the decode attention of each rank's
slot range with its log-sum-exp, merged by ``attention_combine``, against
the whole ring; and the range write against the whole ring's write.

* ``decode_attention_plain(with_lse=True)`` over the slot ranges of R
  ranks, merged by ``attention_combine_plain`` (and the wrapper, which
  takes it on CPU tensors), equals the whole ring's
  ``decode_attention_plain`` within 1e-6 in f32: G 1, 4 and 16; ranges
  empty for some rows; a row empty in every range (zeros, and NEG_INF
  for its log-sum-exp); a windowed ring after it wraps.  Its log-sum-exp
  is the whole ring's too, and ``attention_cached_lse`` (the model's
  plain partial) gives the same pair.
* ``cache_write_range`` on each rank's range, one token a row (decode,
  with rows outside ``live``) and a prompt longer than the ring (prefill,
  wrapping): each rank's slots are the whole ring's ``cache_write`` slots
  of its range, and every rank's ``kpos`` the whole ring's.
* ``attention_combine``'s argument checks, and the combine of one rank.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.distributed.parallel import RingShard  # noqa: E402
from repro_torch.kernels import (attention_combine,  # noqa: E402
                                 attention_combine_plain,
                                 decode_attention, decode_attention_plain)
from repro_torch.kernels.decode_attention import NEG_INF  # noqa: E402
from repro_torch.models.attention import (KVCache,  # noqa: E402
                                          attention_cached_lse, cache_write,
                                          cache_write_range, init_kv_cache)

DH = 32


def ring(b: int, slots: int, hkv: int, g: int, ctx: list, seed: int):
    """q, k, v, kpos, q_pos: rows after writing positions 0..c-1 of each
    row's context c at slot ``pos % slots`` (c = 0: no valid slot)."""
    rng = np.random.default_rng(seed)
    last = np.asarray(ctx)[:, None] - 1
    s = np.arange(slots)[None, :]
    kpos = last - np.mod(last - s, slots)
    kpos = np.where(kpos >= 0, kpos, -1).astype(np.int32)

    def draw(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return (draw(b, 1, hkv * g, DH), draw(b, slots, hkv, DH),
            draw(b, slots, hkv, DH), torch.from_numpy(kpos),
            torch.tensor(last[:, 0], dtype=torch.int32))


def ranges(args, n: int, window: int, combine=attention_combine_plain):
    """Each of n ranks' decode over its slot range, gathered and merged."""
    q, k, v, kpos, q_pos = args
    local = k.shape[1] // n
    outs, lses = [], []
    for r in range(n):
        sl = slice(r * local, (r + 1) * local)
        out, lse = decode_attention_plain(
            q, k[:, sl], v[:, sl], kpos[:, sl].contiguous(), q_pos,
            window=window, with_lse=True)
        outs.append(out[:, 0])
        lses.append(lse)
    b, _, h, dh = q.shape
    return combine(torch.stack(outs), torch.stack(lses)).reshape(b, 1, h, dh)


# contexts: row 0 inside rank 0's range, row 1 past every range boundary,
# row 2 empty (no valid slot anywhere), row 3 inside the last range only
# once the ring wrapped
CTX = [5, 61, 0, 70]


@pytest.mark.parametrize("g", [1, 4, 16])
@pytest.mark.parametrize("n", [2, 4])
def test_ranges_merged_equal_the_whole_ring(g, n):
    args = ring(4, 64, 2, g, CTX, seed=g * 10 + n)
    want, want_lse = decode_attention_plain(*args, with_lse=True)
    got = ranges(args, n, -1)
    assert (got - want).abs().max().item() <= 1e-6
    live = torch.tensor([c > 0 for c in CTX])
    # the whole ring's plain version without the log-sum-exp: equal on
    # every row that has a valid slot (the uniform average elsewhere)
    plain = decode_attention_plain(*args)
    assert (got[live] - plain[live]).abs().max().item() <= 1e-6
    assert not got[~live].any() and (want_lse[~live] == NEG_INF).all()
    # row 0's keys all lie in rank 0's range: every other range is empty
    q, k, v, kpos, q_pos = args
    local = 64 // n
    _, lse1 = decode_attention_plain(q, k[:, local:], v[:, local:],
                                     kpos[:, local:].contiguous(), q_pos,
                                     with_lse=True)
    assert (lse1[0] == NEG_INF).all() and (lse1[1] > NEG_INF / 2).all()
    # the wrapper takes the plain version on CPU tensors
    assert torch.equal(ranges(args, n, -1, attention_combine), got)


@pytest.mark.parametrize("g", [1, 4, 16])
def test_windowed_ring_after_it_wraps(g):
    """A 48-slot ring of a 40-token window, written to positions past
    100: the valid slots straddle the wrap and two of three ranges."""
    args = ring(3, 48, 2, g, [131, 100, 77], seed=g)
    want = decode_attention_plain(*args, window=40)
    for n in (2, 3, 4):
        got = ranges(args, n, 40)
        assert (got - want).abs().max().item() <= 1e-6, n


def test_log_sum_exp_is_the_rows_scaled_scores():
    q, k, v, kpos, q_pos = ring(2, 32, 2, 4, [20, 32], seed=3)
    _, lse = decode_attention_plain(q, k, v, kpos, q_pos, with_lse=True)
    b, _, h, dh = q.shape
    for row in range(b):
        for head in range(h):
            keys = k[row, :, head // 4]
            valid = (kpos[row] >= 0) & (kpos[row] <= q_pos[row])
            s = (keys[valid] @ q[row, 0, head]) / math.sqrt(dh)
            assert abs(lse[row, head].item()
                       - torch.logsumexp(s, 0).item()) <= 1e-5


def test_attention_cached_lse_is_the_plain_partial():
    q, k, v, kpos, q_pos = ring(4, 40, 2, 4, [9, 40, 0, 17], seed=5)
    for window in (-1, 8):
        want, want_lse = decode_attention_plain(q, k, v, kpos, q_pos,
                                                window=window, with_lse=True)
        got, got_lse = attention_cached_lse(q, KVCache(k, v, kpos),
                                            q_pos[:, None], window=window)
        assert (got - want).abs().max().item() <= 1e-6
        assert (got_lse[:, 0] - want_lse).abs().max().item() <= 1e-5
        assert (got_lse[2] == NEG_INF).all() and not got[2].any()


def _shards(total: int, n: int):
    local = total // n
    return [RingShard(None, n, r, r * local, local, total, "model")
            for r in range(n)]


@pytest.mark.parametrize("total,n", [(24, 2), (24, 3), (32, 4)])
def test_range_write_is_the_whole_rings_write(total, n):
    rng = np.random.default_rng(total + n)
    b, hkv = 3, 2

    def draw(s):
        return torch.from_numpy(rng.normal(size=(b, s, hkv, DH)).astype(
            np.float32))
    whole = init_kv_cache(b, total, hkv, DH, torch.float32, "cpu")
    parts = [init_kv_cache(b, total, hkv, DH, torch.float32, "cpu",
                           total // n) for _ in range(n)]
    shards = _shards(total, n)
    # a prompt longer than the ring (it wraps), then decode steps with a
    # row outside ``live``
    prompt = total + 11
    k, v = draw(prompt), draw(prompt)
    start = torch.zeros(b, dtype=torch.int32)
    cache_write(whole, k, v, start)
    for part, sh in zip(parts, shards):
        cache_write_range(part, k, v, start, sh)
    live = torch.tensor([True, False, True])
    for step in range(total + 3):
        k, v = draw(1), draw(1)
        pos = torch.full((b,), prompt + step, dtype=torch.int32)
        cache_write(whole, k, v, pos, live)
        for part, sh in zip(parts, shards):
            cache_write_range(part, k, v, pos, sh, live)
        for part, sh in zip(parts, shards):
            rng_ = slice(sh.lo, sh.lo + sh.local)
            assert torch.equal(part.k, whole.k[:, rng_]), (step, sh.rank)
            assert torch.equal(part.v, whole.v[:, rng_])
            assert torch.equal(part.kpos, whole.kpos)


def test_combine_checks_and_one_rank():
    outs = torch.randn(1, 2, 3, 8)
    lses = torch.randn(1, 2, 3)
    assert torch.equal(attention_combine(outs, lses), outs[0])
    lses[0, 1] = NEG_INF
    got = attention_combine(outs, lses)
    assert not got[1].any() and torch.equal(got[0], outs[0, 0])
    with pytest.raises(ValueError, match="lses must be"):
        attention_combine(outs, lses[:, :1])
    with pytest.raises(ValueError, match="float32"):
        attention_combine(outs, lses.double())
    with pytest.raises(ValueError, match=r"\(R, B, H, dh\)"):
        attention_combine(outs[0], lses)
    bf = attention_combine(outs.to(torch.bfloat16), lses)
    assert bf.dtype == torch.bfloat16


def test_decode_wrapper_returns_the_pair_on_cpu():
    args = ring(2, 16, 1, 4, [3, 0], seed=1)
    out, lse = decode_attention(*args, with_lse=True)
    want, want_lse = decode_attention_plain(*args, with_lse=True)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    assert torch.equal(decode_attention(*args), decode_attention_plain(*args))
