"""The attention shapes the reference pads, on the CPU (ROADMAP A7).

The reference's ``repro/kernels/ops.py`` pads every head dim to a
multiple of 128 and every decode GQA group to a multiple of 8 before its
Pallas kernels, so the JAX package attends at any dh and any G.  The
port's four attention kernels take every dh from 1 to 256 and every G
themselves (``kernels/attention_shapes.py``; past 256 in column blocks
since, ``tests/test_torch_past_limits.py``).  Here, on the CPU:

* the plain versions of flash (forward, and its gradient by autograd),
  ring decode (with and without the log-sum-exp) and paged decode at dh
  {256, 200, 100, 36} x G {3, 9, 48}, f32 and bf16, held against the
  Pallas kernels in interpret mode (``ops.*``) and the jnp oracles of
  ``repro/kernels/ref.py`` at 2e-5 / 2e-2 (the gradient and the
  log-sum-exp against the oracle's; flash is causal, so the reference's
  padded key axis adds no key);
* CPU emulations of the new tilings against the plain versions: the
  tensor-core flash tile loop at DH 256 and on zero columns past dh (the
  wrapper's padding of a dh that is not a multiple of 8), the flash
  backward's DH-256 walk (one 64-row block a CTA, P and dS computed once
  a tile and each warpgroup adding half of dh's columns), and the split
  decode core's lanes (a row over the whole warp at DH 256, two 16-byte
  loads a lane in f32; element by element past a dh that is not a
  multiple of 8);
* ``TorchEngine`` in the paged, ring and mixed paths at tiny variants
  with ``d_head`` 256 and with G 3, ``use_pallas`` on: greedy tokens
  equal the JAX ``Engine``'s;
* ``loss_fn``'s gradient at both variants against ``jax.grad`` within
  1e-4 of each leaf's largest magnitude.
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _jax_caps import HAVE_PALLAS_API, PALLAS_SKIP_REASON  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.core.types import Request as JRequest  # noqa: E402
from repro.kernels import ops, ref  # noqa: E402
from repro.serving.engine import Engine  # noqa: E402
from repro.serving.scheduler import SchedulerConfig as JSched  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.core.types import Request  # noqa: E402
from repro_torch.kernels import (decode_attention,  # noqa: E402
                                 flash_attention, paged_decode_attention)
from repro_torch.kernels.attention_shapes import (  # noqa: E402
    BLOCK_WIDTH, GROUPS, check_attention_shape, check_decode_shape,
    check_grid, group_chunk, pad_width)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_backward_plain, flash_attention_plain)
from repro_torch.models.params import flatten, unflatten  # noqa: E402
from repro_torch.serving.engine import TorchEngine  # noqa: E402
from repro_torch.serving.scheduler import SchedulerConfig  # noqa: E402

from test_torch_attention_tiling import (  # noqa: E402
    flash_tiles_emulation, split_decode_emulation)
from test_torch_flash_backward import emulate as backward_emulation  # noqa

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
needs_pallas = pytest.mark.skipif(not HAVE_PALLAS_API,
                                  reason=PALLAS_SKIP_REASON)
HEAD_DIMS = [256, 200, 100, 36]
# G with its KV heads: 3 over 2 (Llama 3.2 3B's group), 9 and 48 over 1
GROUP_HEADS = [(3, 2), (9, 1), (48, 1)]
SWEEP = [(dh, g, hkv) for dh in HEAD_DIMS for g, hkv in GROUP_HEADS]
LOG2E = 1.4426950408889634
NEG_INF = -1e30


def normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def pair(a, dtype="float32"):
    """The same values as a jnp and a torch array of ``dtype``."""
    if a.dtype != np.float32:
        return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))
    return (jnp.asarray(a).astype(dtype),
            torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch,
                                                                 dtype)))


def close(j, t, dtype="float32"):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(jnp.asarray(j).astype(jnp.float32)),
                               atol=TOL[dtype], rtol=TOL[dtype])


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# The domain
# ---------------------------------------------------------------------------

def test_every_head_dim_to_256_and_every_group_is_taken():
    """Every dh up to 256 on the instantiated widths, and past it in
    column blocks of ``BLOCK_WIDTH`` (ROADMAP A7.1), every G."""
    for dtype in (torch.float32, torch.bfloat16):
        for dh in range(1, 4 * BLOCK_WIDTH + 1):
            check_attention_shape(dtype, dh, 3)
            check_decode_shape(dtype, dh, 3)
        for g in range(1, 130):
            check_attention_shape(dtype, 256, g)
            check_decode_shape(dtype, 512, g)
    assert BLOCK_WIDTH == 256 and {3, 9, 48} <= set(GROUPS)


@pytest.mark.parametrize("dtype,dh,g", [(torch.float32, 9736, 5),
                                        (torch.bfloat16, 49408, 1),
                                        (torch.float32, 0, 2),
                                        (torch.float32, -8, 2),
                                        (torch.float32, 64, 0),
                                        (torch.float16, 64, 2)])
def test_shapes_without_a_kernel_are_refused(dtype, dh, g):
    """What is still refused, naming its cause: a dtype other than f32 and
    bf16, a dh or G below 1, and a decode head whose chunk's q rows pass
    a wide CTA's shared memory (five heads at dh 9736, one at 49408)."""
    with pytest.raises(ValueError, match="no (decode )?kernel for .*("
                                         "any dh >= 1|shared memory)"):
        check_decode_shape(dtype, dh, g)


@pytest.mark.parametrize("g,chunk,chunks", [(3, 3, 1), (9, 3, 3),
                                            (48, 4, 12), (13, 4, 4),
                                            (25, 4, 7)])
def test_group_chunks_and_grid(g, chunk, chunks):
    """Every G runs as chunks of 1-5 heads, the instantiated sizes."""
    assert group_chunk(g) == chunk and -(-g // chunk) == chunks
    check_grid(8, g, chunk)
    with pytest.raises(ValueError, match="at most 65535"):
        check_grid(65536 // chunks + 1, g, chunk)


@pytest.mark.parametrize("dh,width", [(1, 8), (36, 40), (100, 104),
                                      (200, 200), (256, 256), (255, 256)])
def test_pad_width(dh, width):
    assert pad_width(dh) == width


# ---------------------------------------------------------------------------
# Plain versions against the Pallas kernels (interpret mode) and oracles
# ---------------------------------------------------------------------------

def flash_oracle(jq, jk, jv, **kw):
    out = ref.flash_attention_ref(jnp.moveaxis(jq, 2, 1),
                                  jnp.moveaxis(jk, 2, 1),
                                  jnp.moveaxis(jv, 2, 1), **kw)
    return jnp.moveaxis(out, 1, 2)


@needs_pallas
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh,g,hkv", SWEEP)
def test_flash_plain_matches_kernel_and_oracle(dh, g, hkv, dtype):
    s = 64
    seed = dh + g
    (jq, tq), (jk, tk), (jv, tv) = (
        pair(normal(shape, seed + i), dtype)
        for i, shape in enumerate(((1, s, g * hkv, dh), (1, s, hkv, dh),
                                   (1, s, hkv, dh))))
    out = flash_attention(tq, tk, tv, causal=True)
    assert out.dtype == tq.dtype and tuple(out.shape) == (1, s, g * hkv, dh)
    close(ops.flash_attention(jq, jk, jv, causal=True, interpret=True), out,
          dtype)
    close(flash_oracle(jq, jk, jv, causal=True), out, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh,g,hkv", SWEEP)
def test_flash_gradient_matches_jax_grad_of_the_oracle(dh, g, hkv, dtype):
    """Autograd through the plain version (the CPU's flash, and the
    card's backward kernels' plain version) against ``jax.grad`` of the
    oracle, under a 24-key window, each gradient within the band of its
    largest magnitude."""
    s, window = 40, 24
    seed = 7 * dh + g
    arrays = [normal(shape, seed + i) for i, shape in enumerate(
        ((1, s, g * hkv, dh), (1, s, hkv, dh), (1, s, hkv, dh),
         (1, s, g * hkv, dh)))]
    (jq, tq), (jk, tk), (jv, tv), (jd, td) = (pair(a, dtype) for a in arrays)
    want = jax.grad(
        lambda q, k, v: jnp.sum(flash_oracle(q, k, v, causal=True,
                                             window=window).astype(
                                                 jnp.float32)
                                * jd.astype(jnp.float32)),
        argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    out = flash_attention(*leaves, causal=True, window=window)
    got = torch.autograd.grad(out, leaves, td)
    for x, y in zip(got, want):
        assert rel(x.float().numpy(),
                   np.asarray(y.astype(jnp.float32))) <= TOL[dtype]
    for x, y in zip(got, flash_attention_backward_plain(
            tq, tk, tv, td, causal=True, window=window)):
        assert torch.equal(x, y)


def ring_arrays(q_pos, slots, hkv, g, dh, seed):
    """Rings after writing positions 0 .. q_pos[b] at slot pos % slots (a
    row with q_pos -1 has no valid slot)."""
    last = np.asarray(q_pos)[:, None]
    kpos = last - np.mod(last - np.arange(slots)[None], slots)
    kpos = np.where(kpos >= 0, kpos, -1).astype(np.int32)
    b = len(q_pos)
    return (normal((b, 1, hkv * g, dh), seed),
            normal((b, slots, hkv, dh), seed + 1),
            normal((b, slots, hkv, dh), seed + 2), kpos,
            np.asarray(q_pos, np.int32))


def decode_oracle(jq, jk, jv, kpos, q_pos, window):
    b, _, h, dh = jq.shape
    hkv = jk.shape[2]
    out = ref.decode_attention_ref(jq.reshape(b, hkv, h // hkv, dh),
                                   jnp.moveaxis(jk, 2, 1),
                                   jnp.moveaxis(jv, 2, 1), jnp.asarray(kpos),
                                   jnp.asarray(q_pos)[:, None],
                                   window=window)
    return out.reshape(b, 1, h, dh)


def lse_oracle(q, k, kpos, q_pos, window):
    """(B, H) natural log-sum-exp of each row's scaled scores over its
    valid slots, in float64."""
    b, _, h, dh = q.shape
    hkv = k.shape[2]
    qg = q.astype(np.float64).reshape(b, hkv, h // hkv, dh)
    sc = np.einsum("bhgd,bthd->bhgt", qg, k.astype(np.float64)) / math.sqrt(
        dh)
    valid = (kpos >= 0) & (kpos <= q_pos[:, None])
    if window > 0:
        valid &= kpos > q_pos[:, None] - window
    sc = np.where(valid[:, None, None, :], sc, -np.inf)
    m = sc.max(-1, keepdims=True)
    return (m[..., 0] + np.log(np.exp(sc - m).sum(-1))).reshape(b, h)


@needs_pallas
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh,g,hkv", SWEEP)
def test_ring_decode_plain_matches_kernel_and_oracle(dh, g, hkv, dtype):
    """A 96-slot ring, its positions wrapped for rows 0 and 1, a window
    for row 0's second call; with the log-sum-exp the output is the same
    and the log-sum-exp the float64 oracle's."""
    q_pos = [130, 99, 40]
    q, k, v, kpos, qp = ring_arrays(q_pos, 96, hkv, g, dh, 3 * dh + g)
    (jq, tq), (jk, tk), (jv, tv) = (pair(a, dtype) for a in (q, k, v))
    tkp, tqp = torch.from_numpy(kpos), torch.from_numpy(qp)
    for window in (-1, 50):
        out = decode_attention(tq, tk, tv, tkp, tqp, window=window)
        close(ops.decode_attention(jq, jk, jv, jnp.asarray(kpos),
                                   jnp.asarray(qp), window=window,
                                   interpret=True), out, dtype)
        close(decode_oracle(jq, jk, jv, kpos, qp, window), out, dtype)
        out2, lse = decode_attention(tq, tk, tv, tkp, tqp, window=window,
                                     with_lse=True)
        assert torch.equal(out, out2) and lse.dtype == torch.float32
        want = lse_oracle(*(np.asarray(jnp.asarray(a).astype(jnp.float32))
                            for a in (jq, jk)), kpos, qp, window)
        np.testing.assert_allclose(lse.numpy(), want, atol=1e-4, rtol=1e-5)


def pool_arrays(ctx, page, hkv, g, dh, seed):
    """A page pool with each row's pages scattered, tables padded with
    -1; the pool holds one spare page."""
    rng = np.random.default_rng(seed)
    pages = [-(-c // page) for c in ctx]
    p_max = max(pages) + 1
    perm = rng.permutation(sum(pages))
    bt = np.full((len(ctx), p_max), -1, np.int32)
    at = 0
    for r, n in enumerate(pages):
        bt[r, :n] = perm[at:at + n]
        at += n
    n_pool = sum(pages) + 1
    return (normal((len(ctx), 1, hkv * g, dh), seed),
            normal((n_pool, page, hkv, dh), seed + 1),
            normal((n_pool, page, hkv, dh), seed + 2), bt,
            np.asarray(ctx, np.int32))


@needs_pallas
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh,g,hkv", SWEEP)
def test_paged_decode_plain_matches_kernel_and_oracle(dh, g, hkv, dtype):
    q, kp, vp, bt, ctx = pool_arrays([70, 33, 16], 16, hkv, g, dh, dh + g)
    (jq, tq), (jk, tk), (jv, tv) = (pair(a, dtype) for a in (q, kp, vp))
    tbt, tctx = torch.from_numpy(bt), torch.from_numpy(ctx)
    b, _, h, _ = q.shape
    for window in (-1, 20):
        out = paged_decode_attention(tq, tk, tv, tbt, tctx, window=window)
        close(ops.paged_decode_attention(jq, jk, jv, jnp.asarray(bt),
                                         jnp.asarray(ctx), window=window,
                                         interpret=True), out, dtype)
        want = ref.paged_decode_attention_ref(
            jq.reshape(b, hkv, g, dh), jk, jv, jnp.asarray(bt),
            jnp.asarray(ctx), window=window)
        close(want.reshape(b, 1, h, dh), out, dtype)


# ---------------------------------------------------------------------------
# The new tilings, emulated
# ---------------------------------------------------------------------------

def bf16_inputs(b, s, t, h, hkv, dh, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape)).to(torch.bfloat16)
            for shape in ((b, s, h, dh), (b, t, hkv, dh), (b, t, hkv, dh))]


@pytest.mark.parametrize("dh,body,s,causal,window", [
    (256, 256, 200, True, -1),        # Gemma 3's heads
    (256, 256, 150, True, 64),        # under a window
    (200, 256, 130, False, -1),       # zero columns past dh on the 256 body
    (100, 128, 150, True, -1),        # padded to 104, the 128 body
    (36, 64, 90, True, 20)])          # padded to 40, the 64 body
def test_flash_tiles_at_wide_and_padded_heads(dh, body, s, causal, window):
    """The bf16 tensor-core tile loop on the DH-wide body, fed the columns
    the kernel sees: q, k and v with zeros past dh up to the body width
    (the wrapper's zero-padded copy, then the body's zero-filled tile
    columns), scaled by the real dh, then cut back to dh; three query
    heads over one KV head."""
    q, k, v = bf16_inputs(1, s, s, 3, 1, dh, dh + s)
    padded = [torch.nn.functional.pad(x, (0, body - dh)) for x in (q, k, v)]
    got = flash_tiles_emulation(*padded, causal, window,
                                scale=1 / math.sqrt(dh))[..., :dh]
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    assert not flash_tiles_emulation(*padded, causal, window, scale=1 /
                                     math.sqrt(dh))[..., dh:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,t,h,hkv,dh,causal,window", [
    (1, 150, 150, 4, 2, 256, True, -1),
    (1, 130, 130, 6, 2, 256, True, 40),        # G 3 under a window
    (1, 90, 170, 2, 1, 200, False, -1),        # dh 200, non-causal
    (1, 170, 100, 9, 1, 104, True, 30),        # S > T: rows with no key
    (2, 77, 77, 3, 1, 256, True, -1)])         # B 2, a ragged S
def test_flash_backward_column_halves_match_plain(dtype, b, s, t, h, hkv,
                                                  dh, causal, window):
    """The backward's DH-256 walk (dh over 128): bf16 takes one 64-row
    block a CTA in both passes, P and dS computed once a tile and each
    warpgroup adding half of dh's columns; f32 takes 16-row tiles.
    Held to autograd through the plain version."""
    gen = torch.Generator().manual_seed(dh + s)
    q, k, v = (torch.randn(shape, generator=gen).to(dtype)
               for shape in ((b, s, h, dh), (b, t, hkv, dh),
                             (b, t, hkv, dh)))
    dout = torch.randn((b, s, h, dh), generator=gen).to(dtype)
    i = torch.arange(s)
    live = torch.ones(s, dtype=torch.bool)
    if causal and window > 0:
        live = torch.clamp(i - window + 1, min=0) <= torch.clamp(i,
                                                                 max=t - 1)
    elif causal:
        live = i >= 0
    dout[:, ~live] = 0
    got = backward_emulation(q, k, v, dout, causal, window)
    want = flash_attention_backward_plain(q, k, v, dout, causal=causal,
                                          window=window)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        if name == "dq":
            assert not x[:, ~live].any()
            x, y = x[:, live], y[:, live]
        assert rel(x.float().numpy(), y.float().numpy()) <= tol, name


def lane_shape(dtype, width):
    """The decode core's lane layout of a width-DH instantiation: lanes
    per row, elements a lane holds, its 16-byte loads, rows a warp
    loads at once (``DecodeLanes``)."""
    vec16 = 16 // (4 if dtype == torch.float32 else 2)
    lpr = min(width // vec16, 32)
    vec = width // lpr
    return lpr, vec, vec // vec16, 32 // lpr


def lane_decode_emulation(q, k, v, valid, dh, width, dtype, unroll=4):
    """One warp of the split decode core over the valid rows of one
    (sequence, KV head): q (G, dh), k and v (T, dh) f32 (the values the
    kernel widens to f32), valid (T,) bool.  Lane (grp, sub) holds
    elements [sub * VEC, (sub + 1) * VEC) of q, K and V, loaded as LOADS
    16-byte pieces, or element by element with zeros past dh where dh is
    not a multiple of 8; the dot products reduce over a row's LPR lanes
    with the kernel's xor butterfly; each row group keeps its own online
    softmax over U rows at a time; the row groups merge by the butterfly
    over the warp; the output is normalised."""
    lpr, vec, loads, rpw = lane_shape(dtype, width)
    g = q.shape[0]
    assert loads * (16 // (4 if dtype == torch.float32 else 2)) == vec

    def lanes(x):                       # (..., dh) -> (..., LPR, VEC)
        z = torch.zeros(x.shape[:-1] + (lpr * vec,))
        z[..., :dh] = x
        return z.reshape(x.shape[:-1] + (lpr, vec))
    qs = lanes(q * (LOG2E / math.sqrt(dh)))                  # (G, LPR, VEC)
    rows = torch.nonzero(valid).flatten()
    m = torch.full((rpw, g), NEG_INF)
    l = torch.zeros((rpw, g))
    acc = torch.zeros((rpw, g, lpr, vec))
    step = rpw * unroll
    for j0 in range(0, len(rows), step):
        s = torch.full((rpw, g, unroll), -math.inf)
        vr = torch.zeros((rpw, unroll, lpr, vec))
        for u in range(unroll):
            for grp in range(rpw):
                j = j0 + u * rpw + grp
                if j >= len(rows):
                    continue
                kr = lanes(k[rows[j]])                       # (LPR, VEC)
                vr[grp, u] = lanes(v[rows[j]])
                part = (qs * kr).sum(-1)                     # (G, LPR)
                o = lpr // 2
                while o > 0:                                 # butterfly
                    part = part + part[:, torch.arange(lpr) ^ o]
                    o //= 2
                assert torch.allclose(part, part[:, :1].expand_as(part))
                s[grp, :, u] = part[:, 0]
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - mx)
        p = torch.exp2(s - mx[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None, None] + torch.einsum(
            "rgu,ruld->rgld", p, vr)
        m = mx
    o = 1
    while o < rpw:                                           # row groups
        other = torch.arange(rpw) ^ o
        mx = torch.maximum(m, m[other])
        a, c = torch.exp2(m - mx), torch.exp2(m[other] - mx)
        l = l * a + l[other] * c
        acc = acc * a[..., None, None] + acc[other] * c[..., None, None]
        m = mx
        o *= 2
    out = acc[0].reshape(g, lpr * vec)[:, :dh] / l[0][:, None]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dh,width,g", [(256, 256, 2), (200, 256, 3),
                                        (128, 128, 3), (100, 128, 4),
                                        (36, 64, 5), (20, 32, 1)])
def test_decode_core_lanes_match_plain(dtype, dh, width, g):
    """The decode core's lanes at every new layout: DH 256 takes the whole
    warp a row (8 elements a lane: one 16-byte load in bf16, two in
    f32), a dh short of the width leaves tail lanes idle, and a dh that
    is not a multiple of 8 loads element by element with zeros past dh;
    against the plain version of ring decode over the same slots."""
    q_pos = [300]
    q, k, v, kpos, qp = (torch.from_numpy(a) for a in ring_arrays(
        q_pos, 160, 1, g, dh, dh + g))
    if dtype == torch.bfloat16:           # the values a bf16 ring holds
        q, k, v = (x.to(torch.bfloat16).float() for x in (q, k, v))
    valid = (kpos[0] >= 0) & (kpos[0] <= qp[0]) & (kpos[0] > qp[0] - 100)
    got = lane_decode_emulation(q[0, 0], k[0, :, 0], v[0, :, 0], valid, dh,
                                width, dtype)
    want = decode_attention_plain(q, k, v, kpos, qp, window=100)[0, 0]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    _, vec, loads, _ = lane_shape(dtype, width)
    if width == 256:
        assert vec == 8 and loads == (2 if dtype == torch.float32 else 1)


@pytest.mark.parametrize("g", [3, 9, 48])
def test_split_decode_at_new_groups_and_heads(g):
    """Split-KV ranges merged, at dh 256 and G 3, 9 and 48 (the chunks of
    a group are CTAs of the same range: the emulation's heads)."""
    q_pos = [999, 5000, 129, -1]
    args = [torch.from_numpy(a) for a in ring_arrays(q_pos, 384, 1, g, 256,
                                                     g)]
    got = split_decode_emulation(*args, 256, 64)
    want = decode_attention_plain(*args, window=256)
    live = torch.tensor(q_pos) >= 0
    torch.testing.assert_close(got[live], want[live], atol=1e-5, rtol=1e-5)
    assert not got[~live].any()


# ---------------------------------------------------------------------------
# The engines and the gradient at tiny variants of the two shapes
# ---------------------------------------------------------------------------

# (config, replacement): gemma3-27b's smoke at dh 256 (its 5:1 cycle of
# local and global layers, one whole cycle), llama3-405b's at G 3
VARIANTS = {"dh256": ("gemma3-27b", dict(d_head=256, n_layers=6)),
            "g3": ("llama3-405b", dict(n_heads=6, n_kv_heads=2))}
SCHED = dict(max_slots=3, num_pages=64, max_context=128, page_size=16,
             max_batch_tokens=64)
LENS = [20, 45, 33, 60]


@functools.lru_cache(maxsize=None)
def variant(key):
    name, kw = VARIANTS[key]
    jcfg = jconfigs.get_smoke(name).replace(dtype="float32", **kw)
    tree = jax.device_get(jmodels.init(jcfg, jax.random.key(0)))
    return jcfg, tree


def serve(eng, cls, prompts, max_new=8):
    reqs = [cls(prompt_len=len(p), max_new_tokens=max_new, prompt_tokens=p)
            for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    for r in reqs:
        assert r.state.value == "finished"
        assert len(r.output_tokens) == max_new
    return [list(r.output_tokens) for r in reqs]


def prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in LENS]


@functools.lru_cache(maxsize=None)
def reference_tokens(key, layout, mixed):
    jcfg, tree = variant(key)
    sched = dict(SCHED, mixed=mixed, prefill_chunk=16 if mixed else 0)
    eng = Engine(jcfg, jax.tree.map(jnp.asarray, tree), JSched(**sched),
                 cache_layout=layout)
    return serve(eng, JRequest, prompts(jcfg.vocab))


@pytest.mark.parametrize("layout,mixed", [("paged", False), ("ring", False),
                                          ("paged", True)],
                         ids=["paged", "ring", "mixed"])
@pytest.mark.parametrize("key", list(VARIANTS))
def test_engine_tokens_match_the_reference_engine(key, layout, mixed):
    name, kw = VARIANTS[key]
    jcfg, tree = variant(key)
    tcfg = tconfigs.get_smoke(name).replace(dtype="float32",
                                            use_pallas=True, **kw)
    assert (tcfg.d_head, tcfg.n_heads // tcfg.n_kv_heads) in (
        (256, 2), (128, 3))
    params = tmodels.from_jax(tcfg, tree, device="cpu")
    sched = dict(SCHED, mixed=mixed, prefill_chunk=16 if mixed else 0)
    eng = TorchEngine(tcfg, params, SchedulerConfig(**sched),
                      cache_layout=layout, device="cpu")
    assert serve(eng, Request, prompts(tcfg.vocab)) == reference_tokens(
        key, layout, mixed)


@pytest.mark.parametrize("key", list(VARIANTS))
def test_loss_gradient_matches_jax_grad(key):
    """``loss_fn`` with the kernels' plain versions (``use_pallas``)
    against ``jax.grad`` of the reference's, every leaf within 1e-4 of its
    largest magnitude."""
    name, kw = VARIANTS[key]
    jcfg, tree = variant(key)
    tcfg = tconfigs.get_smoke(name).replace(dtype="float32",
                                            use_pallas=True, **kw)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab, (2, 24)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[0, -5:] = -1
    b = {"tokens": toks, "labels": labels}
    jgrads = jax.grad(lambda p: jmodels.loss_fn(p, jcfg, b)[0])(
        jax.tree.map(jnp.asarray, tree))
    leaves, treedef = flatten(tmodels.from_jax(tcfg, tree, device="cpu"))
    live = [p.detach().clone().requires_grad_(True) for p in leaves]
    loss, _ = tmodels.loss_fn(unflatten(treedef, live), tcfg,
                              {k: torch.from_numpy(v) for k, v in b.items()})
    grads = torch.autograd.grad(loss, live)
    want = jax.tree.leaves(jgrads)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        assert rel(g.numpy(), w) <= 1e-4
