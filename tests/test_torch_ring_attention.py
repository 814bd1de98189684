"""Port ring attention vs the JAX reference.

The two ring kernels' wrappers on CPU tensors run their plain versions;
they are held against the reference's Pallas kernels in interpret mode
(``ops.flash_attention`` / ``ops.decode_attention``, ``interpret=True``)
over the sweeps of tests/test_kernels.py, and against the jnp oracles
of ``repro/kernels/ref.py`` where the reference wrapper is at fault
(non-causal flash with a ragged key axis, ROADMAP §C).  Tolerance: 2e-5
f32, 2e-2 bf16 (tests/test_kernels.py:16).  The ring modules
(``cache_write``, ``attention_full``, ``attention_cached``) are held
against ``repro.models.attention`` on the same numpy inputs.  The
kernels themselves run only on the card (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _jax_caps import HAVE_PALLAS_API, PALLAS_SKIP_REASON  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs.base import BlockSpec  # noqa: E402
from repro.kernels import ops, ref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs.base import BlockSpec as TBlockSpec  # noqa: E402
from repro_torch.kernels import decode_attention, flash_attention  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_plain)
from repro_torch.models import attention as tattn  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
needs_pallas = pytest.mark.skipif(not HAVE_PALLAS_API,
                                  reason=PALLAS_SKIP_REASON)


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


# ---------------------------------------------------------------------------
# flash attention: plain version vs the Pallas kernel and the oracle
# ---------------------------------------------------------------------------


def flash_inputs(b, s, t, h, hkv, dh, seed=0):
    return (normal((b, s, h, dh), seed), normal((b, t, hkv, dh), seed + 1),
            normal((b, t, hkv, dh), seed + 2))


def flash_oracle(jq, jk, jv, **kw):
    out = ref.flash_attention_ref(jnp.moveaxis(jq, 2, 1),
                                  jnp.moveaxis(jk, 2, 1),
                                  jnp.moveaxis(jv, 2, 1), **kw)
    return jnp.moveaxis(out, 1, 2)


@needs_pallas
@pytest.mark.parametrize("b,s,h,hkv,dh", [
    (1, 128, 4, 4, 64),       # MHA
    (2, 256, 8, 2, 64),       # GQA 4:1
    (1, 192, 4, 1, 32),       # MQA, ragged seq vs 128 blocks
    (2, 64, 2, 2, 128),       # short seq, wide head
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_kernel_sweep(b, s, h, hkv, dh, dtype):
    (jq, tq), (jk, tk), (jv, tv) = (pair(a, dtype) for a in
                                    flash_inputs(b, s, s, h, hkv, dh))
    out = flash_attention(tq, tk, tv, causal=True)
    assert out.dtype == tq.dtype and tuple(out.shape) == (b, s, h, dh)
    close(ops.flash_attention(jq, jk, jv, causal=True, interpret=True), out,
          dtype)
    close(flash_oracle(jq, jk, jv, causal=True), out, dtype)


@needs_pallas
@pytest.mark.parametrize("window", [32, 64])
def test_flash_plain_window(window):
    (jq, tq), (jk, tk), (jv, tv) = (pair(a) for a in
                                    flash_inputs(1, 256, 256, 4, 4, 64, 1))
    out = flash_attention(tq, tk, tv, causal=True, window=window)
    close(ops.flash_attention(jq, jk, jv, causal=True, window=window,
                              interpret=True), out)
    close(flash_oracle(jq, jk, jv, causal=True, window=window), out)


@pytest.mark.parametrize("s,t,dtype", [(64, 200, "float32"),
                                       (100, 37, "float32"),
                                       (128, 128, "bfloat16")])
def test_flash_plain_noncausal_matches_oracle(s, t, dtype):
    (jq, tq), (jk, tk), (jv, tv) = (pair(a, dtype) for a in
                                    flash_inputs(2, s, t, 4, 2, 32, 3))
    out = flash_attention(tq, tk, tv, causal=False)
    close(flash_oracle(jq, jk, jv, causal=False), out, dtype)


@needs_pallas
def test_flash_noncausal_ragged_keys_reference_fault():
    """The reference wrapper pads the key axis to its 128-key block and
    passes the padded length as ``kv_len``, so non-causal attention over
    T = 192 lets 64 zero keys into the softmax.  The port uses the real
    T and agrees with the oracle; the reference kernel does not."""
    (jq, tq), (jk, tk), (jv, tv) = (pair(a) for a in
                                    flash_inputs(1, 192, 192, 2, 2, 64, 5))
    want = flash_oracle(jq, jk, jv, causal=False)
    close(want, flash_attention(tq, tk, tv, causal=False))
    bad = ops.flash_attention(jq, jk, jv, causal=False, interpret=True)
    assert float(jnp.abs(bad - want).max()) > 1e-2
    # causal prefill, the port's path, is not affected
    good = ops.flash_attention(jq, jk, jv, causal=True, interpret=True)
    close(flash_oracle(jq, jk, jv, causal=True),
          torch.from_numpy(np.array(good)))


# ---------------------------------------------------------------------------
# decode attention: plain version vs the Pallas kernel and the oracle
# ---------------------------------------------------------------------------


def decode_inputs(b, h, hkv, dh, t, seed=2):
    return (normal((b, 1, h, dh), seed), normal((b, t, hkv, dh), seed + 1),
            normal((b, t, hkv, dh), seed + 2))


def decode_oracle(jq, jk, jv, jkpos, jqp, window=-1):
    b, _, h, dh = jq.shape
    hkv = jk.shape[2]
    out = ref.decode_attention_ref(jq.reshape(b, hkv, h // hkv, dh),
                                   jnp.moveaxis(jk, 2, 1),
                                   jnp.moveaxis(jv, 2, 1), jkpos,
                                   jqp[:, None], window=window)
    return out.reshape(b, 1, h, dh)


@needs_pallas
@pytest.mark.parametrize("b,h,hkv,dh,t,qpos", [
    (2, 8, 2, 64, 256, 200),
    (1, 4, 4, 64, 128, 5),      # near-empty cache
    (3, 4, 1, 128, 384, 380),   # MQA, nearly full
])
@pytest.mark.parametrize("window", [-1, 64])
def test_decode_plain_matches_kernel_sweep(b, h, hkv, dh, t, qpos, window):
    q, k, v = decode_inputs(b, h, hkv, dh, t)
    kpos = np.broadcast_to(np.arange(t, dtype=np.int32)[None], (b, t))
    kpos = np.where(kpos <= qpos, kpos, -1).astype(np.int32)
    qp = np.full((b,), qpos, np.int32)
    (jq, tq), (jk, tk), (jv, tv), (jkp, tkp), (jqp, tqp) = (
        pair(a) for a in (q, k, v, kpos, qp))
    out = decode_attention(tq, tk, tv, tkp, tqp, window=window)
    close(ops.decode_attention(jq, jk, jv, jkp, jqp, window=window,
                               interpret=True), out)
    close(decode_oracle(jq, jk, jv, jkp, jqp, window), out)


@needs_pallas
def test_decode_plain_tail_not_truncated():
    """The reference's truncated-tail regression: T = 200 is not a whole
    number of 128-key blocks, and the last 72 keys must count."""
    b, h, hkv, dh, t = 2, 8, 1, 128, 200
    q, k, v = decode_inputs(b, h, hkv, dh, t, seed=8)
    kpos = np.broadcast_to(np.arange(t, dtype=np.int32)[None], (b, t)).copy()
    qp = np.full((b,), t - 1, np.int32)
    (jq, tq), (jk, tk), (jv, tv), (jkp, tkp), (jqp, tqp) = (
        pair(a) for a in (q, k, v, kpos, qp))
    out = decode_attention(tq, tk, tv, tkp, tqp)
    close(ops.decode_attention(jq, jk, jv, jkp, jqp, interpret=True), out)
    trunc = decode_attention_plain(tq, tk, tv,
                                   torch.where(tkp < 128, tkp, -1), tqp)
    assert (out - trunc).abs().max().item() > 1e-2


@needs_pallas
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_wrapped_ring(dtype):
    """A ring whose positions wrapped: slot ``p % T`` holds the newest
    position ``p``; rows at different depths, one with a window."""
    b, h, hkv, dh, t = 3, 8, 2, 64, 96
    q, k, v = decode_inputs(b, h, hkv, dh, t, seed=11)
    qp = np.asarray([250, 95, 40], np.int32)
    kpos = np.full((b, t), -1, np.int32)
    for r, p in enumerate(qp):
        for pos in range(p + 1):
            kpos[r, pos % t] = pos
    for window in (-1, 48):
        (jq, tq), (jk, tk), (jv, tv), (jkp, tkp), (jqp, tqp) = (
            pair(a, dtype) for a in (q, k, v, kpos, qp))
        out = decode_attention(tq, tk, tv, tkp, tqp, window=window)
        close(ops.decode_attention(jq, jk, jv, jkp, jqp, window=window,
                                   interpret=True), out, dtype)


@needs_pallas
@pytest.mark.parametrize("h,hkv,dh", [(8, 1, 112), (12, 1, 120),
                                      (16, 1, 120)],
                         ids=["kimi-dh112-g8", "dh120-g12", "dh120-g16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_kernel_at_new_head_shapes(h, hkv, dh, dtype):
    """The head dims and groups the kernels newly take; the reference
    pads dh to 128 lanes and rescales q for the padded scale."""
    (jq, tq), (jk, tk), (jv, tv) = (pair(a, dtype) for a in
                                    flash_inputs(1, 96, 96, h, hkv, dh, 13))
    for window in (-1, 40):
        out = flash_attention(tq, tk, tv, causal=True, window=window)
        close(ops.flash_attention(jq, jk, jv, causal=True, window=window,
                                  interpret=True), out, dtype)
        close(flash_oracle(jq, jk, jv, causal=True, window=window), out,
              dtype)


@needs_pallas
@pytest.mark.parametrize("h,hkv,dh", [(8, 1, 112), (12, 1, 120),
                                      (16, 1, 120)],
                         ids=["kimi-dh112-g8", "dh120-g12", "dh120-g16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_kernel_at_new_head_shapes(h, hkv, dh, dtype):
    """A wrapped 96-slot ring at the new shapes; the reference pads dh to
    128 lanes and G to the 8-row sublane."""
    b, t = 2, 96
    q, k, v = decode_inputs(b, h, hkv, dh, t, seed=17)
    qp = np.asarray([250, 40], np.int32)
    kpos = np.full((b, t), -1, np.int32)
    for r, p in enumerate(qp):
        for pos in range(p + 1):
            kpos[r, pos % t] = pos
    for window in (-1, 48):
        (jq, tq), (jk, tk), (jv, tv), (jkp, tkp), (jqp, tqp) = (
            pair(a, dtype) for a in (q, k, v, kpos, qp))
        out = decode_attention(tq, tk, tv, tkp, tqp, window=window)
        close(ops.decode_attention(jq, jk, jv, jkp, jqp, window=window,
                                   interpret=True), out, dtype)
        close(decode_oracle(jq, jk, jv, jkp, jqp, window), out, dtype)


# ---------------------------------------------------------------------------
# Wrappers on the CPU
# ---------------------------------------------------------------------------


def test_wrappers_cpu_take_plain_versions_and_count_no_launch():
    q, k, v = (torch.from_numpy(a) for a in flash_inputs(1, 40, 40, 4, 2, 32))
    before = (flash_attention.launches, decode_attention.launches)
    torch.testing.assert_close(flash_attention(q, k, v, window=8),
                               flash_attention_plain(q, k, v, window=8),
                               rtol=0, atol=0)
    kpos = torch.arange(40, dtype=torch.int32)[None]
    qp = torch.tensor([39], dtype=torch.int32)
    torch.testing.assert_close(decode_attention(q[:, :1], k, v, kpos, qp),
                               decode_attention_plain(q[:, :1], k, v, kpos,
                                                      qp), rtol=0, atol=0)
    assert (flash_attention.launches, decode_attention.launches) == before


@pytest.mark.parametrize("bad", ["dtype", "kpos_dtype", "shape", "heads"])
def test_wrappers_reject_bad_inputs(bad):
    q, k, v = (torch.from_numpy(a) for a in flash_inputs(1, 40, 40, 4, 2, 32))
    kpos = torch.arange(40, dtype=torch.int32)[None]
    qp = torch.tensor([39], dtype=torch.int32)
    fargs, dargs = [q, k, v], [q[:, :1], k, v, kpos, qp]
    if bad == "dtype":
        fargs[1] = k.double()
        dargs[1] = k.double()
    elif bad == "kpos_dtype":
        fargs[0] = q[0]
        dargs[3] = kpos.long()
    elif bad == "shape":
        fargs[2] = v[:, :5]
        dargs[0] = q[:, :2]
    else:
        fargs[0] = q[:, :, :3]
        dargs[0] = q[:, :1, :3]
    with pytest.raises(ValueError):
        flash_attention(*fargs)
    with pytest.raises(ValueError):
        decode_attention(*dargs)


# ---------------------------------------------------------------------------
# Ring modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window,max_context,chunk", [(-1, 128, 32),
                                                      (24, 128, 32),
                                                      (256, 4096, 128),
                                                      (100, 96, 64)])
def test_kv_cache_size(window, max_context, chunk):
    assert tattn.kv_cache_size(TBlockSpec(window=window), max_context,
                               chunk) == jattn.kv_cache_size(
        BlockSpec(window=window), max_context, chunk)


@pytest.mark.parametrize("s_new,start", [(5, [0, 3]), (7, [60, 13]),
                                         (100, [0, 20]), (1, [63, 64])],
                         ids=["fill", "wrap", "longer-than-ring", "decode"])
def test_cache_write_matches_reference(s_new, start):
    b, size, hkv, dh = 2, 64, 2, 8
    rng = np.random.default_rng(4)
    k0 = rng.standard_normal((b, size, hkv, dh)).astype(np.float32)
    kp0 = rng.integers(-1, 50, (b, size)).astype(np.int32)
    kn = rng.standard_normal((b, s_new, hkv, dh)).astype(np.float32)
    vn = rng.standard_normal((b, s_new, hkv, dh)).astype(np.float32)
    st = np.asarray(start, np.int32)
    jc = jattn.cache_write(jattn.KVCache(jnp.asarray(k0), jnp.asarray(-k0),
                                         jnp.asarray(kp0)),
                           jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(st))
    tc = tattn.KVCache(torch.from_numpy(k0.copy()), torch.from_numpy(-k0),
                       torch.from_numpy(kp0.copy()))
    out = tattn.cache_write(tc, torch.from_numpy(kn), torch.from_numpy(vn),
                            torch.from_numpy(st))
    assert out.k is tc.k and out.kpos is tc.kpos         # in place
    for a, w in zip(out, jc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))


@pytest.mark.parametrize("s,window,chunk", [(96, -1, 32), (96, 24, 32),
                                            (128, 16, 32), (50, 24, 32),
                                            (64, -1, 64)],
                         ids=["chunked", "chunked-window", "sliced-window",
                              "irregular", "one-chunk"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_full_matches_reference(s, window, chunk, dtype):
    (jq, tq), (jk, tk), (jv, tv) = (pair(a, dtype) for a in
                                    flash_inputs(2, s, s, 4, 2, 16, 7))
    out = tattn.attention_full(tq, tk, tv, window=window, chunk=chunk)
    close(jattn.attention_full(jq, jk, jv, window=window, chunk=chunk), out,
          dtype)
    noncausal = tattn.attention_full(tq, tk, tv, window=window, chunk=chunk,
                                     causal=False)
    close(jattn.attention_full(jq, jk, jv, window=window, chunk=chunk,
                               causal=False), noncausal, dtype)


@pytest.mark.parametrize("sq,window", [(1, -1), (1, 24), (64, 24)])
def test_attention_cached_on_ring_matches_reference(sq, window):
    b, size, h, hkv, dh = 2, 64, 4, 2, 16
    rng = np.random.default_rng(9)
    q = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, size, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, size, hkv, dh)).astype(np.float32)
    top = np.asarray([[150], [40]], np.int32)
    qpos = (top - sq + 1 + np.arange(sq)[None]).astype(np.int32)
    kpos = np.full((b, size), -1, np.int32)
    for r in range(b):
        for pos in range(top[r, 0] + 1):
            kpos[r, pos % size] = pos
    jc = jattn.KVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(kpos))
    tc = tattn.KVCache(*(torch.from_numpy(a) for a in (k, v, kpos)))
    out = tattn.attention_cached(torch.from_numpy(q), tc,
                                 torch.from_numpy(qpos), window=window,
                                 chunk=32)
    close(jattn.attention_cached(jnp.asarray(q), jc, jnp.asarray(qpos),
                                 window=window, chunk=32), out)


@needs_pallas
@pytest.mark.parametrize("window", [-1, 16])
def test_ring_attention_blocks_at_kimi_heads(window):
    """kimi-k2's head shape (dh 112, G = 8) over a narrow d_model with
    ``use_pallas``: the port's ring prefill (flash) and two decode steps
    (ring decode), their wrappers' plain versions here, against
    ``repro.models.attention``, outputs and rings.  With the window the
    40-token prompt wraps its 32-slot ring."""
    kw = dict(d_model=64, n_heads=16, n_kv_heads=2, d_head=112,
              dtype="float32", use_pallas=True, window=window,
              attn_chunk=16)
    jcfg = jget("kimi-k2-1t-a32b").replace(**kw)
    tcfg = tget("kimi-k2-1t-a32b").replace(**kw)
    rng = np.random.default_rng(21)
    shapes = {"wq": (64, 16, 112), "wk": (64, 2, 112), "wv": (64, 2, 112),
              "wo": (16, 112, 64)}
    params = {k: (rng.standard_normal(s) / np.sqrt(s[0] if k != "wo"
                                                   else 16 * 112)
                  ).astype(np.float32) for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    size = jattn.kv_cache_size(BlockSpec(window=window), 64, 16)
    assert size < 40 if window > 0 else size == 64
    b, s = 2, 40
    jc = jattn.KVCache(jnp.zeros((b, size, 2, 112)),
                       jnp.zeros((b, size, 2, 112)),
                       jnp.full((b, size), -1, jnp.int32))
    tc = tattn.KVCache(torch.zeros(b, size, 2, 112),
                       torch.zeros(b, size, 2, 112),
                       torch.full((b, size), -1, dtype=torch.int32))
    x = rng.standard_normal((b, s, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    jo, jc = jattn.self_attention_prefill(jp, jnp.asarray(x), jc, jcfg,
                                          BlockSpec(window=window),
                                          jnp.asarray(pos))
    to, tc = tattn.self_attention_prefill(tp, torch.from_numpy(x), tc, tcfg,
                                          TBlockSpec(window=window),
                                          torch.from_numpy(pos))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-4,
                               rtol=1e-4)
    for step in range(2):
        x1 = rng.standard_normal((b, 1, 64)).astype(np.float32)
        p1 = np.full((b, 1), s + step, np.int32)
        jo, jc = jattn.self_attention_cached(jp, jnp.asarray(x1), jc, jcfg,
                                             BlockSpec(window=window),
                                             jnp.asarray(p1))
        to, tc = tattn.self_attention_cached(tp, torch.from_numpy(x1), tc,
                                             tcfg, TBlockSpec(window=window),
                                             torch.from_numpy(p1))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-4,
                                   rtol=1e-4)
    for t, j in zip(tc, jc):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=1e-5)
