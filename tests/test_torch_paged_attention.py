"""Port paged decode attention vs the JAX reference.

The port's wrapper on CPU tensors runs its plain version; it is held
against the reference's Pallas kernel in interpret mode
(``ops.paged_decode_attention(interpret=True)``) and its jnp oracle
(``ref.paged_decode_attention_ref``) over the cases of
tests/test_kernels.py's paged sweep.  Live rows only: a ctx == 0 row is
padding whose value differs by design.  Tolerance: 2e-5 f32, 2e-2 bf16
(tests/test_kernels.py).  The kernel itself runs only on the card
(tests/test_torch_cuda.py).
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
from repro_torch.kernels import paged_decode_attention  # noqa: E402
from repro_torch.kernels.paged_decode_attention import (  # noqa: E402
    paged_decode_attention_plain)
from repro_torch.models import attention as tattn  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
needs_pallas = pytest.mark.skipif(not HAVE_PALLAS_API,
                                  reason=PALLAS_SKIP_REASON)


def paged_case(b, hkv, g, dh, page, per_seq, shared=0, seed=9):
    """numpy pool + block tables: ``shared`` leading physical pages in
    every row (a cached prefix), the rest private to each row."""
    rng = np.random.default_rng(seed)
    n = shared + b * (per_seq - shared)
    q = rng.standard_normal((b, 1, hkv * g, dh)).astype(np.float32)
    kp = rng.standard_normal((n, page, hkv, dh)).astype(np.float32)
    vp = rng.standard_normal((n, page, hkv, dh)).astype(np.float32)
    rows, nxt = [], shared
    for _ in range(b):
        rows.append(list(range(shared))
                    + list(range(nxt, nxt + per_seq - shared)))
        nxt += per_seq - shared
    return q, kp, vp, np.asarray(rows, np.int32)


def _torch(a, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        getattr(torch, dtype) if a.dtype == np.float32 else torch.int32)


def _jax(a, dtype="float32"):
    return jnp.asarray(a).astype(dtype) if a.dtype == np.float32 \
        else jnp.asarray(a)


def check_against_reference(q, kp, vp, bt, ctx, window=-1,
                            dtype="float32"):
    b, _, h, dh = q.shape
    hkv = kp.shape[2]
    out = paged_decode_attention(*(_torch(a, dtype)
                                   for a in (q, kp, vp, bt, ctx)),
                                 window=window)
    assert out.dtype == getattr(torch, dtype)
    out = out.float().numpy()
    jq, jk, jv, jbt, jctx = (_jax(a, dtype) for a in (q, kp, vp, bt, ctx))
    want_kernel = ops.paged_decode_attention(jq, jk, jv, jbt, jctx,
                                             window=window, interpret=True)
    want_ref = ref.paged_decode_attention_ref(
        jq.reshape(b, hkv, h // hkv, dh), jk, jv, jbt, jctx, window=window)
    live = ctx > 0
    for want in (want_kernel, want_ref):
        want = np.asarray(want.astype(jnp.float32)).reshape(out.shape)
        np.testing.assert_allclose(out[live], want[live], atol=TOL[dtype],
                                   rtol=TOL[dtype])
    return out


@needs_pallas
@pytest.mark.parametrize("b,hkv,g,dh,page,per_seq", [
    (2, 2, 4, 64, 16, 4),       # GQA
    (1, 1, 1, 128, 32, 3),      # MQA, single row, wide head
    (3, 4, 2, 32, 16, 5),
])
@pytest.mark.parametrize("aligned", [True, False])
def test_plain_matches_reference_sweep(b, hkv, g, dh, page, per_seq,
                                       aligned):
    q, kp, vp, bt = paged_case(b, hkv, g, dh, page, per_seq)
    full = per_seq * page
    ctx = np.full((b,), full, np.int32) if aligned else \
        np.asarray([full - 1 - 7 * i for i in range(b)], np.int32)
    check_against_reference(q, kp, vp, bt, ctx)


@needs_pallas
def test_plain_shared_prefix_rows():
    b, hkv, g, dh, page, per_seq = 3, 2, 2, 64, 16, 6
    q, kp, vp, bt = paged_case(b, hkv, g, dh, page, per_seq, shared=2)
    ctx = np.asarray([per_seq * page, per_seq * page - 5, 2 * page + 3],
                     np.int32)
    check_against_reference(q, kp, vp, bt, ctx)
    # identical tables, lengths and query: bit-identical rows, because
    # the prefix really is one physical copy
    bt[1], q[1], ctx[1] = bt[0], q[0], ctx[0]
    out = check_against_reference(q, kp, vp, bt, ctx)
    np.testing.assert_array_equal(out[0], out[1])


@needs_pallas
def test_plain_unmapped_tail():
    b, hkv, g, dh, page = 2, 2, 2, 64, 16
    q, kp, vp, bt = paged_case(b, hkv, g, dh, page, per_seq=4)
    bt[1, 2:] = -1                          # row 1 maps only 2 pages
    ctx = np.asarray([4 * page - 2, page + 5], np.int32)
    check_against_reference(q, kp, vp, bt, ctx)


@needs_pallas
@pytest.mark.parametrize("window", [24, 64])
def test_plain_window(window):
    b, hkv, g, dh, page = 2, 2, 4, 64, 16
    q, kp, vp, bt = paged_case(b, hkv, g, dh, page, per_seq=5)
    ctx = np.asarray([5 * page - 3, 3 * page + 9], np.int32)
    check_against_reference(q, kp, vp, bt, ctx, window=window)


@needs_pallas
def test_plain_bf16():
    b, hkv, g, dh, page = 2, 2, 4, 64, 16
    q, kp, vp, bt = paged_case(b, hkv, g, dh, page, per_seq=4)
    ctx = np.asarray([4 * page, 3 * page - 6], np.int32)
    check_against_reference(q, kp, vp, bt, ctx, dtype="bfloat16")


@needs_pallas
def test_plain_inactive_row_is_not_compared_but_finite():
    # an inactive slot (ctx 0, all -1 row) rides along in every decode
    # step; live rows must be unaffected by it
    b, hkv, g, dh, page = 2, 2, 2, 32, 16
    q, kp, vp, bt = paged_case(b, hkv, g, dh, page, per_seq=3)
    bt[1] = -1
    ctx = np.asarray([2 * page + 1, 0], np.int32)
    out = check_against_reference(q, kp, vp, bt, ctx)
    assert np.isfinite(out).all()


@needs_pallas
@pytest.mark.parametrize("hkv,g,dh", [(1, 8, 112), (1, 12, 120),
                                      (1, 16, 120)],
                         ids=["kimi-dh112-g8", "dh120-g12", "dh120-g16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [-1, 24])
def test_plain_matches_reference_at_new_head_shapes(hkv, g, dh, dtype,
                                                    window):
    """The head dims and groups the kernels newly take: the reference
    pads dh to 128 lanes and G to the 8-row sublane, the port pads
    nothing; ragged contexts, an unmapped tail and an inactive row."""
    b, page, per_seq = 3, 16, 3
    q, kp, vp, bt = paged_case(b, hkv, g, dh, page, per_seq, shared=1)
    bt[1, 2:] = -1
    bt[2] = -1
    ctx = np.asarray([per_seq * page - 5, page + 7, 0], np.int32)
    check_against_reference(q, kp, vp, bt, ctx, window=window, dtype=dtype)


def test_wrapper_cpu_takes_plain_version_and_counts_no_launch():
    q, kp, vp, bt = paged_case(2, 2, 2, 32, 16, 3)
    ctx = np.asarray([40, 17], np.int32)
    args = [_torch(a) for a in (q, kp, vp, bt, ctx)]
    before = paged_decode_attention.launches
    out = paged_decode_attention(*args)
    assert paged_decode_attention.launches == before
    torch.testing.assert_close(out, paged_decode_attention_plain(*args),
                               rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["dtype", "table_dtype", "shape"])
def test_wrapper_rejects_bad_inputs(bad):
    q, kp, vp, bt = paged_case(2, 2, 2, 32, 16, 3)
    args = [_torch(a) for a in (q, kp, vp, bt, np.asarray([40, 17],
                                                         np.int32))]
    if bad == "dtype":
        args[1] = args[1].double()
    elif bad == "table_dtype":
        args[3] = args[3].long()
    else:
        args[0] = args[0][:, 0]
    with pytest.raises(ValueError):
        paged_decode_attention(*args)


# ---------------------------------------------------------------------------
# Pool writes and the gather view
# ---------------------------------------------------------------------------


def test_paged_cache_write_at_sink_routing_and_view():
    rng = np.random.default_rng(5)
    n, page, hkv, dh = 6, 4, 2, 8
    k0 = rng.standard_normal((n + 1, page, hkv, dh)).astype(np.float32)
    v0 = rng.standard_normal((n + 1, page, hkv, dh)).astype(np.float32)
    tables = np.asarray([[3, 1, -1], [-1, -1, -1], [0, 5, 2]], np.int32)
    # row 0 crosses into an unmapped page; row 1 is an inactive slot;
    # row 2 carries -1 positions (padding) and positions past the table
    pos = np.asarray([[6, 7, 8, 9], [0, 1, 2, 3], [4, -1, 13, 11]],
                     np.int32)
    kn = rng.standard_normal((3, 4, hkv, dh)).astype(np.float32)
    vn = rng.standard_normal((3, 4, hkv, dh)).astype(np.float32)

    jc = jattn.paged_cache_write_at(
        jattn.PagedKVCache(jnp.asarray(k0), jnp.asarray(v0)),
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos),
        jnp.asarray(tables))
    tc = tattn.PagedKVCache(torch.from_numpy(k0.copy()),
                            torch.from_numpy(v0.copy()))
    out = tattn.paged_cache_write_at(tc, torch.from_numpy(kn),
                                     torch.from_numpy(vn),
                                     torch.from_numpy(pos),
                                     torch.from_numpy(tables))
    assert out.k is tc.k                    # updated in place
    # every real page matches exactly; the sink takes several writes in
    # an order neither side defines, so only its page id is checked
    np.testing.assert_array_equal(tc.k[:n].numpy(), np.asarray(jc.k)[:n])
    np.testing.assert_array_equal(tc.v[:n].numpy(), np.asarray(jc.v)[:n])
    assert not np.array_equal(tc.k[n].numpy(), k0[n])
    phys, slot = tattn._phys_slots(tc, torch.from_numpy(tables),
                                   torch.from_numpy(pos))
    jphys, jslot = jattn._phys_slots(jc, jnp.asarray(tables),
                                     jnp.asarray(pos))
    np.testing.assert_array_equal(phys.numpy(), np.asarray(jphys))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))

    view_t = tattn.paged_view(tc, torch.from_numpy(tables))
    view_j = jattn.paged_view(jc, jnp.asarray(tables))
    live = [0, 2]
    np.testing.assert_array_equal(view_t.kpos.numpy(),
                                  np.asarray(view_j.kpos))
    np.testing.assert_array_equal(view_t.k.numpy()[live],
                                  np.asarray(view_j.k)[live])
    np.testing.assert_array_equal(view_t.v.numpy()[live],
                                  np.asarray(view_j.v)[live])


# ---------------------------------------------------------------------------
# The paged attention block at kimi-k2's head shape
# ---------------------------------------------------------------------------


def kimi_heads(**kw):
    """kimi-k2's attention head shape (dh 112 = 7168 / 64, G = 8) over a
    narrow d_model: 16 query heads over 2 KV heads, f32, kernels on."""
    kw = dict(d_model=64, n_heads=16, n_kv_heads=2, d_head=112,
              dtype="float32", use_pallas=True, **kw)
    return jget("kimi-k2-1t-a32b").replace(**kw), \
        tget("kimi-k2-1t-a32b").replace(**kw)


def attn_params(cfg, seed=0):
    """numpy attention weights of ``cfg``, fan-in scaled."""
    rng = np.random.default_rng(seed)
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    shapes = {"wq": (d, h, dh), "wk": (d, hkv, dh), "wv": (d, hkv, dh),
              "wo": (h, dh, d)}
    return {k: (rng.standard_normal(s) / np.sqrt(s[-2] if k != "wo"
                                                  else h * dh)
                ).astype(np.float32) for k, s in shapes.items()}


@needs_pallas
@pytest.mark.parametrize("window", [-1, 24])
def test_self_attention_paged_decode_at_kimi_heads(window):
    """``self_attention_paged`` at one decode token with ``use_pallas``:
    the port (its wrapper's plain version here) against
    ``repro.models.attention`` (the Pallas kernel in interpret mode),
    outputs of the live rows and the written pool.  Row 2 is an inactive
    slot (an all -1 table row), whose write goes to the sink page."""
    jcfg, tcfg = kimi_heads(window=window)
    params = attn_params(jcfg)
    page, n = 16, 7
    rng = np.random.default_rng(1)
    kp = rng.standard_normal((n + 1, page, 2, 112)).astype(np.float32)
    vp = rng.standard_normal((n + 1, page, 2, 112)).astype(np.float32)
    tables = np.asarray([[4, 0, 2], [5, 1, -1], [-1, -1, -1]], np.int32)
    pos = np.asarray([[40], [22], [0]], np.int32)
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
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
    np.testing.assert_allclose(tout.numpy()[:2], np.asarray(jout)[:2],
                               atol=1e-4, rtol=1e-4)
    for t, j in zip(tcache, jcache):        # real pages; the sink aside
        np.testing.assert_allclose(t.numpy()[:n], np.asarray(j)[:n],
                                   atol=1e-5, rtol=1e-5)
