"""The last shapes the reference takes and the port refused (ROADMAP
A7.1), on the CPU.

The reference pads any attention head dim to a multiple of 128 before
its Pallas kernels (``repro/kernels/ops.py``) and scans in jnp at any
width (``repro/models/ssm.py``).  The port's attention kernels now take a
dh past 256 in column blocks (``kernels/attention_shapes.py``), and its
scan any dk and dv (``kernels/ssm_scan.py``).  Here, on the CPU:

* the domain: every dh and width from 1 runs, and what is still refused
  names its cause (a dtype, a size below 1, a grid's rows, a decode
  CTA's shared memory); the launch checks take the two new configs;
* the plain versions of flash (and its gradient), ring and paged decode
  at dh 300, 384 and 512 (G 1, 2, 3) against the Pallas kernels in
  interpret mode and the jnp oracles (2e-5 in f32, 2e-2 in bf16);
* ``ssm_scan_plain`` at xLSTM's mLSTM widths at 1.3B (dk 1024, dv 1025)
  and 2.7B (1280, 1281), y, h_T and every gradient against
  ``repro.models.ssm.chunked_linear_attention`` and ``jax.grad`` (1e-4);
* CPU emulations of the new tilings against the plain versions: the
  decode kernels' column-block CTAs (every block's CTA computes the
  whole scores and agrees on m and l bit for bit), the flash forward's
  chunked S and column-block output (bf16 and f32 bodies), and the flash
  backward's column-block dK/dV and dQ passes;
* the model level: xlstm-350m at d_model 2048 (its mLSTM at dk 1024, dv
  1025; one mLSTM and one sLSTM layer) and agent-7b's width at d_head
  512 (d_model 4096, 8 query heads over 4; one layer, d_ff cut to 512),
  with a small vocab and ``use_pallas`` on: prefill and decode logits
  within the reference's bands (1e-4, 2e-3) and greedy engine tokens
  equal to the JAX ``Engine``'s (ring for xLSTM; paged and ring for the
  dense model).
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
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving.engine import Engine  # noqa: E402
from repro.serving.scheduler import SchedulerConfig as JSched  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.core.types import Request  # noqa: E402
from repro_torch.kernels import (decode_attention,  # noqa: E402
                                 flash_attention, paged_decode_attention)
from repro_torch.kernels.attention_shapes import (  # noqa: E402
    BLOCK_WIDTH, check_attention_shape, check_decode_shape, check_grid,
    col_blocks, group_chunk)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_backward_plain, flash_attention_plain)
from repro_torch.kernels.ssm_scan import (backward_plan,  # noqa: E402
                                          scan_plan, ssm_scan_plain)
from repro_torch.configs.base import SHAPES, shape_applicable  # noqa: E402
from repro_torch.launch.mesh import (ShapeMesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.launch.serve import check_serve  # noqa: E402
from repro_torch.launch.specs import input_pspecs  # noqa: E402
from repro_torch.launch.train import check_mesh  # noqa: E402
from repro_torch.serving.engine import TorchEngine  # noqa: E402
from repro_torch.serving.scheduler import SchedulerConfig  # noqa: E402

from test_torch_wide_heads import (close, decode_oracle,  # noqa: E402
                                   flash_oracle, lse_oracle, normal, pair,
                                   pool_arrays, rel, ring_arrays)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SCAN_TOL = 1e-4
DECODE_LOGIT_TOL = 2e-3          # tests/test_paged_engine.py:91-93
needs_pallas = pytest.mark.skipif(not HAVE_PALLAS_API,
                                  reason=PALLAS_SKIP_REASON)
# (dh, G, Hkv)
SWEEP = [(300, 1, 2), (384, 2, 2), (512, 3, 1)]
LOG2E = 1.4426950408889634
NEG_INF = -1e30

# the two new configs at full width (chip_smoke.py's WIDE_MODELS entries)
XLSTM_13B = dict(d_model=2048)
AGENT_7B_D512 = dict(d_head=512, n_heads=8, n_kv_heads=4)


# ---------------------------------------------------------------------------
# The domain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_any_head_dim_and_scan_width_is_taken(dtype):
    """The acceptance shapes return, and so do much wider ones."""
    check_attention_shape(torch.bfloat16, 512, 2)
    for dh in (257, 300, 384, 512, 1024, 2000, 4096, 9728):
        for g in (1, 2, 3, 5, 16, 48):
            check_attention_shape(dtype, dh, g)
            check_decode_shape(dtype, dh, g)
    for dk, dv in ((1024, 1025), (1280, 1281), (600, 1100), (4096, 4097)):
        plan = scan_plan(4, 1024, 4, dk, dv, 128, True, True)
        assert not plan.fast and plan.states_shape == (4, 4, 8, dk, dv)
        bplan = backward_plan(4, 1024, 4, dk, dv, 128, 8, True)
        assert not bplan.fused and bplan.n_parts == 2 * -(-dk // 64)
        assert bplan.states_shape == (4, 4, 8, dk, -(-dv // 8) * 8)
    # 0.54 GB of f32 chunk states at the 1.3B width, B 4, T 1024, H 4
    assert math.prod(scan_plan(4, 1024, 4, 1024, 1025, 128, True,
                               True).states_shape) * 4 == 537_395_200


@pytest.mark.parametrize("dh,blocks", [(1, 1), (256, 1), (257, 2),
                                       (300, 2), (512, 2), (1024, 4),
                                       (2000, 8)])
def test_col_blocks(dh, blocks):
    assert col_blocks(dh) == blocks


@pytest.mark.parametrize("call,match", [
    (lambda: check_decode_shape(torch.float16, 512, 2), "dtype"),
    (lambda: check_decode_shape(torch.float32, 0, 2), "dh 0"),
    (lambda: check_decode_shape(torch.float32, 512, 0), "G 0"),
    (lambda: check_decode_shape(torch.float32, 9736, 5), "shared memory"),
    (lambda: check_grid(32768, 4, 4, 512), "65536 grid rows"),
    (lambda: scan_plan(65536, 64, 1, 1024, 1025, 64, True, True), "B 65536"),
    (lambda: scan_plan(1, 64, 4096, 1024, 1025, 64, True, True),
     "chunk-state pass's grid"),
    (lambda: backward_plan(1, 64, 3000, 1024, 64, 64, 8, True),
     "dq/dk pass's grid"),
    (lambda: backward_plan(1, 64, 2, 0, 64, 64, 8, True), "dk 0")])
def test_what_is_still_refused_names_its_cause(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_launch_checks_take_the_new_configs():
    """The construction-time checks of the sharded serve and train steps
    take xlstm-350m at d_model 2048 and agent-7b at d_head 512 with the
    kernels on: the train step's at one device and over a model axis,
    the serve step's at every cell of the production mesh."""
    mesh = make_production_mesh()
    served = 0
    for name, widths in (("xlstm-350m", XLSTM_13B),
                         ("agent-7b", AGENT_7B_D512)):
        cfg = tconfigs.get_config(name).replace(use_pallas=True, **widths)
        for axes in ((1, 1), (1, 2), (2, 1), (1, 4)):
            check_mesh(cfg, ShapeMesh(("data", "model"), axes))
        for shape in SHAPES.values():
            if shape.kind != "train" and shape_applicable(cfg, shape)[0]:
                check_serve(cfg, mesh,
                            input_pspecs(cfg, shape, mesh)["cache"])
                served += 1
    assert served >= 4


# ---------------------------------------------------------------------------
# Plain versions against the Pallas kernels (interpret mode) and oracles
# ---------------------------------------------------------------------------

@needs_pallas
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh,g,hkv", SWEEP)
def test_flash_plain_matches_kernel_and_oracle(dh, g, hkv, dtype):
    s = 48
    (jq, tq), (jk, tk), (jv, tv) = (
        pair(normal(shape, dh + g + i), dtype)
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
    s, window = 32, 20
    arrays = [normal(shape, 5 * dh + g + i) for i, shape in enumerate(
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


@needs_pallas
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh,g,hkv", SWEEP)
def test_ring_decode_plain_matches_kernel_and_oracle(dh, g, hkv, dtype):
    q, k, v, kpos, qp = ring_arrays([130, 99, 40], 96, hkv, g, dh,
                                    3 * dh + g)
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
        assert torch.equal(out, out2)
        want = lse_oracle(*(np.asarray(jnp.asarray(a).astype(jnp.float32))
                            for a in (jq, jk)), kpos, qp, window)
        np.testing.assert_allclose(lse.numpy(), want, atol=1e-4, rtol=1e-5)


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
# The scan at the mLSTM's 1.3B and 2.7B widths
# ---------------------------------------------------------------------------

def scan_arrays(b, t, h, dk, dv, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, t, h, dk)) * dk ** -0.5).astype(np.float32)
    k = (rng.standard_normal((b, t, h, dk)) * dk ** -0.5).astype(np.float32)
    v = rng.standard_normal((b, t, h, dv)).astype(np.float32)
    la = -rng.uniform(0, 0.2, (b, t, h)).astype(np.float32)
    h0 = (rng.standard_normal((b, h, dk, dv)) * 0.1).astype(np.float32)
    return q, k, v, la, h0


@pytest.mark.parametrize("dk,dv", [(1024, 1025), (1280, 1281)])
def test_scan_plain_matches_the_reference_and_its_gradient(dk, dv):
    """``ssm_scan_plain`` (the kernel's plain version, the CPU's scan)
    against the reference's ``chunked_linear_attention`` at a T that is a
    multiple of the chunk (the reference asserts it): y and h_T, and the
    gradients of q, k, v, log_a and h0 against ``jax.grad``, each within
    1e-4 of its largest magnitude."""
    b, t, h, chunk = 1, 64, 2, 32
    arrays = scan_arrays(b, t, h, dk, dv, dk)
    rng = np.random.default_rng(dv)
    dy = rng.standard_normal((b, t, h, dv)).astype(np.float32)
    dht = rng.standard_normal((b, h, dk, dv)).astype(np.float32) * 0.1
    jy, jh = jssm.chunked_linear_attention(*map(jnp.asarray, arrays),
                                           chunk=chunk)
    xs = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    ty, th = ssm_scan_plain(*xs, chunk=chunk)
    assert rel(ty.detach().numpy(), np.asarray(jy)) <= SCAN_TOL
    assert rel(th.detach().numpy(), np.asarray(jh)) <= SCAN_TOL

    def loss(*a):
        y, hT = jssm.chunked_linear_attention(*a, chunk=chunk)
        return jnp.sum(y * dy) + jnp.sum(hT * dht)
    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray,
                                                        arrays))
    got = torch.autograd.grad((ty, th), xs, (torch.from_numpy(dy),
                                             torch.from_numpy(dht)))
    for x, y in zip(got, want):
        assert x.shape == y.shape
        assert rel(x.numpy(), np.asarray(y)) <= SCAN_TOL


# ---------------------------------------------------------------------------
# The new tilings, emulated
# ---------------------------------------------------------------------------

def wide_decode_emulation(q, k, v, valid, dh, unroll=4):
    """The wide decode body of one warp over the valid rows of one
    (sequence, KV head): q (G, dh), k and v (T, dh) f32.  One CTA a
    column block of 256: lane l holds elements 8 l .. 8 l + 7 of every
    block of a row, sums q . k over the blocks in the lane, then the warp
    reduces by the xor butterfly; each CTA folds only its own block of V.
    Returns the blocks' outputs joined, after checking that the CTAs
    agree on m and l bit for bit."""
    g = q.shape[0]
    nb = col_blocks(dh)
    dhp = nb * BLOCK_WIDTH

    def lanes(x):                       # (..., dh) -> (..., blocks, 32, 8)
        z = torch.zeros(x.shape[:-1] + (dhp,))
        z[..., :dh] = x
        return z.reshape(x.shape[:-1] + (nb, 32, 8))
    qs = lanes(q * (LOG2E / math.sqrt(dh)))                  # (G, nb, 32, 8)
    rows = torch.nonzero(valid).flatten()
    outs, states = [], []
    for cb in range(nb):
        m = torch.full((g,), NEG_INF)
        l = torch.zeros(g)
        acc = torch.zeros((g, 32, 8))
        for j0 in range(0, len(rows), unroll):
            n = min(unroll, len(rows) - j0)
            s = torch.full((g, unroll), -math.inf)
            vr = torch.zeros((unroll, 32, 8))
            for u in range(n):
                kr = lanes(k[rows[j0 + u]])                  # (nb, 32, 8)
                vr[u] = lanes(v[rows[j0 + u]])[cb]
                part = torch.zeros((g, 32))
                for c in range(nb):                          # block by block
                    part = part + (qs[:, c] * kr[c]).sum(-1)
                o = 16
                while o > 0:                                 # butterfly
                    part = part + part[:, torch.arange(32) ^ o]
                    o //= 2
                s[:, u] = part[:, 0]
            mx = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - mx)
            p = torch.exp2(s - mx[:, None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[:, None, None] + torch.einsum("gu,uld->gld", p,
                                                            vr)
            m = mx
        states.append((m, l))
        outs.append(acc.reshape(g, BLOCK_WIDTH) / l[:, None])
    for m, l in states[1:]:
        assert torch.equal(m, states[0][0]) and torch.equal(l, states[0][1])
    return torch.cat(outs, -1)[:, :dh]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dh,g", [(300, 1), (384, 2), (512, 3), (1024, 2),
                                  (777, 1)])
def test_wide_decode_blocks_match_plain(dtype, dh, g):
    q, k, v, kpos, qp = (torch.from_numpy(a) for a in ring_arrays(
        [300], 160, 1, g, dh, dh + g))
    if dtype == torch.bfloat16:           # the values a bf16 ring holds
        q, k, v = (x.to(torch.bfloat16).float() for x in (q, k, v))
    valid = (kpos[0] >= 0) & (kpos[0] <= qp[0]) & (kpos[0] > qp[0] - 100)
    got = wide_decode_emulation(q[0, 0], k[0, :, 0], v[0, :, 0], valid, dh)
    want = decode_attention_plain(q, k, v, kpos, qp, window=100)[0, 0]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert group_chunk(g) == g


def wide_flash_emulation(q, k, v, causal, window, block, tk, p_bf16):
    """The flash forward's column-block bodies: per (b, head, 64 query
    rows, block of ``block`` output columns), tiles of ``tk`` keys whose
    S sums 64-column chunks of dh, the online softmax (exp2 units), P
    rounded to bf16 where ``p_bf16`` (the tensor-core body), and O += P V
    over the CTA's columns.  Returns (out, the blocks' m and l agree)."""
    b, s, h, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    c = LOG2E / math.sqrt(dh)
    out = torch.zeros(b, s, h, dh)
    qi = torch.arange(s)[:, None]
    kj = torch.arange(t)[None, :]
    ok = torch.ones(s, t, dtype=torch.bool)
    if causal:
        ok = kj <= qi
        if window > 0:
            ok &= kj > qi - window
    for bi in range(b):
        for hi in range(h):
            qf, kf = q[bi, :, hi].float(), k[bi, :, hi // g].float()
            vf = v[bi, :, hi // g].float()
            seen = None
            for col0 in range(0, dh, block):
                cols = slice(col0, min(col0 + block, dh))
                m = torch.full((s,), NEG_INF)
                l = torch.zeros(s)
                acc = torch.zeros(s, cols.stop - col0)
                for k0 in range(0, t, tk):
                    ks = slice(k0, min(k0 + tk, t))
                    sc = torch.zeros(s, ks.stop - k0)
                    for c0 in range(0, dh, 64):              # the chunks
                        sc = sc + qf[:, c0:c0 + 64] @ kf[ks, c0:c0 + 64].T
                    sc = sc.masked_fill(~ok[:, ks], -math.inf)
                    mx = torch.maximum(m, sc.amax(1))
                    alpha = torch.exp2((m - mx) * c)
                    p = torch.exp2(sc * c - (mx * c)[:, None])
                    pv = (p.to(torch.bfloat16).float() if p_bf16 else p)
                    m, l = mx, l * alpha + p.sum(1)
                    acc = acc * alpha[:, None] + pv @ vf[ks, cols]
                if seen is not None:
                    assert torch.equal(m, seen[0]) and torch.equal(l, seen[1])
                seen = (m, l)
                out[bi, :, hi, cols] = torch.where(
                    (l > 0)[:, None], acc / torch.clamp(l, min=1e-30)[:, None],
                    0.0)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dh,h,hkv,s,t,causal,window", [
    (512, 4, 2, 130, 130, True, -1),
    (384, 3, 1, 100, 100, True, 40),
    (304, 8, 2, 70, 90, False, -1),           # dh 300 padded to 304
    (1024, 2, 1, 80, 80, True, -1)])
def test_wide_flash_forward_blocks_match_plain(dtype, dh, h, hkv, s, t,
                                               causal, window):
    """bf16: 64-key tiles, 256-column blocks, P in bf16; f32: 32-key
    tiles, 64-column blocks, P in f32.  Against the plain version."""
    gen = torch.Generator().manual_seed(dh + s)
    q, k, v = (torch.randn(shape, generator=gen).to(dtype)
               for shape in ((1, s, h, dh), (1, t, hkv, dh), (1, t, hkv, dh)))
    bf16 = dtype == torch.bfloat16
    got = wide_flash_emulation(q, k, v, causal, window,
                               256 if bf16 else 64, 64 if bf16 else 32, bf16)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    tol = 2e-2 if bf16 else 2e-5
    torch.testing.assert_close(got.to(dtype).float(), want.float(),
                               atol=tol, rtol=tol)


def wide_backward_emulation(q, k, v, dout, causal, window, tile=16,
                            dq_block=64, kv_block=64, p_bf16=False):
    """The backward's column-block passes: dK/dV per (KV head, block of
    ``kv_block`` columns), walking the group's heads and ``tile``-query
    tiles; dQ per (head, block of ``dq_block``), walking ``tile``-key
    tiles; S and dP summed over 64-column chunks, P from the forward's
    log-sum-exp, D = rowsum(dO O); with ``p_bf16`` (the tensor-core
    body: 64-row tiles, dQ blocks of 128, dK/dV of 64) P and dS rounded
    to bf16 before the products that take them."""
    b, s, h, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1 / math.sqrt(dh)
    qf, kf, vf, df = (x.float() for x in (q, k, v, dout))
    of = flash_attention_plain(qf, kf, vf, causal=causal, window=window)
    qi = torch.arange(s)[:, None]
    kj = torch.arange(t)[None, :]
    ok = torch.ones(s, t, dtype=torch.bool)
    if causal:
        ok = kj <= qi
        if window > 0:
            ok &= kj > qi - window
    dq, dk, dv = (torch.zeros(x.shape) for x in (q, k, v))

    def rnd(x):
        return x.to(torch.bfloat16).float() if p_bf16 else x

    def chunked(a, bm):                   # a @ bm.T over 64-column chunks
        out = torch.zeros(a.shape[0], bm.shape[0])
        for c0 in range(0, dh, 64):
            out = out + a[:, c0:c0 + 64] @ bm[:, c0:c0 + 64].T
        return out
    for bi in range(b):
        lse = torch.logsumexp(
            torch.stack([chunked(qf[bi, :, hh], kf[bi, :, hh // g]) * scale
                         for hh in range(h)]).masked_fill(~ok, NEG_INF), -1)
        dsum = (df[bi] * of[bi]).sum(-1).T                   # (H, S)
        for hh in range(h):
            kh = hh // g
            for col0 in range(0, dh, dq_block):
                cols = slice(col0, col0 + dq_block)
                for k0 in range(0, t, tile):                 # dQ's tiles
                    ks = slice(k0, k0 + tile)
                    sc = chunked(qf[bi, :, hh], kf[bi, ks, kh]) * scale
                    dp = chunked(df[bi, :, hh], vf[bi, ks, kh])
                    p = torch.where(ok[:, ks],
                                    torch.exp(sc - lse[hh][:, None]), 0.0)
                    ds = p * (dp - dsum[hh][:, None])
                    dq[bi, :, hh, cols] += (rnd(ds) @ kf[bi, ks, kh, cols]
                                            * scale)
        for kh in range(hkv):
            for col0 in range(0, dh, kv_block):
                cols = slice(col0, col0 + kv_block)
                for hh in range(kh * g, (kh + 1) * g):
                    for i0 in range(0, s, tile):             # dK/dV's tiles
                        qs = slice(i0, i0 + tile)
                        st = chunked(kf[bi, :, kh], qf[bi, qs, hh]) * scale
                        dpt = chunked(vf[bi, :, kh], df[bi, qs, hh])
                        pt = torch.where(ok[qs].T,
                                         torch.exp(st - lse[hh][qs][None]),
                                         0.0)
                        dst = pt * (dpt - dsum[hh][qs][None])
                        dv[bi, :, kh, cols] += rnd(pt) @ df[bi, qs, hh, cols]
                        dk[bi, :, kh, cols] += (rnd(dst)
                                                @ qf[bi, qs, hh, cols]
                                                * scale)
    return dq, dk, dv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dh,h,hkv,s,t,causal,window", [
    (512, 4, 2, 70, 70, True, -1),
    (384, 3, 1, 50, 50, True, 20),
    (320, 2, 2, 40, 60, False, -1)])
def test_wide_flash_backward_blocks_match_plain(dtype, dh, h, hkv, s, t,
                                                causal, window):
    """f32: 16-row tiles, blocks of 64 (2e-5); bf16: 64-row tiles, dQ
    blocks of 128 and dK/dV of 64, P and dS in bf16 (2e-2)."""
    gen = torch.Generator().manual_seed(dh + s)
    q, k, v, dout = (torch.randn(shape, generator=gen).to(dtype)
                     for shape in ((1, s, h, dh), (1, t, hkv, dh),
                                   (1, t, hkv, dh), (1, s, h, dh)))
    bf16 = dtype == torch.bfloat16
    got = wide_backward_emulation(q, k, v, dout, causal, window,
                                  **(dict(tile=64, dq_block=128, p_bf16=True)
                                     if bf16 else {}))
    want = flash_attention_backward_plain(q, k, v, dout, causal=causal,
                                          window=window)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert rel(x.numpy(), y.float().numpy()) <= (2e-2 if bf16
                                                     else 2e-5), name


# ---------------------------------------------------------------------------
# The two new configs at the model and the engine
# ---------------------------------------------------------------------------

# (reference config name, cut): xlstm-350m at the paper's 1.3B width, one
# mLSTM and one sLSTM layer; agent-7b's width at d_head 512, one layer,
# d_ff cut to 512; both with a 256-token vocab
MODELS = {"xlstm-1.3b": ("xlstm-350m", dict(XLSTM_13B, n_layers=2,
                                            mlstm_ratio=1, vocab=256)),
          "agent-7b-d512": ("agent-7b", dict(AGENT_7B_D512, n_layers=1,
                                             d_ff=512, vocab=256))}
SCHED = dict(max_slots=2, num_pages=32, max_context=128, page_size=16)
LENS = [30, 64]


@functools.lru_cache(maxsize=None)
def model(key):
    name, kw = MODELS[key]
    jcfg = jconfigs.get_config(name).replace(dtype="float32", **kw)
    tree = jax.device_get(jmodels.init(jcfg, jax.random.key(0)))
    tcfg = tconfigs.get_config(name).replace(dtype="float32",
                                             use_pallas=True, **kw)
    return jcfg, tcfg, tree


def serve(eng, cls, prompts, max_new=6):
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


@pytest.mark.parametrize("key", list(MODELS))
def test_logits_match_the_reference(key):
    """Ring prefill logits within 1e-4 and four decode steps within
    2e-3 of the reference's, the kernels' plain versions on."""
    jcfg, tcfg, tree = model(key)
    if key.startswith("xlstm"):
        assert tcfg.d_model == 2048 and tcfg.n_heads == 4
    else:
        assert (tcfg.d_model, tcfg.d_head) == (4096, 512)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = tmodels.from_jax(tcfg, tree, device="cpu")
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (2, 32))
    toks = toks.astype(np.int32)
    jcache = jmodels.init_cache(jcfg, 2, 48)
    tcache = tmodels.init_cache(tcfg, 2, 48, device="cpu")
    lj, jcache = jtfm.prefill(jparams, jcfg, jnp.asarray(toks), jcache)
    lt, tcache = tmodels.prefill(tparams, tcfg, torch.from_numpy(toks).long(),
                                 tcache)
    assert rel(lt.numpy(), np.asarray(lj)) <= 1e-4
    tok = np.argmax(np.asarray(lj), -1).astype(np.int32)[:, None]
    for _ in range(4):
        lj, jcache = jmodels.decode_step(jparams, jcfg, jnp.asarray(tok),
                                         jcache)
        lt, tcache = tmodels.decode_step(tparams, tcfg,
                                         torch.from_numpy(tok).long(), tcache)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   atol=DECODE_LOGIT_TOL,
                                   rtol=DECODE_LOGIT_TOL)
        tok = np.argmax(np.asarray(lj), -1).astype(np.int32)[:, None]


@pytest.mark.parametrize("key,layout", [("xlstm-1.3b", "ring"),
                                        ("agent-7b-d512", "paged"),
                                        ("agent-7b-d512", "ring")])
def test_engine_tokens_match_the_reference_engine(key, layout):
    jcfg, tcfg, tree = model(key)
    want = serve(Engine(jcfg, jax.tree.map(jnp.asarray, tree),
                        JSched(**SCHED), cache_layout=layout), JRequest,
                 prompts(jcfg.vocab))
    eng = TorchEngine(tcfg, tmodels.from_jax(tcfg, tree, device="cpu"),
                      SchedulerConfig(**SCHED), cache_layout=layout,
                      device="cpu")
    assert serve(eng, Request, prompts(tcfg.vocab)) == want
