"""The arithmetic and plans of the redesigned ``ssm_scan`` and
``grouped_matmul`` kernels, emulated on the CPU.

The CUDA kernels cannot run here, so this file holds emulations of their
designs in PyTorch and checks them against the plain versions and the
JAX package:

* ``ssm_scan`` runs mamba-2's three chunk phases (``csrc/ssm_scan.cu``):
  chunk states S_c = sum_j exp(L_last - L_j) k_j v_j^T with a_c =
  exp(L_last); the state pass H_c = a_c H_{c-1} + S_c, which overwrites
  S_c with the state entering chunk c; chunk outputs y_i = sum_{j <= i}
  (q_i . k_j) exp(L_i - L_j) v_j + exp(L_i) q_i . H, the mask before the
  exponential.  The scratch starts as NaN, so a slot no phase writes
  shows.  In f32 the emulation is held to ``ssm_scan_plain`` within 2e-5
  (the same sums in another order) and to
  ``repro.models.ssm.chunked_linear_attention``, ``ops.ssm_scan`` in
  interpret mode and ``ref.ssm_scan_ref`` within 1e-4, the reference's
  band for this kernel (tests/test_kernels.py:253).  With bf16 inputs
  and the weighted scores rounded to bf16, as the tensor-core phase 3
  feeds them to P V, it is held to the bf16 plain version within 2e-2,
  and to its f32 sums within 1e-2.
* ``grouped_matmul``'s persistent kernel walks units (live expert,
  column tile, row block) in stride order over its CTAs and writes the
  zeros of every row past its count first.  The emulation, with NaN in
  every dead row and dead expert's weights, is held to
  ``grouped_matmul_plain`` within 1e-5 (f32).
* Both planners take ints only: ``scan_plan`` and ``tma_plan``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _jax_caps import HAVE_PALLAS_API, PALLAS_SKIP_REASON  # noqa: E402
from repro.kernels import ops, ref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels.grouped_matmul import (  # noqa: E402
    grouped_matmul_plain, tma_plan)
from repro_torch.kernels.ssm_scan import (  # noqa: E402
    MAX_CHUNK, MAX_DK, MAX_DV, scan_plan, ssm_scan_plain)

needs_pallas = pytest.mark.skipif(not HAVE_PALLAS_API,
                                  reason=PALLAS_SKIP_REASON)

# ---------------------------------------------------------------------------
# ssm_scan: the three phases
# ---------------------------------------------------------------------------


def scan_inputs(b, t, h, dk, dv, seed=0, h0_scale=0.0, decay=0.1,
                shared=False, softplus=False, q_scale=0.3):
    """q, k (shared: one row for every head, as hymba's), v, log_a, h0 as
    float32 numpy arrays; ``softplus`` draws log_a = -softplus(N(0, 1)),
    hymba's decay at a_log = 0, which reaches L ~ -90 within 128 rows."""
    rng = np.random.default_rng(seed)
    nq = 1 if shared else h
    q = rng.standard_normal((b, t, nq, dk)) * q_scale
    k = rng.standard_normal((b, t, nq, dk)) * q_scale
    if shared:
        q, k = (np.broadcast_to(a, (b, t, h, dk)) for a in (q, k))
    v = rng.standard_normal((b, t, h, dv)) * 0.3
    if softplus:
        log_a = -np.log1p(np.exp(rng.standard_normal((b, t, h))))
    else:
        log_a = -rng.uniform(0, decay, (b, t, h))
    h0 = rng.standard_normal((b, h, dk, dv)) * h0_scale
    return [np.ascontiguousarray(a, dtype=np.float32)
            for a in (q, k, v, log_a, h0)]


def chunk_cumsum(la_chunk: torch.Tensor, chunk: int) -> torch.Tensor:
    """L over a chunk's ``chunk`` rows (B, n, H) -> (B, chunk, H): rows
    past n add log_a = 0, as the kernel's scan reads them."""
    b, n, h = la_chunk.shape
    full = torch.zeros((b, chunk, h), dtype=torch.float32)
    full[:, :n] = la_chunk
    return torch.cumsum(full, dim=1)


def emulate_scan(q, k, v, log_a, h0, chunk, p_bf16=False, out_dtype=None):
    """The kernel's phases in PyTorch; ``p_bf16`` rounds the weighted
    scores to bf16, as the tensor-core phase 3 feeds them to P V.
    Returns (y in ``out_dtype``, by default v's, h_T, the scratch of
    entering states, decay)."""
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    nc = -(-t // chunk)
    qf, kf, vf, la = q.float(), k.float(), v.float(), log_a.float()
    states = torch.full((b, h, nc, dk, dv), float("nan"))
    decay = torch.full((b, h, nc), float("nan"))
    ls = []
    # phase 1: chunk states and decays, every chunk independent
    for c in range(nc):
        c0, n = c * chunk, min(chunk, t - c * chunk)
        L = chunk_cumsum(la[:, c0:c0 + n], chunk)
        l_last = L[:, n - 1]                                   # (B, H)
        rem = torch.exp(l_last[:, None] - L[:, :n])            # (B, n, H)
        states[:, :, c] = torch.einsum(
            "bjhd,bjhe->bhde", kf[:, c0:c0 + n] * rem[..., None],
            vf[:, c0:c0 + n])
        decay[:, :, c] = torch.exp(l_last)
        ls.append(L)
    # phase 2: the only sequential part, nc elementwise steps
    H = h0.float().clone()
    for c in range(nc):
        s = states[:, :, c].clone()
        states[:, :, c] = H
        H = decay[:, :, c, None, None] * H + s
    # phase 3: chunk outputs, every chunk independent
    y = torch.full((b, t, h, dv), float("nan"))
    for c in range(nc):
        c0, n = c * chunk, min(chunk, t - c * chunk)
        L = ls[c][:, :n].permute(0, 2, 1)                     # (B, H, n)
        qc, kc, vc = qf[:, c0:c0 + n], kf[:, c0:c0 + n], vf[:, c0:c0 + n]
        scores = torch.einsum("bihd,bjhd->bhij", qc, kc)
        causal = torch.tril(torch.ones((n, n), dtype=torch.bool))
        ldiff = (L[..., :, None] - L[..., None, :]).masked_fill(
            ~causal, float("-inf"))                           # mask, then exp
        p = scores * torch.exp(ldiff)
        if p_bf16:
            p = p.bfloat16().float()
        intra = torch.einsum("bhij,bjhe->bihe", p, vc)
        inter = torch.einsum("bihd,bhde->bihe", qc, states[:, :, c]) \
            * torch.exp(L).permute(0, 2, 1)[..., None]
        y[:, c0:c0 + n] = intra + inter
    return y.to(out_dtype or v.dtype), H, states, decay


def as_torch(arrs, dtype=torch.float32):
    t = [torch.from_numpy(a) for a in arrs]
    return [x.to(dtype) for x in t[:3]] + t[3:]


# b, t, h, dk, dv, chunk, h0 scale, shared q/k, softplus decay
SCAN_CASES = [
    (1, 256, 3, 16, 64, 128, 0.0, True, True),     # hymba's widths, L ~ -90
    (1, 130, 3, 16, 64, 128, 0.0, True, True),     # hymba, a 2-row tail
    (2, 100, 2, 16, 64, 32, 0.5, True, False),     # ragged, h0 != 0
    (1, 96, 2, 32, 33, 32, 0.3, False, False),     # mLSTM-like: dv = dk + 1
    (1, 70, 2, 64, 65, 64, 0.0, False, False),     # mLSTM-like, ragged
    (1, 40, 1, 128, 129, 16, 0.2, False, False),   # past one 64-wide tile
    (2, 7, 3, 5, 33, 128, 0.2, True, False),       # one short chunk
]


@pytest.mark.parametrize("b,t,h,dk,dv,chunk,h0s,shared,softplus",
                         SCAN_CASES)
def test_scan_phases_match_plain(b, t, h, dk, dv, chunk, h0s, shared,
                                 softplus):
    arrs = scan_inputs(b, t, h, dk, dv, h0_scale=h0s, shared=shared,
                       softplus=softplus,
                       q_scale=0.3 if dk <= 64 else dk ** -0.5)
    args = as_torch(arrs)
    y, h_t, states, decay = emulate_scan(*args, chunk)
    assert not torch.isnan(states).any() and not torch.isnan(decay).any()
    assert torch.isfinite(y).all() and torch.isfinite(h_t).all()
    want_y, want_h = ssm_scan_plain(*args, chunk=chunk)
    torch.testing.assert_close(y, want_y, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(h_t, want_h, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("b,t,h,dk,dv,chunk,h0s", [
    (1, 256, 2, 16, 64, 128, 0.0),                 # hymba's widths
    (1, 128, 2, 32, 33, 32, 0.4),                  # mLSTM-like, h0 != 0
    (2, 64, 2, 64, 65, 64, 0.0)])
def test_scan_phases_match_chunked_linear_attention(b, t, h, dk, dv, chunk,
                                                    h0s):
    """``repro.models.ssm.chunked_linear_attention``, the reference
    model's scan (T a multiple of the chunk, which it asserts)."""
    arrs = scan_inputs(b, t, h, dk, dv, seed=5, h0_scale=h0s)
    y, h_t, _, _ = emulate_scan(*as_torch(arrs), chunk)
    jy, jh = jssm.chunked_linear_attention(*(jnp.asarray(a) for a in arrs),
                                           chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(jh), atol=1e-4,
                               rtol=1e-4)


@needs_pallas
@pytest.mark.parametrize("b,t,h,dk,dv,chunk,h0s", [
    (1, 130, 2, 16, 64, 128, 0.0),                 # hymba, a ragged tail
    (1, 100, 2, 32, 33, 32, 0.3),                  # mLSTM-like, ragged
    (1, 64, 1, 64, 65, 16, 0.5)])
def test_scan_phases_match_pallas_kernel(b, t, h, dk, dv, chunk, h0s):
    """``ops.ssm_scan`` in interpret mode (it pads a ragged tail) and the
    sequential oracle ``ref.ssm_scan_ref``."""
    arrs = scan_inputs(b, t, h, dk, dv, seed=6, h0_scale=h0s)
    y, h_t, _, _ = emulate_scan(*as_torch(arrs), chunk)
    jq, jk, jv, jla, jh0 = (jnp.asarray(a) for a in arrs)
    jy, jh = ops.ssm_scan(jq, jk, jv, jla, jh0, chunk=chunk, interpret=True)
    oy, oh = ref.ssm_scan_ref(jnp.moveaxis(jq, 2, 1), jnp.moveaxis(jk, 2, 1),
                              jnp.moveaxis(jv, 2, 1),
                              jnp.moveaxis(jla, 2, 1)[..., None], jh0)
    for want_y, want_h in ((jy, jh), (jnp.moveaxis(oy, 1, 2), oh)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(h_t.numpy(), np.asarray(want_h),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("b,t,h,dk,dv,chunk,h0s,shared,softplus", [
    (1, 1024, 4, 16, 64, 128, 0.0, True, True),    # hymba's prefill widths
    (1, 1024, 4, 16, 64, 128, 0.0, True, False),   # slow decay: long sums
    (1, 300, 2, 64, 64, 64, 0.5, False, False),
    (1, 200, 2, 32, 32, 128, 0.3, False, False)])
def test_scan_bf16_scores_stay_in_band(b, t, h, dk, dv, chunk, h0s, shared,
                                       softplus):
    """The tensor-core phase 3 feeds the weighted scores to P V in bf16.
    On the same bf16 inputs, y (in f32, before its own rounding) stays
    within 1e-2 of the plain version's f32 sums (7.4e-3 at most here, at
    |y| ~ 4), and the bf16 y within the band 2e-2 of the plain version's,
    which rounds only y."""
    arrs = scan_inputs(b, t, h, dk, dv, seed=7, h0_scale=h0s, shared=shared,
                       softplus=softplus)
    args = as_torch(arrs, torch.bfloat16)
    exact = [x.float() for x in args]            # the bf16 values, in f32
    want32, _ = ssm_scan_plain(*exact, chunk=chunk)
    y32, _, _, _ = emulate_scan(*args, chunk, p_bf16=True,
                                out_dtype=torch.float32)
    err32 = (y32 - want32).abs().max().item()
    y, h_t, _, _ = emulate_scan(*args, chunk, p_bf16=True)
    want_y, want_h = ssm_scan_plain(*args, chunk=chunk)
    err = (y.float() - want_y.float()).abs().max().item()
    print(f"max |y - plain|: in f32 {err32:.3e}, in bf16 {err:.3e}; |y| <= "
          f"{want_y.float().abs().max().item():.2f}")
    assert err32 < 1e-2
    assert err <= 2e-2
    torch.testing.assert_close(h_t, want_h, atol=1e-4, rtol=1e-4)


def test_scan_plan_hymba_and_mlstm():
    """Chunks and scratch from ints: hymba's prefill takes the
    tensor-core phase 3 with 1.6 MB of f32 chunk states; mLSTM's widths
    the CUDA-core one."""
    p = scan_plan(1, 1024, 50, 16, 64, 128, bf16=True, aligned=True)
    assert p.fast and p.nc == 8
    assert p.states_shape == (1, 50, 8, 16, 64) and p.decay_shape == (1, 50,
                                                                      8)
    assert math.prod(p.states_shape) * 4 == 1638400
    p = scan_plan(1, 900, 50, 16, 64, 128, bf16=True, aligned=True)
    assert p.nc == 8 and p.fast                 # a ragged last chunk
    p = scan_plan(1, 1024, 4, 512, 513, 128, bf16=True, aligned=True)
    assert not p.fast and p.states_shape == (1, 4, 8, 512, 513)
    assert scan_plan(2, 7, 3, 5, 33, 128, True, True).nc == 1


@pytest.mark.parametrize("bf16,aligned,dk,dv,fast", [
    (True, True, 16, 64, True), (True, True, 64, 64, True),
    (True, True, 32, 1024, True), (False, True, 16, 64, False),
    (True, False, 16, 64, False), (True, True, 72, 64, False),
    (True, True, 12, 64, False), (True, True, 16, 60, False)])
def test_scan_plan_fast_path(bf16, aligned, dk, dv, fast):
    """The tensor-core phase 3 takes bf16, dk <= 64, dk and dv multiples
    of 8 and 16-byte aligned rows; everything else the CUDA-core one."""
    assert scan_plan(1, 64, 2, dk, dv, 64, bf16, aligned).fast == fast


@pytest.mark.parametrize("dk,dv,chunk,match", [
    (MAX_DK + 1, 16, 64, "dk"), (16, MAX_DV + 1, 64, "dv"),
    (16, 16, MAX_CHUNK + 1, "chunk"), (16, 16, 0, "chunk"),
    (0, 16, 64, "dk")])
def test_scan_plan_refuses_and_names_it(dk, dv, chunk, match):
    with pytest.raises(ValueError, match=match):
        scan_plan(1, 64, 2, dk, dv, chunk, True, True)


# ---------------------------------------------------------------------------
# grouped_matmul: the persistent walk and its plan
# ---------------------------------------------------------------------------


def unit_of(u, plan):
    """csrc ``unit_of``: (live expert, tile, row block), row block
    fastest."""
    rb = u % plan.row_blocks
    u //= plan.row_blocks
    return u // plan.tiles, u % plan.tiles, rb


def emulate_tma_walk(x, w, counts, plan):
    """The persistent kernel in PyTorch: the live list, the zero pass,
    each CTA's units in stride order.  Returns (out, units seen per
    CTA)."""
    e, c, d = x.shape
    f = w.shape[2]
    cnt = counts.clamp(0, c).tolist()
    live = [i for i in range(e) if cnt[i] > 0]
    out = torch.full((e, c, f), float("nan"))
    for i in range(e):                       # the zero pass
        out[i, cnt[i]:] = 0.0
    units = len(live) * plan.tiles * plan.row_blocks
    seen = []
    for cta in range(plan.grid):
        mine = list(range(cta, units, plan.grid))
        seen.append(mine)
        for u in mine:
            le, tile, rb = unit_of(u, plan)
            ex = live[le]
            r0 = rb * plan.rows
            if r0 >= cnt[ex]:
                continue                     # rows zeroed, w never read
            c0, c1 = tile * plan.cols, min((tile + 1) * plan.cols, f)
            rows = min(plan.rows, cnt[ex] - r0)
            out[ex, r0:r0 + rows, c0:c1] = x[ex, r0:r0 + rows].float() \
                @ w[ex, :, c0:c1].float()
    return out.to(x.dtype), seen


@pytest.mark.parametrize("e,c,d,f,counts,grid", [
    (6, 8, 64 * 40, 136, [8, 0, 3, 0, 0, 0], 10),       # few units
    (6, 8, 64 * 40, 136, [8, 0, 3, 1, 0, 5], 3),        # ragged walk
    (5, 24, 200, 256, [24, 0, 13, 24, 2], 7),           # prefill-like
    (3, 40, 128, 64, [40, 33, 0], 4),                   # 40 rows
    (3, 100, 128, 64, [100, 70, 0], 4),                 # row blocks
    (4, 8, 64 * 24, 64, [0, 0, 0, 0], 3),               # all dead
    (4, 8, 64 * 24, 128, [0, 0, 8, 0], 3)])             # one live
def test_tma_walk_matches_plain(e, c, d, f, counts, grid):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((e, c, d)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((e, d, f))
                          / np.sqrt(d)).astype(np.float32))
    cnt = torch.tensor(counts, dtype=torch.int32)
    x[torch.arange(c)[None, :] >= cnt[:, None]] = float("nan")
    w[cnt == 0] = float("nan")               # never read
    plan = tma_plan(c, f, grid)
    assert plan.grid == grid
    out, seen = emulate_tma_walk(x, w, cnt, plan)
    assert torch.isfinite(out).all()
    want = grouped_matmul_plain(torch.nan_to_num(x), w.nan_to_num(), cnt)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
    # every unit exactly once; CTAs differ by at most one unit
    flat = sorted(u for mine in seen for u in mine)
    assert flat == list(range(len(flat)))
    sizes = [len(m) for m in seen]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("c,f,rows,cols", [
    (8, 4864, 8, 128),     # arctic decode, w_in
    (8, 7168, 8, 128),     # arctic and kimi decode, w_out
    (24, 4864, 24, 256),   # arctic prefill
    (8, 2048, 8, 128),     # kimi decode, w_in
    (32, 2048, 32, 256),   # kimi prefill
    (48, 4864, 48, 256),   # a 2048-token paged chunk
    (64, 256, 64, 256),    # wgmma's N up to 64
    (100, 256, 64, 256),   # C past 64: blocks of 64
    (5, 136, 8, 128)])
def test_tma_plan_shapes(c, f, rows, cols):
    """Units of 128 columns at decode shapes (C <= 16) and 256 past them,
    with L2 hints past them too, each measured the faster there (PERF.md
    §6); one CTA per SM."""
    p = tma_plan(c, f, 132)
    assert (p.rows, p.cols) == (rows, cols)
    assert p.m_tiles == (1 if c <= 16 else 2)
    assert p.l2_hints == (c > 16)             # L2 hints at prefill shapes
    assert p.row_blocks == -(-c // rows) and p.tiles == -(-f // cols)
    assert p.grid == 132


def test_kernel_path_needs_what_tma_needs():
    """The TMA kernel takes bf16 with d and f multiples of 8 (16-byte row
    strides), 16-byte aligned bases and at most 1024 experts (its shared
    live list); everything else the CUDA-core kernel."""
    import importlib
    gm = importlib.import_module("repro_torch.kernels.grouped_matmul")

    def path(e, d, f, offset=0, dtype=torch.bfloat16):
        x = torch.zeros((e, 8, d), dtype=dtype)
        w = torch.zeros((e * d * f + offset,), dtype=dtype)[offset:]
        return gm.kernel_path(x, w.view(e, d, f))

    assert path(gm.MAX_TMA_EXPERTS, 8, 8) == gm.PATH_TENSOR_CORES
    assert path(gm.MAX_TMA_EXPERTS + 1, 8, 8) == gm.PATH_FOUR_COLUMNS
    assert path(4, 16, 16, offset=4) == gm.PATH_ONE_COLUMN
    assert path(4, 12, 16) == gm.PATH_FOUR_COLUMNS
    assert path(4, 16, 16, dtype=torch.float32) == gm.PATH_FOUR_COLUMNS
