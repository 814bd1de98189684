"""The ``ssm_scan`` backward on the CPU: its plain version against the JAX
package, and an emulation of the CUDA kernel's launches against the plain
version.

* ``ssm_scan_backward_plain`` (autograd through the port's plain chunked
  scan) against ``jax.grad`` of the reference's sequential oracle
  (``repro/kernels/ref.py::ssm_scan_ref``) for the gradients of y and
  h_T: dq, dk, dv, dlog_a and dh0 within 1e-4 of each output's largest
  magnitude (f32; a chunked and a sequential sum differ in order, the
  reference's own band for this kernel, ``tests/test_kernels.py:253``).
* ``walk``, the launches of ``csrc/ssm_scan_bwd.cu`` in PyTorch, on the
  route ``backward_plan`` picks: the U pass (U_c = Q^T diag(exp L) dY),
  the reverse state pass over the chunks from dH_T, then where dk and dv
  are at most 64 the fused chunk pass (each 16-row block of a chunk as
  the query rows, W of the keys up to its rows and dq, and as the key
  rows, W^T and P^T of the queries from its rows on, dk and dv), else the
  tiled pass (P and W written once per chunk, dq and dk over tiles of 64
  columns of dk each summing the whole of dv, dv over tiles of 64
  columns of dv); r_t = q_t . dq_t - k_t . dk_t from the f32 sums (in
  the tiled pass two parts per dk tile, q . dq and -k . dk, added in
  order) and its suffix sums, the dla pass.  In bf16 every product's
  operands are rounded to bf16 where the kernel rounds them (q exp(L) in
  U, S_c, D_c, the pair matrices), sums stay f32 and the outputs are
  rounded to the input type; held to the plain backward within 1e-4 (f32) and 2e-2
  (bf16) of each output's largest magnitude.
* Cases: a ragged T (a ragged last chunk), hymba's head-shared q and k
  (stride-0 views; both give full-shape gradients), a non-zero h0 and
  dH_T, mLSTM's dk 512 x dv 513 at a short T (the tiled pass), T under
  one chunk, and hymba's own tile (dk 16, dv 64, chunk 128) over three
  chunks with a ragged last one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import ssm_scan_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import (backward_plan,  # noqa: E402
                                          ssm_scan_backward_plain,
                                          ssm_scan_plain)

TILE = 64
BAND = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# b, t, h, dk, dv, chunk, shared q/k, decay, h0 scale, dH_T
CASES = [(1, 64, 2, 16, 16, 16, False, 0.1, 0.0, False),
         (2, 100, 3, 16, 64, 32, True, 0.5, 0.0, False),
         (1, 77, 2, 8, 24, 16, False, 1.0, 0.5, True),
         (1, 40, 1, 512, 513, 16, False, 0.05, 0.2, True),
         (2, 9, 2, 24, 40, 128, False, 0.3, 0.3, True),
         (1, 300, 3, 16, 64, 128, True, 0.5, 0.3, True)]
IDS = ["basic", "hymba-shared-ragged", "h0-dhT-ragged", "mlstm-width",
       "under-one-chunk", "hymba-tile-three-chunks"]


def scan_inputs(b, t, h, dk, dv, shared, decay, h0_scale, dh_t, dtype,
                seed=0):
    rng = np.random.default_rng(seed)
    nq = 1 if shared else h
    q = torch.from_numpy(rng.standard_normal((b, t, nq, dk)) * 0.3)
    k = torch.from_numpy(rng.standard_normal((b, t, nq, dk)) * 0.3)
    v = torch.from_numpy(rng.standard_normal((b, t, h, dv)) * 0.3)
    la = torch.from_numpy(-rng.uniform(0, decay, (b, t, h))).float()
    h0 = torch.from_numpy(rng.standard_normal((b, h, dk, dv))
                          * h0_scale).float()
    dy = torch.from_numpy(rng.standard_normal((b, t, h, dv))).to(dtype)
    dht = (torch.from_numpy(rng.standard_normal((b, h, dk, dv))).float()
           if dh_t else None)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    if shared:
        q, k = q.expand(b, t, h, dk), k.expand(b, t, h, dk)
    return q, k, v, la, h0, dy, dht


def rnd(x, dtype):
    """``x`` as an operand of the kernel's products: rounded to bf16 where
    the kernel runs bf16 on the tensor cores, unchanged in f32."""
    return x.to(dtype).float()


def decayed(x, y, L):
    """(x_i . y_j) exp(L_i - L_j) for j <= i, masked before the
    exponential: (B, H, n, n) from rows (B, n, H, w) and L (B, H, n)."""
    n = L.shape[-1]
    tri = torch.ones(n, n, dtype=torch.bool).tril()
    dec = torch.exp((L[..., :, None] - L[..., None, :]).masked_fill(
        ~tri, float("-inf")))
    return torch.einsum("bihd,bjhd->bhij", x, y) * dec


def row_scale(f):
    """(B, H, n) factors as (B, n, H, 1), to scale rows."""
    return f.permute(0, 2, 1)[..., None]


def fused_chunk(Q, K, V, Y, L, S, D, dt):
    """scan_bwd_chunk_kernel on one chunk: each 16-row block of the chunk
    as the query rows (W of the keys up to its last row, the state term
    first) and as the key rows (W^T and P^T of the queries from its first
    row on); each pair tile rounded to the operand type as it enters the
    next product.  Returns (dq, dk, dv, r's one part)."""
    n = L.shape[-1]
    e_l, e_r = row_scale(torch.exp(L)), row_scale(torch.exp(L[..., -1:] - L))
    W, P = decayed(Y, V, L), decayed(Q, K, L)
    dq, dk, dv = torch.zeros_like(Q), torch.zeros_like(K), torch.zeros_like(V)
    for w0 in range(0, n, 16):
        blk, upto, on = slice(w0, w0 + 16), slice(0, w0 + 16), slice(w0, n)
        dq[:, blk] = (e_l[:, blk] * torch.einsum("bihe,bhde->bihd",
                                                 Y[:, blk], S)
                      + torch.einsum("bhij,bjhd->bihd",
                                     rnd(W[:, :, blk, upto], dt), K[:, upto]))
        dk[:, blk] = (e_r[:, blk] * torch.einsum("bjhe,bhde->bjhd",
                                                 V[:, blk], D)
                      + torch.einsum("bhij,bihd->bjhd",
                                     rnd(W[:, :, on, blk], dt), Q[:, on]))
        dv[:, blk] = (e_r[:, blk] * torch.einsum("bjhd,bhde->bjhe",
                                                 K[:, blk], D)
                      + torch.einsum("bhij,bihe->bjhe",
                                     rnd(P[:, :, on, blk], dt), Y[:, on]))
    r = (Q * dq).sum(-1) - (K * dk).sum(-1)
    return dq, dk, dv, r[..., None]


def tiled_chunk(Q, K, V, Y, L, S, D, dt):
    """The tiled pass on one chunk: P and W written once in the operand
    type (scan_bwd_pair_kernel); dq and dk over 64 columns of dk at a
    time, each summing the whole of dv, with the tile's parts of r, q . dq
    and -k . dk (scan_bwd_dqdk_kernel); dv over 64 columns of dv, each
    summing the whole of dk (scan_bwd_dv_kernel).  Returns (dq, dk, dv,
    r's parts)."""
    dk_, dv_ = Q.shape[-1], V.shape[-1]
    e_l, e_r = row_scale(torch.exp(L)), row_scale(torch.exp(L[..., -1:] - L))
    W, P = rnd(decayed(Y, V, L), dt), rnd(decayed(Q, K, L), dt)
    tq, tk, tv, parts = [], [], [], []
    for d0 in range(0, dk_, TILE):
        sl = slice(d0, d0 + TILE)
        tq.append(e_l * torch.einsum("bihe,bhde->bihd", Y, S[:, :, sl])
                  + torch.einsum("bhij,bjhd->bihd", W, K[..., sl]))
        tk.append(e_r * torch.einsum("bjhe,bhde->bjhd", V, D[:, :, sl])
                  + torch.einsum("bhij,bihd->bjhd", W, Q[..., sl]))
        parts += [(Q[..., sl] * tq[-1]).sum(-1),
                  -(K[..., sl] * tk[-1]).sum(-1)]
    for e0 in range(0, dv_, TILE):
        sl = slice(e0, e0 + TILE)
        tv.append(e_r * torch.einsum("bjhd,bhde->bjhe", K, D[..., sl])
                  + torch.einsum("bhij,bihe->bjhe", P, Y[..., sl]))
    return (torch.cat(tq, -1), torch.cat(tk, -1), torch.cat(tv, -1),
            torch.stack(parts, -1))


def walk(q, k, v, la, h0, dy, dh_t, chunk):
    """The backward kernel's launches, in PyTorch, on the route
    ``backward_plan`` picks for these (contiguous or head-broadcast,
    16-byte aligned) inputs."""
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, t)
    dt = q.dtype
    plan = backward_plan(b, t, h, dk, dv, chunk, 16 // q.element_size(),
                         True)
    nc = plan.nc
    qf, kf, vf, dyf = (x.float() for x in (q, k, v, dy))
    la = la.float()
    rows = lambda x, c: x[:, c * chunk:(c + 1) * chunk]  # noqa: E731
    # the forward's chunk-entry states (what the autograd Function keeps)
    states, st = [], h0.float()
    for c in range(nc):
        states.append(st)
        L = torch.cumsum(rows(la, c), 1)
        rem = torch.exp(L[:, -1:] - L)
        st = torch.exp(L[:, -1])[..., None, None] * st + torch.einsum(
            "bjhd,bjhe->bhde", rows(kf, c) * rem[..., None], rows(vf, c))
    h_t = st
    Ls = [torch.cumsum(rows(la, c), 1).permute(0, 2, 1) for c in range(nc)]
    # 1. the U pass: U_c = Q^T diag(exp L) dY, q exp(L) the rounded operand
    us = [torch.einsum("bjhd,bjhe->bhde",
                       rnd(rows(qf, c) * row_scale(torch.exp(Ls[c])), dt),
                       rows(dyf, c)) for c in range(nc)]
    # 2. the reverse state pass: D_c over U_c, dh0 at the end
    d = dh_t.float() if dh_t is not None else torch.zeros_like(h_t)
    ds = [None] * nc
    for c in reversed(range(nc)):
        ds[c] = d
        d = torch.exp(Ls[c][..., -1])[..., None, None] * d + us[c]
    dh0 = d
    # 3. the chunk pass, the states rounded to the operand type
    step = fused_chunk if plan.fused else tiled_chunk
    outs = [step(rows(qf, c), rows(kf, c), rows(vf, c), rows(dyf, c), Ls[c],
                 rnd(states[c], dt), rnd(ds[c], dt), dt) for c in range(nc)]
    gq, gk, gv, parts = (torch.cat(x, 1) for x in zip(*outs))
    assert parts.shape[-1] == plan.n_parts
    # 4. r's parts in tile order, then its suffix sums (+ <dH_T, H_T>)
    r = parts[..., 0]
    for i in range(1, plan.n_parts):
        r = r + parts[..., i]
    dla = torch.flip(torch.cumsum(torch.flip(r, [1]), 1), [1])
    if dh_t is not None:
        dla = dla + (dh_t.float() * h_t).sum((-1, -2))[:, None, :]
    return (gq.to(q.dtype), gk.to(k.dtype), gv.to(v.dtype), dla, dh0)


def rel(got, want) -> float:
    got, want = got.double(), want.double()
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_jax_grad(case):
    b, t, h, dk, dv, chunk, shared, decay, h0s, dht = case
    q, k, v, la, h0, dy, dh_t = scan_inputs(b, t, h, dk, dv, shared, decay,
                                            h0s, dht, torch.float32)
    got = ssm_scan_backward_plain(q, k, v, la, h0, dy, dh_t, chunk=chunk)
    tr = lambda x: jnp.asarray(x.numpy()).transpose(0, 2, 1, 3)  # noqa: E731
    jdy, jdh = tr(dy), (jnp.asarray(dh_t.numpy()) if dht else None)

    def loss(qq, kk, vv, ll, hh):
        y, h_fin = ssm_scan_ref(qq, kk, vv, ll, hh)
        out = jnp.sum(y * jdy)
        return out + jnp.sum(h_fin * jdh) if dht else out

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        tr(q), tr(k), tr(v),
        jnp.asarray(la.numpy()).transpose(0, 2, 1)[..., None],
        jnp.asarray(h0.numpy()))
    back = [np.array(w).transpose(0, 2, 1, 3) for w in want[:3]]
    back += [np.array(want[3])[..., 0].transpose(0, 2, 1),
             np.array(want[4])]
    for g, w in zip(got, back):
        assert g.shape == w.shape
        assert rel(g, torch.from_numpy(w)) <= BAND[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernel_walk_matches_plain_backward(case, dtype):
    b, t, h, dk, dv, chunk, shared, decay, h0s, dht = case
    q, k, v, la, h0, dy, dh_t = scan_inputs(b, t, h, dk, dv, shared, decay,
                                            h0s, dht, dtype)
    got = walk(q, k, v, la, h0, dy, dh_t, chunk)
    want = ssm_scan_backward_plain(q, k, v, la, h0, dy, dh_t, chunk=chunk)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert rel(g, w) <= BAND[dtype]


def test_plain_backward_is_autograd_of_the_plain_scan():
    """The plain backward is what autograd gives through the wrapper's
    CPU path, gradients of both outputs included."""
    q, k, v, la, h0, dy, dh_t = scan_inputs(2, 50, 3, 8, 12, False, 0.4,
                                            0.3, True, torch.float32)
    xs = [x.clone().requires_grad_(True) for x in (q, k, v, la, h0)]
    y, h_t = ssm_scan_plain(*xs, chunk=16)
    want = torch.autograd.grad((y * dy).sum() + (h_t * dh_t).sum(), xs)
    got = ssm_scan_backward_plain(q, k, v, la, h0, dy, dh_t, chunk=16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dims,vec,aligned,fused,n_parts", [
    ((16, 64), 8, True, True, 1),          # hymba, bf16
    ((16, 64), 4, True, True, 1),          # hymba, f32
    ((8, 24), 8, True, True, 1),           # dk 8 held in the 16 template
    ((512, 513), 8, True, False, 16),      # the mLSTM
    ((64, 72), 8, True, False, 2),         # dv above what the pass holds
    ((16, 64), 8, False, False, 2),        # rows that do not load 16 bytes
    ((24, 20), 8, True, False, 2)])        # dv not a multiple of 16 bytes
def test_backward_plan_routes(dims, vec, aligned, fused, n_parts):
    """The fused pass where dk and dv are at most 64 and rows load 16
    bytes at a time, with no pair scratch; the tiled pass elsewhere, with
    two parts of r per 64 columns of dk and the chunk x chunk scratch."""
    dk, dv = dims
    plan = backward_plan(2, 300, 3, dk, dv, 128, vec, aligned)
    assert (plan.nc, plan.fused, plan.n_parts) == (3, fused, n_parts)
    assert plan.pw_shape == (None if fused else (2, 3, 3, 2, 128, 128))
    pitch = dv if fused else -(-dv // 8) * 8
    assert plan.states_shape == (2, 3, 3, dk, pitch)
