"""The ``ssm_scan`` backward on the CPU: its plain version against the JAX
package, and an emulation of the CUDA kernel's walk against the plain
version.

* ``ssm_scan_backward_plain`` (autograd through the port's plain chunked
  scan) against ``jax.grad`` of the reference's sequential oracle
  (``repro/kernels/ref.py::ssm_scan_ref``) for the gradients of y and
  h_T: dq, dk, dv, dlog_a and dh0 within 1e-4 of each output's largest
  magnitude (f32; a chunked and a sequential sum differ in order, the
  reference's own band for this kernel, ``tests/test_kernels.py:253``).
* ``walk``, the seven launches of ``csrc/ssm_scan_bwd.cu`` in PyTorch:
  the decayed pair matrices P and W of each chunk (masked before the
  exponential), U_c, the reverse state pass over the chunks from dH_T,
  dq and dk over tiles of 64 columns of dk (each summing the whole of
  dv), dv over tiles of 64 columns of dv (each summing the whole of dk),
  r_t = q_t . dq_t - k_t . dk_t from the f32 values and its suffix sums.
  Inputs widened to f32, outputs rounded to the input type, as the
  kernel does; held to the plain backward within 1e-4 (f32) and 2e-2
  (bf16) of each output's largest magnitude.
* Cases: a ragged T (a ragged last chunk), hymba's head-shared q and k
  (stride-0 views; both give full-shape gradients), a non-zero h0 and
  dH_T, mLSTM's dk 512 x dv 513 at a short T, T under one chunk.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import ssm_scan_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import (ssm_scan_backward_plain,  # noqa: E402
                                          ssm_scan_plain)

TILE = 64
BAND = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# b, t, h, dk, dv, chunk, shared q/k, decay, h0 scale, dH_T
CASES = [(1, 64, 2, 16, 16, 16, False, 0.1, 0.0, False),
         (2, 100, 3, 16, 64, 32, True, 0.5, 0.0, False),
         (1, 77, 2, 8, 24, 16, False, 1.0, 0.5, True),
         (1, 40, 1, 512, 513, 16, False, 0.05, 0.2, True),
         (2, 9, 2, 24, 40, 128, False, 0.3, 0.3, True)]
IDS = ["basic", "hymba-shared-ragged", "h0-dhT-ragged", "mlstm-width",
       "under-one-chunk"]


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


def walk(q, k, v, la, h0, dy, dh_t, chunk):
    """The backward kernel's seven launches, in PyTorch."""
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, t)
    nc = -(-t // chunk)
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
    Ls, pair_p, pair_w, us = [], [], [], []
    for c in range(nc):
        L = torch.cumsum(rows(la, c), 1).permute(0, 2, 1)     # (B, H, n)
        n = L.shape[-1]
        Ls.append(L)
        # 1. pair matrices, the mask before the exponential
        tri = torch.ones(n, n, dtype=torch.bool).tril()
        dec = torch.exp((L[..., :, None] - L[..., None, :]).masked_fill(
            ~tri, float("-inf")))
        pair_p.append(torch.einsum("bihd,bjhd->bhij", rows(qf, c),
                                   rows(kf, c)) * dec)
        pair_w.append(torch.einsum("bihe,bjhe->bhij", rows(dyf, c),
                                   rows(vf, c)) * dec)
        # 2. U_c = Q^T diag(exp L) dY
        us.append(torch.einsum("bjhd,bjhe->bhde", rows(qf, c)
                               * torch.exp(L).permute(0, 2, 1)[..., None],
                               rows(dyf, c)))
    # 3. the reverse state pass: D_c over U_c, dh0 at the end
    d = dh_t.float() if dh_t is not None else torch.zeros_like(h_t)
    ds = [None] * nc
    for c in reversed(range(nc)):
        ds[c] = d
        d = torch.exp(Ls[c][..., -1])[..., None, None] * d + us[c]
    dh0 = d
    gq, gk, gv = [], [], []
    for c in range(nc):
        L = Ls[c]
        e_l = torch.exp(L).permute(0, 2, 1)[..., None]
        e_r = torch.exp(L[..., -1:] - L).permute(0, 2, 1)[..., None]
        tq, tk, tv = [], [], []
        # 4. dq and dk, 64 columns of dk at a time (whole of dv in each)
        for d0 in range(0, dk, TILE):
            sl = slice(d0, d0 + TILE)
            tq.append(torch.einsum("bhij,bjhd->bihd", pair_w[c],
                                   rows(kf, c)[..., sl])
                      + e_l * torch.einsum("bihe,bhde->bihd", rows(dyf, c),
                                           states[c][:, :, sl]))
            tk.append(torch.einsum("bhji,bjhd->bihd", pair_w[c],
                                   rows(qf, c)[..., sl])
                      + e_r * torch.einsum("bihe,bhde->bihd", rows(vf, c),
                                           ds[c][:, :, sl]))
        # 5. dv, 64 columns of dv at a time (whole of dk in each)
        for e0 in range(0, dv, TILE):
            sl = slice(e0, e0 + TILE)
            tv.append(torch.einsum("bhji,bjhe->bihe", pair_p[c],
                                   rows(dyf, c)[..., sl])
                      + e_r * torch.einsum("bihd,bhde->bihe", rows(kf, c),
                                           ds[c][..., sl]))
        gq.append(torch.cat(tq, -1))
        gk.append(torch.cat(tk, -1))
        gv.append(torch.cat(tv, -1))
    gq, gk, gv = (torch.cat(x, 1) for x in (gq, gk, gv))
    # 6. r from the f32 dq and dk; 7. its suffix sums (+ <dH_T, H_T>)
    r = (qf * gq).sum(-1) - (kf * gk).sum(-1)
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
