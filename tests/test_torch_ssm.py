"""Port mamba / SSD modules vs the JAX reference.

``ssm_scan``'s wrapper on CPU tensors runs its plain version; it is held
against the reference's Pallas kernel in interpret mode
(``ops.ssm_scan(..., interpret=True)``) and the sequential oracle
``ref.ssm_scan_ref`` over the sweep of tests/test_kernels.py plus a
ragged T.  Tolerance 1e-4 in f32, the reference's own band for this
kernel (tests/test_kernels.py:253: chunked and sequential sums differ in
order), 2e-2 in bf16.  The functions of ``models/ssm.py`` are held
against ``repro.models.ssm`` on the same numpy inputs at hymba-smoke
width.  The kernel itself runs only on the card
(tests/test_torch_cuda.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _jax_caps import HAVE_PALLAS_API, PALLAS_SKIP_REASON  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.kernels import ops, ref  # noqa: E402
from repro.models import params as jprm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import get_smoke as tsmoke  # noqa: E402
from repro_torch.configs.base import BlockSpec  # noqa: E402
from repro_torch.kernels import ssm_scan  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan_plain  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import params as tprm  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
needs_pallas = pytest.mark.skipif(not HAVE_PALLAS_API,
                                  reason=PALLAS_SKIP_REASON)


def scan_inputs(b, t, h, dk, dv, seed=0, h0_scale=0.0, decay=0.1):
    """The sweep's inputs (tests/test_kernels.py:243-247), from numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, dk)) * 0.3
    k = rng.standard_normal((b, t, h, dk)) * 0.3
    v = rng.standard_normal((b, t, h, dv)) * 0.3
    log_a = -rng.uniform(0, decay, (b, t, h))
    h0 = rng.standard_normal((b, h, dk, dv)) * h0_scale
    return [a.astype(np.float32) for a in (q, k, v, log_a, h0)]


def both(arrs, dtype="float32"):
    """jnp and torch copies; q, k, v in ``dtype``, log_a and h0 f32."""
    j = [jnp.asarray(a) for a in arrs]
    t = [torch.from_numpy(a) for a in arrs]
    for i in range(3):
        j[i] = j[i].astype(dtype)
        t[i] = t[i].to(getattr(torch, dtype))
    return j, t


def close(want, got, dtype="float32", tol=None):
    tol = TOL[dtype] if tol is None else tol
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want).astype(
                                   jnp.float32)), atol=tol, rtol=tol)


def oracle(jq, jk, jv, jla, jh0):
    """ref.ssm_scan_ref in model layout."""
    y, h = ref.ssm_scan_ref(jnp.moveaxis(jq, 2, 1), jnp.moveaxis(jk, 2, 1),
                            jnp.moveaxis(jv, 2, 1),
                            jnp.moveaxis(jla, 2, 1)[..., None], jh0)
    return jnp.moveaxis(y, 1, 2), h


# ---------------------------------------------------------------------------
# ssm_scan: plain version vs the Pallas kernel and the oracle
# ---------------------------------------------------------------------------


@needs_pallas
@pytest.mark.parametrize("b,h,t,dk,dv,chunk", [
    (1, 2, 128, 16, 16, 32),
    (2, 4, 96, 32, 16, 32),     # ragged tail chunk
    (1, 1, 64, 64, 64, 64),     # single chunk
    (1, 3, 130, 16, 64, 128),   # hymba's head dims, a ragged 2-token tail
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_plain_matches_kernel_sweep(b, h, t, dk, dv, chunk, dtype):
    (jq, jk, jv, jla, jh0), targs = both(scan_inputs(b, t, h, dk, dv),
                                         dtype)
    y, h_t = ssm_scan(*targs, chunk=chunk)
    assert y.dtype == targs[2].dtype and h_t.dtype == torch.float32
    assert tuple(y.shape) == (b, t, h, dv)
    jy, jh = ops.ssm_scan(jq, jk, jv, jla, jh0, chunk=chunk, interpret=True)
    close(jy, y, dtype)
    close(jh, h_t, dtype)
    oy, oh = oracle(jq, jk, jv, jla, jh0)
    close(oy, y, dtype)
    close(oh, h_t, dtype)


@needs_pallas
def test_ssm_scan_plain_nonzero_initial_state():
    """tests/test_kernels.py::test_ssm_scan_nonzero_initial_state."""
    arrs = scan_inputs(1, 64, 2, 16, 16, seed=7, h0_scale=0.5, decay=0.05)
    (jq, jk, jv, jla, jh0), targs = both(arrs)
    y, h_t = ssm_scan(*targs, chunk=16)
    jy, jh = ops.ssm_scan(jq, jk, jv, jla, jh0, chunk=16, interpret=True)
    close(jy, y)
    close(jh, h_t)
    oy, oh = oracle(jq, jk, jv, jla, jh0)
    close(oy, y)
    close(oh, h_t)


def test_ssm_scan_strong_decay_stays_finite():
    """log_a = -softplus(N(0, 1)) with hymba's a_log = 0: a 128-token
    chunk reaches L ~ -90, so exp(L_i - L_j) above the diagonal would
    overflow; it is masked before the exponential."""
    b, t, h, dk, dv = 1, 256, 2, 16, 64
    arrs = scan_inputs(b, t, h, dk, dv, seed=3)
    rng = np.random.default_rng(4)
    arrs[3] = -np.log1p(np.exp(rng.standard_normal((b, t, h)))).astype(
        np.float32)
    assert arrs[3][:, :128].sum(1).min() < -60
    (jq, jk, jv, jla, jh0), targs = both(arrs)
    y, h_t = ssm_scan(*targs)
    assert torch.isfinite(y).all() and torch.isfinite(h_t).all()
    oy, oh = oracle(jq, jk, jv, jla, jh0)
    close(oy, y)
    close(oh, h_t)


def test_ssm_scan_wrapper_on_cpu():
    """CPU tensors take the plain version (no launch is counted), q and k
    may broadcast over heads with stride 0, and bad shapes raise."""
    b, t, h, dk, dv = 2, 40, 3, 4, 64
    q, k, v, la, h0 = (torch.from_numpy(a) for a in
                       scan_inputs(b, t, h, dk, dv, seed=5))
    qs = q[:, :, :1].expand(b, t, h, dk)            # head stride 0
    ks = k[:, :, :1].expand(b, t, h, dk)
    assert qs.stride(2) == 0
    before = ssm_scan.launches
    y, h_t = ssm_scan(qs, ks, v, la, h0, chunk=16)
    assert ssm_scan.launches == before
    y2, h2 = ssm_scan_plain(qs.contiguous(), ks.contiguous(), v, la, h0,
                            chunk=16)
    assert torch.equal(y, y2) and torch.equal(h_t, h2)
    with pytest.raises(ValueError, match="log_a"):
        ssm_scan(q, k, v, la[:, :, :1], h0)
    with pytest.raises(ValueError, match="h0"):
        ssm_scan(q, k, v, la, h0[:, :, :2])
    with pytest.raises(ValueError, match="dtype"):
        ssm_scan(q, k, v.double(), la, h0)


# ---------------------------------------------------------------------------
# models/ssm.py vs repro.models.ssm at hymba-smoke width
# ---------------------------------------------------------------------------


def configs(dtype="float32"):
    return (jsmoke("hymba-1.5b").replace(dtype=dtype),
            tsmoke("hymba-1.5b").replace(dtype=dtype))


def mamba_params(jcfg, tcfg, seed=1):
    """The reference's random mamba weights in both packages."""
    jdt = jnp.float32 if jcfg.dtype == "float32" else jnp.bfloat16
    tree = jax.device_get(jprm.init_params(jssm.mamba_defs(jcfg),
                                           jax.random.key(seed), jdt))
    # nonzero dt_bias and a_log, so the decay is not the init's alone
    rng = np.random.default_rng(seed)
    nh = jssm.mamba_dims(jcfg)[1]
    tree["dt_bias"] = rng.standard_normal(nh).astype(np.float32) * 0.5
    tree["a_log"] = rng.standard_normal(nh).astype(np.float32) * 0.5
    tparams = tprm.load_tree(tssm.mamba_defs(tcfg), tree, None,
                             torch.device("cpu"))
    return jax.tree.map(jnp.asarray, tree), tparams


def hidden(b, t, d, seed=0):
    return np.random.default_rng(seed).standard_normal((b, t, d)).astype(
        np.float32)


def test_mamba_dims_and_defs_match():
    jcfg, tcfg = configs()
    assert tssm.mamba_dims(tcfg) == jssm.mamba_dims(jcfg) == (128, 2, 4)
    jdefs, tdefs = jssm.mamba_defs(jcfg), tssm.mamba_defs(tcfg)
    assert sorted(jdefs) == sorted(tdefs)
    for name in jdefs:
        assert tdefs[name].shape == jdefs[name].shape
        assert tdefs[name].dtype == jdefs[name].dtype
    assert tssm.mamba_dims(tget("hymba-1.5b")) == \
        jssm.mamba_dims(jget("hymba-1.5b")) == (3200, 50, 16)
    assert tssm.SSM_HEAD_DIM == jssm.SSM_HEAD_DIM


@pytest.mark.parametrize("t", [1, 2, 9])
def test_causal_conv1d_and_conv_step_match(t):
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    close(jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w)),
          tssm.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w)),
          tol=1e-6)
    state = rng.standard_normal((2, 3, 24)).astype(np.float32)
    jy, jst = jssm.conv_step(jnp.asarray(x[:, :1]), jnp.asarray(w),
                             jnp.asarray(state))
    ty, tst = tssm.conv_step(torch.from_numpy(x[:, :1]), torch.from_numpy(w),
                             torch.from_numpy(state))
    close(jy, ty, tol=1e-6)
    close(jst, tst, tol=0)


def test_recurrent_step_matches():
    q, k, v, la, h0 = scan_inputs(2, 1, 3, 4, 64, seed=8, h0_scale=0.5)
    jy, jh = jssm.recurrent_step(*map(jnp.asarray, (q, k, v, la, h0)))
    ty, th = tssm.recurrent_step(*map(torch.from_numpy, (q, k, v, la, h0)))
    close(jy, ty, tol=1e-6)
    close(jh, th, tol=1e-6)


@pytest.mark.parametrize("t,chunk", [(128, 128), (96, 32), (40, 128)])
def test_chunked_linear_attention_matches(t, chunk):
    arrs = scan_inputs(2, t, 2, 4, 64, seed=9, h0_scale=0.3)
    (jq, jk, jv, jla, jh0), targs = both(arrs)
    jy, jh = jssm.chunked_linear_attention(jq, jk, jv, jla, jh0, chunk=chunk)
    ty, th = tssm.chunked_linear_attention(*targs, chunk=chunk)
    close(jy, ty)
    close(jh, th)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_qkv_matches(dtype):
    jcfg, tcfg = configs(dtype)
    jp, tp = mamba_params(jcfg, tcfg)
    x = hidden(2, 12, jcfg.d_model)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for name, j, t in zip(("xs", "z", "B", "C", "dt", "log_a"),
                          jssm._mamba_qkv(jp, jx, jcfg),
                          tssm._mamba_qkv(tp, tx, tcfg)):
        assert str(t.dtype).split(".")[-1] == str(j.dtype), name
        close(j, t, dtype, tol=1e-5 if dtype == "float32" else None)


def test_init_ssm_state_matches():
    jcfg, tcfg = configs()
    js = jssm.init_ssm_state(3, jcfg, jnp.float32)
    ts = tssm.init_ssm_state(3, tcfg, torch.float32, torch.device("cpu"))
    assert ts._fields == js._fields == ("h", "conv")
    for a, b in zip(js, ts):
        assert tuple(b.shape) == a.shape and not b.any()
    assert ts.h.dtype == torch.float32


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "kernel"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_branch_then_steps_match(dtype, use_pallas):
    """A 64-token prefill through ``mamba_branch`` and 6 decode tokens
    through ``mamba_branch_step``, chained on each package's own state,
    against the JAX pair."""
    jcfg, tcfg = configs(dtype)
    tcfg = tcfg.replace(use_pallas=use_pallas)
    jp, tp = mamba_params(jcfg, tcfg)
    x = hidden(2, 70, jcfg.d_model, seed=2)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jo, jst = jssm.mamba_branch(jp, jx[:, :64], jcfg)
    to, tst = tssm.mamba_branch(tp, tx[:, :64], tcfg)
    tol = 1e-4 if dtype == "float32" else None
    close(jo, to, dtype, tol)
    close(jst.h, tst.h, dtype, tol)
    close(jst.conv, tst.conv, dtype, tol)
    assert tst.h.dtype == torch.float32 and tst.conv.dtype == tx.dtype
    for i in range(64, 70):
        jo, jst = jssm.mamba_branch_step(jp, jx[:, i:i + 1], jst, jcfg)
        to, tst = tssm.mamba_branch_step(tp, tx[:, i:i + 1], tst, tcfg)
        close(jo, to, dtype, tol)
    close(jst.h, tst.h, dtype, tol)


@pytest.mark.parametrize("t", [2, 3])
def test_mamba_branch_short_prompt_conv_state(t):
    """A prompt shorter than the conv window pads the conv state left."""
    jcfg, tcfg = configs()
    jp, tp = mamba_params(jcfg, tcfg)
    x = hidden(1, t, jcfg.d_model, seed=4)
    _, jst = jssm.mamba_branch(jp, jnp.asarray(x), jcfg)
    _, tst = tssm.mamba_branch(tp, torch.from_numpy(x), tcfg)
    assert tuple(tst.conv.shape) == jst.conv.shape == (1, 3, 128)
    close(jst.conv, tst.conv, tol=1e-6)


def test_ragged_prompt_reference_fault():
    """ROADMAP §C fault 3: the reference's ``mamba_branch`` asserts
    ``T % chunk == 0`` with ``chunk = min(128, T)``, so a 130-token prompt
    raises.  The port pads the tail as ``ops.ssm_scan`` does and matches
    the sequential oracle: the reference's own ``mamba_branch_step``
    walked over the 130 tokens from the zero state."""
    jcfg, tcfg = configs()
    jp, tp = mamba_params(jcfg, tcfg)
    x = hidden(1, 130, jcfg.d_model, seed=6)
    with pytest.raises(AssertionError, match="130, 128"):
        jssm.mamba_branch(jp, jnp.asarray(x), jcfg)
    for use_pallas in (False, True):
        to, tst = tssm.mamba_branch(tp, torch.from_numpy(x),
                                    tcfg.replace(use_pallas=use_pallas))
        step = jax.jit(lambda p, xt, st: jssm.mamba_branch_step(p, xt, st,
                                                                jcfg))
        st = jssm.init_ssm_state(1, jcfg, jnp.float32)
        outs = []
        for i in range(130):
            o, st = step(jp, jnp.asarray(x[:, i:i + 1]), st)
            outs.append(o)
        close(jnp.concatenate(outs, axis=1), to)
        close(st.h, tst.h)
        close(st.conv, tst.conv, tol=0)


def test_xlstm_kinds_not_ported_yet():
    _, tcfg = configs()
    for kind in ("mlstm", "slstm"):
        with pytest.raises(NotImplementedError, match="xLSTM"):
            tblocks.block_defs(tcfg, BlockSpec(kind=kind))
