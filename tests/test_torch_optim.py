"""The port's AdamW (``repro_torch/optim/adamw.py``) against the JAX
package's, and twins of ``tests/test_optim.py``.

* ``_quantize``: ``q`` bit-equal to the reference's, the scale within 1
  ulp (both round half to even); ``_dequantize`` equal.
* ``adamw_update`` from the same state and gradients, f32 and int8
  moments, five steps: parameters and f32 moments within 1e-6 of their
  largest magnitude, int8 ``q`` within one grid step, ``lr`` and
  ``grad_norm`` within 1e-6 relative (the schedule and bias corrections
  are f32 tensors, as the reference's).
* The sliced update (``UPDATE_SLICE`` forced small) equals the
  whole-leaf update bit for bit, and updates in place.
* The optimizer state crosses packages (``opt_state_from_jax``,
  ``opt_state_to_numpy``) unchanged.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as ja  # noqa: E402
from repro_torch.models.params import (opt_state_from_jax,  # noqa: E402
                                       opt_state_to_numpy)
from repro_torch.optim import adamw as ta  # noqa: E402
from repro_torch.optim.adamw import (AdamWConfig, _dequantize,  # noqa: E402
                                     _quantize, adamw_init, adamw_update)


def _params():
    gen = torch.Generator().manual_seed(0)
    return {"w": torch.randn((64, 256), generator=gen),
            "b": torch.zeros((256,)),
            "emb": torch.randn((100, 64), generator=gen)}


def _grad(loss, params):
    """jax.grad's counterpart: zeros for a leaf the loss does not use."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    grads = torch.autograd.grad(loss(leaves), list(leaves.values()),
                                allow_unused=True)
    return {k: torch.zeros_like(leaves[k]) if g is None else g
            for k, g in zip(leaves, grads)}


# ---------------------------------------------------------------------------
# Twins of tests/test_optim.py
# ---------------------------------------------------------------------------

def test_quantize_roundtrip_error_bounded():
    x = torch.randn((33, 200), generator=torch.Generator().manual_seed(2)) * 3
    q = _quantize(x)
    back = _dequantize(q, x.shape)
    err = (back - x).abs()
    # blockwise linear int8: error <= scale/2 per block
    assert err.max().item() <= x.abs().max().item() / 127.0 + 1e-6
    assert q.q.dtype == torch.int8


def test_quantize_handles_zeros_and_odd_shapes():
    for shape in [(1,), (5,), (3, 129), (2, 2, 130)]:
        x = torch.zeros(shape)
        back = _dequantize(_quantize(x), shape)
        assert (back == 0).all()


def test_adamw_decreases_quadratic_loss():
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=0,
                      total_steps=1000, min_lr_frac=1.0)
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    state = adamw_init(params, cfg)
    loss = lambda p: (p["w"] ** 2).sum()  # noqa: E731
    for _ in range(200):
        grads = _grad(loss, params)
        params, state, m = adamw_update(grads, state, params, cfg)
    assert loss(params).item() < 1e-2


def test_adamw_int8_tracks_f32():
    """int8 moments stay close to the f32 trajectory."""
    f32 = AdamWConfig(lr=0.01, weight_decay=0.01, warmup_steps=0)
    i8 = AdamWConfig(lr=0.01, weight_decay=0.01, warmup_steps=0,
                     int8_moments=True)
    p1 = _params()
    p2 = {k: v.clone() for k, v in p1.items()}
    s1, s2 = adamw_init(p1, f32), adamw_init(p2, i8)
    loss = lambda p: (p["w"] ** 2).mean() + ((p["emb"] - 1.0) ** 2).mean()  # noqa: E731,E501
    for _ in range(20):
        g1 = _grad(loss, p1)
        g2 = _grad(loss, p2)
        p1, s1, _ = adamw_update(g1, s1, p1, f32)
        p2, s2, _ = adamw_update(g2, s2, p2, i8)
    for k in p1:
        a, b = p1[k].double().ravel(), p2[k].double().ravel()
        denom = a.norm() * b.norm()
        if denom < 1e-9:
            continue                    # untouched zero leaf (bias)
        assert (a @ b / denom).item() > 0.999
        assert (a - b).abs().max().item() < 0.2


def test_grad_clipping():
    cfg = AdamWConfig(lr=0.0, clip_norm=1.0, warmup_steps=0)
    params = {"w": torch.ones((4,))}
    state = adamw_init(params, cfg)
    huge = {"w": torch.full((4,), 1e6)}
    _, _, metrics = adamw_update(huge, state, params, cfg)
    assert metrics["grad_norm"].item() > 1e6          # reported pre-clip


def test_warmup_and_cosine_schedule():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    params = {"w": torch.ones((2,))}
    state = adamw_init(params, cfg)
    lrs = []
    for _ in range(100):
        g = {"w": torch.zeros((2,))}
        params, state, m = adamw_update(g, state, params, cfg)
        lrs.append(m["lr"].item())
    assert lrs[0] < 0.2                          # warmup ramps
    assert abs(max(lrs) - 1.0) < 0.05            # peaks at lr
    assert lrs[-1] < 0.2                         # decays toward min frac


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(), (5,), (33, 200), (2, 3, 130),
                                   (4, 256)])
def test_quantize_matches_reference(shape):
    x = (np.random.default_rng(1).standard_normal(shape) * 3).astype(
        np.float32)
    if x.size > 3:
        x.flat[3] = 0.5 * np.abs(x).max() / 127.0 * 7   # a half-way point
    got, want = _quantize(torch.tensor(x)), ja._quantize(jnp.asarray(x))
    assert np.array_equal(got.q.numpy(), np.asarray(want.q))
    ulp = np.spacing(np.abs(np.asarray(want.scale)))
    assert (np.abs(got.scale.numpy() - np.asarray(want.scale)) <= ulp).all()
    back = _dequantize(got, shape).numpy()
    assert np.array_equal(back, np.asarray(ja._dequantize(want, shape)))


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_update_matches_reference(int8):
    """Five steps.  f32 moments: the port runs its own trajectory.  int8
    moments: each step starts the port from the reference's state, since
    a q that rounds the other way at a half point (an ulp apart before
    rounding) moves that moment by a whole grid step in the next one."""
    rng = np.random.default_rng(0)
    shapes = {"w": (3, 64, 300), "b": (300,), "s": ()}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=20, int8_moments=int8)
    jcfg, tcfg = ja.AdamWConfig(**kw), AdamWConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    js = ja.adamw_init(jp, jcfg)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    ts = adamw_init(tp, tcfg)
    for _ in range(5):
        if int8:
            tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
            ts = opt_state_from_jax(jax.device_get(js), device="cpu")
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        jp, js, jm = ja.adamw_update(jax.tree.map(jnp.asarray, g), js, jp,
                                     jcfg)
        tp, ts, tm = adamw_update({k: torch.tensor(v) for k, v in
                                   g.items()}, ts, tp, tcfg)
        for k in shapes:
            want = np.asarray(jp[k])
            assert np.abs(tp[k].numpy() - want).max() \
                <= 1e-6 * max(np.abs(want).max(), 1.0)
        assert tm["lr"].item() == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert tm["grad_norm"].item() == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
    got = opt_state_to_numpy(ts, ja.AdamWState, ja.Q8)
    assert int(got.step) == int(js.step) == 5
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(js)):
        b = np.asarray(b)
        if a.dtype == np.int8:
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        else:
            assert np.abs(a - b).max() <= 1e-6 * max(np.abs(b).max(), 1.0)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_sliced_update_equals_whole_leaf(int8, monkeypatch):
    # no clip: the norm's sum, taken slice by slice, is another order of
    # the same sum (held within 1e-6 below); everything else is
    # elementwise or blockwise along the last axis
    cfg = AdamWConfig(lr=1e-2, warmup_steps=0, clip_norm=0.0,
                      int8_moments=int8)
    gen = torch.Generator().manual_seed(3)
    shapes = {"stack": (4, 3, 40, 260), "mat": (50, 300), "vec": (700,)}
    params = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    grads = [{k: torch.randn(s, generator=gen) for k, s in shapes.items()}
             for _ in range(3)]
    runs = []
    for limit in (ta.UPDATE_SLICE, 100):     # whole leaves, then slices
        monkeypatch.setattr(ta, "UPDATE_SLICE", limit)
        p = {k: v.clone() for k, v in params.items()}
        ids = {k: v.data_ptr() for k, v in p.items()}
        s = adamw_init(p, cfg)
        norms = []
        for g in grads:
            p, s, m = adamw_update(g, s, p, cfg)
            norms.append(m["grad_norm"].item())
        assert {k: v.data_ptr() for k, v in p.items()} == ids   # in place
        runs.append((p, s, norms))
    assert ta._slices((4, 3, 40, 260)) != [()]
    (p1, s1, n1), (p2, s2, n2) = runs
    assert n1 == pytest.approx(n2, rel=1e-6)
    for k in shapes:
        assert torch.equal(p1[k], p2[k])
    for a, b in zip(opt_state_to_numpy(s1), opt_state_to_numpy(s2)):
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            assert np.array_equal(x, y)


def test_slices_tile_the_leaf_and_keep_the_last_axis_whole(monkeypatch):
    monkeypatch.setattr(ta, "UPDATE_SLICE", 1000)
    assert ta._slices((10,)) == [()]
    assert ta._slices((30, 30)) == [()]
    assert ta._slices((5, 3000)) == [(slice(i, i + 1),) for i in range(5)]
    assert ta._slices((3000, 7)) == [(slice(0, 142),), (slice(142, 284),)] \
        + [(slice(i, min(i + 142, 3000)),) for i in range(284, 3000, 142)]
    assert len(ta._slices((2, 3, 4, 500))) == 12
    assert ta._slices((2, 3, 4, 50)) == [(slice(0, 1),), (slice(1, 2),)]
    for shape in ((5, 3000), (3000, 7), (2, 3, 4, 500), (7, 9, 130)):
        x = torch.zeros(shape, dtype=torch.int32)
        for idx in ta._slices(shape):
            assert x[idx].numel() <= max(1000, shape[-1])
            x[idx] += 1
        assert (x == 1).all()                     # each element once


def test_slices_at_agent_7b(monkeypatch):
    """agent-7b's leaves: the stacked MLP one layer a slice, the
    attention weights a few layers, the embedding two runs of rows."""
    assert len(ta._slices((32, 4096, 11008))) == 32
    assert len(ta._slices((32, 4096, 32, 128))) == 8
    assert len(ta._slices((32000, 4096))) == 2
    assert ta._slices((32, 4096)) == [()]


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_state_crosses_packages(int8):
    params = {"a": jnp.ones((3, 130)), "z": [jnp.zeros((7,))]}
    js = jax.device_get(ja.adamw_init(params, ja.AdamWConfig(
        int8_moments=int8)))
    ts = opt_state_from_jax(js, device="cpu")
    assert type(ts) is ta.AdamWState
    assert isinstance(ts.m["a"], ta.Q8) == int8
    back = opt_state_to_numpy(ts, ja.AdamWState, ja.Q8)
    assert jax.tree.structure(back) == jax.tree.structure(js)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
