"""Every other family's training against the JAX package on the CPU.

arctic-480b and kimi-k2 (MoE: the aux loss, the expert products under
grad), hymba-1.5b (the mamba branch's scan under grad), xlstm-350m (the
mLSTM's scan, the sLSTM token loop under autograd), qwen2-vl-2b (patch
embeddings over the first 12 slots at (t, h, w) M-RoPE positions) and
seamless-m4t-large-v2 (the encoder over 20 frames, cross attention), at
their smoke configs in f32: both packages start from the reference's
weights (``from_jax``) and take the same batches, made with numpy; the
port runs its kernels' plain versions (``use_pallas`` as the smoke sets
it) with remat as the smoke sets it.

* ``loss_fn``: the loss and xent within 1e-5, the aux loss within 1e-6.
* Every gradient leaf against ``jax.grad``, within ``GRAD_TOL`` (1e-4) of
  the leaf's largest magnitude, the band of the dense decoders
  (``tests/test_torch_train.py``).  Three smokes amplify f32 rounding
  past it, so their bands come from float64 references (the port's
  loss_fn run in float64 throughout, on the CPU): each package's f32
  gradient leaves stand from the float64 ones by at most
  kimi-k2 1.45e-4 (JAX) and 2.62e-4 (port), hymba 8.60e-4 and 7.48e-4,
  seamless 4.03e-4 and 3.66e-4, so the packages are held to each other
  within the sum, rounded up: 5e-4, 2e-3 and 1e-3 (measured 1.54e-4,
  1.11e-3 and 3.91e-4).  The other three stand within 1.1e-4 of
  float64 and are held at 1e-4 (measured arctic 8.7e-5, xlstm 3.8e-5,
  qwen2-vl 1.8e-5).
* One ``make_train_step`` (f32 moments; microbatch 2 for qwen2-vl and
  seamless, so every batch key is sliced) against the reference's on a
  (1, 1) mesh: loss within 1e-5, the gradient norm within the family's
  band, parameters where the clipped gradient stands clear of f32 noise
  and of eps within 1e-5 of their largest magnitude (AdamW's first step
  is sign-like; see ``tests/test_torch_train.py``), m within the band
  and v within twice it.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
from _jax_caps import HAVE_MESH_API, MESH_SKIP_REASON  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jmodels  # noqa: E402
from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.configs import get_smoke as tsmoke  # noqa: E402
from repro_torch.launch.train import (AdamWConfig, TrainPlan,  # noqa: E402
                                      make_train_step)
from repro_torch.models.params import (flatten, opt_state_from_jax,  # noqa: E402
                                       opt_state_to_numpy, unflatten)

GRAD_TOL = 1e-4
# from float64 references (see the module docstring)
FAMILY_TOL = {"kimi-k2-1t-a32b": 5e-4, "hymba-1.5b": 2e-3,
              "seamless-m4t-large-v2": 1e-3}
FAMILIES = ["arctic-480b", "kimi-k2-1t-a32b", "hymba-1.5b", "xlstm-350m",
            "qwen2-vl-2b", "seamless-m4t-large-v2"]
MICROBATCH = {"qwen2-vl-2b": 2, "seamless-m4t-large-v2": 2}
GRID = (4, 3)                 # the VLM's patches: 12 over the first slots
FRAMES = 20


def tol(name: str) -> float:
    return FAMILY_TOL.get(name, GRAD_TOL)


def vision_positions(b: int, n_text: int) -> np.ndarray:
    """(B, P + n_text, 3): patches at (0, row, col) of the grid, then text
    whose three streams run on together from max(grid)."""
    gh, gw = GRID
    hh, ww = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    vis = np.stack([np.zeros_like(hh), hh, ww], -1).reshape(gh * gw, 3)
    text = np.repeat((max(gh, gw) + np.arange(n_text))[:, None], 3, 1)
    pos = np.concatenate([vis, text]).astype(np.int32)
    return np.broadcast_to(pos[None], (b,) + pos.shape).copy()


def batch(cfg, b=2, s=24, seed=0):
    """Tokens and labels (-1 pads), plus the family's own inputs."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[0, -5:] = -1
    labels[1, 3] = -1
    out = {"tokens": toks, "labels": labels}
    if cfg.frontend == "patch":
        p = GRID[0] * GRID[1]
        out["vision_embeds"] = (0.5 * rng.standard_normal(
            (b, p, cfg.d_model))).astype(np.float32)
        out["positions"] = vision_positions(b, s - p)
    if cfg.is_encdec:
        out["frames"] = (0.5 * rng.standard_normal(
            (b, FRAMES, cfg.d_model))).astype(np.float32)
    return out


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def case(name):
    """(jax cfg, port cfg, reference weights, batch)."""
    jcfg = jsmoke(name).replace(dtype="float32")
    tcfg = tsmoke(name).replace(dtype="float32")
    tree = jax.device_get(jax.jit(jmodels.init, static_argnums=0)(
        jcfg, jax.random.key(0)))
    return jcfg, tcfg, tree, batch(jcfg)


@functools.lru_cache(maxsize=None)
def reference(name):
    """The reference's (loss, metrics, gradient leaves)."""
    jcfg, _, tree, b = case(name)
    fn = jax.jit(jax.value_and_grad(
        lambda p, bb: jmodels.loss_fn(p, jcfg, bb), has_aux=True))
    (loss, m), g = fn(jax.tree.map(jnp.asarray, tree),
                      jax.tree.map(jnp.asarray, b))
    return (float(loss), {k: float(v) for k, v in m.items()},
            [np.asarray(x) for x in jax.tree.leaves(g)])


@functools.lru_cache(maxsize=None)
def port(name):
    """The port's (loss, metrics, gradient leaves)."""
    _, tcfg, tree, b = case(name)
    leaves, treedef = flatten(tmodels.from_jax(tcfg, tree, device="cpu"))
    live = [p.detach().clone().requires_grad_(True) for p in leaves]
    loss, m = tmodels.loss_fn(unflatten(treedef, live), tcfg,
                              {k: torch.from_numpy(v) for k, v in b.items()})
    grads = torch.autograd.grad(loss, live)
    return (loss.item(), {k: v.item() for k, v in m.items()},
            [g.numpy() for g in grads])


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_xent_and_aux_match_reference(name):
    loss, m, _ = port(name)
    jloss, jm, _ = reference(name)
    assert set(m) == set(jm) == {"loss", "xent", "aux"}
    assert abs(loss - jloss) <= 1e-5
    assert abs(m["xent"] - jm["xent"]) <= 1e-5
    assert abs(m["aux"] - jm["aux"]) <= 1e-6
    if tsmoke(name).n_experts:
        assert m["aux"] > 0.5          # a load-balance loss near 1 or more
    else:
        assert m["aux"] == jm["aux"] == 0.0


@pytest.mark.parametrize("name", FAMILIES)
def test_gradients_match_jax_grad(name):
    _, _, grads = port(name)
    _, _, want = reference(name)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        assert rel(g, w) <= tol(name)
    # every leaf gets a gradient: the expert, scan and encoder weights too
    assert all(np.abs(g).max() > 0 for g in grads)


def jax_step(jcfg, plan, acfg, tree, jopt, b):
    from repro.launch.mesh import make_mesh
    from repro.launch.train import TrainPlan as JPlan
    from repro.launch.train import make_train_step as jmake

    mesh = make_mesh((1, 1), ("data", "model"))
    with jax.set_mesh(mesh):
        step, _ = jmake(jcfg, mesh, JPlan(microbatch=plan.microbatch),
                        acfg, shape=JShape("t", b["tokens"].shape[1],
                                           b["tokens"].shape[0], "train"))
        p, o, m = step(jax.tree.map(jnp.asarray, tree),
                       jax.tree.map(jnp.asarray, jopt), b)
        return jax.device_get((p, o, m))


@pytest.mark.skipif(not HAVE_MESH_API, reason=MESH_SKIP_REASON)
@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_matches_reference(name):
    jcfg, tcfg, tree, b = case(name)
    band = tol(name)
    plan = TrainPlan(microbatch=MICROBATCH.get(name, 1))
    kw = dict(lr=1e-2, warmup_steps=0, clip_norm=1e3)
    jacfg, tacfg = jadamw.AdamWConfig(**kw), AdamWConfig(**kw)
    jopt = jax.device_get(jadamw.adamw_init(jax.tree.map(jnp.asarray, tree),
                                            jacfg))
    jp, jo, jm = jax_step(jcfg, plan, jacfg, tree, jopt, b)

    params = tmodels.from_jax(tcfg, tree, device="cpu")
    opt = opt_state_from_jax(jopt, device="cpu")
    step = make_train_step(tcfg, None, plan, tacfg, device="cpu")
    params, opt, m = step(params, opt, b)
    assert abs(m["loss"].item() - float(jm["loss"])) <= 1e-5
    assert abs(m["grad_norm"].item() - float(jm["grad_norm"])) \
        <= band * float(jm["grad_norm"])
    if plan.microbatch == 1:
        jg = reference(name)[2]
    else:                     # the mean of the microbatches' gradients
        k = plan.microbatch
        gb = b["tokens"].shape[0] // k
        mbs = [{n: x[i * gb:(i + 1) * gb] for n, x in b.items()}
               for i in range(k)]
        grad = jax.jit(jax.grad(lambda p, bb: jmodels.loss_fn(p, jcfg,
                                                               bb)[0]))
        jg = [sum(np.asarray(x) for x in gs) / k for gs in zip(*(
            jax.tree.leaves(grad(jax.tree.map(jnp.asarray, tree), mb))
            for mb in mbs))]
    clip = min(1.0, tacfg.clip_norm / float(jm["grad_norm"]))
    held = total = 0
    for got, want, p0, g in zip(flatten(params)[0], jax.tree.leaves(jp),
                                jax.tree.leaves(tree), jg):
        got, g = got.numpy(), np.abs(g) * clip
        sure = (g > 1e-3 * g.max()) & (g > 1e-4)
        held += int(sure.sum())
        total += sure.size
        if sure.any():
            assert (np.abs(got - want)[sure].max()
                    <= 1e-5 * np.abs(want).max())
        assert (np.abs(got - p0) <= tacfg.lr * (1 + tacfg.weight_decay
                                                * np.abs(p0)) + 1e-6).all()
    assert held >= 0.3 * total, (held, total)
    got_o = opt_state_to_numpy(opt, jadamw.AdamWState, jadamw.Q8)
    assert int(got_o.step) == int(jo.step) == 1
    # m is 0.1 g after one step, v 0.05 g^2: twice g's relative error
    for moments, mband in (("m", band), ("v", 2 * band)):
        for got, want in zip(jax.tree.leaves(getattr(got_o, moments)),
                             jax.tree.leaves(getattr(jo, moments))):
            assert rel(got, want) <= mband
