"""The port's training path against the JAX package on the CPU.

Both packages start from the reference's weights (``from_jax``) and
optimizer state (``opt_state_from_jax``), and take the same batches,
made with numpy, in f32; the port runs its kernels' plain versions.

* ``loss_fn``, ``forward`` and ``hidden_states`` against the reference's
  on the dense smoke configs (tiny-agent, gemma3-27b's 13-layer nested
  local/global stack with qk-norm and softcap, h2o-danube-3's dh 120
  under a window, llama3-405b, command-r-plus's parallel block), labels
  with -1 pads: the loss within 1e-5; logits and hidden states within
  1e-4 (``rtol = atol``, the repo's prefill-logits band: each package's
  f32 hidden states stand up to 5.4e-5 from float64 ones at these
  sizes).
* Every gradient leaf against ``jax.grad``, within 1e-4 of the leaf's
  largest magnitude.  Measured: at most 6.3e-5 (command-r-plus's smoke);
  the JAX package's own f32 gradients stand up to 4.3e-5 from float64
  ones there, so this is f32 rounding, not a difference of method.
* Remat on and off give the same gradients, bit for bit; the flash
  wrapper (``use_pallas``) and the chunked attention agree.
* ``chunked_unembed_xent`` with pad labels and ``S % chunk != 0`` equals
  ``softmax_xent`` and the reference's.
* One ``make_train_step`` against the reference's on a (1, 1) mesh, for
  f32 moments, int8 moments and microbatch 2: loss within 1e-5, the
  gradient norm within 1e-4, parameters within 1e-5 of their largest
  magnitude wherever the reference's clipped gradient g exceeds 1e-3 of
  its leaf's largest and 1e-4 in value.  AdamW's first step moves a
  parameter by ``lr * g / (|g| + eps)``: a gradient within f32 noise of
  zero may move it either way, and one near ``eps`` moves it by a
  fraction that f32 noise in g changes; there only ``|change| <= lr *
  (1 + wd |p|)`` is held.
  m within 2e-4 and v (0.05 g^2 after one step) within 4e-4 of their
  largest magnitudes (f32 noise at this batch, measured against
  float64), and int8 moments' q within one step of the grid.
* The twin of ``tests/test_launch.py::test_train_step_runs_and_learns``.

The other families' training: ``tests/test_torch_train_families.py``.
"""
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
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.configs import get_smoke as tsmoke  # noqa: E402
from repro_torch.launch.train import (AdamWConfig, TrainPlan,  # noqa: E402
                                      make_train_step)
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.params import (flatten, opt_state_from_jax,  # noqa: E402
                                       opt_state_to_numpy, unflatten)
from repro_torch.optim.adamw import adamw_init  # noqa: E402

DENSE = ["tiny-agent", "gemma3-27b", "h2o-danube-3-4b", "llama3-405b",
         "command-r-plus-104b"]
# f32 gradients of both packages stand 1e-5 to 6e-5 (of each leaf's largest
# magnitude) from float64 ones at these sizes, so the packages are held
# to each other within 1e-4
GRAD_TOL = 1e-4
ARRAY_TOL = 1e-4
# the train step's batch (B 4): the port's f32 gradients stand up to
# 1.9e-4 from float64 ones there (its embedding leaf), the JAX package's
# up to 8.9e-5, so the moments (0.1 g and 0.05 g^2) are held to 2e-4 and
# 4e-4
STEP_TOL = 2e-4


def configs(name, **kw):
    return (jsmoke(name).replace(dtype="float32", **kw),
            tsmoke(name).replace(dtype="float32", **kw))


def batch(cfg, b=2, s=24, seed=0, pads=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    if pads:
        labels[0, -5:] = -1                  # a padded tail
        labels[1, 3] = -1
    return {"tokens": toks, "labels": labels}


def weights(jcfg, seed=0):
    return jax.device_get(jmodels.init(jcfg, jax.random.key(seed)))


def t_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def port_grads(tcfg, params, b):
    leaves, treedef = flatten(params)
    live = [p.detach().clone().requires_grad_(True) for p in leaves]
    loss, metrics = tmodels.loss_fn(unflatten(treedef, live), tcfg,
                                    t_batch(b))
    return loss, metrics, torch.autograd.grad(loss, live)


@pytest.mark.parametrize("name", DENSE)
def test_loss_forward_hidden_match_reference(name):
    jcfg, tcfg = configs(name)
    tree = weights(jcfg)
    params = tmodels.from_jax(tcfg, tree, device="cpu")
    b = batch(jcfg)
    jb = jax.tree.map(jnp.asarray, b)
    jp = jax.tree.map(jnp.asarray, tree)
    with torch.no_grad():
        loss, m = tmodels.loss_fn(params, tcfg, t_batch(b))
        logits, aux = tmodels.forward(params, tcfg, t_batch(b)["tokens"])
        hid, _ = tmodels.hidden_states(params, tcfg, t_batch(b)["tokens"])
    jloss, jm = jmodels.loss_fn(jp, jcfg, jb)
    jlogits, jaux = jmodels.forward(jp, jcfg, jb["tokens"])
    jhid, _ = jtransformer.hidden_states(jp, jcfg, jb["tokens"])
    assert abs(loss.item() - float(jloss)) <= 1e-5
    assert set(m) == set(jm) == {"loss", "xent", "aux"}
    assert abs(m["xent"].item() - float(jm["xent"])) <= 1e-5
    assert m["aux"].item() == float(jm["aux"]) == float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=ARRAY_TOL,
                               atol=ARRAY_TOL)
    np.testing.assert_allclose(hid.numpy(), jhid, rtol=ARRAY_TOL,
                               atol=ARRAY_TOL)


@pytest.mark.parametrize("name", DENSE)
def test_gradients_match_jax_grad(name):
    jcfg, tcfg = configs(name)
    tree = weights(jcfg)
    b = batch(jcfg)
    jgrads = jax.grad(lambda p: jmodels.loss_fn(p, jcfg, b)[0])(
        jax.tree.map(jnp.asarray, tree))
    _, _, grads = port_grads(tcfg, tmodels.from_jax(tcfg, tree, device="cpu"),
                             b)
    want = jax.tree.leaves(jgrads)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        assert rel(g.numpy(), w) <= GRAD_TOL


@pytest.mark.parametrize("name", ["tiny-agent", "gemma3-27b"])
def test_remat_gives_the_same_gradients(name):
    _, tcfg = configs(name)
    params = tmodels.init(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    b = batch(tcfg)
    _, _, on = port_grads(tcfg.replace(remat=True), params, b)
    _, _, off = port_grads(tcfg.replace(remat=False), params, b)
    for x, y in zip(on, off):
        assert torch.equal(x, y)


@pytest.mark.parametrize("name", ["tiny-agent", "h2o-danube-3-4b"])
def test_flash_wrapper_and_chunked_attention_agree(name):
    """``use_pallas`` routes training attention through the flash
    wrapper (its plain version here); without it the query-chunked
    ``attention_full`` runs.  The same loss within 1e-5 and gradients
    within the gradient band."""
    _, tcfg = configs(name)
    params = tmodels.init(tcfg, torch.Generator().manual_seed(1),
                          device="cpu")
    b = batch(tcfg, s=32)
    la, _, ga = port_grads(tcfg.replace(use_pallas=True), params, b)
    lb, _, gb = port_grads(tcfg.replace(use_pallas=False), params, b)
    assert abs(la.item() - lb.item()) <= 1e-5
    for x, y in zip(ga, gb):
        assert rel(x.numpy(), y.numpy()) <= GRAD_TOL


@pytest.mark.parametrize("s,chunk", [(30, 8), (24, 8), (7, 8), (30, 0)])
def test_chunked_xent_equals_softmax_xent(s, chunk):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, s, 16)).astype(np.float32)
    w = rng.standard_normal((16, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (2, s)).astype(np.int32)
    labels[0, -3:] = -1
    mask = (labels >= 0).astype(np.float32)
    safe = np.maximum(labels, 0)
    tx, tw = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(w)
    fn = (lambda xc: xc @ tw)
    got = tlayers.chunked_unembed_xent(fn, tx, torch.from_numpy(safe),
                                       torch.from_numpy(mask), chunk)
    whole = tlayers.softmax_xent(fn(tx), torch.from_numpy(safe),
                                 torch.from_numpy(mask))
    want = jlayers.chunked_unembed_xent(lambda xc: xc @ w, jnp.asarray(x),
                                        jnp.asarray(safe), jnp.asarray(mask),
                                        chunk)
    assert abs(got.item() - whole.item()) <= 1e-6
    assert abs(got.item() - float(want)) <= 1e-6
    gx, = torch.autograd.grad(got, tx)
    jgx = jax.grad(lambda xx: jlayers.chunked_unembed_xent(
        lambda xc: xc @ w, xx, jnp.asarray(safe), jnp.asarray(mask),
        chunk))(jnp.asarray(x))
    assert rel(gx.numpy(), jgx) <= 1e-5


def jax_step(jcfg, plan, acfg, tree, jopt, b):
    from repro.launch.mesh import make_mesh
    from repro.launch.train import TrainPlan as JPlan
    from repro.launch.train import make_train_step as jmake

    mesh = make_mesh((1, 1), ("data", "model"))
    with jax.set_mesh(mesh):
        step, _ = jmake(jcfg, mesh, JPlan(microbatch=plan.microbatch,
                                          int8_moments=plan.int8_moments),
                        acfg, shape=JShape("t", b["tokens"].shape[1],
                                           b["tokens"].shape[0], "train"))
        p, o, m = step(jax.tree.map(jnp.asarray, tree),
                       jax.tree.map(jnp.asarray, jopt), b)
        return jax.device_get((p, o, m))


@pytest.mark.skipif(not HAVE_MESH_API, reason=MESH_SKIP_REASON)
@pytest.mark.parametrize("plan", [TrainPlan(), TrainPlan(int8_moments=True),
                                  TrainPlan(microbatch=2)],
                         ids=["f32", "int8", "microbatch2"])
def test_train_step_matches_reference(plan):
    jcfg, tcfg = configs("tiny-agent")
    # clip_norm above the gradient norm (about 77): the clip is computed but
    # leaves the gradients as they are, so most of them stand clear of eps
    kw = dict(lr=1e-2, warmup_steps=0, clip_norm=1e3,
              int8_moments=plan.int8_moments)
    jacfg, tacfg = jadamw.AdamWConfig(**kw), AdamWConfig(**kw)
    tree = weights(jcfg)
    jopt = jax.device_get(jadamw.adamw_init(jax.tree.map(jnp.asarray, tree),
                                            jacfg))
    b = batch(jcfg, b=4)
    jp, jo, jm = jax_step(jcfg, plan, jacfg, tree, jopt, b)

    params = tmodels.from_jax(tcfg, tree, device="cpu")
    opt = opt_state_from_jax(jopt, device="cpu")
    step = make_train_step(tcfg, None, plan, tacfg, device="cpu")
    params, opt, m = step(params, opt, b)
    assert abs(m["loss"].item() - float(jm["loss"])) <= 1e-5
    assert abs(m["grad_norm"].item() - float(jm["grad_norm"])) \
        <= GRAD_TOL * float(jm["grad_norm"])
    assert m["lr"].item() == pytest.approx(float(jm["lr"]), rel=1e-6)
    k = plan.microbatch
    mbs = [{n: x[i * 4 // k:(i + 1) * 4 // k] for n, x in b.items()}
           for i in range(k)]
    jg = [sum(np.asarray(x) for x in gs) / k for gs in zip(*(
        jax.tree.leaves(jax.grad(lambda p: jmodels.loss_fn(p, jcfg, mb)[0])(
            jax.tree.map(jnp.asarray, tree))) for mb in mbs))]
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
    assert held >= 0.5 * total, (held, total)
    got_o = opt_state_to_numpy(opt, jadamw.AdamWState, jadamw.Q8)
    assert int(got_o.step) == int(jo.step) == 1
    # m is 0.1 g after one step, v 0.05 g^2: twice g's relative error
    for moments, band in ((("m", STEP_TOL), ("v", 2 * STEP_TOL))):
        for got, want in zip(jax.tree.leaves(getattr(got_o, moments)),
                             jax.tree.leaves(getattr(jo, moments))):
            if got.dtype == np.int8:
                assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
            else:
                assert rel(got, want) <= band


def test_train_step_runs_and_learns():
    _, tcfg = configs("tiny-agent")
    tcfg = tcfg.replace(dtype="bfloat16")
    acfg = AdamWConfig(lr=5e-3, warmup_steps=0)
    step = make_train_step(tcfg, None, TrainPlan(microbatch=2), acfg,
                           device="cpu")
    params = tmodels.init(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    opt = adamw_init(params, acfg)
    toks = np.random.default_rng(0).integers(
        0, tcfg.vocab, (4, 32)).astype(np.int32)
    b = {"tokens": toks, "labels": toks}
    losses = []
    for _ in range(12):
        params, opt, m = step(params, opt, b)
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0] - 0.3      # memorizes a fixed batch


def test_rescale_to_true_fan_in():
    """The training entry points' init: the attention projections at
    their true fan-in (d for wq, wk, wv; heads x dh for wo), every other
    leaf as ``init`` drew it."""
    from repro_torch.models.attention import rescale_to_true_fan_in

    _, tcfg = configs("llama3-405b")           # d 64, 4 / 2 heads, dh 128
    params = tmodels.init(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    before = [p.clone() for p in flatten(params)[0]]
    rescale_to_true_fan_in(params)
    attn = params["decoder"][0]["e0"]["attn"]
    for name, fan in (("wq", 64), ("wk", 64), ("wv", 64), ("wo", 4 * 128)):
        assert attn[name].std().item() == pytest.approx(fan ** -0.5,
                                                        rel=0.03)
    moved = [not torch.equal(a, b) for a, b in zip(before,
                                                   flatten(params)[0])]
    assert sum(moved) == 4
