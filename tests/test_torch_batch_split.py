"""The train step's batch split, against the reference's.

* ``launch.train._local_rows`` gives each batch rank GSPMD's padded
  shard of every microbatch without the pads: rank ``r`` of ``n`` holds
  rows ``[r c, min((r + 1) c, b))``, ``c = ceil(b / n)``, some ranks
  none; the ranks' rows put back in order are the global batch, and
  where ``n`` divides ``b`` the split is the even one it always was;
* ``check_mesh`` takes every batch the reference's ``batch_pspec`` and
  ``_constrain_act`` take (the four multi-pod train cells' 16
  microbatches of 16 rows over 32 batch ranks, a batch of 3 over 2) and
  refuses a global batch its microbatches do not split;
* reference fault 8 (ROADMAP §C): the JAX package's step at B 5 in 2
  microbatches is its step on the first 4 rows (``slice_mb`` drops the
  fifth); the port's step raises, naming 5 and 2, before any split (on
  (2, 1), in every gloo rank: ``tests/test_torch_launch.py``'s
  ``refuse-microbatch-split``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
from _jax_caps import HAVE_MESH_API, MESH_SKIP_REASON  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jmodels  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import models  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import ShapeMesh  # noqa: E402
from repro_torch.launch.train import (AdamWConfig, TrainPlan,  # noqa: E402
                                      _local_rows, check_mesh, default_plan,
                                      make_train_step)
from repro_torch.configs.base import SHAPES  # noqa: E402


# (global batch, microbatches, batch ranks)
SPLITS = [(4, 1, 2), (8, 2, 2), (256, 16, 32), (3, 1, 2), (6, 2, 4),
          (4, 4, 4), (2, 2, 2), (5, 1, 4), (16, 1, 32)]


@pytest.mark.parametrize("b,k,n", SPLITS,
                         ids=[f"B{b}-k{k}-n{n}" for b, k, n in SPLITS])
def test_local_rows_are_the_padded_shards(b, k, n):
    x = torch.arange(b)
    parts = [_local_rows(x, k, n, r) for r in range(n)]
    m = b // k
    c = -(-m // n)
    for r, part in enumerate(parts):
        held = max(0, min((r + 1) * c, m) - r * c)
        assert part.numel() == k * held
        # microbatch by microbatch: the i-th local slice is the rank's
        # share of the global i-th
        for i in range(k):
            want = torch.arange(i * m + r * c, i * m + r * c + held)
            assert torch.equal(part[i * held:(i + 1) * held], want)
    # the ranks' shares of each microbatch, in rank order, are the whole
    whole = torch.cat([p.view(k, -1) for p in parts], 1).reshape(-1)
    assert torch.equal(whole, x)
    if m % n == 0:
        # the even split of before: a reshape
        even = x.reshape(k, n, m // n)
        for r, part in enumerate(parts):
            assert torch.equal(part, even[:, r].reshape(-1))


def test_check_mesh_takes_every_split_the_reference_takes():
    multi = ShapeMesh(("pod", "data", "model"), (2, 16, 16))
    shape = SHAPES["train_4k"]
    for arch in ("llama3-405b", "command-r-plus-104b", "arctic-480b",
                 "kimi-k2-1t-a32b"):
        cfg = get_config(arch)
        plan = default_plan(cfg, shape)
        assert plan.microbatch == 16
        check_mesh(cfg, multi, shape.global_batch, plan.microbatch)
    tiny = get_config("tiny-agent")
    check_mesh(tiny, ShapeMesh(("data", "model"), (2, 1)), 3)
    check_mesh(tiny, ShapeMesh(("pod", "data", "model"), (2, 2, 1)), 6, 2)
    with pytest.raises(ValueError, match=r"tiny-agent on mesh .*a global "
                                         r"batch of 5 does not split into 2 "
                                         r"microbatches"):
        check_mesh(tiny, ShapeMesh(("data", "model"), (2, 1)), 5, 2)


def _batch(vocab: int, b: int, s: int = 16) -> dict:
    rng = np.random.default_rng(3)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": toks, "labels": labels}


@pytest.mark.skipif(not HAVE_MESH_API, reason=MESH_SKIP_REASON)
def test_reference_drops_the_rows_past_its_microbatches():
    """Reference fault 8: the JAX package's step at B 5 in 2 microbatches
    gives the loss, gradient norm and updated parameters of its step on
    the batch's first 4 rows, bit for bit; the fifth row is never
    read."""
    from repro.launch.mesh import make_mesh
    from repro.launch.train import TrainPlan as JPlan
    from repro.launch.train import make_train_step as jmake

    cfg = jget_config("tiny-agent").replace(dtype="float32")
    acfg = jadamw.AdamWConfig(lr=1e-2, warmup_steps=0)
    # numpy: the step donates its arguments' buffers
    tree = jax.device_get(jmodels.init(cfg, jax.random.key(0)))
    five = _batch(cfg.vocab, 5)
    four = {k: v[:4] for k, v in five.items()}
    mesh = make_mesh((1, 1), ("data", "model"))
    out = []
    with jax.set_mesh(mesh):
        for b in (five, four):
            step, _ = jmake(cfg, mesh, JPlan(microbatch=2), acfg,
                            shape=JShape("t", 16, len(b["tokens"]), "train"))
            p = jax.tree.map(jnp.asarray, tree)
            out.append(jax.device_get(step(
                p, jadamw.adamw_init(p, acfg),
                jax.tree.map(jnp.asarray, b))))
    (p5, _, m5), (p4, _, m4) = out
    assert float(m5["loss"]) == float(m4["loss"])
    assert float(m5["grad_norm"]) == float(m4["grad_norm"])
    for a, b in zip(jax.tree.leaves(p5), jax.tree.leaves(p4)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_port_refuses_a_batch_its_microbatches_do_not_split():
    """The port's one-device step raises on B 5 in 2 microbatches, naming
    both, where the reference drops a row; B 4 steps."""
    cfg = get_config("tiny-agent").replace(dtype="float32")
    acfg = AdamWConfig(lr=1e-2, warmup_steps=0)
    step = make_train_step(cfg, None, TrainPlan(microbatch=2), acfg,
                           device="cpu")
    params = models.init(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    with pytest.raises(ValueError, match="a global batch of 5 does not "
                                         "split into 2 microbatches"):
        step.grads(params, _batch(cfg.vocab, 5))
    g = step.grads(params, _batch(cfg.vocab, 4))
    assert all(torch.isfinite(t).all() for t in
               models.params.flatten(g)[0])


def test_a_leaf_cut_out_of_the_graph_raises_on_a_rank_with_rows():
    """Only a rank that holds no row of a microbatch takes a zero
    gradient for a leaf its graph does not reach: where the rank holds
    rows, a leaf the loss never reads still raises."""
    cfg = get_config("tiny-agent").replace(dtype="float32")
    step = make_train_step(cfg, None, TrainPlan(), AdamWConfig(),
                           device="cpu")
    params = models.init(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    params["unread"] = torch.ones(3)
    with pytest.raises(RuntimeError, match="not have been used"):
        step.grads(params, _batch(cfg.vocab, 2))
