"""The port's checkpoint manager (``repro_torch/checkpoint``): twins of
``tests/test_checkpoint.py``, and checkpoints across packages.

A bf16 parameter tree with an int8-moment AdamW state (``Q8`` leaves),
written by either package, restores in the other with every leaf equal
by value (bf16 by its bits), in the same flattened order.  An async save
holds a host copy, so an in-place update after ``save`` does not reach
the file.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.optim import adamw as ja  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.models.params import (flatten,  # noqa: E402
                                       opt_state_from_jax,
                                       opt_state_to_numpy)
from repro_torch.optim import adamw as ta  # noqa: E402


def _tree(x=1.0):
    return {"params": {"w": np.full((8, 4), x, np.float32),
                       "b": np.arange(4, dtype=np.int32)},
            "step": np.asarray(7)}


# ---------------------------------------------------------------------------
# Twins of tests/test_checkpoint.py
# ---------------------------------------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    t = _tree(2.5)
    mgr.save(10, t, meta={"data_step": 10})
    got, meta = mgr.restore(10, t)
    np.testing.assert_array_equal(got["params"]["w"], t["params"]["w"])
    np.testing.assert_array_equal(got["params"]["b"], t["params"]["b"])
    assert meta["data_step"] == 10


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(float(s)))
    assert mgr.steps() == [3, 4]
    got, _ = mgr.restore(4, _tree())
    assert got["params"]["w"][0, 0] == 4.0


def test_incomplete_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(1, _tree(1.0))
    # simulate a crashed writer: directory without _COMPLETE
    bad = tmp_path / "step_2"
    bad.mkdir()
    (bad / "arrays.npz").write_bytes(b"garbage")
    assert mgr.latest_step() == 1
    step, tree, _ = mgr.restore_latest(_tree())
    assert step == 1


def test_async_save_then_wait(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(5, _tree(5.0), blocking=False)
    mgr.wait()
    assert mgr.steps() == [5]


def test_restore_latest_none_when_empty(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    assert mgr.restore_latest(_tree()) is None


def test_restore_casts_dtypes(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=1)
    t = {"w": np.ones((4,), np.float32)}
    mgr.save(1, t)
    like = {"w": torch.zeros((4,), dtype=torch.bfloat16)}
    got, _ = mgr.restore(1, like)
    assert got["w"].dtype == torch.bfloat16
    assert (got["w"] == 1).all()


def test_leaf_count_mismatch_raises(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=1)
    mgr.save(1, {"a": np.ones(3)})
    with pytest.raises(ValueError, match="leaf count"):
        mgr.restore(1, {"a": np.ones(3), "b": np.ones(2)})


# ---------------------------------------------------------------------------
# Tensors, in-place updates, and across packages
# ---------------------------------------------------------------------------

def test_async_save_is_a_copy(tmp_path):
    """The train step updates parameters in place right after a save."""
    mgr = CheckpointManager(tmp_path, keep=1)
    w = torch.ones((64, 64))
    mgr.save(1, {"w": w}, blocking=False)
    w.add_(1.0)
    mgr.wait()
    got, _ = mgr.restore(1, {"w": torch.zeros((64, 64))})
    assert (got["w"] == 1).all()


def jax_state(seed=0):
    """bf16 parameters (a stacked leaf, a list) and an int8-moment state
    after one update, from the reference."""
    rng = np.random.default_rng(seed)
    params = {"stack": jnp.asarray(rng.standard_normal((2, 8, 200)),
                                   jnp.bfloat16),
              "norms": [jnp.asarray(rng.standard_normal((200,)),
                                    jnp.float32)],
              "emb": jnp.asarray(rng.standard_normal((30, 200)),
                                 jnp.bfloat16)}
    cfg = ja.AdamWConfig(int8_moments=True)
    opt = ja.adamw_init(params, cfg)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape), p.dtype), params)
    return jax.device_get(ja.adamw_update(grads, opt, params, cfg)[:2])


def as_float(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def test_checkpoint_written_by_jax_restores_in_the_port(tmp_path):
    params, opt = jax_state()
    JManager(tmp_path).save(3, (params, opt), meta={"data_step": 3})
    # the port's zero tree of the same shapes and dtypes
    like = (jax.tree.map(lambda a: torch.zeros(
        a.shape, dtype=torch.bfloat16 if a.dtype.name == "bfloat16"
        else torch.float32), params),
        opt_state_from_jax(jax.tree.map(np.zeros_like, opt), device="cpu"))
    (p, o), meta = CheckpointManager(tmp_path).restore(3, like)
    assert meta["data_step"] == 3
    assert isinstance(o, ta.AdamWState) and isinstance(o.m["emb"], ta.Q8)
    assert p["stack"].dtype == torch.bfloat16
    got = flatten((p, o))[0]
    want = jax.tree.leaves((params, opt))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(as_float(a), as_float(b))
    back = opt_state_to_numpy(o, ja.AdamWState, ja.Q8)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(opt)):
        assert np.array_equal(a, np.asarray(b))


def test_checkpoint_written_by_the_port_restores_in_jax(tmp_path):
    params, opt = jax_state(1)
    like = (params, opt)
    jp = jax.tree.map(lambda a: torch.from_numpy(
        np.asarray(a, np.float32)).to(torch.bfloat16)
        if a.dtype.name == "bfloat16" else torch.from_numpy(np.array(a)),
        params)
    to = opt_state_from_jax(opt, device="cpu")
    CheckpointManager(tmp_path).save(4, (jp, to), meta={"data_step": 4})
    (p, o), meta = JManager(tmp_path).restore(4, like)
    assert meta["data_step"] == 4 and meta["dtypes"][0] == "bfloat16"
    assert np.asarray(p["stack"]).dtype.name == "bfloat16"
    for a, b in zip(jax.tree.leaves((p, o)), jax.tree.leaves(like)):
        assert np.array_equal(as_float(a), as_float(b))
