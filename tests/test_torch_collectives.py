"""The port's int8 compressed all-reduce against the reference's.

* ``quantize_int8`` bit-equal to ``repro.distributed.collectives``'s
  (round half to even included);
* ``compressed_psum`` over 2 and 4 CPU ``gloo`` ranks (a ``pod`` mesh of
  that size, ranks spawned once per file) for 3 steps with the error
  feedback carried, against the reference's ``compressed_psum`` run under
  ``jax.vmap(..., axis_name="pod")`` on the stacked per-rank inputs: the
  residuals bit-equal, the means within f32 rounding (the port sums
  ``q_i * scale_i`` in rank order, the reference's ``psum`` in its own);
* ``wire_bytes_saved`` counts elements, as the reference's does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_ranks as ranks  # noqa: E402
from repro.distributed import collectives as jcoll  # noqa: E402
from repro_torch.distributed import collectives as coll  # noqa: E402

STEPS = 3


@pytest.mark.parametrize("seed", range(4))
def test_quantize_int8_bit_equal(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(257,)).astype(np.float32) * 10 ** (seed - 2)
    # ties: values that land exactly on .5 after the scale
    x[:4] = np.array([0.5, 1.5, -2.5, 127.0], np.float32) / 127.0 * np.abs(
        x).max()
    q, s = coll.quantize_int8(torch.from_numpy(x))
    jq, js = jcoll.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)
    z = np.zeros(5, np.float32)
    q0, s0 = coll.quantize_int8(torch.from_numpy(z))
    jq0, js0 = jcoll.quantize_int8(jnp.asarray(z))
    np.testing.assert_array_equal(q0.numpy(), np.asarray(jq0))
    assert s0.item() == float(js0)


@pytest.fixture(scope="module", params=[2, 4])
def psum_runs(request, tmp_path_factory):
    n = request.param
    res = ranks.spawn(n, [((n,), ["psum"])], tmp_path_factory.mktemp(
        f"psum{n}"))
    return n, [r[f"({n},):psum"] for r in res]


def _reference(n: int):
    """The reference's compressed_psum under vmap over ``pod``, step by
    step with its error feedback: [(mean leaves, ef leaves)]."""
    fn = jax.vmap(lambda g, e: jcoll.compressed_psum(g, e, "pod"),
                  axis_name="pod")
    ef, out = None, []
    for step in range(STEPS):
        trees = [ranks.psum_inputs(step, r) for r in range(n)]
        for t in trees:
            t["bf16"] = jnp.asarray(t["bf16"], jnp.bfloat16)
        g = jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
        if ef is None:
            ef = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), g)
        mean, ef = fn(g, ef)
        out.append(([np.asarray(x, np.float32) for x in jax.tree.leaves(mean)],
                    [np.asarray(x) for x in jax.tree.leaves(ef)],
                    [str(x.dtype) for x in jax.tree.leaves(mean)]))
    return out


def test_compressed_psum_matches_reference_under_vmap(psum_runs):
    n, runs = psum_runs
    assert all("error" not in r for r in runs), runs
    ref = _reference(n)
    for step, (want_mean, want_ef, want_dt) in enumerate(ref):
        for r, run in enumerate(runs):
            got = run["steps"][step]
            assert [d.split(".")[-1] for d in got["dtypes"]] == want_dt
            for a, b in zip(got["mean"], want_mean):
                np.testing.assert_allclose(np.asarray(a, np.float32), b[r],
                                           rtol=1e-6, atol=1e-6)
            for a, b in zip(got["ef"], want_ef):
                np.testing.assert_array_equal(np.asarray(a, np.float32),
                                              b[r])


def test_compressed_psum_ranks_agree(psum_runs):
    """Every rank holds the same mean; the residuals are the ranks' own."""
    n, runs = psum_runs
    for step in range(STEPS):
        means = [run["steps"][step]["mean"] for run in runs]
        assert all(m == means[0] for m in means[1:])
        efs = [run["steps"][step]["ef"][0] for run in runs]
        assert any(e != efs[0] for e in efs[1:])


def test_wire_bytes_saved_counts_elements():
    g = {"a": torch.zeros(16), "b": [torch.zeros(8, 12), torch.zeros(3)]}
    jg = {"a": jnp.zeros(16), "b": [jnp.zeros((8, 12)), jnp.zeros(3)]}
    assert coll.wire_bytes_saved(g) == jcoll.wire_bytes_saved(jg) == 115
