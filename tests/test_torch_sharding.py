"""The port's sharding rules against the reference's, by value.

* every test of ``tests/test_sharding.py`` mirrored on the port;
* ``param_pspecs``, ``cache_pspecs`` (``shard_seq`` both ways),
  ``input_pspecs`` and ``opt_pspecs`` (f32 and int8 moments) equal to
  ``repro.distributed.sharding`` / ``repro.launch`` for all 14 configs,
  the four ``SHAPES`` and the meshes 16x16, 2x16x16, 1x2, 2x1 and 2x2;
* the 34 cells of ``test_input_specs_all_cells_build``, as meta tensors.

Specs are pure shape logic, so these need no devices: both packages
take a shape-only mesh.
"""
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs.base import SHAPES, shape_applicable  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import specs as specs_mod  # noqa: E402
from repro_torch.launch.mesh import (ShapeMesh, make_production_mesh,  # noqa: E402
                                     mesh_chips)
from repro_torch.launch.train import opt_pspecs  # noqa: E402
from repro_torch.models import params as prm  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402

P = shd.PartitionSpec
NAMES = list(ARCHS) + ["tiny-agent", "lm-100m", "agent-7b", "agent-1b"]


class FakeMesh:
    """The reference's shape-only stand-in (``tests/test_sharding.py``)."""

    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)
        self.devices = np.empty(tuple(axes.values()), dtype=object)


MESH = ShapeMesh(("data", "model"), (16, 16))
POD = ShapeMesh(("pod", "data", "model"), (2, 16, 16))
MESHES = {"16x16": dict(data=16, model=16),
          "2x16x16": dict(pod=2, data=16, model=16),
          "1x2": dict(data=1, model=2), "2x1": dict(data=2, model=1),
          "2x2": dict(data=2, model=2)}


def _port_mesh(axes: dict) -> ShapeMesh:
    return ShapeMesh(tuple(axes), tuple(axes.values()))


def _jleaves(tree) -> list:
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, JP))]


def _leaves(tree) -> list:
    return [tuple(s) for s in prm.flatten(tree, is_leaf=shd.is_spec)[0]]


@pytest.fixture(autouse=True, scope="module")
def _memo_reference_cache_axes():
    """The reference's cache specs shape-diff ``init_cache`` under
    ``jax.eval_shape`` on every call; the answer depends only on (config,
    context, encoder length), so the module memoizes it."""
    orig = jshd._cache_batch_axes
    jshd._cache_batch_axes = functools.lru_cache(maxsize=None)(orig)
    yield
    jshd._cache_batch_axes = orig


# ---------------------------------------------------------------------------
# tests/test_sharding.py, mirrored
# ---------------------------------------------------------------------------


def test_tp_axes_map_to_model():
    s = shd.spec_for(("embed", "heads", None), (16384, 128, 128), MESH)
    assert s == P("data", "model", None)


def test_kv_heads_fallback_replicates():
    s = shd.spec_for(("embed", "kv_heads", None), (16384, 8, 128), MESH)
    assert s == P("data", None, None)


def test_mesh_axis_used_once_per_tensor():
    s = shd.spec_for(("experts", "embed", "ff"), (128, 7168, 4864), MESH)
    assert s == P("model", "data", None)


def test_joint_fsdp_over_pod_and_data():
    s = shd.spec_for(("embed", "vocab"), (16384, 128256), POD)
    assert s == P(("pod", "data"), "model")
    s2 = shd.spec_for(("embed", None), (16 * 17, 4), POD)
    assert s2 == P("data", None)


def test_stacked_param_leading_dims_replicated():
    specs = shd.param_pspecs(get_config("llama3-405b"), MESH)
    wq = specs["decoder"][0]["e0"]["attn"]["wq"]
    assert wq[0] is None
    assert "model" in wq and "data" in wq


def test_batch_pspec_divisibility():
    assert shd.batch_pspec(MESH, batch_size=256) == P("data")
    assert shd.batch_pspec(POD, batch_size=256) == P(("pod", "data"))
    assert shd.batch_pspec(POD, batch_size=16) == P("data")
    assert shd.batch_pspec(MESH, batch_size=1) == P(None)


def _kv_leaves(specs):
    return [s for s in _leaves(specs) if len(s) >= 4 and "model" in s]


def test_cache_specs_decode_batch_and_seq():
    specs = shd.cache_pspecs(get_config("llama3-405b"), batch=128,
                             max_context=32896, mesh=MESH)
    kv = _kv_leaves(specs)
    assert kv
    for s in kv:
        assert "data" in s
        assert s[-3] == "model" and s[-2] is None


def test_cache_specs_gqa16_heads_tp():
    specs = shd.cache_pspecs(get_config("gemma3-27b"), batch=128,
                             max_context=4096, mesh=MESH)
    kv = _kv_leaves(specs)
    assert kv
    for s in kv:
        assert s[-2] == "model"
        assert "data" in s


def test_cache_specs_long_context_seq_sharding():
    specs = shd.cache_pspecs(get_config("h2o-danube-3-4b"), batch=1,
                             max_context=524416, mesh=MESH, shard_seq=True)
    ring = [s for s in _leaves(specs) if len(s) == 5]
    assert ring
    for s in ring:
        assert s[-3] == "data"
        assert s[1] is None


def test_input_specs_all_cells_build():
    """input_specs / input_pspecs build for every (arch, shape): meta
    tensors, no memory, and a spec for every input leaf."""
    n = 0
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok, _ = shape_applicable(cfg, shape)
            if not ok:
                continue
            ins = specs_mod.input_specs(cfg, shape)
            ps = specs_mod.input_pspecs(cfg, shape, MESH)
            leaves = prm.flatten(ins)[0]
            assert all(t.device.type == "meta" for t in leaves)
            assert len(leaves) == len(_leaves(ps))
            n += 1
    assert n == 34          # 40 cells - 6 long_500k skips


def test_long_500k_cell_count():
    skips = [a for a in ARCHS
             if not shape_applicable(get_config(a), SHAPES["long_500k"])[0]]
    assert len(skips) == 6


# ---------------------------------------------------------------------------
# Parity with the reference, by value
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_param_and_opt_pspecs_equal_reference(name, mesh):
    axes = MESHES[mesh]
    pm, jm = _port_mesh(axes), FakeMesh(**axes)
    cfg, jcfg = get_config(name), jget_config(name)
    assert _leaves(shd.param_pspecs(cfg, pm)) == _jleaves(
        jshd.param_pspecs(jcfg, jm))
    for int8 in (False, True):
        got = _leaves(opt_pspecs(cfg, pm, AdamWConfig(int8_moments=int8)))
        want = _jleaves(jtrain.opt_pspecs(jcfg, jm,
                                          JAdamWConfig(int8_moments=int8)))
        assert got == want, (name, mesh, int8)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_input_and_cache_pspecs_equal_reference(name, mesh):
    axes = MESHES[mesh]
    pm, jm = _port_mesh(axes), FakeMesh(**axes)
    cfg, jcfg = get_config(name), jget_config(name)
    for shape in SHAPES.values():
        if not shape_applicable(cfg, shape)[0]:
            continue
        js = JSHAPES[shape.name]
        assert _leaves(specs_mod.input_pspecs(cfg, shape, pm)) == _jleaves(
            jspecs.input_pspecs(jcfg, js, jm)), (name, mesh, shape.name)
        if shape.kind != "decode":
            continue
        ctx = specs_mod.decode_context(shape)
        enc = specs_mod.enc_len(cfg, shape)
        for shard_seq in (False, True):
            got = shd.cache_pspecs(cfg, shape.global_batch, ctx, pm,
                                   enc_len=enc, shard_seq=shard_seq)
            want = jshd.cache_pspecs(jcfg, js.global_batch, ctx, jm,
                                     enc_len=enc, shard_seq=shard_seq)
            assert _leaves(got) == _jleaves(want), (name, mesh, shape.name,
                                                    shard_seq)


def test_batch_and_activation_pspecs_equal_reference():
    for axes in MESHES.values():
        pm, jm = _port_mesh(axes), FakeMesh(**axes)
        for b in (None, 1, 2, 16, 32, 256):
            assert tuple(shd.batch_pspec(pm, batch_size=b)) == tuple(
                jshd.batch_pspec(jm, batch_size=b))
        for seq in (False, True):
            assert tuple(shd.activation_pspec(pm, seq)) == tuple(
                jshd.activation_pspec(jm, seq))


def test_input_specs_shapes_equal_reference():
    """Every meta input has the reference's abstract shape and dtype."""
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        for shape in SHAPES.values():
            if not shape_applicable(cfg, shape)[0]:
                continue
            got = prm.flatten(specs_mod.input_specs(cfg, shape))[0]
            want = jax.tree.leaves(jspecs.input_specs(jcfg,
                                                      JSHAPES[shape.name]))
            assert [tuple(t.shape) for t in got] == [w.shape for w in want]
            assert [str(t.dtype).split(".")[-1] for t in got] == [
                str(w.dtype) for w in want]


def test_production_meshes_and_placements():
    assert MESH == make_production_mesh()
    assert POD == make_production_mesh(multi_pod=True)
    assert mesh_chips(MESH) == 256 and mesh_chips(POD) == 512
    from torch.distributed.tensor import Replicate, Shard

    wq = shd.param_shardings(get_config("llama3-405b"), POD)[
        "decoder"][0]["e0"]["attn"]["wq"]
    assert wq == [Shard(1), Shard(1), Shard(2)]
    norm = shd.param_shardings(get_config("llama3-405b"), MESH)[
        "final_norm"]["scale"]
    assert norm == [Replicate(), Replicate()]


def test_maybe_constrain_is_the_identity():
    x = torch.ones(2, 3)
    assert shd.maybe_constrain(x, P("data", None)) is x


def test_partition_spec_behaves_as_a_tuple():
    s = P(("pod", "data"), None, "model")
    assert s == (("pod", "data"), None, "model") and len(s) == 3
    assert repr(s).startswith("PartitionSpec(")
    import pickle

    assert pickle.loads(pickle.dumps(s)) == s
    assert shd.axes_size(s[0], dict(pod=2, data=16)) == 32


def test_package_exports_cover_the_reference():
    import repro.distributed as jdist

    import repro_torch.distributed as dist_pkg
    import repro_torch.launch as launch_pkg

    assert set(jdist.__all__) <= set(dist_pkg.__all__)
    for pkg in (dist_pkg, launch_pkg):
        for name in pkg.__all__:
            assert getattr(pkg, name) is not None
    with pytest.raises(AttributeError):
        getattr(dist_pkg, "no_such_name")
