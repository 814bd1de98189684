"""The port's launch layer against the reference's, and its sharded steps
against its single-device steps.

* twins of ``tests/test_launch.py``: the dry run's helpers
  (``_period``, ``_scaled_cfg``, ``_units_full``, ``_lin``), and
  ``model_flops`` and ``recurrent_correction`` equal to the reference's
  for every cell; the serve and prefill steps on a (1, 1) mesh against
  the reference's on the same weights; ``opt_pspecs``' structure; the
  train step learning a fixed batch;
* sharded parity in CPU ``gloo`` ranks (``_torch_ranks``: one spawn of 2
  ranks and one of 4 for the file, ``FileStore`` rendezvous) on (1, 2),
  (2, 1), (2, 2), (1, 4) and a (2, 1, 1) pod mesh: tiny-agent (f32 and
  int8 moments, microbatches, one KV head replicated over the model
  axis), the arctic smoke (EP, forced drops at S < 256 and B > 1, and
  per-row dispatch at S 256), kimi's smoke (a dense first layer and a
  shared expert) and hymba's (data axes), each held to the single-device
  step: greedy tokens equal; logits, losses, every gradient leaf and
  every updated parameter within 1e-4 (``tests/test_torch_train.py``'s
  bands); the MoE's dropped fraction and aux loss equal;
* tensor parallelism over ``model`` of the hybrid, xLSTM, VLM and
  encoder-decoder smokes (hymba, xlstm, qwen2-vl with patch embeddings
  and (B, S, 3) positions, seamless with frames), train and serve on
  (1, 2) and (1, 4) and train on (2, 2): greedy tokens equal, logits
  within each config's band of ``tests/test_torch_train_families.py``
  (1e-4; hymba 2e-3, seamless 1e-3), and one train step's loss,
  gradient norm and every gradient leaf within it, each leaf relative to
  its largest magnitude (the mLSTM's f32 noise), the updated parameters
  where the gradient stands clear of f32 noise (AdamW's first step is
  sign-like, as the family tests hold it);
* serving over a sequence-sharded ring cache, held to the single device
  the same way, with each rank's slots (``S / n``): the GQA fallback over
  ``model`` (one KV head on (1, 2), tiny-agent's two on (1, 4), where
  three ranks' ranges stay empty), a ring that does not split kept whole
  under cut query heads, ``long_*`` over ``data`` on (2, 1) (tiny-agent,
  hymba, and danube's 24-slot windowed ring the prompt wraps) and on
  (2, 2) with a whole KV head under query heads cut over ``model``; and
  against the JAX package's own sharded serve steps on a forced
  four-device CPU mesh (``_jax_seq_ref.py``, a subprocess): the (1, 4)
  GQA fallback and the (2, 1) ``long_*`` ring, logits within 1e-4, and
  the hymba and seamless smokes (with frames) on (1, 2) within their
  config's band;
* every family over ``model`` accepted where it once was refused (the
  hybrid, xLSTM, VLM and encoder-decoder configs on the CPU meshes and
  the production mesh, their serve cells too); the refusals: a local
  attention shape no kernel takes, a batch that does not split for
  training, compressed gradients without a pod axis, a shape-only mesh
  of many devices;
* the dry run: a record for every applicable cell on both production
  meshes, its per-device parameter and optimizer bytes equal to the
  reference's ``abstract_state`` cut by the reference's specs, and none
  refused.
"""
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

jax.devices()        # fix the device count before the dry run's import

import _torch_ranks as ranks  # noqa: E402
from _jax_caps import HAVE_MESH_API, MESH_SKIP_REASON  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch import dryrun as jdry  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro_torch import models  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_smoke  # noqa: E402
from repro_torch.configs.base import (SHAPES, ShapeConfig,  # noqa: E402
                                      shape_applicable)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as specs_mod  # noqa: E402
from repro_torch.launch.mesh import ShapeMesh, make_mesh  # noqa: E402
from repro_torch.launch.serve import (check_serve,  # noqa: E402
                                      make_prefill_step, make_serve_step)
from repro_torch.launch.train import (AdamWConfig, TrainPlan,  # noqa: E402
                                      abstract_state, check_mesh,
                                      make_train_step, opt_pspecs)
from repro_torch.models import params as prm  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402

needs_mesh = pytest.mark.skipif(not HAVE_MESH_API, reason=MESH_SKIP_REASON)
ONE = ShapeMesh(("data", "model"), (1, 1))
TOL = 1e-4


def _cells():
    return [(a, s) for a in ARCHS for s in SHAPES
            if shape_applicable(get_config(a), SHAPES[s])[0]]


# ---------------------------------------------------------------------------
# The dry run's helpers, against the reference's
# ---------------------------------------------------------------------------


def test_model_flops_and_recurrent_correction_equal_reference():
    for arch, s in _cells():
        cfg, jcfg = get_config(arch), jget_config(arch)
        assert dryrun.model_flops(cfg, SHAPES[s]) == jdry.model_flops(
            jcfg, JSHAPES[s]), (arch, s)
        assert dryrun.recurrent_correction(cfg, SHAPES[s]) == \
            jdry.recurrent_correction(jcfg, JSHAPES[s]), (arch, s)


def test_scaled_cfg_period_and_units_equal_reference():
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        assert dryrun._period(cfg) == jdry._period(jcfg)
        assert dryrun._units_full(cfg) == jdry._units_full(jcfg)
        for u in (1, 2, 4):
            assert dataclasses.asdict(dryrun._scaled_cfg(cfg, u)) == \
                dataclasses.asdict(jdry._scaled_cfg(jcfg, u)), (arch, u)
    gem = get_config("gemma3-27b")
    assert dryrun._period(gem) == 6 and \
        dryrun._scaled_cfg(gem, 2).n_layers == 12


def test_linear_extrapolation_equals_reference():
    fa = {"flops": 10.0, "bytes_accessed": 6.0,
          "collectives": {"all-gather": 4, "total": 4, "count": 2}}
    fb = {"flops": 16.0, "bytes_accessed": 8.0,
          "collectives": {"all-gather": 6, "total": 6, "count": 3}}
    got = dryrun._lin(fa, fb, 2, 4, 10)
    assert got == jdry._lin(fa, fb, 2, 4, 10)
    assert got["flops"] == pytest.approx(34.0)
    assert got["collectives"]["count"] == 6


def test_dryrun_writes_every_cell_with_reference_bytes(tmp_path):
    """The CLI writes one record per (arch, shape, mesh); every applicable
    cell's per-device parameter and optimizer bytes equal the reference's
    abstract state cut by the reference's specs on the same mesh."""
    assert dryrun.main(["--out", str(tmp_path)]) == 0
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.iterdir())]
    assert len(recs) == 2 * len(ARCHS) * len(SHAPES)
    live = [r for r in recs if "skipped" not in r]
    assert len(live) == 2 * 34
    refused = [r["port_refuses"] for r in live if r["port_refuses"]]
    assert refused == []
    meshes = {"single": dict(data=16, model=16),
              "multi": dict(pod=2, data=16, model=16)}
    for rec in live:
        axes = meshes[rec["mesh"]]
        jm = _FakeMesh(**axes)
        jcfg = jget_config(rec["arch"])
        shape = JSHAPES[rec["shape"]]
        int8 = rec.get("plan", {}).get("int8_moments", False)
        jacfg = JAdamWConfig(int8_moments=int8)
        p, o = jtrain.abstract_state(jcfg, jacfg)
        want = _cut_bytes(p, jshd.param_pspecs(jcfg, jm), axes)
        by = rec["bytes_per_device"]
        assert by["params"] == want, rec
        if shape.kind == "train":
            assert by["opt"] == _cut_bytes(
                o, jtrain.opt_pspecs(jcfg, jm, jacfg), axes), rec
        assert by["total"] == sum(v for k, v in by.items() if k != "total")
        assert rec["fits_h100_80gb"] == (by["total"] <= 80e9)
        assert rec["model_flops"] == jdry.model_flops(jcfg, shape)


class _FakeMesh:
    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)
        self.devices = np.empty(tuple(axes.values()), dtype=object)


def _cut_bytes(tree, specs, sizes) -> int:
    from jax.sharding import PartitionSpec as JP

    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, JP))
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        n = math.prod(leaf.shape)
        for e in spec:
            for a in (e if isinstance(e, tuple) else (e,) if e else ()):
                n //= sizes[a]
        total += n * jnp.dtype(leaf.dtype).itemsize
    return total


# ---------------------------------------------------------------------------
# One device: the reference's (1, 1) mesh steps
# ---------------------------------------------------------------------------


def _jweights(jcfg):
    return jax.device_get(jmodels.init(jcfg, jax.random.key(0)))


@needs_mesh
def test_serve_step_matches_reference_on_one_device():
    from repro.launch.mesh import make_mesh as jmake_mesh
    from repro.launch.serve import make_serve_step as jmake

    jcfg = jget_config("tiny-agent").replace(dtype="float32")
    cfg = get_config("tiny-agent").replace(dtype="float32")
    shape = ShapeConfig("d", 64, 2, "decode")
    tree = _jweights(jcfg)
    mesh = jmake_mesh((1, 1), ("data", "model"))
    toks = np.array([[3], [5]], np.int32)
    ctx = specs_mod.decode_context(shape)
    with jax.set_mesh(mesh):
        jstep, jspecs = jmake(jcfg, mesh, JShape("d", 64, 2, "decode"))
        want, _ = jstep(jax.tree.map(jnp.asarray, tree), jnp.asarray(toks),
                        jmodels.init_cache(jcfg, 2, ctx))
    step, specs = make_serve_step(cfg, ONE, shape, device="cpu")
    params = prm.from_jax(cfg, tree, device="cpu")
    got, cache = step(params, torch.from_numpy(toks),
                      models.init_cache(cfg, 2, ctx, device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    assert cache["pos"].tolist() == [1, 1]
    assert set(specs) == set(jspecs) == {"params", "cache", "batch"}


@needs_mesh
def test_prefill_step_matches_reference_on_one_device():
    from repro.launch.mesh import make_mesh as jmake_mesh
    from repro.launch.serve import make_prefill_step as jmake

    jcfg = jget_config("tiny-agent").replace(dtype="float32")
    cfg = get_config("tiny-agent").replace(dtype="float32")
    tree = _jweights(jcfg)
    mesh = jmake_mesh((1, 1), ("data", "model"))
    toks = (np.arange(64, dtype=np.int32).reshape(2, 32) % cfg.vocab)
    with jax.set_mesh(mesh):
        jstep, _ = jmake(jcfg, mesh, JShape("p", 32, 2, "prefill"))
        want, _ = jstep(jax.tree.map(jnp.asarray, tree), jnp.asarray(toks),
                        jmodels.init_cache(jcfg, 2, 32))
    step, _ = make_prefill_step(cfg, ONE, ShapeConfig("p", 32, 2, "prefill"),
                                device="cpu")
    got, cache = step(prm.from_jax(cfg, tree, device="cpu"),
                      torch.from_numpy(toks),
                      models.init_cache(cfg, 2, 32, device="cpu"))
    assert got.shape == (2, cfg.vocab) and int(cache["pos"][0]) == 32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_opt_pspecs_structure_matches_state():
    cfg = get_smoke("llama3-405b")
    for int8 in (False, True):
        acfg = AdamWConfig(int8_moments=int8)
        spec = opt_pspecs(cfg, ONE, acfg)
        _, state = abstract_state(cfg, acfg)
        from repro_torch.distributed.sharding import is_spec
        s_leaves, s_def = prm.flatten(spec, is_leaf=is_spec)
        t_leaves, t_def = prm.flatten(state)
        assert s_def == t_def and len(s_leaves) == len(t_leaves)
        assert all(len(s) == t.ndim for s, t in zip(s_leaves, t_leaves))
        assert all(t.device.type == "meta" for t in t_leaves)


def test_train_step_runs_and_learns():
    cfg = get_config("tiny-agent")
    acfg = AdamWConfig(lr=5e-3, warmup_steps=0)
    step = make_train_step(cfg, ONE, TrainPlan(microbatch=2), acfg,
                           shape=ShapeConfig("t", 32, 4, "train"),
                           device="cpu")
    params = models.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = adamw_init(params, acfg)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (4, 32))
    batch = {"tokens": toks, "labels": toks}
    losses = []
    for _ in range(12):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3
    assert set(step.shardings) == {"params", "opt", "state", "batch"}


# ---------------------------------------------------------------------------
# Refusals (shape logic; the ranks below show the factories raise them)
# ---------------------------------------------------------------------------


def _mesh(**axes) -> ShapeMesh:
    return ShapeMesh(tuple(axes), tuple(axes.values()))


@pytest.mark.parametrize("name", ["hymba-1.5b", "xlstm-350m", "qwen2-vl-2b",
                                  "seamless-m4t-large-v2"])
def test_tp_of_other_families_refused_by_name(name):
    """Once refused over a model axis larger than one (ROADMAP A6.1), the
    hybrid, xLSTM, VLM and encoder-decoder configs now pass
    ``check_mesh`` on every mesh, their smokes and full widths, with the
    kernels' local attention shapes checked (hymba's 25 heads and 5 KV
    heads stay whole at 16-way TP, seamless's 16 go one a rank; at 4-way
    TP qwen2-vl's 12 heads over 2 KV heads would leave a GQA group of 3,
    which the kernels take since they run every G)."""
    for cfg in (get_smoke(name), get_config(name)):
        for mesh in (_mesh(data=1, model=2), _mesh(data=2, model=1),
                     _mesh(data=1, model=4), _mesh(data=16, model=16),
                     _mesh(pod=2, data=16, model=16)):
            check_mesh(cfg, mesh)
            check_mesh(cfg.replace(use_pallas=True), mesh)


def test_sequence_sharded_cache_refused_for_serving():
    """No serve cell is refused: every family's cells on the production
    mesh pass ``check_serve`` with the kernels on, those whose ring the
    spec cuts over ``model`` (the GQA fallback: hymba's 5 KV heads and
    qwen2-vl's 2, whole query heads over a rank's slots) or over
    ``data`` (``long_*``) included, and seamless's cross K/V cut by
    heads."""
    mesh = make_prod()
    cut = served = 0
    for arch in ARCHS:
        cfg = get_config(arch).replace(use_pallas=True)
        for name in ("prefill_32k", "decode_32k", "long_500k"):
            shape = SHAPES[name]
            if not shape_applicable(cfg, shape)[0]:
                continue
            cache = specs_mod.input_pspecs(cfg, shape, mesh)["cache"]
            cut += any(s[-3] is not None for s in _ring_specs(cache))
            check_serve(cfg, mesh, cache)
            served += 1
    assert cut == 17          # of the 80 cells of the single-pod mesh
    # prefill_32k and decode_32k of the ten configs, long_500k of four
    assert served == 24
    dan = get_config("h2o-danube-3-4b")
    long = SHAPES["long_500k"]
    spec = _ring_specs(specs_mod.input_pspecs(dan, long, mesh)["cache"])[0]
    assert spec[-3] == "data" and spec[-2] is None
    check_serve(dan, mesh, specs_mod.input_pspecs(dan, long, mesh)["cache"])


def _ring_specs(tree) -> list:
    from repro_torch.models.attention import KVCache

    if isinstance(tree, KVCache):
        return [tree.k]
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _ring_specs(v)]
    if isinstance(tree, list):
        return [s for v in tree for s in _ring_specs(v)]
    return []


def make_prod():
    from repro_torch.launch.mesh import make_production_mesh

    return make_production_mesh()


def test_local_attention_shape_refused_with_config_and_mesh():
    """A head dim past 256 has no kernel on any mesh (the reference pads
    it: ROADMAP A7.1); every local GQA group runs, 12 query heads over 1
    KV head at 4-way TP leaving G 3 included."""
    cfg = get_config("tiny-agent").replace(d_head=264, use_pallas=True)
    with pytest.raises(ValueError, match=r"tiny-agent on mesh .*'model': 4"
                                         r".*no kernel.*dh from 1 to 256"):
        check_mesh(cfg, _mesh(data=1, model=4))
    cfg = get_config("tiny-agent").replace(n_heads=12, n_kv_heads=1,
                                           use_pallas=True)
    check_mesh(cfg, _mesh(data=1, model=4))          # local G 3
    check_mesh(cfg, _mesh(data=1, model=2))          # local G 6
    # llama3-405b at 16-way TP: 8 query heads on one replicated KV head
    check_mesh(get_config("llama3-405b").replace(use_pallas=True),
               _mesh(data=16, model=16))


def test_sharded_step_needs_a_device_mesh_and_a_process_group():
    cfg = get_config("tiny-agent")
    with pytest.raises(RuntimeError, match="DeviceMesh"):
        make_train_step(cfg, _mesh(data=1, model=2), device="cpu")
    with pytest.raises(RuntimeError, match="DeviceMesh"):
        make_serve_step(cfg, _mesh(data=2, model=1),
                        ShapeConfig("d", 32, 2, "decode"))
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh((1, 2), ("data", "model"), device_type="cpu")
    with pytest.raises(ValueError, match="pod"):
        make_train_step(cfg, ONE, TrainPlan(compress_grads=True),
                        device="cpu")


# ---------------------------------------------------------------------------
# Sharded parity in gloo ranks
# ---------------------------------------------------------------------------

TRAIN = ["train-tiny-f32", "train-tiny-int8", "train-tiny-micro",
         "train-arctic", "train-arctic-drops", "train-kimi"]
SERVE = ["serve-tiny", "serve-arctic"]
MOE = ["dispatch-arctic", "dispatch-arctic-rows"]
# tensor parallelism over ``model`` of the hybrid, xLSTM, VLM and
# encoder-decoder smokes
FAMILY_TRAIN = ["train-hymba-tp", "train-xlstm", "train-qwen2vl",
                "train-seamless"]
FAMILY_SERVE = ["serve-hymba", "serve-xlstm", "serve-qwen2vl",
                "serve-seamless"]
# hymba's full-width layout at smoke size: whole query heads over a ring
# cut over ``model``, the mamba branch cut
WHOLE_HEADS = ["train-hymba-whole", "serve-hymba-whole"]
FAMILY = set(FAMILY_TRAIN + FAMILY_SERVE + WHOLE_HEADS)
CKPT_SAVE = ["ckpt-save"]
CKPT_JAX = ["ckpt-jax-tiny", "ckpt-jax-llama"]
PLAN2 = [((1, 2), TRAIN + ["train-tiny-kv1"] + SERVE + MOE + [
            "refuse-tp-hybrid", "serve-tiny-kv1", "serve-tiny-kv1-odd"]
          + FAMILY_TRAIN + FAMILY_SERVE + WHOLE_HEADS
          + ["jax-ref-hymba", "jax-ref-seamless"]),
         ((2, 1), TRAIN + ["train-hymba", "serve-hymba"] + SERVE + MOE + [
            "refuse-batch-split", "serve-tiny-long", "serve-hymba-long",
            "serve-danube-long", "jax-ref-long", "refuse-compress-no-pod"]),
         ((2, 1, 1), ["train-tiny-int8", "train-tiny-compress",
                      "serve-tiny"]),
         # checkpoints of a sharded train state: saved on (2, 1) with
         # FSDP, restored there, onto (1, 2) and (in the test) onto one
         # process; the JAX package's checkpoints restored on both meshes
         ((2, 1), CKPT_SAVE + CKPT_JAX + ["ckpt-supervised"]),
         ((1, 2), ["ckpt-restore", "ckpt-scales", "ckpt-refuse-save",
                   "ckpt-supervised"] + CKPT_JAX)]
PLAN4 = [((2, 2), TRAIN + ["train-tiny-kv1"] + SERVE + MOE + [
            "serve-kv1-long", "train-hymba-tp", "train-seamless"]),
         ((1, 4), ["refuse-local-shape", "serve-tiny", "jax-ref-gqa"]
          + FAMILY_TRAIN + FAMILY_SERVE)]
CASES = [(shape, n, w) for w, plan in ((2, PLAN2), (4, PLAN4))
         for shape, names in plan for n in names]
REFUSED = {"refuse-batch-split": "does not split",
           "refuse-compress-no-pod": "'pod'",
           "refuse-local-shape": "no kernel"}
# refused until the model axis cut every family: now the step builds
ACCEPTED = {"refuse-tp-hybrid"}
# the config of each serve and JAX-reference check
# (``_torch_ranks.CONFIGS``)
SERVED = {"serve-tiny": "tiny", "serve-arctic": "arctic",
          "serve-hymba": "hymba", "serve-tiny-kv1": "tiny-kv1",
          "serve-tiny-kv1-odd": "tiny-kv1", "serve-tiny-long": "tiny",
          "serve-kv1-long": "tiny-kv1", "serve-hymba-long": "hymba",
          "serve-danube-long": "danube", "serve-xlstm": "xlstm",
          "serve-qwen2vl": "qwen2vl", "serve-seamless": "seamless",
          "serve-hymba-whole": "hymba-whole",
          "jax-ref-hymba": "hymba", "jax-ref-seamless": "seamless"}
# each family check's band: its config's in
# ``tests/test_torch_train_families.py`` (1e-4 but for hymba, seamless)
BAND = {"hymba": 2e-3, "seamless": 1e-3}


def _band(name: str) -> float:
    return BAND.get(SERVED.get(name) or name.split("-")[1], TOL)


def _seq_shards(name: str, shape, kv: int, ring: int) -> int:
    """The ranks a check's ring is cut over: ``long_*`` over ``data``,
    else the GQA fallback over ``model`` where the KV heads do not divide
    it and the ring does."""
    if name.endswith("-long"):
        return shape[-2]
    m = shape[-1]
    return m if kv % m and ring % m == 0 else 1


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    dirs = {w: tmp_path_factory.mktemp(f"w{w}") for w in (2, 4)}
    ref = dirs[2] / "jax_seq_ref.pkl"
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(root / "src"))
    # the JAX package's sharded serve steps, in a process whose JAX sees
    # four CPU devices; a failure shows in the jax-ref checks
    subprocess.run([sys.executable, str(root / "tests" / "_jax_seq_ref.py"),
                    str(ref), "gqa", "long", "hymba", "seamless", "ckpt"],
                   env=env, timeout=300, check=False)
    if ref.exists():
        shutil.copy(ref, dirs[4] / ref.name)
    return {2: ranks.spawn(2, PLAN2, dirs[2]),
            4: ranks.spawn(4, PLAN4, dirs[4]), "dirs": dirs}


@pytest.mark.parametrize("shape,name,world", CASES,
                         ids=[f"{'x'.join(map(str, s))}-{n}"
                              for s, n, _ in CASES])
def test_sharded_step_matches_single_device(rank_results, shape, name,
                                            world):
    key = f"{tuple(shape)}:{name}"
    for r, res in enumerate(rank_results[world]):
        got = res[key]
        assert "error" not in got, f"rank {r}: {got.get('error')}"
        if name.startswith("ckpt-"):
            _check_ckpt(name, shape, got)
        elif name in ACCEPTED:
            assert not got["raised"], got
        elif name.startswith("refuse-"):
            assert got["raised"] and REFUSED[name] in got["message"], got
        elif name in FAMILY and name.startswith("train-"):
            # one step, each gradient leaf relative to its largest
            # magnitude, the update where the gradient clears f32 noise
            band = _band(name)
            assert got["grad_rel"] <= band, got
            assert got["loss"] <= band and got["norm_rel"] <= band, got
            assert got["params_sure"] <= band and got["held"] >= 0.3, got
            assert got["bounded"] and got["moved"] > 10 * TOL, got
        elif name == "train-tiny-compress":
            # int8 on the wire: the gradients within the quantization step
            # of the two ranks' shares, the first loss (same weights) equal
            assert got["grads"] <= 2 * got["grad_max"] / 127, got
            assert got["loss0"] <= TOL
            assert got["ef_leaves"] > 0 and got["ef_max"] > 0
        elif name.startswith("train-"):
            assert got["grads"] <= TOL * max(got["grad_max"], 1.0), got
            assert got["loss"] <= TOL and got["norm_rel"] <= TOL, got
            assert got["params"] <= TOL and got["moved"] > 10 * TOL, got
        elif name.startswith("serve-"):
            # every served smoke within 1e-4, inside each config's band
            assert got["tokens_equal"] and got["logits"] <= TOL, got
            m = shape[-1]
            kv = ranks.CONFIGS[SERVED[name]]().n_kv_heads
            if name == "serve-xlstm":            # recurrent state only
                assert "kv_heads" not in got, got
                continue
            assert got["kv_heads"] == (kv // m if kv % m == 0 else kv)
            n = _seq_shards(name, shape, kv, got["ring"])
            assert got["slots"] * n == got["ring"], got
            if name == "serve-seamless":         # cross K/V cut by heads
                assert got["cross_heads"] == kv // m, got
        elif name.startswith("jax-ref-"):
            # the port's sharded steps against the JAX package's own
            band = _band(name)
            assert got["steps"] == 6 and got["logits"] <= band, got
            n = {"jax-ref-gqa": 4, "jax-ref-long": 2}.get(name, 1)
            assert got["slots"] * n == got["ring"], got
        elif name.startswith("dispatch-"):
            assert got["dropped_ref"] > 0
            assert got["dropped"] <= 1e-6 and got["aux"] <= 1e-6, got
            assert got["y"] <= TOL, got


def _check_ckpt(name: str, shape, got: dict) -> None:
    """A checkpoint check's results (``_torch_ranks.CKPT``)."""
    if name == "ckpt-save":
        # restored onto (2, 1) bit-equal to the state saved; the whole
        # restore equal to the gather and, cut, to the rank's shards;
        # tiny-agent's 64-column FSDP shards keep whole block scales
        assert got["same"] and got["whole"] and got["recut"], got
        assert got["latest"] == got["step"] == 1, got
        assert [2, 256, 64] in [q for q, _ in got["whole_scales"]], got
        assert all(sc[-1] == 1 for _, sc in got["whole_scales"]), got
    elif name == "ckpt-restore":
        assert got["equal"] and got["leaves"] == 61, got
    elif name == "ckpt-scales":
        # the (2, 64, 192) leaves: 96 columns a rank, both blocks' scales
        assert got["same"] and got["step_equal"], got
        assert got["whole_scales"] == [[[2, 64, 96], [2, 64, 2]]] * 2, got
        assert "(2, 64, 1), not the like leaf's (2, 64, 2)" in \
            got["opt_specs_raise"], got
    elif name == "ckpt-supervised":
        assert got["restarts"] == 2 and got["steps"] == 12, got
        assert got["losses_equal"] and got["equal"], got
    elif name == "ckpt-refuse-save":
        assert got["raised"] and "without shardings" in got["message"], got
        assert got["written"] == [], got
    else:
        # the JAX package's restore onto the same mesh, bit for bit; on
        # (1, 2) the llama smoke's whole scales against the whole leaves
        assert got["bad"] == [] and got["leaves"] == 61, got
        whole = 4 if name == "ckpt-jax-llama" and shape == (1, 2) else 0
        assert got["held_whole"] == whole, got


def test_sharded_checkpoint_restores_in_a_world_of_one(rank_results):
    """The (2, 1) FSDP ranks' checkpoint restored by one process with no
    mesh: every leaf bit-equal to the tree they gathered."""
    from repro_torch.checkpoint import CheckpointManager

    d = rank_results["dirs"][2]
    whole = torch.load(d / "ckpt_whole.pt")
    like = [torch.zeros_like(t) for t in whole]
    got, meta = CheckpointManager(d / "ckpt").restore(1, like)
    assert meta["step"] == 1 and meta["data_step"] == 1
    assert len(got) == len(whole) == 61
    for x, y in zip(got, whole):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("key", ["tiny", "llama"])
def test_port_ranks_checkpoint_restores_in_jax(rank_results, key):
    """What the (1, 2) ranks restored from the JAX package's checkpoint,
    saved again from the ranks (whole leaves, rank 0 writing), restores
    in the JAX package with every leaf's bits equal to its own."""
    import pickle

    from repro.checkpoint import CheckpointManager as JManager
    from repro.configs import get_smoke as jget_smoke
    from repro.optim.adamw import AdamWConfig as JAdamWConfig
    from repro.optim.adamw import adamw_init as jadamw_init

    d = rank_results["dirs"][2]
    with open(d / "jax_seq_ref.pkl", "rb") as f:
        ref = pickle.load(f)["ckpt"][key]
    cfg = (jget_config("tiny-agent") if key == "tiny"
           else jget_smoke("llama3-405b"))
    like = jax.eval_shape(lambda k: (lambda p: (p, jadamw_init(
        p, JAdamWConfig(int8_moments=True))))(jmodels.init(cfg, k)),
        jax.random.key(0))
    tree, meta = JManager(d / "port_ckpt" / key).restore(ref["step"], like)
    got = jax.tree.leaves(tree)
    assert meta["step"] == ref["step"] and len(got) == len(ref["whole"])
    for i, (x, want) in enumerate(zip(got, ref["whole"])):
        x = np.asarray(x)
        assert x.shape == want.shape, i
        assert np.array_equal(x.view(f"u{x.dtype.itemsize}"), want), i


@pytest.mark.parametrize("n,cut", [(200, 100), (128, 64), (384, 96)])
def test_global_blocks_give_the_whole_leafs_int8_numbers(n, cut):
    """A leaf's last axis cut into shards off the 128-element blocks: each
    shard's quantize, its block maxima reduced over the shards, gives the
    unsharded ``_quantize``'s q and scales exactly; dequantize likewise."""
    from repro_torch.optim.adamw import _dequantize, _quantize, global_blocks

    x = torch.from_numpy(np.random.default_rng(n).normal(
        size=(3, n)).astype(np.float32))
    whole = _quantize(x)
    parts = [x[:, i:i + cut] for i in range(0, n, cut)]
    nb = -(-n // 128)

    def local_amax(i, part):
        wide = part.new_zeros(3, nb * 128)
        wide[:, i * cut:i * cut + cut] = part.abs()
        return wide.reshape(3, nb, 128).amax(-1)
    amax = torch.stack([local_amax(i, p) for i, p in enumerate(parts)])
    got = [global_blocks(i * cut, n, lambda t: amax.max(0).values)
           for i in range(len(parts))]
    q8s = [g[0](p) for g, p in zip(got, parts)]
    assert torch.equal(torch.cat([q.q for q in q8s], -1), whole.q)
    for q in q8s:
        assert torch.equal(q.scale, whole.scale)
    deq = torch.cat([g[1](q, p.shape) for g, q, p in zip(got, q8s, parts)],
                    -1)
    assert torch.equal(deq, _dequantize(whole, x.shape))
