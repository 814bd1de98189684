"""Sequence parallelism over ``model`` in the port's sharded train and
prefill steps (the reference's ``_constrain_act``), and decode over a
cross attention K/V cut along its encoder axis.

In CPU ``gloo`` ranks (``_torch_ranks``: one spawn each of 1, 2 and 4
ranks for the file):

* the sequence-parallel autograd collectives (``split_to``,
  ``scatter_from``, ``gather_from`` along S, ``own_rows``) in f64
  against their definitions, and ``seq_parallel``'s rule;
* the smokes of tiny-agent, arctic (MoE), hymba (and its full-width
  layout of whole query heads), xlstm, qwen2-vl and seamless on (1, 2),
  (2, 2) and (1, 4), S 16 (the model axis divides it; seamless's 10
  frames only on a model axis of 2): one train step's loss and every
  gradient leaf, the norm scales' apart, and the prefill step's logits
  and greedy tokens against one device, within the bands of
  ``tests/test_torch_launch.py``;
* what remat saves at the layer boundaries: each layer's input is
  (B_local, S / m, d) where the rule cuts the stack's S, and its bytes
  exactly 1/m of the step's with ``act_sharding`` off;
* the hand-off: at S 37 (no model axis of 2 or 4 divides it, nor the
  9 frames of an encoder) the steps with ``act_sharding`` on equal
  those with it off bit for bit, and a world of one equals the mesh-less
  steps bit for bit;
* against the JAX package's own sharded steps (``_jax_seq_ref.py``, a
  subprocess with four CPU devices): tiny-agent's and the hymba smoke's
  loss, gradients and prefill logits on (1, 2) and (1, 4) within 1e-4;
* decode of the seamless smoke on (2, 1) under a ``long``-named shape, a
  batch of one, its cross K/V cut along the encoder axis (5 of 10 frames
  a rank), against one device and the JAX package's ``make_serve_step``.

And the dry run's ``acts``: its ratio with ``act_sharding`` off to on is
the model axis's size in every train cell.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_ranks as ranks  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_smoke  # noqa: E402
from repro_torch.configs.base import SHAPES, shape_applicable  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as specs_mod  # noqa: E402
from repro_torch.launch.mesh import ShapeMesh, make_production_mesh  # noqa
from repro_torch.launch.serve import check_serve  # noqa: E402

TOL = 1e-4
# each family's band (``tests/test_torch_launch.py``): 1e-4 but for
# hymba and seamless, whose bands come from float64
BAND = {"hymba": 2e-3, "hymba-whole": 2e-3, "seamless": 1e-3}
SP = [f"sp-{c}" for c in ranks.SP_CONFIGS]
HANDOFF = [f"handoff-{c}" for c in ranks.SP_CONFIGS]
JAX_SP = ["jax-sp-tiny-2", "jax-sp-hymba-2", "jax-sp-tiny-4",
          "jax-sp-hymba-4"]
PLAN1 = [((1, 1), ["world1-tiny"])]
PLAN2 = [((1, 2), ["sp-collectives"] + SP + HANDOFF
          + ["jax-sp-tiny-2", "jax-sp-hymba-2"]),
         ((2, 1), ["serve-seamless-long", "jax-ref-seamless-long"])]
PLAN4 = [((2, 2), SP + HANDOFF),
         ((1, 4), ["sp-collectives"] + SP + HANDOFF
          + ["jax-sp-tiny-4", "jax-sp-hymba-4"])]
CASES = [(shape, n, w) for w, plan in ((1, PLAN1), (2, PLAN2), (4, PLAN4))
         for shape, names in plan for n in names]


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    dirs = {w: tmp_path_factory.mktemp(f"sp{w}") for w in (1, 2, 4)}
    ref = dirs[2] / "jax_seq_ref.pkl"
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(root / "src"))
    # the JAX package's sharded steps, in a process whose JAX sees four
    # CPU devices; a failure shows in the checks that read them
    subprocess.run([sys.executable, str(root / "tests" / "_jax_seq_ref.py"),
                    str(ref), "seamless-long",
                    *(c[len("jax-"):] for c in JAX_SP)],
                   env=env, timeout=400, check=False)
    if ref.exists():
        shutil.copy(ref, dirs[4] / ref.name)
    return {1: ranks.spawn(1, PLAN1, dirs[1]),
            2: ranks.spawn(2, PLAN2, dirs[2]),
            4: ranks.spawn(4, PLAN4, dirs[4])}


def _results(rank_results, shape, name, world):
    key = f"{tuple(shape)}:{name}"
    out = []
    for r, res in enumerate(rank_results[world]):
        got = res[key]
        assert "error" not in got, f"rank {r}: {got.get('error')}"
        out.append(got)
    return out


def _cut(s: int, m: int) -> bool:
    """The reference's rule at the stack's S, ``act_sharding`` on."""
    return m > 1 and s > 1 and s % m == 0


@pytest.mark.parametrize("shape,name,world", CASES,
                         ids=[f"{'x'.join(map(str, s))}-{n}"
                              for s, n, _ in CASES])
def test_sequence_parallel_step(rank_results, shape, name, world):
    m = shape[-1]
    for got in _results(rank_results, shape, name, world):
        if name == "sp-collectives":
            assert max(got["errs"].values()) <= 1e-12, got
            assert got["m"] == m
            # on: S > 1 and a multiple of m; off: never
            assert got["rule"] == {str(s): [_cut(s, m), False]
                                   for s in (1, 2, 15, 16, 18)}, got
        elif name.startswith("sp-"):
            band = BAND.get(name[len("sp-"):], TOL)
            assert got["loss"] <= band and got["grad_rel"] <= band, got
            # the RMSNorm scales: replicated weights applied to the rows
            assert got["scales"] > 0 and got["scale_rel"] <= band, got
            assert got["tokens_equal"] and got["logits"] <= band, got
        elif name.startswith("handoff-"):
            assert got["equal"], got
            assert got["saved"] == got["saved_off"]
            assert all(sh[1] in (9, 37) for sh in got["saved"]), got
        elif name == "world1-tiny":
            assert got["equal"], got
        elif name.startswith("jax-sp-"):
            # the JAX package's own sharded steps, act_sharding on
            assert got["loss"] <= TOL and got["logits"] <= TOL, got
            assert got["grads"] <= TOL * max(got["grad_max"], 1.0), got
            assert got["tokens_equal"], got
            assert all(sh[1] == 16 // m for sh in got["saved"]), got
        elif name == "serve-seamless-long":
            # the ring and the cross K/V cut over ``data``, 5 of 10 frames
            assert got["tokens_equal"] and got["logits"] <= TOL, got
            assert got["slots"] * 2 == got["ring"], got
            assert got["cross_len"] * 2 == got["enc_len"] == 10, got
        elif name == "jax-ref-seamless-long":
            assert got["steps"] == 6 and got["logits"] <= TOL, got
            assert got["slots"] * 2 == got["ring"], got
        else:
            raise KeyError(name)


@pytest.mark.parametrize("shape,name,world",
                         [c for c in CASES if c[1] in SP],
                         ids=[f"{'x'.join(map(str, s))}-{n}"
                              for s, n, _ in CASES if n in SP])
def test_remat_keeps_a_ranks_rows_at_layer_boundaries(rank_results, shape,
                                                      name, world):
    """Each layer's input saved for the backward is (B_local, S / m, d)
    where the rule cuts its stack's S (the decoder's 16 positions; the
    encoder's 10 frames on a model axis of 2) and its bytes are exactly
    1/m of the same layer's with ``act_sharding`` off; elsewhere they are
    the same."""
    m = shape[-1]
    cfg = ranks.CONFIGS[name[len("sp-"):]]()
    for got in _results(rank_results, shape, name, world):
        assert len(got["saved"]) == len(got["whole"]) \
            == cfg.n_layers + cfg.enc_layers
        cuts = 0
        for (b, s, d, n), (b0, s0, d0, n0) in zip(got["saved"],
                                                  got["whole"]):
            assert (b, d) == (b0, d0) == (got["b_local"], cfg.d_model)
            assert n0 == b0 * s0 * d0 * 4                  # f32
            if _cut(s0, m):
                assert s * m == s0 and n * m == n0, got
                cuts += 1
            else:
                assert (s, n) == (s0, n0), got
        assert cuts >= cfg.n_layers


def test_dryrun_counts_what_remat_keeps():
    """``acts`` of every train cell on both production meshes: with
    ``act_sharding`` off it is the model axis's size times the figure
    with it on (every stack's S divides 16), layers x B_local x S x d x
    itemsize over the microbatches, B_local a microbatch's padded shard
    (at least one row); the cells' records carry it."""
    n = 0
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        sizes = shd.mesh_axis_sizes(mesh)
        for arch in ARCHS:
            cfg = get_config(arch)
            for shape in SHAPES.values():
                if shape.kind != "train" or not shape_applicable(cfg,
                                                                 shape)[0]:
                    continue
                k = dryrun.default_plan(cfg, shape).microbatch
                on = dryrun.activation_bytes(cfg, shape, mesh, k)
                off = dryrun.activation_bytes(
                    cfg.replace(act_sharding=False), shape, mesh, k)
                assert off == sizes["model"] * on, (arch, shape.name)
                # a microbatch's padded shard: one row of 16 over the
                # multi-pod mesh's 32 batch ranks, where a floor gave 0
                b = -(-shape.global_batch // (k * shd.axes_size(
                    shd.batch_pspec(mesh, batch_size=shape.global_batch)[0],
                    sizes)))
                enc = specs_mod.enc_len(cfg, shape)
                want = (cfg.n_layers * shape.seq_len + cfg.enc_layers * enc
                        ) * b * cfg.d_model * (2 if cfg.dtype == "bfloat16"
                                               else 4)
                assert off == want, (arch, shape.name)
                rec = dryrun.cell_record(arch, shape.name, mesh, "m")
                assert rec["bytes_per_device"]["acts"] == on
                n += 1
    assert n == 2 * 10


def test_check_serve_takes_a_cross_kv_cut_along_its_encoder_axis():
    """A ``long_*`` decode shape's cache spec cuts an encoder-decoder's
    cross K/V along its encoder axis over ``data``; ``check_serve`` no
    longer refuses it (the kernels on too)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.attention import CrossKV

    for cfg in (get_smoke("seamless-m4t-large-v2"),
                get_config("seamless-m4t-large-v2")):
        mesh = ShapeMesh(("data", "model"), (2, 1))
        shape = ShapeConfig("long_d", 40, 1, "decode")
        cache = specs_mod.input_pspecs(cfg, shape, mesh)["cache"]
        cross = cache["segments"][0]["e0"]["cross"]
        assert isinstance(cross, CrossKV) and cross.k[-3] == "data"
        check_serve(cfg, mesh, cache)
        check_serve(cfg.replace(use_pallas=True), mesh, cache)
