"""The dry run's step pass (``launch.dryrun.lower_cell``, the port of the
reference's): each cell's real step on meta tensors as one rank of a
fake world (``launch.fake_world``), and the kernels' meta branches.

* the fake world leaves no process group and no mesh context behind;
* the collectives the fake pass records for a rank equal, call by call
  (kind, bytes, group size), those real CPU ``gloo`` ranks make in the
  same steps (``_torch_ranks``: tiny-agent's train, prefill and decode
  steps and the arctic smoke's EP train step on (1, 2), (2, 1), (2, 2));
* meta tensors do not change the program: a (1, 1) train step's FLOPs,
  bytes and ``MemTracker`` peak are the same on real CPU tensors;
* FLOPs split exactly over the mesh (hymba's smoke is the exception:
  its recurrences run whole on every model rank);
* ``_lin`` over two depths gives a third depth's direct count;
* each kernel entry point on meta returns its plain version's shapes and
  dtypes, counts one call with ``kernels.work``'s figures, leaves the
  wrapper's launch count alone and never runs the plain version;
* agent-7b's kernel calls a train step at full width equal the launches
  ``chip_smoke.py`` counts on the card;
* ``CostModel.from_dryrun`` reads the port's own record;
* every family's cell at one unit of ``_scaled_cfg`` on the single-pod
  mesh (256 fake ranks) runs with no error and every reference key.
"""
import importlib
import json
import math
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import torch.distributed as dist  # noqa: E402

import _torch_ranks as ranks  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.distributed import parallel  # noqa: E402
from repro_torch.kernels import work  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.fake_world import fake_world  # noqa: E402
from repro_torch.launch.mesh import ShapeMesh, make_mesh  # noqa: E402
from repro_torch.launch.train import TrainPlan, make_train_step  # noqa: E402
from repro_torch.sim.costmodel import CostModel  # noqa: E402

# the kernel modules (the package exports their wrappers by the same names)
ac_mod, dec_mod, fa_mod, gm_mod, pg_mod, pf_mod, scan_mod = (
    importlib.import_module(f"repro_torch.kernels.{m}") for m in (
        "attention_combine", "decode_attention", "flash_attention",
        "grouped_matmul", "paged_decode_attention", "paged_flash_attention",
        "ssm_scan"))

MESHES = [(1, 2), (2, 1), (2, 2)]
AXES = ("data", "model")


def _sizes(shape) -> dict:
    return dict(zip(AXES, shape))


# ---------------------------------------------------------------------------
# (a) the fake world
# ---------------------------------------------------------------------------


def test_fake_world_leaves_nothing_behind():
    cfg = ranks.CONFIGS["tiny"]()
    res = dryrun.rank_pass(cfg, ranks.COLL_SHAPES["train"], _sizes((2, 2)),
                           3)
    assert res["collectives"]["count"] > 0
    assert not dist.is_initialized() and parallel._ACTIVE == []
    # a step that raises inside the world tears it down too (a batch of 3
    # over the two data ranks runs, in padded shards; 2 microbatches do
    # not split it)
    with pytest.raises(ValueError, match="batch"):
        with fake_world((2, 2), AXES, 1) as ctx:
            make_train_step(cfg, ctx, TrainPlan(microbatch=2),
                            shape=ShapeConfig("t", 16, 3, "train"))
    assert not dist.is_initialized() and parallel._ACTIVE == []
    # what a process with no group expects still holds
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh((1, 2), AXES, device_type="cpu")
    with pytest.raises(RuntimeError, match="DeviceMesh"):
        make_train_step(cfg, ShapeMesh(AXES, (1, 2)), device="cpu")


# ---------------------------------------------------------------------------
# (b) the fake pass against real gloo ranks
# ---------------------------------------------------------------------------

COLL = [("tiny", "train"), ("tiny", "prefill"), ("tiny", "decode"),
        ("arctic", "train")]


@pytest.fixture(scope="module")
def gloo_collectives(tmp_path_factory):
    names = ["coll-tiny", "coll-arctic"]
    two = ranks.spawn(2, [((1, 2), names), ((2, 1), names)],
                      tmp_path_factory.mktemp("coll2"))
    four = ranks.spawn(4, [((2, 2), names)],
                       tmp_path_factory.mktemp("coll4"))
    return {2: two, 4: four}


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name,kind", COLL, ids=lambda x: x)
def test_fake_pass_collectives_equal_gloo_ranks(gloo_collectives, shape,
                                                name, kind):
    world = math.prod(shape)
    cfg = ranks.CONFIGS[name]()
    for rank, got in enumerate(gloo_collectives[world]):
        rec = got[f"{shape}:coll-{name}"]
        assert "error" not in rec, rec.get("error")
        fake = dryrun.rank_pass(cfg, ranks.COLL_SHAPES[kind], _sizes(shape),
                                rank, memory=False, costs=False)
        assert [list(c) for c in fake["calls"]] == rec[kind], (rank, kind)
        assert rec[kind], "the step made no collective"


# ---------------------------------------------------------------------------
# (c) meta does not change the program
# ---------------------------------------------------------------------------


def test_meta_pass_equals_cpu_pass():
    cfg = get_config("tiny-agent")
    shape = ShapeConfig("t", 32, 4, "train")
    for counters in ({"memory": False}, {"costs": False}):
        meta = dryrun.step_pass(cfg, shape, None, device="meta", **counters)
        cpu = dryrun.step_pass(cfg, shape, None, device="cpu", **counters)
        for key in ("flops", "bytes_accessed", "memory"):
            assert meta.get(key) == cpu.get(key), key
    assert meta["memory"]["peak_bytes"] > meta["memory"]["argument_bytes"]


# ---------------------------------------------------------------------------
# (d) FLOPs split exactly
# ---------------------------------------------------------------------------


def _matmul_flops(cfg, shape, mesh) -> float:
    return dryrun.rank_pass(cfg, shape, _sizes(mesh), 0,
                            memory=False)["flops"]


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1)], ids=["1x2", "2x1"])
def test_flops_split_exactly_over_the_mesh(mesh):
    cfg = ranks.CONFIGS["tiny"]()
    shape = ranks.COLL_SHAPES["train"]
    assert 2 * _matmul_flops(cfg, shape, mesh) == \
        _matmul_flops(cfg, shape, (1, 1))


def test_hymba_recurrence_runs_whole_on_every_model_rank():
    cfg = ranks.CONFIGS["hymba"]()
    shape = ranks.COLL_SHAPES["train"]
    assert 2 * _matmul_flops(cfg, shape, (1, 2)) > \
        _matmul_flops(cfg, shape, (1, 1))


# ---------------------------------------------------------------------------
# (e) extrapolation
# ---------------------------------------------------------------------------


def test_two_depths_extrapolate_to_a_direct_count():
    base = get_config("tiny-agent").replace(n_layers=4)
    shape = ShapeConfig("t", 32, 4, "train")
    costs = {u: dryrun._costs_of(dryrun.rank_pass(
        dryrun._scaled_cfg(base, u), shape, _sizes((2, 2)), 0,
        memory=False)) for u in (1, 2, 4)}
    got = dryrun._lin(costs[1], costs[2], 1, 2, 4)
    assert got["flops"] == pytest.approx(costs[4]["flops"], rel=1e-12)
    assert got["bytes_accessed"] == pytest.approx(
        costs[4]["bytes_accessed"], rel=1e-12)
    for k, v in costs[4]["collectives"].items():
        assert got["collectives"][k] == pytest.approx(v, rel=1e-12), k
    assert costs[4]["collectives"]["count"] > costs[1]["collectives"]["count"]


# ---------------------------------------------------------------------------
# (f) the kernels' meta branches
# ---------------------------------------------------------------------------

PLAINS = [(fa_mod, "flash_attention_plain"),
          (fa_mod, "flash_attention_lse_plain"),
          (fa_mod, "flash_attention_backward_plain"),
          (dec_mod, "decode_attention_plain"),
          (pg_mod, "paged_decode_attention_plain"),
          (pf_mod, "paged_flash_attention_plain"),
          (scan_mod, "ssm_scan_plain"),
          (scan_mod, "ssm_scan_backward_plain"),
          (gm_mod, "grouped_matmul_plain"),
          (gm_mod, "grouped_matmul_backward_plain"),
          (ac_mod, "attention_combine_plain")]
WRAPPERS = {"flash_attention": fa_mod.flash_attention,
            "flash_attention_backward": fa_mod.flash_attention_backward,
            "decode_attention": dec_mod.decode_attention,
            "paged_decode_attention": pg_mod.paged_decode_attention,
            "paged_flash_attention": pf_mod.paged_flash_attention,
            "ssm_scan": scan_mod.ssm_scan,
            "ssm_scan_backward": scan_mod.ssm_scan_backward,
            "grouped_matmul": gm_mod.grouped_matmul,
            "grouped_matmul_backward": gm_mod.grouped_matmul_backward,
            "attention_combine": ac_mod.attention_combine}


def _rand(gen, shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen).to(dtype)


def _flash_args(gen, dtype):
    return [_rand(gen, (2, 24, 8, 40), dtype),
            _rand(gen, (2, 24, 2, 40), dtype),
            _rand(gen, (2, 24, 2, 40), dtype)]


def _ring_args(gen, dtype):
    kpos = torch.arange(40, dtype=torch.int32).repeat(2, 1)
    return [_rand(gen, (2, 1, 8, 32), dtype),
            _rand(gen, (2, 40, 2, 32), dtype),
            _rand(gen, (2, 40, 2, 32), dtype), kpos,
            torch.tensor([39, 20], dtype=torch.int32)]


def _paged_args(gen, dtype):
    tables = torch.tensor([[0, 1, 2], [3, 4, -1]], dtype=torch.int32)
    return [_rand(gen, (2, 1, 8, 32), dtype),
            _rand(gen, (6, 16, 2, 32), dtype),
            _rand(gen, (6, 16, 2, 32), dtype), tables,
            torch.tensor([40, 20], dtype=torch.int32)]


def _paged_flash_args(gen, dtype):
    tables = torch.tensor([[0, 1, 2], [3, 4, -1]], dtype=torch.int32)
    q_pos = torch.tensor([list(range(30, 40)), [20, 21, 22] + [-1] * 7],
                         dtype=torch.int32)
    return [_rand(gen, (2, 10, 8, 32), dtype),
            _rand(gen, (6, 16, 2, 32), dtype),
            _rand(gen, (6, 16, 2, 32), dtype), tables, q_pos]


def _scan_args(gen, dtype):
    return [_rand(gen, (2, 20, 3, 8), dtype), _rand(gen, (2, 20, 3, 8), dtype),
            _rand(gen, (2, 20, 3, 6), dtype),
            -torch.rand((2, 20, 3), generator=gen),
            _rand(gen, (2, 3, 8, 6))]


def _gm_args(gen, dtype):
    return [_rand(gen, (4, 6, 16), dtype), _rand(gen, (4, 16, 24), dtype),
            torch.tensor([6, 0, 3, 6], dtype=torch.int32)]


def _meta(xs):
    return [x.to("meta") for x in xs]


def _call(name, xs, dtype, gen):
    """(the call on ``xs``, the plain version's on them, the expected
    work): each a function of the inputs."""
    if name == "flash_attention":
        return (lambda a: fa_mod.flash_attention(*a, window=10),
                lambda a: fa_mod.flash_attention_plain(*a, window=10),
                lambda a: work.flash(a[0], a[1], True, 10))
    if name == "flash_attention_forward":
        return (lambda a: fa_mod.flash_attention_forward(*a, causal=False),
                lambda a: (fa_mod.flash_attention_plain(*a, causal=False),
                           fa_mod.flash_attention_lse_plain(
                               a[0], a[1], causal=False)),
                lambda a: work.flash(a[0], a[1], False, -1))
    if name == "flash_attention_backward":
        dout = _rand(gen, xs[0].shape, dtype)
        lse = torch.zeros((2, 8, 24))
        return (lambda a: fa_mod.flash_attention_backward(
                    *a, a[0] * 0, lse.to(a[0].device), dout.to(a[0].device)),
                lambda a: fa_mod.flash_attention_backward_plain(*a, dout),
                lambda a: work.flash_backward(a[0], a[1], True, -1))
    if name == "decode_attention":
        return (lambda a: dec_mod.decode_attention(*a, with_lse=True),
                lambda a: dec_mod.decode_attention_plain(*a, with_lse=True),
                lambda a: work.ring_decode(a[0], a[1], a[3], a[4], 2 * 40))
    if name == "paged_decode_attention":
        return (lambda a: pg_mod.paged_decode_attention(*a, window=24),
                lambda a: pg_mod.paged_decode_attention_plain(*a, window=24),
                lambda a: work.paged_decode(a[0], a[1], a[3], a[4], 2 * 24))
    if name == "paged_flash_attention":
        # meta: every row at full context within the window, every page
        return (lambda a: pf_mod.paged_flash_attention(*a, window=24),
                lambda a: pf_mod.paged_flash_attention_plain(*a, window=24),
                lambda a: work.paged_flash(a[0], a[1], a[3], a[4],
                                           2 * 10 * 24, 2 * 48))
    if name == "ssm_scan":
        return (lambda a: scan_mod.ssm_scan(*a, chunk=8),
                lambda a: scan_mod.ssm_scan_plain(*a, chunk=8),
                lambda a: work.scan(*a, 8))
    if name == "ssm_scan_backward":
        dy = _rand(gen, xs[2].shape, dtype)
        return (lambda a: scan_mod.ssm_scan_backward(*a, dy.to(a[0].device),
                                                     chunk=8),
                lambda a: scan_mod.ssm_scan_backward_plain(*a, dy, chunk=8),
                lambda a: work.scan_backward(
                    a[0], a[1], a[2], torch.empty((2, 3, 3, 8, 6))))
    if name == "grouped_matmul":
        return (lambda a: gm_mod.grouped_matmul(*a),
                lambda a: gm_mod.grouped_matmul_plain(*a),
                lambda a: work.grouped_matmul(*a, 4 * 6, 4))
    if name == "grouped_matmul_backward":
        dout = _rand(gen, (4, 6, 24), dtype)
        return (lambda a: gm_mod.grouped_matmul_backward(
                    *a, dout.to(a[0].device)),
                lambda a: gm_mod.grouped_matmul_backward_plain(*a, dout),
                lambda a: work.grouped_matmul_backward(*a, 4 * 6, 4))
    assert name == "attention_combine"
    return (lambda a: ac_mod.attention_combine(*a),
            lambda a: ac_mod.attention_combine_plain(*a),
            lambda a: work.combine(*a))


ARGS = {"flash_attention": _flash_args, "flash_attention_forward": _flash_args,
        "flash_attention_backward": _flash_args,
        "decode_attention": _ring_args, "paged_decode_attention": _paged_args,
        "paged_flash_attention": _paged_flash_args,
        "ssm_scan": _scan_args, "ssm_scan_backward": _scan_args,
        "grouped_matmul": _gm_args, "grouped_matmul_backward": _gm_args,
        "attention_combine": lambda gen, dtype: [
            _rand(gen, (3, 2, 8, 32), dtype), _rand(gen, (3, 2, 8))]}
# the counter each entry point's calls go to
COUNTED = {"flash_attention_forward": "flash_attention"}


def _shapes(out):
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [(tuple(t.shape), t.dtype) for t in outs]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(ARGS))
def test_kernel_meta_branch(name, dtype, monkeypatch):
    gen = torch.Generator().manual_seed(0)
    xs = ARGS[name](gen, dtype)
    call, plain, want = _call(name, xs, dtype, gen)
    ref = _shapes(plain(xs))
    calls = []
    for mod, k in PLAINS:
        monkeypatch.setattr(mod, k, lambda *a, _k=k, **kw: calls.append(_k))
    before = {k: w.launches for k, w in WRAPPERS.items()}
    with work.count_calls() as counted:
        got = call(_meta(xs))
    assert calls == []
    assert {k: w.launches for k, w in WRAPPERS.items()} == before
    assert _shapes(got) == ref
    assert all(t.device.type == "meta" for t in
               (got if isinstance(got, (tuple, list)) else (got,)))
    want_calls = {COUNTED.get(name, name): want(xs)}
    if name == "ssm_scan_backward":        # the forward for its states
        want_calls["ssm_scan"] = work.scan(*xs, 8)
    assert counted == {k: {"calls": 1, "ops": w.ops, "bytes": w.nbytes}
                       for k, w in want_calls.items()}


@pytest.mark.parametrize("name", ["flash_attention", "ssm_scan",
                                  "grouped_matmul"])
def test_kernel_meta_branch_under_grad(name, monkeypatch):
    """Under autograd the meta branch is the kernels' autograd Function:
    the forward saves what the kernel path saves and the backward counts
    one backward call, with the plain autograd's gradient shapes."""
    gen = torch.Generator().manual_seed(1)
    xs = ARGS[name](gen, torch.float32)
    call, _, _ = _call(name, xs, torch.float32, gen)
    leaves = [x.requires_grad_(True) if x.is_floating_point() else x
              for x in xs]
    out = call(leaves)
    outs = out if isinstance(out, tuple) else (out,)
    ref = torch.autograd.grad(outs[0].sum(), [x for x in leaves
                                              if x.requires_grad])
    for mod, fn in PLAINS:
        monkeypatch.setattr(mod, fn, lambda *a, **k: pytest.fail("plain"))
    metas = [x.detach().to("meta").requires_grad_(x.requires_grad)
             for x in xs]
    with work.count_calls() as counted:
        out = call(metas)
        outs = out if isinstance(out, tuple) else (out,)
        got = torch.autograd.grad(outs[0].sum(), [x for x in metas
                                                  if x.requires_grad])
    assert _shapes(got) == _shapes(ref)
    assert {k: v["calls"] for k, v in counted.items()} == {
        name: 1, f"{name}_backward": 1}


# ---------------------------------------------------------------------------
# (g) agent-7b's calls equal the card's launches
# ---------------------------------------------------------------------------


def test_agent7b_kernel_calls_equal_the_cards_launches():
    """chip_smoke.py's train phase launches 2 flash forwards (remat) and 1
    backward a layer a step; the meta pass of agent-7b at full width, 2
    layers, B 2 x S 4096, kernels on, counts the same."""
    cfg = get_config("agent-7b").replace(n_layers=2, use_pallas=True)
    res = dryrun.step_pass(cfg, ShapeConfig("t", 4096, 2, "train"), None,
                           TrainPlan(int8_moments=True), memory=False,
                           costs=False)
    assert {k: v["calls"] for k, v in res["kernels"].items()} == {
        "flash_attention": 2 * 2, "flash_attention_backward": 2}


# ---------------------------------------------------------------------------
# (h) the cost model's static calibration
# ---------------------------------------------------------------------------


def test_costmodel_reads_the_ports_record(tmp_path):
    cfg = get_config("tiny-agent")
    rec = dryrun.lower_cell("tiny-agent", "t", ShapeMesh(AXES, (1, 1)),
                            "one", shape=ShapeConfig("t", 32, 4, "train"))
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(rec))
    cm = CostModel.from_dryrun(cfg, 1, path)
    assert cm.flops_scale == rec["flops"] / rec["model_flops"] > 1


# ---------------------------------------------------------------------------
# (i) every family on the single-pod mesh
# ---------------------------------------------------------------------------

# one cell a family at one unit of _scaled_cfg: danube trains, the rest
# serve; xlstm prefills 256 tokens, since its sLSTM runs a host loop over
# every token (ROADMAP B3), minutes at 32k even on meta tensors
FAMILY_CELLS = {"h2o-danube-3-4b": "train_4k", "llama3-405b": "decode_32k",
                "command-r-plus-104b": "prefill_32k",
                "gemma3-27b": "long_500k", "arctic-480b": "decode_32k",
                "kimi-k2-1t-a32b": "decode_32k", "qwen2-vl-2b": "prefill_32k",
                "hymba-1.5b": "decode_32k",
                "xlstm-350m": ShapeConfig("prefill_256", 256, 32, "prefill"),
                "seamless-m4t-large-v2": "prefill_32k"}
# the reference's record keys (src/repro/launch/dryrun.py lower_cell)
REF_KEYS = {"arch", "shape", "mesh", "chips", "model_flops", "memory",
            "flops", "bytes_accessed", "collectives", "cost_mode"}
REF_COLLECTIVES = {"all-gather", "all-reduce", "reduce-scatter",
                   "all-to-all", "collective-permute", "count", "total"}


def test_family_cells_cover_every_arch():
    assert set(FAMILY_CELLS) == set(ARCHS)
    kinds = {(c if isinstance(c, ShapeConfig) else SHAPES[c]).kind
             for c in FAMILY_CELLS.values()}
    assert {"train", "prefill", "decode"} <= kinds


@pytest.mark.parametrize("arch", list(FAMILY_CELLS))
def test_every_family_runs_on_the_single_pod_mesh(arch):
    cell = FAMILY_CELLS[arch]
    shape = cell if isinstance(cell, ShapeConfig) else SHAPES[cell]
    rec = dryrun.lower_cell(arch, shape.name, ShapeMesh(AXES, (16, 16)),
                            "single",
                            cfg=dryrun._scaled_cfg(get_config(arch), 1),
                            shape=shape)
    assert "error" not in rec and "skipped" not in rec
    assert REF_KEYS <= set(rec)
    assert set(rec["collectives"]) == REF_COLLECTIVES
    assert set(rec["memory"]) == {"argument_bytes", "temp_bytes",
                                  "peak_bytes"}
    assert set(rec["ranks"]) == {"0", "255"}
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert rec["collectives"]["count"] > 0
    for r in rec["ranks"].values():
        assert r["memory"]["peak_bytes"] <= rec["memory"]["peak_bytes"]
        assert r["flops"] <= rec["flops"]


# ---------------------------------------------------------------------------
# (j) a batch of no rows, and the multi-pod train cells' empty ranks
# ---------------------------------------------------------------------------


def _empty_args(name):
    """Inputs of a kernel entry point at B 0 (``grouped_matmul``'s at C 0,
    an expert's rows of a rank that holds no token), with the extra
    arguments the call takes."""
    gen = torch.Generator().manual_seed(2)
    if name.startswith("flash"):
        xs = [_rand(gen, (0, 24, 8, 40)), _rand(gen, (0, 24, 2, 40)),
              _rand(gen, (0, 24, 2, 40))]
        return xs, [xs[0] * 0, torch.zeros((0, 8, 24)), xs[0] + 1]
    if name.startswith("ssm"):
        xs = [_rand(gen, (0, 20, 3, 8)), _rand(gen, (0, 20, 3, 8)),
              _rand(gen, (0, 20, 3, 6)), torch.zeros((0, 20, 3)),
              torch.zeros((0, 3, 8, 6))]
        return xs, [torch.zeros((0, 20, 3, 6))]
    xs = [_rand(gen, (4, 0, 16)), _rand(gen, (4, 16, 24)),
          torch.zeros(4, dtype=torch.int32)]
    return xs, [torch.zeros((4, 0, 24))]


EMPTY = {
    "flash_attention": (lambda a, e: fa_mod.flash_attention(*a),
                        lambda a, e: fa_mod.flash_attention_plain(*a)),
    "flash_attention_forward": (
        lambda a, e: fa_mod.flash_attention_forward(*a),
        lambda a, e: (fa_mod.flash_attention_plain(*a),
                      fa_mod.flash_attention_lse_plain(a[0], a[1]))),
    "flash_attention_backward": (
        lambda a, e: fa_mod.flash_attention_backward(*a, *e),
        lambda a, e: fa_mod.flash_attention_backward_plain(*a, e[2])),
    "ssm_scan": (lambda a, e: scan_mod.ssm_scan(*a, chunk=8),
                 lambda a, e: scan_mod.ssm_scan_plain(*a, chunk=8)),
    "ssm_scan_backward": (
        lambda a, e: scan_mod.ssm_scan_backward(*a, *e, chunk=8),
        lambda a, e: scan_mod.ssm_scan_backward_plain(*a, *e, chunk=8)),
    "grouped_matmul": (lambda a, e: gm_mod.grouped_matmul(*a),
                       lambda a, e: gm_mod.grouped_matmul_plain(*a)),
    "grouped_matmul_backward": (
        lambda a, e: gm_mod.grouped_matmul_backward(*a, *e),
        lambda a, e: gm_mod.grouped_matmul_backward_plain(*a, *e))}


@pytest.mark.parametrize("name", list(EMPTY))
def test_kernel_on_no_rows_counts_nothing(name):
    """A rank that holds no row of a batch split calls the kernels on B 0:
    on meta each entry point returns its plain version's shapes and
    counts no call (on the card it launches nothing: a grid of no CTAs
    is not a launch), and under autograd neither does its backward."""
    xs, extra = _empty_args(name)
    call, plain = EMPTY[name]
    ref = _shapes(plain(xs, extra))
    before = {k: w.launches for k, w in WRAPPERS.items()}
    with work.count_calls() as counted:
        got = call(_meta(xs), _meta(extra))
    assert _shapes(got) == ref and counted == {}
    assert {k: w.launches for k, w in WRAPPERS.items()} == before
    if name in ("flash_attention", "ssm_scan", "grouped_matmul"):
        metas = [x.to("meta").requires_grad_(x.is_floating_point())
                 for x in xs]
        live = [x for x in metas if x.requires_grad]
        with work.count_calls() as counted:
            out = call(metas, [])
            outs = out if isinstance(out, tuple) else (out,)
            grads = torch.autograd.grad(outs[0].sum(), live)
        assert counted == {}
        assert [g.shape for g in grads] == [x.shape for x in live]


MULTI = ShapeMesh(("pod", "data", "model"), (2, 16, 16))
# the multi-pod train cells: 16 microbatches of 16 rows over 32 batch
# ranks, ranks 16 to 31 of each microbatch (the last rank's too) empty
MULTI_TRAIN = ("llama3-405b", "command-r-plus-104b", "arctic-480b",
               "kimi-k2-1t-a32b")


@pytest.mark.parametrize("arch", MULTI_TRAIN)
def test_multi_pod_train_acts_are_one_row_not_zero(arch):
    """``activation_bytes`` of the multi-pod train cells: GSPMD's padded
    shard of a 16-row microbatch over 32 batch ranks is one row, S cut
    over the 16 model ranks: layers x 1 x S/16 x d x itemsize (the floor
    it once took gave 0)."""
    cfg = get_config(arch)
    shape = SHAPES["train_4k"]
    plan = dryrun.default_plan(cfg, shape)
    assert plan.microbatch == 16
    want = cfg.n_layers * 1 * (shape.seq_len // 16) * cfg.d_model * 2
    assert dryrun.activation_bytes(cfg, shape, MULTI, 16) == want > 0
    rec = dryrun.cell_record(arch, "train_4k", MULTI, "multi")
    assert rec["bytes_per_device"]["acts"] == want
    assert rec["port_refuses"] is None


@pytest.mark.parametrize("arch", ["llama3-405b", "kimi-k2-1t-a32b"])
def test_multi_pod_train_cell_runs_on_its_empty_ranks(arch):
    """The real 16-microbatch plan of a multi-pod train cell at one unit
    of ``_scaled_cfg`` (llama3: 1 layer; kimi: its dense layer and an
    MoE layer), kernels on: rank 0 (a row of each microbatch) and rank
    511 (none) both run the step; the empty rank makes the same
    collectives (kind and group size, in order) and counts no kernel
    call, where rank 0 counts flash's (and kimi's expert products')."""
    full = get_config(arch)
    shape = SHAPES["train_4k"]
    plan = dryrun.default_plan(full, shape)
    cfg = dryrun._scaled_cfg(full, 1).replace(use_pallas=True)
    sizes = dict(zip(MULTI.axis_names, (2, 16, 16)))
    # the collectives and kernel calls only: the memory counter would
    # triple the pass's time (the CLI's --steps records both ranks' peaks)
    got = {r: dryrun.rank_pass(cfg, shape, sizes, r, plan, memory=False,
                               costs=False)
           for r in (0, 511)}
    calls = {r: [(kind, n) for kind, _, n in res["calls"]]
             for r, res in got.items()}
    assert calls[0] and calls[0] == calls[511]
    assert got[511]["kernels"] == {}
    want = {"flash_attention", "flash_attention_backward"} | (
        {"grouped_matmul", "grouped_matmul_backward"} if full.n_experts
        else set())
    assert set(got[0]["kernels"]) == want
