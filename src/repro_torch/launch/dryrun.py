"""Meta-device dry run (port of ``repro/launch/dryrun.py``): every
(architecture x input-shape) cell on the production meshes, as shapes.

Per cell it writes ``artifacts/torch/dryrun/<arch>.<shape>.<mesh>.json``
with the train plan, ``model_flops`` (6 N D to train, 2 N D forward, N
the active parameters of an MoE), ``recurrent_correction`` (the
recurrent scans' analytic FLOPs), and the per-device bytes of the
parameters, gradients (and the microbatch accumulator), optimizer state
and batch or cache, each leaf's shard shape from the port's specs
(``param_pspecs``, ``opt_pspecs``, ``input_pspecs``), and for a train
cell the layer-boundary activations remat keeps (``acts``: layers x
B_local x S_local x d x itemsize, S cut over ``model`` where the
reference's ``_constrain_act`` cuts it), with whether their sum fits
one H100's 80 GB.  It also records whether the port's sharded steps
refuse the cell by their shape checks (``port_refuses``: none is).
These figures are analytic.

With ``--steps`` each record also gets the step pass, the port of the
reference's ``lower_cell``: the cell's real train, prefill or decode
step, built as the reference's ``_compile_cell`` builds it, runs once on
meta tensors as one rank of a fake world the size of the mesh
(``launch.fake_world``), rank 0 and the world's last rank, each figure
the larger of the two (both under ``ranks``).  Every record gets
``memory`` (``MemTracker``'s peak over the step, ``peak_bytes``; the
params, optimizer state and inputs or cache the step is given,
``argument_bytes``; the rest, ``temp_bytes``), and the single-pod cells
the cost figures, each a device: ``flops`` (``FlopCounterMode``'s count
plus each kernel call's operations), ``bytes_accessed`` (each
dispatched op's tensor inputs read once and outputs written once, views
and allocations counting nothing, plus each kernel call's bytes: the
eager step's op-by-op traffic, not XLA's count after fusion) and
``collectives`` (the result bytes of every collective by XLA's kind, as
the reference's ``collective_bytes`` sums them from HLO, here from
``parallel.record_collectives``).  The cost pass runs the step with one
microbatch and the unchunked loss, as the reference's; a config past
``_direct_ok`` runs at two reduced depths (``_scaled_cfg``) and is
extrapolated (``_lin``), as ``cost_mode`` says.  The memory pass runs
the production plan at full depth, or at the same two depths where
depth times microbatches pass ``_MEMORY_MAX_PASSES``
(``memory_mode``).  The recurrent scans run chunk by chunk in eager
PyTorch and are counted whole, so ``recurrent_correction_flops`` is not
added to ``flops`` (the reference adds it because XLA counts a loop body
once).  A step that raises is recorded as ``"error"`` with its
traceback.  Every number is counted from shapes on the CPU; none is a
measurement on a card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun            # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --steps    # + steps
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b \\
      --shape train_4k --mesh single --steps
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.distributed import parallel
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import work
from repro_torch.launch import serve
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.fake_world import fake_world
from repro_torch.launch.mesh import make_production_mesh, mesh_chips
from repro_torch.launch.train import (AdamWConfig, TrainPlan, abstract_state,
                                      check_mesh, default_plan,
                                      make_train_step, opt_pspecs)
from repro_torch.models import params as prm
from repro_torch.models.params import torch_dtype

# one H100's device memory, as the card is sold (80 GB)
H100_BYTES = 80e9


# ---------------------------------------------------------------------------
# Model-FLOPs reference
# ---------------------------------------------------------------------------


def recurrent_correction(cfg, shape, data_shards: int = 16) -> float:
    """Analytic per-device FLOPs of the recurrent chunk scans that XLA's
    cost analysis counts only once (the reference adds them to its
    compiled count): the mamba branch (hybrid) and the mLSTM / sLSTM
    blocks (ssm); the forward count x 4 for training (backward 2x, remat
    re-forward 1x)."""
    if cfg.family not in ("hybrid", "ssm") or shape.kind == "decode":
        return 0.0
    from repro_torch.models.ssm import SSM_HEAD_DIM, mamba_dims, mlstm_dims
    b, t = shape.global_batch, shape.seq_len
    c = 128
    nc = max(t // c, 1)

    def chunk_flops(h, dk, dv):
        per_chunk = b * h * (2 * c * c * (dk + dv) + 4 * c * dk * dv
                             + 2 * c * c)
        return (nc - 1) * per_chunk          # one chunk already counted

    total = 0.0
    if cfg.family == "hybrid":
        _, nh, ds = mamba_dims(cfg)
        total += cfg.n_layers * chunk_flops(nh, ds, SSM_HEAD_DIM)
    else:                                    # xlstm
        _, nh, dh = mlstm_dims(cfg)
        n_mlstm = sum(n * seg.repeat for seg in cfg.plan()
                      for sp, n in seg.pattern if sp.kind == "mlstm")
        n_slstm = sum(n * seg.repeat for seg in cfg.plan()
                      for sp, n in seg.pattern if sp.kind == "slstm")
        total += n_mlstm * chunk_flops(nh, dh, dh + 1)
        d_inner = cfg.ssm_expand * cfg.d_model
        total += n_slstm * (t - 1) * 20 * b * d_inner   # elementwise scan
    if shape.kind == "train":
        total *= 4.0
    shards = data_shards if b % data_shards == 0 else 1
    return total / shards


def model_flops(cfg, shape) -> float:
    """6 N D (train) / 2 N D (forward) with N_active for MoE."""
    from repro_torch.sim.costmodel import CostModel
    n = CostModel(cfg).n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # one decode token / seq


# ---------------------------------------------------------------------------
# Layer-scaled helpers (the reference's cost extrapolation)
# ---------------------------------------------------------------------------


def _period(cfg) -> int:
    if cfg.local_global_ratio > 0:
        return cfg.local_global_ratio + 1
    if cfg.mlstm_ratio > 0:
        return cfg.mlstm_ratio + 1
    return 1


def _scaled_cfg(cfg, units: int):
    period = _period(cfg)
    n = cfg.first_k_dense + units * period
    kw = {"n_layers": n, "scan_layers": False, "loss_chunk": 0}
    if cfg.global_layers:
        density = len(cfg.global_layers) / cfg.n_layers
        k = max(1, round(density * n))
        kw["global_layers"] = tuple(min(n - 1, int(i * n / k) + 1)
                                    for i in range(k))
    if cfg.enc_layers:
        kw["enc_layers"] = n
    return cfg.replace(**kw)


def _units_full(cfg) -> float:
    return (cfg.n_layers - cfg.first_k_dense) / _period(cfg)


def _lin(fa: dict, fb: dict, ua: float, ub: float, u: float) -> dict:
    def go(a, b):
        if isinstance(a, dict):
            return {k: go(a[k], b[k]) for k in a}
        slope = (b - a) / (ub - ua)
        return max(0.0, a + slope * (u - ua))
    out = go(fa, fb)
    out["collectives"] = {k: (int(v) if k == "count" else v)
                          for k, v in out["collectives"].items()}
    return out


_DIRECT_MAX_LAYERS = 48          # the cost pass runs the full depth when
_DIRECT_MAX_DMODEL = 4096        # depth and width are both this small
# the memory pass runs the full depth when layers x microbatches (the
# layer passes of one step) are at most this many
_MEMORY_MAX_PASSES = 64


def _direct_ok(cfg) -> bool:
    if cfg.family in ("hybrid", "ssm"):
        # the reference's rule (its recurrent branches unroll their chunk
        # scans when compiled); kept, so both dry runs count alike
        return False
    return (cfg.n_layers <= _DIRECT_MAX_LAYERS
            and cfg.d_model <= _DIRECT_MAX_DMODEL)


def _depths(cfg) -> tuple[int, int]:
    """The reference's two reduced depths, in units of ``_scaled_cfg``."""
    if _period(cfg) >= 6:
        return 1, 2                      # one and two full patterns
    if cfg.global_layers:
        return 8, 16                     # keep the global-layer density
    return 2, 4


# ---------------------------------------------------------------------------
# The step pass (the reference's lower_cell)
# ---------------------------------------------------------------------------

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def collective_bytes(calls) -> dict:
    """Sum the result bytes of recorded collectives (``(kind, bytes,
    group size)`` from ``parallel.record_collectives``) by kind, with
    their ``count`` and ``total``: the reference's dict, which it sums
    from the optimized HLO."""
    out = {k: 0 for k in _COLLECTIVES}
    out["count"] = 0
    for kind, nbytes, _ in calls:
        out[kind] += nbytes
        out["count"] += 1
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    return out


# ops that move no element: allocations and metadata (views are found by
# their schema)
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh",
               "set_", "resize_", "_local_scalar_dense", "sym_size",
               "sym_stride", "sym_numel", "sym_storage_offset"}


def _stored(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements (a broadcast dim once)."""
    return math.prod(n for n, st in zip(t.shape, t.stride()) if st) \
        * t.element_size()


def _tensor_bytes(x) -> int:
    """``_stored`` summed over the tensors in ``x`` (nested lists, tuples
    and dicts), walked without a recursive closure: a closure's
    reference cycle would hold the op's tensors until the garbage
    collector ran, and raise the peak the pass reads."""
    total, todo = 0, [x]
    while todo:
        y = todo.pop()
        if isinstance(y, torch.Tensor):
            total += _stored(y)
        elif isinstance(y, (list, tuple)):
            todo.extend(y)
        elif isinstance(y, dict):
            todo.extend(y.values())
    return total


class _Traffic(TorchDispatchMode):
    """Each dispatched op's tensor inputs read once and its tensor outputs
    written once; views, allocations, metadata ops and collectives (which
    ``record_collectives`` counts) count nothing."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func.namespace != "aten"
                or func.overloadpacket.__name__ in _NO_TRAFFIC):
            self.bytes += _tensor_bytes((args, kwargs or {}, out))
        return out


def _materialize(tree, device):
    """A meta tree's leaves as zeros on ``device`` (itself on meta)."""
    if torch.device(device).type == "meta":
        return tree
    leaves, treedef = prm.flatten(tree)
    return prm.unflatten(treedef, [torch.zeros(t.shape, dtype=t.dtype,
                                               device=device)
                                   for t in leaves])


def build_step(cfg, shape, ctx, plan=None, device="meta"):
    """``(run, args)``: the cell's step as the reference's ``_compile_cell``
    builds it, on ``ctx`` (a ``MeshContext``; None for one device on
    ``device``), and the arguments it is given, this rank's shards:
    train: ``make_train_step``'s gradients then its AdamW half on
    ``abstract_state`` cut by the step's held specs and the global batch;
    prefill: ``make_prefill_step`` on the rank's ``init_cache`` with a
    VLM's ``vision_embeds`` or an encoder-decoder's ``frames``; decode:
    ``make_serve_step``.  Off meta the state and inputs are zeros."""
    dev = None if ctx is not None else device
    ins = _materialize(specs_mod.input_specs(cfg, shape), device)
    if shape.kind == "train":
        chips = 1 if ctx is None else math.prod(ctx.sizes.values())
        plan = plan or default_plan(cfg, shape, chips)
        acfg = AdamWConfig(int8_moments=plan.int8_moments)
        step = make_train_step(cfg, ctx, plan, acfg, shape=shape, device=dev)
        p_specs, o_specs = step.shardings["state"]
        p, o = abstract_state(cfg, acfg)
        params = _materialize(parallel.shard_tree(p, p_specs, ctx), device)
        opt = _materialize(parallel.shard_tree(o, o_specs, ctx), device)

        def run(params, opt, batch):
            return step.update(params, opt, step.grads(params, batch))

        return run, (params, opt, ins["batch"])
    if shape.kind == "prefill":
        step, specs = serve.make_prefill_step(cfg, ctx, shape, device=dev)
    else:
        step, specs = serve.make_serve_step(cfg, ctx, shape, device=dev)
    p, _ = abstract_state(cfg, AdamWConfig())
    params = _materialize(parallel.shard_tree(p, specs["params"], ctx),
                          device)
    cache = serve.init_cache(cfg, ctx, shape, device=dev)
    args = [params, ins["tokens"], cache]
    if shape.kind == "prefill":
        extra = ins.get("vision_embeds", ins.get("frames"))
        if extra is not None:
            args.append(extra)

    def run(*a):
        with torch.no_grad():
            return step(*a)

    return run, tuple(args)


def step_pass(cfg, shape, ctx, plan=None, device="meta", *,
              memory: bool = True, costs: bool = True) -> dict:
    """Run the cell's step once (``build_step``) under the counters: with
    ``memory`` its ``memory`` (``MemTracker``), with ``costs`` its
    ``flops`` and ``bytes_accessed``; always its ``collectives`` as the
    reference names them, the collectives in order (``calls``: (kind,
    bytes, group size)), the kernel calls its wrappers' meta branches
    counted (``kernels``: name -> calls, ops, bytes) and the pass's wall
    time with the build (``run_s``).  ``lower_cell`` runs the two
    counters in separate passes: ``FlopCounterMode`` keeps some of the
    ops' tensors alive a while, which raised agent-7b's train step peak
    by 0.77 GB (2%) under both."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.perf_counter()
    run, args = build_step(cfg, shape, ctx, plan, device)
    dev = torch.device(device) if ctx is None else ctx.device
    modes = []
    if memory:
        tracker = MemTracker()
        tracker.track_external(*prm.flatten(args)[0])
        arg_bytes = tracker.get_tracker_snapshot()[dev]["Total"]
        modes.append(tracker)
    if costs:
        flops, traffic = FlopCounterMode(display=False), _Traffic()
        modes += [flops, traffic]
    with parallel.record_collectives() as calls, \
            work.count_calls() as kernels, contextlib.ExitStack() as stack:
        for mode in modes:
            stack.enter_context(mode)
        run(*args)
    out = {"collectives": collective_bytes(calls), "kernels": kernels,
           "calls": calls}
    if memory:
        peak = tracker.get_tracker_snapshot("peak")[dev]["Total"]
        out["memory"] = {"argument_bytes": arg_bytes,
                         "temp_bytes": peak - arg_bytes,
                         "peak_bytes": peak}
    if costs:
        out["flops"] = float(flops.get_total_flops() + sum(
            k["ops"] for k in kernels.values()))
        out["bytes_accessed"] = float(traffic.bytes + sum(
            k["bytes"] for k in kernels.values()))
    out["run_s"] = time.perf_counter() - t0
    return out


def rank_pass(cfg, shape, sizes: dict, rank: int, plan=None,
              **counters) -> dict:
    """``step_pass`` as rank ``rank`` of a fake world of mesh ``sizes``
    ({axis: size}); a world of one runs with no mesh, on meta.
    ``counters``: ``step_pass``'s ``memory`` and ``costs``."""
    if math.prod(sizes.values()) == 1:
        return step_pass(cfg, shape, None, plan, **counters)
    try:
        with fake_world(tuple(sizes.values()), tuple(sizes), rank) as ctx:
            return step_pass(cfg, shape, ctx, plan, **counters)
    except Exception as e:
        raise RuntimeError(f"{cfg.name} at {shape.name}, rank {rank} of "
                           f"mesh {sizes}: {e!r}") from e


def _costs_of(res: dict) -> dict:
    return {"flops": res["flops"], "bytes_accessed": res["bytes_accessed"],
            "collectives": res["collectives"]}


def _larger(a: dict, b: dict) -> dict:
    """Each figure of two ranks' records, the larger."""
    return {k: _larger(v, b[k]) if isinstance(v, dict) else max(v, b[k])
            for k, v in a.items()}


def _at_depths(cfg, shape, sizes, ranks, plan, pick, full: bool,
               memory: bool):
    """``pick`` of each rank's pass (the memory counter's with
    ``memory``, else the costs'), at full depth or extrapolated from the
    reference's two depths: ({rank: figures}, mode)."""
    counters = {"memory": memory, "costs": not memory}
    if full:
        return {r: pick(rank_pass(cfg, shape, sizes, r, plan, **counters))
                for r in ranks}, "direct"
    ua, ub = _depths(cfg)
    # the reduced depths keep the pass's loss (the memory pass's chunked)
    cfgs = [_scaled_cfg(cfg, u).replace(loss_chunk=cfg.loss_chunk)
            for u in (ua, ub)]
    out = {}
    for r in ranks:
        fa, fb = (pick(rank_pass(c, shape, sizes, r, plan, **counters))
                  for c in cfgs)
        out[r] = _lin(fa, fb, ua, ub, _units_full(cfg))
    return out, f"extrapolated(u={ua},{ub})"


def lower_cell(arch: str, shape_name: str, mesh, mesh_name: str,
               plan: TrainPlan | None = None, cost_pass: bool = True, *,
               cfg=None, shape=None) -> dict:
    """The step pass of one cell on ``mesh`` (a shape-only mesh): the
    memory pass (the production plan, at full depth where depth times
    microbatches are at most ``_MEMORY_MAX_PASSES``, else at the two
    depths) and, with ``cost_pass``, the cost pass (one microbatch, the
    unchunked loss; direct where ``_direct_ok``, else at the two depths),
    on rank 0 and the world's last rank.  ``cfg`` and ``shape`` replace
    the registry's (a test's reduced config)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "skipped": why}
    sizes = shd.mesh_axis_sizes(mesh)
    chips = mesh_chips(mesh)
    ranks = sorted({0, chips - 1})
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "chips": chips, "model_flops": model_flops(cfg, shape)}
    if shape.kind == "train":
        plan = plan or default_plan(cfg, shape, chips)
        rec["plan"] = {"microbatch": plan.microbatch,
                       "accum_dtype": plan.accum_dtype,
                       "int8_moments": plan.int8_moments}
    t0 = time.perf_counter()
    passes = cfg.n_layers * (plan.microbatch if plan else 1)
    mem, rec["memory_mode"] = _at_depths(
        cfg, shape, sizes, ranks, plan,
        lambda res: {"memory": res["memory"],
                     "collectives": res["collectives"]},
        passes <= _MEMORY_MAX_PASSES, memory=True)
    by_rank = {r: {"memory": {k: int(v) for k, v in m["memory"].items()}}
               for r, m in mem.items()}
    if cost_pass:
        plan_u = (TrainPlan(microbatch=1, int8_moments=plan.int8_moments)
                  if plan else None)
        cfg_u = cfg.replace(scan_layers=False, loss_chunk=0)
        costs, rec["cost_mode"] = _at_depths(cfg_u, shape, sizes, ranks,
                                             plan_u, _costs_of,
                                             _direct_ok(cfg), memory=False)
        for r, c in costs.items():
            by_rank[r].update(c)
    rec["run_s"] = round(time.perf_counter() - t0, 1)
    first, *rest = by_rank.values()
    for other in rest:
        first = _larger(first, other)
    rec.update(first)
    rec["ranks"] = {str(r): v for r, v in by_rank.items()}
    return rec


# ---------------------------------------------------------------------------
# Per-device bytes
# ---------------------------------------------------------------------------


def shard_bytes(tree, specs, mesh) -> int:
    """Bytes one device holds of a tree of (meta) tensors cut by a
    matching PartitionSpec tree."""
    sizes = shd.mesh_axis_sizes(mesh)
    leaves = prm.flatten(tree)[0]
    spec_leaves = prm.flatten(specs, is_leaf=shd.is_spec)[0]
    total = 0
    for t, spec in zip(leaves, spec_leaves):
        n = t.numel() // math.prod(shd.axes_size(e, sizes) for e in spec)
        total += n * t.element_size()
    return total


def activation_bytes(cfg, shape, mesh, microbatch: int = 1) -> int:
    """Per-device bytes of the layer inputs remat keeps through a train
    step's backward: each stack's layers x B_local x S_local x d x
    itemsize (the decoder's at the shape's S, an encoder's at its frame
    count), B into ``microbatch`` slices, one of which is in flight, each
    cut over the batch axes as ``batch_pspec`` cuts the batch, in GSPMD's
    padded shards (``ceil(B / microbatch / n)`` rows: a microbatch of 16
    rows over 32 ranks holds 1 on the ranks that hold any), and S over
    ``model`` where the reference's ``_constrain_act`` cuts it
    (``cfg.act_sharding``, S > 1 and a multiple of the model axis), as
    the port's sequence-parallel steps hold it."""
    sizes = shd.mesh_axis_sizes(mesh)
    b_spec = shd.batch_pspec(mesh, batch_size=shape.global_batch)
    n = shd.axes_size(b_spec[0], sizes)
    b_local = -(-shape.global_batch // (microbatch * n))
    m = sizes.get("model", 1)
    stacks = [(cfg.plan(), shape.seq_len)]
    if cfg.is_encdec:
        stacks.append((cfg.enc_plan(), specs_mod.enc_len(cfg, shape)))
    total = 0
    for plan, s in stacks:
        layers = sum(n * seg.repeat for seg in plan for _, n in seg.pattern)
        cut = cfg.act_sharding and m > 1 and s > 1 and s % m == 0
        total += layers * b_local * (s // m if cut else s) * cfg.d_model
    return total * torch_dtype(cfg.dtype).itemsize


def cell_record(arch: str, shape_name: str, mesh, mesh_name: str) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "skipped": why}
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "chips": mesh_chips(mesh), "analytic": True,
           "model_flops": model_flops(cfg, shape),
           "recurrent_correction_flops": recurrent_correction(cfg, shape)}
    ins = specs_mod.input_specs(cfg, shape)
    ins_specs = specs_mod.input_pspecs(cfg, shape, mesh)
    if shape.kind == "train":
        plan = default_plan(cfg, shape, mesh_chips(mesh))
        acfg = AdamWConfig(int8_moments=plan.int8_moments)
        params, opt = abstract_state(cfg, acfg)
        p_bytes = shard_bytes(params, shd.param_pspecs(cfg, mesh), mesh)
        by = {"params": p_bytes, "grads": p_bytes,
              "opt": shard_bytes(opt, opt_pspecs(cfg, mesh, acfg), mesh),
              "batch": shard_bytes(ins["batch"], ins_specs["batch"], mesh),
              "acts": activation_bytes(cfg, shape, mesh, plan.microbatch)}
        if plan.microbatch > 1:
            item = torch_dtype(plan.accum_dtype).itemsize
            p_dt = torch_dtype(cfg.dtype).itemsize
            by["accum"] = p_bytes * item // p_dt
        rec["plan"] = {"microbatch": plan.microbatch,
                       "accum_dtype": plan.accum_dtype,
                       "int8_moments": plan.int8_moments}
        refuse = _refusal(lambda: check_mesh(cfg, mesh, shape.global_batch,
                                             plan.microbatch))
    else:
        params, _ = abstract_state(cfg, AdamWConfig())
        by = {"params": shard_bytes(params, shd.param_pspecs(cfg, mesh),
                                    mesh),
              "cache": shard_bytes(ins["cache"], ins_specs["cache"], mesh),
              "batch": shard_bytes(
                  {k: v for k, v in ins.items() if k != "cache"},
                  {k: v for k, v in ins_specs.items() if k != "cache"},
                  mesh)}
        refuse = _refusal(lambda: serve.check_serve(cfg, mesh,
                                                    ins_specs["cache"]))
    by["total"] = sum(by.values())
    rec["bytes_per_device"] = by
    rec["fits_h100_80gb"] = by["total"] <= H100_BYTES
    rec["port_refuses"] = refuse
    return rec


def _refusal(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _cell(arch: str, shape_name: str, mesh_name: str, steps: bool) -> dict:
    """One cell's record: the analytic figures, and with ``steps`` the
    step pass (the cost pass on the single-pod cells, as the
    reference's; multi-pod is the memory picture)."""
    mesh = make_production_mesh(multi_pod=mesh_name == "multi")
    rec = cell_record(arch, shape_name, mesh, mesh_name)
    if steps and "skipped" not in rec:
        try:
            rec.update(lower_cell(arch, shape_name, mesh, mesh_name,
                                  cost_pass=(mesh_name == "single")))
        except Exception as e:
            rec["error"] = repr(e)
            rec["trace"] = traceback.format_exc()[-2000:]
    return rec


def _report(rec: dict, out_dir: Path) -> None:
    tag = f"{rec['arch']}.{rec['shape']}.{rec['mesh']}"
    (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
    if "skipped" in rec:
        print(f"SKIP {tag}: {rec['skipped']}", flush=True)
        return
    if "error" in rec:
        print(f"FAIL {tag}: {rec['error']}", flush=True)
        return
    by = rec["bytes_per_device"]
    line = (f"OK   {tag}: {rec['model_flops']:.3e} model FLOPs, "
            f"{by['total'] / 1e9:.2f} GB/device analytic (params "
            f"{by['params'] / 1e9:.2f}), fits 80 GB: {rec['fits_h100_80gb']}")
    if rec["port_refuses"]:
        line += f"; the port refuses: {rec['port_refuses']}"
    if "memory" in rec:
        line += (f"; step peak {rec['memory']['peak_bytes'] / 1e9:.2f} GB "
                 f"({rec['memory_mode']})")
    if "flops" in rec:
        line += (f", {rec['flops']:.3e} FLOPs {rec['bytes_accessed']:.3e} B "
                 f"coll={rec['collectives']['total']:.3e} B "
                 f"({rec['cost_mode']})")
    if "run_s" in rec:
        line += f", {rec['run_s']} s"
    print(line, flush=True)


def run(archs, shapes, meshes, out_dir: Path, steps: bool = False,
        jobs: int = 1) -> list[dict]:
    """Every (arch, shape, mesh) cell's record, written to ``out_dir`` as
    it comes; with ``jobs`` > 1 the cells run in that many processes (one
    torch thread each), the recurrent families' first, since the
    sLSTM's loop over the tokens on the host makes theirs the longest."""
    out_dir.mkdir(parents=True, exist_ok=True)
    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]
    if jobs <= 1:
        results = []
        for cell in cells:
            results.append(_cell(*cell, steps))
            _report(results[-1], out_dir)
        return results
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor, as_completed

    from repro_torch.launch import dryrun   # picklable by module name

    order = sorted(cells, key=lambda c: get_config(c[0]).family
                   not in ("hybrid", "ssm"))
    done = {}
    with ProcessPoolExecutor(jobs, multiprocessing.get_context("spawn"),
                             initializer=torch.set_num_threads,
                             initargs=(1,)) as pool:
        futures = {pool.submit(dryrun._cell, *c, steps): c
                   for c in order}
        for f in as_completed(futures):
            done[futures[f]] = f.result()
            _report(done[futures[f]], out_dir)
    return [done[c] for c in cells]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/torch/dryrun")
    ap.add_argument("--steps", action="store_true",
                    help="run each cell's step pass (lower_cell)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run in this many processes at once")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    t0 = time.perf_counter()
    results = run(archs, shapes, meshes, Path(args.out), steps=args.steps,
                  jobs=args.jobs)
    skipped = sum(1 for r in results if "skipped" in r)
    failed = sum(1 for r in results if "error" in r)
    print(f"\n{len(results)} cells: {len(results) - skipped - failed} "
          f"recorded, {failed} failed, {skipped} skipped, in "
          f"{time.perf_counter() - t0:.1f} s")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
