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
one H100's 80 GB.  It also records whether the port's sharded
steps run the cell, or the refusal they raise (``port_refuses``: every
family's train, prefill and decode steps run over ``model`` and the
batch axes, so no cell of the registry is refused).  Every number is
analytic: the meta tensors hold no memory, and the activations inside
a layer (remat's recompute) and workspace are not counted.

The reference lowers and compiles each cell with XLA on 512 placeholder
CPU devices and reads ``compiled.memory_analysis()`` and
``cost_analysis()``, and its ``collective_bytes`` and
``cpu_bf16_inflation`` parse the optimized HLO text.  PyTorch has no
compiled whole-step module to read, so this dry run has none of those.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun            # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b \\
      --shape train_4k --mesh single
"""
from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.distributed import sharding as shd
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import make_production_mesh, mesh_chips
from repro_torch.launch.serve import check_serve
from repro_torch.launch.train import (AdamWConfig, abstract_state,
                                      check_mesh, default_plan, opt_pspecs)
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
    count), B cut over the batch axes as ``batch_pspec`` cuts it and
    into ``microbatch`` slices, one of which is in flight, and S over
    ``model`` where the reference's ``_constrain_act`` cuts it
    (``cfg.act_sharding``, S > 1 and a multiple of the model axis), as
    the port's sequence-parallel steps hold it."""
    sizes = shd.mesh_axis_sizes(mesh)
    b_spec = shd.batch_pspec(mesh, batch_size=shape.global_batch)
    b_local = shape.global_batch // shd.axes_size(b_spec[0], sizes)
    b_local //= microbatch
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
        refuse = _refusal(lambda: check_mesh(cfg, mesh, shape.global_batch))
    else:
        params, _ = abstract_state(cfg, AdamWConfig())
        by = {"params": shard_bytes(params, shd.param_pspecs(cfg, mesh),
                                    mesh),
              "cache": shard_bytes(ins["cache"], ins_specs["cache"], mesh),
              "batch": shard_bytes(
                  {k: v for k, v in ins.items() if k != "cache"},
                  {k: v for k, v in ins_specs.items() if k != "cache"},
                  mesh)}
        refuse = _refusal(lambda: check_serve(cfg, mesh, ins_specs["cache"]))
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


def run(archs, shapes, meshes, out_dir: Path) -> list[dict]:
    out_dir.mkdir(parents=True, exist_ok=True)
    mesh_objs = {}
    if "single" in meshes:
        mesh_objs["single"] = make_production_mesh(multi_pod=False)
    if "multi" in meshes:
        mesh_objs["multi"] = make_production_mesh(multi_pod=True)
    results = []
    for arch in archs:
        for shape_name in shapes:
            for mesh_name, mesh in mesh_objs.items():
                tag = f"{arch}.{shape_name}.{mesh_name}"
                rec = cell_record(arch, shape_name, mesh, mesh_name)
                results.append(rec)
                (out_dir / f"{tag}.json").write_text(json.dumps(rec,
                                                                indent=1))
                if "skipped" in rec:
                    print(f"SKIP {tag}: {rec['skipped']}", flush=True)
                    continue
                by = rec["bytes_per_device"]
                print(f"OK   {tag}: {rec['model_flops']:.3e} model FLOPs, "
                      f"{by['total'] / 1e9:.2f} GB/device analytic "
                      f"(params {by['params'] / 1e9:.2f}), fits 80 GB: "
                      f"{rec['fits_h100_80gb']}"
                      + (f"; the port refuses: {rec['port_refuses']}"
                         if rec["port_refuses"] else ""), flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/torch/dryrun")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    results = run(archs, shapes, meshes, Path(args.out))
    skipped = sum(1 for r in results if "skipped" in r)
    print(f"\n{len(results)} cells: {len(results) - skipped} recorded, "
          f"{skipped} skipped")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
