"""Bit-level digests of the sharded steps where sequence parallelism hands
off to the tensor-parallel path.

Runs a source tree's ``repro_torch`` launch steps in CPU ``gloo`` ranks
(2 and 4, spawned here; no card needed) on the f32 smokes of
``tests/_torch_ranks.py``, weights from seed 0: one train step's
gradients and loss (``step.grads``), a prefill and three decode steps'
logits, per (mesh, config, S, ``act_sharding``) case, and prints the
first 16 hex digits of the SHA-256 of each rank's bytes.  The cases are
those the sequence-parallel rule leaves whole: ``act_sharding`` off, or
an S the model axis does not divide (S 15, 17 or 18; seamless's 10
frames at S 16 off).  ``--src`` names the tree (default: this
checkout's), so a tree from before sequence parallelism and this one
compare line for line:

    python tools/sharded_digests.py --src /path/to/other/src
    python tools/sharded_digests.py

Prints one JSON object a line per case and rank.  A tree without
``act_sharding`` in its steps ignores the flag.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (mesh, config of tests/_torch_ranks.py's CONFIGS, S, act_sharding)
CASES = [((1, 2), "tiny", 16, False), ((1, 2), "tiny", 15, True),
         ((1, 2), "hymba", 16, False), ((1, 2), "hymba-whole", 16, False),
         ((1, 2), "xlstm", 15, True), ((1, 2), "arctic", 16, False),
         ((1, 2), "seamless", 16, False), ((1, 2), "qwen2vl", 15, True),
         ((1, 4), "tiny", 18, True), ((1, 4), "hymba", 18, True),
         ((1, 4), "xlstm", 16, False), ((2, 2), "arctic", 17, True),
         ((2, 2), "seamless", 16, False)]


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def rank(r: int, world: int, src: str, tmp: str) -> None:
    sys.path[:0] = [str(ROOT / "tests"), src]
    import numpy as np
    import torch
    import torch.distributed as dist

    import _torch_ranks as ranks
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import parallel
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import specs as specs_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import (AdamWConfig, TrainPlan,
                                          make_train_step)
    from repro_torch.models import params as prm

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            world_size=world, rank=r)
    lines = []
    for shape, name, s, act in CASES:
        if shape[0] * shape[1] != world:
            continue
        ctx = parallel.MeshContext(make_mesh(shape, ("data", "model"),
                                             device_type="cpu"))
        cfg = ranks.CONFIGS[name]().replace(act_sharding=act)
        full = ranks._params(cfg)
        batch = ranks._batch(cfg, 4, s)
        step = make_train_step(cfg, ctx, TrainPlan(), AdamWConfig(),
                               shape=ShapeConfig("t", s, 4, "train"))
        params = parallel.shard_tree(full, step.shardings["params"], ctx)
        m, g = step.grads(params, batch, with_metrics=True)
        shape_d = ShapeConfig("d", s, 4, "decode")
        pre, _ = serve_mod.make_prefill_step(
            cfg, ctx, ShapeConfig("p", s, 4, "prefill"))
        dec, dspecs = serve_mod.make_serve_step(cfg, ctx, shape_d)
        params = parallel.shard_tree(full, dspecs["params"], ctx)
        cache = serve_mod.init_cache(cfg, ctx, shape_d)
        kw = ranks.frontend(cfg, 4, np.random.default_rng(5),
                            specs_mod.enc_len(cfg, shape_d))
        with torch.no_grad():
            logits, cache = pre(params, batch["tokens"], cache,
                                *kw.values())
            outs = [logits]
            for _ in range(3):
                logits, cache = dec(params, torch.zeros((4, 1),
                                                        dtype=torch.long),
                                    cache)
                outs.append(logits)
        lines.append({"mesh": list(shape), "config": name, "S": s,
                      "act_sharding": act, "rank": r,
                      "grads": digest(prm.flatten(g)[0] + [m["loss"]]),
                      "serve": digest(outs)})
    Path(tmp, f"rank{r}.json").write_text(json.dumps(lines))
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args(argv)
    import torch.multiprocessing as mp

    for world in (2, 4):
        with tempfile.TemporaryDirectory() as tmp:
            mp.start_processes(rank, args=(world, args.src, tmp),
                               nprocs=world, start_method="spawn")
            for r in range(world):
                for line in json.loads(Path(tmp, f"rank{r}.json")
                                       .read_text()):
                    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
