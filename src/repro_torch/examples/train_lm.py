"""End-to-end training example: a ~100M-param LM for a few hundred steps
through the port's production path -- the single-device train step
(the Hopper flash attention forward and backward on the card), the
synthetic token pipeline, AdamW with warmup+cosine, atomic
checkpointing, and supervised restart.  The twin of the JAX package's
``examples/train_lm.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] [--chaos]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu ...

``--chaos`` injects a failure mid-run to demonstrate checkpoint/restart
(the resumed loss curve continues where it left off).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import models
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch.train import AdamWConfig, TrainPlan, make_train_step
from repro_torch.models.attention import rescale_to_true_fan_in
from repro_torch.models.params import resolve_device
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime import SimulatedFailure, TrainSupervisor
from repro_torch.runtime.supervisor import SupervisorConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--model", default="lm-100m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="artifacts/train_lm")
    ap.add_argument("--chaos", action="store_true",
                    help="inject a failure at step 2/3 of the run")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, with the Hopper "
                         "kernels; 'cpu' runs their plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.model).replace(use_pallas=device.type == "cuda")
    n = models.param_count(cfg)
    print(f"model {cfg.name}: {n/1e6:.1f}M params on {device}")

    acfg = AdamWConfig(lr=1e-3, warmup_steps=min(30, args.steps // 5),
                       total_steps=args.steps)
    step_fn = make_train_step(cfg, None, TrainPlan(), acfg, device=device)
    params = models.init(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    # the reference draws its attention projections at the fan-in of the
    # head axis, and then lm-100m gains under 0.2 nats in 150 steps
    # (ROADMAP §C, reference fault 5)
    rescale_to_true_fan_in(params)
    opt = adamw_init(params, acfg)

    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch, seed=1))
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    sup = TrainSupervisor(mgr, SupervisorConfig(ckpt_every=50))

    losses = []
    t0 = time.time()
    chaos_at = {args.steps * 2 // 3} if args.chaos else set()

    def train_one(state, batch, step):
        if step in chaos_at:
            chaos_at.discard(step)
            raise SimulatedFailure(f"injected failure at step {step}")
        p, o = state
        p, o, metrics = step_fn(p, o, batch)
        losses.append(float(metrics["loss"]))
        if (step + 1) % 25 == 0:
            rate = (step + 1) / (time.time() - t0)
            print(f"step {step+1:4d}  loss {losses[-1]:.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"({rate:.2f} steps/s)", flush=True)
        return (p, o)

    sup.run(state=(params, opt), pipeline=pipe, step_fn=train_one,
            total_steps=args.steps)
    pipe.close()

    first = np.mean(losses[:20])
    last = np.mean(losses[-20:])
    print(f"\nloss: {first:.3f} -> {last:.3f} "
          f"(improved {first-last:.3f} nats)")
    if sup.restarts:
        print(f"survived {sup.restarts} failure(s); log: {sup.log}")
    need = 0.2 if args.steps >= 150 else 0.04
    if not last < first - need:
        raise RuntimeError("training did not make progress")
    print("OK")
    return {"losses": losses, "restarts": sup.restarts, "log": sup.log,
            "first": float(first), "last": float(last)}


if __name__ == "__main__":
    main()
