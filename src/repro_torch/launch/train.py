"""Training-step factory (port of ``repro/launch/train.py``), single
device.

``make_train_step`` builds the (params, opt_state, batch) -> (params,
opt_state, metrics) update for a config on one device:

* gradients of ``models.loss_fn`` by ``torch.autograd.grad`` for every
  config of the registry, with the Hopper kernels' forwards and
  backwards on the card when ``cfg.use_pallas`` is set (flash attention,
  the MoE's ``grouped_matmul``, the ``ssm_scan`` of hymba and the
  mLSTM);
* optional microbatch gradient accumulation in ``plan.accum_dtype``, in
  the reference's order (``a + g / k`` per microbatch);
* AdamW, optionally with int8 moments (``repro_torch.optim``), updating
  the parameters and moments in place.

Left out, because they are ROADMAP A6 (multi-GPU): the mesh and the
sharding trees (``opt_pspecs``, in/out shardings, buffer donation: the
port updates in place instead), the int8 cross-pod gradient compression
(``compress_grads``, ``make_compressed_grad_fn``) and the dry run's
``abstract_state``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer
from repro_torch.models.params import (flatten, resolve_device, torch_dtype,
                                       unflatten)
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

__all__ = ["AdamWConfig", "TrainPlan", "adamw_init", "default_plan",
           "make_train_step"]


@dataclass(frozen=True)
class TrainPlan:
    microbatch: int = 1              # gradient-accumulation steps
    accum_dtype: str = "float32"     # grad accumulator dtype
    int8_moments: bool = False


def default_plan(cfg: ModelConfig, shape: ShapeConfig,
                 n_chips: int = 256) -> TrainPlan:
    """The reference's memory-fitting heuristics, by parameter count."""
    n = transformer.param_count(cfg)
    if n > 100e9:
        return TrainPlan(microbatch=16, accum_dtype="bfloat16",
                         int8_moments=True)
    if n > 20e9:
        return TrainPlan(microbatch=4, int8_moments=True)
    return TrainPlan(microbatch=1)


def make_train_step(cfg: ModelConfig, plan: Optional[TrainPlan] = None,
                    acfg: Optional[AdamWConfig] = None, device=None):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``batch`` holds tokens and labels (B, S) and, where the
    config takes them, positions (B, S) or (B, S, 3), vision_embeds (B,
    P, d) and frames (B, T_enc, d) (numpy arrays or tensors; moved to
    ``device``, CUDA unless the caller asks for the CPU); the global
    batch splits into ``plan.microbatch`` equal slices of every key, as
    the reference's ``slice_mb`` maps over every leaf.
    ``metrics``: loss (and xent, aux without microbatches), grad_norm and
    lr, as 0-d tensors on the device."""
    plan = plan or TrainPlan()
    acfg = acfg or AdamWConfig(int8_moments=plan.int8_moments)
    dev = resolve_device(device)
    accum_dt = torch_dtype(plan.accum_dtype)

    def grads_of(params, mb):
        leaves, treedef = flatten(params)
        with torch.enable_grad():
            live = [p.detach().requires_grad_(True) for p in leaves]
            loss, metrics = transformer.loss_fn(unflatten(treedef, live),
                                                cfg, mb)
            grads = torch.autograd.grad(loss, live)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, unflatten(treedef, list(grads))

    def step(params, opt_state, batch):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        k = plan.microbatch
        if k <= 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            gb = next(iter(batch.values())).shape[0]
            if gb % k:
                raise ValueError(f"global batch {gb} does not split into "
                                 f"{k} microbatches")
            b = gb // k
            acc = None
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(k):
                mb = {n: x[i * b:(i + 1) * b] for n, x in batch.items()}
                mb_loss, _, grads = grads_of(params, mb)
                g_leaves, treedef = flatten(grads)
                if acc is None:
                    acc = [torch.zeros(g.shape, dtype=accum_dt, device=dev)
                           for g in g_leaves]
                acc = [a + g.to(accum_dt) / k for a, g in zip(acc, g_leaves)]
                loss = loss + mb_loss / k
            grads = unflatten(treedef, acc)
            metrics = {"loss": loss}
        params, opt_state, opt_metrics = adamw_update(grads, opt_state,
                                                      params, acfg)
        return params, opt_state, {**metrics, **opt_metrics}

    return step
