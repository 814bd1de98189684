"""AdamW with optional int8 (blockwise-quantized) moments (port of
``repro/optim/adamw.py``).

``int8_moments=True`` stores m and v as int8 with per-128-block f32
scales over the last axis (8-bit-Adam style): 2.25 bytes a parameter of
optimizer state instead of 8, which is what lets agent-7b's training
state (5.93 B parameters) fit one 80 GB card.  v is stored in the sqrt
domain, as the reference does.

The math is the reference's, in f32: the global-norm clip, the schedule
and the bias corrections are f32 tensors computed from the step as
``step.astype(jnp.float32)`` is (Python doubles would differ in the last
bits), and ``_quantize`` rounds half to even as ``jnp.round`` does.

Two differences, both for memory on one card:

* ``adamw_update`` updates the parameters and the moments in place,
  under ``torch.no_grad()``, and returns the same tensors (the reference
  returns new arrays and donates the old ones);
* it walks each leaf in slices along its leading axes (a stacked leaf
  one layer at a time), so its f32 temporaries stay at most
  ``UPDATE_SLICE`` elements: agent-7b's stacked MLP leaf holds 1.44 G
  elements, one f32 temporary of it 5.8 GB, and the update makes
  several.  Quantization blocks lie along the last axis only, so the
  slices give the whole-leaf update's numbers exactly.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.params import flatten, unflatten

BLOCK = 128
# the most elements a slice of one leaf's update holds (agent-7b's MLP
# slice of one layer is 4096 x 11008 = 45 M)
UPDATE_SLICE = 2 ** 26


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    int8_moments: bool = False
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


# ---------------------------------------------------------------------------
# Blockwise int8 quantization
# ---------------------------------------------------------------------------


class Q8(NamedTuple):
    q: torch.Tensor          # int8, original shape
    scale: torch.Tensor      # f32, shape (..., n_blocks) over the last dim


def _quantize(x: torch.Tensor) -> Q8:
    """Blockwise int8 over the LAST dim only, blocks of 128 (the last
    block zero-padded), scale = max |block| / 127 (at least 1e-12)."""
    shape = x.shape
    if not shape:
        return Q8(torch.zeros((), dtype=torch.int8, device=x.device),
                  torch.clamp(x.abs(), min=1e-12).float()[None])
    n = shape[-1]
    pad = (-n) % BLOCK
    blocks = F.pad(x, (0, pad)).reshape(*shape[:-1], -1, BLOCK)
    scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    q = q.reshape(*shape[:-1], n + pad)[..., :n].contiguous()
    return Q8(q, scale[..., 0].float())


def _dequantize(q8: Q8, shape) -> torch.Tensor:
    shape = tuple(shape)
    if not shape:
        return q8.q.float() * q8.scale[0]
    n = shape[-1]
    pad = (-n) % BLOCK
    blocks = F.pad(q8.q.float(), (0, pad)).reshape(*shape[:-1], -1, BLOCK)
    out = blocks * q8.scale[..., None]
    return out.reshape(*shape[:-1], n + pad)[..., :n]


def global_blocks(offset: int, full: int, reduce_max: Callable):
    """(quantize, dequantize) for the shard [offset, offset + n) of a
    leaf's last axis of ``full`` elements: the blocks are the whole
    leaf's 128-element blocks, their scales (..., ceil(full / 128)) kept
    whole on every rank, each block's max |x| the max over the ranks
    sharing it (``reduce_max``).  Gives the unsharded leaf's numbers
    exactly.  Only the blocks the shard touches are made element-wide (at
    most its width plus two blocks), never the whole leaf's width."""
    nb = -(-full // BLOCK)

    def window(n: int) -> tuple[int, int, int]:
        """The shard's first and last-plus-one block, and its offset in
        the first."""
        b0 = offset // BLOCK
        return b0, -(-(offset + n) // BLOCK), offset - b0 * BLOCK

    def spread(scale, n):
        b0, b1, lo = window(n)
        return scale[..., b0:b1].repeat_interleave(BLOCK, -1)[..., lo:lo + n]

    def quantize(x: torch.Tensor) -> Q8:
        n = x.shape[-1]
        b0, b1, lo = window(n)
        part = x.new_zeros(*x.shape[:-1], (b1 - b0) * BLOCK)
        part[..., lo:lo + n] = x.abs()
        amax = x.new_zeros(*x.shape[:-1], nb)
        amax[..., b0:b1] = part.reshape(*x.shape[:-1], b1 - b0,
                                        BLOCK).amax(-1)
        amax = reduce_max(amax)
        scale = torch.clamp(amax / 127.0, min=1e-12)
        q = torch.clamp(torch.round(x / spread(scale, n)), -127, 127)
        return Q8(q.to(torch.int8), scale.float())

    def dequantize(q8: Q8, shape) -> torch.Tensor:
        return q8.q.float() * spread(q8.scale, tuple(shape)[-1])

    return quantize, dequantize


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


class AdamWState(NamedTuple):
    step: torch.Tensor     # int32 scalar
    m: Any                 # tree: f32 tensors or Q8
    v: Any


def _is_q8(x) -> bool:
    return isinstance(x, Q8)


def adamw_init(params, cfg: AdamWConfig) -> AdamWState:
    """Zero moments leaf for leaf of ``params``, on each leaf's device."""
    leaves, treedef = flatten(params)

    def zero(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return _quantize(z) if cfg.int8_moments else z

    dev = leaves[0].device if leaves else None
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m=unflatten(treedef, [zero(p) for p in leaves]),
        v=unflatten(treedef, [zero(p) for p in leaves]))


def _lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine to ``min_lr_frac``; ``step`` f32."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def _slices(shape) -> list:
    """Index tuples whose slices of a leaf of ``shape`` tile it with at most
    ``UPDATE_SLICE`` elements each (or one row of the last axis, which is
    never split) and as few slices as that allows: the leading axes one
    index at a time down to the first axis ``n`` whose trailing block
    fits, that axis in runs of rows.  One empty index for a leaf that
    fits whole."""
    shape = tuple(shape)
    if math.prod(shape) <= UPDATE_SLICE or len(shape) < 2:
        return [()]
    n = next((a for a in range(len(shape) - 1)
              if math.prod(shape[a + 1:]) <= UPDATE_SLICE), len(shape) - 2)
    run = max(1, UPDATE_SLICE // math.prod(shape[n + 1:]))
    rows = [slice(i, min(i + run, shape[n]))
            for i in range(0, shape[n], run)]
    return [lead + (r,) for lead in itertools.product(*map(range, shape[:n]))
            for r in rows]


def _sq_sum(g: torch.Tensor) -> torch.Tensor:
    """sum(square(g in f32)), slice by slice."""
    total = torch.zeros((), dtype=torch.float32, device=g.device)
    for idx in _slices(g.shape):
        total = total + g[idx].float().square().sum()
    return total


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig,
                 norm_sq: Optional[Callable] = None,
                 quant: Optional[list] = None):
    """Returns (params, new_state, metrics), the parameters and moments
    updated in place (the same tensors), ``metrics`` with the pre-clip
    ``grad_norm`` and this step's ``lr``.

    A sharded step passes ``norm_sq(flat_grads)``, the global squared
    norm (its ranks' shares summed, each replicated element counted
    once), and ``quant``: per flat leaf None or a (quantize, dequantize)
    pair for int8 moments whose blocks are the whole leaf's (a shard whose
    last axis is cut off a 128 boundary)."""
    step = state.step + 1
    flat_p, treedef = flatten(params)
    flat_g, gdef = flatten(grads)
    if gdef != treedef:
        raise ValueError("grads do not have the params' tree")
    if any(g is None for g in flat_g):
        raise ValueError("a parameter has no gradient")

    # global-norm clip, f32
    gnorm = torch.sqrt(norm_sq(flat_g) if norm_sq is not None
                       else sum(_sq_sum(g) for g in flat_g))
    scale = (torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
             if cfg.clip_norm > 0 else torch.ones((), device=gnorm.device))

    stepf = step.float()
    b1t = 1 - cfg.b1 ** stepf
    b2t = 1 - cfg.b2 ** stepf
    lr = _lr_at(cfg, stepf)

    def upd(p, g, m, v, qz):
        quantize, dequantize = qz or (_quantize, _dequantize)
        g = g.float() * scale
        if cfg.int8_moments:
            mf = dequantize(m, p.shape)
            vf = torch.square(dequantize(v, p.shape))
        else:
            mf, vf = m, v
        mf = cfg.b1 * mf + (1 - cfg.b1) * g
        vf = cfg.b2 * vf + (1 - cfg.b2) * torch.square(g)
        update = (mf / b1t) / (torch.sqrt(vf / b2t) + cfg.eps)
        pf = p.float()
        newp = pf - lr * (update + cfg.weight_decay * pf)
        p.copy_(newp)
        if cfg.int8_moments:
            for old, new in ((m, quantize(mf)), (v, quantize(
                    torch.sqrt(vf)))):
                old.q.copy_(new.q)
                old.scale.copy_(new.scale)
        else:
            m.copy_(mf)
            v.copy_(vf)

    flat_m = flatten(state.m, is_leaf=_is_q8)[0]
    flat_v = flatten(state.v, is_leaf=_is_q8)[0]
    quant = quant or [None] * len(flat_p)
    for p, g, m, v, qz in zip(flat_p, flat_g, flat_m, flat_v, quant):
        for idx in _slices(p.shape):
            if cfg.int8_moments:
                upd(p[idx], g[idx], Q8(m.q[idx], m.scale[idx]),
                    Q8(v.q[idx], v.scale[idx]), qz)
            else:
                upd(p[idx], g[idx], m[idx], v[idx], qz)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step, state.m, state.v), metrics
