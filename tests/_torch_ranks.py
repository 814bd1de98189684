"""Sharded checks of the port, run in CPU ``gloo`` ranks.

``spawn(world, mesh_shapes, checks, tmp)`` starts ``world`` processes
that rendezvous through a ``FileStore`` in ``tmp`` (no TCP port), build
a ``DeviceMesh`` of each shape in ``mesh_shapes`` over them and run every
named check of ``CHECKS`` on it; each rank writes its results to a JSON
file and the parent returns them per rank.  Each check holds a sharded
step to the single-device step on the same weights and inputs, both
computed in the rank: greedy tokens, and the largest |difference| of
logits, losses, every gradient leaf and every updated parameter, which
the tests compare with their bands.  This module imports no JAX, so a
rank starts in seconds.
"""
from __future__ import annotations

import json
import os
import pickle
import threading
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import models
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import parallel
from repro_torch.distributed.sharding import is_spec
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import (AdamWConfig, TrainPlan,
                                      init_opt_state, make_train_step)
from repro_torch.models import params as prm
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.models.attention import rescale_to_true_fan_in
from repro_torch.optim.adamw import Q8, adamw_init
from repro_torch.runtime.supervisor import (SimulatedFailure,
                                            SupervisorConfig, TrainSupervisor)

def f32(cfg):
    return cfg.replace(dtype="float32")


def tiny():
    return f32(get_config("tiny-agent"))


# every config a check names, at its CPU size in f32
CONFIGS = {
    "tiny": tiny,
    # one KV head: it replicates over a model axis of 2 (the serve cache
    # cuts its ring's sequence over the model axis, the GQA fallback, or
    # keeps it whole where the ring does not split; training slices the
    # KV head each rank reads)
    "tiny-kv1": lambda: tiny().replace(n_kv_heads=1),
    # sliding window 16 on every layer: a 24-slot ring the prompt wraps
    "danube": lambda: f32(get_smoke("h2o-danube-3-4b")),
    "arctic": lambda: f32(get_smoke("arctic-480b")),
    "kimi": lambda: f32(get_smoke("kimi-k2-1t-a32b")),
    "hymba": lambda: f32(get_smoke("hymba-1.5b")),
    # the families the model axis cuts only since A6.1: xLSTM (mLSTM and
    # sLSTM, d_inner 128: up_proj's contiguous cut puts all of x on rank
    # 0 of (1, 2) and all of z on rank 1, half each on (1, 4)), the VLM
    # (4 heads over 2 KV heads, M-RoPE, patch embeddings) and the
    # encoder-decoder (4 heads over 4 KV heads, cross attention)
    # hymba's full-width layout at smoke size: 3 query heads over 1 KV
    # head stay whole on a model axis of 2 (hymba-1.5b's 25 over 5), so
    # the ring is cut over ``model`` and each rank decodes whole query
    # heads over its slots; the mamba branch and the MLP are still cut
    "hymba-whole": lambda: f32(get_smoke("hymba-1.5b")).replace(
        n_heads=3, n_kv_heads=1, d_head=16),
    "xlstm": lambda: f32(get_smoke("xlstm-350m")),
    "qwen2vl": lambda: f32(get_smoke("qwen2-vl-2b")),
    "seamless": lambda: f32(get_smoke("seamless-m4t-large-v2")),
}

# the VLM's patch embeddings over the first slots, and the encoder's frames
GRID = (2, 3)
FRAMES = 10


def _params(cfg):
    p = models.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    rescale_to_true_fan_in(p)
    return p


def vision_positions(b: int, n_text: int) -> np.ndarray:
    """(B, P + n_text, 3): the GRID patches at (0, row, col), then text
    whose three streams run on together from max(GRID)."""
    gh, gw = GRID
    hh, ww = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    vis = np.stack([np.zeros_like(hh), hh, ww], -1).reshape(gh * gw, 3)
    text = np.repeat((max(gh, gw) + np.arange(n_text))[:, None], 3, 1)
    pos = np.concatenate([vis, text]).astype(np.int32)
    return np.broadcast_to(pos[None], (b,) + pos.shape).copy()


def frontend(cfg, b: int, rng, frames: int = FRAMES) -> dict:
    """A VLM's patch embeddings (B, P, d) or an encoder-decoder's frames
    (B, frames, d), as tensors; nothing for any other config."""
    if cfg.frontend == "patch":
        return {"vision_embeds": torch.from_numpy((0.5 * rng.standard_normal(
            (b, GRID[0] * GRID[1], cfg.d_model))).astype(np.float32))}
    if cfg.is_encdec:
        return {"frames": torch.from_numpy((0.5 * rng.standard_normal(
            (b, frames, cfg.d_model))).astype(np.float32))}
    return {}


def _batch(cfg, b: int, s: int, seed: int = 0, frames: int = FRAMES) -> dict:
    """Tokens and labels, plus the family's inputs: a VLM's patch
    embeddings at (B, S, 3) positions, an encoder-decoder's ``frames``
    frames."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int64)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    labels[0, -5:] = -1          # rank 0's rows hold fewer labels
    out = {"tokens": torch.from_numpy(toks),
           "labels": torch.from_numpy(labels),
           **frontend(cfg, b, rng, frames)}
    if cfg.frontend == "patch":
        out["positions"] = torch.from_numpy(
            vision_positions(b, s - GRID[0] * GRID[1]))
    return out


def _max_diff(a, b) -> float:
    la, lb = prm.flatten(a)[0], prm.flatten(b)[0]
    if len(la) != len(lb):
        raise AssertionError(f"{len(la)} leaves against {len(lb)}")
    return max(float((x.float() - y.float()).abs().max()) if x.numel() else
               0.0 for x, y in zip(la, lb))


def _max_rel(a, b) -> float:
    """The largest |difference| of a leaf over the leaf's largest
    magnitude in ``b``, over the leaves."""
    return max(float((x.float() - y.float()).abs().max()
                     / y.float().abs().max().clamp_min(1e-30))
               for x, y in zip(prm.flatten(a)[0], prm.flatten(b)[0])
               if x.numel())


def _clone(tree):
    return prm.tree_map(lambda t: t.clone(), tree)


def train_check(ctx, cfg, b: int, s: int, int8: bool, microbatch: int = 1,
                steps: int = 2, compress: bool = False) -> dict:
    """Steps of the sharded train step against the single-device one."""
    acfg = AdamWConfig(lr=1e-3, warmup_steps=0, int8_moments=int8)
    plan = TrainPlan(microbatch=microbatch, int8_moments=int8,
                     compress_grads=compress)
    full = _params(cfg)
    batches = [_batch(cfg, b, s, seed) for seed in range(steps)]
    ref_step = make_train_step(cfg, None, TrainPlan(
        microbatch=microbatch, int8_moments=int8), acfg, device="cpu")
    step = make_train_step(cfg, ctx, plan, acfg,
                           shape=ShapeConfig("t", s, b, "train"))
    specs = step.shardings["params"]
    ref_p, ref_o = _clone(full), adamw_init(_clone(full), acfg)
    params = parallel.shard_tree(full, specs, ctx)
    opt = init_opt_state(params, acfg, ctx, cfg=cfg)
    ref_g = ref_step.grads(ref_p, batches[0])
    got_g = parallel.gather_tree(step.grads(params, batches[0]), specs, ctx)
    out = {"grads": _max_diff(got_g, ref_g), "grad_rel": _max_rel(got_g,
                                                                  ref_g),
           "grad_max": _max_diff(ref_g, prm.tree_map(torch.zeros_like,
                                                     ref_g))}
    losses, norms = [], []
    for i, batch in enumerate(batches):
        ref_p, ref_o, rm = ref_step(ref_p, ref_o, batch)
        params, opt, m = step(params, opt, batch)
        losses.append(abs(float(m["loss"]) - float(rm["loss"])))
        norms.append(abs(float(m["grad_norm"]) - float(rm["grad_norm"]))
                     / max(float(rm["grad_norm"]), 1e-9))
        if i == 0:
            out.update(_first_update(
                parallel.gather_tree(params, specs, ctx), ref_p, full, ref_g,
                float(rm["grad_norm"]), acfg))
    out.update(loss=max(losses), loss0=losses[0], norm_rel=max(norms),
               params=_max_diff(parallel.gather_tree(params, specs, ctx),
                                ref_p), moved=_max_diff(ref_p, full))
    if compress:
        ef = prm.flatten(step.error_feedback())[0]
        out["ef_leaves"] = len(ef)
        out["ef_max"] = max(float(e.abs().max()) for e in ef)
    return out


def _first_update(got, want, p0, grads, norm: float, acfg) -> dict:
    """AdamW's first step is sign-like (m / sqrt(v) = sign(g)), so a
    gradient element within f32 noise of zero may move either way by the
    learning rate.  As ``tests/test_torch_train_families.py`` holds it:
    the largest |difference| of the updated parameters where the clipped
    gradient stands clear of that noise (above 1e-3 of the leaf's largest
    and above 1e-4) over the leaf's largest magnitude (``params_sure``),
    the share of elements so held, and whether every element moved by at
    most the learning rate (with its weight decay) from where it was."""
    clip = min(1.0, acfg.clip_norm / max(norm, 1e-30))
    worst, held, total, bounded = 0.0, 0, 0, True
    for x, y, x0, g in zip(*(prm.flatten(t)[0]
                             for t in (got, want, p0, grads))):
        g = g.abs() * clip
        sure = (g > 1e-3 * g.max()) & (g > 1e-4)
        held += int(sure.sum())
        total += sure.numel()
        if sure.any():
            worst = max(worst, float((x - y).abs()[sure].max()
                                     / y.abs().max().clamp_min(1e-30)))
        bounded &= bool(((x - x0).abs() <= acfg.lr * (
            1 + acfg.weight_decay * x0.abs()) + 1e-6).all())
    return {"params_sure": worst, "held": held / max(total, 1),
            "bounded": bounded}


def serve_check(ctx, cfg, b: int, prompt: int, new: int,
                use_pallas: bool = False, long: bool = False) -> dict:
    """Prefill then ``new`` greedy decode steps through the launch steps on
    the mesh, against ``transformer.prefill`` / ``decode_step`` on one
    device: the rank's rows' logits and greedy tokens, the local cache's
    KV heads and ring slots (of the first layer) and the ring's global
    slots.  ``long`` names the decode shape ``long_*``, whose cache cuts
    the ring's sequence over ``data`` (``shard_seq``): the prefill then
    runs on one device and ``cut_cache`` gives the step its shard, as
    the reference's prefill step has no such layout."""
    cfg = cfg.replace(use_pallas=use_pallas)
    full = _params(cfg)
    toks = _batch(cfg, b, prompt)["tokens"]
    shape_p = ShapeConfig("p", prompt, b, "prefill")
    shape_d = ShapeConfig("long_d" if long else "d", prompt, b, "decode")
    enc = specs_mod.enc_len(cfg, shape_d)
    kw = frontend(cfg, b, np.random.default_rng(5), enc)
    dec, dspecs = serve_mod.make_serve_step(cfg, ctx, shape_d)
    params = parallel.shard_tree(full, dspecs["params"], ctx)
    ref_cache = models.init_cache(cfg, b, prompt + 128, device="cpu",
                                  enc_len=enc)
    rows = serve_mod.local_rows(torch.arange(b), ctx, dspecs["batch"])
    with torch.no_grad():
        ref, ref_cache = models.prefill(full, cfg, toks, ref_cache, **kw)
        if long:
            whole = models.init_cache(cfg, b, prompt + 128, device="cpu",
                                      enc_len=enc)
            logits, whole = models.prefill(full, cfg, toks, whole, **kw)
            logits = logits[rows]
            cache = serve_mod.cut_cache(whole, cfg, ctx, shape_d)
        else:
            pre, _ = serve_mod.make_prefill_step(cfg, ctx, shape_p)
            cache = serve_mod.init_cache(cfg, ctx, shape_d)
            logits, cache = pre(params, toks, cache, *kw.values())
        diffs = [float((logits - ref[rows]).abs().max())]
        scale = [float(ref.abs().max())]
        got, want = [logits.argmax(-1)], [ref[rows].argmax(-1)]
        nxt, ref_nxt = torch.zeros((b, 1), dtype=torch.long), None
        for _ in range(new):
            ref_nxt = ref.argmax(-1)[:, None]
            nxt[rows] = got[-1][:, None]
            logits, cache = dec(params, nxt, cache)
            ref, ref_cache = models.decode_step(full, cfg, ref_nxt, ref_cache)
            diffs.append(float((logits - ref[rows]).abs().max()))
            scale.append(float(ref.abs().max()))
            got.append(logits.argmax(-1))
            want.append(ref[rows].argmax(-1))
    out = {"logits": max(diffs), "logit_max": max(scale), "tokens_equal":
           bool(all(torch.equal(x, y) for x, y in zip(got, want))),
           "tokens": int(sum(x.numel() for x in got))}
    out.update(_first_ring(cache))
    cross = _first(cache, "cross")
    if cross is not None:
        out["cross_heads"] = int(cross.k.shape[-2])
        out["cross_len"] = int(cross.k.shape[-3])
        out["enc_len"] = enc
    return out


def _first(cache, key: str):
    """The first layer's cache leaf ``key`` (a stacked ``KVCache`` or
    ``CrossKV``), or None where its blocks keep none (xLSTM's)."""
    return cache["segments"][0]["e0"].get(key)


def _first_ring(cache) -> dict:
    """The first layer's ring, where it has one: its KV heads, this
    rank's slots and the ring's global slots."""
    kv = _first(cache, "kv")
    if kv is None:
        return {}
    return {"kv_heads": int(kv.k.shape[-2]), "slots": int(kv.k.shape[-3]),
            "ring": int(kv.kpos.shape[-1])}


def jax_ref_check(ctx, case: str) -> dict:
    """The sharded serve steps on a config's weights from the JAX package
    (``CONFIGS[r["config"]]``, with its patch embeddings or frames where
    the case has them), fed the greedy tokens of the JAX package's own
    serve steps on the same mesh (``_jax_seq_ref.py``, run by the test
    into this spawn's directory): the largest |logits - JAX logits| over
    the prefill and every decode step, and the largest |JAX logits|."""
    with open(Path(RUN_DIR, "jax_seq_ref.pkl"), "rb") as f:
        ref = pickle.load(f)
    r = ref[case]
    cfg = CONFIGS[r["config"]]()
    b, s = r["batch"], r["prompt"].shape[1]
    full = prm.from_jax(cfg, r["weights"], device="cpu")
    shape_d = ShapeConfig(r["name"], s, b, "decode")
    dec, dspecs = serve_mod.make_serve_step(cfg, ctx, shape_d)
    params = parallel.shard_tree(full, dspecs["params"], ctx)
    rows = serve_mod.local_rows(torch.arange(b), ctx, dspecs["batch"])
    toks = torch.from_numpy(r["prompt"]).long()
    extra = [torch.from_numpy(r["extra"])] if "extra" in r else []
    with torch.no_grad():
        if r["name"].startswith("long"):
            enc = specs_mod.enc_len(cfg, shape_d)
            whole = models.init_cache(cfg, b, s + 128, device="cpu",
                                      enc_len=enc)
            kw = {"frames": extra[0]} if cfg.is_encdec else {}
            logits, whole = models.prefill(full, cfg, toks, whole, **kw)
            logits = logits[rows]
            cache = serve_mod.cut_cache(whole, cfg, ctx, shape_d)
        else:
            pre, _ = serve_mod.make_prefill_step(
                cfg, ctx, ShapeConfig("p", s, b, "prefill"))
            cache = serve_mod.init_cache(cfg, ctx, shape_d)
            logits, cache = pre(params, toks, cache, *extra)
        diffs = [float((logits - torch.from_numpy(r["logits"][0])[rows])
                       .abs().max())]
        for fed, want in zip(r["fed"], r["logits"][1:]):
            logits, cache = dec(params, torch.from_numpy(fed).long(), cache)
            diffs.append(float((logits - torch.from_numpy(want)[rows])
                               .abs().max()))
    return {"logits": max(diffs), "steps": len(r["fed"]),
            "logit_max": max(float(np.abs(x).max()) for x in r["logits"]),
            **_first_ring(cache)}


def _norm_scales(tree) -> list:
    """The RMSNorm scales of a parameter tree (every ``scale`` leaf,
    stacked over the layers): the replicated weights a sequence-parallel
    block applies to its rows of S."""
    if isinstance(tree, dict):
        return [t for k, v in tree.items()
                for t in ([v] if k == "scale" else _norm_scales(v))]
    if isinstance(tree, list):
        return [t for v in tree for t in _norm_scales(v)]
    return []


def _sp_grads(ctx, cfg, full, batch, b: int, s: int):
    """(metrics, gathered gradients, boundary saves) of one sharded train
    step's gradients, the layer-boundary tensors remat saved recorded."""
    step = make_train_step(cfg, ctx, TrainPlan(), AdamWConfig(),
                           shape=ShapeConfig("t", s, b, "train"))
    specs = step.shardings["params"]
    params = parallel.shard_tree(full, specs, ctx)
    with models.boundary_saves() as saved:
        m, g = step.grads(params, batch, with_metrics=True)
    return m, parallel.gather_tree(g, specs, ctx), list(saved)


def _prefill(ctx, cfg, full, toks, kw: dict):
    """Last-token logits of the mesh's prefill step (this rank's rows)."""
    b, s = toks.shape
    shape_d = ShapeConfig("d", s, b, "decode")
    pre, specs = serve_mod.make_prefill_step(
        cfg, ctx, ShapeConfig("p", s, b, "prefill"))
    params = parallel.shard_tree(full, specs["params"], ctx)
    cache = serve_mod.init_cache(cfg, ctx, shape_d)
    with torch.no_grad():
        return pre(params, toks, cache, *kw.values())[0]


def sp_check(ctx, cfg, b: int, s: int) -> dict:
    """A sequence-parallel train step and prefill against one device: the
    loss and every gradient leaf (relative to the leaf's largest
    magnitude, the norm scales' apart), the prefill's logits and greedy
    tokens; and what remat saved at the layer boundaries, with
    ``act_sharding`` on and off: each saved input's shape and bytes."""
    full = _params(cfg)
    batch = _batch(cfg, b, s)
    ref_step = make_train_step(cfg, None, TrainPlan(), AdamWConfig(),
                               device="cpu")
    ref_m, ref_g = ref_step.grads(full, batch, with_metrics=True)
    m, got, saved = _sp_grads(ctx, cfg, full, batch, b, s)
    _, _, whole = _sp_grads(ctx, cfg.replace(act_sharding=False), full,
                            batch, b, s)
    scales = [float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
              for x, y in zip(_norm_scales(got), _norm_scales(ref_g))]
    kw = frontend(cfg, b, np.random.default_rng(5),
                  specs_mod.enc_len(cfg, ShapeConfig("d", s, b, "decode")))
    toks = batch["tokens"]
    rows = serve_mod.local_rows(torch.arange(b), ctx)
    logits = _prefill(ctx, cfg, full, toks, kw)
    with torch.no_grad():
        ref_cache = models.init_cache(cfg, b, s + 128, device="cpu",
                                      enc_len=specs_mod.enc_len(
                                          cfg, ShapeConfig("d", s, b,
                                                           "decode")))
        ref, _ = models.prefill(full, cfg, toks, ref_cache, **kw)
    return {"loss": abs(float(m["loss"]) - float(ref_m["loss"])),
            "grad_rel": _max_rel(got, ref_g), "scales": len(scales),
            "scale_rel": max(scales),
            "logits": float((logits - ref[rows]).abs().max()),
            "tokens_equal": bool(torch.equal(logits.argmax(-1),
                                             ref[rows].argmax(-1))),
            "saved": [[*sh, n] for sh, n in saved],
            "whole": [[*sh, n] for sh, n in whole],
            "b_local": b // ctx.batch_world}


def handoff_check(ctx, cfg, b: int, s: int) -> dict:
    """A stack whose S the rule keeps whole: the train step's loss and
    gradients and the prefill's logits with ``act_sharding`` on equal
    those with it off, bit for bit, and remat saves whole-S inputs.  An
    encoder-decoder's encoder keeps its S whole too: 9 frames to train,
    and ``enc_len``'s 9 to prefill at S of 36 to 39."""
    full = _params(cfg)
    batch = _batch(cfg, b, s, frames=9)
    kw = frontend(cfg, b, np.random.default_rng(5),
                  specs_mod.enc_len(cfg, ShapeConfig("d", s, b, "decode")))
    runs = []
    for act in (True, False):
        c = cfg.replace(act_sharding=act)
        m, g, saved = _sp_grads(ctx, c, full, batch, b, s)
        runs.append((m["loss"], prm.flatten(g)[0], saved,
                     _prefill(ctx, c, full, batch["tokens"], kw)))
    (l0, g0, s0, p0), (l1, g1, s1, p1) = runs
    return {"equal": bool(torch.equal(l0, l1) and torch.equal(p0, p1)
                          and all(torch.equal(x, y) for x, y in zip(g0, g1))),
            "saved": [list(sh) for sh, _ in s0],
            "saved_off": [list(sh) for sh, _ in s1]}


def world1_check(ctx, cfg, b: int, s: int) -> dict:
    """A world of one: the mesh's train step (``act_sharding`` on) and
    prefill give the mesh-less step's loss, gradients and logits bit for
    bit."""
    full = _params(cfg)
    batch = _batch(cfg, b, s)
    ref_step = make_train_step(cfg, None, TrainPlan(), AdamWConfig(),
                               device="cpu")
    l0, g0 = ref_step.grads(full, batch, with_metrics=True)
    l1, g1, _ = _sp_grads(ctx, cfg, full, batch, b, s)
    p1 = _prefill(ctx, cfg, full, batch["tokens"], {})
    with torch.no_grad():
        p0, _ = models.prefill(full, cfg, batch["tokens"], models.init_cache(
            cfg, b, s + 128, device="cpu"))
    return {"equal": bool(
        torch.equal(l0["loss"], l1["loss"]) and torch.equal(p0, p1)
        and all(torch.equal(x, y) for x, y in zip(prm.flatten(g0)[0],
                                                  prm.flatten(g1)[0])))}


def jax_sp_check(ctx, case: str) -> dict:
    """The port's sequence-parallel train and prefill steps on the JAX
    package's weights against the JAX package's own sharded gradients
    and prefill on the same mesh (``_jax_seq_ref.py``'s ``sp-*`` cases):
    the loss, every gradient leaf and the prefill's logits."""
    with open(Path(RUN_DIR, "jax_seq_ref.pkl"), "rb") as f:
        r = pickle.load(f)[case]
    cfg = CONFIGS[r["config"]]()
    full = prm.from_jax(cfg, r["weights"], device="cpu")
    want_g = prm.from_jax(cfg, r["grads"], device="cpu")
    batch = {"tokens": torch.from_numpy(r["tokens"]).long(),
             "labels": torch.from_numpy(r["labels"]).long()}
    b, s = r["tokens"].shape
    m, got, saved = _sp_grads(ctx, cfg, full, batch, b, s)
    logits = _prefill(ctx, cfg, full, batch["tokens"], {})
    rows = serve_mod.local_rows(torch.arange(b), ctx)
    want = torch.from_numpy(r["logits"])[rows]
    return {"loss": abs(float(m["loss"]) - float(r["loss"])),
            "grads": _max_diff(got, want_g),
            "grad_max": _max_diff(want_g, prm.tree_map(torch.zeros_like,
                                                       want_g)),
            "logits": float((logits - want).abs().max()),
            "tokens_equal": bool(torch.equal(logits.argmax(-1),
                                             want.argmax(-1))),
            "saved": [list(sh) for sh, _ in saved]}


def collectives_check(ctx) -> dict:
    """The sequence-parallel autograd collectives over ``model`` in f64
    against their definitions, every rank's inputs drawn from its own
    seed so each rank knows all of them: ``split_to``, ``scatter_from``
    and ``gather_from`` along S (dim 1) and ``own_rows``, forward and
    backward; and ``seq_parallel``'s rule at a few S, on and off."""
    g, n, r = ctx.model, ctx.size("model"), ctx.coord("model")

    def draw(seed: int, rows: int):
        return torch.from_numpy(np.random.default_rng(seed).normal(
            size=(2, rows, 3)))

    def run(fn, x, up):
        x = x.clone().requires_grad_(True)
        y = fn(x)
        y.backward(up)
        return y.detach(), x.grad

    def rows(t, k):
        return t[:, k * 4:(k + 1) * 4]

    errs = {}
    whole = draw(0, 4 * n)                    # alike on every rank
    y, gx = run(lambda x: parallel.split_to(x, 1, g), whole, draw(10 + r, 4))
    errs["split_to"] = max(
        float((y - rows(whole, r)).abs().max()),
        float((gx - torch.cat([draw(10 + k, 4) for k in range(n)], 1))
              .abs().max()))
    y, gx = run(lambda x: parallel.scatter_from(x, 1, g), draw(20 + r, 4 * n),
                draw(30 + r, 4))
    errs["scatter_from"] = max(
        float((y - rows(sum(draw(20 + k, 4 * n) for k in range(n)), r))
              .abs().max()),
        float((gx - torch.cat([draw(30 + k, 4) for k in range(n)], 1))
              .abs().max()))
    y, gx = run(lambda x: parallel.gather_from(x, 1, g), draw(40 + r, 4),
                draw(50 + r, 4 * n))
    errs["gather_from"] = max(
        float((y - torch.cat([draw(40 + k, 4) for k in range(n)], 1))
              .abs().max()),
        float((gx - rows(sum(draw(50 + k, 4 * n) for k in range(n)), r))
              .abs().max()))
    up = draw(60, 4 * n)
    y, gx = run(lambda x: parallel.own_rows(x, 1, g), whole, up)
    mask = torch.zeros_like(up)
    mask[:, r * 4:(r + 1) * 4] = 1
    errs["own_rows"] = max(float((y - whole).abs().max()),
                           float((gx - up * mask).abs().max()))
    on = parallel.context(ctx, act_sharding=True)
    rule = {str(s_): [on.seq_parallel(s_) is not None,
                      ctx.seq_parallel(s_) is not None]
            for s_ in (1, 2, 15, 16, 18)}
    return {"errs": errs, "rule": rule, "m": n}


def dispatch_check(ctx, cfg, b: int, s: int) -> dict:
    """The MoE layer's dropped fraction and aux loss over the mesh's
    batch axes against one device on the whole batch, with drops forced
    (a capacity factor of 0.5)."""
    from repro_torch.models.moe import moe_ffn

    cfg = cfg.replace(capacity_factor=0.5)
    p = _params(cfg)["decoder"][0]["e0"]["moe"]
    p = prm.tree_map(lambda t: t[0], p)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(b, s, cfg.d_model)).astype(np.float32))
    spec = cfg.plan()[0].pattern[0][0]
    with torch.no_grad():
        y_ref, st_ref = moe_ffn(p, x, cfg, spec)
        defs = models.model_defs(cfg)["decoder"][0]["e0"]["moe"]
        defs = prm.tree_map(lambda d: prm.P(d.shape[1:], d.axes[1:]), defs)
        from repro_torch.distributed.sharding import spec_for
        specs = prm.tree_map(lambda d: spec_for(d.axes, d.shape, ctx), defs)
        local = parallel.shard_tree(p, specs, ctx)
        local = ctx.fsdp_gather(local, defs)
        with parallel.use_mesh(ctx):
            y, st = moe_ffn(local, serve_mod.local_rows(x, ctx), cfg, spec)
    rows = serve_mod.local_rows(torch.arange(b), ctx)
    return {"y": float((y - y_ref[rows]).abs().max()),
            "dropped": abs(float(st.dropped_frac) - float(st_ref.dropped_frac)),
            "dropped_ref": float(st_ref.dropped_frac),
            "aux": abs(float(st.aux_loss) - float(st_ref.aux_loss))}


def refusal_check(ctx, what: str) -> dict:
    """The named refusal raises ValueError; returns its message.
    ``tp-hybrid``, refused until the model axis cut the hybrid and
    recurrent families, is now a step that builds (raised False)."""
    try:
        if what == "tp-hybrid":
            make_train_step(CONFIGS["hymba"](), ctx, TrainPlan(),
                            AdamWConfig())
        elif what == "local-shape":
            make_train_step(tiny().replace(d_head=264, use_pallas=True), ctx)
        elif what == "batch-split":
            make_train_step(tiny(), ctx, TrainPlan(), AdamWConfig(),
                            shape=ShapeConfig("t", 16, 3, "train"))
        elif what == "compress-no-pod":
            make_train_step(tiny(), ctx, TrainPlan(compress_grads=True),
                            AdamWConfig())
        else:
            raise KeyError(what)
    except ValueError as e:
        return {"raised": True, "message": str(e)}
    return {"raised": False, "message": ""}


CHECKS = {
    "train-tiny-f32": lambda c: train_check(c, CONFIGS["tiny"](), 4, 16,
                                            False),
    "train-tiny-int8": lambda c: train_check(c, CONFIGS["tiny"](), 4, 16,
                                             True),
    "train-tiny-micro": lambda c: train_check(c, CONFIGS["tiny"](), 4, 16,
                                              False, microbatch=2),
    "train-tiny-kv1": lambda c: train_check(c, CONFIGS["tiny-kv1"](), 4, 16,
                                            True),
    "train-arctic": lambda c: train_check(c, CONFIGS["arctic"](), 4, 16,
                                          True),
    "train-arctic-drops": lambda c: train_check(
        c, CONFIGS["arctic"]().replace(capacity_factor=0.5), 4, 16, False),
    "train-kimi": lambda c: train_check(c, CONFIGS["kimi"](), 2, 16, False),
    "train-hymba": lambda c: train_check(c, CONFIGS["hymba"](), 4, 16,
                                         False),
    "serve-tiny": lambda c: serve_check(c, CONFIGS["tiny"](), 4, 12, 6),
    "serve-arctic": lambda c: serve_check(c, CONFIGS["arctic"](), 4, 12, 6),
    "serve-hymba": lambda c: serve_check(c, CONFIGS["hymba"](), 4, 12, 6),
    # tensor parallelism over ``model`` for the hybrid, recurrent, VLM and
    # encoder-decoder smokes (hymba's 2 KV heads replicate on (1, 4),
    # where its ring's sequence is cut; qwen2-vl's likewise)
    # one step: the first is sign-like, so a second compounds f32 noise
    # that the first's gradient elements near zero turn into lr-sized moves
    "train-hymba-tp": lambda c: train_check(c, CONFIGS["hymba"](), 4, 16,
                                            False, steps=1),
    "train-hymba-whole": lambda c: train_check(
        c, CONFIGS["hymba-whole"](), 4, 16, False, steps=1),
    "train-xlstm": lambda c: train_check(c, CONFIGS["xlstm"](), 4, 16,
                                         False, steps=1),
    "train-qwen2vl": lambda c: train_check(c, CONFIGS["qwen2vl"](), 4, 16,
                                           False, steps=1),
    "train-seamless": lambda c: train_check(c, CONFIGS["seamless"](), 4, 16,
                                            False, steps=1),
    "serve-hymba-whole": lambda c: serve_check(c, CONFIGS["hymba-whole"](),
                                               4, 12, 6),
    "serve-xlstm": lambda c: serve_check(c, CONFIGS["xlstm"](), 4, 12, 6),
    "serve-qwen2vl": lambda c: serve_check(c, CONFIGS["qwen2vl"](), 4, 12,
                                           6),
    "serve-seamless": lambda c: serve_check(c, CONFIGS["seamless"](), 4, 12,
                                            6),
    # sequence-sharded rings: the GQA fallback over ``model`` (a prompt
    # past the first rank's range, so both ranks hold keys, and the
    # empty ranges of the ranks a 12-token prompt leaves empty), the
    # ring kept whole where it does not split (139 slots), ``long_*``
    # over ``data`` (a batch of one), and on (2, 2) a whole KV head under
    # query heads cut over ``model``
    "serve-tiny-kv1": lambda c: serve_check(c, CONFIGS["tiny-kv1"](), 4,
                                            136, 6),
    "serve-tiny-kv1-odd": lambda c: serve_check(c, CONFIGS["tiny-kv1"](),
                                                4, 11, 6),
    "serve-tiny-long": lambda c: serve_check(c, CONFIGS["tiny"](), 1, 140,
                                             6, long=True),
    "serve-kv1-long": lambda c: serve_check(c, CONFIGS["tiny-kv1"](), 1,
                                            140, 6, long=True),
    "serve-hymba-long": lambda c: serve_check(c, CONFIGS["hymba"](), 1, 40,
                                              6, long=True),
    "serve-danube-long": lambda c: serve_check(c, CONFIGS["danube"](), 1,
                                               40, 6, long=True),
    "dispatch-arctic": lambda c: dispatch_check(c, CONFIGS["arctic"](), 4,
                                                24),
    "dispatch-arctic-rows": lambda c: dispatch_check(
        c, CONFIGS["arctic"](), 2, 256),
    "jax-ref-gqa": lambda c: jax_ref_check(c, "gqa"),
    "jax-ref-long": lambda c: jax_ref_check(c, "long"),
    "jax-ref-hymba": lambda c: jax_ref_check(c, "hymba"),
    "jax-ref-seamless": lambda c: jax_ref_check(c, "seamless"),
    "refuse-tp-hybrid": lambda c: refusal_check(c, "tp-hybrid"),
    "refuse-local-shape": lambda c: refusal_check(c, "local-shape"),
    "refuse-batch-split": lambda c: refusal_check(c, "batch-split"),
    "refuse-compress-no-pod": lambda c: refusal_check(c, "compress-no-pod"),
    "train-tiny-compress": lambda c: train_check(c, CONFIGS["tiny"](), 4, 16,
                                                 False, compress=True),
    # a cross attention K/V cut along its encoder axis (``long_*``: 10
    # frames, 5 a rank) beside the ring cut over ``data``
    "serve-seamless-long": lambda c: serve_check(c, CONFIGS["seamless"](), 1,
                                                 40, 6, long=True),
    "jax-ref-seamless-long": lambda c: jax_ref_check(c, "seamless-long"),
    "world1-tiny": lambda c: world1_check(c, CONFIGS["tiny"](), 4, 16),
    "sp-collectives": collectives_check,
}
# sequence parallelism over ``model`` (tests/test_torch_sequence_parallel.py)
SP_CONFIGS = ("tiny", "arctic", "hymba", "hymba-whole", "xlstm", "qwen2vl",
              "seamless")
for _name in SP_CONFIGS:
    CHECKS[f"sp-{_name}"] = (lambda n: lambda c: sp_check(
        c, CONFIGS[n](), 4, 16))(_name)
    # 37 positions: no model axis of 2 or 4 divides them
    CHECKS[f"handoff-{_name}"] = (lambda n: lambda c: handoff_check(
        c, CONFIGS[n](), 4, 37))(_name)
for _case in ("sp-tiny-2", "sp-tiny-4", "sp-hymba-2", "sp-hymba-4"):
    CHECKS[f"jax-{_case}"] = (lambda k: lambda c: jax_sp_check(c, k))(_case)


# ---------------------------------------------------------------------------
# Checkpoints of a sharded train state
# ---------------------------------------------------------------------------

INT8 = AdamWConfig(lr=1e-3, warmup_steps=0, int8_moments=True)


def _int8_step(ctx, cfg, b: int = 4, s: int = 16):
    return make_train_step(cfg, ctx, TrainPlan(int8_moments=True), INT8,
                           shape=ShapeConfig("t", s, b, "train"))


def _fresh(ctx, cfg, step):
    """This rank's (params, opt_state) of ``step`` from seed 0's weights
    and zero moments."""
    p = parallel.shard_tree(_params(cfg), step.shardings["params"], ctx)
    return p, init_opt_state(p, INT8, ctx, cfg=cfg)


def _trained(ctx, cfg, steps: int = 1):
    """(step, state) after ``steps`` int8 steps on the mesh."""
    step = _int8_step(ctx, cfg)
    params, opt = _fresh(ctx, cfg, step)
    for i in range(steps):
        params, opt, _ = step(params, opt, _batch(cfg, 4, 16, seed=i))
    return step, (params, opt)


def _zeros(tree):
    leaves, treedef = prm.flatten(tree)
    return prm.unflatten(treedef, [torch.zeros_like(t) for t in leaves])


def _bit_equal(a, b) -> bool:
    la, lb = prm.flatten(a)[0], prm.flatten(b)[0]
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


def _whole_scales(specs, state) -> list:
    """The shapes of this rank's q and scales of every int8 moment whose
    scales it holds whole while its q is cut on the last dim."""
    def q8s(tree):
        return prm.flatten(tree.m, is_leaf=lambda x: isinstance(x, Q8))[0]
    return [[list(q.q.shape), list(q.scale.shape)]
            for sp, q in zip(q8s(specs[1]), q8s(state[1]))
            if sp.q and sp.q[-1] is not None and sp.scale[-1] is None]


def ckpt_save_check(ctx) -> dict:
    """tiny-agent's int8 state after one step on this mesh saved (async)
    by ``step.shardings["state"]`` into ``ckpt/``; rank 0 also writes the
    tree gathered (``gather_tree``) to ``ckpt_whole.pt`` for the checks
    that restore it elsewhere.  Restored onto the same mesh: bit-equal
    to the state saved; restored whole (no shardings) and cut by the
    specs: bit-equal to it too, which no gather decides."""
    step, state = _trained(ctx, tiny())
    specs = step.shardings["state"]
    mgr = CheckpointManager(Path(RUN_DIR, "ckpt"),
                            shardings=(specs, ctx))
    mgr.save(1, state, meta={"data_step": 1}, blocking=False)
    mgr.wait()
    whole = parallel.gather_tree(state, specs, ctx)
    if dist.get_rank() == 0:
        torch.save(prm.flatten(whole)[0], Path(RUN_DIR, "ckpt_whole.pt"))
    back, meta = mgr.restore(1, _zeros(state))
    plain, _ = CheckpointManager(Path(RUN_DIR, "ckpt")).restore(
        1, _zeros(whole))
    dist.barrier()
    return {"same": _bit_equal(back, state), "whole": _bit_equal(plain, whole),
            "recut": _bit_equal(parallel.shard_tree(plain, specs, ctx), state),
            "latest": mgr.latest_step(), "step": meta["step"],
            "whole_scales": _whole_scales(specs, state)}


def ckpt_restore_check(ctx) -> dict:
    """``ckpt-save``'s checkpoint (saved on (2, 1)) restored onto this
    mesh by its step's held specs: every leaf bit-equal to the whole tree
    cut by them."""
    cfg = tiny()
    step = _int8_step(ctx, cfg)
    specs = step.shardings["state"]
    got, _ = CheckpointManager(Path(RUN_DIR, "ckpt")).restore(
        1, _fresh(ctx, cfg, step), shardings=(specs, ctx))
    whole = prm.unflatten(prm.flatten(got)[1],
                          torch.load(Path(RUN_DIR, "ckpt_whole.pt")))
    return {"equal": _bit_equal(got, parallel.shard_tree(whole, specs, ctx)),
            "leaves": len(prm.flatten(got)[0])}


def ckpt_scales_check(ctx) -> dict:
    """The llama3-405b smoke's int8 state after a step on this mesh,
    saved and restored by the held specs: every leaf bit-equal (its
    (2, 64, 192) leaves, 96 columns a rank on (1, 2), keep both blocks'
    scales), a restore by ``opt_pspecs`` (the reference's) raises, and a
    step from the restored state equals one from the state saved, bit
    for bit."""
    cfg = f32(get_smoke("llama3-405b"))
    step, state = _trained(ctx, cfg)
    specs = step.shardings["state"]
    mgr = CheckpointManager(Path(RUN_DIR, "ckpt-scales"),
                            shardings=(specs, ctx))
    mgr.save(1, state)
    got, _ = mgr.restore(1, _zeros(state))
    out = {"same": _bit_equal(got, state),
           "whole_scales": _whole_scales(specs, got)}
    try:
        mgr.restore(1, _zeros(state), shardings=(
            (step.shardings["params"], step.shardings["opt"]), ctx))
        out["opt_specs_raise"] = ""
    except ValueError as e:
        out["opt_specs_raise"] = str(e)
    batch = _batch(cfg, 4, 16, seed=7)
    p1, o1, m1 = step(*state, batch)
    p2, o2, m2 = step(*got, batch)
    out["step_equal"] = _bit_equal((p1, o1), (p2, o2)) and bool(
        torch.equal(m1["loss"], m2["loss"]))
    return out


def _supervised(ctx, sub: str, fail_at=()) -> tuple:
    """tiny-agent's int8 train step on the mesh under ``TrainSupervisor``,
    12 steps of B 4 x S 16, checkpoints every 4 (async) by the step's
    held specs, failures injected on every rank at ``fail_at``: (state,
    loss by step, restarts).  ``compress_grads`` stays off: its error
    feedback is the step's, not the state's."""
    cfg = tiny()
    acfg = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=12,
                       int8_moments=True)
    step_fn = make_train_step(cfg, ctx, TrainPlan(int8_moments=True), acfg,
                              shape=ShapeConfig("t", 16, 4, "train"))
    params = parallel.shard_tree(models.init(
        cfg, torch.Generator().manual_seed(0), device="cpu"),
        step_fn.shardings["params"], ctx)
    pending = set(fail_at)
    losses = {}

    def one(state, batch, step):
        if step in pending:
            pending.discard(step)
            raise SimulatedFailure(f"chaos at {step}")
        p, o, m = step_fn(*state, batch)
        losses[step] = m["loss"].item()
        return (p, o)

    where = "x".join(str(n) for n in ctx.sizes.values())
    mgr = CheckpointManager(Path(RUN_DIR, f"{sub}-{where}"), keep=2,
                            shardings=(step_fn.shardings["state"], ctx))
    sup = TrainSupervisor(mgr, SupervisorConfig(ckpt_every=4))
    state = sup.run(state=(params, init_opt_state(params, acfg, ctx,
                                                  cfg=cfg)),
                    pipeline=TokenPipeline(DataConfig(
                        vocab=cfg.vocab, seq_len=16, global_batch=4, seed=5)),
                    step_fn=one, total_steps=12)
    return state, losses, sup.restarts


def supervised_check(ctx) -> dict:
    """A supervised sharded run with failures mid-interval (steps 6 and
    9, checkpoints every 4) against the uninterrupted run: restarts, the
    losses by step and every final shard."""
    ref, ref_losses, _ = _supervised(ctx, "sup-ref")
    got, losses, restarts = _supervised(ctx, "sup-crashy", (6, 9))
    return {"restarts": restarts, "losses_equal": losses == ref_losses,
            "steps": len(losses), "equal": _bit_equal(got, ref)}


def unsharded_save_check(ctx) -> dict:
    """``save`` without shardings in a world of more than one rank
    raises, and writes nothing."""
    d = Path(RUN_DIR, f"refused-{dist.get_rank()}")
    try:
        CheckpointManager(d).save(1, {"w": torch.ones(4)})
    except ValueError as e:
        return {"raised": True, "message": str(e),
                "written": [p.name for p in d.iterdir()]}
    return {"raised": False, "message": "", "written": []}


def _bits(t) -> np.ndarray:
    """A tensor's bits as unsigned integers of its width (numpy)."""
    t = t.detach().cpu().contiguous()
    n = t.element_size()
    signed = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(signed[n]).numpy().view(f"u{n}")


def jax_ckpt_check(ctx, key: str) -> dict:
    """The JAX package's checkpoint (``_jax_seq_ref.py``'s ``ckpt``: bf16
    params and int8 moments after an update, of tiny-agent or the
    llama3-405b smoke, ``JAX_CKPT``) restored
    onto this mesh by the held specs, every leaf's bits against the
    ``addressable_shards`` of the JAX package's own ``restore(...,
    shardings)`` on the same mesh; a leaf whose held spec is not the
    reference's (block scales held whole) against the reference's whole
    leaf cut by the held spec.  On (1, 2) the ranks then save what they
    restored into ``port_ckpt/`` for the test to restore in JAX."""
    with open(Path(RUN_DIR, "jax_seq_ref.pkl"), "rb") as f:
        r = pickle.load(f)["ckpt"][key]
    cfg = JAX_CKPT[key]()
    step = _int8_step(ctx, cfg)
    specs = step.shardings["state"]
    got, _ = CheckpointManager(r["dir"]).restore(
        r["step"], _fresh(ctx, cfg, step), shardings=(specs, ctx))
    coord = ",".join(str(ctx.coords[a]) for a in ("data", "model"))
    mesh = "x".join(str(ctx.sizes[a]) for a in ("data", "model"))
    ref = r["shards"][mesh]
    held = prm.flatten(specs, is_leaf=is_spec)[0]
    same, whole = 0, 0
    bad = []
    for i, (t, spec) in enumerate(zip(prm.flatten(got)[0], held)):
        if tuple(spec) == tuple(ref["specs"][i]):
            want = ref["bits"][i][coord]
            same += 1
        else:
            w = torch.from_numpy(r["whole"][i])
            want = parallel.shard_leaf(w, spec, ctx).contiguous().numpy()
            whole += 1
        if want.shape != tuple(t.shape) or not np.array_equal(_bits(t),
                                                                want):
            bad.append(i)
    out = {"bad": bad, "leaves": same + whole, "held_whole": whole}
    if ctx.sizes.get("model", 1) > 1:
        CheckpointManager(Path(RUN_DIR, "port_ckpt", key),
                          shardings=(specs, ctx)).save(r["step"], got)
    return out


# ``_jax_seq_ref.CKPT_CONFIGS``
JAX_CKPT = {"tiny": lambda: get_config("tiny-agent"),
            "llama": lambda: get_smoke("llama3-405b")}
CKPT = {"ckpt-save": ckpt_save_check, "ckpt-restore": ckpt_restore_check,
        "ckpt-scales": ckpt_scales_check, "ckpt-supervised": supervised_check,
        "ckpt-refuse-save": unsharded_save_check,
        "ckpt-jax-tiny": lambda c: jax_ckpt_check(c, "tiny"),
        "ckpt-jax-llama": lambda c: jax_ckpt_check(c, "llama")}
CHECKS.update(CKPT)
# each checkpoint check's own limit, seconds: a rank that restores while
# another is in a collective would hang, so a stuck check fails alone
TIMEOUTS = dict.fromkeys(CKPT, 240)


def psum_inputs(step: int, rank: int) -> dict:
    """The gradient tree rank ``rank`` reduces at ``step`` (numpy f32; the
    ``bf16`` leaf's values are bf16 numbers)."""
    rng = np.random.default_rng(1000 * step + rank)
    half = rng.normal(size=(6, 5)).astype(np.float32)
    half = torch.from_numpy(half).to(torch.bfloat16).float().numpy()
    return {"a": rng.normal(size=(16,)).astype(np.float32) * (rank + 1),
            "b": [rng.normal(size=(8, 12)).astype(np.float32) * 1e-3,
                  np.zeros((3,), np.float32)],
            "bf16": half}


def psum_check(ctx, steps: int = 3) -> dict:
    """``compressed_psum`` over the ``pod`` axis for ``steps`` steps, the
    error feedback carried: each step's mean and residuals as lists."""
    from repro_torch.distributed.collectives import compressed_psum

    group, rank = ctx.group("pod"), ctx.coord("pod")
    ef, out = None, []
    for step in range(steps):
        g = psum_inputs(step, rank)
        g = prm.tree_map(torch.from_numpy, g)
        g["bf16"] = g["bf16"].to(torch.bfloat16)
        mean, ef = compressed_psum(g, ef, group)
        out.append({"mean": [t.float().tolist() for t in
                             prm.flatten(mean)[0]],
                    "ef": [t.tolist() for t in prm.flatten(ef)[0]],
                    "dtypes": [str(t.dtype) for t in prm.flatten(mean)[0]]})
    return {"steps": out}


CHECKS["psum"] = psum_check


def _axes(shape) -> tuple:
    return {1: ("pod",), 2: ("data", "model"),
            3: ("pod", "data", "model")}[len(shape)]


# the spawn's directory, where a check finds the files the test put there
RUN_DIR = "."


def _rank(rank: int, world: int, tmp: str, plan: list) -> None:
    global RUN_DIR
    RUN_DIR = tmp
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            world_size=world, rank=rank)
    out: dict = {}
    try:
        for shape, names in plan:
            mesh = make_mesh(tuple(shape), _axes(shape), device_type="cpu")
            ctx = parallel.MeshContext(mesh)
            for name in names:
                key = f"{tuple(shape)}:{name}"
                watch = None
                if name in TIMEOUTS:
                    watch = threading.Timer(TIMEOUTS[name], _give_up,
                                            (out, key, rank, tmp,
                                             TIMEOUTS[name]))
                    watch.start()
                try:
                    out[key] = CHECKS[name](ctx)
                except Exception:
                    out[key] = {"error": traceback.format_exc()[-3000:]}
                finally:
                    if watch is not None:
                        watch.cancel()
    finally:
        Path(tmp, f"rank{rank}.json").write_text(json.dumps(out))
        dist.destroy_process_group()


def _give_up(out: dict, key: str, rank: int, tmp: str, seconds) -> None:
    """A check past its limit: record it and end the rank, whose results
    so far the parent reads."""
    out[key] = {"error": f"timed out after {seconds} s"}
    Path(tmp, f"rank{rank}.json").write_text(json.dumps(out))
    os._exit(0)


def spawn(world: int, plan: list, tmp) -> list[dict]:
    """Run ``plan`` ([(mesh shape, [check names])]) in ``world`` gloo
    ranks; the per-rank results."""
    import torch.multiprocessing as mp

    mp.start_processes(_rank, args=(world, str(tmp), plan), nprocs=world,
                       start_method="spawn")
    return [json.loads(Path(tmp, f"rank{r}.json").read_text())
            for r in range(world)]

