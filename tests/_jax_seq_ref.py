"""The JAX package's own serve steps over a sequence-sharded ring cache,
on a forced four-device CPU mesh: the reference the port's gloo ranks
are held to (``tests/test_torch_launch.py``).

Run as a script, in a process of its own, since the device count is
fixed when JAX starts:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/_jax_seq_ref.py OUT.pkl

It writes a pickle of numpy values: for each case (``CASES``) its
config's name in the port's test ranks (``_torch_ranks.CONFIGS``), its
f32 weights (seed 0, the attention projections at their true fan-in as
the port's ``rescale_to_true_fan_in`` sets them, ROADMAP §C, reference
fault 5), the prompt, an encoder-decoder's frames, the greedy tokens fed
and the logits of the prefill and of every decode step.  ``gqa`` on
``(1, 4)``: tiny-agent's 2 KV heads do not divide the model axis, so
``cache_pspecs`` cuts the ring's sequence over ``model`` (the GQA
fallback).  ``long`` on ``(2, 1)``: a ``long_*`` decode shape, a batch of
one, so the ring's sequence is cut over ``data`` (``shard_seq``); its
prefill step has no such layout, so the prefill's cache is put to the
decode step's shardings first.  ``hymba`` and ``seamless`` on ``(1, 2)``:
tensor parallelism over ``model`` of the hybrid smoke (its in_proj's x |
z columns, out_proj's rows, heads and MLP cut) and of the
encoder-decoder smoke with frames (the encoder's and the cross
attention's heads cut, and the cross K/V by heads).  ``seamless-long``
on ``(2, 1)``: the encoder-decoder smoke under a ``long_*`` decode shape,
a batch of one, whose cache spec cuts the ring and the cross K/V's
encoder axis (10 frames) over ``data``.

The ``sp-*`` cases (``SP_CASES``) are the JAX package's sharded train
and prefill steps with ``act_sharding`` on, whose ``_constrain_act``
cuts the layer-boundary activations' S over ``model``: the loss and
gradients of ``loss_fn`` jitted on the mesh with the train step's
shardings, and the prefill step's logits, for tiny-agent and the hymba
smoke on ``(1, 2)`` and ``(1, 4)``; they are written to a file of their
own, so each test runs only the cases it reads:

    ... python tests/_jax_seq_ref.py OUT.pkl sp-tiny-2 sp-hymba-4 ...

The ``ckpt`` case writes checkpoints with the JAX package's
``CheckpointManager`` into ``jax_ckpt/`` beside the pickle: bf16 params
(seed 0) and int8 AdamW moments after one update on gradients from seed
3, of tiny-agent and of the llama3-405b smoke (``CKPT_CONFIGS``).  It restores it onto (1, 2) and (2, 1) with
``NamedSharding``s of ``param_pspecs`` / ``opt_pspecs`` and records, for
each mesh, each leaf's spec and the bits of its ``addressable_shards`` by
mesh coordinate, and each whole leaf's bits: what the port's ranks
restore the same checkpoint against.
"""
from __future__ import annotations

import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding

from repro import models
from repro.configs import get_config, get_smoke
from repro.configs.base import ShapeConfig
from repro.launch import specs as specs_mod
from repro.launch.mesh import make_mesh
from repro.launch.serve import make_prefill_step, make_serve_step

# (mesh shape, decode shape name, batch, prompt, decode steps, config)
CASES = {"gqa": ((1, 4), "d", 2, 40, 6, "tiny"),
         "long": ((2, 1), "long_d", 1, 140, 6, "tiny"),
         "hymba": ((1, 2), "d", 2, 12, 6, "hymba"),
         "seamless": ((1, 2), "d", 2, 12, 6, "seamless"),
         "seamless-long": ((2, 1), "long_d", 1, 40, 6, "seamless")}
# (mesh shape, batch, sequence, config)
SP_CASES = {"sp-tiny-2": ((1, 2), 2, 16, "tiny"),
            "sp-tiny-4": ((1, 4), 2, 16, "tiny"),
            "sp-hymba-2": ((1, 2), 2, 16, "hymba"),
            "sp-hymba-4": ((1, 4), 2, 16, "hymba")}
# each config by its key in ``_torch_ranks.CONFIGS``, in f32
CONFIGS = {"tiny": lambda: get_config("tiny-agent"),
           "hymba": lambda: get_smoke("hymba-1.5b"),
           "seamless": lambda: get_smoke("seamless-m4t-large-v2")}


def prompt(case: str, vocab: int) -> np.ndarray:
    _, _, b, s, _, _ = CASES[case]
    return np.random.default_rng(7).integers(0, vocab, (b, s)).astype(
        np.int32)


def run(case: str) -> dict:
    mesh_shape, name, b, s, steps, key = CASES[case]
    cfg = CONFIGS[key]().replace(dtype="float32")
    tree = true_fan_in(jax.device_get(models.init(cfg, jax.random.key(0))))
    mesh = make_mesh(mesh_shape, ("data", "model"))
    toks = prompt(case, cfg.vocab)
    d_shape = ShapeConfig(name, s, b, "decode")
    enc = specs_mod._n_frames(s) if cfg.is_encdec else 0
    extra = []
    if cfg.is_encdec:
        extra = [np.random.default_rng(8).normal(
            size=(b, enc, cfg.d_model)).astype(np.float32)]

    def put(x, spec):
        return jax.tree.map(
            lambda a, p: jax.device_put(a, NamedSharding(mesh, p)), x, spec)

    with jax.set_mesh(mesh):
        pre, pspecs = make_prefill_step(cfg, mesh,
                                        ShapeConfig("p", s, b, "prefill"))
        dec, dspecs = make_serve_step(cfg, mesh, d_shape)
        params = put(tree, pspecs["params"])
        cache = models.init_cache(cfg, b, specs_mod.decode_context(d_shape),
                                  enc_len=enc)
        logits, cache = pre(params, put(toks, pspecs["batch"]),
                            put(cache, pspecs["cache"]),
                            *(put(x, pspecs["batch"]) for x in extra))
        # the decode step's layout: for ``long_*`` the ring's sequence is
        # cut over ``data``, which the prefill's spec does not do
        cache = put(cache, dspecs["cache"])
        out, fed = [np.asarray(logits)], []
        for _ in range(steps):
            nxt = np.asarray(out[-1]).argmax(-1)[:, None].astype(np.int32)
            fed.append(nxt)
            logits, cache = dec(params, put(nxt, dspecs["batch"]), cache)
            out.append(np.asarray(logits))
    res = {"config": key, "weights": tree, "name": name, "batch": b,
           "prompt": toks, "fed": fed, "logits": out,
           "cache_spec": repr(dspecs["cache"]["segments"][0]["e0"]["kv"])}
    if extra:
        res["extra"] = extra[0]
    return res


def run_sp(case: str) -> dict:
    """One ``SP_CASES`` case: the sharded loss and gradients, and the
    prefill step's logits, on the mesh."""
    from repro.launch.train import make_train_step
    from repro.models import transformer

    mesh_shape, b, s, key = SP_CASES[case]
    cfg = CONFIGS[key]().replace(dtype="float32")
    assert cfg.act_sharding
    tree = true_fan_in(jax.device_get(models.init(cfg, jax.random.key(0))))
    mesh = make_mesh(mesh_shape, ("data", "model"))
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    labels[0, -5:] = -1

    def put(x, spec):
        return jax.tree.map(
            lambda a, p: jax.device_put(a, NamedSharding(mesh, p)), x, spec)

    with jax.set_mesh(mesh):
        _, specs = make_train_step(cfg, mesh,
                                   shape=ShapeConfig("t", s, b, "train"))
        params = put(tree, specs["params"])
        batch = {k: jax.device_put(v, NamedSharding(mesh, specs["batch"]))
                 for k, v in (("tokens", toks), ("labels", labels))}
        grad_fn = jax.jit(jax.value_and_grad(
            lambda p, bt: transformer.loss_fn(p, cfg, bt)[0]))
        loss, grads = grad_fn(params, batch)
        pre, pspecs = make_prefill_step(cfg, mesh,
                                        ShapeConfig("p", s, b, "prefill"))
        cache = models.init_cache(cfg, b, s)
        logits, _ = pre(put(tree, pspecs["params"]),
                        put(toks, pspecs["batch"]),
                        put(cache, pspecs["cache"]))
    return {"config": key, "weights": tree, "tokens": toks,
            "labels": labels, "loss": float(loss),
            "grads": jax.device_get(grads), "logits": np.asarray(logits)}


def bits(a) -> np.ndarray:
    """An array's bits as unsigned integers of its width."""
    a = np.array(np.asarray(a), order="C")
    return a.view(f"u{a.dtype.itemsize}")


# the ``ckpt`` case's configs, bf16: tiny-agent, and the llama3-405b
# smoke, whose (2, 64, 192) leaves' block scales ``opt_pspecs`` cuts on
# (1, 2) while the port's ranks hold them whole
CKPT_CONFIGS = {"tiny": lambda: get_config("tiny-agent"),
                "llama": lambda: get_smoke("llama3-405b")}


def run_ckpt(out_dir: Path) -> dict:
    return {key: ckpt_case(key, out_dir / "jax_ckpt" / key)
            for key in CKPT_CONFIGS}


def ckpt_case(key: str, directory: Path) -> dict:
    from jax.sharding import PartitionSpec

    from repro.checkpoint import CheckpointManager
    from repro.distributed.sharding import param_pspecs
    from repro.launch.train import opt_pspecs
    from repro.optim.adamw import AdamWConfig, adamw_init, adamw_update

    cfg = CKPT_CONFIGS[key]()
    acfg = AdamWConfig(lr=1e-3, warmup_steps=0, int8_moments=True)
    # jitted: op by op the update alone took 10 s
    params = jax.jit(lambda k: models.init(cfg, k))(jax.random.key(0))
    rng = np.random.default_rng(3)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(
        size=p.shape).astype(np.float32)).astype(p.dtype), params)
    params, opt, _ = jax.jit(lambda g, p: adamw_update(
        g, adamw_init(p, acfg), p, acfg))(grads, params)
    state = jax.device_get((params, opt))
    mgr = CheckpointManager(directory)
    mgr.save(3, state)
    is_spec = lambda x: isinstance(x, PartitionSpec)  # noqa: E731
    shards = {}
    for shape in ((1, 2), (2, 1)):
        mesh = make_mesh(shape, ("data", "model"))
        specs = (param_pspecs(cfg, mesh), opt_pspecs(cfg, mesh, acfg))
        tree, _ = mgr.restore(3, state, jax.tree.map(
            lambda p: NamedSharding(mesh, p), specs, is_leaf=is_spec))
        pos = {d: ",".join(map(str, i))
               for i, d in np.ndenumerate(mesh.devices)}
        shards["x".join(map(str, shape))] = {
            "specs": [tuple(p) for p in jax.tree.leaves(specs,
                                                        is_leaf=is_spec)],
            "bits": [{pos[sh.device]: bits(sh.data)
                      for sh in leaf.addressable_shards}
                     for leaf in jax.tree.leaves(tree)]}
    return {"dir": str(directory), "step": 3,
            "whole": [bits(a) for a in jax.tree.leaves(state)],
            "shards": shards}


def true_fan_in(tree):
    """The weights with wq, wk and wv (..., d, heads, dh) drawn at
    1/sqrt(d) and wo (..., heads, dh, d) at 1/sqrt(heads * dh)."""
    if isinstance(tree, list):
        return [true_fan_in(x) for x in tree]
    if not isinstance(tree, dict):
        return tree
    out = {}
    for key, x in tree.items():
        if key in ("wq", "wk", "wv"):
            x = x * np.float32(np.sqrt(x.shape[-2] / x.shape[-3]))
        elif key == "wo":
            x = x * np.float32(np.sqrt(1 / x.shape[-3]))
        out[key] = true_fan_in(x)
    return out


def main(path: str, cases: list) -> None:
    out = {case: run_ckpt(Path(path).parent) if case == "ckpt" else
           run_sp(case) if case in SP_CASES else run(case)
           for case in cases or CASES}
    with open(path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
