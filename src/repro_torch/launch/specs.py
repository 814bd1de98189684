"""Abstract input specs (port of ``repro/launch/specs.py``).

``input_specs(cfg, shape)`` returns meta-device tensors for every model
input of an (architecture x input-shape) cell: the right shapes and
dtypes, no memory.  ``input_pspecs`` returns the matching PartitionSpec
tree for a mesh.  The VLM cell receives precomputed patch embeddings
(``vision_embeds``), the audio cell precomputed frame embeddings
(``frames``), as in the reference.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import transformer
from repro_torch.models.params import torch_dtype

VLM_PATCHES = 256          # stub patch-embedding count (qwen2-vl)
AUDIO_FRAMES = 1024        # stub speech-frame count (seamless)
DECODE_CACHE_PAD = 128     # ring slack so one decode step never wraps


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _n_patches(seq_len: int) -> int:
    return min(VLM_PATCHES, seq_len // 2)


def _n_frames(seq_len: int) -> int:
    return min(AUDIO_FRAMES, max(seq_len // 4, 8))


def decode_context(shape: ShapeConfig) -> int:
    return shape.seq_len + DECODE_CACHE_PAD


def enc_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    return _n_frames(shape.seq_len) if cfg.is_encdec else 0


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, Any]:
    """Meta-device inputs of the step this cell runs."""
    b, s = shape.global_batch, shape.seq_len
    dt = torch_dtype(cfg.dtype)
    enc = enc_len(cfg, shape)

    if shape.kind == "train":
        batch: dict[str, Any] = {"tokens": _meta((b, s), torch.int32),
                                 "labels": _meta((b, s), torch.int32)}
        if cfg.frontend == "patch":
            batch["vision_embeds"] = _meta((b, _n_patches(s), cfg.d_model),
                                           dt)
        if cfg.is_encdec:
            batch["frames"] = _meta((b, enc, cfg.d_model), dt)
        return {"batch": batch}

    if shape.kind == "prefill":
        cache = transformer.init_cache(cfg, b, s, device="meta", enc_len=enc)
        out = {"tokens": _meta((b, s), torch.int32), "cache": cache}
        if cfg.frontend == "patch":
            out["vision_embeds"] = _meta((b, _n_patches(s), cfg.d_model), dt)
        if cfg.is_encdec:
            out["frames"] = _meta((b, enc, cfg.d_model), dt)
        return out

    if shape.kind != "decode":
        raise ValueError(f"unknown shape kind {shape.kind!r}")
    cache = transformer.init_cache(cfg, b, decode_context(shape),
                                   device="meta", enc_len=enc)
    return {"tokens": _meta((b, 1), torch.int32), "cache": cache}


def input_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                 rules: shd.ShardingRules = shd.DEFAULT_RULES):
    """PartitionSpec tree matching ``input_specs``."""
    b = shape.global_batch
    bspec = shd.batch_pspec(mesh, rules, batch_size=b)
    b_entry = bspec[0] if len(bspec) else None
    enc = enc_len(cfg, shape)

    def bleading(ndim):
        return shd.PartitionSpec(b_entry, *([None] * (ndim - 1)))

    if shape.kind == "train":
        batch = {"tokens": bleading(2), "labels": bleading(2)}
        if cfg.frontend == "patch":
            batch["vision_embeds"] = bleading(3)
        if cfg.is_encdec:
            batch["frames"] = bleading(3)
        return {"batch": batch}

    if shape.kind == "prefill":
        cache = shd.cache_pspecs(cfg, b, shape.seq_len, mesh, enc_len=enc,
                                 rules=rules)
        out = {"tokens": bleading(2), "cache": cache}
        if cfg.frontend == "patch":
            out["vision_embeds"] = bleading(3)
        if cfg.is_encdec:
            out["frames"] = bleading(3)
        return out

    # long-context decode (batch too small to shard): sequence-shard the
    # KV cache instead
    cache = shd.cache_pspecs(cfg, b, decode_context(shape), mesh,
                             enc_len=enc, rules=rules,
                             shard_seq=shape.name.startswith("long"))
    return {"tokens": bleading(2), "cache": cache}
