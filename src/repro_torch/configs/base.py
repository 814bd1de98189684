"""Model / shape / mesh configuration dataclasses.

Every assigned architecture is expressed as a ``ModelConfig`` plus a
``stack plan`` — an ordered list of (possibly nested) block segments that
``models/transformer.py`` compiles into ``jax.lax.scan`` stacks.  The plan
keeps compile time O(#distinct block types) instead of O(#layers), which is
what makes 126-layer dry-runs tractable, and lets heterogeneous stacks
(gemma3's 5 local : 1 global, hymba's 3 global islands, xLSTM's 7 mLSTM :
1 sLSTM) stay scan-friendly.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

# ---------------------------------------------------------------------------
# Block specs
# ---------------------------------------------------------------------------

FULL_ATTENTION = -1  # sentinel window meaning "no sliding window"


@dataclass(frozen=True)
class BlockSpec:
    """One block *type* in the stack plan.

    kind:
      'attn'    — attention + (dense MLP | MoE) residual block
      'hymba'   — parallel attention + mamba heads, fused output
      'mlstm'   — xLSTM matrix-memory block (has its own up-proj; no MLP)
      'slstm'   — xLSTM scalar-memory block (+ small gated FFN)
      'enc'     — bidirectional encoder block (attn + MLP)
      'dec'     — decoder block w/ cross attention (self + cross + MLP)
    """

    kind: str = "attn"
    window: int = FULL_ATTENTION          # sliding window size; -1 = full
    moe: bool = False                     # MoE FFN instead of dense
    dense_residual: bool = False          # arctic: dense FFN in parallel w/ MoE
    n_shared_experts: int = 0             # kimi: always-on shared expert(s)
    parallel_block: bool = False          # cohere: attn & MLP in parallel
    cross_attention: bool = False         # decoder blocks

    def cache_kinds(self) -> tuple[str, ...]:
        """Which decode-state tensors this block carries."""
        if self.kind in ("attn", "enc", "dec"):
            kinds = ("kv",)
            if self.cross_attention:
                kinds = ("kv", "cross_kv")
            return kinds
        if self.kind == "hymba":
            return ("kv", "ssm")
        if self.kind == "mlstm":
            return ("mlstm",)
        if self.kind == "slstm":
            return ("slstm",)
        raise ValueError(self.kind)


@dataclass(frozen=True)
class Segment:
    """A run of layers in the model.

    pattern: tuple of (BlockSpec, n_inner) executed in order; the whole
    pattern repeats ``repeat`` times.  A plain homogeneous stack is
    ``Segment(((spec, n),), repeat=1)``.

    Parameters for each pattern element are stacked with leading dims
    ``(repeat, n_inner, ...)`` and executed with nested ``lax.scan``.
    """

    pattern: tuple[tuple[BlockSpec, int], ...]
    repeat: int = 1

    @property
    def n_layers(self) -> int:
        return self.repeat * sum(n for _, n in self.pattern)


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | hybrid | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                  # 0 -> d_model // n_heads

    # attention structure
    window: int = FULL_ATTENTION     # default sliding window for all layers
    local_global_ratio: int = 0      # gemma3: N local then 1 global
    global_layers: tuple[int, ...] = ()   # hymba: explicit global layer ids
    rope_theta: float = 500_000.0
    mrope_sections: tuple[int, ...] = ()  # qwen2-vl M-RoPE (sums to d_head//2)
    parallel_block: bool = False     # cohere
    qk_norm: bool = False
    logit_softcap: float = 0.0       # gemma-style final-logit softcap

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    first_k_dense: int = 0           # kimi: first k layers use dense FFN
    dense_residual: bool = False     # arctic
    capacity_factor: float = 1.25

    # SSM / hybrid / xLSTM
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    mlstm_ratio: int = 0             # xlstm: k mLSTM blocks then 1 sLSTM

    # enc-dec
    enc_layers: int = 0              # >0 => encoder-decoder model
    frontend: str = "none"           # 'patch' (vlm) | 'frames' (audio) | none

    # numerics / structure
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # implementation knobs (hillclimbing surface)
    attn_chunk: int = 1024           # query-chunked attention block
    use_pallas: bool = False         # swap pure-jnp attention for kernels
    remat: bool = True
    scan_layers: bool = True
    act_sharding: bool = True        # layer-boundary sharding constraints
                                     # (batch over data, seq over model)
    loss_chunk: int = 2048           # seq-chunked unembed+xent (0 = off);
                                     # avoids materializing (B, S, V)
    unroll_ssm: bool = False         # flatten recurrent chunk scans
                                     # (cost-analysis only; compile-heavy)

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    # -- derived -----------------------------------------------------------
    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """True if the decoder never needs an unbounded full-attention cache
        in *every* layer (assignment rule for long_500k eligibility)."""
        if self.family in ("ssm", "hybrid"):
            return True
        if self.window > 0 and not self.global_layers and not self.local_global_ratio:
            return True   # pure SWA (danube)
        if self.local_global_ratio > 0:
            return True   # gemma3: bounded except sparse global layers
        return False

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- stack plan ----------------------------------------------------------
    def plan(self) -> list[Segment]:
        """Decoder (or decoder-only) stack plan."""
        if self.family == "ssm":
            return self._xlstm_plan()
        if self.family == "hybrid":
            return self._hymba_plan()
        if self.is_encdec:
            spec = BlockSpec(kind="dec", cross_attention=True)
            return [Segment(((spec, self.n_layers),))]
        if self.local_global_ratio > 0:
            return self._local_global_plan()
        base = BlockSpec(
            kind="attn",
            window=self.window,
            moe=self.n_experts > 0,
            dense_residual=self.dense_residual,
            n_shared_experts=self.n_shared_experts,
            parallel_block=self.parallel_block,
        )
        segs: list[Segment] = []
        n = self.n_layers
        if self.n_experts > 0 and self.first_k_dense > 0:
            dense = dataclasses.replace(base, moe=False, dense_residual=False,
                                        n_shared_experts=0)
            segs.append(Segment(((dense, self.first_k_dense),)))
            n -= self.first_k_dense
        segs.append(Segment(((base, n),)))
        return segs

    def enc_plan(self) -> list[Segment]:
        assert self.is_encdec
        spec = BlockSpec(kind="enc")
        return [Segment(((spec, self.enc_layers),))]

    def _local_global_plan(self) -> list[Segment]:
        r = self.local_global_ratio
        local = BlockSpec(kind="attn", window=self.window)
        glob = BlockSpec(kind="attn", window=FULL_ATTENTION)
        group = r + 1
        n_groups, leftover = divmod(self.n_layers, group)
        segs = [Segment(((local, r), (glob, 1)), repeat=n_groups)]
        if leftover:
            segs.append(Segment(((local, leftover),)))
        return segs

    def _hymba_plan(self) -> list[Segment]:
        """hymba: global full attention at explicit layer ids, SWA elsewhere;
        every layer is a parallel attn+mamba block."""
        swa = BlockSpec(kind="hymba", window=self.window)
        glob = BlockSpec(kind="hymba", window=FULL_ATTENTION)
        ids = set(self.global_layers)
        segs: list[Segment] = []
        run = 0
        for i in range(self.n_layers):
            if i in ids:
                if run:
                    segs.append(Segment(((swa, run),)))
                    run = 0
                segs.append(Segment(((glob, 1),)))
            else:
                run += 1
        if run:
            segs.append(Segment(((swa, run),)))
        return segs

    def _xlstm_plan(self) -> list[Segment]:
        m = BlockSpec(kind="mlstm")
        s = BlockSpec(kind="slstm")
        if self.mlstm_ratio <= 0:
            return [Segment(((m, self.n_layers),))]
        group = self.mlstm_ratio + 1
        n_groups, leftover = divmod(self.n_layers, group)
        segs = [Segment(((m, self.mlstm_ratio), (s, 1)), repeat=n_groups)]
        if leftover:
            segs.append(Segment(((m, leftover),)))
        return segs


# ---------------------------------------------------------------------------
# Shapes (assigned input-shape set) & mesh config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # 'train' | 'prefill' | 'decode'
    microbatch: int = 0  # 0 = auto (train only)


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: long_500k requires sub-quadratic attention (see DESIGN.md)"
    return True, ""
