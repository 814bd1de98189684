"""hymba-1.5b — hybrid: parallel attention + mamba heads in every layer.

[arXiv:2411.13676; hf] 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001 ssm_state=16.  SWA(1024) everywhere except global full
attention at layers {0, 16, 31} (first/middle/last, per the paper).
Hybrid + bounded windows → long_500k RUNS.  Hymba's 128 learnable meta
tokens are a prompt-side detail and are omitted from the shape cells
(noted in DESIGN.md §Arch-applicability).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    window=1024,
    global_layers=(0, 16, 31),
    ssm_state=16,
    rope_theta=10_000.0,
)

SMOKE = CONFIG.replace(n_layers=5, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=128, vocab=256, window=16, global_layers=(0, 4),
                       ssm_state=4, attn_chunk=8)
