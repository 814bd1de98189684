"""gemma3-27b — dense GQA with 5:1 local:global attention, 262k vocab.

[hf:google/gemma-3-1b-pt; unverified] 62L d_model=5376 32H (GQA kv=16)
d_ff=21504 vocab=262144.  5 local (window 1024) then 1 global layer; the
stack plan nests the 6-layer cycle in an outer scan.  long_500k RUNS
(bounded cache in 5/6 of layers; global layers are decode-linear).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_head=128,
    d_ff=21504,
    vocab=262144,
    window=1024,
    local_global_ratio=5,
    qk_norm=True,
    logit_softcap=30.0,
    rope_theta=1_000_000.0,
)

SMOKE = CONFIG.replace(n_layers=13, d_model=64, n_heads=4, n_kv_heads=2,
                       d_head=16, d_ff=128, vocab=256, window=16,
                       attn_chunk=8)
