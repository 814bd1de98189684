"""command-r-plus-104b — dense GQA, no-bias, parallel attn+FFN block.

[hf:CohereForAI/c4ai-command-r-v01; unverified] 64L d_model=12288 96H
(GQA kv=8) d_ff=33792 vocab=256000.  Full attention → long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab=256000,
    parallel_block=True,          # cohere runs attention and FFN in parallel
    rope_theta=75_000.0,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=128, vocab=256, attn_chunk=8)
