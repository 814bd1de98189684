"""llama3-405b — dense GQA, 128k vocab.  [arXiv:2407.21783; unverified]

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.  Pure full
attention → long_500k is skipped per the assignment's sub-quadratic rule.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab=128256,
    rope_theta=500_000.0,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=192, vocab=256, attn_chunk=8)
