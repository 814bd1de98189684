"""h2o-danube-3-4b — dense, llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; unverified] 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000.  SWA on every layer makes the decoder cache bounded, so the
long_500k cell runs for this arch.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab=32000,
    window=4096,
    rope_theta=10_000.0,
)

# Reduced config for CPU smoke tests — same family/structure, tiny dims.
SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=128, vocab=256, window=16, attn_chunk=8)
