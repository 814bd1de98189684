"""kimi-k2-1t-a32b — trillion-parameter MoE, 384 experts top-8 + 1 shared
expert, first layer dense.  [arXiv:2501.kimi2; unverified]

61L d_model=7168 64H (GQA kv=8) d_ff=2048 (expert dim) vocab=163840.
Full attention → long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=11264,             # dense FFN width for the first_k_dense layers
    vocab=163840,
    n_experts=384,
    top_k=8,
    d_ff_expert=2048,
    n_shared_experts=1,
    first_k_dense=1,
    rope_theta=50_000.0,
)

SMOKE = CONFIG.replace(n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=128, d_ff_expert=32, n_experts=8, top_k=2,
                       n_shared_experts=1, first_k_dense=1, vocab=256,
                       attn_chunk=8)
