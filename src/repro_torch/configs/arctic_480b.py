"""arctic-480b — MoE 128 experts top-2 with a dense residual FFN in
parallel (dense-MoE hybrid).  [hf:Snowflake/snowflake-arctic-base; hf]

35L d_model=7168 56H (GQA kv=8) d_ff=4864 (expert dim) vocab=32000.
Full attention → long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,              # dense-residual FFN width
    vocab=32000,
    n_experts=128,
    top_k=2,
    d_ff_expert=4864,
    dense_residual=True,
    rope_theta=10_000.0,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=96, d_ff_expert=96, n_experts=8, top_k=2,
                       vocab=256, attn_chunk=8)
