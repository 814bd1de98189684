"""qwen2-vl-2b — VLM backbone with M-RoPE and dynamic resolution.

[arXiv:2409.12191; hf] 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936.  The vision tower is a STUB per the assignment:
``input_specs()`` provides precomputed patch embeddings that are scattered
into the token stream; M-RoPE uses 3-axis (t, h, w) positions with
sections (16, 24, 24) over d_head/2 = 64.  Full attention → long_500k skip.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_head=128,
    d_ff=8960,
    vocab=151936,
    mrope_sections=(16, 24, 24),
    frontend="patch",
    rope_theta=1_000_000.0,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_head=16, d_ff=128, vocab=256,
                       mrope_sections=(2, 3, 3), attn_chunk=8)
