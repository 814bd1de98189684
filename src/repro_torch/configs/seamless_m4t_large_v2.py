"""seamless-m4t-large-v2 — encoder-decoder, multimodal.  [arXiv:2308.11596; hf]

24L (encoder) + 24L (decoder) d_model=1024 16H (kv=16, i.e. MHA) d_ff=8192
vocab=256206.  The speech frontend is a STUB per the assignment:
``input_specs()`` provides precomputed frame embeddings (B, T, d_model).
Decode shapes lower the *decoder* step (self-attn cache + precomputed
cross-attention KV).  Full attention → long_500k skipped.

LM shape convention for enc-dec (documented in DESIGN.md): a cell with
seq_len S splits into S/2 encoder frames + S/2 decoder tokens for train
and prefill; decode cells use an S/2 decoder self-cache + S/2 encoder
memory.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    enc_layers=24,
    frontend="frames",
    rope_theta=10_000.0,
)

SMOKE = CONFIG.replace(n_layers=2, enc_layers=2, d_model=64, n_heads=4,
                       n_kv_heads=4, d_ff=128, vocab=256, attn_chunk=8)
