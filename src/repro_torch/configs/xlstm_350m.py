"""xlstm-350m — sLSTM + mLSTM blocks (xLSTM[7:1]).  [arXiv:2405.04517;
unverified]

24L d_model=1024 4H vocab=50304, d_ff=0 (mLSTM blocks carry their own
up-projection; sLSTM blocks use a small gated FFN).  Constant-size
recurrent state → long_500k RUNS (the "cache" is the state, not a KV
buffer).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    mlstm_ratio=7,          # 7 mLSTM then 1 sLSTM, repeated
    ssm_expand=2,
)

SMOKE = CONFIG.replace(n_layers=6, d_model=64, n_heads=2, n_kv_heads=2,
                       vocab=256, mlstm_ratio=2)
