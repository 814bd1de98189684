"""Configs for the paper's own workload: the MetaGPT-like developer→tester
agentic pipeline (Figures 1, 3, 6, 7).

The paper serves two agents (a "developer" that emits functions and a
"tester" that generates tests) behind a serving framework.  On this CPU
container the *real-engine* examples use the tiny configs below; the
load-sweep benchmarks use the sim substrate with roofline-calibrated costs
for the paper-scale agent (a ~7B-class dense model).
"""
from repro_torch.configs.base import ModelConfig

# Tiny but real: runs actual JAX forward passes on CPU.
TINY_AGENT = ModelConfig(
    name="tiny-agent",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    attn_chunk=32,
    rope_theta=10_000.0,
)

# ~100M-class model for the end-to-end training example.
LM_100M = ModelConfig(
    name="lm-100m",
    family="dense",
    n_layers=8,
    d_model=512,
    n_heads=8,
    n_kv_heads=4,
    d_ff=2048,
    vocab=32000,
    attn_chunk=256,
    rope_theta=10_000.0,
)

# Small serving tier (~1B-class dense): the workflow plane's Aragog-style
# per-stage tiering routes cheap stages (map workers, summarizers) here
# instead of the 7B tier — same architecture family, ~1/6 the weights.
AGENT_1B = ModelConfig(
    name="agent-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=5632,
    vocab=32000,
    rope_theta=10_000.0,
)

# Paper-scale serving agent (7B-class dense) — used by the sim cost model.
AGENT_7B = ModelConfig(
    name="agent-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=11008,
    vocab=32000,
    rope_theta=10_000.0,
)
