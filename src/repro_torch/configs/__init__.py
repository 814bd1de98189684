"""Model configs the port serves: every architecture of the reference's
registry (``ARCHS``, in its order) and the paper's own agentic-workload
configs (``tiny-agent``, ``lm-100m``, ``agent-7b``, ``agent-1b``).

``get_config(name)`` resolves each of them; ``get_smoke(name)`` the
reduced same-family config of the CPU tests (the config itself where
there is none).
"""
from __future__ import annotations

from repro_torch.configs import (arctic_480b, command_r_plus_104b,
                                 gemma3_27b, h2o_danube_3_4b, hymba_1_5b,
                                 kimi_k2_1t_a32b, llama3_405b, qwen2_vl_2b,
                                 seamless_m4t_large_v2, xlstm_350m)
from repro_torch.configs.base import (FULL_ATTENTION, BlockSpec, ModelConfig,
                                      Segment)
from repro_torch.configs.paper_agentic import (AGENT_1B, AGENT_7B, LM_100M,
                                               TINY_AGENT)

ARCHS: tuple[str, ...] = (
    "h2o-danube-3-4b",
    "llama3-405b",
    "command-r-plus-104b",
    "gemma3-27b",
    "arctic-480b",
    "kimi-k2-1t-a32b",
    "qwen2-vl-2b",
    "hymba-1.5b",
    "xlstm-350m",
    "seamless-m4t-large-v2",
)

_MODULES = (h2o_danube_3_4b, llama3_405b, command_r_plus_104b, gemma3_27b,
            arctic_480b, kimi_k2_1t_a32b, qwen2_vl_2b, hymba_1_5b,
            xlstm_350m, seamless_m4t_large_v2)
_CONFIGS = {c.name: c for c in (TINY_AGENT, LM_100M, AGENT_7B, AGENT_1B,
                                *(m.CONFIG for m in _MODULES))}
_SMOKE = {m.CONFIG.name: m.SMOKE for m in _MODULES}


def get_config(name: str) -> ModelConfig:
    try:
        return _CONFIGS[name]
    except KeyError:
        raise KeyError(f"unknown config {name!r}; the port serves "
                       f"{sorted(_CONFIGS)}") from None


def get_smoke(name: str) -> ModelConfig:
    """Reduced same-family config for CPU tests."""
    return _SMOKE.get(name) or get_config(name)


__all__ = ["AGENT_1B", "AGENT_7B", "ARCHS", "FULL_ATTENTION", "BlockSpec",
           "LM_100M", "ModelConfig", "Segment", "TINY_AGENT", "get_config",
           "get_smoke"]
