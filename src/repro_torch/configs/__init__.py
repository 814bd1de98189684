"""Model configs the port serves: the paper's agentic-workload family,
the hybrid ``hymba-1.5b`` and the MoE models ``arctic-480b`` and
``kimi-k2-1t-a32b``.

``get_config(name)`` resolves ``tiny-agent``, ``agent-1b``, ``agent-7b``,
``hymba-1.5b``, ``arctic-480b`` and ``kimi-k2-1t-a32b``;
``get_smoke(name)`` the reduced same-family config of the CPU tests (the
config itself where there is none).  The other architectures wait for
their block kinds (xLSTM, enc-dec, VLM) to be ported.
"""
from __future__ import annotations

from repro_torch.configs import arctic_480b, hymba_1_5b, kimi_k2_1t_a32b
from repro_torch.configs.base import (FULL_ATTENTION, BlockSpec, ModelConfig,
                                      Segment)
from repro_torch.configs.paper_agentic import AGENT_1B, AGENT_7B, TINY_AGENT

_MODULES = (hymba_1_5b, arctic_480b, kimi_k2_1t_a32b)
_CONFIGS = {c.name: c for c in (TINY_AGENT, AGENT_1B, AGENT_7B,
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


__all__ = ["AGENT_1B", "AGENT_7B", "FULL_ATTENTION", "BlockSpec",
           "ModelConfig", "Segment", "TINY_AGENT", "get_config", "get_smoke"]
