"""Model configs the port serves: the paper's agentic-workload family
and the hybrid ``hymba-1.5b``.

``get_config(name)`` resolves ``tiny-agent``, ``agent-1b``, ``agent-7b``
and ``hymba-1.5b``; ``get_smoke(name)`` the reduced same-family config
of the CPU tests (the config itself where there is none).  The other
architectures wait for their block kinds (MoE, xLSTM, enc-dec, VLM) to
be ported.
"""
from __future__ import annotations

from repro_torch.configs import hymba_1_5b
from repro_torch.configs.base import (FULL_ATTENTION, BlockSpec, ModelConfig,
                                      Segment)
from repro_torch.configs.paper_agentic import AGENT_1B, AGENT_7B, TINY_AGENT

_CONFIGS = {c.name: c for c in (TINY_AGENT, AGENT_1B, AGENT_7B,
                                hymba_1_5b.CONFIG)}
_SMOKE = {hymba_1_5b.CONFIG.name: hymba_1_5b.SMOKE}


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
