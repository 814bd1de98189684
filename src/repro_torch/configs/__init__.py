"""Model configs the port serves: the paper's agentic-workload family.

``get_config(name)`` resolves ``tiny-agent``, ``agent-1b`` and
``agent-7b`` only; the other architectures wait for their block kinds
(MoE, SSM, enc-dec, VLM) to be ported.
"""
from __future__ import annotations

from repro_torch.configs.base import (FULL_ATTENTION, BlockSpec, ModelConfig,
                                      Segment)
from repro_torch.configs.paper_agentic import AGENT_1B, AGENT_7B, TINY_AGENT

_CONFIGS = {c.name: c for c in (TINY_AGENT, AGENT_1B, AGENT_7B)}


def get_config(name: str) -> ModelConfig:
    try:
        return _CONFIGS[name]
    except KeyError:
        raise KeyError(f"unknown config {name!r}; the port serves "
                       f"{sorted(_CONFIGS)}") from None


__all__ = ["AGENT_1B", "AGENT_7B", "FULL_ATTENTION", "BlockSpec",
           "ModelConfig", "Segment", "TINY_AGENT", "get_config"]
