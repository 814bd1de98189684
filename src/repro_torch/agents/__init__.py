from repro_torch.agents.agent import DeveloperAgent, TesterAgent, ToolAgent
from repro_torch.agents.graph import (GraphTask, WorkflowGraph, debate,
                                deep_review, fig1, map_reduce)
from repro_torch.agents.pipeline import (AgenticPipeline, PipelineConfig, TaskSpec,
                                   TierSpec, WorkflowConfig, WorkflowPipeline)
from repro_torch.agents.stage import StageAgent, StageKind, StageSpec
from repro_torch.agents.workloads import (ClosedLoopClient, GraphBurst, TenantLoad,
                                    TenantMix, WorkloadConfig)

__all__ = [
    "AgenticPipeline", "ClosedLoopClient", "DeveloperAgent", "GraphBurst",
    "GraphTask", "PipelineConfig", "StageAgent", "StageKind", "StageSpec",
    "TaskSpec", "TenantLoad", "TenantMix", "TesterAgent", "TierSpec",
    "ToolAgent", "WorkflowConfig", "WorkflowGraph", "WorkflowPipeline",
    "WorkloadConfig", "debate", "deep_review", "fig1", "map_reduce",
]
