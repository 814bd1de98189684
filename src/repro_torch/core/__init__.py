"""The paper's contribution: a software-defined agentic serving stack.

* metrics plane — core/metrics.py  (collectors, aggregation, specs)
* data plane    — core/dataplane.py (the reconfigurable channel shim)
* control plane — core/controller.py + core/registry.py + core/rules.py
* intents       — core/intent.py   (declarative policy language)
* policies      — core/policies.py (Fig 6/7 control programs)
* tenancy plane — core/tenancy.py  (tenant specs, fair-share weights,
                  admission buckets, per-tenant SLO rollups)
"""
from repro_torch.core.controller import (Action, ControlContext, Controller,
                                   Policy)
from repro_torch.core.dataplane import Channel
from repro_torch.core.intent import (IntentError, IntentPolicy, Trigger,
                               compile_intent)
from repro_torch.core.knobs import ControlSurface, KnobSpec
from repro_torch.core.metrics import (AGGREGATIONS, CentralPoller, Collector,
                                MetricBus, MetricSpec, StateStore,
                                ThresholdSub, register_aggregation)
from repro_torch.core.registry import Registry
from repro_torch.core.rules import AgentRule, RequestRule, RuleTable
from repro_torch.core.tenancy import TenantDirectory, TenantEntry, TenantSpec
from repro_torch.core.trace import FlightRecorder, Span, Tracer
from repro_torch.core.types import (AgentCard, Granularity, Message, Priority,
                              Request, RequestState, SLOClass)

__all__ = [
    "AGGREGATIONS", "Action", "AgentCard", "AgentRule", "CentralPoller",
    "Channel", "Collector", "ControlContext", "ControlSurface", "Controller",
    "FlightRecorder", "Granularity", "IntentError", "IntentPolicy",
    "KnobSpec", "Message", "MetricBus", "MetricSpec", "Policy", "Priority",
    "Registry", "Request", "RequestRule", "RequestState", "RuleTable",
    "SLOClass", "Span", "StateStore", "TenantDirectory", "TenantEntry",
    "TenantSpec", "ThresholdSub", "Tracer", "Trigger", "compile_intent",
    "register_aggregation",
]
