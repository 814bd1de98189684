"""Shared vocabulary of the serving stack: requests, messages, communication
granularities, priorities.  Used by every plane, the engines, and the sim."""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Any, Optional

_ids = itertools.count()


def fresh_id(prefix: str = "r") -> str:
    return f"{prefix}{next(_ids)}"


class Granularity(str, enum.Enum):
    """Message granularity on an agent-to-agent channel — the paper's core
    data-plane knob (Fig 2): batch the whole response, pipeline it
    unit-by-unit (e.g. function-by-function), or stream token-by-token."""

    BATCH = "batch"
    PIPELINE = "pipeline"
    STREAM = "stream"


class Priority(int, enum.Enum):
    LOW = 0
    NORMAL = 1
    HIGH = 2
    INTERACTIVE = 3


class SLOClass(str, enum.Enum):
    """Service class of a tenant's traffic (the multi-tenant SLO plane's
    coarse vocabulary): ``gold`` is latency-sensitive interactive work
    with a TTFT target, ``standard`` is ordinary traffic, ``batch`` is
    deferrable throughput work the controller may pause under pressure."""

    GOLD = "gold"
    STANDARD = "standard"
    BATCH = "batch"


class RequestState(str, enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    RUNNING = "running"
    PREEMPTED = "preempted"
    HANDOFF = "handoff"      # prefill done; KV in flight to a decode engine
    SUSPENDED = "suspended"  # parked on an external wait (tool call)
    FINISHED = "finished"
    FAILED = "failed"


@dataclass
class Request:
    """One LLM inference request inside an engine."""

    prompt_len: int
    max_new_tokens: int
    req_id: str = field(default_factory=lambda: fresh_id("req"))
    priority: Priority = Priority.NORMAL
    arrival_time: float = 0.0
    # workflow-plane metadata: the stage that issued the call and its
    # propagated finish deadline (inf = none).  The scheduler orders the
    # waiting queue EDF-within-priority over ``deadline``, so defaults
    # leave every pre-graph call site's behaviour untouched.
    deadline: float = float("inf")
    stage: Optional[str] = None
    # tenancy-plane metadata: which tenant issued the request and its
    # service class.  Defaults leave every pre-tenancy call site's
    # behaviour untouched (one implicit "default" tenant, standard SLO).
    tenant: str = "default"
    slo_class: str = SLOClass.STANDARD.value
    # engine-assigned
    state: RequestState = RequestState.QUEUED
    slot: int = -1
    prefilled: int = 0              # prompt tokens already prefilled
    available: int = -1             # prompt tokens that have *arrived*
                                    # (-1 => all; grows under streaming)
    generated: int = 0
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    # payloads (real engine)
    prompt_tokens: Optional[Any] = None      # np.ndarray int32
    output_tokens: list = field(default_factory=list)
    # pipeline metadata
    parent_task: Optional[str] = None
    meta: dict = field(default_factory=dict)

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.generated

    def feed(self, n: int) -> None:
        """More prompt tokens arrived (progressive prefill under
        STREAM granularity)."""
        self.available = min(self.prompt_len, max(self.available, 0) + n)

    @property
    def done(self) -> bool:
        return self.generated >= self.max_new_tokens


@dataclass
class Message:
    """A unit of agent-to-agent communication flowing through the data
    plane shim.  ``granularity`` is stamped by the shim when the channel's
    mode is applied; ``units`` counts the logical content units (tokens
    for STREAM, functions for PIPELINE, whole responses for BATCH)."""

    src: str
    dst: str
    payload: Any
    units: int = 1
    tokens: int = 0
    granularity: Granularity = Granularity.BATCH
    priority: Priority = Priority.NORMAL
    msg_id: str = field(default_factory=lambda: fresh_id("msg"))
    created_at: float = 0.0
    task_id: Optional[str] = None
    speculative: bool = False
    # tenancy plane: stamped by the issuing workload / pool so routers
    # can meter per-tenant admission ahead of the policy pick
    tenant: str = "default"
    slo_class: str = SLOClass.STANDARD.value


@dataclass
class AgentCard:
    """Registration record (the paper's §3.1 agent/tool hooks): identity
    plus the advertised set()-able knobs and exported metrics."""

    name: str
    kind: str                        # 'llm' | 'tool'
    knobs: dict[str, Any] = field(default_factory=dict)      # name -> default
    metrics: tuple[str, ...] = ()
    capabilities: tuple[str, ...] = ()   # e.g. ('kv_transfer', 'pause')
