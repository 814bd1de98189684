"""Workflow graph plane: agent DAGs as first-class control-plane objects.

The data plane no longer hard-codes the paper's Fig-1 topology: a
``WorkflowGraph`` declares typed stages (chain, fan-out, fan-in/join,
branch, tool) and the edges between them, and
``AgenticPipeline.build(graph)`` compiles it into wired engines,
channels and routers (agents/pipeline.py).  The graph itself stays on
the *control* side of the line — the scheduler consumes its
critical-path structure (longest-remaining-path priorities,
edge-propagated deadlines), the router consumes its per-stage model
tiers, and the controller reaches every stage through a registered
``stage.<name>`` knob surface.

Graph analysis lives here and is deliberately dependency-free (no
engines, no event loop): ``topo_order``, ``est_inputs`` (expected token
flow along edges) and ``critical_path`` (longest remaining work per
stage under a pluggable per-stage cost function) are pure functions of
the DAG, so policies and tests can reason about workflows without
building one.

Prebuilt topologies:

* ``fig1()``        — the paper's developer→tester pipeline (template
  marker: ``build`` routes it to the classic ``AgenticPipeline``).
* ``map_reduce()``  — planner → fan-out map workers → fan-in reducer.
* ``deep_review()`` — a depth-d review chain (author → reviewers → editor).
* ``debate()``      — moderator → pro/con branches → fact-check tool →
  judge → verdict branch (accept | revise).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

from repro_torch.agents.stage import StageKind, StageSpec
from repro_torch.core.types import Priority, fresh_id


class GraphError(ValueError):
    pass


@dataclass
class GraphTask:
    """One task flowing through a workflow graph.

    ``deadline`` is absolute virtual time; ``inf`` means "stamp from the
    graph's critical path at submit" (pipeline default) — the workflow
    runtime propagates per-stage deadlines from it along edges.
    """

    session: str
    prompt_tokens: int = 128
    priority: Priority = Priority.NORMAL
    speculative: bool = False
    deadline: float = math.inf
    task_id: str = field(default_factory=lambda: fresh_id("wtask"))
    submitted_at: float = 0.0
    finished_at: float = 0.0
    # runtime scratch (e.g. live requests held open across a TOOL stage
    # by the suspend/resume plane)
    meta: dict = field(default_factory=dict)


class WorkflowGraph:
    """A DAG of ``StageSpec``s — the control-plane view of a workflow."""

    def __init__(self, name: str, template: str = ""):
        self.name = name
        self.template = template          # "fig1" routes build() to the
        self.meta: dict = {}              # classic pipeline
        self.stages: dict[str, StageSpec] = {}
        self.edges: list[tuple[str, str]] = []
        self._preds: dict[str, list[str]] = {}
        self._succs: dict[str, list[str]] = {}

    # -- construction -------------------------------------------------------
    def add_stage(self, spec: StageSpec) -> StageSpec:
        if spec.name in self.stages:
            raise GraphError(f"duplicate stage {spec.name!r}")
        self.stages[spec.name] = spec
        self._preds[spec.name] = []
        self._succs[spec.name] = []
        return spec

    def stage(self, name: str, **kw) -> StageSpec:
        """Sugar: declare-and-add in one call."""
        return self.add_stage(StageSpec(name, **kw))

    def add_edge(self, src: str, dst: str) -> None:
        for n in (src, dst):
            if n not in self.stages:
                raise GraphError(f"edge {src}->{dst}: unknown stage {n!r}")
        if (src, dst) in self.edges:
            raise GraphError(f"duplicate edge {src}->{dst}")
        if src == dst:
            raise GraphError(f"self-edge on {src!r}")
        self.edges.append((src, dst))
        self._succs[src].append(dst)
        self._preds[dst].append(src)

    def chain(self, *names: str) -> None:
        for u, v in zip(names, names[1:]):
            self.add_edge(u, v)

    # -- structure ----------------------------------------------------------
    def preds(self, name: str) -> list[str]:
        return list(self._preds[name])

    def succs(self, name: str) -> list[str]:
        return list(self._succs[name])

    def sources(self) -> list[str]:
        return [n for n in self.stages if not self._preds[n]]

    def sinks(self) -> list[str]:
        return [n for n in self.stages if not self._succs[n]]

    def topo_order(self) -> list[str]:
        indeg = {n: len(p) for n, p in self._preds.items()}
        ready = [n for n, d in indeg.items() if d == 0]
        order: list[str] = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for s in self._succs[n]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    ready.append(s)
        if len(order) != len(self.stages):
            raise GraphError(f"graph {self.name!r} has a cycle")
        return order

    def validate(self) -> "WorkflowGraph":
        if not self.stages:
            raise GraphError("empty graph")
        self.topo_order()                  # raises on cycles
        if not self.sources():
            raise GraphError("no source stage")
        for name, spec in self.stages.items():
            if spec.kind is StageKind.JOIN and not self._preds[name]:
                raise GraphError(f"JOIN stage {name!r} has no inputs")
            if (spec.kind is StageKind.BRANCH
                    and len(self._succs[name]) < 2):
                raise GraphError(
                    f"BRANCH stage {name!r} needs >= 2 successors")
            if spec.kind is StageKind.FAN_OUT and spec.width < 1:
                raise GraphError(f"FAN_OUT stage {name!r}: width < 1")
        self._check_fanin_liveness()
        return self

    def _check_fanin_liveness(self) -> None:
        """Reject fan-ins that can never fire.  A BRANCH activates only
        ONE successor per task, so a stage that waits for ALL of its
        inputs (multi-pred, join_k=0, join_timeout=0) deadlocks if any
        input is only *maybe* produced — e.g. the natural
        ``branch -> arm_a | arm_b -> merge`` pattern.  Forward pass:
        ``guaranteed[n]`` = this stage runs (and feeds all successors)
        for every task.  Wait-for-all stages need every input
        guaranteed; others fire on any guaranteed input (join_k /
        join_timeout stages fire once anything arrives)."""
        guaranteed: dict[str, bool] = {}
        for n in self.topo_order():
            preds = self._preds[n]
            if not preds:
                guaranteed[n] = True
                continue
            spec = self.stages[n]
            fed = {p: guaranteed[p]
                   and self.stages[p].kind is not StageKind.BRANCH
                   for p in preds}
            waits_all = (len(preds) > 1 and spec.join_k == 0
                         and spec.join_timeout == 0)
            if waits_all and not all(fed.values()):
                starved = sorted(p for p, ok in fed.items() if not ok)
                raise GraphError(
                    f"stage {n!r} waits for ALL inputs but "
                    f"{starved} may never fire (downstream of a "
                    "BRANCH arm) — set join_k or join_timeout on it")
            guaranteed[n] = (all(fed.values()) if waits_all
                             else any(fed.values()))

    # -- analysis -----------------------------------------------------------
    def est_out_tokens(self, spec: StageSpec, est_in: float) -> float:
        """Expected tokens a stage emits downstream per task."""
        if spec.kind is StageKind.TOOL:
            return est_in                  # tools pass content through
        if spec.kind is StageKind.FAN_OUT:
            return float(spec.width * spec.out_tokens)
        return float(spec.out_tokens)

    def est_inputs(self, prompt_tokens: int = 128) -> dict[str, float]:
        """Expected input tokens arriving at each stage (forward pass in
        topological order; sources see the task prompt)."""
        est: dict[str, float] = {}
        for n in self.topo_order():
            if not self._preds[n]:
                est[n] = float(prompt_tokens)
            else:
                est[n] = sum(
                    self.est_out_tokens(self.stages[p], est[p])
                    for p in self._preds[n])
        return est

    def critical_path(
            self, cost_fn: Callable[[StageSpec, float], float],
            prompt_tokens: int = 128,
    ) -> dict[str, float]:
        """Longest remaining work per stage (the stage's own estimated
        cost plus the heaviest downstream path), under ``cost_fn(spec,
        est_input_tokens) -> seconds``.  Reverse topological pass; for a
        BRANCH the max over arms is the conservative remaining path."""
        est_in = self.est_inputs(prompt_tokens)
        cp: dict[str, float] = {}
        for n in reversed(self.topo_order()):
            tail = max((cp[s] for s in self._succs[n]), default=0.0)
            cp[n] = cost_fn(self.stages[n], est_in[n]) + tail
        return cp

    def cp_total(self, cp: dict[str, float]) -> float:
        return max((cp[s] for s in self.sources()), default=0.0)

    def describe(self) -> str:
        lines = [f"workflow {self.name!r}:"]
        for n in self.topo_order():
            spec = self.stages[n]
            succ = ", ".join(self._succs[n]) or "(sink)"
            lines.append(f"  {n} [{spec.kind.value}"
                         f"{'x%d' % spec.width if spec.kind is StageKind.FAN_OUT else ''}"
                         f", tier={spec.model_tier}] -> {succ}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Prebuilt topologies
# ---------------------------------------------------------------------------


def fig1(n_functions: int = 6, func_tokens: int = 48,
         test_tokens: int = 40) -> WorkflowGraph:
    """The paper's Fig-1 developer→tester pipeline as a graph.  Carries
    the ``fig1`` template marker: ``AgenticPipeline.build`` compiles it
    through the classic pipeline (DeveloperAgent/TesterAgent semantics,
    KV-transfer fabric, elastic tester group) rather than the generic
    stage runtime."""
    g = WorkflowGraph("fig1", template="fig1")
    g.stage("developer", kind=StageKind.CHAIN,
            out_tokens=n_functions * func_tokens)
    g.stage("tester", kind=StageKind.FAN_OUT, width=n_functions,
            out_tokens=test_tokens)
    g.add_edge("developer", "tester")
    return g


def map_reduce(width: int = 8, out_tokens: int = 48,
               worker_tier: str = "large") -> WorkflowGraph:
    """Planner fans a task out to ``width`` map workers; a fan-in
    reducer joins their results.  The map stage is the natural
    down-tiering target (many short parallel calls)."""
    g = WorkflowGraph(f"map_reduce_w{width}")
    g.stage("planner", kind=StageKind.CHAIN, out_tokens=64)
    g.stage("map", kind=StageKind.FAN_OUT, width=width,
            out_tokens=out_tokens, model_tier=worker_tier)
    g.stage("reduce", kind=StageKind.JOIN, out_tokens=96)
    g.chain("planner", "map", "reduce")
    return g


def deep_review(depth: int = 4, out_tokens: int = 64,
                reviewer_tier: str = "large", tool_latency: float = 0.0,
                tool_latency_cv: float = 0.0,
                tool_timeout: float = 0.0) -> WorkflowGraph:
    """An author draft walked through a depth-``depth`` reviewer chain,
    closed by an editor — the long-critical-path shape where EDF over
    propagated deadlines matters most.  ``tool_latency > 0`` inserts a
    research TOOL stage after each reviewer (a literature lookup), which
    turns the chain into the suspend/resume plane's stress shape:
    every reviewer's context parks for a heavy-tailed tool wait."""
    g = WorkflowGraph(f"deep_review_d{depth}")
    g.stage("author", kind=StageKind.CHAIN, out_tokens=128)
    names = ["author"]
    for i in range(depth):
        g.stage(f"reviewer-{i}", kind=StageKind.CHAIN,
                out_tokens=out_tokens, model_tier=reviewer_tier)
        names.append(f"reviewer-{i}")
        if tool_latency > 0:
            g.stage(f"research-{i}", kind=StageKind.TOOL,
                    tool_latency=tool_latency,
                    tool_latency_cv=tool_latency_cv,
                    tool_timeout=tool_timeout)
            names.append(f"research-{i}")
    g.stage("editor", kind=StageKind.CHAIN, out_tokens=96)
    names.append("editor")
    g.chain(*names)
    return g


def debate(side_tokens: int = 80, side_tier: str = "large",
           tool_latency: float = 0.05, tool_latency_cv: float = 0.0,
           tool_timeout: float = 0.0) -> WorkflowGraph:
    """Branching debate with a tool stage: a moderator frames the
    question, pro and con argue in parallel, a fact-check *tool* joins
    both transcripts, a judge rules, and a verdict BRANCH routes each
    task to exactly one of accept/revise."""
    g = WorkflowGraph("debate")
    g.stage("moderator", kind=StageKind.CHAIN, out_tokens=48)
    g.stage("pro", kind=StageKind.CHAIN, out_tokens=side_tokens,
            model_tier=side_tier)
    g.stage("con", kind=StageKind.CHAIN, out_tokens=side_tokens,
            model_tier=side_tier)
    g.stage("factcheck", kind=StageKind.TOOL, tool_latency=tool_latency,
            tool_latency_cv=tool_latency_cv, tool_timeout=tool_timeout)
    g.stage("judge", kind=StageKind.CHAIN, out_tokens=72)
    g.stage("verdict", kind=StageKind.BRANCH, out_tokens=24)
    g.stage("accept", kind=StageKind.CHAIN, out_tokens=16,
            model_tier=side_tier)
    g.stage("revise", kind=StageKind.CHAIN, out_tokens=64,
            model_tier=side_tier)
    g.add_edge("moderator", "pro")
    g.add_edge("moderator", "con")
    g.add_edge("pro", "factcheck")
    g.add_edge("con", "factcheck")
    g.chain("factcheck", "judge", "verdict")
    g.add_edge("verdict", "accept")
    g.add_edge("verdict", "revise")
    return g


GALLERY: dict[str, Callable[..., WorkflowGraph]] = {
    "fig1": fig1,
    "map_reduce": map_reduce,
    "deep_review": deep_review,
    "debate": debate,
}
