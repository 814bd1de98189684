"""Control rules (paper §3.1 design point 1).

The controller does not micromanage messages; it installs *rules* into
the data plane:

* ``AgentRule`` — agent-level: the default communication mode for a
  channel, admission floor under load, pacing.  Applying one is a batch
  of ``set()`` calls against the channel/engine shims.
* ``RequestRule`` — request-level: fine-grained routing of requests to
  agent instances (session pinning, overrides) and gating of speculative
  sends.  Routers and channels consult the installed ``RuleTable``.
"""
from __future__ import annotations

import fnmatch
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.types import Granularity, Message


@dataclass
class AgentRule:
    """Default communication behaviour for channels matching ``target``."""

    target: str                             # channel-name glob
    granularity: Optional[Granularity] = None
    stream_chunk: Optional[int] = None
    pace: Optional[float] = None
    admit_priority_min: Optional[int] = None   # applied to the dst engine

    def knob_updates(self) -> dict:
        out = {}
        if self.granularity is not None:
            out["granularity"] = self.granularity
        if self.stream_chunk is not None:
            out["stream_chunk"] = self.stream_chunk
        if self.pace is not None:
            out["pace"] = self.pace
        return out


@dataclass
class RequestRule:
    """Routing / gating for requests matching (session, task, tenant,
    flags)."""

    session: str = "*"                      # glob over session ids
    task: str = "*"                         # glob over task ids
    tenant: str = "*"                       # glob over tenant names
    speculative: Optional[bool] = None      # match only (non-)speculative
    route_to: Optional[str] = None          # instance name
    block: bool = False                     # hold until rule removed
    priority: Optional[int] = None

    def matches(self, msg: Message) -> bool:
        sess = (msg.payload or {}).get("session") or ""
        if not fnmatch.fnmatch(sess, self.session):
            return False
        if not fnmatch.fnmatch(msg.task_id or "", self.task):
            return False
        if not fnmatch.fnmatch(msg.tenant or "", self.tenant):
            return False
        if self.speculative is not None and msg.speculative != self.speculative:
            return False
        return True


class RuleTable:
    """The installed rule state, shared controller ↔ data plane."""

    def __init__(self):
        self.agent_rules: list[AgentRule] = []
        self.request_rules: list[RequestRule] = []
        self.version = 0

    def install(self, rule) -> None:
        if isinstance(rule, AgentRule):
            self.agent_rules = [r for r in self.agent_rules
                                if r.target != rule.target] + [rule]
        else:
            self.request_rules.append(rule)
        self.version += 1

    def remove_request_rules(self, predicate) -> int:
        before = len(self.request_rules)
        self.request_rules = [r for r in self.request_rules
                              if not predicate(r)]
        self.version += 1
        return before - len(self.request_rules)

    def route_for(self, msg: Message) -> Optional[str]:
        """Last matching request-rule wins (most recently installed)."""
        out = None
        for r in self.request_rules:
            if r.route_to and r.matches(msg):
                out = r.route_to
        return out

    def blocked(self, msg: Message) -> bool:
        return any(r.block and r.matches(msg) for r in self.request_rules)
