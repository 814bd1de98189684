"""A2A-compatible protocol facade (paper §3.3 "build compatibility in").

Developers keep writing against the familiar agent-protocol surface
(agent cards, ``send_message`` / ``send_message_streaming`` — Fig 4 of
the paper); underneath, every send goes through the reconfigurable
data-plane shim, so the *controller* decides how the bytes actually move.
The streaming/batching choice in application code becomes a *preference*,
not a binding: ``send_message_streaming`` on a channel the controller has
set to BATCH will batch.

This is deliberately a thin veneer — the point of the paper is that the
protocol layer stays familiar while control moves out of the app.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core.dataplane import Channel
from repro_torch.core.types import AgentCard, Granularity, fresh_id


@dataclass
class A2AClientConfig:
    prefer: Optional[Granularity] = None   # app's (non-binding) preference


class A2AClient:
    """Handle to a remote agent, resolved from its card."""

    def __init__(self, card: AgentCard, channel: Channel,
                 cfg: Optional[A2AClientConfig] = None):
        self.card = card
        self.channel = channel
        self.cfg = cfg or A2AClientConfig()

    @classmethod
    def from_agent_card(cls, registry, name: str, channel: Channel,
                        **kw) -> "A2AClient":
        """The Fig-4 ``get_client_from_agent_card_url`` equivalent:
        discovery via the registration plane instead of an HTTP URL."""
        return cls(registry.card(name), channel,
                   A2AClientConfig(**kw) if kw else None)

    # -- message API ---------------------------------------------------------
    def send_message(self, text_tokens: int, session: Optional[str] = None,
                     **meta) -> str:
        """One-shot message: the whole payload as a single task."""
        task_id = fresh_id("a2a")
        self.channel.begin_task(task_id, session=session, **meta)
        self.channel.push_tokens(task_id, text_tokens)
        self.channel.end_task(task_id)
        return task_id

    def send_message_streaming(self, session: Optional[str] = None,
                               **meta) -> "A2AStream":
        """Open a streaming send.  NOTE: whether tokens leave one-by-one
        is the data plane's call — the app only expresses a preference."""
        task_id = fresh_id("a2a")
        self.channel.begin_task(task_id, session=session, **meta)
        return A2AStream(self.channel, task_id)


class A2AStream:
    def __init__(self, channel: Channel, task_id: str):
        self.channel = channel
        self.task_id = task_id
        self.closed = False

    def push(self, n_tokens: int = 1) -> None:
        assert not self.closed
        self.channel.push_tokens(self.task_id, n_tokens)

    def end_unit(self) -> None:
        self.channel.end_unit(self.task_id)

    def close(self) -> None:
        if not self.closed:
            self.channel.end_task(self.task_id)
            self.closed = True
