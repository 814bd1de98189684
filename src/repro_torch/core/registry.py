"""Controller-side registry (paper §3.1 "agent/tool hooks").

Every controllable object — engine, agent, tool, channel, router —
*registers at launch*, advertising its AgentCard (knobs, metrics,
capabilities).  The controller then manipulates all of them through the
paper's two-function Table-1 surface:

    registry.set("tester-0", "max_num_seqs", 4)
    registry.reset("tester-0", "max_num_seqs")

The per-object ``set_param`` method is the object's *shim layer*: it maps
the uniform knob name onto whatever internal API the object has (exactly
the vLLM ``max_num_seqs`` example from the paper).
"""
from __future__ import annotations


from repro_torch.core.types import AgentCard


class Controllable:
    """Duck-typed interface: card() / set_param() / reset_param()."""


class Registry:
    def __init__(self):
        self._objs: dict[str, object] = {}
        self._cards: dict[str, AgentCard] = {}
        self.set_count = 0

    # -- registration (launch-time hook) ------------------------------------
    def register(self, obj) -> AgentCard:
        card = obj.card()
        if card.name in self._objs:
            raise ValueError(f"duplicate registration: {card.name}")
        self._objs[card.name] = obj
        self._cards[card.name] = card
        return card

    def deregister(self, name: str) -> None:
        self._objs.pop(name, None)
        self._cards.pop(name, None)

    # -- discovery -----------------------------------------------------------
    def names(self) -> list[str]:
        return list(self._objs)

    def get(self, name: str):
        return self._objs[name]

    def card(self, name: str) -> AgentCard:
        return self._cards[name]

    def of_kind(self, kind: str) -> list[str]:
        return [n for n, c in self._cards.items() if c.kind == kind]

    def with_capability(self, cap: str) -> list[str]:
        return [n for n, c in self._cards.items() if cap in c.capabilities]

    def knobs(self, name: str) -> dict:
        return dict(self._cards[name].knobs)

    # -- Table-1 surface ------------------------------------------------------
    def set(self, name: str, knob: str, value) -> None:
        self._objs[name].set_param(knob, value)
        self.set_count += 1

    def reset(self, name: str, knob: str) -> None:
        self._objs[name].reset_param(knob)

    def get_param(self, name: str, knob: str):
        return self._objs[name].get_param(knob)
