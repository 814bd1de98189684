"""Declarative knob surface (paper Table 1, unified).

The seed hand-rolled the two-function ``set()/reset()`` shim separately
in every controllable class (channel, router, scheduler, engine, tool),
each with its own if/elif validation ladder.  This module replaces all
of them with ONE implementation:

* ``KnobSpec`` — declares a knob: type, bounds/choices, the attribute it
  backs onto (dotted paths allowed, e.g. ``cfg.max_batch_tokens``), an
  optional ``on_change`` hook for side effects, an optional dynamic
  ``clamp`` hook, and an optional ``delegate`` that forwards the knob to
  a sub-object which is itself a ``ControlSurface`` (engines delegate
  scheduler knobs this way).
* ``ControlSurface`` — a mixin deriving ``get_param`` / ``set_param`` /
  ``reset_param`` / ``card()`` from the class's ``KNOB_SPECS``, with
  uniform coercion, clamping, default-tracking (first-set value is the
  reset target), and audit emission (a bounded per-object ``knob_log``
  plus a ``<name>.knob_sets`` counter when a collector is attached).

The controller's registry keeps talking plain ``set_param``/``reset_param``
— nothing upstream changes; only the per-class ladders are gone.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.types import AgentCard

_TRUE_WORDS = ("1", "true", "on", "yes")
_FALSE_WORDS = ("0", "false", "off", "no")


@dataclass(frozen=True)
class KnobSpec:
    """One controllable attribute, declaratively."""

    name: str
    kind: str = "float"              # int | float | bool | str | enum
    enum: Optional[type] = None      # Enum class (kind implied)
    lo: Optional[float] = None       # clamp floor (int/float kinds)
    hi: Optional[float] = None       # clamp ceiling
    choices: Optional[tuple] = None  # allowed values (str kinds)
    attr: Optional[str] = None       # backing attribute; dotted path ok
    delegate: Optional[str] = None   # forward to this sub-surface
    on_change: Optional[str] = None  # method name: (old, new) -> None
    clamp: Optional[str] = None      # method name: (value) -> value
    doc: str = ""

    def delegated(self, path: str, **overrides) -> "KnobSpec":
        # the delegate's own surface runs the on_change hook; the
        # delegating level only coerces/clamps and tracks defaults
        overrides.setdefault("on_change", None)
        return dataclasses.replace(self, delegate=path, **overrides)

    # -- uniform validation / coercion ------------------------------------
    def coerce(self, value):
        if self.enum is not None:
            value = self.enum(value)
        elif self.kind == "int":
            value = int(value)
        elif self.kind == "float":
            value = float(value)
        elif self.kind == "bool":
            if isinstance(value, str):
                low = value.lower()
                if low in _TRUE_WORDS:
                    value = True
                elif low in _FALSE_WORDS:
                    value = False
                else:
                    raise ValueError(
                        f"knob {self.name!r}: bad boolean {value!r}")
            else:
                value = bool(value)
        elif self.kind == "str":
            value = str(value)
        if self.choices is not None and value not in self.choices:
            raise ValueError(f"knob {self.name!r}: {value!r} not in "
                             f"{self.choices}")
        if self.lo is not None and value < self.lo:
            value = type(value)(self.lo)
        if self.hi is not None and value > self.hi:
            value = type(value)(self.hi)
        return value


def _walk(obj, path: str):
    """Resolve a dotted attribute path to (owner, leaf_name)."""
    parts = path.split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    return obj, parts[-1]


class ControlSurface:
    """Mixin: the ONE set()/reset() implementation (paper Table 1).

    Subclasses declare ``KNOB_SPECS`` plus the card metadata class attrs
    (``kind``, ``CAPABILITIES``, ``METRICS``); ``KNOBS`` and the spec map
    are derived automatically.
    """

    KNOB_SPECS: tuple[KnobSpec, ...] = ()
    KNOBS: tuple[str, ...] = ()
    _SPEC_MAP: dict[str, KnobSpec] = {}
    kind: str = "controllable"
    CAPABILITIES: tuple[str, ...] = ()
    METRICS: tuple[str, ...] = ()
    KNOB_LOG_CAP = 256               # bounded audit trail per object

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if "KNOB_SPECS" in cls.__dict__:
            cls.KNOBS = tuple(s.name for s in cls.KNOB_SPECS)
            cls._SPEC_MAP = {s.name: s for s in cls.KNOB_SPECS}

    # -- spec access ------------------------------------------------------
    def _spec(self, name: str) -> KnobSpec:
        spec = self._SPEC_MAP.get(name)
        if spec is None:
            raise KeyError(f"{getattr(self, 'name', type(self).__name__)}: "
                           f"unknown knob {name!r}")
        return spec

    def knob_names(self) -> tuple[str, ...]:
        return self.KNOBS

    def knob_specs(self) -> tuple[KnobSpec, ...]:
        return self.KNOB_SPECS

    @property
    def _knob_defaults(self) -> dict:
        d = self.__dict__.get("_knob_defaults_")
        if d is None:
            d = self.__dict__["_knob_defaults_"] = {}
        return d

    @property
    def knob_log(self) -> list:
        log = self.__dict__.get("_knob_log_")
        if log is None:
            log = self.__dict__["_knob_log_"] = []
        return log

    # -- Table-1 surface ---------------------------------------------------
    def get_param(self, name: str):
        spec = self._spec(name)
        if spec.delegate is not None:
            return getattr(self, spec.delegate).get_param(name)
        owner, leaf = _walk(self, spec.attr or spec.name)
        return getattr(owner, leaf)

    def set_param(self, name: str, value) -> None:
        spec = self._spec(name)
        old = self.get_param(name)
        value = spec.coerce(value)
        if spec.clamp is not None:
            value = getattr(self, spec.clamp)(value)
        self._knob_defaults.setdefault(name, old)
        if spec.delegate is not None:
            getattr(self, spec.delegate).set_param(name, value)
        else:
            owner, leaf = _walk(self, spec.attr or spec.name)
            setattr(owner, leaf, value)
        if spec.on_change is not None:
            getattr(self, spec.on_change)(old, value)
        self._knob_audit(name, old, value)
        self.on_knob_set(name, old, value)

    def reset_param(self, name: str) -> None:
        self._spec(name)                       # unknown knobs still raise
        defaults = self._knob_defaults
        if name in defaults:
            self.set_param(name, defaults[name])

    # -- audit -------------------------------------------------------------
    def _surface_now(self) -> float:
        loop = getattr(self, "loop", None)
        if loop is not None:
            return loop.now()
        return 0.0

    def _knob_audit(self, name: str, old, new) -> None:
        log = self.knob_log
        log.append((self._surface_now(), name, old, new))
        if len(log) > self.KNOB_LOG_CAP:
            del log[: self.KNOB_LOG_CAP // 2]
        collector = getattr(self, "collector", None)
        if collector is not None:
            collector.counter(
                f"{getattr(self, 'name', type(self).__name__)}.knob_sets",
                1, self._surface_now())

    def on_knob_set(self, name: str, old, new) -> None:
        """Class-wide post-set hook (e.g. engines kick their step loop)."""

    # -- registration card -------------------------------------------------
    def card_metrics(self) -> tuple[str, ...]:
        return self.METRICS

    def card(self) -> AgentCard:
        return AgentCard(
            name=self.name, kind=self.kind,
            knobs={k: self.get_param(k) for k in self.KNOBS},
            metrics=tuple(self.card_metrics()),
            capabilities=tuple(self.CAPABILITIES))
