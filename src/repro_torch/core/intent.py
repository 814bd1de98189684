"""Declarative intent language v2 (paper §3.1 goal 3, §5 "Languages for
Agentic Control").

Infrastructure engineers express goals without touching control-plane
internals; the compiler turns them into a closed-loop ``Policy``:

    objective: maximize throughput under p95(pipeline.task_latency) <= 2.0

    rule high_load: when mean(tester.queue_len, 2.0) > 8
        => granularity dev->tester batch
    rule low_load hold 0.5: when mean(tester.queue_len, 2.0) <= 2
        => granularity dev->tester stream; reset tester-0.admit_priority_min
    # v2: event-triggered rules — fired by MetricBus threshold pushes
    # (or named controller events) BETWEEN interval polls
    rule burst on tester-0.queue_len > 12 hold 4:
        => scale tester-group +1; gate dev->tester on
    # workflow plane: `stage NAME` selects a registered stage.<NAME>
    # controllable / its exported stage.<NAME>.* gauges
    rule slow_review on stage reviewer.p95 > 2 hold 3:
        => set stage reviewer.model_tier small
    # disaggregation plane: flip an engine's phase role from fleet
    # pressure (`engine NAME` selects the engine's registered knobs)
    rule surge on cluster.prefill_pressure > 2 hold 1:
        => set engine e3.role prefill
    # tenancy plane: `tenant NAME` selects a registered tenant.<NAME>
    # controllable / its exported tenant.<NAME>.* rollups
    rule guard on tenant gold.p95_ttft > 1.5 hold 2:
        => set tenant batch.weight 0.2

Grammar (line oriented; '#' comments):

    objective: (minimize|maximize) EXPR [under COND]
    rule NAME [hold SECONDS] [on EVENT] [hold SECONDS]:
        [when COND] => ACTION (';' ACTION)*

    EVENT  := METRIC CMP NUMBER        (MetricBus threshold subscription)
            | NAME                     (named controller event, e.g.
                                        task_start, instance_failed)
    COND   := TERM (('and'|'or') TERM)*
    TERM   := AGG '(' METRIC [',' WINDOW] ')' CMP NUMBER
    METRIC := exact series name, or a glob (``tester-*.queue_len``)
              pooling every matching series fleet-wide;
              ``stage NAME.METRIC`` sugars to ``stage.NAME.METRIC``
              (the workflow plane's per-stage gauge namespace);
              ``engine NAME.METRIC`` sugars to ``NAME.METRIC``
              (engines register unprefixed);
              ``tenant NAME.METRIC`` sugars to ``tenant.NAME.METRIC``
              (the tenancy plane's per-tenant rollup namespace)
    ACTION := set [stage|engine|tenant] TARGET.KNOB VALUE
            | reset [stage|engine|tenant] TARGET.KNOB
            | granularity CHANNEL (batch|pipeline|stream)
            | route SESSION INSTANCE | pace CHANNEL SECONDS
            | scale GROUP (+N|-N|N) | gate CHANNEL (on|off)
            | transfer SESSION SRC DST
            | pin PREFIX | unpin PREFIX
            | trace (on|off|RATE)          (global span sampling)
            | trace (tenant|stage) NAME (on|off|RATE)
            | note TEXT

A rule must have a ``when`` condition, an ``on`` trigger, or both.

Tick rules are evaluated top-to-bottom each controller tick; **the first
rule whose condition holds fires** (guarded-command semantics — put the
most specific condition first), unless it is still within its ``hold``
window.  ``set`` is idempotent at the controller, so a firing rule does
not thrash knobs that already hold the target value.

``on`` rules are event-driven: installed on a controller with a
``MetricBus`` they become threshold subscriptions (fresh on-demand
poll, then the ``when`` guard, then the actions — all between interval
ticks).  With a ``hold`` the subscription is level-triggered and
``hold`` is the re-fire cooldown, so a *sustained* breach keeps firing
(e.g. keep adding replicas while overloaded); without one it is
edge-triggered and fires once per excursion.  Without a bus the rules
degrade gracefully to tick rules whose trigger becomes a
``last(METRIC) CMP NUMBER`` condition term, so the same program runs on
both control-plane generations.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.core.controller import ControlContext, Policy
from repro_torch.core.metrics import AGGREGATIONS


class IntentError(ValueError):
    pass


_CMP = {
    "<=": lambda a, b: a <= b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    ">": lambda a, b: a > b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
}

_TERM_RE = re.compile(
    r"^\s*(?P<agg>\w+)\s*\(\s*(?P<metric>[\w.>\-*?\[\]]+)"
    r"\s*(?:,\s*(?P<window>[\d.]+)\s*)?\)\s*"
    r"(?P<cmp><=|>=|==|!=|<|>)\s*(?P<num>-?[\d.]+(?:e-?\d+)?)\s*$")


@dataclass
class Term:
    agg: str
    metric: str
    window: float
    cmp: str
    value: float

    def eval(self, ctx: ControlContext) -> bool:
        v = ctx.metric(self.metric, self.agg, self.window,
                       default=float("nan"))
        if v != v:                      # NaN — metric not yet observed
            return False
        return _CMP[self.cmp](v, self.value)

    def describe(self, ctx: ControlContext) -> str:
        v = ctx.metric(self.metric, self.agg, self.window,
                       default=float("nan"))
        return f"{self.agg}({self.metric})={v:.4g} {self.cmp} {self.value}"


@dataclass
class Cond:
    terms: list[Term]
    ops: list[str]                     # 'and' | 'or' between terms

    def eval(self, ctx: ControlContext) -> bool:
        out = self.terms[0].eval(ctx)
        for op, term in zip(self.ops, self.terms[1:]):
            if op == "and":
                out = out and term.eval(ctx)
            else:
                out = out or term.eval(ctx)
        return out


def _parse_value(s: str):
    ls = s.lower()
    if ls in ("true", "false"):
        return ls == "true"
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        return s


# workflow-plane selector sugar: `stage reviewer.p95` names the series
# `stage.reviewer.p95` (and, in set/reset, the `stage.reviewer`
# controllable) — the grammar keeps the paper's "stage" vocabulary
# while the planes keep plain dotted names
_STAGE_SEL_RE = re.compile(r"\bstage\s+(?=[\w\-]+\.)")
# disaggregation-plane sugar: `engine e3.role` names the engine's plain
# registered name (`e3.role`) — engines register unprefixed, so the
# selector word simply drops, keeping rules like
# `on cluster.prefill_pressure > 2 => set engine e3.role prefill` readable
_ENGINE_SEL_RE = re.compile(r"\bengine\s+(?=[\w\-]+\.)")
# tenancy-plane sugar: `tenant gold.p95_ttft` names the series
# `tenant.gold.p95_ttft` (and, in set/reset, the `tenant.gold`
# controllable) — same shape as the stage selector
_TENANT_SEL_RE = re.compile(r"\btenant\s+(?=[\w\-]+\.)")


def _desugar_stage(text: str) -> str:
    text = _STAGE_SEL_RE.sub("stage.", text)
    text = _TENANT_SEL_RE.sub("tenant.", text)
    return _ENGINE_SEL_RE.sub("", text)


def _parse_cond(text: str, lineno: int) -> Cond:
    parts = re.split(r"\s+(and|or)\s+", _desugar_stage(text))
    terms, ops = [], []
    for i, p in enumerate(parts):
        if i % 2 == 1:
            ops.append(p)
            continue
        m = _TERM_RE.match(p)
        if not m:
            raise IntentError(f"line {lineno}: bad condition term {p!r}")
        agg = m.group("agg")
        if agg not in AGGREGATIONS:
            raise IntentError(f"line {lineno}: unknown aggregation {agg!r}")
        terms.append(Term(agg, m.group("metric"),
                          float(m.group("window") or "inf"),
                          m.group("cmp"), float(m.group("num"))))
    return Cond(terms, ops)


def _parse_action(text: str, lineno: int) -> Callable[[ControlContext], None]:
    toks = _desugar_stage(text).split()
    if not toks:
        raise IntentError(f"line {lineno}: empty action")
    op, args = toks[0], toks[1:]
    if op == "set" and len(args) == 2:
        target, _, knob = args[0].rpartition(".")
        value = _parse_value(args[1])
        if not target:
            raise IntentError(f"line {lineno}: set needs TARGET.KNOB")
        return lambda ctx: ctx.set(target, knob, value)
    if op == "reset" and len(args) == 1:
        target, _, knob = args[0].rpartition(".")
        if not target:
            raise IntentError(f"line {lineno}: reset needs TARGET.KNOB")
        return lambda ctx: ctx.reset(target, knob)
    if op == "granularity" and len(args) == 2:
        chan, mode = args
        return lambda ctx: ctx.granularity(chan, mode)
    if op == "pace" and len(args) == 2:
        chan, sec = args[0], float(args[1])
        return lambda ctx: ctx.set(chan, "pace", sec)
    if op == "route" and len(args) == 2:
        sess, inst = args
        return lambda ctx: ctx.route(sess, inst)
    if op == "scale" and len(args) == 2:
        group, amt = args
        if not re.fullmatch(r"[+-]?\d+", amt):
            raise IntentError(
                f"line {lineno}: scale needs GROUP +N|-N|N, got {amt!r}")
        if amt[0] in "+-":
            delta = int(amt)
            return lambda ctx: ctx.scale(group, delta)
        target = int(amt)
        return lambda ctx: ctx.scale_to(group, target)
    if op == "gate" and len(args) == 2:
        chan, sw = args
        if sw not in ("on", "off"):
            raise IntentError(
                f"line {lineno}: gate needs CHANNEL on|off, got {sw!r}")
        return lambda ctx: ctx.gate(chan, sw == "on")
    if op == "transfer" and len(args) == 3:
        sess, src, dst = args
        return lambda ctx: ctx.transfer_kv(sess, src, dst, proactive=True)
    if op == "pin" and len(args) == 1:
        prefix = args[0]
        return lambda ctx: ctx.pin(prefix)
    if op == "unpin" and len(args) == 1:
        prefix = args[0]
        return lambda ctx: ctx.unpin(prefix)
    if op == "trace" and len(args) in (1, 3):
        def _rate(tok: str) -> float:
            if tok == "on":
                return 1.0
            if tok == "off":
                return 0.0
            try:
                r = float(tok)
            except ValueError:
                raise IntentError(
                    f"line {lineno}: trace rate must be on|off|FLOAT, "
                    f"got {tok!r}") from None
            if not 0.0 <= r <= 1.0:
                raise IntentError(
                    f"line {lineno}: trace rate {r:g} outside [0, 1]")
            return r
        if len(args) == 1:
            rate = _rate(args[0])
            return lambda ctx: ctx.trace(None, rate)
        sel, scope_name, tok = args
        if sel not in ("tenant", "stage"):
            raise IntentError(
                f"line {lineno}: trace selector must be tenant|stage, "
                f"got {sel!r}")
        rate = _rate(tok)
        scope = f"{sel}:{scope_name}"
        return lambda ctx: ctx.trace(scope, rate)
    if op == "note":
        text_ = " ".join(args)
        return lambda ctx: ctx.note("intent", text_)
    raise IntentError(f"line {lineno}: unknown action {text!r}")


_TRIGGER_RE = re.compile(
    r"^(?P<metric>[\w.>\-*?\[\]]+)\s*(?P<cmp><=|>=|==|!=|<|>)\s*"
    r"(?P<num>-?[\d.]+(?:e-?\d+)?)$")
_EVENT_NAME_RE = re.compile(r"^[\w\-]+$")


@dataclass(frozen=True)
class Trigger:
    """``on`` clause of a v2 rule: a metric threshold (MetricBus
    subscription) or a named controller event (task_start, ...)."""

    event: Optional[str] = None
    metric: Optional[str] = None
    cmp: Optional[str] = None
    value: Optional[float] = None

    def as_term(self) -> Term:
        """Tick-path fallback when no MetricBus is attached."""
        return Term("last", self.metric, float("inf"), self.cmp, self.value)

    def describe(self) -> str:
        if self.event is not None:
            return self.event
        return f"{self.metric} {self.cmp} {self.value:g}"


def _parse_trigger(text: str, lineno: int) -> Trigger:
    text = _desugar_stage(text.strip())
    m = _TRIGGER_RE.match(text)
    if m:
        return Trigger(metric=m.group("metric"), cmp=m.group("cmp"),
                       value=float(m.group("num")))
    if _EVENT_NAME_RE.match(text):
        return Trigger(event=text)
    raise IntentError(f"line {lineno}: bad trigger {text!r} "
                      "(want METRIC CMP NUMBER or an event name)")


@dataclass
class IntentRule:
    name: str
    cond: Optional[Cond]
    actions: list[Callable]
    hold: float = 0.0
    trigger: Optional[Trigger] = None
    bus_bound: bool = False            # trigger registered on a MetricBus
    last_fired: float = -1e18
    fire_count: int = 0

    def _guard_holds(self, ctx: ControlContext, from_event: bool) -> bool:
        # on the tick path an unbound metric trigger degrades to a
        # last(METRIC) CMP NUMBER term; on the event path the bus already
        # established it, so only the explicit `when` guard remains
        if (not from_event and self.trigger is not None
                and self.trigger.metric is not None):
            if not self.trigger.as_term().eval(ctx):
                return False
        if self.cond is not None and not self.cond.eval(ctx):
            return False
        return True

    def maybe_fire(self, ctx: ControlContext, from_event: bool = False) -> bool:
        if not self._guard_holds(ctx, from_event):
            return False
        if ctx.now - self.last_fired < self.hold:
            return not from_event       # matched but held: still consumes
        self.last_fired = ctx.now
        self.fire_count += 1
        for act in self.actions:
            act(ctx)
        return True


@dataclass
class Objective:
    direction: str                      # minimize | maximize
    expr: str
    constraint: Optional[str] = None

    def describe(self) -> str:
        s = f"{self.direction} {self.expr}"
        if self.constraint:
            s += f" under {self.constraint}"
        return s


class IntentPolicy(Policy):
    """A compiled intent program: guarded rules over the state store,
    plus v2 event rules bound to the controller's MetricBus."""

    def __init__(self, objective: Optional[Objective],
                 rules: list[IntentRule], source: str = ""):
        self.objective = objective
        self.rules = rules
        self.source = source
        self.name = "intent"

    # -- bind time ----------------------------------------------------------
    def on_install(self, controller) -> None:
        bus = getattr(controller, "bus", None)
        if bus is None:
            return                     # metric triggers degrade to tick path
        for rule in self.rules:
            trig = rule.trigger
            if trig is None or trig.metric is None:
                continue
            cmp_fn = _CMP[trig.cmp]
            # with a hold, level-trigger so a sustained breach re-fires
            # every `hold` seconds (e.g. keep scaling while overloaded);
            # without one, edge-trigger so it can't storm
            bus.subscribe(
                trig.metric,
                predicate=lambda v, f=cmp_fn, x=trig.value: f(v, x),
                cooldown=rule.hold, edge=rule.hold <= 0,
                fn=lambda name, value, t, r=rule: controller.fire_on_event(
                    lambda ctx: r.maybe_fire(ctx, from_event=True),
                    reason=f"rule {r.name}: {name}={value:.4g}"))
            rule.bus_bound = True

    # -- interval path -------------------------------------------------------
    def on_tick(self, ctx: ControlContext) -> None:
        for rule in self.rules:
            if rule.trigger is not None and (rule.bus_bound
                                             or rule.trigger.event):
                continue               # event rules never tick
            if rule.maybe_fire(ctx):
                return                 # guarded commands: first match wins

    # -- event path ----------------------------------------------------------
    def on_event(self, ctx: ControlContext, kind: str, **kw) -> None:
        fresh = False
        for rule in self.rules:
            if rule.trigger is not None and rule.trigger.event == kind:
                if not fresh:
                    ctx.refresh()      # `when` guards read current metrics,
                    fresh = True       # not the previous tick's window
                rule.maybe_fire(ctx, from_event=True)

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict[str, int]:
        return {r.name: r.fire_count for r in self.rules}


_RULE_RE = re.compile(
    r"^rule\s+(?P<name>[\w\-]+)"
    r"(?:\s+hold\s+(?P<hold>[\d.]+))?"
    r"(?:\s+on\s+(?P<event>.+?))?"
    r"(?:\s+hold\s+(?P<hold2>[\d.]+))?"
    r"\s*:\s*(?:when\s+(?P<cond>.+?)\s*)?=>\s*(?P<actions>.+)$")
_OBJ_RE = re.compile(
    r"^objective\s*:\s*(?P<dir>minimize|maximize)\s+(?P<expr>.+?)"
    r"(?:\s+under\s+(?P<constraint>.+))?$")


def compile_intent(text: str) -> IntentPolicy:
    objective: Optional[Objective] = None
    rules: list[IntentRule] = []
    # allow rules to wrap onto continuation lines (indented)
    logical: list[tuple[int, str]] = []
    for i, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        if line[0].isspace() and logical:
            n, prev = logical[-1]
            logical[-1] = (n, prev + " " + line.strip())
        else:
            logical.append((i, line.strip()))
    for lineno, line in logical:
        m = _OBJ_RE.match(line)
        if m:
            objective = Objective(m.group("dir"), m.group("expr"),
                                  m.group("constraint"))
            continue
        m = _RULE_RE.match(line)
        if m:
            if m.group("hold") and m.group("hold2"):
                raise IntentError(f"line {lineno}: 'hold' given twice")
            trigger = (None if m.group("event") is None
                       else _parse_trigger(m.group("event"), lineno))
            cond = (None if m.group("cond") is None
                    else _parse_cond(m.group("cond"), lineno))
            if cond is None and trigger is None:
                raise IntentError(f"line {lineno}: rule "
                                  f"{m.group('name')!r} needs a 'when' "
                                  "condition or an 'on' trigger")
            actions = [_parse_action(a.strip(), lineno)
                       for a in m.group("actions").split(";") if a.strip()]
            rules.append(IntentRule(
                m.group("name"), cond, actions, trigger=trigger,
                hold=float(m.group("hold") or m.group("hold2") or 0.0)))
            continue
        raise IntentError(f"line {lineno}: cannot parse {line!r}")
    if not rules:
        raise IntentError("intent program has no rules")
    return IntentPolicy(objective, rules, source=text)
