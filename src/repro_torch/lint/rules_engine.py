"""ENG rules: engine event hygiene.

ENG001 — event dataclasses are allocated once per scheduled event
(millions in a big sweep) and live in the heap: they must be
``frozen=True, slots=True``.

ENG002 — the epoch-guard pattern: handlers for events that carry an
``epoch`` (ReconfigPoint / CheckpointTick / PhaseChange /
ExpandTimeout — the chains that survive a requeue/restart) must
consult that epoch, otherwise a stale chain left in the heap from a
prior start doubles the check frequency or mutates a restarted job's
band (the duplicated-chain bug class).
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, Optional

from repro_torch.lint.core import (Finding, Module, Rule, register,
                                   terminal_name)

EPOCH_EVENTS = {"ReconfigPoint", "CheckpointTick", "PhaseChange",
                "ExpandTimeout", "TrafficTick"}


def _dataclass_decorator(cls: ast.ClassDef) -> Optional[ast.AST]:
    for deco in cls.decorator_list:
        target = deco.func if isinstance(deco, ast.Call) else deco
        if terminal_name(target) == "dataclass":
            return deco
    return None


def _is_event_class(cls: ast.ClassDef) -> bool:
    if cls.name == "Event":
        return _dataclass_decorator(cls) is not None
    return any(terminal_name(base) == "Event" for base in cls.bases)


@register
class EventSlotsRule(Rule):
    rule_id = "ENG001"
    title = ("engine Event dataclasses must be declared "
             "@dataclass(frozen=True, slots=True)")
    domains = ("rms",)

    def run(self, mod: Module) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.ClassDef) and
                    _is_event_class(node)):
                continue
            deco = _dataclass_decorator(node)
            if deco is None:
                has_slots = any(
                    isinstance(stmt, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == "__slots__"
                        for t in stmt.targets)
                    for stmt in node.body)
                if not has_slots:
                    yield self.finding(
                        mod, node, f"event class {node.name} has neither "
                        f"a slotted dataclass decorator nor __slots__")
                continue
            kwargs = {kw.arg: kw.value for kw in deco.keywords} \
                if isinstance(deco, ast.Call) else {}
            missing = [name for name in ("frozen", "slots")
                       if not (isinstance(kwargs.get(name), ast.Constant)
                               and kwargs[name].value is True)]
            if missing:
                yield self.finding(
                    mod, node, f"event class {node.name} missing "
                    f"{'/'.join(name + '=True' for name in missing)} in "
                    f"its dataclass decorator")


def _mentions_epoch(node: ast.AST) -> bool:
    return any((isinstance(n, ast.Attribute) and n.attr == "epoch") or
               (isinstance(n, ast.Name) and n.id == "epoch")
               for n in ast.walk(node))


def _collect_functions(mod: Module) -> Dict[str, ast.AST]:
    out: Dict[str, ast.AST] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, node)
    return out


@register
class EpochGuardRule(Rule):
    rule_id = "ENG002"
    title = ("handler registered for an epoch-carrying event must "
             "consult the event's epoch (stale-chain guard)")
    domains = ("rms",)

    def run(self, mod: Module) -> Iterator[Finding]:
        functions = _collect_functions(mod)
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call) and
                    isinstance(node.func, ast.Attribute) and
                    node.func.attr == "on" and len(node.args) >= 2):
                continue
            event_name = terminal_name(node.args[0])
            if event_name not in EPOCH_EVENTS:
                continue
            handler = node.args[1]
            if isinstance(handler, ast.Lambda):
                body: Optional[ast.AST] = handler
            else:
                name = terminal_name(handler)
                body = functions.get(name) if name else None
            if body is None:
                continue        # dynamically built handler: can't resolve
            if not _mentions_epoch(body):
                yield self.finding(
                    mod, node, f"handler for {event_name} never reads "
                    f"the event epoch; a stale chain from a prior start "
                    f"will not die at the guard")
