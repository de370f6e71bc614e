"""MUT rules: shared mutable state.

MUT001 — default argument values are evaluated once at ``def`` time
and shared across every call: a mutable default (or any constructor
call) aliases state between independent simulations — the
``SimConfig()``-default bug class where one sweep point's band edits
leaked into the next.

MUT002 — module-level mutable bindings are process-global state that
survives across runs in one interpreter; ALL_CAPS constants (frozen
registries populated at import time) and dunders are exempt by
convention, everything else needs a pragma with a justification.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional

from repro_torch.lint.core import (Finding, Module, Rule, register,
                                   terminal_name)

IMMUTABLE_CALLS = {"tuple", "frozenset", "int", "float", "str", "bool",
                   "bytes"}
MUTABLE_CALLS = {"dict", "list", "set", "defaultdict", "OrderedDict",
                 "Counter", "deque"}
MUTABLE_DISPLAYS = (ast.List, ast.Dict, ast.Set, ast.ListComp,
                    ast.SetComp, ast.DictComp)


def _default_problem(node: ast.AST) -> Optional[str]:
    if isinstance(node, MUTABLE_DISPLAYS):
        return "mutable literal"
    if isinstance(node, ast.Call):
        name = terminal_name(node.func)
        if name in IMMUTABLE_CALLS:
            return None
        return f"call to {name or 'expression'}()"
    return None


@register
class MutableDefaultRule(Rule):
    rule_id = "MUT001"
    title = ("mutable (or constructor-call) default argument: evaluated "
             "once at def time and shared across calls")

    def run(self, mod: Module) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef, ast.Lambda)):
                continue
            defaults = list(node.args.defaults) + \
                [d for d in node.args.kw_defaults if d is not None]
            for default in defaults:
                problem = _default_problem(default)
                if problem:
                    yield self.finding(
                        mod, default, f"default argument is a {problem}: "
                        f"one shared instance across all calls; default "
                        f"to None and construct inside the function")


def _is_constant_name(name: str) -> bool:
    return name.upper() == name or \
        (name.startswith("__") and name.endswith("__"))


@register
class ModuleMutableStateRule(Rule):
    rule_id = "MUT002"
    title = ("module-level mutable state (non-ALL_CAPS binding): "
             "process-global, survives across runs")

    def run(self, mod: Module) -> Iterator[Finding]:
        for stmt in mod.tree.body:
            if isinstance(stmt, ast.Assign):
                targets, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets, value = [stmt.target], stmt.value
            else:
                continue
            mutable = isinstance(value, MUTABLE_DISPLAYS) or (
                isinstance(value, ast.Call) and
                terminal_name(value.func) in MUTABLE_CALLS)
            if not mutable:
                continue
            for target in targets:
                if isinstance(target, ast.Name) and \
                        not _is_constant_name(target.id):
                    yield self.finding(
                        mod, stmt, f"module-level mutable binding "
                        f"{target.id!r}: shared process-global state; "
                        f"make it a function-local, a constant "
                        f"(ALL_CAPS), or pragma with a justification")
