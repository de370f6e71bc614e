"""DET rules: iteration order and float accumulation.

Golden artifacts are byte-compared in CI, so any value derived from
Python's *insertion-ordered-but-history-dependent* dict/set iteration
is a latent nondeterminism bug: two code paths that build the same
mapping in different orders produce different bytes.  The sweep's winner
table and the fairshare ledger both hit this class.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional

from repro_torch.lint.core import (Finding, Module, Rule, register,
                                   terminal_name)

# Consumers that cannot observe iteration order.  ``sum`` is listed here
# because DET002 owns it: integer sums are order-free, float sums are a
# distinct (worse) bug class with its own rule below.
ORDER_INSENSITIVE = {"sorted", "set", "frozenset", "sum", "any", "all",
                     "max", "min", "len", "Counter"}

UNORDERED_METHODS = {"values", "items", "keys"}


def unordered_source(node: ast.AST) -> Optional[str]:
    """Describe ``node`` when it iterates in unordered/history-dependent
    order: ``d.values()/.items()/.keys()``, ``set(...)``, set displays."""
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in UNORDERED_METHODS and \
                not node.args and not node.keywords:
            return f".{node.func.attr}()"
        if isinstance(node.func, ast.Name) and \
                node.func.id in ("set", "frozenset"):
            return f"{node.func.id}()"
    if isinstance(node, ast.Set):
        return "set literal"
    if isinstance(node, ast.SetComp):
        return "set comprehension"
    return None


def _consumer_name(mod: Module, node: ast.AST) -> Optional[str]:
    """Name of the call directly consuming a comprehension, if any."""
    parent = mod.parent(node)
    if isinstance(parent, ast.Call) and node in parent.args:
        return terminal_name(parent.func)
    return None


@register
class UnsortedIterationRule(Rule):
    rule_id = "DET001"
    title = ("unordered dict/set iteration in a determinism-critical "
             "module; wrap in sorted() or consume order-insensitively")

    def run(self, mod: Module) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.For):
                src = unordered_source(node.iter)
                if src:
                    yield self.finding(
                        mod, node.iter,
                        f"for-loop over {src}: iteration order is "
                        f"history-dependent; use sorted()")
            elif isinstance(node, (ast.ListComp, ast.SetComp,
                                   ast.DictComp, ast.GeneratorExp)):
                consumer = _consumer_name(mod, node)
                if consumer in ORDER_INSENSITIVE:
                    continue
                for comp in node.generators:
                    src = unordered_source(comp.iter)
                    if src:
                        yield self.finding(
                            mod, comp.iter,
                            f"comprehension over {src}: iteration order "
                            f"is history-dependent; use sorted()")


def _int_safe_element(elt: ast.AST) -> bool:
    """Elements whose sum is order-free: integer literals and len()."""
    if isinstance(elt, ast.Constant) and isinstance(elt.value, int):
        return True
    if isinstance(elt, ast.Call) and isinstance(elt.func, ast.Name) and \
            elt.func.id in ("len", "int"):
        return True
    return False


@register
class FloatSumOrderRule(Rule):
    rule_id = "DET002"
    title = ("float accumulation (sum) over an unsorted unordered "
             "iterable; float addition is not associative")

    def run(self, mod: Module) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call) and
                    isinstance(node.func, ast.Name) and
                    node.func.id == "sum" and node.args):
                continue
            arg = node.args[0]
            if isinstance(arg, (ast.GeneratorExp, ast.ListComp)):
                if _int_safe_element(arg.elt):
                    continue
                for comp in arg.generators:
                    src = unordered_source(comp.iter)
                    if src:
                        yield self.finding(
                            mod, comp.iter,
                            f"sum over {src}: float accumulation order "
                            f"is history-dependent; sort first or prove "
                            f"the elements integral")
            else:
                src = unordered_source(arg)
                if src:
                    yield self.finding(
                        mod, arg,
                        f"sum({src.lstrip('.')}): float accumulation "
                        f"order is history-dependent; sort first")
