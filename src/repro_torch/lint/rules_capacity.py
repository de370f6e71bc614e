"""CAP rules: the live-capacity denominator contract.

The bug class: after node churn (failures, drains, joins, power
cycling) the construction-time ``config.num_nodes`` is *initial*
capacity, not current capacity.  Every denominator, clamp ceiling, and
normalization in ``rms/`` must read ``cluster.live_capacity`` instead;
``cluster.py`` itself (which owns the lifecycle accounting) is the one
module allowed to touch ``num_nodes``.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.lint.core import Finding, Module, Rule, register


@register
class StaleCapacityRule(Rule):
    rule_id = "CAP001"
    title = ("config.num_nodes read outside cluster.py; "
             "cluster.live_capacity is the only legal denominator")
    domains = ("rms",)

    def applies(self, mod: Module) -> bool:
        return super().applies(mod) and mod.name != "cluster.py"

    def run(self, mod: Module) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Attribute) and
                    node.attr == "num_nodes"):
                continue
            base = node.value
            if (isinstance(base, ast.Name) and
                    base.id in ("config", "cfg")) or \
                    (isinstance(base, ast.Attribute) and
                     base.attr == "config"):
                yield self.finding(
                    mod, node, "config.num_nodes is initial capacity, "
                    "stale after churn; use cluster.live_capacity")
