"""repro_torch.lint — repo-specific determinism/invariant static analysis.

Usage::

    PYTHONPATH=src python -m repro_torch.lint src/ [tests/] [--json] [--check]

Rules (each encodes a bug class that shipped in a past PR; see
``docs/determinism.md`` for the contract they enforce):

=======  ===================================================================
DET001   unordered dict/set iteration in determinism-critical modules
DET002   float accumulation (sum) over unsorted unordered iterables
ENT001   wall-clock / entropy calls outside sanctioned seeded-RNG helpers
CAP001   ``config.num_nodes`` reads outside cluster.py (use live_capacity)
ENG001   engine Event dataclasses missing ``frozen=True, slots=True``
ENG002   epoch-carrying event handlers without an epoch guard
MUT001   mutable / constructor-call default arguments
MUT002   module-level mutable state (non-ALL_CAPS bindings)
=======  ===================================================================

Suppress a true-but-intended finding with ``# lint: disable=RULE`` on
the flagged line, always with a justification comment.
"""
from repro_torch.lint.core import (CRITICAL_DIRS, Finding, Module, REGISTRY,
                             Rule, SCHEMA, lint_paths, lint_source,
                             make_rules, register, render_json,
                             to_json_doc)
# importing the rule modules populates REGISTRY
from repro_torch.lint import rules_capacity    # noqa: F401
from repro_torch.lint import rules_determinism  # noqa: F401
from repro_torch.lint import rules_engine      # noqa: F401
from repro_torch.lint import rules_entropy     # noqa: F401
from repro_torch.lint import rules_state       # noqa: F401

__all__ = ["CRITICAL_DIRS", "Finding", "Module", "REGISTRY", "Rule",
           "SCHEMA", "lint_paths", "lint_source", "make_rules",
           "register", "render_json", "to_json_doc"]
