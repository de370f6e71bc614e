"""ENT rules: wall-clock, entropy, and ad-hoc output in simulation code.

The simulator's outputs must be a pure function of (workload, config,
seed).  Any wall-clock or unseeded-RNG call inside a determinism-
critical module can leak host state into a golden artifact.  The one
sanctioned timing call is ``time.perf_counter`` — used to *measure*
in-process policy latency, which is reported out-of-band
(``SimReport.policy_wall_s``) and never injected into simulation time.

ENT002 extends the discipline to *reporting*: library code under
``repro_torch.rms``/``repro_torch.obs`` must not ``print()`` or write to
stdout/stderr directly — results flow through returned artifacts or the
observability layer (:mod:`repro_torch.obs`), so traced and untraced runs
emit identical streams.  The one sanctioned surface is a module's
``main()`` CLI entry point.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.lint.core import Finding, Module, Rule, dotted_parts, register

TIME_MODULES = {"time", "_time"}
BANNED_TIME_ATTRS = {"time", "time_ns", "monotonic", "monotonic_ns",
                     "sleep"}
DATETIME_ATTRS = {"now", "utcnow", "today"}
NUMPY_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "PCG64",
                   "Philox", "BitGenerator"}


@register
class EntropyRule(Rule):
    rule_id = "ENT001"
    title = ("wall-clock/entropy call outside the sanctioned seeded-RNG "
             "helpers (np.random.default_rng(seed), time.perf_counter)")

    def run(self, mod: Module) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            parts = dotted_parts(node.func)
            if not parts or len(parts) < 2:
                continue
            head, tail = parts[0], parts[-1]
            if head in TIME_MODULES and len(parts) == 2 and \
                    tail in BANNED_TIME_ATTRS:
                yield self.finding(
                    mod, node, f"{'.'.join(parts)}() reads the wall "
                    f"clock; simulation time must come from the engine")
            elif head == "datetime" and tail in DATETIME_ATTRS:
                yield self.finding(
                    mod, node, f"{'.'.join(parts)}() reads the wall "
                    f"clock; thread timestamps in explicitly")
            elif head == "random":
                # the stdlib global RNG is process-state; a seeded
                # random.Random(seed) instance is the only sanctioned use
                if tail == "Random" and node.args:
                    continue
                yield self.finding(
                    mod, node, f"{'.'.join(parts)}() uses the process-"
                    f"global RNG; use a seeded np.random.default_rng")
            elif head in ("np", "numpy") and len(parts) >= 3 and \
                    parts[1] == "random":
                if tail == "default_rng":
                    if not node.args:
                        yield self.finding(
                            mod, node, "np.random.default_rng() without "
                            "a seed draws OS entropy; pass the config "
                            "seed")
                elif tail not in NUMPY_RANDOM_OK:
                    yield self.finding(
                        mod, node, f"legacy {'.'.join(parts)}() uses "
                        f"numpy's global RNG; use a seeded "
                        f"np.random.default_rng")


@register
class AdHocOutputRule(Rule):
    rule_id = "ENT002"
    title = ("print()/stdout/stderr write in library code; report through "
             "repro.obs artifacts (main() entry points are exempt)")
    domains = ("rms", "obs")

    STREAMS = {"stdout", "stderr"}
    WRITE_ATTRS = {"write", "writelines"}

    def _in_main(self, mod: Module, node: ast.AST) -> bool:
        while node is not None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return node.name == "main"
            node = mod.parent(node)
        return False

    def run(self, mod: Module) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if isinstance(func, ast.Name) and func.id == "print":
                if not self._in_main(mod, node):
                    yield self.finding(
                        mod, node, "print() in library code writes to the "
                        "process stream; return data or record it via "
                        "repro.obs")
                continue
            parts = dotted_parts(func)
            if not parts or len(parts) < 2:
                continue
            if parts[-1] in self.WRITE_ATTRS and \
                    parts[-2] in self.STREAMS and \
                    not self._in_main(mod, node):
                yield self.finding(
                    mod, node, f"{'.'.join(parts)}() is an ad-hoc stream "
                    f"write in library code; report through repro.obs "
                    f"artifacts")
