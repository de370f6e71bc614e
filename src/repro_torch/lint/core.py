"""AST lint framework for the repo's determinism contract.

Layer 1 of the correctness tooling (`docs/determinism.md`): a small
rule registry + file walker + pragma handling + stable JSON output.
Rules are repo-specific — each encodes a bug class that actually
shipped in a past PR (stale ``config.num_nodes`` denominators,
unsorted dict iteration feeding golden artifacts, duplicated
epoch-guard chains, …) so the byte-determinism and conservation
contracts are enforced by tooling instead of rediscovered per PR.

Suppression: a finding on line N is suppressed by ``# lint:
disable=RULE`` (comma-separated ids, or ``all``) on that same line.
Every pragma in the tree should carry a justification comment.

The JSON document (``--json``) is schema-stable and fully
deterministic: no timestamps, findings sorted by
``(path, line, col, rule)`` — safe to golden-compare in CI.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import posixpath
import re
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Type

SCHEMA = "repro.lint/v1"

PRAGMA_RE = re.compile(r"#\s*lint:\s*disable=([A-Za-z0-9_,\s]+)")

# Subdirectory names whose modules are determinism-critical: golden
# artifacts and conservation invariants are derived from what runs here.
CRITICAL_DIRS: Tuple[str, ...] = ("rms", "calib", "workload")


@dataclasses.dataclass(frozen=True, slots=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str

    @property
    def sort_key(self) -> Tuple[str, int, int, str]:
        return (self.path, self.line, self.col, self.rule)

    def to_dict(self) -> Dict[str, object]:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message}

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: " \
               f"{self.rule} {self.message}"


class Module:
    """One parsed source file plus the per-file analysis context."""

    def __init__(self, source: str, path: str):
        self.source = source
        self.path = path.replace(os.sep, "/")
        self.name = posixpath.basename(self.path)
        self.tree = ast.parse(source, filename=path)
        self._parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent
        # line -> set of rule ids disabled on that line ("all" wildcard)
        self.disabled: Dict[int, set] = {}
        for lineno, text in enumerate(source.splitlines(), 1):
            m = PRAGMA_RE.search(text)
            if m:
                self.disabled[lineno] = {
                    r.strip() for r in m.group(1).split(",") if r.strip()}

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(node)

    def in_dirs(self, names: Sequence[str]) -> bool:
        """True when the file lives under any of the named subdirs."""
        probe = "/" + self.path
        return any(f"/{n}/" in probe for n in names)

    def suppressed(self, finding: Finding) -> bool:
        rules = self.disabled.get(finding.line)
        return bool(rules) and (finding.rule in rules or "all" in rules)


class Rule:
    """Base rule: subclass, set ``rule_id``/``title``, implement ``run``."""

    rule_id: str = ""
    title: str = ""
    # Only files under these subdirs are checked; () means every file.
    domains: Tuple[str, ...] = CRITICAL_DIRS

    def applies(self, mod: Module) -> bool:
        return not self.domains or mod.in_dirs(self.domains)

    def run(self, mod: Module) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, mod: Module, node: ast.AST, message: str) -> Finding:
        return Finding(self.rule_id, mod.path,
                       getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0), message)


REGISTRY: Dict[str, Type[Rule]] = {}


def register(cls: Type[Rule]) -> Type[Rule]:
    if not cls.rule_id:
        raise ValueError(f"{cls.__name__} has no rule_id")
    if cls.rule_id in REGISTRY:
        raise ValueError(f"duplicate rule id {cls.rule_id}")
    REGISTRY[cls.rule_id] = cls
    return cls


def make_rules(select: Optional[Sequence[str]] = None,
               ignore: Optional[Sequence[str]] = None) -> List[Rule]:
    ids = sorted(REGISTRY)
    if select:
        unknown = sorted(set(select) - set(ids))
        if unknown:
            raise ValueError(f"unknown rule ids: {unknown}")
        ids = [i for i in ids if i in set(select)]
    if ignore:
        ids = [i for i in ids if i not in set(ignore)]
    return [REGISTRY[i]() for i in ids]


# -- helpers shared by rule modules ------------------------------------------

def dotted_parts(node: ast.AST) -> Optional[List[str]]:
    """``a.b.c`` -> ["a", "b", "c"]; None when the chain doesn't end in a
    plain name (e.g. a call result)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return None


def terminal_name(node: ast.AST) -> Optional[str]:
    """Last component of a Name/Attribute expression."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


# -- driving -----------------------------------------------------------------

def lint_module(mod: Module, rules: Sequence[Rule]) -> List[Finding]:
    out: List[Finding] = []
    for rule in rules:
        if not rule.applies(mod):
            continue
        for f in rule.run(mod):
            if not mod.suppressed(f):
                out.append(f)
    return out


def lint_source(source: str, path: str = "<string>",
                select: Optional[Sequence[str]] = None,
                ignore: Optional[Sequence[str]] = None) -> List[Finding]:
    """Lint one source string; ``path`` decides domain scoping (a fixture
    passed as ``rms/x.py`` is checked as a determinism-critical module)."""
    rules = make_rules(select, ignore)
    try:
        mod = Module(source, path)
    except SyntaxError as exc:
        return [Finding("E000", path.replace(os.sep, "/"),
                        exc.lineno or 1, (exc.offset or 1) - 1,
                        f"syntax error: {exc.msg}")]
    return sorted(lint_module(mod, rules), key=lambda f: f.sort_key)


def iter_files(paths: Sequence[str]) -> Iterator[str]:
    for path in paths:
        if os.path.isfile(path):
            yield path
            continue
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(d for d in dirs
                             if not d.startswith(".") and d != "__pycache__")
            for name in sorted(files):
                if name.endswith(".py"):
                    yield os.path.join(root, name)


def lint_paths(paths: Sequence[str],
               select: Optional[Sequence[str]] = None,
               ignore: Optional[Sequence[str]] = None) -> List[Finding]:
    rules = make_rules(select, ignore)
    out: List[Finding] = []
    for path in iter_files(paths):
        with open(path, "r", encoding="utf-8") as fh:
            source = fh.read()
        try:
            mod = Module(source, path)
        except SyntaxError as exc:
            out.append(Finding("E000", path.replace(os.sep, "/"),
                               exc.lineno or 1, (exc.offset or 1) - 1,
                               f"syntax error: {exc.msg}"))
            continue
        out.extend(lint_module(mod, rules))
    return sorted(out, key=lambda f: f.sort_key)


def to_json_doc(findings: Sequence[Finding],
                rules: Sequence[Rule]) -> Dict[str, object]:
    """Deterministic machine-readable report (no timestamps, stable sort)."""
    return {
        "schema": SCHEMA,
        "rules": {r.rule_id: r.title for r in
                  sorted(rules, key=lambda r: r.rule_id)},
        "findings": [f.to_dict() for f in
                     sorted(findings, key=lambda f: f.sort_key)],
    }


def render_json(findings: Sequence[Finding], rules: Sequence[Rule]) -> str:
    return json.dumps(to_json_doc(findings, rules), indent=1, sort_keys=True)
