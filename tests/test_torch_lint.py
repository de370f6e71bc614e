"""The port's determinism linter (``repro_torch.lint``) against the JAX
package's (``repro.lint``), on the CPU.

Every test of ``tests/test_lint.py`` runs against the port's linter (its
module's names bound to the port's, its local imports of the rms, calib
and workload modules it pins bound to the port's), the CLI case through
``python -m repro_torch.lint``. Then the two linters must agree: the same
findings for each fixture of that file, the same JSON report over
``src/`` and ``tests/`` byte for byte, the same rules, and the port's
tree clean under its own linter.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import repro.lint as ref_lint  # noqa: E402
import test_lint as ref_lint_test  # noqa: E402
from test_torch_sweep import (bind_modules, module_twin,  # noqa: E402
                              reference_cases, reference_objects, run_case)

import repro_torch.lint as lint  # noqa: E402
from repro_torch.calib import measure  # noqa: E402
from repro_torch.lint import core  # noqa: E402
from repro_torch.rms import (cluster, policy, scheduler,  # noqa: E402
                             simulator, sweep)
from repro_torch.workload import swf  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
TESTS = os.path.join(REPO, "tests")
# the modules the reference test imports in its bodies
LOCAL_IMPORTS = {"repro.rms.policy": policy, "repro.rms.scheduler": scheduler,
                 "repro.rms.simulator": simulator,
                 "repro.rms.cluster": cluster, "repro.rms.sweep": sweep,
                 "repro.calib.measure": measure, "repro.workload.swf": swf}


def port_cli_check_mode_exit_codes(tmp_path):
    """tests/test_lint.py's ``test_cli_check_mode_exit_codes`` through
    ``python -m repro_torch.lint``."""
    env = dict(os.environ, PYTHONPATH=SRC)
    clean = subprocess.run(
        [sys.executable, "-m", "repro_torch.lint", SRC, "--check"],
        capture_output=True, text=True, env=env)
    assert clean.returncode == 0, clean.stdout + clean.stderr
    dirty = tmp_path / "rms"
    dirty.mkdir()
    (dirty / "bad.py").write_text("t0 = time.time()\n")
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.lint", str(tmp_path), "--json"],
        capture_output=True, text=True, env=env)
    assert run.returncode == 1
    doc = json.loads(run.stdout)
    assert [f["rule"] for f in doc["findings"]] == ["ENT001"]


LINT_TWIN = module_twin(
    ref_lint_test, REGISTRY=lint.REGISTRY, SCHEMA=lint.SCHEMA,
    test_cli_check_mode_exit_codes=port_cli_check_mode_exit_codes)


def findings_of(findings):
    return [f.to_dict() for f in findings]


def both_lint_source(source, path="<string>", **kw):
    """Lint ``source`` with both linters; their findings (rule, path, line,
    col, message) must be equal. Returns the port's."""
    got = lint.lint_source(source, path=path, **kw)
    assert findings_of(got) == findings_of(
        ref_lint.lint_source(source, path=path, **kw))
    return got


AGREE_TWIN = module_twin(ref_lint_test, lint_source=both_lint_source)


def test_twins_hold_only_the_ports_objects():
    assert LINT_TWIN["lint_source"] is lint.lint_source
    assert LINT_TWIN["Finding"] is core.Finding
    assert LINT_TWIN["REGISTRY"] is lint.REGISTRY
    assert reference_objects(LINT_TWIN) == []


@pytest.mark.parametrize("name,arguments", reference_cases(ref_lint_test))
def test_reference_lint_case_on_port(name, arguments, request, monkeypatch):
    """tests/test_lint.py against the port's linter: each rule's positive,
    negative and pragma fixtures, the framework, the JSON schema, the
    committed tree lint-clean, the CLI's exit codes and the regression
    pins on the port's modules."""
    bind_modules(monkeypatch, LOCAL_IMPORTS)
    run_case(LINT_TWIN, name, arguments, request)


def lints_fixtures(fn):
    return bool({"lint_rms", "lint_source"} & set(fn.__code__.co_names))


@pytest.mark.parametrize("name,arguments",
                         reference_cases(ref_lint_test, lints_fixtures))
def test_fixture_findings_equal_reference(name, arguments, request):
    """Each fixture source of tests/test_lint.py gives the same findings
    from both linters (the test's own assertions hold as well)."""
    run_case(AGREE_TWIN, name, arguments, request)


def test_json_report_over_src_and_tests_equals_reference():
    paths = [SRC, TESTS]
    got = lint.render_json(lint.lint_paths(paths), lint.make_rules())
    want = ref_lint.render_json(ref_lint.lint_paths(paths),
                                ref_lint.make_rules())
    assert got == want
    assert json.loads(got)["schema"] == "repro.lint/v1"


def test_registry_equals_reference():
    assert sorted(lint.REGISTRY) == sorted(ref_lint.REGISTRY)
    for rule_id, rule in lint.REGISTRY.items():
        ref_rule = ref_lint.REGISTRY[rule_id]
        assert (rule.title, rule.domains) == (ref_rule.title,
                                              ref_rule.domains)
    assert lint.CRITICAL_DIRS == ref_lint.CRITICAL_DIRS
    assert lint.SCHEMA == ref_lint.SCHEMA


def test_port_tree_is_clean_under_both_linters():
    port = os.path.join(SRC, "repro_torch")
    assert lint.lint_paths([port]) == []
    assert ref_lint.lint_paths([port]) == []
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.lint", "src/repro_torch",
         "--check"], capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=SRC))
    assert run.returncode == 0, run.stdout + run.stderr
