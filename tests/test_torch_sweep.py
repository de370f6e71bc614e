"""The port's sweep driver and journal (``repro_torch.rms.sweep``,
``repro_torch.rms.journal``) against the JAX package's, on the CPU.

The modules are copies, so the reference's own tests are run against the
port: each test of ``tests/test_sweep_golden.py`` and
``tests/test_journal.py`` with its module's names bound to the port's
(``module_twin``), and the reference's golden-row cases with
``repro.rms.sweep`` bound to the port's module for the test's length
(``bind_modules``). Rows are compared equal and artifacts byte for byte,
with no tolerance: the committed goldens, the policy zoo's 80 points under
the paper-fit constants and under ``golden_calibration.json``, and
artifacts and journals handed from one package to the other. Only the
2-worker golden case, the CLI kill-resume and chip_smoke's (sw) phase start
processes: each pays a torch import.
"""
import importlib
import inspect
import json
import os
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")

import test_calib as ref_calib_test  # noqa: E402
import test_capacity as ref_capacity_test  # noqa: E402
import test_journal as ref_journal_test  # noqa: E402
import test_serving_rms as ref_serving_test  # noqa: E402
import test_sweep_golden as ref_golden_test  # noqa: E402
from repro.rms import POLICY_REGISTRY as REF_POLICY_REGISTRY  # noqa: E402
from repro.rms import journal as ref_journal  # noqa: E402
from repro.rms import sweep as ref_sweep  # noqa: E402

from repro_torch.rms import POLICY_REGISTRY  # noqa: E402
from repro_torch.rms import journal, sweep  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
TRACE = os.path.join(DATA, "sample.swf")
GOLDEN = os.path.join(DATA, "golden_sweep.json")
CALIBRATION = os.path.join(DATA, "golden_calibration.json")
PACKAGES = {"ref": (ref_sweep, ref_journal), "port": (sweep, journal)}
# the policy zoo's mixes (benchmarks/policy_zoo.py, DEFAULT_MIXES), as data
ZOO_MIXES = "1:0:0:0,0.2:0.2:0.6:0,0:0:1:0,0.2:0.1:0.4:0.3,0:0:0.3:0.7"


# -- running a reference test module against the port -------------------------


def port_counterpart(value):
    """The port's module, class or function of the same name as ``value``,
    when ``value`` is one of the JAX package's; else None."""
    if isinstance(value, types.ModuleType):
        name = value.__name__
    else:
        name = getattr(value, "__module__", None)
        if not hasattr(value, "__qualname__"):
            return None
    if not isinstance(name, str) or not name.startswith("repro."):
        return None
    port = importlib.import_module("repro_torch" + name[len("repro"):])
    if isinstance(value, types.ModuleType):
        return port
    return getattr(port, value.__qualname__)


def module_twin(module, **names):
    """The namespace of the reference test module ``module`` with the port's
    counterpart of every module, class and function it took from the JAX
    package, then ``names``, in place of its own, every function of the
    module rebound to it: the same test code, its helpers included, run
    against the port."""
    space = dict(vars(module))
    for key, value in vars(module).items():
        twin = port_counterpart(value)
        if twin is not None:
            space[key] = twin
    space.update(names)
    for key, value in list(space.items()):
        if (key not in names and isinstance(value, types.FunctionType)
                and value.__module__ == module.__name__):
            space[key] = types.FunctionType(
                value.__code__, space, value.__name__, value.__defaults__,
                value.__closure__)
    return space


def reference_cases(module, only=None):
    """One ``pytest.param(name, arguments)`` per case of each test function
    of ``module`` (one per row of a ``parametrize`` mark), in name order;
    ``only`` keeps the functions it accepts."""
    cases = []
    for name, fn in sorted(vars(module).items()):
        if not (name.startswith("test_")
                and isinstance(fn, types.FunctionType)):
            continue
        if only is not None and not only(fn):
            continue
        marks = getattr(fn, "pytestmark", [])
        assert all(m.name == "parametrize" for m in marks), (name, marks)
        combos = [{}]
        for mark in marks:
            argnames, values = mark.args[:2]
            if isinstance(argnames, str):
                argnames = [a.strip() for a in argnames.split(",")]
            combos = [{**c, **dict(zip(argnames, v if len(argnames) > 1
                                       else (v,)))}
                      for c in combos for v in values]
        for combo in combos:
            label = "-".join(str(v) for v in combo.values())
            cases.append(pytest.param(
                name, combo, id=f"{name}[{label}]" if combo else name))
    return cases


def run_case(space, name, arguments, request):
    """Call the twin's test ``name`` with its parametrised ``arguments`` and
    pytest's fixtures for the rest of its parameters."""
    fn = space[name]
    kwargs = dict(arguments)
    for arg in inspect.signature(fn).parameters:
        if arg not in kwargs:
            kwargs[arg] = request.getfixturevalue(arg)
    fn(**kwargs)


def bind_modules(monkeypatch, modules):
    """For the test's length, ``import a.b.c`` and ``from a.b import c`` of
    each reference module name in ``modules`` give the port's module: the
    reference tests' local imports, run against the port."""
    for name, module in modules.items():
        parent, _, child = name.rpartition(".")
        monkeypatch.setitem(sys.modules, name, module)
        monkeypatch.setattr(sys.modules[parent], child, module)


# -- the reference's sweep and journal tests ----------------------------------


def port_sweep_cli(tmp, *extra):
    """The reference test's ``_sweep_cli``, launching the port's CLI."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.rms.sweep", "--trace", TRACE,
         "--smoke", *extra],
        cwd=str(tmp), env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def reference_objects(space):
    """The names in a twin's namespace still bound to an object of the JAX
    package (its modules, classes and functions)."""
    return sorted(k for k, v in space.items() if port_counterpart(v))


GOLDEN_TWIN = module_twin(ref_golden_test)
JOURNAL_TWIN = module_twin(ref_journal_test, _sweep_cli=port_sweep_cli)


def test_twins_hold_only_the_ports_objects():
    assert GOLDEN_TWIN["sweep"] is sweep
    assert JOURNAL_TWIN["GridJournal"] is journal.GridJournal
    assert JOURNAL_TWIN["parse_shard"] is journal.parse_shard
    for space in (GOLDEN_TWIN, JOURNAL_TWIN):
        assert reference_objects(space) == []


@pytest.mark.parametrize("name,arguments", reference_cases(ref_golden_test))
def test_reference_sweep_golden_case_on_port(name, arguments, request):
    """tests/test_sweep_golden.py against the port's sweep: the smoke grid
    serial and at 2 workers byte-equal to golden_sweep.json after the v4 ->
    v5 upgrade, the schema, CSV, winners and the v1-v3 upgrades."""
    run_case(GOLDEN_TWIN, name, arguments, request)


@pytest.mark.parametrize("name,arguments", reference_cases(ref_journal_test))
def test_reference_journal_case_on_port(name, arguments, request):
    """tests/test_journal.py against the port's journal and sweep, the kill
    and resume through ``python -m repro_torch.rms.sweep``: killed once the
    journal holds a durable row, resumed byte-equal to a serial run."""
    run_case(JOURNAL_TWIN, name, arguments, request)


ROW_CASES = {
    "churn": ref_capacity_test.test_churn_sweep_row_matches_golden_artifact,
    "serving": ref_serving_test.test_serving_sweep_row_matches_golden_artifact,
    "calibration":
        ref_calib_test.test_sweep_rows_record_calibration_provenance,
}


@pytest.mark.parametrize("case", sorted(ROW_CASES))
def test_reference_sweep_row_case_on_port(case, request, monkeypatch):
    """The reference's golden churn and serving rows (and their journal
    resume) and the calibration provenance of a row, each run with
    ``repro.rms.sweep`` bound to the port's module."""
    bind_modules(monkeypatch, {"repro.rms.sweep": sweep})
    from repro.rms import sweep as bound
    assert bound is sweep
    fn = ROW_CASES[case]
    assert "sweep" not in fn.__globals__     # imported in the body
    run_case({fn.__name__: fn}, fn.__name__, {}, request)


# -- the port against the reference -------------------------------------------


def test_constants_match_reference():
    for name in ("SCHEMA_ID", "SCHEMA_VERSION", "ROUND_DIGITS", "COLUMNS",
                 "SMOKE_POLICIES", "SMOKE_MIXES", "SMOKE_SERVING_POLICIES",
                 "SMOKE_SERVING_MIXES", "PAPER_FIT_ID"):
        assert getattr(sweep, name) == getattr(ref_sweep, name), name
    assert journal.JOURNAL_ID == ref_journal.JOURNAL_ID == "repro.rms.sweep"
    assert journal.JOURNAL_VERSION == ref_journal.JOURNAL_VERSION


def zoo_points(pkg, calibration):
    """The policy zoo's grid: every registered policy x the zoo's five mixes
    x fixed and flexible, on sample.swf at 64 nodes, seed 7: 80 points."""
    mod = PACKAGES[pkg][0]
    policies = sorted(POLICY_REGISTRY if pkg == "port"
                      else REF_POLICY_REGISTRY)
    return mod.build_grid([TRACE], policies, mod.parse_mixes(ZOO_MIXES),
                          (False, True), num_nodes=64, seed=7,
                          calibration=calibration)


@pytest.mark.parametrize("calibration", [None, CALIBRATION],
                         ids=["paper-fit", "golden_calibration"])
def test_policy_zoo_rows_equal_reference(calibration):
    """Every row of the 80-point zoo grid, serial, equal to the reference's,
    the artifacts byte-equal; the rows carry the artifact's id."""
    rows = sweep.run_sweep(zoo_points("port", calibration))
    ref_rows = ref_sweep.run_sweep(zoo_points("ref", calibration))
    assert len(rows) == 80 == len(POLICY_REGISTRY) * 5 * 2
    assert rows == ref_rows
    assert sweep.dumps_artifact(sweep.artifact(rows)) == \
        ref_sweep.dumps_artifact(ref_sweep.artifact(ref_rows))
    want = (json.load(open(calibration))["calibration_id"] if calibration
            else sweep.PAPER_FIT_ID)
    assert {r["calibration_id"] for r in rows} == {want}
    assert sweep.winners_by_mix(rows) == ref_sweep.winners_by_mix(ref_rows)
    assert sweep.winners_by_mix(rows, "node_hours") == \
        ref_sweep.winners_by_mix(ref_rows, "node_hours")


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_artifact_loads_in_the_other_package(writer, reader, tmp_path):
    """An artifact written by one package loads in the other to the same
    bytes, and the committed v4 goldens upgrade alike in both."""
    w_sweep, r_sweep = PACKAGES[writer][0], PACKAGES[reader][0]
    points, grid = w_sweep.smoke_grid(TRACE)
    path = str(tmp_path / "artifact.json")
    w_sweep.write_artifact(path, w_sweep.artifact(
        w_sweep.run_sweep(points), grid))
    with open(path) as fh:
        written = fh.read()
    assert r_sweep.dumps_artifact(r_sweep.load_artifact(path)) == written
    for name in ("golden_sweep.json", "golden_capacity_sweep.json",
                 "golden_serving_sweep.json"):
        golden = os.path.join(DATA, name)
        assert r_sweep.dumps_artifact(r_sweep.load_artifact(golden)) == \
            w_sweep.dumps_artifact(w_sweep.load_artifact(golden))


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_journal_resumes_in_the_other_package(writer, reader, tmp_path,
                                              monkeypatch):
    """Half the smoke grid journaled by one package, resumed by the other:
    only the missing points run, and the artifact is the golden's bytes."""
    (w_sweep, w_journal), (r_sweep, r_journal) = (PACKAGES[writer],
                                                  PACKAGES[reader])
    jpath = str(tmp_path / "run.jsonl")
    points, grid = w_sweep.smoke_grid(TRACE)
    w_sweep.run_sweep(points[::2], journal=jpath)
    with open(jpath) as fh:
        header = json.loads(fh.readline())
    assert header == {"journal": "repro.rms.sweep",
                      "version": r_journal.JOURNAL_VERSION}
    assert len(r_journal.GridJournal.load(jpath)) == len(points[::2])
    ran = []
    real = r_sweep.run_point

    def counting(point):
        ran.append(point)
        return real(point)

    monkeypatch.setattr(r_sweep, "run_point", counting)
    r_points, r_grid = r_sweep.smoke_grid(TRACE)
    rows = r_sweep.run_sweep(r_points, journal=jpath, resume_from=(jpath,))
    assert len(ran) == len(points) - len(points[::2])
    got = r_sweep.dumps_artifact(r_sweep.artifact(rows, r_grid))
    assert got == r_sweep.dumps_artifact(r_sweep.load_artifact(GOLDEN))
    # the journal now holds the whole grid: the writer resumes it all
    assert w_sweep.run_sweep(points, resume_from=(jpath,)) == rows


def test_chip_smoke_sweep_phase_on_cpu(tmp_path, capsys):
    """(sw) whole, fed the golden calibration artifact as (t) would feed
    its own: the three golden grids at 2 workers, the zoo's two shards
    merged byte-equal to the serial run, the traced obs scenario, the
    port's lint; with no artifact, the one fallback line."""
    import chip_smoke
    doc = json.load(open(CALIBRATION))
    written = tmp_path / "calibration.json"
    result = chip_smoke.phase_sweep(doc, workdir=tmp_path / "sw",
                                    calibration_out=written)
    out = capsys.readouterr().out
    assert written.exists()
    assert result["calibration_id"] == doc["calibration_id"]
    assert result["zoo_points"] == 80 and result["lint_rules"] == 9
    assert result["events"] > 0
    assert "its row equal to the untraced row" in out
    for name in ("golden_sweep.json", "golden_capacity_sweep.json",
                 "golden_serving_sweep.json", "golden_obs_trace.json",
                 "golden_obs_report.txt"):
        assert f"byte-equal to tests/data/{name}" in out
    assert "two shards merged by --resume, byte-equal" in out
    assert f"calibration_id {doc['calibration_id']}" in out
    assert out.count("winner by makespan_s") == 5
    assert out.count("winner by node_hours") == 5
    assert chip_smoke.sw_calibration(None, written) == \
        str(chip_smoke.GOLDEN_CALIBRATION)
    assert "no fitted model from this card" in capsys.readouterr().out
