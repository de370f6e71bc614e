"""The port's observability layer (``repro_torch.obs``) against the JAX
package's (``repro.obs``), on the CPU.

Every test of ``tests/test_obs.py`` runs against the port: its module's
names, and the scenario builders of ``tests/test_capacity.py`` and
``tests/test_serving_rms.py`` it drives, bound to the port's classes
(``module_twin``), its local imports of ``repro.rms.reasons`` and
``repro.obs.report`` bound to the port's modules. So the committed golden
trace and report are reproduced byte for byte by the port. Then the two
packages trace the same scenarios: the artifact, the JSONL span log and
the Chrome trace are compared byte for byte, and each package reads the
other's artifacts.
"""
import json
import runpy
import sys
import types

import pytest

torch = pytest.importorskip("torch")

import test_capacity as ref_capacity_test  # noqa: E402
import test_obs as ref_obs_test  # noqa: E402
import test_serving_rms as ref_serving_test  # noqa: E402
from repro.obs import export as ref_export  # noqa: E402
from repro.obs import recorder as ref_recorder  # noqa: E402
from repro.obs import report as ref_report  # noqa: E402
from test_torch_sweep import (bind_modules, module_twin,  # noqa: E402
                              reference_cases, reference_objects, run_case)

import repro_torch.rms as port_rms  # noqa: E402
from repro_torch.obs import export, recorder, report  # noqa: E402
from repro_torch.rms import reasons  # noqa: E402

PACKAGES = {"ref": (ref_recorder, ref_export, ref_report),
            "port": (recorder, export, report)}
CAPACITY_TWIN = module_twin(ref_capacity_test)
SERVING_TWIN = module_twin(ref_serving_test)
SCENARIO_TWINS = {"ref": (ref_capacity_test, ref_serving_test),
                  "port": (types.SimpleNamespace(**CAPACITY_TWIN),
                           types.SimpleNamespace(**SERVING_TWIN))}
OBS_TWIN = module_twin(ref_obs_test,
                       test_capacity=SCENARIO_TWINS["port"][0],
                       test_serving_rms=SCENARIO_TWINS["port"][1])
# the modules the reference test imports in its bodies
LOCAL_IMPORTS = {"repro.rms.reasons": reasons, "repro.obs.report": report}


def test_twins_hold_only_the_ports_objects():
    assert OBS_TWIN["TraceRecorder"] is recorder.TraceRecorder
    assert OBS_TWIN["report_main"] is report.main
    assert OBS_TWIN["SimulationEngine"] is port_rms.SimulationEngine
    for space in (CAPACITY_TWIN, SERVING_TWIN, OBS_TWIN):
        assert reference_objects(space) == []
    sim = OBS_TWIN["test_capacity"].churn_scenario()
    assert type(sim) is port_rms.ClusterSimulator
    assert type(OBS_TWIN["test_serving_rms"].serving_scenario()) is \
        port_rms.ClusterSimulator


@pytest.mark.parametrize("name,arguments", reference_cases(ref_obs_test))
def test_reference_obs_case_on_port(name, arguments, request, monkeypatch):
    """tests/test_obs.py against the port: the golden trace and report byte
    for byte, traced churn and serving runs identical to plain ones, the
    ledger, the SLO samples, the Chrome trace, the CLI's --check drift, the
    monitor fan-out and the metrics."""
    bind_modules(monkeypatch, LOCAL_IMPORTS)
    run_case(OBS_TWIN, name, arguments, request)


def traced(pkg, scenario):
    """``scenario`` ("churn" or "serving") built by ``pkg``'s classes, run
    under ``pkg``'s TraceRecorder; returns (recorder, artifact)."""
    rec_mod, exp_mod, _ = PACKAGES[pkg]
    capacity, serving = SCENARIO_TWINS[pkg]
    sim = (capacity.churn_scenario() if scenario == "churn"
           else serving.serving_scenario())
    rec = rec_mod.TraceRecorder(sim, meta={"scenario": scenario}).install()
    rec.finalize(sim.run())
    return rec, exp_mod.build_artifact(rec)


@pytest.mark.parametrize("scenario", ["churn", "serving"])
def test_artifacts_equal_reference(scenario, tmp_path):
    """The same scenario traced by each package: the artifact, the JSONL
    span log, the Chrome trace, the report and the written bundle's three
    files byte-equal."""
    got = {}
    for pkg, (_, exp_mod, rep_mod) in PACKAGES.items():
        rec, doc = traced(pkg, scenario)
        paths = exp_mod.write_trace(str(tmp_path / pkg / scenario), rec)
        files = {k: open(p, "rb").read() for k, p in sorted(paths.items())}
        got[pkg] = (exp_mod.dumps_artifact(doc), exp_mod.spans_jsonl(doc),
                    exp_mod.dumps_chrome(exp_mod.chrome_trace(doc)),
                    rep_mod.render_report(doc), files)
    assert got["port"] == got["ref"]
    assert got["port"][4]["obs"] == got["port"][0]
    assert got["port"][4]["perfetto"] == got["port"][2]


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_artifact_loads_in_the_other_package(writer, reader, tmp_path,
                                             capsys):
    """A bundle written by one package is read by the other's
    load_artifact and audit CLI to the writer's report."""
    rec, doc = traced(writer, "churn")
    paths = PACKAGES[writer][1].write_trace(str(tmp_path / "run"), rec)
    rep_mod = PACKAGES[reader][2]
    assert rep_mod.load_artifact(paths["obs"]) == json.loads(
        PACKAGES[writer][1].dumps_artifact(doc))
    golden = tmp_path / "report.txt"
    golden.write_text(PACKAGES[writer][2].render_report(doc),
                      encoding="utf-8")
    assert rep_mod.main([paths["obs"], "--check", str(golden)]) == 0
    assert "obs report matches" in capsys.readouterr().out


def test_constants_match_reference():
    assert export.SCHEMA_ID == ref_export.SCHEMA_ID == "repro.obs"
    assert export.SCHEMA_VERSION == ref_export.SCHEMA_VERSION
    assert recorder.RESIZE_ACTIONS == ref_recorder.RESIZE_ACTIONS
    assert recorder.DMR_ACTIONS == ref_recorder.DMR_ACTIONS


def test_obs_module_cli_reproduces_golden_report(monkeypatch, capsys):
    """``python -m repro_torch.obs ARTIFACT`` prints the golden report, and
    with ``--check GOLDEN`` exits 0."""
    trace, golden = ref_obs_test.GOLDEN_TRACE, ref_obs_test.GOLDEN_REPORT
    for argv, out in (([trace], open(golden, encoding="utf-8").read()),
                      ([trace, "--check", golden],
                       f"obs report matches {golden}\n")):
        monkeypatch.setattr(sys, "argv", ["repro_torch.obs", *argv])
        monkeypatch.delitem(sys.modules, "repro_torch.obs.__main__",
                            raising=False)
        with pytest.raises(SystemExit) as done:
            runpy.run_module("repro_torch.obs", run_name="__main__")
        assert done.value.code == 0
        assert capsys.readouterr().out == out
