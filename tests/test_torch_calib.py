"""The port's calibration pipeline (``repro_torch.calib``) and cost model
(``repro_torch.rms.costmodel``) against the JAX reference's
(``repro.calib``, ``repro.rms.costmodel``), on the CPU.

The ``plan`` backend, the fit and the artifact are copies: they must write
the reference's golden artifact byte for byte. The ``torch`` backend times
the port's own reshard between virtual CPU slices; its artifact must load
in the reference unchanged.
"""
import copy
import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro.calib import fit as ref_fit  # noqa: E402
from repro.calib import load_calibration as ref_load  # noqa: E402
from repro.calib.artifact import content_id as ref_content_id  # noqa: E402
from repro.calib.measure import measure_grid as ref_measure_grid  # noqa: E402
from repro.calib.measure import resize_features as ref_features  # noqa: E402
from repro.rms.costmodel import ReconfigCostModel as RefModel  # noqa: E402
from repro_torch.calib import (FitError, MeasureConfig, calibrate,  # noqa: E402
                               dumps_calibration, fit_report_rows,
                               fit_samples, load_calibration, measure_grid,
                               validate_calibration, validate_fit,
                               write_calibration)
from repro_torch.calib import measure  # noqa: E402
from repro_torch.calib.artifact import content_id  # noqa: E402
from repro_torch.calib.measure import (CI_DATA_BYTES,  # noqa: E402
                                       CI_GEOMETRIES, MiB, resize_features)
from repro_torch.core import Action  # noqa: E402
from repro_torch.rms.costmodel import ReconfigCostModel  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN = os.path.join(DATA, "golden_calibration.json")
# the torch backend's quick grid: two geometries at 4 and 64 MiB, best of 3
# timings a sample, so that under a loaded test run the copy's time, 16x
# apart, outweighs a resize's fixed cost and the host's noise, which at 4
# and 16 MiB with one timing could leave the fit a bandwidth below zero
QUICK = MeasureConfig(backend="torch", geometries=((1, 2), (2, 4)),
                      data_bytes=(4 * MiB, 64 * MiB), repeats=3)


@pytest.fixture(autouse=True)
def one_thread():
    """The tier-1 run shares the machine's cores among its workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def golden_doc():
    return load_calibration(GOLDEN)


# -- the plan backend, the fit and the artifact: copies ---------------------


def test_plan_backend_reproduces_golden_bytes():
    doc = calibrate(MeasureConfig())
    with open(GOLDEN) as fh:
        assert dumps_calibration(doc) == fh.read()


def test_refit_golden_samples_gives_golden_fit():
    doc = golden_doc()
    fitted, residuals, checks = fit_samples(doc["samples"])
    assert fitted == doc["fitted"]
    assert residuals == doc["residuals"]
    assert checks == doc["checks"]
    assert validate_fit(fitted) == ref_fit.validate_fit(fitted)


def test_plan_samples_match_reference_on_another_grid():
    cfg = dict(geometries=((1, 2), (4, 8)), data_bytes=(MiB, 3 * MiB),
               sched_nodes=(2, 8), repeats=2, seed=5)
    from repro.calib import MeasureConfig as RefConfig
    assert measure_grid(MeasureConfig(**cfg)) == \
        ref_measure_grid(RefConfig(**cfg))


def tampered(key):
    bad = copy.deepcopy(golden_doc())
    if key == "schema":
        bad["schema"] = "nope"
    elif key == "version":
        bad["version"] = 99
    elif key == "samples":
        bad["samples"][0]["seconds"] = 123.0
    elif key == "fitted":
        bad["fitted"]["link_bw"] = 1e12
    elif key == "backend":
        bad["backend"] = "torch"
    elif key == "residuals":
        bad["residuals"] = {"resize_r2": 1.0}
    elif key == "no-fit":
        del bad["fitted"]
    return bad


@pytest.mark.parametrize("key,match", [
    ("schema", "not a calibration artifact"), ("version", "version"),
    ("samples", "calibration_id"), ("fitted", "calibration_id"),
    ("backend", "calibration_id"), ("residuals", "calibration_id"),
    ("no-fit", "no fitted parameters")])
def test_rejects_foreign_schema_version_and_tampering(key, match):
    """The reference's rejections (tests/test_calib.py), in both packages:
    a plan run cannot be relabelled as a torch measurement either."""
    from repro.calib import validate_calibration as ref_validate
    for validate in (validate_calibration, ref_validate):
        with pytest.raises(ValueError, match=match):
            validate(tampered(key))


def test_calibration_id_is_the_reference_content_hash():
    doc = golden_doc()
    assert content_id(doc) == ref_content_id(doc) == doc["calibration_id"]
    perturbed = copy.deepcopy(doc)
    perturbed["samples"][0]["seconds"] += 1e-6
    assert content_id(perturbed) == ref_content_id(perturbed) != \
        doc["calibration_id"]


def test_fit_error_on_bandwidth_free_or_negative_samples():
    flat = [{"kind": "expand", "old": 1, "new": 2, "bytes": 64,
             "participants": 2, "busiest_bytes": 32,
             "seconds": 0.05 + i * 0.01} for i in range(4)]
    with pytest.raises(FitError, match="no busiest-bytes variation"):
        fit_samples(flat)
    # more bytes, less time: 1/link_bw <= 0
    falling = [dict(s, busiest_bytes=32 * (i + 1), seconds=0.1 - i * 0.01)
               for i, s in enumerate(flat)]
    with pytest.raises(FitError, match="not positive"):
        fit_samples(falling)
    with pytest.raises(ref_fit.FitError):
        ref_fit.fit_samples(falling)


# -- the cost model ---------------------------------------------------------


def test_cost_model_from_golden_matches_reference():
    doc = golden_doc()
    port, ref = ReconfigCostModel.from_artifact(GOLDEN), \
        RefModel.from_artifact(GOLDEN)
    assert port.calibration_id == ref.calibration_id == doc["calibration_id"]
    assert ReconfigCostModel.from_artifact(doc) == port
    assert dataclass_values(port) == dataclass_values(ref)
    assert dataclass_values(ReconfigCostModel()) == \
        dataclass_values(RefModel())
    for p, q in CI_GEOMETRIES:
        for nbytes in (0,) + CI_DATA_BYTES:
            for a, b in ((p, q), (q, p), (p, p)):
                assert port.resize_time(a, b, nbytes) == \
                    ref.resize_time(a, b, nbytes)
    from repro.core.actions import Action as RefAction
    for action in Action:
        for nodes in (1, 8, 64):
            assert port.schedule_time(action, nodes) == \
                ref.schedule_time(RefAction(int(action)), nodes)


def dataclass_values(model):
    import dataclasses
    return [getattr(model, f.name) for f in dataclasses.fields(model)]


def test_fit_report_rows_match_reference():
    doc = golden_doc()
    rows = fit_report_rows(doc)
    assert rows == ref_fit.fit_report_rows(doc)
    assert len(rows) == 2 * len(CI_GEOMETRIES) * len(CI_DATA_BYTES)


# -- the torch backend: the port's reshard on virtual CPU slices ------------


def test_torch_artifact_loads_in_the_reference(tmp_path):
    doc = calibrate(QUICK, device="cpu")
    path = str(tmp_path / "calib.json")
    write_calibration(path, doc)
    loaded = ref_load(path)
    assert loaded == doc and loaded["backend"] == "torch"
    model = RefModel.from_artifact(path)
    assert model.calibration_id == doc["calibration_id"]
    assert model.link_bw == doc["fitted"]["link_bw"] > 0
    assert ReconfigCostModel.from_artifact(path) == \
        ReconfigCostModel.from_artifact(loaded)
    env = doc["environment"]
    assert env["backend"] == "torch" and env["device_kind"] == "cpu"
    assert env["link_proxy_samples"] == 0
    kinds = [s["kind"] for s in doc["samples"]]
    assert kinds.count("expand") == kinds.count("shrink") == 4
    assert kinds.count("migrate") == 1 and kinds.count("sched") == 6
    for s in doc["samples"]:
        assert s["seconds"] > 0
        if s["kind"] in ("expand", "shrink"):
            assert (s["participants"], s["busiest_bytes"]) == ref_features(
                s["kind"], s["old"], s["new"], s["bytes"]) == \
                resize_features(s["kind"], s["old"], s["new"], s["bytes"])
    assert json.loads(dumps_calibration(doc)) == doc


def corrupting(real, how):
    def reshard(state, shardings, transfers=None):
        out = real(state, shardings, transfers=transfers)
        if how == "bits":
            block = next(iter(out.shards.values()))
            block.view(torch.int32)[0] += 1
        elif transfers:
            transfers.pop()
        return out
    return reshard


@pytest.mark.parametrize("how,match", [("bits", "changed the data"),
                                       ("transfers", "the plan")])
def test_torch_backend_holds_each_resize_to_the_plan(monkeypatch, how,
                                                     match):
    import importlib
    reshard_mod = importlib.import_module("repro_torch.core.reshard")
    monkeypatch.setattr(reshard_mod, "reshard",
                        corrupting(reshard_mod.reshard, how))
    with pytest.raises(RuntimeError, match=match):
        measure_grid(MeasureConfig(backend="torch", geometries=((2, 4),),
                                   data_bytes=(MiB,), repeats=1),
                     device="cpu")


def test_torch_backend_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure_grid(QUICK)
    with pytest.raises(ValueError, match="unknown backend"):
        measure_grid(MeasureConfig(backend="jax"))


# -- the CLI ----------------------------------------------------------------


def test_cli_checks_golden_and_keeps_reference_exit_codes(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    assert measure.main(["--backend", "plan", "--check", GOLDEN]) == 0
    other = tmp_path / "other.json"
    write_calibration(str(other), calibrate(MeasureConfig(seed=7)))
    assert measure.main(["--backend", "plan", "--check", str(other)]) == 1
    out = str(tmp_path / "calib.json")
    assert measure.main(["--backend", "plan", "--seed", "7",
                         "--out", out]) == 0
    assert open(out).read() == open(other).read()

    def refuse(samples):
        raise FitError("fitted 1/link_bw = -1.0 is not positive")
    from repro_torch.calib import fit
    monkeypatch.setattr(fit, "fit_samples", refuse)
    assert measure.main(["--backend", "plan"]) == 2
    assert "not positive" in capsys.readouterr().out
