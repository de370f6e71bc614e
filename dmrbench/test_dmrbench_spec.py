"""BENCHMARK.json against the benchmark's contract, and the files it names
found by name."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from dmrbench.conftest import ROOT, make_root
from dmrbench.spec import Bench, read_json

SPEC = read_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E_SOURCES = {"host_clock", "device_trace"}
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
CELLS = [w["name"] for w in SPEC["workloads"]]
# keys that name a width, which ``reduced`` may never name
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|proj|head|expand|"
                    r"_dim$|_rank$|experts_per_tok|d_model|d_inner|d_ff)")


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def all_metrics():
    return SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys_and_command():
    assert set(SPEC) == KEYS
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(line(w) and not w.startswith("/") and ".." not in w
               for w in SPEC["command"])
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.endswith("_torch")
        assert (ROOT / p).is_dir()
    named = [w for w in SPEC["command"] if "/" in w]
    assert all(any(w.startswith(p + "/") for p in SPEC["paths"])
               for w in named)
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_run_seconds_fit_the_check_with_24_cells():
    t = SPEC["run_seconds"]
    assert isinstance(t, int) and 1 <= t <= 51
    runs = 2 + 14 * 24
    assert runs * (t + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", SPEC["configs"] + SPEC["workloads"]
                         + all_metrics(), ids=lambda e: e["name"])
def test_names_and_entry_keys(entry):
    assert NAME.match(entry["name"])
    if entry in SPEC["configs"]:
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert line(entry["source"]) and line(entry["why"])
        assert len(entry["reduced"]) <= 16
        assert all(NAME.match(k) for k in entry["reduced"])
    elif entry in SPEC["workloads"]:
        assert set(entry) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
        assert entry["chips"] in (1, 4) and line(entry["why"])
    else:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in SOURCES
        if entry in SPEC["end_to_end"]:
            assert set(entry) - {"workloads"} == {"name", "unit", "better",
                                                  "bound", "source"}
            assert entry["source"] in E2E_SOURCES
            assert 0.01 <= entry["bound"] <= 0.25
        else:
            assert set(entry) - {"workloads"} == {
                "name", "unit", "better", "source", "layer", "moves"}
            assert line(entry["layer"])


def test_names_are_unique_and_pairs_appear_once():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in all_metrics()]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(
        1, len(SPEC["workloads"]) // 4)


def test_every_config_is_used_and_names_its_reductions():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used
        path = ROOT / c["file"]
        assert path.is_file() and any(
            c["file"].startswith(p + "/") for p in SPEC["paths"])
        cfg = read_json(path)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert key in cfg and not WIDTHS.search(key), key
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files_by_name(cell):
    c = Bench(ROOT).cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer and set(c.readers) == {m["name"] for m in c.per_layer}
    assert all(callable(r) for r in c.readers.values())
    for m in c.per_layer:
        assert m["moves"] in e2e
    assert c.mix["name"] == c.entry["traffic"]
    assert set(c.limits) >= {"loss", "change"}
    for lim in c.limits.values():
        assert lim["lower"] < lim["limit"] < lim["upper"]


def test_metrics_of_one_layer_name_it_alike_and_list_reporting_cells():
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        for cell in m.get("workloads", ()):
            assert cell in CELLS
            reported = [e["name"] for e in SPEC["end_to_end"]
                        if "workloads" not in e or cell in e["workloads"]]
            assert m["moves"] in reported
    assert all(len(v) == 1 for v in layers.values())
    for m in SPEC["end_to_end"]:
        assert all(c in CELLS for c in m.get("workloads", ()))


def test_a_cell_a_mix_and_a_metric_are_added_by_files_alone(tmp_path):
    """A throwaway cell with a new config, mix, limits and per-layer metric
    from a temporary directory: files and entries, no code."""
    root = make_root(tmp_path)
    data = root / "dmrbench"
    shutil.copy(data / "traffic" / "tiny-steady.json",
                data / "traffic" / "tiny-steady-long.json")
    mix = json.loads((data / "traffic" / "tiny-steady-long.json").read_text())
    mix.update(name="tiny-steady-long", seq=64)
    (data / "traffic" / "tiny-steady-long.json").write_text(json.dumps(mix))
    shutil.copy(data / "limits" / "tiny-dense.steady.json",
                data / "limits" / "tiny-dense.long.json")
    (data / "metrics" / "steps_traced.py").write_text(
        "def read(rec):\n    return float(len(rec['trace']['steps']))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny-dense.long",
                              "config": "tiny-dense",
                              "traffic": "tiny-steady-long", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "steps_traced", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "Elastic trainer",
                              "moves": "train_tokens_per_s",
                              "workloads": ["tiny-dense.long"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = Bench(root).cell("tiny-dense.long")
    assert cell.mix["seq"] == 64
    assert cell.readers["steps_traced"]({"trace": {"steps": [1, 2]}}) == 2.0


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_config_is_the_ports_model_as_run(name):
    """The file's ``port`` group is the port's registered model at its
    published widths and depth, with the trainer's settings (remat, the
    loss's chunks) the file states."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import ModelConfig
    port = Bench(ROOT).config(name)["port"]
    ours = ModelConfig(**dict(port, pattern=tuple(port["pattern"])))
    want = dataclasses.replace(get_config(name), remat=port["remat"],
                               ce_chunk=port["ce_chunk"])
    assert ours == want
