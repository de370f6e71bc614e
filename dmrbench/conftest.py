"""Fixtures of the benchmark's CPU tests: a checkout root in a temporary
directory holding ``BENCHMARK.json`` and the benchmark's data files, with
the test-sized cells of ``testdata/`` added by files and entries alone, as
a later change adds a cell."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

TEST_CELLS = [
    {"name": "tiny-dense.steady", "config": "tiny-dense",
     "traffic": "tiny-steady", "chips": 1,
     "why": "test size: a dense decoder on one slice"},
    {"name": "tiny-ssm.malleable", "config": "tiny-ssm",
     "traffic": "tiny-cycle", "chips": 1,
     "why": "test size: a Mamba-2 decoder resized 4->2->1->2->4 by the RMS"}]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU; skipped without one")


def make_root(tmp: Path) -> Path:
    """A checkout root under ``tmp`` with the test cells added."""
    data = tmp / "dmrbench"
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(HERE / sub, data / sub)
        extra = HERE / "testdata" / sub
        if extra.exists():
            for f in extra.iterdir():
                shutil.copy(f, data / sub / f.name)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cfg in ("tiny-dense", "tiny-ssm"):
        spec["configs"].append({
            "name": cfg, "source": "test", "reduced": [],
            "file": f"dmrbench/configs/{cfg}.json", "why": "test size"})
    spec["workloads"] += TEST_CELLS
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and any(w.startswith("mamba2-130m.malleable")
                                    for w in m["workloads"]):
            m["workloads"].append("tiny-ssm.malleable")
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


@pytest.fixture
def root(tmp_path):
    return make_root(tmp_path)


@pytest.fixture(autouse=True)
def one_thread():
    """The test-sized runs on one CPU thread: their tensors are tiny, and
    the suite runs in several workers at once."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
