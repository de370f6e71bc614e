"""A whole run of the harness on the CPU at a test size, past its look for a
card: sound, with each fault planted under the timed path, with the control
in the program's place; and what the run refuses."""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time

import pytest

from dmrbench import check, faults, harness, rival, trainrun
from dmrbench.conftest import ROOT
from dmrbench.spec import Bench

CELLS = ["tiny-dense.steady", "tiny-ssm.malleable"]
# the faults each test cell can have: one slice has no exchange
FAULTS = [("tiny-dense.steady", "unchanged"), ("tiny-dense.steady", "half"),
          ("tiny-ssm.malleable", "unchanged"), ("tiny-ssm.malleable", "half"),
          ("tiny-ssm.malleable", "exchange")]


def run(root, cell, seed, seconds=0.3):
    return harness.run_cell(Bench(root).cell(cell), seed, seconds, False,
                            "cpu", time.perf_counter())


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 5])
@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(root, cell, seed):
    out = run(root, cell, seed)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    names = set(out["metrics"])
    assert {"setup_s", "train_tokens_per_s"} <= names
    assert ("reconfig_ms" in names) == (cell == "tiny-ssm.malleable")
    assert all(v["value"] > 0 for v in out["metrics"].values())


@pytest.mark.parametrize("seed", [4, 2 ** 33 + 1, 123456789])
def test_malleable_loop_walks_the_mixs_cycle_on_every_seed(root, seed):
    """The harness's loop, on several seeds: every resize the RMS's policy
    granted is the one the mix states, and each geometry's walks were
    compiled before the loop's first step."""
    from repro_torch.core.reshard import PROGRAMS
    cell = Bench(root).cell("tiny-ssm.malleable")
    tr = trainrun.TrainCell(cell, seed, "cpu")
    tr.build()
    tr.warm_walks()
    compiled = PROGRAMS.compiles
    for _ in range(cell.mix["rms"]["cycle"]["start"] + 12):
        tr.step()
    assert PROGRAMS.compiles == compiled
    rms = cell.mix["rms"]
    assert [(r["step"], r["to"]) for r in tr.resizes] == [
        (k, rival.expected_at(rms, k)) for k in range(1, tr.step_no)
        if rival.expected_at(rms, k) != rival.expected_at(rms, k - 1)]
    assert all(r["copied_bytes"] > 0 for r in tr.resizes)


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_fault_under_the_timed_path_is_not_correct(root, cell, fault):
    with faults.FAULTS[fault]():
        out = run(root, cell, 12)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_in_the_programs_place_is_not_correct(root, cell):
    """The reference in float8 products, read as a run reads the
    program."""
    cell = Bench(root).cell(cell)
    for seed in (100, 101, 102):
        tr = trainrun.TrainCell(cell, seed, "cpu")
        ref = tr.reference_readings()
        values = check.numbers(tr.reference_readings("fp8"), ref)
        assert not check.verdict(values, cell.limits)[0], values


def test_the_harness_loads_no_jax_nor_the_jax_package(tmp_path):
    code = ("import sys, time; sys.path[:0] = [{root!r}, {src!r}];"
            "from dmrbench import harness, trainrun, trace, control;"
            "from dmrbench.conftest import make_root;"
            "from pathlib import Path; from dmrbench.spec import Bench;"
            "root = make_root(Path({tmp!r}));"
            "harness.run_cell(Bench(root).cell('tiny-ssm.malleable'), 1, 0.1,"
            " False, 'cpu', time.perf_counter());"
            "print(harness.forbidden_modules())").format(
                root=str(ROOT), src=str(ROOT / "src"), tmp=str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole_top_level_names():
    names = ["repro_torch", "repro_torch.core", "reprox", "jaxtyping"]
    assert harness.forbidden_modules(names) == []
    assert harness.forbidden_modules(names + ["repro.core"]) == ["repro"]
    assert harness.forbidden_modules(["jax.numpy", "flax"]) == ["flax",
                                                                "jax"]


def test_without_a_card_the_run_prints_no_result(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "mamba2-130m.steady", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_without_the_program_the_run_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "dmrbench", tmp_path / "dmrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run(
        [sys.executable, "dmrbench/run.py", "--workload",
         "mamba2-130m.steady", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, env=env,
        timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "repro_torch" in out.stderr
