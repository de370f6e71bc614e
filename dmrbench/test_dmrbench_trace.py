"""The reduction from a traced window's events to records, and the
per-layer metrics' readers, on events made up to a known answer."""
from __future__ import annotations

import pytest

from dmrbench import frozen_work, trace
from dmrbench.conftest import ROOT
from dmrbench.spec import Bench

KERNELS = {"ssd_fwd": frozenset({"chunk_state_bf16", "state_pass",
                                 "chunk_output_bf16"}),
           "ssd_bwd": frozenset({"chunk_dstate_bf16", "state_pass",
                                 "chunk_bwd_bf16", "reduce_alog"}),
           "box_copy": frozenset({"box_copy"})}
US = 1000


def ev(name, start_us, dur_us):
    return (name, start_us * US, dur_us * US)


EVENTS = [ev("void chunk_state_bf16<64>(float*)", 10, 5),
          ev("state_pass", 15, 5),
          ev("chunk_output_bf16", 20, 10),
          ev("void at::native::vectorized_elementwise_kernel<4>(int)", 40, 10),
          ev("chunk_dstate_bf16", 60, 5),
          ev("state_pass", 65, 5),
          ev("chunk_bwd_bf16", 70, 20),
          ev("box_copy", 100, 50)]
HOST = [("dmrbench.train_step", 0, 95 * US), ("aten::mm", 28 * US, 45 * US),
        ("dmrbench.reconfigure", 95 * US, 200 * US)]


def test_reduce_busy_families_and_gaps():
    rec = trace.reduce(EVENTS, HOST, (0, 200 * US), KERNELS)
    assert rec["window_s"] == pytest.approx(200e-6)
    assert rec["busy_s"] == pytest.approx(110e-6)
    assert rec["family_s"]["ssd_fwd"] == pytest.approx(20e-6)
    assert rec["family_s"]["ssd_bwd"] == pytest.approx(30e-6)
    assert rec["box_copy_s"] == [pytest.approx(50e-6)]
    assert rec["elementwise_s"] == pytest.approx(10e-6)
    gaps = dict(rec["idle_gaps"])
    assert gaps["dmrbench.train_step: aten::mm"] == pytest.approx(10e-6)
    assert gaps["dmrbench.train_step"] == pytest.approx(30e-6)
    assert gaps["dmrbench.reconfigure"] == pytest.approx(50e-6)
    assert sum(gaps.values()) == pytest.approx(90e-6)
    assert rec["device_ops"][0] == ["box_copy", pytest.approx(50e-6)]


def test_busy_intervals_merge_overlaps():
    got = trace.busy_intervals([ev("a", 0, 10), ev("b", 5, 10),
                                ev("c", 20, 1)])
    assert got == [[0, 15 * US], [20 * US, 21 * US]]


def records(cell_name, steps, family_s, resizes=(), box=()):
    cell = Bench(ROOT).cell(cell_name)
    return cell, {"m": cell.config["port"], "mix": cell.mix,
                  "window": {"seconds": 10.0, "steps": 20,
                             "flops": 20 * frozen_work.step_flops(
                                 cell.config["port"], cell.mix["batch"],
                                 cell.mix["seq"]),
                             "resizes": list(resizes)},
                  "trace": {"window_s": 2.0, "busy_s": 1.5,
                            "steps": steps, "family_s": family_s,
                            "box_copy_s": list(box), "elementwise_s": 0.6,
                            "resizes": list(resizes)}}


def test_rooflines_take_each_calls_bound_at_its_slices_rows():
    steps = [{"slices": n, "launches": {"ssd_fwd": 48 * n, "ssd_bwd": 24 * n,
                                        "flash_fwd": 0, "flash_bwd": 0,
                                        "box_copy": 0}} for n in (4, 2)]
    b = frozen_work.bound_s(*frozen_work.ssd_work(4, 2048, 24, 64, 128, 128,
                                                  2)) * 48 * 4
    b += frozen_work.bound_s(*frozen_work.ssd_work(8, 2048, 24, 64, 128,
                                                   128, 2)) * 48 * 2
    cell, rec = records("mamba2-130m.malleable", steps,
                        {"ssd_fwd": 4 * b, "ssd_bwd": 1.0})
    assert cell.readers["ssd_fwd_roofline"](rec) == pytest.approx(25.0)
    assert cell.readers["device_idle_pct"](rec) == pytest.approx(25.0)
    assert cell.readers["elementwise_ms"](rec) == pytest.approx(300.0)


def test_resize_readers_and_nothing_to_read():
    resizes = [{"stall_s": 0.004, "decide_s": 0.0001,
                "copied_bytes": 1.675e9}]
    cell, rec = records("mamba2-130m.malleable", [], {}, resizes, [0.001])
    assert cell.readers["box_copy_roofline"](rec) == pytest.approx(100.0)
    assert cell.readers["reshard_host_ms"](rec) == pytest.approx(2.9)
    assert cell.readers["rms_decide_ms"](rec) == pytest.approx(0.1)
    assert cell.readers["ssd_bwd_roofline"](rec) is None
    _, bare = records("mamba2-130m.malleable", [], {})
    assert cell.readers["rms_decide_ms"](bare) is None
    assert cell.readers["box_copy_roofline"](bare) is None


def test_step_mfu_is_model_flops_over_the_window():
    cell, rec = records("granite-3-2b.steady", [], {})
    want = 100 * 20 * frozen_work.step_flops(cell.config["port"], 2, 4096) \
        / (10.0 * frozen_work.PEAK_BF16_FLOPS)
    assert cell.readers["step_mfu"](rec) == pytest.approx(want)
    assert 0 < want < 100
