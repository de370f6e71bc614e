"""The frozen yardstick against the program's modules it was copied from,
and the model FLOPs against a count by hand."""
from __future__ import annotations

import pytest
import torch

from dmrbench import frozen_data, frozen_work
from dmrbench.conftest import ROOT
from dmrbench.spec import Bench

# the cells' kernel calls: a slice's rows at 4, 2 and 1 slices
ATTN = [(b, 32, 8, 4096, 4096, 64) for b in (1, 2)]
SSD = [(b, 2048, 24, 64, 128, 128) for b in (4, 8, 16)]


@pytest.mark.parametrize("shape", ATTN)
@pytest.mark.parametrize("name", ["attention_work", "attention_bwd_work"])
def test_attention_work_is_the_programs(name, shape):
    from repro_torch.kernels import work
    assert getattr(frozen_work, name)(*shape, 2) == \
        getattr(work, name)(*shape, 2)


@pytest.mark.parametrize("shape", SSD)
@pytest.mark.parametrize("name", ["ssd_work", "ssd_bwd_work"])
def test_ssd_work_is_the_programs(name, shape):
    from repro_torch.kernels import work
    assert getattr(frozen_work, name)(*shape, 2) == \
        getattr(work, name)(*shape, 2)


def test_peaks_are_the_programs():
    from repro_torch.roofline import hardware
    assert frozen_work.PEAK_BF16_FLOPS == hardware.PEAK_BF16_FLOPS
    assert frozen_work.PEAK_BYTES == hardware.PEAK_BYTES


def test_granite_step_flops_by_hand():
    m = Bench(ROOT).config("granite-3-2b")["port"]
    d, f, v, layers, b, s = 2048, 8192, 49155, 40, 2, 4096
    # q, o: 32 heads of 64; k, v: 8 heads of 64; gate, up, down
    per_layer = d * 32 * 64 * 2 + d * 8 * 64 * 2 + 3 * d * f
    params = layers * per_layer + v * d
    pairs = s * (s + 1) // 2
    attn = layers * 4 * b * 32 * 64 * pairs
    want = 3 * (2 * params * b * s + attn)
    assert frozen_work.step_flops(m, b, s) == pytest.approx(want, rel=1e-12)
    assert params == pytest.approx(2.534e9, rel=1e-3)


def test_mamba2_step_flops_by_hand():
    m = Bench(ROOT).config("mamba2-130m")["port"]
    d, di, n, heads, v, layers, b, s = 768, 1536, 128, 24, 50280, 24, 16, \
        2048
    per_layer = d * (2 * di + 2 * n + heads) + di * d
    params = layers * per_layer + v * d
    # the SSD scan at its least: 16 chunks of 128 rows
    tri, chunks = 16 * (128 * 129 // 2), 16
    scan = (2 * b * n * tri + 2 * b * heads * 64 * tri
            + 2 * b * heads * 64 * n * 128 * (chunks - 1)
            + 2 * b * heads * 64 * n * s)
    want = 3 * (2 * params * b * s + layers * scan)
    assert frozen_work.step_flops(m, b, s) == pytest.approx(want, rel=1e-12)
    assert params == pytest.approx(128.7e6, rel=1e-3)


@pytest.mark.parametrize("seed", [0, 1234, 2 ** 31 + 3, 3 ** 25])
def test_data_is_the_programs_stream(seed):
    from repro_torch.data import DataConfig, SyntheticLMData
    ours = frozen_data.SyntheticLMData(50280, 64, 4, seed)
    theirs = SyntheticLMData(DataConfig(vocab_size=50280, seq_len=64,
                                        global_batch=4, seed=seed))
    for step in (0, 7):
        a, b = ours.batch(step), theirs.batch(step)
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k])


def test_rows_of_a_batch_all_differ():
    batch = frozen_data.SyntheticLMData(49155, 4096, 16, 99).batch(0)
    rows = {tuple(r.tolist()) for r in batch["tokens"]}
    assert len(rows) == 16
