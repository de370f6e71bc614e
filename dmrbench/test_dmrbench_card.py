"""The harness on the card at a test size: the kernels' routes of both test
cells, sound. Skipped without a card (decided inside the test)."""
from __future__ import annotations

import time

import pytest

from dmrbench import harness
from dmrbench.spec import Bench


@pytest.mark.card
@pytest.mark.parametrize("cell", ["tiny-dense.steady", "tiny-ssm.malleable"])
def test_a_sound_run_on_the_card(root, cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU route")
    out = harness.run_cell(Bench(root).cell(cell), 5, 1.0, False,
                           torch.device("cuda", 0), time.perf_counter())
    assert out["device"]["platform"] == "gpu"
    assert out["attempted"] >= 1
