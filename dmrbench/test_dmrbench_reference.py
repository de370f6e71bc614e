"""The plain reference against the program computing in float32, where the
two must agree to rounding; its layout against the program's parameters;
the draws."""
from __future__ import annotations

import copy

import pytest
import torch

from dmrbench import check, reference, trainrun
from dmrbench.conftest import ROOT
from dmrbench.spec import Bench

# the program in fp32 and the reference differ by float32's rounding alone
FP32_TOL = 1e-5


@pytest.mark.parametrize("cell", ["tiny-dense.steady", "tiny-ssm.malleable"])
def test_reference_is_the_program_in_float32(root, cell):
    """Loss, first gradient and change after three steps, leaf by leaf, the
    malleable cell's across a shrink 4 -> 2 and an expand 2 -> 4."""
    c = copy.deepcopy(Bench(root).cell(cell))
    c.config["port"]["dtype"] = "float32"
    run = trainrun.TrainCell(c, 2 ** 31 + 17, "cpu")
    run.setup()
    program = run.readings
    run.free()
    numbers = check.numbers(program, run.reference_readings())
    assert max(numbers.values()) < FP32_TOL, numbers


@pytest.mark.parametrize("name", ["granite-3-2b", "mamba2-130m"])
def test_layout_is_the_programs_parameters(name):
    from repro_torch.models import ModelConfig, build_model
    m = Bench(ROOT).config(name)["port"]
    model = build_model(ModelConfig(**dict(m, pattern=tuple(m["pattern"]))),
                        device="meta")
    want = {p: s for p, (s, _) in reference.layout(m).items()}
    assert trainrun.flat_specs(model.specs()) == want


def test_draws_repeat_and_differ_by_seed(root):
    m = Bench(root).config("tiny-ssm")["port"]
    a, b = reference.draw(m, 5, "cpu"), reference.draw(m, 5, "cpu")
    c = reference.draw(m, 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = "blocks/p0/mixer/in_proj"
    assert not torch.equal(a[w], c[w])
    # the published Mamba-2 init: PyTorch's Linear default, 1 / sqrt(3 fan-in)
    assert abs(float(a[w][0].std()) - (3 * 64) ** -0.5) < 0.02
    assert torch.equal(reference.draw_leaf(m, 5, w, "cpu"), a[w])


def test_control_rounds_products_to_float8(root):
    """The control's losses differ from the reference's by float8's
    rounding, far more than the program's bf16 does."""
    cell = Bench(root).cell("tiny-dense.steady")
    run = trainrun.TrainCell(cell, 3, "cpu")
    ref = run.reference_readings()
    ctl = run.reference_readings("fp8")
    gap = abs(ctl["losses"][0] - ref["losses"][0]) / ref["losses"][0]
    assert 1e-5 < gap < 0.1
