"""The router's load-balancing loss over the whole batch at several data
slices, in the port against the JAX reference, on the CPU.

The Switch loss ``coef * E * sum_e f_e P_e`` is a product of two means over
the batch. The reference's jitted step takes both over the whole
micro-batch; the port's trainer runs each data slice's rows in turn, so it
first routes every slice's rows without a graph (``slice_router_loads``)
and hands the whole micro-batch's routed shares f_e to each slice's loss,
whose router term it weighs 1 / (slices x accum). Held here: the trainer's
loss and every gradient at 2 and 4 data slices (and at 2 slices of 2 model
coordinates), ``accum`` 1 and 2, remat "none" and "nothing_saveable",
against ``jax.value_and_grad`` of the reference's loss on the global
micro-batches, for reduced phi3.5-moe and deepseek-moe, to 1e-5
max-normalised; one slice against two; a step at one slice is the plain
loss's, bit for bit, with no pre-pass; ``router_loads`` gives each MoE
block's routed share; and a remat's recompute reads the loads it was
given.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import reduced_config as jax_reduced_config  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.core import slice_devices  # noqa: E402
from repro_torch.models import ModelConfig, build_model  # noqa: E402
from repro_torch.models.layers import tree_map  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime import ElasticTrainer, TrainerConfig  # noqa: E402
from repro_torch.runtime import trainer as trainer_mod  # noqa: E402

CPU8 = slice_devices(8, "cpu")
TOL = 1e-5
# reduced configs: (arch, changes); deepseek's dense first layer is 4 x
# d_ff wide, as its 10944 against 1408
CASES = {"phi35-moe": ("phi3.5-moe-42b-a6.6b", {}),
         "deepseek-moe": ("deepseek-moe-16b", {"first_dense_ff": 1024})}
ROWS, SEQ = 8, 16


@pytest.fixture(autouse=True)
def one_thread():
    """The tier-1 run shares the machine's cores among its workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def configs(case, **changes):
    arch, more = CASES[case]
    cfg = dataclasses.replace(jax_reduced_config(jax_get_model(arch)[1]),
                              dtype="float32", **more, **changes)
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


def init_params(pcfg, seed=0):
    """Parameters drawn with numpy at each layer's own fan-in, norms at
    zero (tests/test_torch_tensor_parallel.py)."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        if spec.init == "zeros":
            return np.zeros(spec.shape, np.float32)
        stacked = spec.logical[0] == "layers" and len(spec.shape) > 2
        fan_in = spec.shape[1] if stacked else spec.shape[0]
        return (rng.standard_normal(spec.shape) * spec.scale
                / np.sqrt(fan_in)).astype(np.float32)

    return tree_map(draw, build_model(pcfg, device="cpu").specs())


def lm_batch(cfg, seed=0):
    """ROWS x SEQ tokens and labels, a quarter of the labels masked."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (ROWS, SEQ)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (ROWS, SEQ)).astype(np.int32)
    labels[rng.random((ROWS, SEQ)) < 0.25] = -1
    return {"tokens": tokens, "labels": labels}


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in leaves(sub, prefix + (k,)).items()}
    return {prefix: tree}


def max_norm_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@functools.lru_cache(maxsize=None)
def reference(case, accum):
    """The reference's step on the global batch: ``jax.value_and_grad`` of
    its loss on each of ``accum`` micro-batches (rows cut in order, as its
    trainer's scan), the losses and gradients averaged over them. ->
    (cfg, pcfg, params, batch, loss, {path: gradient})."""
    cfg, pcfg = configs(case)
    params = init_params(pcfg)
    batch = lm_batch(cfg)
    step = jax.jit(jax.value_and_grad(jax_build_model(cfg).loss,
                                      has_aux=True))
    outs = [step(params, {k: jnp.asarray(v.reshape(accum, -1, SEQ)[i])
                          for k, v in batch.items()}) for i in range(accum)]
    loss = sum(float(o[0][0]) for o in outs) / accum
    grads = jax.tree.map(lambda *g: np.asarray(sum(g)) / accum,
                         *[o[1] for o in outs])
    return cfg, pcfg, params, batch, loss, leaves(grads)


def trainer_step(monkeypatch, pcfg, params, batch, slices, ways=1, accum=1):
    """One ElasticTrainer.train_step at ``slices`` data slices of ``ways``
    model coordinates on virtual CPU devices: (the loss, {path: gradient})
    as the step hands them to ``apply_step``."""
    seen = {}

    def spy(opt_cfg, state, grads, loss):
        seen["step"] = loss, leaves(grads)
        return state, {"loss": loss}

    monkeypatch.setattr(trainer_mod, "apply_step", spy)
    tr = ElasticTrainer(build_model(pcfg, device="cpu"), AdamWConfig(), None,
                        TrainerConfig(grad_accum=accum, max_slices=slices,
                                      model_ways=ways),
                        devices=CPU8, slices=slices)
    state = tr.init_state(params=params_from_jax(params, "cpu"))
    tr.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return seen["step"]


def check(got, loss, grads):
    np.testing.assert_allclose(float(got[0]), loss, rtol=TOL)
    assert set(got[1]) == set(grads)
    errs = {p: max_norm_err(g.numpy(), grads[p]) for p, g in got[1].items()}
    top = max(errs, key=errs.get)
    assert errs[top] < TOL, (top, errs[top])


@pytest.mark.parametrize("remat", ["none", "nothing_saveable"])
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("slices", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_trainer_matches_jax_over_data_slices(monkeypatch, case, slices,
                                              accum, remat):
    """The trainer's loss and every gradient at 2 and 4 data slices against
    the reference's step over the global micro-batches."""
    cfg, pcfg, params, batch, loss, grads = reference(case, accum)
    got = trainer_step(monkeypatch, dataclasses.replace(pcfg, remat=remat),
                       params, batch, slices, accum=accum)
    check(got, loss, grads)


@pytest.mark.parametrize("case", list(CASES))
def test_two_data_slices_of_two_model_ways_match_jax(monkeypatch, case):
    """At (data 2, model 2) the pre-pass routes each slice's rows with its
    coordinates in lockstep; the step matches the reference's."""
    cfg, pcfg, params, batch, loss, grads = reference(case, 1)
    check(trainer_step(monkeypatch, pcfg, params, batch, 2, ways=2), loss,
          grads)


@pytest.mark.parametrize("case", list(CASES))
def test_one_slice_matches_two(monkeypatch, case):
    """The same step at one data slice and at two: the loss and every
    gradient to 1e-5 (the router loss of two slices was each slice's own
    product of means before the pre-pass)."""
    cfg, pcfg, params, batch, _, _ = reference(case, 1)
    one = trainer_step(monkeypatch, pcfg, params, batch, 1)
    two = trainer_step(monkeypatch, pcfg, params, batch, 2)
    check(two, float(one[0]), {p: g.numpy() for p, g in one[1].items()})


@pytest.mark.parametrize("case", list(CASES))
def test_one_slice_step_is_the_plain_loss(monkeypatch, case):
    """At one slice the trainer runs no pre-pass, and its gradients are
    those of ``model.loss`` on the whole batch, bit for bit (its weight is
    1), as before the repair."""
    cfg, pcfg, params, batch, _, _ = reference(case, 1)
    calls = []
    kept = trainer_mod.slice_router_loads
    monkeypatch.setattr(trainer_mod, "slice_router_loads",
                        lambda *a, **k: calls.append(1) or kept(*a, **k))
    got = trainer_step(monkeypatch, pcfg, params, batch, 1)
    assert not calls
    model = build_model(pcfg, device="cpu")
    tparams = params_from_jax(params, "cpu")
    for p in leaves(tparams).values():
        p.requires_grad_(True)
    loss, _ = model.loss(tparams, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    loss.backward()
    assert torch.equal(got[0], loss.detach())
    for path, p in leaves(tparams).items():
        assert torch.equal(got[1][path], p.grad), path


@pytest.mark.parametrize("case", list(CASES))
def test_router_loads_are_each_moe_blocks_routed_share(case):
    """``router_loads`` returns one share per MoE block (none for a dense
    first layer), each summing to top_k; the first MoE block's is its
    router's one-hot mean over the batch's rows and positions; the aux
    loss with a block's own share as ``load`` is the aux loss without."""
    cfg, pcfg, params, batch, _, _ = reference(case, 1)
    model = build_model(pcfg, device="cpu")
    tparams = params_from_jax(params, "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loads = model.router_loads(tparams, tbatch)
    keys = [f"blocks.p0.{r}" for r in range(model._pattern_layout()[0])]
    assert list(loads) == keys
    for share in loads.values():
        assert share.shape == (pcfg.num_experts,)
        assert share.sum().item() == pytest.approx(pcfg.top_k, rel=1e-6)
    _, parts = model.loss(tparams, tbatch)
    _, again = model.loss(tparams, tbatch, loads)
    assert torch.equal(parts["aux"], again["aux"])
    assert torch.equal(parts["ce"], again["ce"])


@pytest.mark.parametrize("case", list(CASES))
def test_remat_recompute_reads_the_loads_it_was_given(case):
    """Loads that are not the batch's own (every expert's share k / E) move
    the aux loss; under remat "nothing_saveable" the loss and every
    gradient are bit-equal to remat "none"'s with the same loads, so the
    recompute in the backward pass read the same loads by layer."""
    cfg, pcfg, params, batch, _, _ = reference(case, 1)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    model = build_model(pcfg, device="cpu")
    flat = torch.full((pcfg.num_experts,), pcfg.top_k / pcfg.num_experts)
    loads = {k: flat for k in model.router_loads(params_from_jax(
        params, "cpu"), tbatch)}
    out = {}
    for remat in ("none", "nothing_saveable"):
        m = build_model(dataclasses.replace(pcfg, remat=remat), device="cpu")
        tparams = params_from_jax(params, "cpu")
        for p in leaves(tparams).values():
            p.requires_grad_(True)
        loss, parts = m.loss(tparams, tbatch, loads)
        loss.backward()
        out[remat] = loss.detach(), parts["aux"].detach(), {
            k: p.grad for k, p in leaves(tparams).items()}
    own = model.loss(params_from_jax(params, "cpu"), tbatch)[1]["aux"]
    assert not torch.equal(out["none"][1], own)
    assert torch.equal(out["none"][0], out["nothing_saveable"][0])
    for path, g in out["none"][2].items():
        assert torch.equal(g, out["nothing_saveable"][2][path]), path
