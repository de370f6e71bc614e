"""The port's training slice against the JAX reference, on the CPU:
``CausalLM.loss`` and its gradients, AdamW, the synthetic data stream, the
elastic trainer at one slice and the training launcher.

Inputs are made with numpy (or are the reference's own init state and
batches, carried over by the bridge) and fed to both packages. On the CPU
the port's attention takes its chunked path; the flash kernels' forward
and backward run only on the card, where ``chip_smoke.py`` holds them
against these paths.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data import SyntheticLMData as JaxData  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import reduced_config as jax_reduced_config  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import apply_updates as jax_apply_updates  # noqa: E402
from repro.optim import init_state as jax_init_state  # noqa: E402
from repro.runtime import ElasticTrainer as JaxTrainer  # noqa: E402
from repro.runtime import TrainerConfig as JaxTrainerConfig  # noqa: E402
from repro_torch.bridge import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMData, make_batch  # noqa: E402
from repro_torch.models import ModelConfig, build_model  # noqa: E402
from repro_torch.models import reduced_config  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (FSDP_RULES, TP_DP_RULES,  # noqa: E402
                              gather, logical_to_sharding, make_mesh, place)
from repro_torch.core.sharding import zeros  # noqa: E402
from repro_torch.models.layers import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.transformer import DOTS  # noqa: E402
from repro_torch.optim import (AdamWConfig,  # noqa: E402
                               apply_sharded_updates, global_norm, schedule,
                               state_logical)
from repro_torch.runtime import ElasticTrainer, TrainerConfig  # noqa: E402

KEY = jax.random.PRNGKey(3)
# fp32 on both sides, sums in another order: the loss (about 7.6) to a
# relative 1e-5, each gradient leaf max-normalised to 1e-4 (the reference's
# own model-level tolerance, tests/test_decode_consistency.py)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


def smollm_fp32(**changes):
    """The reference's reduced smollm (d_model 128, 4 heads / 1 KV head of
    32, 2 layers, vocab 2048) in fp32, and the port's copy of it."""
    cfg = dataclasses.replace(jax_reduced_config(jax_get_model(
        "smollm-135m")[1]), dtype="float32", **changes)
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


def init_params(cfg):
    """The reference's init of ``cfg``'s 2 layers drawn as smollm-135m's 30
    are drawn, then cut to the first 2. The reference's init takes a
    stacked weight's layers axis as its fan-in (ROADMAP.md, Queue 3), so 2
    layers drawn on their own get weights sqrt(15) times smollm's; the
    model is then chaotic, and the two packages' fp32 gradients, summed in
    another order, differ by more than GRAD_TOL while their losses agree.
    Drawn at 30 layers every leaf agrees well within it, as
    tests/test_torch_model.py draws its cut models."""
    deep = jax_build_model(dataclasses.replace(cfg, num_layers=30)).init(KEY)
    reps = cfg.pattern_repeats[0]
    return {k: jax.tree.map(lambda a: a[:reps], v) if k == "blocks" else v
            for k, v in deep.items()}


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in leaves(sub, prefix + (k,)).items()}
    return {prefix: tree}


def max_norm_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def lm_batch(cfg, b=2, s=32, seed=0):
    """Random tokens and labels, about a quarter of the labels masked
    (-1), as numpy int32."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[rng.random((b, s)) < 0.25] = -1
    return {"tokens": tokens, "labels": labels}


def port_loss_and_grads(pcfg, np_params, batch):
    model = build_model(pcfg, device="cpu")
    params = params_from_jax(np_params, device="cpu")
    for p in leaves(params).values():
        p.requires_grad_(True)
    loss, parts = model.loss(params, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    loss.backward()
    return loss, parts, {k: p.grad for k, p in leaves(params).items()}


@pytest.mark.parametrize("ce_chunk,remat", [
    (0, "none"),                 # whole (B, S, V) logits
    (16, "none"),                # two chunks of 16 positions
    (12, "none"),                # a ragged last chunk (12, 12, 8)
    (0, "nothing_saveable"),     # each pattern unit recomputed in backward
    (0, "dots"),                 # the same, its matrix products kept
])
def test_loss_and_grads_match_jax(ce_chunk, remat):
    cfg, pcfg = smollm_fp32(ce_chunk=ce_chunk)
    model = jax_build_model(cfg)
    params = init_params(cfg)
    batch = lm_batch(cfg)
    (jloss, jparts), jgrads = jax.value_and_grad(model.loss, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    np_params = jax.tree.map(np.asarray, params)
    loss, parts, grads = port_loss_and_grads(
        dataclasses.replace(pcfg, remat=remat), np_params, batch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(parts["ce"].item(), float(jparts["ce"]),
                               rtol=LOSS_RTOL)
    assert parts["aux"].item() == float(jparts["aux"]) == 0.0
    want = leaves(jax.tree.map(np.asarray, jgrads))
    assert set(grads) == set(want)
    for path, g in grads.items():
        err = max_norm_err(g.numpy(), want[path])
        assert err < GRAD_TOL, (path, err)


def test_loss_with_every_label_masked_divides_by_one():
    """The denominator is at least 1: all labels masked gives a loss of
    0, not NaN, as in the reference."""
    _, pcfg = smollm_fp32()
    model = build_model(pcfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    loss, parts = model.loss(params, {"tokens": tokens,
                                      "labels": torch.full((2, 8), -1)})
    assert loss.item() == 0.0 and parts["ce"].item() == 0.0


def test_remat_moves_memory_not_numbers():
    """"nothing_saveable" recomputes each unit in the backward pass, "dots"
    all of it but its matrix products; both give the same loss and
    gradients as "none", bit for bit (the same operations on the same
    inputs). A forward without a graph runs under each, and an unknown
    remat is refused."""
    cfg, pcfg = smollm_fp32()
    np_params = jax.tree.map(np.asarray, init_params(cfg))
    batch = lm_batch(cfg)
    runs = {remat: port_loss_and_grads(
        dataclasses.replace(pcfg, remat=remat), np_params, batch)
        for remat in ("none", "nothing_saveable", "dots")}
    l0, _, g0 = runs["none"]
    for remat in ("nothing_saveable", "dots"):
        loss, _, grads = runs[remat]
        assert loss.item() == l0.item(), remat
        for path in g0:
            torch.testing.assert_close(grads[path], g0[path], rtol=0, atol=0)
    model = build_model(dataclasses.replace(pcfg, remat="dots"), device="cpu")
    with torch.no_grad():
        model.forward(params_from_jax(np_params, device="cpu"),
                      torch.from_numpy(batch["tokens"]))
    with pytest.raises(ValueError, match="unknown remat"):
        port_loss_and_grads(dataclasses.replace(pcfg, remat="offload"),
                            np_params, batch)


class ProductCount(TorchDispatchMode):
    """Counts the ops of ``ops`` (default: the matrix products and the
    flash forward, ``transformer.DOTS``) that run."""

    def __init__(self, ops=DOTS):
        super().__init__()
        self.ops = ops
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in self.ops
        return func(*args, **(kwargs or {}))


def product_counts(pcfg, np_params, batch, device="cpu", ops=DOTS):
    """(products in the forward, products in the backward) of one loss;
    on ``device="meta"`` the parameters' and batch's shapes only (every
    kernel route taken, nothing launched)."""
    params = params_from_jax(np_params, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if device == "meta":
        params = tree_map(lambda p: p.to("meta"), params)
        batch = {k: v.to("meta") for k, v in batch.items()}
    for p in leaves(params).values():
        p.requires_grad_(True)
    model = build_model(pcfg, device=device)
    with ProductCount(ops) as fwd:
        loss, _ = model.loss(params, batch)
    with ProductCount(ops) as bwd:
        loss.backward()
    return fwd.n, bwd.n


def test_remat_dots_saves_the_products():
    """Under "dots" the backward pass runs no product of the units'
    forward again: as many products as without remat, where
    "nothing_saveable" runs the units' products again (all but the last
    of each unit, whose output no backward needs: the recompute stops
    early). On the card's route the same holds for the flash forward,
    whose op "dots" saves."""
    cfg, pcfg = smollm_fp32()
    np_params = jax.tree.map(np.asarray, init_params(cfg))
    batch = lm_batch(cfg)
    counts = {remat: product_counts(dataclasses.replace(pcfg, remat=remat),
                                    np_params, batch)
              for remat in ("none", "nothing_saveable", "dots")}
    (fwd, bwd), (_, again), (_, dots) = (
        counts["none"], counts["nothing_saveable"], counts["dots"])
    assert counts["dots"][0] == counts["nothing_saveable"][0] == fwd
    assert dots == bwd
    reps = pcfg.pattern_repeats[0]
    assert again == bwd + fwd - 1 - reps, counts
    # the card's route (on meta: the flash kernels' ops, nothing launched):
    # "dots" keeps the flash forward's output and log-sum-exp, so its
    # backward pass launches no forward again, where "nothing_saveable"
    # launches one a layer
    flash = [torch.ops.repro_torch.flash_attention_fwd.default]
    meta = {remat: product_counts(dataclasses.replace(pcfg, remat=remat),
                                  np_params, batch, "meta", flash)
            for remat in ("nothing_saveable", "dots")}
    assert meta == {"nothing_saveable": (reps, reps), "dots": (reps, 0)}


# -- AdamW: twins of tests/test_optim.py ------------------------------------


# Each update runs on meshes of 1, 2 and 4 virtual CPU slices: the
# parameters replicated, the moments laid out by ZeRO-1, as the trainer
# holds them.
SLICES = (1, 2, 4)


def on_mesh(params, slices):
    """``params`` (a tree of tensors) replicated on ``slices`` slices, and
    AdamW's state beside them: zero fp32 moments cut by ``state_logical``
    (every dimension's logical axis None) and step 0."""
    mesh = make_mesh(slices, 1, devices=["cpu"] * slices)
    logical = tree_map(lambda p: (None,) * p.ndim, params)
    shapes = tree_map(lambda p: tuple(p.shape), params)
    sh = logical_to_sharding(
        {"params": logical, **state_logical(logical, shapes, mesh,
                                            TP_DP_RULES)},
        {"params": shapes, "mu": shapes, "nu": shapes, "step": ()}, mesh,
        TP_DP_RULES)
    state = {name: tree_map(lambda p, s: zeros(p.shape, torch.float32, s),
                            params, sh[name]) for name in ("mu", "nu")}
    state["step"] = zeros((), torch.int32, sh["step"])
    return tree_map(place, params, sh["params"]), state


def test_adamw_matches_numpy_reference():
    cfg = AdamWConfig(lr=0.1, beta1=0.9, beta2=0.99, eps=1e-8,
                      weight_decay=0.0, clip_norm=None, warmup_steps=0,
                      total_steps=1000, min_lr_ratio=1.0)
    p = {"w": torch.tensor([[1.0, -2.0], [0.5, 3.0]])}
    g = {"w": torch.tensor([[0.1, 0.2], [-0.3, 0.4]])}
    mu = 0.1 * g["w"].numpy()
    nu = 0.01 * g["w"].numpy() ** 2
    mh, nh = mu / (1 - 0.9), nu / (1 - 0.99)
    ref = p["w"].numpy() - 0.1 * mh / (np.sqrt(nh) + 1e-8)
    for slices in SLICES:
        ps, st = on_mesh(p, slices)
        new_p, st1, _ = apply_sharded_updates(cfg, ps, g, st)
        np.testing.assert_allclose(gather(new_p["w"]).numpy(), ref,
                                   rtol=1e-5)
        assert int(st1["step"]) == 1


def test_weight_decay_only_on_matrices():
    cfg = AdamWConfig(lr=0.1, weight_decay=1.0, clip_norm=None,
                      warmup_steps=0, min_lr_ratio=1.0)
    p = {"w": torch.ones((2, 2)), "b": torch.ones((2,))}
    g = {"w": torch.zeros((2, 2)), "b": torch.zeros((2,))}
    for slices in SLICES:
        ps, st = on_mesh(p, slices)
        new_p, _, _ = apply_sharded_updates(cfg, ps, g, st)
        # decayed, also where a slice holds a row block of the matrix
        assert float((gather(new_p["w"]) - 1.0).abs().max()) > 0
        np.testing.assert_allclose(gather(new_p["b"]).numpy(), 1.0)


def test_clipping_bounds_update():
    cfg = AdamWConfig(clip_norm=1.0, warmup_steps=0)
    p = {"w": torch.zeros((4,))}
    g = {"w": torch.full((4,), 100.0)}
    for slices in SLICES:
        ps, st = on_mesh(p, slices)
        _, _, metrics = apply_sharded_updates(cfg, ps, g, st)
        assert float(metrics["grad_norm"]) == 200.0


def test_schedule_warmup_and_cosine():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    assert float(schedule(cfg, 0)) == 0.0
    assert abs(float(schedule(cfg, 10)) - 1.0) < 1e-6
    assert abs(float(schedule(cfg, 100)) - 0.1) < 1e-6


def test_global_norm():
    t = {"a": torch.ones((4,)), "b": torch.full((3,), 2.0)}
    assert abs(float(global_norm(t)) - np.sqrt(4 + 12)) < 1e-6


def test_apply_updates_matches_reference_on_a_random_tree():
    """Three updates of a random tree (matrices, vectors, a stacked
    3-d leaf; mixed scales so clipping is active) with decay on, in the
    middle of the warmup, on 1, 2 and 4 slices: parameters, moments, lr and
    grad norm against the reference's at 1e-6 (fp32, the same
    operations)."""
    kw = dict(lr=1e-2, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1,
              clip_norm=1.0, warmup_steps=5, total_steps=50,
              min_lr_ratio=0.1)
    rng = np.random.default_rng(7)
    shapes = {"w": (8, 6), "b": (6,), "blocks": {"wq": (3, 8, 4),
                                                  "ln": (3, 8)}}

    def draw(scale):
        return jax.tree.map(
            lambda s: (scale * rng.standard_normal(s)).astype(np.float32),
            shapes, is_leaf=lambda x: isinstance(x, tuple))

    params = draw(1.0)
    grads = [draw(3.0) for _ in range(3)]
    jp, js = jax.tree.map(jnp.asarray, params), jax_init_state(
        jax.tree.map(jnp.asarray, params))
    for g in grads:
        jp, js, jm = jax_apply_updates(JaxAdamWConfig(**kw), jp,
                                       jax.tree.map(jnp.asarray, g), js)
    for slices in SLICES:
        tp, ts = on_mesh(params_from_jax(params, device="cpu"), slices)
        for g in grads:
            tp, ts, tm = apply_sharded_updates(
                AdamWConfig(**kw), tp, params_from_jax(g, device="cpu"), ts)
            assert float(tm["grad_norm"]) > kw["clip_norm"]
        for name in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-6)
        assert int(ts["step"]) == int(js["step"]) == 3
        for got, want in ((tp, jp), (ts["mu"], js["mu"]),
                          (ts["nu"], js["nu"])):
            want = leaves(jax.tree.map(np.asarray, want))
            for path, t in leaves(tree_map(gather, got)).items():
                np.testing.assert_allclose(t.numpy(), want[path],
                                           rtol=1e-6, atol=1e-6)


# -- the data stream ------------------------------------------------------------


def test_data_is_a_pure_function_of_seed_and_step():
    cfg = DataConfig(vocab_size=2048, seq_len=32, global_batch=4, seed=11)
    a, b = SyntheticLMData(cfg), SyntheticLMData(cfg)
    for step in (0, 1, 17):
        for key in ("tokens", "labels"):
            assert torch.equal(a.batch(step)[key], b.batch(step)[key])
            assert torch.equal(a.batch(step)[key], make_batch(cfg, step)[key])
    assert not torch.equal(a.batch(0)["tokens"], a.batch(1)["tokens"])
    other = SyntheticLMData(dataclasses.replace(cfg, seed=12))
    assert not torch.equal(a.batch(0)["tokens"], other.batch(0)["tokens"])


def test_data_labels_are_tokens_shifted_and_shift_is_the_references():
    for vocab, seed in ((2048, 1234), (49152, 7), (300, 3)):
        cfg = DataConfig(vocab_size=vocab, seq_len=64, global_batch=8,
                         seed=seed)
        data = SyntheticLMData(cfg)
        ref = JaxData(JaxDataConfig(vocab_size=vocab, seq_len=64,
                                    global_batch=8, seed=seed))
        assert (data.k, data.shift) == (ref.k, ref.shift)
        batch = data.batch(3)
        toks, labels = batch["tokens"], batch["labels"]
        assert toks.shape == labels.shape == (8, 64)
        assert toks.dtype == labels.dtype == torch.int32
        assert torch.equal(toks[:, 1:], labels[:, :-1])
        assert int(toks.min()) >= 0 and int(toks.max()) < data.k
        # the learnable structure: next = (this + shift) mod k, except
        # where noise replaced a token (10%, so ~81% of pairs are clean)
        follows = ((toks + data.shift) % data.k == labels).float().mean()
        assert 0.7 < float(follows) < 0.92


def test_data_is_text_only():
    """Frontend and encoder-decoder batches are ported (the name stays from
    when they raised): the reference's batch shapes and types, tokens and
    labels from the same stream as text-only batches, and the stub
    embeddings drawn from the step's generator."""
    for extra, text, front in (
            (dict(frontend="patches", frontend_tokens=8, d_model=16), 8,
             (2, 8, 16)),
            (dict(frontend="frames", d_model=16, enc_dec=True), 8,
             (2, 8, 16)),
            (dict(enc_dec=True), 8, None)):
        kw = dict(vocab_size=64, seq_len=16, global_batch=2, **extra)
        batch = SyntheticLMData(DataConfig(**kw)).batch(3)
        want = JaxData(JaxDataConfig(**kw)).batch(3)
        assert set(batch) == set(want)
        for name, t in batch.items():
            assert tuple(t.shape) == want[name].shape
            assert str(t.dtype)[6:] == str(want[name].dtype)
        assert batch["tokens"].shape == (2, text)
        assert torch.equal(batch["tokens"][:, 1:], batch["labels"][:, :-1])
        if front is None:
            assert "frontend" not in batch
        else:
            assert batch["frontend"].shape == front
            assert torch.equal(
                SyntheticLMData(DataConfig(**kw)).batch(3)["frontend"],
                batch["frontend"])


# -- the trainer -----------------------------------------------------------------


class FedBatches:
    """A data source that replays another stream's batches as tensors."""

    def __init__(self, source):
        self.source = source

    def batch(self, step):
        return {k: torch.from_numpy(np.array(v))
                for k, v in self.source.batch(step).items()}


def reduced_fp32(arch):
    """The reference's reduced config of ``arch`` in fp32 and the port's
    copy of it."""
    cfg = dataclasses.replace(jax_reduced_config(jax_get_model(arch)[1]),
                              dtype="float32")
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


def per_layer_params(pcfg, seed=0):
    """Parameters drawn with numpy as the reference's init draws them, but
    each stacked weight at its layer's own fan-in (its second axis, where
    the reference takes the stacked layers axis); norms at zero, as both
    inits. The weights ``chip_smoke.py`` holds the card's train steps at."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        if spec.init == "zeros":
            return jnp.zeros(spec.shape, jnp.float32)
        stacked = spec.logical[0] == "layers" and len(spec.shape) > 2
        fan_in = spec.shape[1] if stacked else spec.shape[0]
        return jnp.asarray((rng.standard_normal(spec.shape) * spec.scale
                            / np.sqrt(fan_in)).astype(np.float32))

    return tree_map(draw, build_model(pcfg, device="cpu").specs())


# (arch, sequence length) of the trainer's runs: smollm from the
# reference's init drawn at its published depth (init_params); gemma2,
# paligemma, phi3.5-moe and granite from weights at each layer's own
# fan-in (per_layer_params): gemma2 past its reduced window of 64 (the
# local layer's window biting, the softcaps on the scores and the logits),
# paligemma with its 8 patch embeddings in every batch (the stream's text
# is S - 8 tokens), phi3.5 with the routers' loss in every step, granite's
# dense GQA, seamless's encoder-decoder (32 frames and 32 tokens a row, the
# stream's enc_dec split; the tied embedding's gradient through both its
# uses)
TRAINER_CASES = [("smollm-135m", 32), ("gemma2-27b", 96),
                 ("paligemma-3b", 40), ("phi3.5-moe-42b-a6.6b", 32),
                 ("granite-3-2b", 32), ("seamless-m4t-medium", 64)]


@pytest.mark.parametrize("arch,seq_len", TRAINER_CASES)
def test_trainer_reproduces_reference_losses(arch, seq_len):
    """Started from the reference trainer's own init state and fed its
    batches, the port's trainer gives the reference's losses (and lr, grad
    norms) over 5 fp32 steps, to 1e-4 (relative; fp32 on both sides).

    smollm's parameters are drawn at smollm-135m's depth (see
    ``init_params``): at the 2-layer draw the model is chaotic, the first
    step's losses still agree, but AdamW's early, sign-like updates carry
    the gradients' rounding on, and by step 5 the losses part by more than
    the tolerance (PERF.md, section 7). gemma2's 4 layers drawn so at its
    46 layers' depth are chaotic too at S 96 (and at every S from 64 to
    128): its first step agrees (loss 6e-8, grad norm 7e-7 relative), but
    the grad norms part by 3.6e-4 at step 3 and 2.6e-3 at step 4, and the
    port's own run from a start perturbed by 1e-7 (relative, each weight)
    parts from the unperturbed one as far (3.0e-4, 3.0e-3): the rounding's
    floor, not the port, so the other four cases draw each layer at its
    own fan-in (``per_layer_params``), as chip_smoke.py's held train steps do.
    There every case's grad norms agree within 1e-5 over the 5 steps, and
    a perturbed run stays as close to the unperturbed one."""
    cfg, pcfg = reduced_fp32(arch)
    encdec = cfg.family == "encdec"
    data = JaxDataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                         global_batch=8, frontend=cfg.frontend,
                         frontend_tokens=cfg.frontend_tokens,
                         d_model=cfg.d_model if cfg.frontend else 0,
                         enc_dec=encdec)
    opt = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    tcfg = dict(steps=5, model_ways=1, max_slices=1, log_period=1)
    ref = JaxTrainer(jax_build_model(cfg), JaxAdamWConfig(**opt), data,
                     JaxTrainerConfig(**tcfg))
    state = ref.init_state(seed=0)
    state["params"] = (init_params(cfg) if arch == "smollm-135m"
                       else per_layer_params(pcfg))
    state["opt"] = jax_init_state(state["params"])
    start = state_from_jax(jax.tree.map(np.array, state), device="cpu")
    ref.train(state=state)
    if cfg.frontend:
        front = seq_len // 2 if encdec else cfg.frontend_tokens
        assert ref.data.batch(0)["frontend"].shape == (8, front, cfg.d_model)
        assert ref.data.batch(0)["tokens"].shape == (8, seq_len - front)
    model = build_model(pcfg, device="cpu")
    with torch.no_grad():
        _, parts = model.loss(start["params"], FedBatches(ref.data).batch(0))
    # phi3.5's steps carry the routers' loss; the others' carry none
    assert (float(parts["aux"]) > 0) == (cfg.family == "moe")
    port = ElasticTrainer(model, AdamWConfig(**opt), FedBatches(ref.data),
                          TrainerConfig(**tcfg))
    port.train(state=start)
    assert [m["step"] for m in port.metrics] == [1, 2, 3, 4, 5]
    for got, want in zip(port.metrics, ref.metrics):
        assert got["slices"] == want["slices"] == 1
        for key in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4)


def test_grad_accum_equivalence():
    """accum=2 must match accum=1 on the same global batch (fp32), as
    tests/test_trainer.py holds the reference."""
    _, pcfg = smollm_fp32()
    data = DataConfig(vocab_size=pcfg.vocab_size, seq_len=32, global_batch=8)
    opt = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)

    def run(accum):
        tr = ElasticTrainer(build_model(pcfg, device="cpu"), opt, data,
                            TrainerConfig(steps=5, grad_accum=accum,
                                          log_period=1))
        tr.train()
        return [m["loss"] for m in tr.metrics]

    l1, l2 = run(1), run(2)
    assert max(abs(a - b) for a, b in zip(l1, l2)) < 5e-3


def test_loss_descends():
    """The reduced smollm (bf16 over fp32 parameters) learns the stream's
    structure, as tests/test_trainer.py holds the reference."""
    cfg = reduced_config(get_config("smollm-135m"))
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8)
    opt = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=120)
    tr = ElasticTrainer(build_model(cfg, device="cpu"), opt, data,
                        TrainerConfig(steps=120, log_period=10))
    state = tr.train()
    first, last = tr.metrics[0]["loss"], tr.metrics[-1]["loss"]
    assert last < first - 0.3, (first, last)
    assert int(state["step"]) == 120
    assert all(np.isfinite(m["loss"]) for m in tr.metrics)


def test_trainer_refuses_what_is_not_ported():
    """Nothing the trainer takes raises any more: tensor parallelism inside
    a slice of the block kinds that once raised ("ssd", "rglru", the
    mixture-of-experts feed-forward, the encoder-decoder) is taken at
    model_ways 2, as smollm's is. FSDP_RULES, more slices, a checkpoint
    directory and an RMS are taken, and under FSDP_RULES each slice holds
    its half of every parameter with an embed axis."""
    _, pcfg = smollm_fp32()
    model = build_model(pcfg, device="cpu")
    data = DataConfig(vocab_size=pcfg.vocab_size, seq_len=8, global_batch=2)
    for arch in ("mamba2-130m", "recurrentgemma-9b", "deepseek-moe-16b",
                 "seamless-m4t-medium"):
        other = build_model(reduced_config(get_config(arch)), device="cpu")
        tp = ElasticTrainer(other, AdamWConfig(), data,
                            TrainerConfig(model_ways=2), devices=["cpu"] * 2)
        assert tp.mesh.shape == {"data": 1, "model": 2}, arch
    tp = ElasticTrainer(model, AdamWConfig(), data,
                        TrainerConfig(model_ways=2), devices=["cpu"] * 2)
    assert tp.mesh.shape == {"data": 1, "model": 2}
    tr = ElasticTrainer(model, AdamWConfig(), data,
                        TrainerConfig(max_slices=2, ckpt_dir=None,
                                      rules=FSDP_RULES),
                        rms=object(), devices=["cpu"] * 2)
    assert tr.slices == 2 and tr.dmr is not None
    params = tr.init_state(seed=0)["params"]
    for logical, p in zip(tree_leaves(model.logical()), tree_leaves(params)):
        halves = [t.shape for t in p.shards.values()]
        if "embed" in logical:
            d = logical.index("embed")
            assert all(h[d] * 2 == p.shape[d] for h in halves), logical
        else:
            assert all(h == p.shape for h in halves), logical


def test_state_from_jax_carries_the_whole_train_state():
    cfg, _ = smollm_fp32()
    params = jax_build_model(cfg).init(KEY)
    opt = jax_init_state(params)
    opt = {"mu": jax.tree.map(lambda x: x + 1.0, opt["mu"]),
           "nu": jax.tree.map(lambda x: x + 2.0, opt["nu"]),
           "step": jnp.int32(4)}
    state = {"params": params, "opt": opt, "rng": jax.random.PRNGKey(1),
             "step": jnp.int32(4)}
    got = state_from_jax(jax.tree.map(np.asarray, state), device="cpu")
    assert set(got) == {"params", "opt", "rng", "step"}
    assert int(got["step"]) == int(got["opt"]["step"]) == 4
    assert got["rng"].dtype == torch.uint32
    np.testing.assert_array_equal(got["rng"].numpy(),
                                  np.asarray(state["rng"]))
    for name, tree in (("params", params), ("mu", opt["mu"]),
                       ("nu", opt["nu"])):
        sub = got["params"] if name == "params" else got["opt"][name]
        want = leaves(jax.tree.map(np.asarray, tree))
        for path, t in leaves(sub).items():
            np.testing.assert_array_equal(t.numpy(), want[path])


# -- guards and the launcher ------------------------------------------------------


def test_train_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import train
    assert train.main(["--device", "cpu", "--steps", "4",
                       "--global-batch", "4", "--seq-len", "32"]) == 0
    out = capsys.readouterr().out
    assert "step     4 loss" in out
    assert "smollm-135m on cpu: 4 steps" in out


def test_train_launcher_needs_a_card_unless_asked_for_cpu(monkeypatch):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1", "--devices", "4", "--elastic"])


@pytest.mark.parametrize("arch,fits", [
    ("smollm-135m", True), ("granite-3-2b", True), ("paligemma-3b", True),
    ("qwen3-4b", True), ("seamless-m4t-medium", True),
    ("gemma2-27b", False), ("phi3.5-moe-42b-a6.6b", False),
    ("deepseek-moe-16b", False), ("recurrentgemma-9b", False)])
def test_train_launcher_refuses_training_state_beyond_the_card(arch, fits):
    """The launcher refuses, before drawing, a model whose fp32 training
    state (16 bytes a parameter: the parameter, its gradient and AdamW's two
    moments) exceeds the card's memory: a pure function of the config and
    a memory size. At 80 GB gemma2-27b's 27.2 B parameters (435.6 GB)
    are refused, granite-3-2b's 2.53 B (40.5 GB) are not; a card one byte
    short of a model's state refuses it, one of exactly its size takes
    it."""
    from repro_torch.launch import train
    from repro_torch.roofline.hardware import HBM_BYTES
    cfg = get_config(arch)
    need = 16 * cfg.param_count()
    why = train.training_state_refusal(cfg, HBM_BYTES)
    assert (why is None) == fits
    if not fits:
        assert f"{need / 1e9:.1f} GB of fp32 training state" in why
        assert f"{HBM_BYTES / 1e9:.1f} GB" in why and cfg.name in why
    assert train.training_state_refusal(cfg, need) is None
    assert train.training_state_refusal(cfg, need - 1) is not None
    assert train.training_state_refusal(
        reduced_config(cfg), 2 ** 30) is None


def test_train_launcher_refuses_before_drawing_on_the_card(monkeypatch):
    """On the card the refusal comes before any weight is drawn: the
    launcher exits with the reason and never builds a trainer."""
    from repro_torch.launch import train
    from repro_torch.runtime import trainer as trainer_mod
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: type("P", (), {
                            "total_memory": 80 * 10 ** 9})())
    import repro_torch.models as models
    build = models.build_model

    def on_cuda(cfg, device="cuda"):
        model = build(cfg, device="cpu")
        model.device = torch.device("cuda")
        return model
    monkeypatch.setattr(models, "build_model", on_cuda)
    monkeypatch.setattr(trainer_mod.ElasticTrainer, "__init__",
                        lambda *a, **k: pytest.fail("a trainer was built"))
    with pytest.raises(SystemExit, match="gemma2-27b: 435.6 GB of fp32 "
                                         "training state"):
        train.main(["--arch", "gemma2-27b", "--no-reduced"])


def test_train_launcher_runs_elastic_on_cpu_slices(capsys):
    """--devices 4 --slices 2 --elastic on the CPU: four virtual slices of
    the CPU, a LocalRMS of four nodes that expands the job from 2 to 4
    slices at its first reconfiguration point."""
    from repro_torch.launch import train
    assert train.main(["--device", "cpu", "--devices", "4", "--slices", "2",
                       "--elastic", "--steps", "4", "--reduced",
                       "--global-batch", "8", "--seq-len", "16"]) == 0
    out = capsys.readouterr().out
    first = out.splitlines()[0]
    assert "4 virtual slices of one device (cpu)" in first, first
    assert "step     4 loss" in out and "slices 4" in out
    assert "'action': 'EXPAND', 'from': 2, 'to': 4" in out
