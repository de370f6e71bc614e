"""The port's dry-run and roofline tooling against the reference, on the CPU.

``repro_torch.launch.cells`` against ``repro.launch.cells`` (which only
builds abstract values here, on a 1 x 1 mesh): which (arch, shape) cells
apply, their tokens and model FLOPs, the rule tables they choose, and the
train step itself on CPU tensors against the reference cell's jitted
``train_step``. Then the counts on the meta device
(``repro_torch.roofline.count``) against hand counts: the products' FLOPs,
remat's recompute, the kernel ops' formulas (``kernels/work.py``, which
``kernels/bench.py`` bounds with), the live storage the kernels' wrappers
allocate; and the command line, at reduced configs. Nothing here builds or
launches a kernel.
"""
import dataclasses
import json
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import sharding as jax_sharding  # noqa: E402
from repro.launch import cells as jax_cells  # noqa: E402
from repro.launch import shapes as jax_shapes  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import reduced_config as jax_reduced_config  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro_torch.bridge import state_from_jax  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.core import Mesh, make_mesh, sharding  # noqa: E402
from repro_torch.kernels import bench, build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.ssd import kernel as ssd  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.launch import cells, dryrun, perf_iterate, shapes  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import build_model, reduced_config  # noqa: E402
from repro_torch.models.layers import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.roofline import report  # noqa: E402
from repro_torch.roofline.analysis import roofline_terms  # noqa: E402
from repro_torch.roofline.count import count_step  # noqa: E402

# the reference's dry-run meshes' axes are Auto (its cells pin shardings
# with with_sharding_constraint)
JAX_MESH = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def names(module):
    """Each rule table of a sharding module, by its name."""
    return {name: getattr(module, name) for name in
            ("TP_DP_RULES", "FSDP_RULES", "LONG_CONTEXT_RULES")}


def which(rules, module) -> str:
    return next(name for name, table in names(module).items()
                if table == rules)


# -- the cells against the reference's -----------------------------------------


MESH_NAMES = ("h100x1", "h100x8_m8", "h100x8_m4")


@pytest.mark.parametrize("arch", list_archs())
def test_cells_apply_count_tokens_and_model_flops_as_the_reference(arch):
    """For each of the 40 (arch, shape) cells, on one card and on the node
    layouts with a model axis: applicability and its reason, tokens and
    model FLOPs (6 or 2 x active parameters x tokens) equal the reference
    cell's."""
    assert list(shapes.SHAPES) == list(jax_shapes.SHAPES)
    for shape in shapes.SHAPES:
        assert dataclasses.asdict(shapes.SHAPES[shape]) == \
            dataclasses.asdict(jax_shapes.SHAPES[shape])
        ok, why = shapes.applicable(arch, shape)
        assert (ok, why) == jax_shapes.applicable(arch, shape)
        if not ok:
            with pytest.raises(ValueError) as theirs:
                jax_cells.build_cell(arch, shape, JAX_MESH)
            for name in MESH_NAMES:
                with pytest.raises(ValueError) as ours:
                    cells.build_cell(arch, shape, make_production_mesh(name))
                assert str(ours.value) == str(theirs.value)
            continue
        want = jax_cells.build_cell(arch, shape, JAX_MESH)
        for name in MESH_NAMES:
            got = cells.build_cell(arch, shape, make_production_mesh(name))
            assert got.tokens == want.tokens
            assert got.model_flops == pytest.approx(want.model_flops,
                                                    rel=1e-12)
            assert got.ways == make_production_mesh(name).shape["model"]


@pytest.mark.parametrize("data", [1, 2, 8, 16, 64, 256, 512])
def test_rule_choice_matches_the_reference(data):
    """``rules_for_shape`` and ``rules_for`` pick the table the
    reference's pick, for every shape at several data sizes (both read
    only ``mesh.shape``); ``cell_config`` changes the same fields."""
    mesh = types.SimpleNamespace(shape={"data": data, "model": 1})
    for name, shape in shapes.SHAPES.items():
        mine = sharding.rules_for_shape(name, shape.global_batch, mesh)
        theirs = jax_sharding.rules_for_shape(name, shape.global_batch, mesh)
        assert which(mine, sharding) == which(theirs, jax_sharding)
        mine = cells.rules_for(shape, mesh)
        theirs = jax_cells.rules_for(jax_shapes.SHAPES[name], mesh)
        assert which(mine, sharding) == which(theirs, jax_sharding)
        for arch in list_archs():
            ours = cells.cell_config(get_config(arch), shape)
            ref = jax_cells.cell_config(jax_get_model(arch)[1],
                                        jax_shapes.SHAPES[name])
            assert (ours.attn_chunk, ours.ssd_chunk) == (ref.attn_chunk,
                                                         ref.ssd_chunk)


@pytest.mark.parametrize("model", [1, 16, 8, 4])
def test_train_rules_match_the_reference_at_its_threshold(model):
    """``train_rules`` with the threshold passed as the reference's 6e9
    bytes agrees with the reference's on every arch, on the reference's
    16 x 1 and 16 x 16 meshes and the node layouts 1 x 8 and 2 x 4; by
    default it takes 0.375 of the H100's 80 GB."""
    data = {8: 1, 4: 2}.get(model, 16)
    mesh = types.SimpleNamespace(shape={"data": data, "model": model})
    for arch in list_archs():
        mine = cells.train_rules(get_config(arch), mesh, threshold=6e9)
        theirs = jax_cells.train_rules(jax_get_model(arch)[1], mesh)
        assert which(mine, sharding) == which(theirs, jax_sharding), arch
    assert cells.FSDP_HBM_SHARE * 80e9 == pytest.approx(
        jax_cells.FSDP_BYTES_THRESHOLD / 16e9 * 80e9)
    assert cells.TRAIN_ACCUM == jax_cells.TRAIN_ACCUM


def test_node_layouts_have_a_model_axis():
    """One card, and one HGX node as 8 data slices, 1 x 8 and 2 x 4 (data
    x model), every entry the meta device; a cell takes any of them, and a
    (1, 2) layout too."""
    want = {"h100x1": (1, 1), "h100x8": (8, 1), "h100x8_m8": (1, 8),
            "h100x8_m4": (2, 4)}
    assert set(mesh_mod.MESHES) == set(want)
    for name, (data, model) in want.items():
        mesh = make_production_mesh(name)
        assert mesh.shape == {"data": data, "model": model}
        assert {d.type for d in mesh.devices.flat} == {"meta"}
    two_ways = Mesh(np.array([[torch.device("meta")] * 2], dtype=object),
                    ("data", "model"))
    cell = cells.build_cell("smollm-135m", "train_4k", two_ways)
    assert cell.ways == 2
    assert perf_iterate.variant("grad_bf16")["opt_cfg"].grad_reduce_dtype \
        == "bfloat16"


def test_model_axis_variants_are_the_references_rules():
    """``dp_only*`` cut the batch and the ZeRO-1 moments over the data and
    model axes and split nothing else over the model axis;
    ``decode_seq*`` split the cache's sequence over it and leave the heads
    whole; each variant names the reference's overrides."""
    dp, seq = perf_iterate.DP_ONLY_RULES, perf_iterate.DECODE_SEQ_RULES
    assert dp.mesh_axes_for("batch") == ("pod", "data", "model")
    assert dp.mesh_axes_for("zero1") == ("pod", "data", "model")
    for axis in ("heads", "kv_heads", "mlp", "experts", "vocab"):
        assert dp.mesh_axes_for(axis) == ()
    assert seq.mesh_axes_for("kv_seq") == ("model",)
    assert seq.mesh_axes_for("heads") == seq.mesh_axes_for("kv_heads") == ()
    assert seq.mesh_axes_for("mlp") == ("model",)
    for name in ("dp_only", "dp_only_ce", "dp_only_dots", "dp_only_dots_ce"):
        assert perf_iterate.variant(name)["rules"] == dp
    assert perf_iterate.variant("dp_only_dots_ce")["cfg_overrides"] == {
        "remat": "dots", "ce_chunk": 1024}
    assert perf_iterate.variant("decode_seq_bf16") == {
        "rules": seq, "cfg_overrides": {"param_dtype": "bfloat16"}}


@pytest.mark.parametrize("name", ["dp_only", "dp_only_ce", "dp_only_dots",
                                  "dp_only_dots_ce", "decode_seq",
                                  "decode_seq_bf16"])
def test_model_axis_variants_count_on_the_node_layouts(name, tmp_path,
                                                       capsys):
    """Each model-axis variant of ``perf_iterate`` counts a reduced cell on
    both node layouts into an ok record: ``dp_only*`` a train cell as 8
    data slices (the gradients all-reduced over the 8 cards, nothing over
    the model axis), ``decode_seq*`` a decode over each coordinate's block
    of the cache's sequence."""
    arch, shape = (("smollm-135m", "train_4k") if name.startswith("dp")
                   else ("qwen3-4b", "decode_32k"))
    for mesh in ("h100x8_m8", "h100x8_m4"):
        assert perf_iterate.main(["--arch", arch, "--shape", shape,
                                  "--variant", name, "--mesh", mesh,
                                  "--reduced", "--base", str(tmp_path),
                                  "--out", str(tmp_path)]) == 0
        rec = json.loads(dryrun.artifact_path(tmp_path, arch, shape, mesh,
                                              name).read_text())
        assert rec["status"] == "ok" and rec["chips"] == 8
        coll = rec["collectives"]
        if name.startswith("dp"):
            assert coll["all-reduce (gradients)"] > 0
            assert not any("model axis" in k for k in coll)
        else:
            assert coll["all-reduce (attention over the split cache)"] > 0
    assert name in capsys.readouterr().out


def test_chunk_variants_that_cannot_move_the_count_raise():
    """The reference's attn_chunk and ssd_chunk variants would count the
    baseline's program: the flash kernel tiles on its own and the SSD
    kernel clamps its chunk to 128 rows."""
    for name in perf_iterate.KERNEL_TILES:
        with pytest.raises(ValueError, match="baseline's program"):
            perf_iterate.variant(name)
    assert not set(perf_iterate.KERNEL_TILES) & set(perf_iterate.VARIANTS)


# -- the train step on CPU tensors against the reference cell's -------------------


def test_cell_train_step_matches_the_reference_cell():
    """The port's cell train step (the trainer's ``slice_grads`` and
    ``apply_step``; ``accum`` 2, gradients cast to bf16 per micro-batch and
    summed in fp32) on CPU tensors against the reference
    cell's jitted ``train_step`` on the same bridged state and batch, the
    moments random (a first step's zero moments make the update sign-like)
    with nu of the gradients' square's scale: the loss, the updated
    parameters and moments and the counters. The two packages sum the fp32
    gradients in another order, so a gradient element at a bf16 rounding
    boundary may round the other way in the cast; an update over a nu near
    zero would magnify that flip, which is the test's choice of moments and
    not the step's."""
    full = jax_get_model("smollm-135m")[1]
    red = dataclasses.replace(jax_reduced_config(full), dtype="float32")
    overrides = {k: v for k, v in dataclasses.asdict(red).items()
                 if getattr(full, k) != v}
    opt = dict(grad_reduce_dtype="bfloat16", warmup_steps=1)
    ref = jax_cells.build_cell("smollm-135m", "train_4k", JAX_MESH,
                               opt_cfg=JaxAdamWConfig(**opt),
                               cfg_overrides=overrides, accum=2)
    mine = cells.build_cell("smollm-135m", "train_4k",
                            make_mesh(1, 1, devices=[torch.device("cpu")]),
                            opt_cfg=AdamWConfig(**opt),
                            cfg_overrides=overrides, accum=2)
    deep = jax_build_model(dataclasses.replace(red, num_layers=30)).init(
        jax.random.PRNGKey(2))
    params = {k: jax.tree.map(lambda a: a[:2], v) if k == "blocks" else v
              for k, v in deep.items()}
    rng = np.random.default_rng(0)
    moments = [jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32) * scale), params)
        for scale in (1e-3, 1e-6)]
    moments[1] = jax.tree.map(lambda n: jnp.abs(n) + 5e-7, moments[1])
    state = {"params": params,
             "opt": {"mu": moments[0], "nu": moments[1],
                     "step": jnp.asarray(4, jnp.int32)},
             "rng": jax.random.PRNGKey(7), "step": jnp.asarray(4, jnp.int32)}
    tokens = rng.integers(0, red.vocab_size, (4, 32)).astype(np.int32)
    labels = rng.integers(0, red.vocab_size, (4, 32)).astype(np.int32)
    labels[rng.random((4, 32)) < 0.25] = -1
    with JAX_MESH:
        jstate, jmetrics = jax.jit(ref.fn)(state, {"tokens": tokens,
                                                     "labels": labels})
    np_state = jax.tree.map(np.asarray, state)
    tstate = tree_map(sharding.place, state_from_jax(np_state, device="cpu"),
                      mine.shardings)
    new, metrics = mine.fn(tstate, {"tokens": torch.from_numpy(tokens),
                                    "labels": torch.from_numpy(labels)})
    new = tree_map(sharding.gather, new)
    np.testing.assert_allclose(metrics["loss"].item(),
                               float(jmetrics["loss"]), rtol=1e-5)
    want = jax.tree.map(np.asarray, jstate)
    for key in ("params", "opt"):
        got = tree_leaves(tree_map(lambda t: t.numpy(), new[key]))
        ref_leaves = jax.tree.leaves(want[key])
        assert len(got) == len(ref_leaves)
        for g, w in zip(got, ref_leaves):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    assert int(new["step"]) == int(want["step"]) == 5
    assert np.array_equal(new["rng"].numpy(), want["rng"])


@pytest.mark.parametrize("accum,low,ways", [
    pytest.param(1, None, 1, id="1-None"),
    pytest.param(2, None, 1, id="2-None"),
    pytest.param(2, "bfloat16", 1, id="2-bfloat16"),
    pytest.param(1, None, 2, id="1-None-model2"),
    pytest.param(2, "bfloat16", 4, id="2-bfloat16-model4")])
def test_cell_train_step_is_the_trainers(accum, low, ways):
    """The cell's train step and ``ElasticTrainer.train_step`` on one CPU
    slice of ``ways`` model coordinates are one program: from the same
    state and batch (every label unmasked, where the trainer's weights by
    label count are the cell's 1/accum) the new states and the loss are
    bit-equal, with and without ``grad_reduce_dtype``, which moves the
    trainer's step as it moves the cell's."""
    from repro_torch.core import slice_devices
    from repro_torch.data import DataConfig
    from repro_torch.runtime.trainer import ElasticTrainer, TrainerConfig
    cfg = dataclasses.replace(reduced_config(get_config("smollm-135m")),
                              dtype="float32")
    overrides = {k: v for k, v in dataclasses.asdict(cfg).items()
                 if getattr(get_config("smollm-135m"), k) != v}
    devices = slice_devices(ways, "cpu")
    mesh = make_mesh(1, ways, devices=devices)
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    results = {}
    for reduce_dtype in dict.fromkeys((None, low)):
        opt = AdamWConfig(grad_reduce_dtype=reduce_dtype, warmup_steps=1)
        cell = cells.build_cell("smollm-135m",
                                shapes.ShapeSpec("cut", 16, 4, "train"), mesh,
                                opt_cfg=opt, cfg_overrides=overrides,
                                accum=accum)
        trainer = ElasticTrainer(
            build_model(cfg, device="cpu"), opt,
            DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                       global_batch=4),
            TrainerConfig(grad_accum=accum, model_ways=ways),
            devices=devices)
        state = trainer.init_state(seed=1)
        outs = [fn(state, batch) for fn in (trainer.train_step, cell.fn)]
        (a, ma), (b, mb) = [(tree_leaves(tree_map(sharding.gather, new)),
                             metrics) for new, metrics in outs]
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        assert torch.equal(ma["loss"], mb["loss"])
        results[reduce_dtype] = a
    if low is not None:
        assert not all(torch.equal(x, y)
                       for x, y in zip(results[None], results[low]))


# -- the counts on the meta device ---------------------------------------------------


def meta_model(arch, **changes):
    cfg = dataclasses.replace(reduced_config(get_config(arch)), **changes)
    model = build_model(cfg, device="meta")
    params = tree_map(lambda s: torch.empty(s.shape, device="meta"),
                      model.specs())
    return cfg, model, params


def meta_batch(b, s):
    return {k: torch.empty((b, s), dtype=torch.int32, device="meta")
            for k in ("tokens", "labels")}


def train_count(model, params, batch):
    def step(params, batch):
        leaves = tree_map(lambda p: p.requires_grad_(True), params)
        loss, _ = model.loss(leaves, batch)
        return torch.autograd.grad(loss, tree_leaves(leaves))
    return count_step(step, params, batch)[1]


def smollm_products(cfg, t):
    """(forward matrix-product FLOPs of one layer, of its MLP's down
    projection, of the tied unembedding) for ``t`` tokens: 2 M N K each."""
    e, h, kv, d, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.head_dim, cfg.d_ff)
    layer = 2 * t * (e * h * d + 2 * e * kv * d + h * d * e + 3 * e * f)
    return layer, 2 * t * f * e, 2 * t * e * cfg.vocab_size


def test_products_of_a_dense_step_are_the_hand_count():
    """A reduced smollm train step (no remat): every product three times
    (forward, and the two of its backward), 2 M N K each, and each layer's
    flash forward and backward at their formulas; nothing else counts
    FLOPs."""
    b, s = 2, 64
    cfg, model, params = meta_model("smollm-135m", remat="none")
    c = train_count(model, params, meta_batch(b, s))
    layer, _, logits = smollm_products(cfg, b * s)
    fwd, _ = bench.work.attention_work(b, cfg.num_heads, cfg.num_kv_heads, s,
                                       s, cfg.head_dim, 2)
    bwd, _ = bench.work.attention_bwd_work(b, cfg.num_heads,
                                           cfg.num_kv_heads, s, s,
                                           cfg.head_dim, 2)
    n = cfg.num_layers
    assert c.flops == 3 * (n * layer + logits) + n * (fwd + bwd)
    assert c.kernel_calls == {"repro_torch.flash_attention_fwd": n,
                              "repro_torch.flash_attention_bwd": n}


def tp_products(cfg, t, ways):
    """(train products, prefill products at the last position's logits) of
    one model coordinate of a reduced smollm at ``ways`` for ``t`` tokens:
    its H / M query heads, the one KV head whole (it does not divide), its
    d_ff / M MLP columns and V / M rows of the tied table; 2 M N K each,
    three times in a step (forward and the two of its backward)."""
    e, h, kv, d, f, v = (cfg.d_model, cfg.num_heads // ways, cfg.num_kv_heads,
                         cfg.head_dim, cfg.d_ff // ways,
                         cfg.vocab_size // ways)
    layer = 2 * t * (e * h * d + 2 * e * kv * d + h * d * e + 3 * e * f)
    return cfg.num_layers * layer, 2 * t * e * v


@pytest.mark.parametrize("data,ways", [(1, 2), (2, 4)])
def test_dense_cell_at_a_model_axis_is_the_hand_count(data, ways):
    """A reduced smollm's train and prefill cells on a (data, ways) mesh:
    one card's products and flash calls are one model coordinate's hand
    count, and the model axis's collectives, read from the step's own
    calls, are the hand count at a ring's bytes: the residual stream's
    all-reduces (the embedding's and two a layer, again in the backward),
    the gradients of the leaves every coordinate holds whole (the norms,
    the one KV head's projections), and at prefill the vocab's all-gather
    of the last position's logits."""
    b, s = 4, 64
    cfg = reduced_config(get_config("smollm-135m"))
    overrides = {k: v for k, v in dataclasses.asdict(cfg).items()
                 if getattr(get_config("smollm-135m"), k) != v}
    mesh = Mesh(np.array([[torch.device("meta")] * ways] * data,
                         dtype=object), ("data", "model"))
    rows = b // data
    ring = cells._ring(ways)
    act = rows * s * cfg.d_model * 2            # a bf16 residual stream
    h = cfg.num_heads // ways
    fwd, _ = bench.work.attention_work(rows, h, cfg.num_kv_heads, s, s,
                                       cfg.head_dim, 2)
    bwd, _ = bench.work.attention_bwd_work(rows, h, cfg.num_kv_heads, s, s,
                                           cfg.head_dim, 2)
    layers, logits = tp_products(cfg, rows * s, ways)

    cell = cells.build_cell("smollm-135m", shapes.ShapeSpec("cut", s, b,
                                                            "train"),
                            mesh, cfg_overrides=overrides, accum=1)
    _, c = count_step(cell.fn, *cell.args, ways=cell.ways)
    n = cfg.num_layers
    assert c.flops == 3 * (layers + logits) + n * (fwd + bwd)
    assert c.kernel_calls == {"repro_torch.flash_attention_fwd": n,
                              "repro_torch.flash_attention_bwd": n}
    model = build_model(cfg, device="meta")
    whole = sum(math.prod(spec.shape) for spec in tree_leaves(model.specs())
                if "model" not in sharding.TP_DP_RULES.spec_for(
                    spec.logical, spec.shape, mesh))
    assert c.collectives == {"all-reduce (model axis)": pytest.approx(
        ring * (2 * (1 + 2 * n) * act + 4 * whole), rel=1e-12)}

    cell = cells.build_cell("smollm-135m", shapes.ShapeSpec("cut", s, b,
                                                            "prefill"),
                            mesh, cfg_overrides=overrides)
    _, c = count_step(cell.fn, *cell.args, ways=cell.ways)
    assert c.flops == layers + 2 * rows * cfg.d_model * (
        cfg.vocab_size // ways) + n * fwd
    assert c.collectives == {
        "all-reduce (model axis)": pytest.approx(ring * (1 + 2 * n) * act,
                                                 rel=1e-12),
        "all-gather (model axis)": pytest.approx(
            (ways - 1) / ways * rows * cfg.vocab_size * 4, rel=1e-12)}


def test_remat_recompute_adds_one_forward():
    """"nothing_saveable" counts one forward of the stacked units more than
    "none" (less each unit's last product, whose output no backward needs:
    the recompute stops before it); "dots" keeps the products and the
    flash forward, so it counts as "none"."""
    b, s = 2, 64
    counts = {}
    for remat in ("none", "nothing_saveable", "dots"):
        cfg, model, params = meta_model("smollm-135m", remat=remat)
        counts[remat] = train_count(model, params, meta_batch(b, s))
    layer, down, _ = smollm_products(cfg, b * s)
    fwd, _ = bench.work.attention_work(b, cfg.num_heads, cfg.num_kv_heads, s,
                                       s, cfg.head_dim, 2)
    reps = cfg.pattern_repeats[0]
    assert counts["nothing_saveable"].flops - counts["none"].flops == \
        reps * (layer - down + fwd)
    assert counts["dots"].flops == counts["none"].flops
    assert counts["dots"].kernel_calls == counts["none"].kernel_calls
    assert counts["nothing_saveable"].kernel_calls[
        "repro_torch.flash_attention_fwd"] == 2 * reps


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-130m",
                                  "recurrentgemma-9b"])
def test_kernel_ops_count_what_the_bench_bounds_with(arch, monkeypatch):
    """Each kernel op's FLOPs in a reduced train step (remat on) are
    ``kernels/bench.py``'s operation counts at the op's shapes, summed over
    its calls; and the step builds, loads and launches no kernel."""
    def refuse(*_):
        raise AssertionError("the meta count built a kernel")
    monkeypatch.setattr(build, "load", refuse)
    launches = (flash.flash_attention.launches, ssd.ssd_scan.launches)
    b, s = 2, 80
    cfg, model, params = meta_model(arch, remat="nothing_saveable")
    c = train_count(model, params, meta_batch(b, s))
    bf16 = torch.bfloat16
    want = {}
    reps, tail = cfg.pattern_repeats
    kinds = list(cfg.pattern) * reps + list(cfg.pattern[:tail])
    for kind in kinds:
        if kind in ("global", "local"):
            window = cfg.sliding_window if kind == "local" else None
            args = (b, cfg.num_heads, cfg.num_kv_heads, s, s, cfg.head_dim,
                    bf16)
            for op, fn in (("flash_attention_fwd", bench.attention_bound),
                           ("flash_attention_bwd",
                            bench.attention_bwd_bound)):
                want.setdefault(op, []).append(fn(*args, window=window)[2])
        elif kind == "ssd":
            args = (b, s, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                    cfg.ssd_chunk, bf16)
            want.setdefault("ssd_scan_fwd", []).append(bench.ssd_bound(
                *args)[2])
            want.setdefault("ssd_scan_bwd", []).append(bench.ssd_bwd_bound(
                *args)[2])
        else:
            want.setdefault("rglru_scan_fwd", []).append(bench.rglru_bound(
                b, s, cfg.lru_width)[2])
            want.setdefault("rglru_scan_bwd", []).append(
                bench.rglru_bwd_bound(b, s, cfg.lru_width)[2])
    # under remat the stacked units' forwards run twice
    for op, flops in want.items():
        again = 2 if op.endswith("fwd") else 1
        total = again * sum(flops[:len(flops) - tail]) + sum(
            flops[len(flops) - tail:])
        assert c.kernel_flops[f"repro_torch.{op}"] == pytest.approx(
            total, rel=1e-12), op
    assert set(c.kernel_flops) == {f"repro_torch.{op}" for op in want}
    assert (flash.flash_attention.launches, ssd.ssd_scan.launches) == \
        launches


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_peak_memory_is_the_hand_count_of_live_storage():
    """A tiny step's peak is the bytes alive at its worst moment, the
    arguments counted from the start; a view adds nothing."""
    def step(x):
        y = x * 2                   # x, y
        z = y[:500] + 1             # x, y, z: the peak
        del y
        return z.sum()              # x, z, the sum
    _, c = count_step(step, meta(1000))
    assert c.arg_bytes == 4000
    assert c.peak_bytes == 4000 + 4000 + 2000
    assert c.bytes == (4000 + 4000) + (2000 + 2000) + (2000 + 4)


def test_kernel_wrappers_allocate_on_meta_what_they_allocate_on_the_card():
    """On meta the kernel ops allocate the CUDA path's outputs and
    workspaces (the wrappers' own code) and launch nothing: the flash
    forward's output and log-sum-exp, its backward's gradients beside the
    transient workspace, the SSD forward's y, final state and workspace."""
    b, h, kv, s, d = 2, 4, 1, 128, 64
    q, k, v = meta(b, h, s, d), meta(b, kv, s, d), meta(b, kv, s, d)
    args = q.nbytes + k.nbytes + v.nbytes
    launches = flash.flash_attention.launches
    (out, lse), c = count_step(
        lambda *t: flash_ops.flash_fwd_op(*t, True, None, None, True),
        q, k, v)
    assert out.stride() == flash.output_buffer(q).stride()
    assert c.peak_bytes == args + out.nbytes + b * h * s * 4
    do = meta(b, h, s, d)
    grads, c = count_step(
        lambda *t: flash_ops.flash_bwd_op(*t, True, None, None),
        q, k, v, out, lse, do)
    ws = 4 * flash.bwd_workspace_numel(b, h, s, d)
    held = args + out.nbytes + lse.nbytes + do.nbytes
    assert c.peak_bytes == held + sum(g.nbytes for g in grads) + ws
    assert flash.flash_attention.launches == launches
    x, dt = meta(2, 64, 4, 16), meta(2, 64, 4)
    a_log, bb, cc = meta(4), meta(2, 64, 16), meta(2, 64, 16)
    (y, h_final, work), c = count_step(
        lambda *t: ssd_ops.ssd_fwd_op(*t, 32), x, dt, a_log, bb, cc)
    assert work.numel() == ssd.workspace_numel(2, 64, 4, 16, 16, 32,
                                               torch.float32)
    assert c.peak_bytes - c.arg_bytes == y.nbytes + h_final.nbytes + \
        work.nbytes


def test_roofline_terms_against_the_h100():
    rl = roofline_terms(per_device_flops=989e12, per_device_bytes=3.35e12,
                        per_device_coll_bytes=900e9, chips=8,
                        model_flops=0.5 * 8 * 989e12)
    assert (rl.compute_s, rl.memory_s) == pytest.approx((1.0, 1.0))
    assert rl.collective_s == pytest.approx(2.0)
    assert rl.dominant == "collective" and rl.step_s == rl.collective_s
    assert rl.mfu == pytest.approx(0.25)
    assert rl.useful_ratio == pytest.approx(0.5)


# -- the command line ------------------------------------------------------------------


def test_dryrun_and_report_at_reduced_configs(tmp_path, capsys):
    """``dryrun --reduced`` counts smollm's train, prefill and decode cells
    on both meshes into ``tmp_path``; each artifact is ok with the
    reference record's fields; the report prints their rows."""
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        assert dryrun.main(["--arch", "smollm-135m", "--shape", shape,
                            "--mesh", "both", "--out", str(tmp_path),
                            "--reduced"]) == 0
    files = sorted(tmp_path.glob("*.json"))
    assert len(files) == 6
    for mesh in ("h100x1", "h100x8"):
        rows = {r["shape"]: r for r in report.load(tmp_path, mesh)
                if r["arch"] == "smollm-135m"}
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            r = rows[shape]
            assert r["status"] == "ok"
            assert {"memory", "cost", "collectives", "roofline", "tokens",
                    "fits", "rules"} <= set(r)
            assert r["roofline"]["compute_s"] > 0 and r["fits"] is True
        assert rows["long_500k"]["status"] == "skipped"
    train8 = json.loads((tmp_path / "smollm-135m__train_4k__h100x8.json")
                        .read_text())
    assert train8["collectives"]["all-reduce (gradients)"] > 0
    capsys.readouterr()
    report.main(["--art", str(tmp_path)])
    out = capsys.readouterr().out
    assert "smollm-135m,train_4k,ok,TP_DP_RULES," in out
    assert ",True," in out


def test_dryrun_counts_the_node_layouts_at_reduced_configs(tmp_path, capsys):
    """``dryrun --mesh node_m8`` and ``node_m4`` count reduced cells into
    ok records of 8 cards, one card's share with the model axis's
    collectives by kind; the report prints each kind's bytes."""
    for arch, shape in (("smollm-135m", "train_4k"),
                        ("smollm-135m", "decode_32k"),
                        ("deepseek-moe-16b", "train_4k")):
        for mesh in ("node_m8", "node_m4"):
            assert dryrun.main(["--arch", arch, "--shape", shape, "--mesh",
                                mesh, "--out", str(tmp_path),
                                "--reduced"]) == 0
    for mesh in ("h100x8_m8", "h100x8_m4"):
        rows = {(r["arch"], r["shape"]): r for r in report.load(tmp_path,
                                                                mesh)}
        train = rows[("smollm-135m", "train_4k")]
        assert train["status"] == "ok" and train["chips"] == 8
        assert train["collectives"]["all-reduce (model axis)"] > 0
        assert train["roofline"]["collective_s"] > 0
        moe_train = rows[("deepseek-moe-16b", "train_4k")]
        assert moe_train["collectives"]["all-gather (model axis)"] > 0
        assert moe_train["collectives"]["reduce-scatter (model axis)"] > 0
        assert rows[("smollm-135m", "decode_32k")]["status"] == "ok"
    m4 = rows[("deepseek-moe-16b", "train_4k")]["collectives"]
    assert m4["all-reduce (router loads)"] > 0      # 2 data slices
    capsys.readouterr()
    report.main(["--art", str(tmp_path), "--mesh", "node_m4"])
    out = capsys.readouterr().out
    assert "all-reduce (model axis)=" in out and "h100x8_m4" in out


def test_decode_seq_attends_over_each_coordinates_block():
    """Under DECODE_SEQ_RULES on the 2 x 4 layout a decode cell's cache
    arguments are each coordinate's block of the sequence (the lockstep
    decode attends over it), the blocks of the other coordinates beside it
    as a buffer, and the partial outputs' combine is counted as an
    all-reduce over the 4 coordinates."""
    arch = "qwen3-4b"
    cfg = reduced_config(get_config(arch))
    cell = cells.build_cell(arch, "decode_32k",
                            make_production_mesh("h100x8_m4"),
                            rules=perf_iterate.DECODE_SEQ_RULES,
                            cfg_overrides=dryrun.reduced_overrides(arch))
    _, cache, token, spare = cell.args
    k = cache["blocks"]["p0"]["k"]
    rows = 128 // 2
    assert tuple(k.shape) == (cfg.num_layers, rows, 32768 // 4,
                              cfg.num_kv_heads, cfg.head_dim)
    assert spare.nbytes == 3 * sum(t.nbytes for t in tree_leaves(cache))
    assert cell.collectives == {
        "all-reduce (attention over the split cache)": pytest.approx(
            cells._ring(4) * cfg.num_layers * rows * cfg.num_heads
            * (cfg.head_dim + 2) * 4, rel=1e-12)}
    _, c = count_step(cell.fn, *cell.args, ways=cell.ways)
    assert c.kernel_calls == {}


def test_moe_cell_counts_the_router_pre_pass():
    """A reduced deepseek-moe train cell on 8 data slices runs the
    trainer's routing pre-pass: one forward more a micro-batch (its flash
    forwards), and the loads' all-reduce, E fp32 values a MoE block and
    micro-batch; on one card neither."""
    arch = "deepseek-moe-16b"
    cfg = reduced_config(get_config(arch))
    over = dict(dryrun.reduced_overrides(arch), remat="none")
    calls = {}
    for name in ("h100x1", "h100x8"):
        cell = cells.build_cell(arch, "train_4k", make_production_mesh(name),
                                cfg_overrides=over, accum=2)
        _, c = count_step(cell.fn, *cell.args)
        calls[name] = c.kernel_calls["repro_torch.flash_attention_fwd"]
        routers = cfg.num_layers - cfg.first_dense_layers
        load = cell.collectives.get("all-reduce (router loads)")
        if name == "h100x1":
            assert load is None
        else:
            assert load == pytest.approx(2 * cells._ring(8) * routers
                                         * cfg.num_experts * 4)
    assert calls == {"h100x1": 2 * cfg.num_layers,
                     "h100x8": 4 * cfg.num_layers}


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-130m",
                                  "recurrentgemma-9b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_flops_are_flop_counter_modes(arch):
    """The count's FLOPs of a reduced train step under remat are
    ``FlopCounterMode``'s over the same step, kernel ops included."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg, model, params = meta_model(arch, remat="nothing_saveable")
    batch = meta_batch(2, 64)
    c = train_count(model, params, batch)
    with FlopCounterMode(display=False) as mode:
        leaves = tree_map(lambda p: p.requires_grad_(True), params)
        loss, _ = model.loss(leaves, batch)
        torch.autograd.grad(loss, tree_leaves(leaves))
    assert c.flops == mode.get_total_flops()
