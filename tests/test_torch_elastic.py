"""The port's elastic machinery against the JAX reference, on the CPU: the
Listing-3 plans and their cost model, the sharding rules and the ZeRO-1
layout, resharding and slice migration (twins of tests/test_multidevice.py),
the trainer over 1, 2 and 4 slices, an expand mid-run, and the slice as a
whole: the reference's elastic run and the port's from one state.

The port runs in-process on virtual CPU slices (``slice_devices(n,
"cpu")``); where the reference needs several devices it runs in a
subprocess with 8 forced host devices, as tests/test_multidevice.py does.
"""
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.core import redistribute as jax_redistribute  # noqa: E402
from repro.core.sharding import FSDP_RULES as JAX_FSDP  # noqa: E402
from repro.core.sharding import TP_DP_RULES as JAX_RULES  # noqa: E402
from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data import SyntheticLMData as JaxData  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import reduced_config as jax_reduced_config  # noqa: E402
from repro.optim import init_state as jax_init_state  # noqa: E402
from repro.optim.adamw import zero1_logical as jax_zero1  # noqa: E402
from repro_torch.bridge import state_from_jax  # noqa: E402
from repro_torch.core import (Action, Decision, NamedSharding,  # noqa: E402
                              PartitionSpec as P, FSDP_RULES, TP_DP_RULES,
                              expand_plan,
                              gather, make_mesh, mesh_model_ways,
                              mesh_num_slices, migrate_slice, ownership_map,
                              place, plan_stats, reshard, resized_mesh,
                              shrink_plan, slice_devices, slice_of_rank,
                              transfer_time_s)
from repro_torch.core.sharding import distinct_blocks  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.models import ModelConfig, build_model  # noqa: E402
from repro_torch.models.layers import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import AdamWConfig, zero1_logical  # noqa: E402
from repro_torch.prng import fold_in, prng_key, threefry2x32  # noqa: E402
from repro_torch.runtime import ElasticTrainer, TrainerConfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = slice_devices(8, "cpu")


@pytest.fixture(autouse=True)
def one_thread():
    """The tier-1 run shares the machine's cores among its workers: these
    many small ops run on one thread each, not on every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def smollm_fp32():
    """The reference's reduced smollm in fp32, and the port's copy."""
    cfg = dataclasses.replace(jax_reduced_config(jax_get_model(
        "smollm-135m")[1]), dtype="float32")
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


def init_params(cfg):
    """The reference's init of ``cfg``'s layers drawn as smollm-135m's 30
    are drawn (a cut draw is chaotic; tests/test_torch_train.py)."""
    deep = jax_build_model(dataclasses.replace(cfg, num_layers=30)).init(
        jax.random.PRNGKey(3))
    reps = cfg.pattern_repeats[0]
    return {k: jax.tree.map(lambda a: a[:reps], v) if k == "blocks" else v
            for k, v in deep.items()}


class ScriptedRMS:
    """Answers the n-th reconfiguration request from ``script``."""

    def __init__(self, script):
        self.script = dict(script)
        self.calls = 0

    def request_reconfig(self, job_id, *, current, minimum, maximum,
                         factor, preferred):
        self.calls += 1
        return self.script.get(self.calls,
                               Decision(Action.NO_ACTION, current))

    def confirm_resize(self, job_id, decision, timeout_s):
        return True, 0.0


class FedBatches:
    """Replays the reference stream's batches as tensors."""

    def __init__(self, source):
        self.source = source

    def batch(self, step):
        return {k: torch.from_numpy(np.array(v))
                for k, v in self.source.batch(step).items()}


# -- plans, cost model, rules ------------------------------------------------------


@pytest.mark.parametrize("p,q", [(1, 2), (2, 4), (2, 8), (4, 2), (8, 2),
                                 (8, 1), (3, 6), (6, 3), (4, 4)])
def test_plans_and_cost_model_match_reference(p, q):
    for nbytes in (0, 1000, 1 << 30, 12345678):
        if q >= p:
            got, want = expand_plan(p, q, nbytes), \
                jax_redistribute.expand_plan(p, q, nbytes)
        else:
            got, want = shrink_plan(p, q, nbytes), \
                jax_redistribute.shrink_plan(p, q, nbytes)
        assert [dataclasses.astuple(t) for t in got] == \
            [dataclasses.astuple(t) for t in want]
        assert plan_stats(got) == jax_redistribute.plan_stats(want)
        for bw, lat, sync in ((1e9, 0.0, 0.0), (2.5e10, 1e-4, 3e-3)):
            assert transfer_time_s(got, link_bw=bw, latency_s=lat,
                                   sync_s_per_participant=sync) == \
                jax_redistribute.transfer_time_s(
                    want, link_bw=bw, latency_s=lat,
                    sync_s_per_participant=sync)


def test_plans_refuse_sizes_without_a_factor():
    for p, q in ((2, 3), (4, 6)):
        with pytest.raises(ValueError):
            expand_plan(p, q, 8)
        with pytest.raises(ValueError):
            jax_redistribute.expand_plan(p, q, 8)


def smollm_specs():
    _, pcfg = smollm_fp32()
    model = build_model(pcfg, device="cpu")
    return [(s.logical, s.shape) for s in tree_leaves(model.specs())]


@pytest.mark.parametrize("data", range(1, 9))
def test_spec_for_and_zero1_match_reference(data):
    """The reference reads only ``mesh.shape``: an AbstractMesh stands in
    for its devices."""
    shapes = smollm_specs() + [
        (("layers", "embed", "mlp"), (30, 576, 1536)),
        (("vocab", "embed"), (49152, 576)),
        (("embed", "heads", "head_dim"), (576, 9, 64)),
        (("batch", "seq"), (8, 2048)), (("embed",), (7,)), ((), ())]
    for model_ways in (1, 2):
        mesh = make_mesh(data, model_ways, devices=["cpu"] * 16)
        jmesh = AbstractMesh((data, model_ways), ("data", "model"))
        for logical, shape in shapes:
            assert tuple(TP_DP_RULES.spec_for(logical, shape, mesh)) == \
                tuple(JAX_RULES.spec_for(logical, shape, jmesh))
            assert zero1_logical(logical, shape, mesh, TP_DP_RULES) == \
                jax_zero1(logical, shape, jmesh, JAX_RULES)


def test_fold_in_matches_jax_on_64_keys():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2 ** 32, (64, 2), dtype=np.uint64)
    for k0, k1 in keys:
        key = torch.tensor([int(k0), int(k1)]).to(torch.uint32)
        want = jax.random.fold_in(jnp.array([k0, k1], jnp.uint32), 0)
        np.testing.assert_array_equal(fold_in(key, 0).numpy(),
                                      np.asarray(want))
    # the card's path: the same hash in int64 tensor ops
    k = torch.from_numpy(keys.astype(np.int64))
    y0, y1 = threefry2x32(k[:, 0], k[:, 1], 0, 0)
    want = np.stack([np.asarray(jax.random.fold_in(
        jnp.array(key, jnp.uint32), 0)) for key in keys])
    np.testing.assert_array_equal(torch.stack([y0, y1], 1).numpy(), want)
    for seed in (0, 1, 7, 2 ** 31 + 5):
        np.testing.assert_array_equal(prng_key(seed).numpy(),
                                      np.asarray(jax.random.PRNGKey(seed)))


def test_meshes_nest_and_resize_by_prefix():
    """make_mesh takes a prefix of the devices, so meshes of 2 and 4 slices
    share their first slices; resized_mesh keeps the pod axis while it
    divides; slice_of_rank names a mesh entry's slice by its position."""
    devs = [torch.device("cpu")] * 8
    m = make_mesh(2, 2, pod=2, devices=devs)
    assert m.shape == {"pod": 2, "data": 2, "model": 2}
    assert mesh_num_slices(m) == 4 and mesh_model_ways(m) == 2
    assert resized_mesh(m, 2, devices=devs).shape == \
        {"pod": 2, "data": 1, "model": 2}
    assert resized_mesh(m, 3, devices=devs).shape == {"data": 3, "model": 2}
    assert [slice_of_rank(m, r) for r in range(8)] == [0, 0, 1, 1, 2, 2,
                                                       3, 3]
    assert len(m.coords()) == 8 and m.coords()[3] == (0, 1, 1)
    with pytest.raises(ValueError, match="need 9 devices"):
        make_mesh(9, 1, devices=devs)


def test_resized_mesh_places_slices_by_listing_3():
    """Expanding by f puts new slice r*f on old slice r's devices and the
    others on fresh ones; shrinking keeps old slice r*f's as new slice r;
    with the model axis a slice's devices move as one row."""
    m2 = make_mesh(2, 1, devices=CPU8)
    m4 = resized_mesh(m2, 4, devices=CPU8)
    assert m4.ids.ravel().tolist() == [0, 2, 1, 3]
    assert resized_mesh(m4, 2, devices=CPU8).ids.ravel().tolist() == [0, 1]
    assert resized_mesh(m2, 8, devices=CPU8).ids.ravel().tolist() == \
        [0, 2, 3, 4, 1, 5, 6, 7]
    assert resized_mesh(m2, 3, devices=CPU8).ids.ravel().tolist() == \
        [0, 1, 2]
    tp = resized_mesh(make_mesh(2, 2, devices=CPU8), 4, devices=CPU8)
    assert tp.ids.tolist() == [[0, 1], [4, 5], [2, 3], [6, 7]]
    with pytest.raises(ValueError, match="need 16 devices"):
        resized_mesh(m2, 16, devices=CPU8)


@pytest.mark.parametrize("spec", [P("data"), P()])
def test_reshard_keeps_a_block_only_on_its_own_device_id(spec):
    """One rule on any mesh: a block stays in place where the old entry
    with the new entry's device id holds it whole. On resized_mesh's
    placement those are the plan's local transfers (new slices 0 and 2 of
    an expand 2 -> 4); on a prefix mesh (ids 0-3) a row block stays only on
    slice 0 and a replica on slices 0 and 1."""
    x = torch.arange(64.0).reshape(8, 8)
    m2 = make_mesh(2, 1, devices=CPU8)
    x2 = place(x, NamedSharding(m2, spec))
    for m4, kept in ((resized_mesh(m2, 4, devices=CPU8), {0, 2}),
                     (make_mesh(4, 1, devices=CPU8),
                      {0} if spec else {0, 1})):
        transfers = []
        x4 = reshard(x2, NamedSharding(m4, spec), transfers=transfers)
        assert torch.equal(gather(x4), x)
        views = {c[0] for c, t in x4.shards.items()
                 if any(storage(t) == storage(o) for o in x2.shards.values())}
        assert views == kept == {t.dst for t in transfers if t.local}
        if m4.ids.ravel().tolist() == [0, 2, 1, 3]:
            assert sorted((t.src, t.dst) for t in transfers) == sorted(
                (t.src, t.dst) for t in expand_plan(2, 4, 0))


@pytest.mark.parametrize("p,q", [(32, 64), (64, 32)])
def test_reshard_walk_stops_once_a_block_is_covered(monkeypatch, p, q):
    """Resizing a row-sharded leaf between 32 and 64 virtual slices tests
    each new block against its own device's old block and its plan's
    sources, then stops: a few box tests per new slice, not one per old
    slice (p q = 2048). The values and the transfers are the plan's, as
    the full walk gave them."""
    reshard_mod = importlib.import_module("repro_torch.core.reshard")
    tests = []

    def counted(a, b, real=reshard_mod._intersect):
        tests.append(1)
        return real(a, b)
    monkeypatch.setattr(reshard_mod, "_intersect", counted)
    # the walk runs once per geometry: count a walk compiled afresh
    reshard_mod.PROGRAMS.clear()
    cpu64 = slice_devices(64, "cpu")
    x = torch.arange(128.0 * 3).reshape(128, 3)
    mp = make_mesh(p, 1, devices=cpu64)
    xp = place(x, NamedSharding(mp, P("data")))
    mq = resized_mesh(mp, q, devices=cpu64)
    transfers = []
    xq = reshard(xp, NamedSharding(mq, P("data")), transfers=transfers)
    assert torch.equal(gather(xq), x)
    plan = expand_plan(p, q, 0) if q > p else shrink_plan(p, q, 0)
    assert sorted((t.src, t.dst) for t in transfers) == sorted(
        (t.src, t.dst) for t in plan)
    # local where the new slice sits on its source's device id
    assert all(t.local == (mp.id((t.src, 0)) == mq.id((t.dst, 0)))
               for t in transfers)
    assert sum(t.nbytes for t in transfers) == x.numel() * 4
    assert len(tests) <= 3 * q < p * q


# -- twins of tests/test_multidevice.py:34-83 ----------------------------------------


def test_reshard_expand_preserves_values_and_layout():
    x = torch.arange(64.0).reshape(8, 8)
    m2, m4 = make_mesh(2, 1, devices=CPU8), make_mesh(4, 1, devices=CPU8)
    x2 = place(x, NamedSharding(m2, P("data")))
    x4 = reshard(x2, NamedSharding(m4, P("data")))
    own = ownership_map(x4)
    # Listing 3 expand: old rank r's rows split between new ranks 2r, 2r+1
    starts = sorted(idx[0].start or 0 for idx in own.values())
    assert torch.equal(gather(x4), x) and len(own) == 4
    assert starts == [0, 2, 4, 6]


def test_reshard_shrink_and_roundtrip():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((16, 4)))
    m8, m2 = make_mesh(8, 1, devices=CPU8), make_mesh(2, 1, devices=CPU8)
    x8 = place(x, NamedSharding(m8, P("data")))
    x2 = reshard(x8, NamedSharding(m2, P("data")))
    back = reshard(x2, NamedSharding(m8, P("data")))
    assert np.allclose(gather(x2).numpy(), x.numpy())
    assert np.allclose(gather(back).numpy(), x.numpy())


def test_migrate_slice_swaps_shards():
    m = make_mesh(4, 1, devices=CPU8)
    x = torch.arange(4.0)[:, None].repeat(1, 3)   # row i = i
    xs = place(x, NamedSharding(m, P("data")))
    y = migrate_slice(xs, m, 0, 2)
    assert gather(y)[:, 0].tolist() == [2.0, 1.0, 0.0, 3.0]
    # the swapped blocks are new buffers, the others stay
    assert y.shards[(1, 0)] is xs.shards[(1, 0)]
    assert y.shards[(0, 0)].data_ptr() != xs.shards[(2, 0)].data_ptr()


# -- a TrainState -----------------------------------------------------------------


def boxes(spec, shape, mesh):
    """The block of each mesh coordinate under a PartitionSpec, as the
    reference lays it out: a dimension split over mesh axes is cut in
    their product, the first axis outermost."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = {}
    for c in mesh.coords():
        box = []
        for dim, part in zip(shape, spec):
            axes = () if part is None else (
                (part,) if isinstance(part, str) else tuple(part))
            n, k = 1, 0
            for ax in axes:
                n *= mesh.shape[ax]
                k = k * mesh.shape[ax] + c[mesh.axis_names.index(ax)]
            box.append((k * dim // n, (k + 1) * dim // n))
        out[c] = tuple(box)
    return out


@pytest.mark.parametrize("slices", [2, 4])
def test_fsdp_blocks_match_reference_spec_for(slices):
    """Under FSDP_RULES the trainer's TrainState holds each parameter's and
    each moment's blocks where the reference's ``spec_for`` (and ZeRO-1
    layout) puts them on a mesh of that many slices: every weight's embed
    axis split over the data slices (ln1, ln2, final_norm, wo's and
    w_down's last axis included), the embedding table (table_embed) not."""
    _, pcfg = smollm_fp32()
    model = build_model(pcfg, device="cpu")
    tr = ElasticTrainer(model, AdamWConfig(), DataConfig(
        vocab_size=pcfg.vocab_size, seq_len=8, global_batch=8),
        TrainerConfig(max_slices=slices, rules=FSDP_RULES),
        devices=CPU8[:slices])
    state = tr.init_state(seed=0)
    jmesh = AbstractMesh((slices, 1), ("data", "model"))
    split = 0
    for logical, p, mu in zip(tree_leaves(model.logical()),
                              tree_leaves(state["params"]),
                              tree_leaves(state["opt"]["mu"])):
        shape = tuple(p.shape)
        want = JAX_FSDP.spec_for(logical, shape, jmesh)
        mom = JAX_FSDP.spec_for(jax_zero1(logical, shape, jmesh, JAX_FSDP),
                                shape, jmesh)
        for arr, spec in ((p, want), (mu, mom)):
            got = {c: tuple((s.start, s.stop) for s in arr.index(c))
                   for c in arr.shards}
            assert got == boxes(spec, shape, tr.mesh), (logical, spec)
            assert all(tuple(t.shape) == tuple(b - a for a, b in got[c])
                       for c, t in arr.shards.items())
        assert ("data" in tuple(want)) == ("embed" in logical), logical
        split += "embed" in logical
    assert split == len(tree_leaves(state["params"])) - 1  # all but the table


@pytest.mark.parametrize("slices", [1, 2, 4])
def test_fsdp_step_matches_replicated(slices):
    """Two steps from one state under FSDP_RULES and under TP_DP_RULES:
    the same losses, gradient norms and every leaf of the new TrainState,
    bit for bit (each slice runs on the same whole parameters, gathered
    from its blocks, and the gradients are summed in the same order)."""
    _, pcfg = smollm_fp32()
    data = DataConfig(vocab_size=pcfg.vocab_size, seq_len=32, global_batch=8)
    runs = {}
    for name, rules in (("tp_dp", TP_DP_RULES), ("fsdp", FSDP_RULES)):
        tr = ElasticTrainer(build_model(pcfg, device="cpu"),
                            AdamWConfig(lr=1e-3, warmup_steps=0,
                                        total_steps=10),
                            data, TrainerConfig(steps=2, log_period=1,
                                                max_slices=slices,
                                                rules=rules),
                            devices=CPU8[:slices])
        state = tr.train(seed=0)
        runs[name] = (tr.metrics, state)
    (m0, s0), (m1, s1) = runs["tp_dp"], runs["fsdp"]
    assert [(m["loss"], m["grad_norm"]) for m in m0] == \
        [(m["loss"], m["grad_norm"]) for m in m1]
    if slices > 1:
        wq = s1["params"]["blocks"]["p0"]["attn"]["wq"]
        assert len(distinct_blocks(wq)) == slices
    for a, b in zip(tree_leaves(s0), tree_leaves(s1)):
        assert torch.equal(gather(a), gather(b))


def test_fsdp_train_state_reshards_2_4_2():
    """An FSDP TrainState (parameters in blocks, random moments) expands
    2 -> 4 slices and shrinks back, every leaf equal; at 4 slices each
    slice holds a quarter of every embed-split parameter. Training goes on
    at 4 slices from the resharded state as from the same state placed
    there."""
    _, pcfg = smollm_fp32()
    data = DataConfig(vocab_size=pcfg.vocab_size, seq_len=16, global_batch=8)

    def trainer(slices):
        return ElasticTrainer(build_model(pcfg, device="cpu"),
                              AdamWConfig(lr=1e-3, warmup_steps=0,
                                          total_steps=10),
                              data, TrainerConfig(steps=1, max_slices=4,
                                                  rules=FSDP_RULES,
                                                  log_period=1),
                              devices=CPU8[:4], slices=slices)
    tr = trainer(2)
    state = tr.init_state(seed=0)
    state["opt"]["nu"] = tree_map(lambda x: x.map(
        lambda t: torch.rand(t.shape)), state["opt"]["nu"])
    want = tree_map(gather, state)
    m4 = resized_mesh(tr.mesh, 4, devices=CPU8[:4])
    s4 = reshard(state, tr._state_shardings(m4))
    s2 = reshard(s4, tr._state_shardings(tr.mesh))
    for w, a, b in zip(tree_leaves(want), tree_leaves(s4), tree_leaves(s2)):
        assert torch.equal(gather(a), w) and torch.equal(gather(b), w)
    wo = s4["params"]["blocks"]["p0"]["attn"]["wo"]
    assert [t.shape[-1] for t in wo.shards.values()] == \
        [wo.shape[-1] // 4] * 4
    four = trainer(4)
    four.mesh = m4
    resumed = four.train(state=s4)
    placed = trainer(4).train(state=want)
    for a, b in zip(tree_leaves(resumed), tree_leaves(placed)):
        assert torch.equal(gather(a), gather(b))


def storage(t):
    s = t.untyped_storage()
    return s.data_ptr(), s.data_ptr() + s.nbytes()


def test_reshard_train_state_expand_and_shrink():
    """A smollm TrainState (ZeRO-1 moments, replicated params, rng, step)
    expands 2 -> 4 and shrinks back: every leaf equal; a block stays in
    place (a view of its old buffer) exactly where the plan marks the
    transfer local, as resized_mesh puts those on their sources' device
    ids; every other block is a buffer of its own."""
    _, pcfg = smollm_fp32()
    model = build_model(pcfg, device="cpu")
    tr = ElasticTrainer(model, AdamWConfig(), DataConfig(
        vocab_size=pcfg.vocab_size, seq_len=8, global_batch=8),
        TrainerConfig(max_slices=4), devices=CPU8[:4], slices=2)
    state = tr.init_state(seed=0)
    state["opt"]["mu"] = tree_map(lambda x: x.map(
        lambda t: torch.randn(t.shape)), state["opt"]["mu"])
    want = tree_map(gather, state)
    m4 = resized_mesh(tr.mesh, 4, devices=CPU8[:4])
    transfers = []
    s4 = reshard(state, tr._state_shardings(m4), transfers=transfers)
    for old, new in zip(tree_leaves(state), tree_leaves(s4)):
        kept = {c for c in new.shards
                if any(storage(new.shards[c]) == storage(o)
                       for o in old.shards.values())}
        # new slices 0 and 2 take old slices 0 and 1 locally
        assert kept == {(0, 0), (2, 0)}
        for c, t in new.shards.items():
            if c not in kept:
                assert not any(storage(t)[0] < storage(o)[1] and
                               storage(o)[0] < storage(t)[1]
                               for o in old.shards.values())
    assert sum(not t.local for t in transfers) == \
        2 * len(tree_leaves(state))
    s2 = reshard(s4, tr._state_shardings(tr.mesh))
    for path_want, got4, got2 in zip(tree_leaves(want), tree_leaves(s4),
                                     tree_leaves(s2)):
        assert torch.equal(gather(got4), path_want)
        assert torch.equal(gather(got2), path_want)
    # ZeRO-1: the moments of every leaf with a dimension 2 divides are
    # cut in two, the parameters are whole on each slice
    for mu in tree_leaves(state["opt"]["mu"]):
        assert len(distinct_blocks(mu)) == 2, mu
    for p in tree_leaves(state["params"]):
        assert len(distinct_blocks(p)) == 1


def run_slices(slices, steps=3, accum=1):
    _, pcfg = smollm_fp32()
    data = DataConfig(vocab_size=pcfg.vocab_size, seq_len=32, global_batch=8)
    tr = ElasticTrainer(build_model(pcfg, device="cpu"),
                        AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10),
                        data, TrainerConfig(steps=steps, log_period=1,
                                            max_slices=slices,
                                            grad_accum=accum),
                        devices=CPU8[:slices])
    state = tr.train()
    return [m["loss"] for m in tr.metrics], state


def test_train_step_at_1_2_and_4_slices_agrees():
    """One batch stream at 1, 2 and 4 slices (and 2 slices of 2
    micro-batches): the same losses, within the tolerance of
    tests/test_trainer.py::test_grad_accum_equivalence."""
    l1, s1 = run_slices(1)
    for slices, accum in ((2, 1), (4, 1), (2, 2)):
        got, s = run_slices(slices, accum=accum)
        assert max(abs(a - b) for a, b in zip(l1, got)) < 5e-3, (slices, got)
        assert torch.equal(gather(s["rng"]), gather(s1["rng"]))
        assert int(s["step"]) == 3


def test_elastic_training_expand_matches_fixed():
    """A job that expands 2->4 slices mid-run computes the same losses as
    one that never resizes (tests/test_multidevice.py:87-140)."""
    _, pcfg = smollm_fp32()
    model = build_model(pcfg, device="cpu")
    data = DataConfig(vocab_size=pcfg.vocab_size, seq_len=32, global_batch=8)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=30)

    def run(rms, slices):
        tr = ElasticTrainer(model, opt, data,
                            TrainerConfig(steps=20, model_ways=1,
                                          max_slices=4, check_period=5,
                                          log_period=5),
                            rms=rms, devices=CPU8, slices=slices)
        tr.train()
        return [m["loss"] for m in tr.metrics], tr.resize_log

    base_losses, _ = run(None, 4)
    el_losses, resizes = run(ScriptedRMS({1: Decision(Action.EXPAND, 4)}),
                             2)
    diffs = [abs(a - b) for a, b in zip(base_losses, el_losses)]
    assert len(resizes) == 1 and resizes[0]["to"] == 4
    assert max(diffs) < 0.05


# -- the slice as a whole against JAX --------------------------------------------

REFERENCE_RUN = """
import dataclasses, json, sys
import jax, numpy as np
from repro.core import Action, Decision, make_mesh, sharding
from repro.data import DataConfig
from repro.models import build_model, get_model, reduced_config
from repro.optim import AdamWConfig, init_state
from repro.runtime import ElasticTrainer, TrainerConfig


class ScriptedRMS:
    def __init__(self, script):
        self.script, self.calls = dict(script), 0

    def request_reconfig(self, job_id, *, current, minimum, maximum,
                         factor, preferred):
        self.calls += 1
        return self.script.get(self.calls,
                               Decision(Action.NO_ACTION, current))

    def confirm_resize(self, job_id, decision, timeout_s):
        return True, 0.0


cfg = dataclasses.replace(reduced_config(get_model("smollm-135m")[1]),
                          dtype="float32")
deep = build_model(dataclasses.replace(cfg, num_layers=30)).init(
    jax.random.PRNGKey(3))
reps = cfg.pattern_repeats[0]
params = {k: jax.tree.map(lambda a: a[:reps], v) if k == "blocks" else v
          for k, v in deep.items()}
tr = ElasticTrainer(build_model(cfg), AdamWConfig(**OPT),
                    DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                               global_batch=8),
                    TrainerConfig(**TCFG, rules=getattr(sharding, RULES)),
                    rms=ScriptedRMS({1: Decision(Action.EXPAND, 4)}))
tr.slices = 2
tr.mesh = make_mesh(2, 1)
tr.dmr.current_slices = 2
state = tr.init_state(seed=0)
state["params"] = params
state["opt"] = init_state(params)
state = jax.device_put(state, tr._state_shardings(tr.mesh))
out = tr.train(state=state)
print(json.dumps({"metrics": tr.metrics,
                  "resizes": [(r["action"], r["from"], r["to"])
                              for r in tr.resize_log],
                  "rng": np.asarray(out["rng"]).tolist()}))
"""


@pytest.mark.parametrize("rules", ["TP_DP_RULES", "FSDP_RULES"])
def test_elastic_run_reproduces_reference(rules):
    """The reference's elastic run (2 slices, an EXPAND to 4 at the first
    reconfiguration point, 5 fp32 steps) and the port's, from the same
    bridged state and the reference's batches, both under ``rules`` (the
    parameters replicated, or in blocks over the data slices): the same
    losses, lr and gradient norms to 1e-4 (relative, the tolerance of
    test_trainer_reproduces_reference_losses), the same slice counts and
    the same rng key at the end."""
    opt = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    tcfg = dict(steps=5, model_ways=1, max_slices=4, check_period=2,
                log_period=1)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    code = (f"OPT = {opt!r}\nTCFG = {tcfg!r}\nRULES = {rules!r}\n"
            + textwrap.dedent(REFERENCE_RUN))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])

    cfg, pcfg = smollm_fp32()
    params = init_params(cfg)
    start = {"params": params, "opt": jax_init_state(params),
             "rng": jax.random.PRNGKey(1), "step": jnp.int32(0)}
    data = JaxData(JaxDataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                 global_batch=8))
    port = ElasticTrainer(build_model(pcfg, device="cpu"), AdamWConfig(**opt),
                          FedBatches(data),
                          TrainerConfig(**tcfg, rules={
                              "TP_DP_RULES": TP_DP_RULES,
                              "FSDP_RULES": FSDP_RULES}[rules]),
                          rms=ScriptedRMS({1: Decision(Action.EXPAND, 4)}),
                          devices=CPU8, slices=2)
    out = port.train(state=state_from_jax(
        jax.tree.map(np.array, start), device="cpu",
        shardings=port._state_shardings(port.mesh)))
    assert ref["resizes"] == [["EXPAND", 2, 4]]
    assert [(r["action"], r["from"], r["to"]) for r in port.resize_log] == \
        [("EXPAND", 2, 4)]
    assert [m["slices"] for m in port.metrics] == \
        [m["slices"] for m in ref["metrics"]] == [2, 2, 4, 4, 4]
    for got, want in zip(port.metrics, ref["metrics"]):
        assert got["step"] == want["step"]
        for key in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4)
    assert gather(out["rng"]).tolist() == ref["rng"]
