"""The port's checkpoint store against the reference's, on the CPU: the
cases of tests/test_checkpoint.py, blobs that restore across the two
packages bit for bit (a bf16 leaf, a 0-d leaf, the ZSTD and RAW0 tags),
restores onto a mesh of another slice count, and the trainer's checkpoint
resume and fault path.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.checkpoint.store as jax_store  # noqa: E402
import repro_torch.checkpoint.store as port_store  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (FSDP_RULES, NamedSharding,  # noqa: E402
                              PartitionSpec as P, ShardedTensor, gather,
                              make_mesh, place, slice_devices)
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.models import build_model, reduced_config  # noqa: E402
from repro_torch.models.layers import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime import ElasticTrainer, TrainerConfig  # noqa: E402

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


@pytest.fixture
def state():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.ones((4,), dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


# -- tests/test_checkpoint.py on the port's store ----------------------------------


def test_roundtrip(tmp_path, state):
    store = CheckpointStore(tmp_path)
    store.save(7, state)
    out = store.restore(7, state)
    for a, b in zip(tree_leaves(state), tree_leaves(out)):
        assert torch.equal(a, b) and a.dtype == b.dtype and \
            a.shape == b.shape


def test_latest_and_gc(tmp_path, state):
    store = CheckpointStore(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        store.save(s, state)
    assert store.latest_step() == 4
    assert len(list(tmp_path.glob("ckpt_*"))) == 2


def test_async_save(tmp_path, state):
    store = CheckpointStore(tmp_path)
    store.save_async(5, state)
    store.wait()
    assert store.latest_step() == 5
    out = store.restore(5, state)
    assert torch.equal(out["params"]["w"], state["params"]["w"])


def test_no_partial_files_after_save(tmp_path, state):
    store = CheckpointStore(tmp_path)
    store.save(1, state)
    assert not list(tmp_path.glob("*.tmp"))


def test_elastic_restore_with_shardings(tmp_path, state):
    store = CheckpointStore(tmp_path)
    store.save(1, state)
    mesh = make_mesh(1, 1, devices=CPU8)
    sh = tree_map(lambda _: NamedSharding(mesh, P()), state)
    out = store.restore(1, state, sh)
    assert out["params"]["w"].sharding.mesh.shape["data"] == 1
    assert torch.equal(gather(out["params"]["w"]), state["params"]["w"])


# -- across the two packages ----------------------------------------------------------


def mixed_state():
    """numpy leaves of every dtype a TrainState holds: fp32, a bf16 leaf
    (ml_dtypes in the reference), a 0-d int32 step, a uint32 key."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    return {"params": {"w": w, "b": np.asarray(jnp.asarray(w[0],
                                                           jnp.bfloat16))},
            "opt": {"mu": {"w": w * 2, "b": w[1].copy()},
                    "step": np.int32(3)},
            "rng": np.asarray(jax.random.PRNGKey(5)),
            "step": np.int32(3)}


def words(x):
    """The bits of a leaf (bf16 as its 16-bit words)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().tobytes(), "bfloat16", \
                tuple(x.shape)
        return x.numpy().tobytes(), str(x.dtype).replace("torch.", ""), \
            tuple(x.shape)
    x = np.asarray(x)
    return x.tobytes(), str(x.dtype), tuple(x.shape)


def as_torch(tree):
    def one(x):
        x = np.asarray(x)
        if x.dtype.name == "bfloat16":
            return torch.from_numpy(x.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(x.copy())
    return tree_map(one, tree)


@pytest.mark.parametrize("compressed", [True, False], ids=["ZSTD", "RAW0"])
def test_reference_checkpoint_restores_in_port(tmp_path, monkeypatch,
                                               compressed):
    if not compressed:
        monkeypatch.setattr(jax_store, "zstd", None)
    host = mixed_state()
    jax_store.CheckpointStore(tmp_path).save(3, jax.tree.map(jnp.asarray,
                                                             host))
    tag = (tmp_path / "ckpt_00000003").read_bytes()[:4]
    assert tag == (b"ZSTD" if compressed else b"RAW0")
    out = CheckpointStore(tmp_path).restore(3, as_torch(host))
    assert [words(x) for x in port_store.tree_flatten(out)] == \
        [words(x) for x in jax.tree.leaves(host)]


@pytest.mark.parametrize("compressed", [True, False], ids=["ZSTD", "RAW0"])
def test_port_checkpoint_restores_in_reference(tmp_path, monkeypatch,
                                               compressed):
    if not compressed:
        monkeypatch.setattr(port_store, "zstd", None)
    host = mixed_state()
    CheckpointStore(tmp_path / "port").save(3, as_torch(host))
    jax_store.CheckpointStore(tmp_path / "ref").save(
        3, jax.tree.map(jnp.asarray, host))
    tag = (tmp_path / "port" / "ckpt_00000003").read_bytes()[:4]
    assert tag == (b"ZSTD" if compressed else b"RAW0")
    out = jax_store.CheckpointStore(tmp_path / "port").restore(3, host)
    assert [words(x) for x in jax.tree.leaves(out)] == \
        [words(x) for x in jax.tree.leaves(host)]
    # the same manifest, structure spelled as jax.tree.flatten spells it
    assert json.loads((tmp_path / "port" / "manifest.json").read_text()) \
        == json.loads((tmp_path / "ref" / "manifest.json").read_text())


def test_restore_onto_a_mesh_of_another_slice_count(tmp_path):
    """A state saved from 2 slices (ZeRO-1 moments cut in two) restores
    onto 4 slices, each block on its own."""
    x = torch.arange(48.0).reshape(8, 6)
    m2, m4 = make_mesh(2, 1, devices=CPU8), make_mesh(4, 1, devices=CPU8)
    state = {"mu": place(x, NamedSharding(m2, P("data"))),
             "w": place(x, NamedSharding(m2, P())),
             "step": place(torch.tensor(9, dtype=torch.int32),
                           NamedSharding(m2, P()))}
    store = CheckpointStore(tmp_path)
    store.save(9, state)
    sh4 = {"mu": NamedSharding(m4, P("data")), "w": NamedSharding(m4, P()),
           "step": NamedSharding(m4, P())}
    out = store.restore(9, sh4, sh4)
    assert isinstance(out["mu"], ShardedTensor)
    assert len(out["mu"].shards) == 4
    assert [tuple(t.shape) for t in out["mu"].shards.values()] == [(2, 6)] * 4
    assert torch.equal(gather(out["mu"]), x)
    assert torch.equal(gather(out["w"]), x) and int(out["step"]) == 9


# -- the trainer ----------------------------------------------------------------------


def make(tmp_path, steps, slices=1, **kw):
    cfg = reduced_config(get_config("smollm-135m"))
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=8)
    opt = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=steps)
    return ElasticTrainer(build_model(cfg, device="cpu"), opt, data,
                          TrainerConfig(steps=steps, max_slices=slices,
                                        log_period=2, ckpt_dir=str(tmp_path),
                                        **kw),
                          devices=CPU8[:slices])


def test_checkpoint_resume(tmp_path):
    """tests/test_trainer.py:34-46 on the port, saved from 2 slices and
    resumed on 4."""
    tr = make(tmp_path, steps=8, slices=2, ckpt_period=4)
    state = tr.train()
    assert tr.store.latest_step() == 8 and int(state["step"]) == 8
    tr2 = make(tmp_path, steps=10, slices=4, ckpt_period=4)
    shardings = tr2._state_shardings(tr2.mesh)
    restored = tr2.store.restore(8, shardings, shardings)
    assert int(restored["step"]) == 8
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert torch.equal(gather(a), gather(b))
    out = tr2.train(state=restored)
    assert int(out["step"]) == 10 and tr2.metrics[-1]["slices"] == 4


def test_recover_restores_after_an_injected_fault(tmp_path):
    """A step that raises once restores the latest checkpoint and the run
    goes on, with the losses of a run without the fault; a step that
    raises again after its restore ends the run with its error."""
    clean = make(tmp_path / "clean", steps=6, slices=2, ckpt_period=2)
    clean.train()
    tr = make(tmp_path / "fault", steps=6, slices=2, ckpt_period=2)
    step_fn, calls = tr.train_step, []

    def flaky(state, batch):
        calls.append(int(state["step"]))
        if len(calls) == 4:                 # the step from 3 to 4
            raise RuntimeError("injected fault")
        return step_fn(state, batch)

    tr.train_step = flaky
    state = tr.train()
    assert tr.recoveries == [{"failed": 3, "restored": 2}]
    assert calls == [0, 1, 2, 3, 2, 3, 4, 5]
    assert int(state["step"]) == 6
    assert [m["loss"] for m in tr.metrics[-2:]] == \
        [m["loss"] for m in clean.metrics[-2:]]

    broken = make(tmp_path / "broken", steps=6, slices=2, ckpt_period=2)
    broken_fn = broken.train_step

    def always(state, batch):
        if int(state["step"]) >= 3:
            raise RuntimeError("a kernel that cannot launch")
        return broken_fn(state, batch)

    broken.train_step = always
    with pytest.raises(RuntimeError, match="cannot launch"):
        broken.train()
    assert len(broken.recoveries) == 1


def test_fsdp_checkpoint_restores_onto_another_slice_count(tmp_path):
    """Under FSDP_RULES (every embed axis in blocks over the data slices) a
    state saved from 2 slices restores onto 4, each slice holding its
    quarter, equal to the saved one; training resumes there. A fault at 4
    slices restores the latest checkpoint onto the current mesh and the
    run ends with the losses of a run without the fault."""
    tr = make(tmp_path / "run", steps=4, slices=2, ckpt_period=4,
              rules=FSDP_RULES)
    state = tr.train()
    tr2 = make(tmp_path / "run", steps=6, slices=4, ckpt_period=2,
               rules=FSDP_RULES)
    shardings = tr2._state_shardings(tr2.mesh)
    restored = tr2.store.restore(4, shardings, shardings)
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert torch.equal(gather(a), gather(b))
    w = restored["params"]["blocks"]["p0"]["ffn"]["w_down"]
    assert [t.shape[-1] for t in w.shards.values()] == [w.shape[-1] // 4] * 4
    clean = tr2.train(state=restored)
    fault = make(tmp_path / "fault", steps=6, slices=4, ckpt_period=2,
                 rules=FSDP_RULES)
    step_fn, calls = fault.train_step, []

    def flaky(state, batch):
        calls.append(int(state["step"]))
        if calls == [4, 5]:                  # the step from 5 to 6
            raise RuntimeError("injected fault")
        return step_fn(state, batch)

    fault.store.save(4, restored)
    fault.train_step = flaky
    out = fault.train(state=restored)
    assert fault.recoveries == [{"failed": 5, "restored": 4}]
    for a, b in zip(tree_leaves(clean), tree_leaves(out)):
        assert torch.equal(gather(a), gather(b))


def test_recover_without_a_checkpoint_raises(tmp_path):
    tr = make(tmp_path, steps=2, ckpt_period=10)
    tr.train_step = lambda state, batch: (_ for _ in ()).throw(
        RuntimeError("injected fault"))
    with pytest.raises(RuntimeError, match="before first checkpoint"):
        tr.train()
    no_store = dataclasses.replace(tr.cfg, ckpt_dir=None)
    tr2 = ElasticTrainer(tr.model, tr.opt_cfg, tr.data, no_store)
    tr2.train_step = tr.train_step
    with pytest.raises(RuntimeError, match="no checkpoint store"):
        tr2.train()
