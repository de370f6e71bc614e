"""The reshard's transfer engine on the CPU: the walk compiled once per
geometry (``core/reshard.py``) and the table of pieces it hands to the copy
engine (``kernels/reshard``), against ``gather`` of the input, the Listing-3
plans and the reference's ``jax.device_put`` on forced host devices.

The port runs on virtual CPU slices (``slice_devices(n, "cpu")``), where the
pieces take the plain executor; the CUDA kernel runs the same tables on the
card (``chip_smoke.py``). Its tiling is held here by a step-by-step mirror
of the kernel's walk over (piece, tile).
"""
import dataclasses
import importlib
import itertools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.calib.measure import CI_GEOMETRIES  # noqa: E402
from repro_torch.core import (FSDP_RULES, NamedSharding,  # noqa: E402
                              PartitionSpec as P, TP_DP_RULES, expand_plan,
                              gather, make_mesh, place, plan_stats, reshard,
                              resized_mesh, shrink_plan, slice_devices)
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.kernels.reshard import kernel, ops, ref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.registry import reduced_config  # noqa: E402
from repro_torch.models.layers import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime import ElasticTrainer, TrainerConfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
reshard_mod = importlib.import_module("repro_torch.core.reshard")
CPU8 = slice_devices(8, "cpu")
CPU64 = slice_devices(64, "cpu")
DTYPES = (torch.float32, torch.bfloat16, torch.int32)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def distinct(shape, dtype):
    """Values whose bits differ element by element in every dtype (the
    counter's low bits as bf16 / fp32 / int32 bit patterns)."""
    n = int(np.prod(shape))
    bits = torch.arange(n, dtype=torch.int32).reshape(shape)
    if dtype == torch.bfloat16:
        return (bits % 30000 + 1).to(torch.int16).view(torch.bfloat16)
    return bits.view(dtype)


def same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def plan_of(p, q, nbytes):
    return expand_plan(p, q, nbytes) if q > p else shrink_plan(p, q, nbytes)


def nonlocal_bytes(transfers):
    return sum(t.nbytes for t in transfers if not t.local)


# -- the compiled walk against gather and the plans ---------------------------------


GEOMETRIES = [g for p, q in CI_GEOMETRIES for g in ((p, q), (q, p))]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("p,q", GEOMETRIES)
def test_row_sharded_leaf_moves_by_the_plan(p, q, dtype):
    """Every CI geometry both ways, a row-sharded leaf onto resized_mesh:
    bit-equal to the input, the transfers carrying the plan's participants,
    busiest-link bytes and non-local bytes (as measure_grid checks them)."""
    x = distinct((128, 3), dtype)
    mp = make_mesh(p, 1, devices=CPU64)
    xp = place(x, NamedSharding(mp, P("data")))
    transfers = []
    y = reshard(xp, NamedSharding(resized_mesh(mp, q, devices=CPU64),
                                  P("data")), transfers=transfers)
    assert same_bits(gather(y), x)
    plan = plan_of(p, q, xp.nbytes)
    assert plan_stats(transfers) == plan_stats(plan)
    assert nonlocal_bytes(transfers) == nonlocal_bytes(plan)


@pytest.mark.parametrize("spec,shape", [(P(), (8, 6)), (P(None, "data"),
                                                        (3, 16, 5)),
                                        (P(None, None, "data"), (2, 3, 16))])
@pytest.mark.parametrize("p,q", [(1, 2), (2, 4), (4, 2), (8, 1), (2, 8)])
def test_replicated_and_inner_dim_leaves(p, q, spec, shape):
    """A replicated leaf and leaves split on a non-leading dim: bit-equal;
    a replica stays only on its own device id, every other slice gets the
    whole leaf; a split leaf moves the plan's bytes."""
    x = distinct(shape, torch.float32)
    mp = make_mesh(p, 1, devices=CPU8)
    mq = resized_mesh(mp, q, devices=CPU8)
    xp = place(x, NamedSharding(mp, spec))
    transfers = []
    y = reshard(xp, NamedSharding(mq, spec), transfers=transfers)
    assert same_bits(gather(y), x)
    if spec == P():
        held = {mp.id(c) for c in mp.coords()}
        assert sorted(t.dst for t in transfers if t.local) == sorted(
            k for k, c in enumerate(mq.coords()) if mq.id(c) in held)
        assert all(t.nbytes == xp.nbytes for t in transfers)
        assert len(transfers) == q
    else:
        plan = plan_of(p, q, xp.nbytes)
        assert plan_stats(transfers) == plan_stats(plan)
        assert nonlocal_bytes(transfers) == nonlocal_bytes(plan)


@pytest.mark.parametrize("p,q", [(3, 4), (4, 3), (3, 2), (6, 4)])
def test_sizes_without_a_plan(p, q):
    """Sizes that are not multiples of each other (prefix meshes): every
    byte arrives once, from the old slices whose rows meet the new ones."""
    x = distinct((48, 5), torch.bfloat16)
    mp = make_mesh(p, 1, devices=CPU8)
    xp = place(x, NamedSharding(mp, P("data")))
    transfers = []
    y = reshard(xp, NamedSharding(resized_mesh(mp, q, devices=CPU8),
                                  P("data")), transfers=transfers)
    assert same_bits(gather(y), x)
    assert sum(t.nbytes for t in transfers) == xp.nbytes
    rows = 48
    for t in transfers:
        old = range(t.src * rows // p, (t.src + 1) * rows // p)
        new = range(t.dst * rows // q, (t.dst + 1) * rows // q)
        assert t.nbytes == len(set(old) & set(new)) * 5 * 2


def storage(t):
    s = t.untyped_storage()
    return s.data_ptr(), s.data_ptr() + s.nbytes()


@pytest.mark.parametrize("spec", [P("data"), P()])
def test_a_block_stays_only_on_its_own_device_id(spec):
    """The rule of core/reshard.py, through the compiled program: on
    resized_mesh's placement the plan's local transfers stay (slices 0 and
    2 of 2 -> 4), on a prefix mesh a row block stays on slice 0 and a
    replica on slices 0 and 1 (twin of test_torch_elastic.py's case)."""
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


def small_trainer(rules, slices, model_ways=1):
    cfg = dataclasses.replace(reduced_config(get_config("smollm-135m"),
                                             vocab=96), dtype="float32")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=8)
    return ElasticTrainer(build_model(cfg, device="cpu"), AdamWConfig(),
                          data, TrainerConfig(max_slices=4, rules=rules,
                                              model_ways=model_ways),
                          devices=CPU8, slices=slices)


@pytest.mark.parametrize("rules,ways", [(TP_DP_RULES, 1), (FSDP_RULES, 1),
                                        (TP_DP_RULES, 2), (FSDP_RULES, 2)],
                         ids=["replicated", "fsdp", "replicated-m2",
                              "fsdp-m2"])
def test_train_state_reshards_2_4_2(rules, ways):
    """A TrainState (random moments, ZeRO-1) under TP_DP_RULES and
    FSDP_RULES, at model_ways 1 and 2, expanded 2 -> 4 and shrunk back:
    every leaf bit-equal; every moved byte is the plan's (twin of
    test_torch_elastic.py's FSDP and model_ways cases)."""
    tr = small_trainer(rules, 2, ways)
    state = tr.init_state(seed=0)
    gen = torch.Generator().manual_seed(1)
    state["opt"]["mu"] = tree_map(lambda x: x.map(
        lambda t: torch.randn(t.shape, generator=gen)), state["opt"]["mu"])
    want = tree_map(gather, state)
    m4 = resized_mesh(tr.mesh, 4, devices=CPU8)
    transfers = []
    s4 = reshard(state, tr._state_shardings(m4), transfers=transfers)
    s2 = reshard(s4, tr._state_shardings(tr.mesh))
    for w, a, b in zip(tree_leaves(want), tree_leaves(s4), tree_leaves(s2)):
        assert same_bits(gather(a), w) and same_bits(gather(b), w)
    assert {(t.src, t.dst, t.local) for t in transfers} <= {
        (t.src, t.dst, t.local) for t in expand_plan(2, 4, 0)}


def test_a_chain_reads_strided_views():
    """Expanding a leaf split on its middle dim keeps blocks in place as
    strided views of the old ones; a second reshard reads those views as
    its sources, with their strides, bit-equal."""
    x = distinct((8, 16, 6), torch.float32)
    spec = P(None, "data")
    m2 = make_mesh(2, 1, devices=CPU8)
    m4 = resized_mesh(m2, 4, devices=CPU8)
    x4 = reshard(place(x, NamedSharding(m2, spec)), NamedSharding(m4, spec))
    views = [t for t in x4.shards.values() if not t.is_contiguous()]
    assert len(views) == 2
    for q, sp in itertools.product((2, 8), (spec, P(), P("data"))):
        y = reshard(x4, NamedSharding(resized_mesh(m4, q, devices=CPU8), sp))
        assert same_bits(gather(y), x)
    y = reshard(x4, NamedSharding(make_mesh(3, 1, devices=CPU8),
                                  P(None, None, "data")))
    assert same_bits(gather(y), x)


def test_a_second_reshard_of_a_geometry_compiles_nothing():
    """The walk is compiled once per geometry: a second reshard of the same
    leaf structure, even between freshly built meshes, compiles nothing."""
    x = distinct((64, 4), torch.float32)
    reshard_mod.PROGRAMS.clear()
    before = reshard_mod.PROGRAMS.compiles

    def resize(p, q):
        mp = make_mesh(p, 1, devices=CPU64)
        xp = place(x, NamedSharding(mp, P("data")))
        return reshard(xp, NamedSharding(resized_mesh(mp, q, devices=CPU64),
                                         P("data")))
    for p, q in ((32, 64), (64, 32), (2, 4)):
        resize(p, q)
    assert reshard_mod.PROGRAMS.compiles - before == 3
    for p, q in ((32, 64), (64, 32), (2, 4)):
        assert same_bits(gather(resize(p, q)), x)
    assert reshard_mod.PROGRAMS.compiles - before == 3
    # another dtype or another spec is another program
    mp = make_mesh(2, 1, devices=CPU8)
    reshard(place(x.double(), NamedSharding(mp, P("data"))),
            NamedSharding(resized_mesh(mp, 4, devices=CPU8), P("data")))
    assert reshard_mod.PROGRAMS.compiles - before == 4


def test_the_program_cache_is_bounded(monkeypatch):
    cache = reshard_mod._Programs(2)
    monkeypatch.setattr(reshard_mod, "PROGRAMS", cache)
    mp = make_mesh(2, 1, devices=CPU8)
    for n in (4, 8, 12, 4):
        x = place(torch.zeros(n, 2), NamedSharding(mp, P("data")))
        reshard(x, NamedSharding(resized_mesh(mp, 4, devices=CPU8),
                                 P("data")))
    assert len(cache.entries) == 2 and cache.compiles == 4


# -- the reference: jax.device_put on forced host devices ---------------------------

REFERENCE_CASES = [
    # (shape, spec, p, q, model_ways)
    ((64, 6), ("data",), 2, 4, 1), ((64, 6), ("data",), 4, 2, 1),
    ((64, 6), ("data",), 1, 8, 1), ((64, 6), ("data",), 8, 2, 1),
    ((48, 6), ("data",), 3, 4, 1), ((4, 8, 6), (None, "data"), 2, 4, 1),
    ((8, 6), (), 2, 4, 1), ((8, 6), ("data", "model"), 2, 4, 2),
    ((8, 6, 4), (None, "model", "data"), 4, 2, 2),
]

REFERENCE_PUT = """
import json
import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec
from repro.core.reshard import reshard
devs = np.array(jax.devices())
out = []
for shape, spec, old_ids, new_ids in CASES:
    x = np.arange(int(np.prod(shape)), dtype=np.int32).reshape(shape)
    def mesh(ids):
        return Mesh(devs[np.array(ids)], ("data", "model"))
    a = jax.device_put(x, NamedSharding(mesh(old_ids), PartitionSpec(*spec)))
    b = reshard(a, NamedSharding(mesh(new_ids), PartitionSpec(*spec)))
    out.append({str(s.device.id): [
        [[i.start or 0, i.stop if i.stop is not None else n]
         for i, n in zip(s.index, shape)],
        np.asarray(s.data).ravel().tolist()] for s in b.addressable_shards})
print(json.dumps(out))
"""


def test_blocks_match_the_reference_device_put():
    """For each case the reference's reshard (``jax.device_put``) on 8
    forced host devices, between meshes of the port's device ids: each
    device holds the same box with the same values as the port's block on
    the coordinate of that id."""
    cases, ports = [], []
    for shape, spec, p, q, ways in REFERENCE_CASES:
        mp = make_mesh(p, ways, devices=CPU8)
        mq = resized_mesh(mp, q, devices=CPU8)
        x = torch.arange(int(np.prod(shape)), dtype=torch.int32).reshape(
            shape)
        ports.append((mq, reshard(place(x, NamedSharding(mp, P(*spec))),
                                  NamedSharding(mq, P(*spec)))))
        cases.append((shape, spec, mp.ids.tolist(), mq.ids.tolist()))
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    code = f"CASES = {cases!r}\n" + textwrap.dedent(REFERENCE_PUT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    for (mq, y), ref_shards in zip(ports, want):
        got = {str(mq.id(c)): [[[b.start, b.stop] for b in y.index(c)],
                               y.shards[c].ravel().tolist()]
               for c in mq.coords()}
        assert got == ref_shards


# -- the table and its plain executor ------------------------------------------------


@pytest.mark.parametrize("extents,src,dst,want", [
    # a whole contiguous block: one run
    ((4, 6), (6, 1), (6, 1), [(96, 1, 1)]),
    # rows of a contiguous block into a contiguous one: one run
    ((2, 6), (6, 1), (6, 1), [(48, 1, 1)]),
    # a box of a (4, 6) block, 3 of its 6 columns: rows of 12 bytes
    ((4, 3), (6, 1), (3, 1), [(4, 24, 12), (12, 1, 1)]),
    # a stacked layer's block split on its middle dim: layers of runs
    ((3, 8, 5), (80, 5, 1), (40, 5, 1), [(3, 320, 160), (160, 1, 1)]),
    # extent-1 dims vanish wherever they are
    ((1, 4, 1, 6), (48, 12, 6, 1), (24, 6, 6, 1), [(4, 48, 24), (24, 1, 1)]),
    # a transposed source: element by element
    ((3, 2), (1, 3), (2, 1), [(3, 4, 8), (2, 12, 4), (4, 1, 1)]),
])
def test_merge_dims_leaves_contiguous_runs_whole(extents, src, dst, want):
    assert ref.merge_dims(extents, src, dst, 4) == want


def test_a_piece_above_four_dims_raises():
    with pytest.raises(ValueError, match="above 4"):
        ref.piece(0, 0, (0,) * 4, (2, 2, 2, 2), (0,) * 4,
                  (1000, 100, 10, 2), (8, 4, 2, 1), 4)


def strided_cases(seed):
    """Random source blocks (strided views of larger tensors: slices,
    a transposed one), destination blocks, and boxes of 1 to 4 dims."""
    rng = np.random.default_rng(seed)
    out = []
    for ndim, dtype in itertools.product((1, 2, 3, 4), DTYPES):
        shape = tuple(int(n) for n in rng.integers(2, 7, ndim))
        big = distinct(tuple(n + 3 for n in shape), dtype)
        src = big[tuple(slice(1, 1 + n) for n in shape)]
        if 1 < ndim < 4 and rng.random() < 0.5:
            src = src.transpose(0, -1).contiguous().transpose(0, -1)
        dst = torch.zeros(shape, dtype=dtype)
        ext = [int(rng.integers(1, n + 1)) for n in shape]
        s0 = [int(rng.integers(0, n - e + 1)) for n, e in zip(shape, ext)]
        d0 = [int(rng.integers(0, n - e + 1)) for n, e in zip(shape, ext)]
        out.append((src, dst, s0, ext, d0))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_plain_executor_against_copy_per_piece(seed):
    """One table over many blocks (1-4 dims, strided and transposed
    sources, fp32 / bf16 / int32): box_copy_ref writes what copy_ of each
    box writes, and nothing else."""
    cases = strided_cases(seed)
    srcs = [c[0] for c in cases]
    dsts = [c[1] for c in cases]
    want = [d.clone() for d in dsts]
    recs = []
    for i, (src, dst, s0, ext, d0) in enumerate(cases):
        box = tuple(slice(a, a + e) for a, e in zip(s0, ext))
        dbox = tuple(slice(a, a + e) for a, e in zip(d0, ext))
        want[i][dbox].copy_(src[box])
        recs.append(ref.piece(i, i, s0, ext, d0, src.stride(), dst.stride(),
                              src.element_size()))
    ref.box_copy_ref(srcs, dsts, ref.table_of(recs))
    for got, w in zip(dsts, want):
        assert same_bits(got, w)


def kernel_mirror(srcs, dsts, table):
    """box_copy.cu's walk, step by step on the host: each tile found by a
    binary search over the pieces' first tiles, its rows and bytes as the
    kernel computes them. Returns how often each destination byte was
    written."""
    tile = ref.TILE_BYTES
    src_b = [ref.byte_view(t).numpy() for t in srcs]
    dst_b = [ref.byte_view(t).numpy() for t in dsts]
    base_s = [t.storage_offset() * t.element_size() for t in srcs]
    base_d = [t.storage_offset() * t.element_size() for t in dsts]
    writes = [np.zeros(b.size, np.int64) for b in dst_b]
    firsts = table["tile0"]
    for t in range(ref.n_tiles(table)):
        p = int(np.searchsorted(firsts, t, side="right")) - 1
        pc = table[p]
        group, chunk = divmod(t - int(pc["tile0"]), int(pc["chunks"]))
        ext = [int(e) for e in pc["ext"]]
        rows = ext[0] * ext[1] * ext[2]
        row0 = group * int(pc["rows_per_tile"])
        nrows = min(int(pc["rows_per_tile"]), rows - row0)
        col0 = chunk * tile
        width = min(tile, int(pc["run"]) - col0)
        assert nrows >= 1 and width >= 1
        for row in range(row0, row0 + nrows):
            i0, rest = divmod(row, ext[1] * ext[2])
            i1, i2 = divmod(rest, ext[2])
            idx = (i0, i1, i2)
            so = base_s[pc["src"]] + int(pc["src_off"]) + col0 + sum(
                i * int(s) for i, s in zip(idx, pc["src_stride"]))
            do = base_d[pc["dst"]] + int(pc["dst_off"]) + col0 + sum(
                i * int(s) for i, s in zip(idx, pc["dst_stride"]))
            dst_b[pc["dst"]][do:do + width] = src_b[pc["src"]][so:so + width]
            writes[pc["dst"]][do:do + width] += 1
    return writes


@pytest.mark.parametrize("shape,box", [
    ((64, 1024), (slice(0, 32), slice(None))),      # long runs, chunked
    ((4, 4, 3000), (slice(1, 3), slice(None), slice(0, 2000))),
    ((300, 7), (slice(0, 300), slice(2, 5))),         # short rows, packed
    ((5, 6, 7, 8), (slice(1, 4), slice(0, 5), slice(2, 6), slice(1, 7))),
])
def test_kernel_tiles_write_every_byte_once(shape, box):
    """The kernel's tiling of a table (rows packed into tiles where runs are
    short, runs cut into tiles where they are long), mirrored on the host:
    every destination byte of every piece is written exactly once, with
    the plain executor's values."""
    src = distinct(shape, torch.bfloat16)
    ext = [len(range(*b.indices(n))) for b, n in zip(box, shape)]
    start = [b.indices(n)[0] for b, n in zip(box, shape)]
    dsts = [torch.zeros(ext, dtype=src.dtype) for _ in range(2)]
    want = torch.zeros(ext, dtype=src.dtype)
    recs = [ref.piece(0, 0, start, ext, [0] * len(ext), src.stride(),
                      dsts[i].stride(), 2) for i in range(2)]
    first = ref.table_of(recs[:1])
    table = ref.concat([(first, 0, 0, 0),
                        (ref.table_of(recs[1:]), 0, 1, ref.n_tiles(first))])
    writes = kernel_mirror([src], dsts, table)
    ref.box_copy_ref([src], [want], ref.table_of(recs[:1]))
    for d, w in zip(dsts, writes):
        assert (w == 1).all() and same_bits(d, want)


def test_concat_shifts_blocks_and_tiles():
    a = ref.table_of([ref.piece(0, 0, (0,), (5000,), (0,), (1,), (1,), 4)])
    b = ref.table_of([ref.piece(0, 0, (0,), (3,), (0,), (1,), (1,), 4),
                      ref.piece(1, 1, (0,), (9000,), (0,), (1,), (1,), 4)])
    assert (ref.n_tiles(a), ref.n_tiles(b)) == (2, 4)
    t = ref.concat([(a, 0, 0, 0), (b, 1, 1, 2)])
    assert t["src"].tolist() == [0, 1, 2] and t["dst"].tolist() == [0, 1, 2]
    assert t["tile0"].tolist() == [0, 2, 3] and ref.n_tiles(t) == 6
    assert t["run"].tolist() == [20000, 12, 36000]
    assert a["tile0"].tolist() == [0] and b["src"].tolist() == [0, 1]
    assert ref.concat([(a, 0, 0, 0)]) is a
    # as the copies of a reshard gather their leaves' tables
    batch = reshard_mod._Copies()
    batch.add(("cpu", "cpu"), a, 2, ["s0"], ["d0"])
    batch.add(("cpu", "cpu"), b, 4, ["s1", "s2"], ["d1", "d2"])
    (_, _, srcs, dsts, joint), = batch.tables()
    assert srcs == ["s0", "s1", "s2"] and dsts == ["d0", "d1", "d2"]
    assert joint.tobytes() == t.tobytes()


def test_kernel_wrapper_refuses_cpu_blocks_and_counts_nothing():
    """The kernel wrapper never runs the plain version: CPU blocks are an
    error there, and only a launch adds to its count."""
    src, dst = torch.arange(8.0), torch.zeros(8)
    table = ref.table_of([ref.piece(0, 0, (0,), (8,), (0,), (1,), (1,), 4)])
    before = kernel.box_copy.launches
    with pytest.raises(ValueError, match="one card"):
        kernel.box_copy([src], [dst], table)
    assert kernel.box_copy.launches == before
    ops.box_copy_op([src], [dst], table)
    assert torch.equal(dst, src) and kernel.box_copy.launches == before
