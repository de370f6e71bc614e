"""Elastic resharding of program state across meshes.

Counterpart of ``repro.core.reshard``, the paper's §5.2 reconfiguration
mechanics: after the RMS grants an expand or shrink, the job's *entire
state* (parameters, optimizer moments, RNG, step counter) continues on a
mesh with a different number of data-parallel slices.

- :func:`reshard` — *runtime data redistribution* (the paper's
  contribution). The reference leaves the transfers to ``jax.device_put``;
  here :func:`reshard` carries out the :func:`expand_plan` /
  :func:`shrink_plan` transfers itself. One rule decides what moves: a
  block stays in place, the old tensor or a view of it, only where the old
  mesh's entry with the new entry's device id (``Mesh.ids``) holds it
  whole; every other block is a new buffer on its slice's device, even
  where two virtual slices share a card. Replicated leaves are copied to
  every new slice that does not already hold a replica.
  ``meshes.resized_mesh`` places new slices so that the blocks that stay
  are exactly the plans' ``local`` transfers: the copies are the plan's
  non-local transfers, on one card or on N.

  The counterpart of ``device_put``'s transfer engine. A leaf's walk (which
  old blocks meet each new block, what stays, the transfer log) depends
  only on the two shardings, the leaf's shape and its dtype: it is compiled
  once into a program, kept in a bounded cache keyed by structure
  (``PROGRAMS``; each resize builds new ``Mesh`` objects). A call then
  allocates the new blocks, each its own ``torch.empty`` buffer, and
  gathers the pieces of every leaf whose source and destination lie on one
  device into one table: one launch of the box-copy kernel a card
  (``kernels/reshard``), the plain version's copies on the CPU. Pieces
  between two devices keep one ``copy_`` each (the plain version's); no
  run has had several real cards, so that route has not run.
- :func:`checkpoint_reshard` — the *checkpoint-and-reconfigure* baseline
  the paper improves on: the state is pulled to host memory and placed
  again. Slower (a host round trip), but it survives device loss; this is
  also the failure-recovery path.
"""
from __future__ import annotations

import collections
import itertools
import time
from typing import Any, Callable, List, Optional

import torch

from repro_torch.core.meshes import Mesh
from repro_torch.core.redistribute import Transfer, expand_plan, shrink_plan
from repro_torch.core.sharding import (NamedSharding, ShardedTensor,
                                       ShardingRules, gather, place,
                                       relative_index)
from repro_torch.core.sharding import intersect as _intersect
from repro_torch.kernels.reshard.ops import box_copy_op
from repro_torch.kernels.reshard.ref import (box_copy_ref, concat, n_tiles,
                                            piece, table_of)
from repro_torch.models.layers import tree_leaves, tree_map

# the compiled walks kept (by structure), and each walk's layouts (by its
# source blocks' devices and strides)
MAX_PROGRAMS, MAX_LAYOUTS = 4096, 16


def state_shardings(state: Any, logical_specs: Any, mesh: Mesh,
                    rules: ShardingRules):
    """NamedShardings for a state tree from its logical specs."""
    return tree_map(lambda logical, leaf: rules.sharding_for(
        logical, tuple(leaf.shape), mesh), logical_specs, state)


def _slice_and_model(mesh: Mesh, coord) -> tuple:
    """(data-parallel slice rank, model coordinate) of a mesh coordinate."""
    k = 0
    for ax in ("pod", "data"):
        if ax in mesh.shape:
            k = k * mesh.shape[ax] + coord[mesh.axis_names.index(ax)]
    m = coord[mesh.axis_names.index("model")] if "model" in mesh.shape \
        else 0
    return k, m


def _plan_sources(p: int, q: int):
    """{new slice: its plan's source slices} for a resize from ``p`` to
    ``q`` slices. Sizes that are not multiples of each other have no plan:
    every old slice may be a source."""
    if p == q:
        return {k: [k] for k in range(q)}
    try:
        plan = expand_plan(p, q, 0) if q > p else shrink_plan(p, q, 0)
    except ValueError:
        return {k: [] for k in range(q)}
    return {k: [t.src for t in plan if t.dst == k] for k in range(q)}


def _numel(box: tuple) -> int:
    n = 1
    for s in box:
        n *= s.stop - s.start
    return n


def _tables(old: Mesh, new: Mesh) -> tuple:
    """What a walk from ``old`` to ``new`` looks up, the same for every
    leaf: each old coordinate's (slice, model) rank, the coordinate of each
    rank and of each device id, the plan's sources of every new slice, and
    each new coordinate's (slice, model) rank."""
    rank = {c: _slice_and_model(old, c) for c in old.coords()}
    by_slice = {v: c for c, v in rank.items()}
    by_id = {old.id(c): c for c in old.coords()}
    new_rank = {c: _slice_and_model(new, c) for c in new.coords()}
    p = len({k for k, _ in by_slice})
    q = len({k for k, _ in new_rank.values()})
    return rank, by_slice, by_id, _plan_sources(p, q), new_rank, p


class _Program:
    """One leaf's walk from one sharding to another, compiled (it depends
    only on the two shardings, the leaf's shape and its dtype).

    ``sources``: the old coordinates it reads, in order. ``steps``: one per
    new coordinate, in the new mesh's order: (coordinate, block shape,
    device, keep, pieces). ``keep`` is (source, index in the old block, or
    None where the block is the old one whole) where the block may stay in
    place: one piece covers it from the old entry with its own device id;
    it stays where that old block lies on its device. ``pieces``: [(source,
    start in the old block, extents, start in the new block)] in the walk's
    order. ``transfers``: the log a call extends. ``layouts``: the copies'
    tables by the source blocks' devices and strides (:func:`_layout`)."""

    __slots__ = ("sources", "steps", "transfers", "dtype", "layouts")

    def __init__(self, sources, steps, transfers, dtype):
        self.sources, self.steps = sources, steps
        self.transfers, self.dtype = transfers, dtype
        self.layouts: "collections.OrderedDict" = collections.OrderedDict()


def _view_index(inner: tuple, outer: tuple):
    """The index of box ``inner`` in a block of box ``outer``: None for the
    whole block, else its slices without the trailing whole dims (a single
    slice indexes fastest)."""
    index = list(relative_index(inner, outer))
    while index and inner[len(index) - 1] == outer[len(index) - 1]:
        index.pop()
    if not index:
        return None
    return index[0] if len(index) == 1 else tuple(index)


def _start(inner: tuple, outer: tuple) -> tuple:
    return tuple(a.start - b.start for a, b in zip(inner, outer))


def _compile(shape, dtype, old_sh: NamedSharding,
             new_sh: NamedSharding) -> _Program:
    """The walk of :func:`reshard` for one leaf, once: for each new block,
    the old entry on its device id, then the plan's sources, then the rest,
    each distinct old block that meets it, once. The distinct old blocks
    partition the leaf, so the walk stops once the pieces cover the new
    block: no later block can meet it."""
    old, new = old_sh.mesh, new_sh.mesh
    rank, by_slice, by_id, plans, new_rank, p = _tables(old, new)
    itemsize = dtype.itemsize
    boxes, sources, index = {}, [], {}

    def source(oc):
        if oc not in index:
            index[oc] = len(sources)
            sources.append(oc)
        return index[oc]

    steps, transfers = [], []
    for c in new.coords():
        k, m = new_rank[c]
        box = new_sh.index(shape, c)
        need = _numel(box)
        here = by_id.get(new.id(c))
        order = itertools.chain(
            () if here is None else (here,),
            (by_slice[(s, m)] for s in itertools.chain(plans[k], range(p))))
        pieces, seen, covered = [], set(), 0
        for oc in order:
            if oc not in boxes:
                boxes[oc] = old_sh.index(shape, oc)
            ob = boxes[oc]
            key = tuple((b.start, b.stop) for b in ob)
            if key in seen:
                continue
            inter = _intersect(box, ob)
            if inter is None:
                continue
            seen.add(key)
            pieces.append((oc, ob, inter))
            covered += _numel(inter)
            if covered == need:
                break
        oc, ob, inter = pieces[0]
        keep = None
        if len(pieces) == 1 and oc == here and inter == box:
            keep = (source(oc), _view_index(inter, ob))
        # a kept block logs as its one piece would: local, the whole box
        for oc, ob, inter in pieces:
            transfers.append(Transfer(rank[oc][0], k, _numel(inter)
                                      * itemsize, oc == here))
        steps.append((c, tuple(b.stop - b.start for b in box), new.device(c),
                      keep, [(source(oc), _start(inter, ob),
                              tuple(b.stop - b.start for b in inter),
                              _start(inter, box))
                             for oc, ob, inter in pieces]))
    return _Program(sources, steps, transfers, dtype)


def _contiguous_strides(shape: tuple) -> tuple:
    out, n = [], 1
    for d in reversed(shape):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def _layout(prog: _Program, devices: tuple, strides: tuple) -> tuple:
    """What a call does with source blocks on ``devices`` at element
    ``strides`` (one per source): (actions, groups). ``actions``, one per
    new coordinate in order: (coordinate, keep or None, shape, device, the
    earlier new block of that shape and device or None); a block stays
    only where its source lies on its device. ``groups``: by
    (source device, destination device), the copies as (a table of pieces,
    its tiles, the sources its ``src`` indices name, the new blocks, in the
    order they are made, its ``dst`` indices name)."""
    actions, groups, made, first = [], {}, 0, {}
    itemsize = prog.dtype.itemsize
    for c, shape, dev, keep, pieces in prog.steps:
        if keep is not None and devices[keep[0]] == dev:
            actions.append((c, keep, shape, dev, None))
            continue
        # a new block like an earlier one is allocated by empty_like(it)
        actions.append((c, None, shape, dev, first.get((shape, dev))))
        first.setdefault((shape, dev), made)
        dst_strides = _contiguous_strides(shape)
        for si, start, ext, dst_start in pieces:
            recs, srcs, dsts = groups.setdefault((devices[si], dev),
                                                 ([], {}, {}))
            recs.append(piece(srcs.setdefault(si, len(srcs)),
                              dsts.setdefault(made, len(dsts)), start, ext,
                              dst_start, strides[si], dst_strides, itemsize))
        made += 1
    tables = {key: table_of(recs) for key, (recs, _, _) in groups.items()}
    return actions, {key: (tables[key], n_tiles(tables[key]), tuple(srcs),
                           tuple(dsts))
                     for key, (_, srcs, dsts) in groups.items()}


class _Programs:
    """The compiled walks by structure: both meshes' axis names, shape, ids
    and devices, both specs, the leaf's shape and dtype (each resize builds
    new Mesh objects, so identity would never hit). Bounded: the least
    recently used goes first. ``compiles`` counts the walks compiled."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self.entries: "collections.OrderedDict" = collections.OrderedDict()
        self.compiles = 0

    def get(self, x: ShardedTensor, sh: NamedSharding) -> _Program:
        old = x.sharding
        key = (old.mesh.key, old.spec, sh.mesh.key, sh.spec, x.shape,
               x.dtype)
        prog = self.entries.get(key)
        if prog is None:
            prog = _compile(x.shape, x.dtype, old, sh)
            self.compiles += 1
            self.entries[key] = prog
            if len(self.entries) > self.maxsize:
                self.entries.popitem(last=False)
        else:
            self.entries.move_to_end(key)
        return prog

    def clear(self) -> None:
        self.entries.clear()


PROGRAMS = _Programs(MAX_PROGRAMS)


class _Copies:
    """The copies of one reshard call, gathered across its leaves by
    (source device, destination device)."""

    def __init__(self):
        self.groups: dict = {}

    def add(self, key, table, tiles, srcs, dsts) -> None:
        group = self.groups.get(key)
        if group is None:
            group = self.groups[key] = [[], [], [], 0]
        tables, all_srcs, all_dsts, first = group
        tables.append((table, len(all_srcs), len(all_dsts), first))
        all_srcs.extend(srcs)
        all_dsts.extend(dsts)
        group[3] = first + tiles

    def tables(self) -> list:
        """[(source device, destination device, sources, destinations,
        table)]: each group's pieces in one table."""
        return [(sdev, ddev, srcs, dsts, concat(tables))
                for (sdev, ddev), (tables, srcs, dsts, _)
                in self.groups.items()]


def _reshard_leaf(x: ShardedTensor, sh: NamedSharding,
                  transfers: Optional[List[Transfer]],
                  copies: _Copies) -> ShardedTensor:
    """The new blocks of one leaf, from its compiled walk: kept blocks are
    the old tensors (or views of them), each other block a new buffer
    whose pieces go to ``copies``."""
    prog = PROGRAMS.get(x, sh)
    old = x.shards
    srcs = [old[oc] for oc in prog.sources]
    key = (tuple([t.device for t in srcs]), tuple([t.stride() for t in srcs]))
    layout = prog.layouts.get(key)
    if layout is None:
        layout = prog.layouts[key] = _layout(prog, *key)
        if len(prog.layouts) > MAX_LAYOUTS:
            prog.layouts.popitem(last=False)
    actions, groups = layout
    dtype, empty, empty_like = x.dtype, torch.empty, torch.empty_like
    shards, made = {}, []
    for c, keep, shape, dev, like in actions:
        if keep is None:
            out = empty(shape, dtype=dtype, device=dev) if like is None \
                else empty_like(made[like])
            made.append(out)
            shards[c] = out
        else:
            t = srcs[keep[0]]
            shards[c] = t if keep[1] is None else t[keep[1]]
    for gkey, (table, tiles, si, di) in groups.items():
        copies.add(gkey, table, tiles, [srcs[i] for i in si],
                   [made[i] for i in di])
    if transfers is not None:
        transfers.extend(prog.transfers)
    return ShardedTensor(x.shape, x.dtype, sh, shards)


def plan_copies(state: Any, shardings: Any, *,
                transfers: Optional[List[Transfer]] = None) -> tuple:
    """:func:`reshard` up to its copies: (the new state, whose new blocks
    are allocated but not yet written, and [(source device, destination
    device, sources, destinations, table)], the copies that write them, one
    table a pair of devices)."""
    batch = _Copies()
    out = tree_map(lambda x, sh: _reshard_leaf(x, sh, transfers, batch),
                   state, shardings)
    return out, batch.tables()


def reshard(state: Any, shardings: Any, *,
            transfers: Optional[List[Transfer]] = None) -> Any:
    """Runtime redistribution: move ``state`` (a tree of ShardedTensors)
    onto ``shardings`` (a tree of NamedShardings of the same structure).

    ``transfers``, when given, gets one :class:`Transfer` per block or piece
    moved, ``local`` where it stays on its device id. Blocks left in place
    are the old tensors, or views of them, and keep the old buffers alive.
    The copies go in one box-copy launch a card (the CPU's take its plain
    version); pieces between two devices take the plain version's copy_."""
    out, copies = plan_copies(state, shardings, transfers=transfers)
    for sdev, ddev, srcs, dsts, table in copies:
        if sdev == ddev:
            box_copy_op(srcs, dsts, table)
        else:
            box_copy_ref(srcs, dsts, table)
    return out


def checkpoint_reshard(state: Any, shardings: Any) -> Any:
    """Checkpoint-based baseline: a host round trip, then placed again."""
    host = tree_map(lambda x: gather(x, device="cpu"), state)
    return tree_map(place, host, shardings)


def synchronize(state: Any) -> None:
    """Wait for every card that holds a block of ``state``."""
    cards = {t.get_device() for x in tree_leaves(state)
             for t in x.shards.values()}
    for card in sorted(cards - {-1}):      # -1: the CPU
        torch.cuda.synchronize(card)


def timed_reshard(state: Any, shardings: Any,
                  impl: Callable[[Any, Any], Any] = reshard):
    """Reshard and return ``(new_state, seconds)``, the paper's resize time
    (Fig. 3 right); the devices are synchronised before each clock
    reading."""
    synchronize(state)
    t0 = time.perf_counter()
    out = impl(state, shardings)
    synchronize(out)
    return out, time.perf_counter() - t0


def ownership_map(arr: ShardedTensor) -> dict:
    """Which mesh coordinate owns which index range: used to check that
    :func:`reshard` realizes exactly the Listing-3 mapping. The reference
    keys it by device id; a device may hold several virtual slices here."""
    return {c: arr.index(c) for c in arr.sharding.mesh.coords()}
