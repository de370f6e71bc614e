"""Elastic resharding of program state across meshes.

Counterpart of ``repro.core.reshard``, the paper's §5.2 reconfiguration
mechanics: after the RMS grants an expand or shrink, the job's *entire
state* (parameters, optimizer moments, RNG, step counter) continues on a
mesh with a different number of data-parallel slices.

- :func:`reshard` — *runtime data redistribution* (the paper's
  contribution). The reference leaves the transfers to ``jax.device_put``;
  here :func:`reshard` carries out the :func:`expand_plan` /
  :func:`shrink_plan` transfers itself. One rule decides what moves: a
  block stays in place, as a view of the old buffer, only where the old
  mesh's entry with the new entry's device id (``Mesh.ids``) holds it
  whole; every other block is a new buffer on its slice's device, even
  where two virtual slices share a card. Replicated leaves are copied to
  every new slice that does not already hold a replica.
  ``meshes.resized_mesh`` places new slices so that the blocks that stay
  are exactly the plans' ``local`` transfers: the copies are the plan's
  non-local transfers, on one card or on N.
- :func:`checkpoint_reshard` — the *checkpoint-and-reconfigure* baseline
  the paper improves on: the state is pulled to host memory and placed
  again. Slower (a host round trip), but it survives device loss; this is
  also the failure-recovery path.
"""
from __future__ import annotations

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
from repro_torch.models.layers import tree_leaves, tree_map


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


def _reshard_leaf(x: ShardedTensor, sh: NamedSharding,
                  transfers: Optional[List[Transfer]],
                  tables: Optional[dict] = None) -> ShardedTensor:
    """``tables``: a cache of :func:`_tables` by (old mesh, new mesh),
    shared by the leaves of one reshard."""
    old, new = x.sharding.mesh, sh.mesh
    if tables is None:
        tables = {}
    if (old, new) not in tables:
        tables[old, new] = _tables(old, new)
    rank, by_slice, by_id, plans, new_rank, p = tables[old, new]
    shards = {}
    for c in new.coords():
        k, m = new_rank[c]
        box = sh.index(x.shape, c)
        need = _numel(box)
        dev = new.device(c)
        # the old entry on this device, then the plan's sources, then the
        # rest: each distinct old block that meets the new one, once. The
        # distinct old blocks partition the leaf, so the walk stops once
        # the pieces cover the new block: no later block can meet it.
        here = by_id.get(new.id(c))
        order = itertools.chain(
            () if here is None else (here,),
            (by_slice[(s, m)] for s in itertools.chain(plans[k], range(p))))
        pieces, seen, covered = [], set(), 0
        for oc in order:
            ob = x.index(oc)
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
        if len(pieces) == 1 and oc == here and inter == box and \
                x.shards[oc].device == dev:
            # already on this device: the block stays where it is
            shards[c] = x.shards[oc][relative_index(inter, ob)]
            if transfers is not None:
                transfers.append(Transfer(rank[oc][0], k, _numel(box)
                                          * x.dtype.itemsize, True))
            continue
        out = torch.empty([b.stop - b.start for b in box], dtype=x.dtype,
                          device=dev)
        for oc, ob, inter in pieces:
            out[relative_index(inter, box)].copy_(
                x.shards[oc][relative_index(inter, ob)])
            if transfers is not None:
                transfers.append(Transfer(rank[oc][0], k, _numel(inter)
                                          * x.dtype.itemsize, oc == here))
        shards[c] = out
    return ShardedTensor(x.shape, x.dtype, sh, shards)


def reshard(state: Any, shardings: Any, *,
            transfers: Optional[List[Transfer]] = None) -> Any:
    """Runtime redistribution: move ``state`` (a tree of ShardedTensors)
    onto ``shardings`` (a tree of NamedShardings of the same structure).

    ``transfers``, when given, gets one :class:`Transfer` per block or piece
    moved, ``local`` where it stays on its device id. Blocks left in place
    are views that keep the old buffer alive."""
    tables: dict = {}
    return tree_map(lambda x, sh: _reshard_leaf(x, sh, transfers, tables),
                    state, shardings)


def checkpoint_reshard(state: Any, shardings: Any) -> Any:
    """Checkpoint-based baseline: a host round trip, then placed again."""
    host = tree_map(lambda x: gather(x, device="cpu"), state)
    return tree_map(place, host, shardings)


def synchronize(state: Any) -> None:
    """Wait for every card that holds a block of ``state``."""
    devices = {t.device for x in tree_leaves(state)
               for t in x.shards.values() if t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


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
