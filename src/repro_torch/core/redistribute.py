"""Factor-based data redistribution plans (Listing 3 / Fig. 2) and slice
migration.

Counterpart of ``repro.core.redistribute``. The paper's programming model
redistributes data homogeneously: an *expand* by factor ``f`` splits each of
the ``P`` old ranks' data into ``f`` chunks, chunk ``i`` of old rank ``r``
going to new rank ``r*f + i`` (Fig. 2a); a *shrink* by factor ``f`` groups
ranks in blocks of ``f``, the last member of each block (the *receiver*)
collecting the other ``f-1`` *senders'* data (Fig. 2b) and continuing as new
rank ``r // f``.

- :func:`expand_plan` / :func:`shrink_plan` — explicit transfer plans (src
  slice, dst slice, bytes), copied from the reference (host math).
  :func:`repro_torch.core.reshard.reshard` carries them out.
- :func:`transfer_time_s` — the Fig.-3 cost model (a copy).
- :func:`migrate_slice` — a swap of two slices' shards (straggler
  mitigation: the slice *count* is unchanged, membership rotates).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

from repro_torch.core.meshes import Mesh
from repro_torch.core.sharding import ShardedTensor, copy_to


@dataclasses.dataclass(frozen=True)
class Transfer:
    src: int          # old-configuration slice id
    dst: int          # new-configuration slice id
    nbytes: int
    local: bool       # True when src slice maps onto the same devices


def _check_factor(p: int, q: int) -> int:
    big, small = max(p, q), min(p, q)
    if small <= 0 or big % small:
        raise ValueError(f"sizes {p}->{q} are not multiple/divisor related")
    return big // small


def expand_plan(p: int, q: int, nbytes: int) -> List[Transfer]:
    """P -> Q = P*f slices. Old rank r keeps chunk 0 locally (original nodes
    are reused, §5.2.1) and sends chunks 1..f-1 out."""
    f = _check_factor(p, q)
    if q < p:
        raise ValueError("expand requires q > p")
    chunk = nbytes // q  # bytes per new slice (global nbytes)
    plan = []
    for r in range(p):
        for i in range(f):
            dst = r * f + i
            plan.append(Transfer(src=r, dst=dst, nbytes=chunk,
                                 local=(i == 0)))
    return plan


def shrink_plan(p: int, q: int, nbytes: int) -> List[Transfer]:
    """P -> Q = P/f slices. Receivers are ranks with r % f == f-1
    (Listing 3: ``sender = (rank % f) < f-1``); receiver r continues as new
    rank r // f."""
    f = _check_factor(p, q)
    if q > p:
        raise ValueError("shrink requires q < p")
    chunk = nbytes // p  # bytes per old slice
    plan = []
    for r in range(p):
        receiver = f * (r // f + 1) - 1           # Listing 3 line 19
        new_rank = r // f
        plan.append(Transfer(src=r, dst=new_rank, nbytes=chunk,
                             local=(r == receiver)))
    return plan


# -- Fig. 3 cost model -------------------------------------------------------

def plan_stats(plan: List[Transfer]) -> Tuple[int, int]:
    """``(participants, busiest_link_bytes)`` of a transfer plan.

    These are the two features the Fig.-3 cost model (and the calibration
    fitter in :mod:`repro.calib.fit`) is linear in: the busiest per-slice
    link bounds the transfer, the participant count drives the shrink
    synchronization barrier.
    """
    send = {}
    recv = {}
    participants = set()
    for t in plan:
        participants.add(t.src)
        participants.add(t.dst)
        if t.local:
            continue
        send[t.src] = send.get(t.src, 0) + t.nbytes
        recv[t.dst] = recv.get(t.dst, 0) + t.nbytes
    busiest = max([*send.values(), *recv.values(), 0])
    return len(participants), busiest


def transfer_time_s(plan: List[Transfer], *, link_bw: float,
                    latency_s: float = 0.0,
                    sync_s_per_participant: float = 0.0) -> float:
    """Completion time of a redistribution plan.

    Each slice sends/receives over its own link at ``link_bw`` B/s; the plan
    completes when the busiest link drains.  ``sync_s_per_participant``
    models the shrink barrier (ACK collection at the management node,
    §5.2.2) — the paper observes shrinks cost more synchronization the
    larger the participant-count gap.
    """
    participants, busiest = plan_stats(plan)
    return latency_s + busiest / link_bw + \
        sync_s_per_participant * participants


# -- In-mesh slice migration (straggler path) -------------------------------

def migrate_slice(x: ShardedTensor, mesh: Mesh, src: int, dst: int,
                  axis: str = "data") -> ShardedTensor:
    """Swap the shards held by slices ``src`` and ``dst`` along ``axis``.

    Data moves, the logical layout (sharding) is unchanged: the block at
    coordinate ``i`` along ``axis`` of the result is the old block of the
    slice it swapped with, copied to a new buffer on its own device (the
    reference's one bidirectional ``ppermute``); every other block stays as
    it is.
    """
    if x.sharding.mesh is not mesh:
        raise ValueError("x is not laid out on this mesh")
    n = mesh.shape[axis]
    if not (0 <= src < n and 0 <= dst < n):
        raise ValueError(f"slices {src}, {dst} outside {axis} of {n}")
    at = mesh.axis_names.index(axis)
    shards = {}
    for coord, block in x.shards.items():
        i = coord[at]
        j = dst if i == src else (src if i == dst else i)
        if j == i:
            shards[coord] = block
        else:
            peer = coord[:at] + (j,) + coord[at + 1:]
            shards[coord] = copy_to(x.shards[peer], mesh.device(coord))
    return ShardedTensor(x.shape, x.dtype, x.sharding, shards)
