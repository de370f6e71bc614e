"""Tensor parallelism inside a slice: the collectives over the ``model`` axis.

The reference has no counterpart: it pins the layout of each activation
(``core.sharding.constrain``) and GSPMD writes the collectives that layout
needs. The port writes them itself, here.

Like the slices, a slice's model coordinates are driven from one process
(``core.meshes``), each with buffers of its own on its device. They run in
lockstep: a block runs its sublayer once per model coordinate, on that
coordinate's blocks of the weights (``model_block``), and then the
coordinates' partial sums are added (``all_reduce``) before anything reads
them. One coordinate cannot run its whole forward before the next, since a
sum over the coordinates needs every coordinate's part at the same point.
All of it is one autograd graph, so the backward of each collective is
autograd's own: the sum hands every part the gradient of the whole, and
the copies of the sum add their gradients back, which is the all-reduce of
the gradients GSPMD writes.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.core.meshes import Mesh, mesh_model_ways
from repro_torch.core.sharding import (NamedSharding, PartitionSpec,
                                       ShardedTensor, _as_tuple)

ITEM_12 = "ROADMAP.md, Queue 1 item 12"


class Partial(list):
    """One partial sum per model coordinate, in coordinate order, each on
    its coordinate's device: the value is their sum. A plain list of one
    tensor per coordinate is a value each coordinate holds whole (or its
    block of, where the layout splits it)."""


def all_reduce(parts) -> List[torch.Tensor]:
    """The sum of ``parts`` in coordinate order, on the first coordinate's
    device, and a copy of it on every other coordinate's device (its own
    buffer, even where virtual coordinates share a card): deterministic,
    and the same on one card or on N."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return [total] + [total.to(p.device, copy=True) for p in parts[1:]]


def all_gather(parts, dim: int) -> torch.Tensor:
    """The coordinates' blocks of a tensor split over the model axis along
    ``dim`` (the logits' vocab), put together in coordinate order on the
    first coordinate's device."""
    home = parts[0].device
    return torch.cat([p.to(home) for p in parts], dim=dim)


def model_spec(sharding: NamedSharding) -> NamedSharding:
    """``sharding`` with only its ``model`` axis: every dimension whole over
    the data axes."""
    spec = []
    for part in sharding.spec:
        axes = tuple(ax for ax in _as_tuple(part) if ax == "model")
        spec.append(axes[0] if axes else None)
    return NamedSharding(sharding.mesh, PartitionSpec(*spec))


def model_block(x: ShardedTensor, coord) -> tuple:
    """The box (global slices) of ``x`` that mesh coordinate ``coord`` holds
    over the model axis alone, ``NamedSharding.index`` on that axis: its
    block of the heads, the MLP columns or the vocab, whole over the data
    axes (``FSDP_RULES`` gathers it over them before the step)."""
    return model_spec(x.sharding).index(x.shape, coord)


def slices_of(mesh: Mesh) -> List[list]:
    """The coordinates of each data-parallel slice, in slice order, each
    slice's model coordinates in order (``model`` is the mesh's last
    axis)."""
    coords = mesh.coords()
    m = mesh_model_ways(mesh)
    return [coords[i:i + m] for i in range(0, len(coords), m)]


def refuse(what: str):
    """Raise for a part of a model that tensor parallelism does not cover
    yet."""
    raise NotImplementedError(
        f"{what} under tensor parallelism inside a slice (model_ways > 1) is "
        f"not ported yet ({ITEM_12})")
