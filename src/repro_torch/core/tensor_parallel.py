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
All of it is one autograd graph. Each collective is an autograd Function
whose backward is the collective GSPMD writes for the gradients: an
all-reduce's copies add their gradients back (an all-reduce), and the
blocks of a leaf put together take their shares of its gradient (a
reduce-scatter).

Each collective runs inside :func:`collective`, which tells the watchers
(``roofline/count.py``, counting a step on the meta device) its kind and
the bytes a card sends for it on N cards (a ring's): the count files them
as collectives, not as HBM traffic.
"""
from __future__ import annotations

import contextlib
from typing import List

import torch

from repro_torch.core.meshes import Mesh, mesh_model_ways
from repro_torch.core.sharding import (NamedSharding, PartitionSpec,
                                       ShardedTensor, _as_tuple)

# the counters of ``roofline/count.py`` that are counting a step now
WATCHERS: list = []


def ring_bytes(kind: str, nbytes: int, ways: int) -> float:
    """Bytes a card sends, in a ring over ``ways`` cards, for a collective
    of ``kind`` over ``nbytes``: an all-reduce's partial sums (a
    reduce-scatter and an all-gather), or the whole that an all-gather puts
    together, a reduce-scatter cuts up or a broadcast or a reduce copies
    out from one card."""
    if ways < 2:
        return 0.0
    share = (ways - 1) / ways * nbytes
    return 2 * share if kind == "all-reduce" else share


@contextlib.contextmanager
def collective(kind: str, nbytes: int, ways: int):
    """The ops inside make one collective of ``kind`` over the model
    axis, ``nbytes`` as :func:`ring_bytes` reads them; the watchers hear
    of it (none outside a count)."""
    for w in WATCHERS:
        w.enter(f"{kind} (model axis)", ring_bytes(kind, nbytes, ways))
    try:
        yield
    finally:
        for w in WATCHERS:
            w.exit()


def _size(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Partial(list):
    """One partial sum per model coordinate, in coordinate order, each on
    its coordinate's device: the value is their sum. A plain list of one
    tensor per coordinate is a value each coordinate holds whole (or its
    block of, where the layout splits it)."""


def _sum_copies(parts) -> list:
    """The all-reduce itself: the sum in coordinate order on the first
    coordinate's device, a copy of it on each other's."""
    with collective("all-reduce", _size(parts[0]), len(parts)):
        total = parts[0]
        for p in parts[1:]:
            total = total + p.to(total.device)
        return [total] + [total.to(p.device, copy=True) for p in parts[1:]]


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *parts):
        return tuple(_sum_copies(parts))

    @staticmethod
    def backward(ctx, *grads):
        return tuple(_sum_copies(grads))


def all_reduce(parts) -> List[torch.Tensor]:
    """The sum of ``parts`` in coordinate order, on the first coordinate's
    device, and a copy of it on every other coordinate's device (its own
    buffer, even where virtual coordinates share a card): deterministic,
    and the same on one card or on N. Its backward is the same all-reduce
    of the copies' gradients."""
    return list(_AllReduce.apply(*parts))


class _Gather(torch.autograd.Function):
    """The blocks put together on the first block's device (``copies``:
    and a copy of the whole on each other's); the backward adds the
    copies' gradients and cuts the sum into the blocks' shares, each on
    its block's device."""

    @staticmethod
    def forward(ctx, dim, copies, *parts):
        ctx.dim = dim
        ctx.blocks = [(p.shape[dim], p.device) for p in parts]
        home = parts[0].device
        with collective("all-gather", sum(map(_size, parts)), len(parts)):
            out = torch.cat([p.to(home) for p in parts], dim=dim)
            if not copies:
                return out
            return (out,) + tuple(out.to(p.device, copy=True)
                                  for p in parts[1:])

    @staticmethod
    def backward(ctx, *grads):
        total = grads[0]
        with collective("reduce-scatter", _size(total), len(ctx.blocks)):
            for g in grads[1:]:
                total = total + g.to(total.device)
            out, lo = [], 0
            for n, dev in ctx.blocks:
                out.append(total.narrow(ctx.dim, lo, n).to(dev))
                lo += n
        return (None, None) + tuple(out)


def all_gather(parts, dim: int) -> torch.Tensor:
    """The coordinates' blocks of a tensor split over the model axis along
    ``dim`` (the logits' vocab), put together in coordinate order on the
    first coordinate's device; its backward gives each block its share of
    the whole's gradient."""
    return _Gather.apply(dim, False, *parts)


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


def is_split(block: torch.Tensor, whole_shape) -> bool:
    """Whether a coordinate's ``block`` of a leaf is a block of it (the
    rules split one of its axes over the model axis) rather than the whole
    leaf: its shape against the whole shape of the leaf's spec."""
    return tuple(block.shape) != tuple(whole_shape)


def whole(blocks, whole_shape) -> List[torch.Tensor]:
    """Each coordinate's copy of a leaf whole: the leaf itself where every
    coordinate holds it whole, else its blocks put together along the axis
    the rules split (``all_gather``), inside the autograd graph, so that
    each block's gradient is its share of the whole leaf's."""
    if not is_split(blocks[0], whole_shape):
        return list(blocks)
    dim = next(d for d, (b, n) in enumerate(zip(blocks[0].shape,
                                                whole_shape)) if b != n)
    return list(_Gather.apply(dim, True, *blocks))


def whole_tree(parts, specs) -> list:
    """``whole`` over every leaf of each coordinate's parameter tree
    (``specs``: the tree's ParamSpecs, which carry the whole shapes)."""
    if isinstance(specs, dict):
        subs = {k: whole_tree([p[k] for p in parts], v)
                for k, v in specs.items()}
        return [{k: subs[k][m] for k in specs} for m in range(len(parts))]
    return whole(parts, specs.shape)


def run_whole(parts, xs, specs, run):
    """A sublayer whose leaves the rules do not split on the boundaries its
    computation needs, run whole: ``run(params, x)`` -> (y, extra) once,
    on the first coordinate's leaves put together (``whole_tree``; the
    gradients reach every coordinate's blocks) and its input; y copied to
    every other coordinate (no partial sum). -> (ys, False, extra)."""
    y, extra = run(whole_tree(parts, specs)[0], xs[0])
    with collective("broadcast", _size(y), len(xs)):
        copies = [y.to(x.device, copy=True) for x in xs[1:]]
    return [y] + copies, False, extra
