"""Logical-axis sharding rules (divisibility-aware) and sharded tensors.

Counterpart of ``repro.core.sharding``. Every tensor is annotated with a
*logical spec*: a tuple of logical axis names (or ``None``) per dimension,
e.g. an attention projection ``(embed, heads, head_dim)``. A
:class:`ShardingRules` table maps logical axes to mesh axes. ``spec_for``
resolves a logical spec against a concrete shape and mesh, dropping mesh
axes that do not divide the dimension (a copy of the reference's rule).

Where the reference hands a :class:`NamedSharding` to ``jax.device_put``,
the port holds the result itself: a :class:`ShardedTensor` is a global
shape, its sharding and one tensor per mesh coordinate, on that
coordinate's device. :func:`place` cuts a tensor into one, :func:`gather`
puts one back together, :func:`read_box` reads any box of one.

``activation_rules`` / ``constrain`` pin activations inside a slice under
tensor parallelism (``model`` > 1); without a context they do nothing, as
the reference's. Where the reference's GSPMD derives the collectives from
the pinned layout, the port's ``constrain`` carries them out: the model
runs each sublayer once per model coordinate (``core.tensor_parallel``),
and ``constrain`` adds the coordinates' partial sums where the layout is
whole on every coordinate.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Mapping, Optional, Sequence

import torch

from repro_torch.core.meshes import Mesh

LogicalSpec = tuple  # tuple[str | None, ...]


class PartitionSpec(tuple):
    """One entry per dimension: ``None`` (replicated), a mesh axis name, or
    a tuple of names (the dimension split over their product, the first
    name outermost)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _as_tuple(x) -> tuple:
    if x is None:
        return ()
    if isinstance(x, str):
        return (x,)
    return tuple(x)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Maps logical axis names -> mesh axis name(s)."""

    rules: Mapping[str, tuple]

    def replace(self, **updates) -> "ShardingRules":
        new = dict(self.rules)
        for k, v in updates.items():
            new[k] = _as_tuple(v)
        return ShardingRules(new)

    def mesh_axes_for(self, logical_axis: str | None) -> tuple:
        if logical_axis is None:
            return ()
        return _as_tuple(self.rules.get(logical_axis))

    def spec_for(self, logical: Sequence, shape: Sequence[int],
                 mesh) -> PartitionSpec:
        """Resolve a logical spec to a PartitionSpec for ``shape`` on
        ``mesh`` (only ``mesh.shape`` is read).

        Mesh axes that are missing from the mesh, already used by another
        dimension, or that do not evenly divide the dimension size are
        dropped (replication fallback).
        """
        if len(logical) != len(shape):
            raise ValueError(
                f"logical spec {logical} does not match shape {shape}")
        used: set = set()
        out = []
        for name, dim in zip(logical, shape):
            axes = []
            remaining = dim
            for ax in self.mesh_axes_for(name):
                if ax in used or ax not in mesh.shape:
                    continue
                size = mesh.shape[ax]
                if remaining % size != 0:
                    continue
                axes.append(ax)
                used.add(ax)
                remaining //= size
            if not axes:
                out.append(None)
            elif len(axes) == 1:
                out.append(axes[0])
            else:
                out.append(tuple(axes))
        return P(*out)

    def sharding_for(self, logical: Sequence, shape: Sequence[int],
                     mesh: Mesh) -> "NamedSharding":
        return NamedSharding(mesh, self.spec_for(logical, shape, mesh))


# ---------------------------------------------------------------------------
# Rule tables (copies of the reference's).
#
# "tp_dp" is the paper-faithful baseline: a job owns a set of data-parallel
# slices (the malleable resource) and each slice does tensor parallelism over
# the fixed "model" axis.
# ---------------------------------------------------------------------------

TP_DP_RULES = ShardingRules({
    # activations
    "batch": ("pod", "data"),
    "seq": (),
    "kv_seq": (),            # decode-time KV cache sequence axis
    "embed": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "mlp": ("model",),
    "experts": ("model",),
    "expert_mlp": (),
    "vocab": ("model",),
    "state": (),             # SSM / RG-LRU recurrent state width
    "layers": (),            # stacked scan dimension — never sharded
    "frontend": (),
    "table_embed": (),       # embedding-table model dim (never FSDP)
    "zero1": ("pod", "data"),   # ZeRO-1 optimizer-moment sharding
})

# FSDP-style variant: weights additionally sharded over the data axis.
FSDP_RULES = TP_DP_RULES.replace(embed=("data",))

# Long-context decode (batch too small to shard): shard the KV cache /
# sequence dimension over the data axis.
LONG_CONTEXT_RULES = TP_DP_RULES.replace(
    batch=(), kv_seq=("pod", "data"), seq=("pod", "data"))


def rules_for_shape(shape_name: str, global_batch: int, mesh,
                    base: ShardingRules = TP_DP_RULES) -> ShardingRules:
    """Pick a rule table appropriate for an input-shape family (a copy of
    the reference's): the long-context rules when the batch is too small
    to split over the data slices."""
    data_ways = 1
    for ax in ("pod", "data"):
        if ax in mesh.shape:
            data_ways *= mesh.shape[ax]
    if global_batch < data_ways:
        return LONG_CONTEXT_RULES
    return base


class NamedSharding:
    """A :class:`PartitionSpec` on a :class:`Mesh`."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    def __repr__(self):
        return f"NamedSharding({self.mesh.shape}, {self.spec})"

    def index(self, shape, coord) -> tuple:
        """The block of a tensor of ``shape`` that mesh coordinate ``coord``
        holds: one ``slice`` per dimension."""
        mesh = self.mesh
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        out = []
        for dim, part in zip(shape, spec):
            n, k = 1, 0
            for ax in _as_tuple(part):
                size = mesh.shape[ax]
                n *= size
                k = k * size + coord[mesh.axis_names.index(ax)]
            if dim % n:
                raise ValueError(f"dimension {dim} of {tuple(shape)} does "
                                 f"not divide over {part} ({n} ways)")
            block = dim // n
            out.append(slice(k * block, (k + 1) * block))
        return tuple(out)


class ShardedTensor:
    """A global ``shape`` of ``dtype`` laid out by ``sharding``: ``shards``
    maps each mesh coordinate to its block, a tensor on that coordinate's
    device. Replicated blocks are separate tensors, one per coordinate."""

    def __init__(self, shape, dtype, sharding: NamedSharding, shards: dict):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.sharding = sharding
        self.shards = shards

    def index(self, coord) -> tuple:
        return self.sharding.index(self.shape, coord)

    def map(self, fn) -> "ShardedTensor":
        """``fn`` applied to every block; ``fn`` keeps the block's shape."""
        shards = {c: fn(t) for c, t in self.shards.items()}
        dtype = next(iter(shards.values())).dtype
        return ShardedTensor(self.shape, dtype, self.sharding, shards)

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize

    def __int__(self):
        return int(gather(self))

    def __repr__(self):
        return (f"ShardedTensor({tuple(self.shape)}, {self.dtype}, "
                f"{self.sharding})")


def copy_to(src: torch.Tensor, device) -> torch.Tensor:
    """A new, contiguous buffer on ``device`` holding ``src``."""
    return torch.empty(src.shape, dtype=src.dtype, device=device).copy_(src)


def place(x: torch.Tensor, sharding: NamedSharding) -> ShardedTensor:
    """Cut ``x`` into ``sharding``'s blocks, each copied to its own buffer
    on its coordinate's device."""
    mesh = sharding.mesh
    shards = {c: copy_to(x[sharding.index(x.shape, c)], mesh.device(c))
              for c in mesh.coords()}
    return ShardedTensor(x.shape, x.dtype, sharding, shards)


def zeros(shape, dtype, sharding: NamedSharding) -> ShardedTensor:
    """Zeros laid out by ``sharding``, made on each device in place."""
    mesh = sharding.mesh
    shards = {}
    for c in mesh.coords():
        block = [s.stop - s.start for s in sharding.index(shape, c)]
        shards[c] = torch.zeros(block, dtype=dtype, device=mesh.device(c))
    return ShardedTensor(shape, dtype, sharding, shards)


def relative_index(inner: tuple, outer: tuple) -> tuple:
    """``inner`` (global slices inside ``outer``) as slices of the block
    ``outer``."""
    return tuple(slice(i.start - o.start, i.stop - o.start)
                 for i, o in zip(inner, outer))


def intersect(a: tuple, b: tuple) -> Optional[tuple]:
    """The global slices two boxes share, or None where they do not
    meet."""
    out = []
    for x, y in zip(a, b):
        lo, hi = max(x.start, y.start), min(x.stop, y.stop)
        if lo >= hi:
            return None
        out.append(slice(lo, hi))
    return tuple(out)


def read_box(arr: ShardedTensor, box: tuple, coord) -> torch.Tensor:
    """``arr``'s values on ``box`` (global slices), on ``coord``'s device: a
    view of ``coord``'s own block where that holds the box whole, else a
    new buffer put together from the distinct blocks that meet it. An
    ``arr`` that holds only some coordinates' blocks (one card's view of
    a TrainState, as the dry-run's cells build it) leaves the parts of the
    buffer that the others hold unwritten: a collective brings them."""
    own = arr.index(coord)
    if all(o.start <= b.start and b.stop <= o.stop
           for o, b in zip(own, box)):
        return arr.shards[coord][relative_index(box, own)]
    out = torch.empty([b.stop - b.start for b in box], dtype=arr.dtype,
                      device=arr.sharding.mesh.device(coord))
    for idx, c in distinct_blocks(arr):
        inter = intersect(box, idx)
        if inter is not None and c in arr.shards:
            out[relative_index(inter, box)].copy_(
                arr.shards[c][relative_index(inter, idx)])
    return out


def distinct_blocks(arr: ShardedTensor):
    """(index, coordinate) of each distinct block of ``arr``, the first
    coordinate (row-major) that holds it."""
    seen = {}
    for c in arr.sharding.mesh.coords():
        key = tuple((s.start, s.stop) for s in arr.index(c))
        seen.setdefault(key, (arr.index(c), c))
    return list(seen.values())


def gather(arr: ShardedTensor, device=None) -> torch.Tensor:
    """The global tensor, on ``device`` (default: the first block's)."""
    if device is None:
        device = next(iter(arr.shards.values())).device
    out = torch.empty(arr.shape, dtype=arr.dtype, device=device)
    for idx, c in distinct_blocks(arr):
        out[idx].copy_(arr.shards[c])
    return out


def logical_to_sharding(tree_logical, tree_shapes, mesh: Mesh,
                        rules: ShardingRules):
    """Map a tree of logical specs + matching shapes -> NamedShardings."""
    # imported here: the model's modules import this one
    from repro_torch.models.layers import tree_map
    return tree_map(lambda logical, shape: rules.sharding_for(logical, shape,
                                                              mesh),
                    tree_logical, tree_shapes)


# -- activation sharding constraints -----------------------------------------
#
# The model calls ``constrain(x, logical)`` at the reference's points (block
# boundaries, the embedding, the logits: src/repro/models/transformer.py:69,
# 109,138,239-260, encdec.py:41,50) and where a sublayer's output is a sum
# over the model coordinates' heads or MLP columns (where GSPMD puts its
# all-reduce). It is a no-op unless a (mesh, rules) context is active, set
# by the trainer around each slice's step.

_ACT_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "activation_rules", default=None)


@contextlib.contextmanager
def activation_rules(mesh: Mesh, rules: ShardingRules):
    """Counterpart of the reference's ``activation_rules``
    (src/repro/core/sharding.py:150-156): ``constrain`` pins activations to
    ``rules`` on ``mesh`` inside the context."""
    tok = _ACT_CTX.set((mesh, rules))
    try:
        yield
    finally:
        _ACT_CTX.reset(tok)


def keep_activation_rules(fn):
    """``fn`` run under the activation rules active now, wherever it is
    called later: a remat's recompute runs in the backward pass, which may
    run outside the step's context."""
    ctx = _ACT_CTX.get()

    def run(*args):
        tok = _ACT_CTX.set(ctx)
        try:
            return fn(*args)
        finally:
            _ACT_CTX.reset(tok)

    return run


def model_ways() -> int:
    """The ``model`` extent of the active context's mesh: 1 without one."""
    ctx = _ACT_CTX.get()
    return 1 if ctx is None else ctx[0].shape.get("model", 1)


class _ModelAxis:
    """The model axis alone, as ``ShardingRules.spec_for`` reads a mesh: the
    port runs one slice's step at a time, so a constraint inside it has no
    data axis to pin."""

    def __init__(self, ways: int):
        self.shape = {"model": ways}


def constrain(x, logical):
    """Pin an activation to its logical sharding (no-op without context),
    the counterpart of src/repro/core/sharding.py:159-166.

    Under a context whose mesh has ``model`` > 1, ``x`` is one tensor per
    model coordinate, in coordinate order (``tensor_parallel.Partial``
    where they are partial sums). Where ``rules`` leave the model axis off
    every dimension of ``logical`` (the residual stream, ``("batch",
    "seq", "embed")``), the value is whole on every coordinate: a
    ``Partial`` is summed in coordinate order and one copy of the sum
    lands on each coordinate's device (``tensor_parallel.all_reduce``);
    whole values pass. Where the model axis splits a dimension (the
    logits' ``vocab``), each coordinate's block is the layout already."""
    ways = model_ways()
    if ways == 1:
        return x
    from repro_torch.core import tensor_parallel as tp
    if not isinstance(x, list) or len(x) != ways:
        raise TypeError(f"constrain under {ways} model ways takes one tensor "
                        f"per model coordinate, got {type(x).__name__}")
    _, rules = _ACT_CTX.get()
    spec = rules.spec_for(logical, tuple(x[0].shape), _ModelAxis(ways))
    if all(part is None for part in spec):
        return tp.all_reduce(x) if isinstance(x, tp.Partial) else x
    if isinstance(x, tp.Partial):
        raise NotImplementedError(
            f"a partial sum pinned to {logical}, split over the model axis "
            "(a reduce-scatter): no block of the port's model makes one")
    return x
