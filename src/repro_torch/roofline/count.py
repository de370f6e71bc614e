"""Count one step of the port's program on the meta device.

``count_step(fn, *args)`` runs ``fn`` on meta tensors (``device="meta"``:
every kernel route a CUDA tensor takes, the kernels' wrappers allocating
their outputs and workspaces and launching nothing) and returns what the
card would do, per device:

- **flops**: by the formulas ``torch.utils.flop_counter.FlopCounterMode``
  counts with (its ``flop_registry``): aten's for the products, the
  kernel ops' own (``kernels/work.py``, registered with
  ``register_flop_formula``). Each op is counted as it is dispatched, as
  the card runs it: the mode itself would split an op it has no formula
  for (``silu_backward``, say) into its decomposition before the byte
  count saw it. A remat's recompute is counted, the recomputed forward
  too.
- **bytes**: for each dispatched op, the bytes of its tensor inputs plus
  its outputs, each tensor at its own size (a view's, not its storage's);
  a view op, and an op that only allocates, moves nothing; a copy reads
  its source and writes its destination; a kernel op moves what its
  ``*_work`` counts. This describes an eager program, which is what the
  port runs: every op reads its inputs from HBM and writes its outputs
  there, and the count ignores what the L2 cache keeps between ops.
- **peak_bytes**: the most bytes of storage alive at once, followed by
  weak references to each storage the step makes; the arguments' storages
  count as alive from the start, as a TrainState is on the card. A kernel
  op's implementation runs under the count, so its workspace counts while
  the call holds it. The caching allocator's rounding and cuBLAS's
  workspace are not counted.
- **collectives**: the bytes a card sends for the collectives over the
  model axis that the step calls (``core/tensor_parallel.py``, forward
  and backward, a remat's recompute too), by kind, at a ring's bytes
  (``tensor_parallel.ring_bytes``); their ops move no HBM bytes in the
  count.

A step of ``ways`` model coordinates runs them in lockstep, every
coordinate's blocks on the one meta device (``launch/cells.py``): the
coordinates are symmetric, so one card's share of FLOPs, bytes and live
storage is the count over ``ways`` (a leaf every coordinate holds whole is
an argument once per coordinate, as each card holds it). A collective's
bytes are a card's already.

Nothing here builds, loads or launches a kernel, and nothing touches CUDA.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.core import tensor_parallel as tp
from repro_torch.core.sharding import ShardedTensor
from repro_torch.kernels.work import KERNEL_IMPL, KERNEL_WORK

_aten = torch.ops.aten
# ops that only allocate: their outputs are not written
_ALLOCATE = {_aten.empty, _aten.empty_like, _aten.empty_strided,
             _aten.new_empty, _aten.new_empty_strided}
# ops that write their first argument without reading it
_OVERWRITE = {_aten.copy_, _aten.fill_, _aten.zero_}


@dataclasses.dataclass
class StepCount:
    flops: float                  # per device
    bytes: float                  # HBM bytes per device (an eager program)
    peak_bytes: int               # live storage at most, arguments included
    arg_bytes: int                # the arguments' storage
    ops: int                      # ops dispatched
    kernel_flops: Dict[str, float]   # by kernel op
    kernel_calls: Dict[str, int]     # by kernel op
    collectives: Dict[str, float]    # bytes a card sends, by kind


def _tensors(tree):
    """Every tensor of ``tree``, a ShardedTensor's blocks among them."""
    out = []
    for t in tree_leaves(tree):
        if isinstance(t, ShardedTensor):
            out.extend(t.shards.values())
        elif isinstance(t, torch.Tensor):
            out.append(t)
    return out


def _size(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    """Bytes moved and storage alive, op by op."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.live: Dict[int, int] = {}
        self.current = 0
        self.peak = 0
        self.kernel_flops = collections.Counter()
        self.kernel_calls = collections.Counter()
        self.collectives = collections.Counter()
        self.inside = 0           # collectives the ops now run inside

    def enter(self, kind: str, nbytes: float) -> None:
        """A collective starts (``tensor_parallel.collective``)."""
        if not self.inside:
            self.collectives[kind] += nbytes
        self.inside += 1

    def exit(self) -> None:
        self.inside -= 1

    def hold(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self.live:
            return
        n = storage.nbytes()
        self.live[key] = n
        self.current += n
        self.peak = max(self.peak, self.current)
        weakref.finalize(storage, self._free, key)

    def _free(self, key: int) -> None:
        self.current -= self.live.pop(key)

    def _moved(self, func, args, kwargs, out) -> int:
        packet = func._overloadpacket
        if packet in KERNEL_WORK:
            flops, nbytes = KERNEL_WORK[packet](*args, **kwargs)
            self.kernel_flops[str(packet)] += flops
            self.kernel_calls[str(packet)] += 1
            return nbytes
        if func.is_view or packet in _ALLOCATE or self.inside:
            return 0
        inputs = _tensors((args, kwargs))
        if packet in _OVERWRITE:
            inputs = inputs[1:]
        return sum(map(_size, inputs)) + sum(map(_size, _tensors(out)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        impl = KERNEL_IMPL.get(func._overloadpacket)
        if impl is None:
            out = func(*args, **kwargs)
        else:
            # the wrapper's own allocations (a transient workspace too)
            # come back to this mode
            with self:
                out = impl(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        self.ops += 1
        self.bytes += self._moved(func, args, kwargs, out)
        for t in _tensors(out):
            self.hold(t)
        return out


def count_step(fn, *args, ways: int = 1) -> tuple:
    """(fn's result, :class:`StepCount`) of ``fn(*args)`` on meta tensors,
    one card's share of a step of ``ways`` model coordinates in lockstep;
    every tensor leaf of ``args`` counts as alive from the start."""
    counter = _Counter()
    for t in _tensors(args):
        counter.hold(t)
    arg_bytes = counter.current
    tp.WATCHERS.append(counter)
    try:
        with counter:
            result = fn(*args)
    finally:
        tp.WATCHERS.remove(counter)
    return result, StepCount(
        flops=counter.flops / ways, bytes=counter.bytes / ways,
        peak_bytes=round(counter.peak / ways),
        arg_bytes=round(arg_bytes / ways), ops=counter.ops,
        kernel_flops={k: v / ways for k, v in counter.kernel_flops.items()},
        kernel_calls={k: round(v / ways)
                      for k, v in counter.kernel_calls.items()},
        collectives=dict(counter.collectives))
