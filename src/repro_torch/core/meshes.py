"""Meshes of data-parallel slices and elastic resizing helpers.

Counterpart of ``repro.core.meshes``. A job's allocation is a set of
data-parallel slices: the mesh is ``(data, model)`` (optionally ``(pod,
data, model)``) and malleability resizes the ``data`` (and ``pod``) extent
while ``model``, the ways inside a slice, stays fixed: the paper's fixed
cores per node and variable node count.

A :class:`Mesh` is an array of ``torch.device`` with axis names. Like the
reference, which drives every device from one process, one process drives
every slice. A slice owns its own buffers on its device, and a device may
appear more than once: :func:`slice_devices` gives ``n`` *virtual slices*
of one card (NCCL takes one rank per card, and gloo would move the card's
tensors through the host), as the reference's tests give 8 host devices of
one CPU. Slices are told apart by their mesh coordinate, never by their
device. Each entry also carries its ``id``, its position in the list of
devices the job's meshes are drawn from (the counterpart of a JAX device's
``id``): two entries with one id are one device, even where virtual slices
share a card, and the reshard keeps a block in place only on its own id.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device


class Mesh:
    """``devices``: an object array of ``torch.device``, one axis per name;
    ``ids``: an int array of the same shape, each entry's position in the
    device list (default: row-major order)."""

    def __init__(self, devices: np.ndarray, axis_names, ids=None):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of rank {devices.ndim} given axis names "
                             f"{axis_names}")
        self.devices = devices
        self.ids = (np.arange(devices.size).reshape(devices.shape)
                    if ids is None else np.asarray(ids).reshape(devices.shape))
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self._coords = list(np.ndindex(*devices.shape))

    def coords(self):
        """Every mesh coordinate, in row-major order (a slice's coordinate
        along the data axes is its rank among the slices)."""
        return list(self._coords)

    def device(self, coord) -> torch.device:
        return self.devices[coord]

    def id(self, coord) -> int:
        return int(self.ids[coord])

    @property
    def key(self) -> tuple:
        """The mesh's structure, hashable: axis names, shape, ids and
        devices. Meshes with one key lay tensors out alike, however often
        they are built (the reshard caches its programs by it)."""
        key = self.__dict__.get("_key")
        if key is None:
            key = self._key = (self.axis_names, self.devices.shape,
                               tuple(int(i) for i in self.ids.flat),
                               tuple(self.devices.flat))
        return key

    def __repr__(self):
        return (f"Mesh({self.shape}, {list(self.devices.flat)}, "
                f"ids {self.ids.ravel().tolist()})")


def visible_devices():
    """The visible cards, ``cuda:0 .. cuda:N-1`` (raises without one)."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _indexed(device) -> torch.device:
    """``device`` with its index: a tensor's ``.device`` is ``cuda:0``,
    never ``cuda``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def slice_devices(n: int, device=DEFAULT_DEVICE):
    """``n`` virtual slices of one device: the device ``n`` times. Each
    slice placed on it keeps buffers of its own."""
    return [_indexed(resolve_device(device))] * n


def _mesh(ids, data: int, model: int, pod: int, devices) -> Mesh:
    """The mesh whose entries, in row-major order, are ``devices[i]`` for
    each ``i`` of ``ids``."""
    if max(ids, default=-1) >= len(devices):
        raise ValueError(f"need {len(ids)} devices, have {len(devices)}")
    arr = np.empty(len(ids), dtype=object)
    arr[:] = [_indexed(devices[i]) for i in ids]
    if pod > 1:
        shape, names = (pod, data, model), ("pod", "data", "model")
    else:
        shape, names = (data, model), ("data", "model")
    return Mesh(arr.reshape(shape), names, np.asarray(ids).reshape(shape))


def make_mesh(data: int, model: int, pod: int = 1, devices=None) -> Mesh:
    """Build a mesh of ``pod*data*model`` devices.

    Uses the first ``pod*data*model`` entries of ``devices`` (defaults to
    the visible cards), so that meshes of different ``data`` extents share
    a device prefix.
    """
    if devices is None:
        devices = visible_devices()
    return _mesh(list(range(pod * data * model)), data, model, pod, devices)


def mesh_num_slices(mesh: Mesh) -> int:
    """Number of data-parallel slices (the malleable resource count)."""
    n = 1
    for ax in ("pod", "data"):
        if ax in mesh.shape:
            n *= mesh.shape[ax]
    return n


def mesh_model_ways(mesh: Mesh) -> int:
    return mesh.shape.get("model", 1)


def resized_mesh(mesh: Mesh, new_slices: int, devices=None) -> Mesh:
    """A mesh with ``new_slices`` data-parallel slices, placed as the
    Listing-3 plans (``core.redistribute``) assume, so that each of their
    local transfers stays on its device.

    Expanding ``p`` slices by a factor ``f`` puts new slice ``r*f`` on old
    slice ``r``'s devices and new slices ``r*f+1 .. r*f+f-1`` on devices
    of ``devices`` the mesh does not use, in order (the paper reuses the
    original nodes on expansion, §5.2.1). Shrinking by ``f`` keeps old
    slice ``r*f``'s devices as new slice ``r``. Sizes that are not
    multiples of each other take the prefix of ``devices``, as
    :func:`make_mesh`. Multi-pod meshes keep the pod axis as long as
    ``new_slices`` divides by the pod count; otherwise they collapse to a
    single-pod mesh.
    """
    model = mesh_model_ways(mesh)
    pods = mesh.shape.get("pod", 1)
    if devices is None:
        devices = visible_devices()
    old = mesh.ids.reshape(-1, model).tolist()   # one row per slice
    p, q = len(old), new_slices
    if q % p == 0:
        used = set(mesh.ids.flat)
        fresh = [i for i in range(len(devices)) if i not in used]
        rows = []
        for r in range(p):
            rows.append(old[r])
            for _ in range(q // p - 1):
                rows.append(fresh[:model])
                fresh = fresh[model:]
        if any(len(row) < model for row in rows):
            raise ValueError(f"need {q * model} devices, have "
                             f"{len(devices)}")
    elif p % q == 0:
        rows = [old[r * (p // q)] for r in range(q)]
    else:
        rows = [list(range(k * model, (k + 1) * model)) for k in range(q)]
    ids = [i for row in rows for i in row]
    if pods > 1 and q % pods == 0:
        return _mesh(ids, q // pods, model, pods, devices)
    return _mesh(ids, q, model, 1, devices)


def slice_of_rank(mesh: Mesh, rank: int) -> int:
    """Index of the data-parallel slice that the ``rank``-th entry of the
    mesh's devices (in row-major order) belongs to. The reference takes the
    device itself; here a device can stand for several slices, so the
    entry is named by its position."""
    return rank // mesh_model_ways(mesh)
