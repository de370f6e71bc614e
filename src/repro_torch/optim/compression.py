"""Gradient compression for the data-parallel all-reduce.

Counterpart of ``repro.optim.compression``: int8 block-quantized gradient
sync with error feedback. Each data-parallel slice quantizes its local
gradient to int8 with one fp32 scale per block of 256 elements, the slices
sum the int8 payload in int32, dequantize, and each keeps its quantization
residual to add into its next step's gradient (error feedback). The scale
of a block is the largest over the slices (the reference's ``pmax``), so
the int32 sum is exact and only each slice's own rounding remains, which
the feedback carries. The payload a slice sends is an int8 per element and
an fp32 scale per 256: 0.254 times fp32's bytes.

The reference runs inside ``shard_map``, one local value per mesh
coordinate, and its collectives are ``pmax`` and ``psum`` over the mesh's
data axes. The port drives every coordinate from one process
(``core.meshes``), so :func:`compressed_psum_grads` takes what the port's
trainer holds before it sums the slices' gradients: a list of gradient
trees in the order of ``mesh.coords()``, each on its coordinate's device.
With ``model`` > 1 (tensor parallelism inside a slice) a coordinate's tree
holds its model block of every leaf, as the reference's ``shard_map``
hands it out, and the sum runs over the data axes only, once per model
coordinate. The max and the
int32 sum are taken in slice order on the first slice's device of each
group and copied back, so every slice gets a buffer of its own (between
virtual slices of one card these are on-card copies). It is elementwise
fp32 arithmetic and an exact integer sum, the same on any device.
Rounding is half to even (``torch.round``, as ``jnp.round``).
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.core.meshes import Mesh
from repro_torch.core.sharding import copy_to
from repro_torch.models.layers import tree_leaves, tree_map

BLOCK = 256
# The reference runs the all-reduce under jit, where XLA turns the division
# by the constant 127 into a product with its fp32 reciprocal (not always
# the correctly rounded quotient); the all-reduce does the same, so its
# scales are the reference's bit for bit. ``_quantize``, which the
# reference calls eagerly, divides.
INV_127 = 1.0 / 127.0


def _blocks(g: torch.Tensor) -> torch.Tensor:
    """``g`` flattened, zero-padded to whole blocks, as (n_blocks, BLOCK)."""
    flat = g.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    return torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 blocks, fp32 scales (n_blocks, 1)): scale = max|block| /
    127, q = round(block / max(scale, 1e-12))."""
    blocks = _blocks(g)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(blocks / scale.clamp_min(1e-12)).to(torch.int8)
    return q, scale


def _dequantize(q, scale, shape, size):
    flat = (q.float() * scale).reshape(-1)[:size]
    return flat.reshape(shape)


def _residual(g, q, scale):
    """``g - dequantize(q)`` rounded once, as a fused multiply-add gives
    it: the reference's XLA contracts the product and the difference into
    one FMA. In fp64 both are exact (q has 8 bits and the scale 24, and g
    lies within 128 scales of q * scale), so one rounding to fp32 is
    the FMA's."""
    prod = (q.double() * scale.double()).reshape(-1)[:g.numel()]
    return (g.double() - prod.reshape(g.shape)).float()


def _groups(mesh: Mesh, axes) -> List[List[int]]:
    """Positions in ``mesh.coords()`` of the slices each all-reduce over
    ``axes`` joins: those equal along every other axis, in order."""
    keep = [i for i, ax in enumerate(mesh.axis_names) if ax not in axes]
    groups = {}
    for i, c in enumerate(mesh.coords()):
        groups.setdefault(tuple(c[k] for k in keep), []).append(i)
    return list(groups.values())


def _sync_group(gs, es, n: int):
    """One leaf over one group of slices: ``gs`` and ``es`` the slices'
    gradients and residuals. -> the slices' means and new residuals, each
    on its slice's device."""
    gs = [g.float() + e for g, e in zip(gs, es)]
    blocks = [_blocks(g) for g in gs]
    home = gs[0].device
    # the shared per-block scale (pmax): the int8 sum is exact
    scale = None
    for b in blocks:
        local = (b.abs().amax(dim=1, keepdim=True) * INV_127).clamp_min(
            1e-12)
        local = local.to(home)
        scale = local if scale is None else torch.maximum(scale, local)
    means, errs, total = [], [], None
    for g, b in zip(gs, blocks):
        s = scale.to(g.device)
        q = torch.clamp(torch.round(b / s), -127, 127).to(torch.int8)
        errs.append(_residual(g, q, s))
        q32 = q.to(home).to(torch.int32)
        total = q32 if total is None else total + q32
    mean = _dequantize(total, scale, gs[0].shape, gs[0].numel()) / n
    means = [copy_to(mean, g.device) for g in gs]
    return means, errs


def compressed_psum_grads(grads, mesh: Mesh, axes=("pod", "data"),
                          errors=None):
    """All-reduce per-slice gradients with int8 compression and error
    feedback.

    grads: a list of gradient trees (nested dicts of tensors), one per
    entry of ``mesh.coords()``, each on that coordinate's device (with a
    model axis, each coordinate's blocks); errors: the fp32 residuals of
    the last call in the same form, or None (zeros). Only the axes of
    ``axes`` that the mesh has count; a group is the coordinates equal
    along every other axis (one model coordinate of every slice). Returns
    (means, errors), lists of trees in the same order and on the same
    devices: every coordinate of a group gets the group's mean, and its own
    residual.
    """
    coords = mesh.coords()
    if len(grads) != len(coords):
        raise ValueError(f"{len(grads)} gradient trees for a mesh of "
                         f"{len(coords)} slices")
    axes = tuple(ax for ax in axes if ax in mesh.shape)
    n = 1
    for ax in axes:
        n *= mesh.shape[ax]
    if errors is None:
        errors = [tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                           g) for g in grads]
    means, errs = [None] * len(grads), [None] * len(grads)
    for group in _groups(mesh, axes):
        k = len(group)
        # each leaf -> (the group's means, its residuals), a tuple: a leaf
        synced = tree_map(lambda *ge: _sync_group(ge[:k], ge[k:], n),
                          *[grads[i] for i in group],
                          *[errors[i] for i in group])
        for j, i in enumerate(group):
            means[i] = tree_map(lambda o, j=j: o[0][j], synced)
            errs[i] = tree_map(lambda o, j=j: o[1][j], synced)
    return means, errs


def make_compressed_allreduce(mesh: Mesh, param_specs):
    """The callable ``(per-slice grads, errors) -> (means, errors)`` of
    :func:`compressed_psum_grads` over ``mesh``'s data axes ("pod",
    "data") only. ``param_specs``: the parameters' shardings (a tree of
    ``NamedSharding``), which must be on ``mesh``; each coordinate's tree
    holds the blocks they give it over the model axis
    (``tensor_parallel.model_block``), every parameter whole with one way
    inside a slice."""
    for spec in tree_leaves(param_specs):
        if spec.mesh is not mesh:
            raise ValueError("param_specs are not shardings on this mesh")
    axes = tuple(ax for ax in ("pod", "data") if ax in mesh.shape)

    def allreduce(grads, errors=None):
        return compressed_psum_grads(grads, mesh, axes=axes, errors=errors)

    return allreduce
