"""AdamW with a warmup + cosine schedule, global-norm clipping, ZeRO-1.

Counterpart of ``repro.optim.adamw`` on trees (nested dicts) of
``ShardedTensor``s laid out on a mesh of data-parallel slices (one slice
included). Like the reference it is functional: ``apply_sharded_updates``
returns new parameters and a new state and leaves its arguments as they
are. The moments are fp32 whatever the parameters' dtype, weight decay is
applied to tensors of two or more dimensions only, and the step is an int32
tensor.

``zero1_logical`` gives each moment the ``zero1`` logical axis (the data
axes) on its largest dimension the parameter's spec leaves unsharded, as
the reference does. ``apply_sharded_updates`` is the update that XLA
derives from that layout in the reference: every slice updates the block of
the parameters its moments hold, then every slice gathers the updated
blocks its parameter block covers (all of them where the parameters are
replicated).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core.sharding import ShardedTensor, read_box
from repro_torch.models.layers import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    zero1: bool = True          # shard moments over the data axes
    # dtype for the cross-slice gradient reduction (None = fp32)
    grad_reduce_dtype: str = None


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), fp32: linear
    warmup to ``lr``, then a cosine to ``min_lr_ratio * lr``."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32."""
    return torch.sqrt(torch.stack(
        [x.float().square().sum() for x in tree_leaves(tree)]).sum())


def _clip_scale(cfg: AdamWConfig, gnorm):
    if cfg.clip_norm is None:
        return None
    return torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)


def _coefficients(cfg: AdamWConfig, step):
    """(lr, 1 - beta1^t, 1 - beta2^t) at the new ``step``, on its device."""
    lr = schedule(cfg, step).to(step.device)
    t = step.float()
    return lr, 1 - cfg.beta1 ** t, 1 - cfg.beta2 ** t


def _update(cfg: AdamWConfig, p, g, mu, nu, coef, scale):
    """One leaf (or block of one): (new p, new mu, new nu)."""
    lr, c1, c2 = coef
    b1, b2 = cfg.beta1, cfg.beta2
    if scale is not None:
        g = g * scale
    g = g.float()
    mu = b1 * mu + (1 - b1) * g
    nu = b2 * nu + (1 - b2) * g.square()
    u = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
    if p.ndim >= 2:   # decoupled weight decay on matrices only
        u = u + cfg.weight_decay * p.float()
    return (p.float() - lr * u).to(p.dtype), mu, nu


@torch.no_grad()
def apply_sharded_updates(cfg: AdamWConfig, params, grads, state):
    """ZeRO-1 AdamW over a mesh. ``params``: ShardedTensors laid out by the
    trainer's rules, replicated over the slices or, as ``FSDP_RULES`` lays
    them out, cut into blocks, and with a model axis split over the model
    coordinates too; ``grads``: the summed gradients, whole tensors on one
    device (the trainer puts each slice's together from its model
    coordinates' blocks, a block they all hold counted once); ``state``:
    ``mu`` and ``nu`` laid out by :func:`state_logical` and a replicated
    ``step``. The gradient norm and the clipping scale come from the whole
    gradients, once, so no replica of a block is counted twice. Each mesh
    coordinate updates the block its moments hold (weight decay by the
    leaf's rank, which a block keeps), reading the parameters on that
    block from whichever blocks hold them: a moment's block need not lie
    inside its coordinate's parameter block (ZeRO-1 may cut another
    dimension than the parameters' rules). Each coordinate's new parameter
    block is then put together from the updated blocks that meet it: the
    replicas gather the whole, a sharded layout its own block. Returns
    (new_params, new_state, {"lr", "grad_norm"}), the metrics on the
    gradients' device."""
    gnorm = global_norm(grads)
    scale = _clip_scale(cfg, gnorm)
    step = state["step"].map(lambda t: t + 1)
    coef = {c: _coefficients(cfg, t) for c, t in step.shards.items()}

    def leaf(p: ShardedTensor, g, mu: ShardedTensor, nu: ShardedTensor):
        updated, mus, nus = {}, {}, {}
        for c, m in mu.shards.items():
            box = mu.index(c)
            updated[c], mus[c], nus[c] = _update(
                cfg, read_box(p, box, c), g[box].to(m.device), m,
                nu.shards[c], coef[c],
                None if scale is None else scale.to(m.device))
        new = ShardedTensor(p.shape, p.dtype, mu.sharding, updated)
        out = {c: updated[c] if mu.index(c) == p.index(c)
               else read_box(new, p.index(c), c) for c in p.shards}
        return (ShardedTensor(p.shape, p.dtype, p.sharding, out),
                ShardedTensor(mu.shape, mu.dtype, mu.sharding, mus),
                ShardedTensor(nu.shape, nu.dtype, nu.sharding, nus))

    res = tree_map(leaf, params, grads, state["mu"], state["nu"])
    new = [tree_map(lambda o, i=i: o[i], res) for i in range(3)]
    first = next(iter(coef))
    return new[0], {"mu": new[1], "nu": new[2], "step": step}, \
        {"lr": coef[first][0].to(gnorm.device), "grad_norm": gnorm}


# -- ZeRO-1 logical specs --------------------------------------------------------


def zero1_logical(param_logical, param_shape, mesh, rules):
    """Moment spec = param spec + 'data' sharding on the largest dim that the
    param spec leaves unsharded and that the data axes divide evenly."""
    data_ways = 1
    for ax in ("pod", "data"):
        if ax in mesh.shape:
            data_ways *= mesh.shape[ax]
    used = rules.spec_for(param_logical, param_shape, mesh)
    best, best_size = None, 0
    for i, (name, dim) in enumerate(zip(param_logical, param_shape)):
        already = i < len(used) and used[i] is not None
        if already or name == "layers":
            continue
        if dim % data_ways == 0 and dim > best_size:
            best, best_size = i, dim
    if best is None:
        return tuple(param_logical)
    out = list(param_logical)
    out[best] = "zero1"
    return tuple(out)


def state_logical(params_logical, params_shapes, mesh, rules,
                  zero1: bool = True):
    """Logical specs for the optimizer state tree."""
    if zero1:
        mom = tree_map(lambda lg, sh: zero1_logical(lg, sh, mesh, rules),
                       params_logical, params_shapes)
    else:
        mom = params_logical
    return {"mu": mom, "nu": mom, "step": ()}
