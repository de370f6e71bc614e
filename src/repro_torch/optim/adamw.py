"""AdamW with a warmup + cosine schedule and global-norm clipping.

Counterpart of ``repro.optim.adamw`` on trees (nested dicts) of tensors.
Like the reference it is functional: ``apply_updates`` returns new
parameters and a new state and leaves its arguments as they are. The
moments are fp32 whatever the parameters' dtype, weight decay is applied to
tensors of two or more dimensions only, and the step is an int32 tensor.

The reference's ZeRO-1 layout (``zero1_logical``, ``state_logical``) needs
the sharding rules, which come with resharding (ROADMAP.md, Queue 1 item
2); ``AdamWConfig.zero1`` is accepted and has no effect on one rank, as the
moments of one rank are whole.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

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


def init_state(params) -> dict:
    """Zero fp32 moments beside each parameter, and step 0."""
    def zeros():
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)
    device = tree_leaves(params)[0].device
    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32."""
    return torch.sqrt(torch.stack(
        [x.float().square().sum() for x in tree_leaves(tree)]).sum())


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state):
    """Returns (new_params, new_state, {"lr", "grad_norm"})."""
    step = state["step"] + 1
    lr = schedule(cfg, step).to(step.device)
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)

    b1, b2 = cfg.beta1, cfg.beta2
    t = step.float()
    c1 = 1 - b1 ** t
    c2 = 1 - b2 ** t

    def upd(p, g, mu, nu):
        if scale is not None:
            g = g * scale
        g = g.float()
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g.square()
        u = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
        if p.ndim >= 2:   # decoupled weight decay on matrices only
            u = u + cfg.weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype), mu, nu

    out = tree_map(upd, params, grads, state["mu"], state["nu"])
    new = [tree_map(lambda o, i=i: o[i], out) for i in range(3)]
    return new[0], {"mu": new[1], "nu": new[2], "step": step}, \
        {"lr": lr, "grad_norm": gnorm}
