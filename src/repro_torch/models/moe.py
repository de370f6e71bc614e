"""Mixture-of-Experts feed-forward: top-k routing, capacity dispatch, shared
experts.

Counterpart of ``repro.models.moe``. Experts are stacked ``(E, D, F)``;
routing is per batch row with capacity ``C = ceil(S k / E * factor)`` slots
per expert (at least 8, at most S), and a token's choices past its expert's
capacity drop to the residual path (Switch). The reference computes all of
it in XLA, outside any Pallas kernel, so it stays plain torch here: the
router, the dispatch by gathers, and the three expert products as batched
matrix products (``torch.einsum``).

Which choices drop is fixed by a cumulative count over the ``S * k``
choices of a row, flattened token-major, as in the reference. The
reference's dispatch scatters into ``E * C + 1`` slots whose last takes
every overflow and is cut off; the scatter here does the same, so duplicate
indices land only in that discarded slot. The reference's combine adds
each slot's output into its token (``y.at[disp].add``); here each (token,
choice) gathers its slot's output (zero when the choice dropped) and the
``k`` of a token are summed in choice order: the same function, without an
atomic scatter-add whose order changes from run to run on the card.

Supports DeepSeekMoE's fine-grained layout (64 routed top-6 + 2 shared
experts, first layer dense) and Phi-3.5-MoE (16 routed top-2).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamSpec, act_fn, mlp_apply, mlp_specs


def moe_specs(cfg) -> Dict[str, Any]:
    e, f, ne = cfg.d_model, cfg.expert_d_ff or cfg.d_ff, cfg.num_experts
    specs = {
        "router": ParamSpec((e, ne), ("embed", "experts")),
        "w_gate": ParamSpec((ne, e, f), ("experts", "embed", "expert_mlp")),
        "w_up": ParamSpec((ne, e, f), ("experts", "embed", "expert_mlp")),
        "w_down": ParamSpec((ne, f, e), ("experts", "expert_mlp", "embed")),
    }
    if cfg.num_shared_experts:
        specs["shared"] = mlp_specs(
            cfg, d_ff=cfg.num_shared_experts * (cfg.expert_d_ff or cfg.d_ff))
    return specs


def capacity(cfg, seq: int, factor: float = 1.25) -> int:
    c = math.ceil(seq * cfg.top_k / cfg.num_experts * factor)
    return max(8, min(c, seq))


def route(params, x, cfg):
    """The router: fp32 probabilities (B, S, E), the top-k experts (B, S, k)
    with their renormalised weights, and the Switch load-balancing loss
    ``coef * E * sum_e f_e P_e``."""
    ne = cfg.num_experts
    logits = (x @ params["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                     # (B,S,E)
    weights, experts = torch.topk(probs, cfg.top_k, dim=-1)   # (B,S,k)
    weights = weights / weights.sum(-1, keepdim=True)
    f_e = F.one_hot(experts, ne).float().sum(2).mean((0, 1))  # routed share
    p_e = probs.mean((0, 1))
    aux = cfg.router_aux_coef * ne * (f_e * p_e).sum()
    return probs, experts, weights, aux


def dispatch_slots(experts, ne: int, cap: int):
    """Each choice's slot: ``expert * cap + its rank among the row's choices
    of that expert``, counted over the (token, choice) pairs flattened
    token-major, or the overflow slot ``ne * cap`` past the capacity.
    experts: (B, S, k) -> (B, S k) int64."""
    bsz = experts.shape[0]
    flat_e = experts.reshape(bsz, -1)                         # (B,S*k)
    pos = torch.cumsum(F.one_hot(flat_e, ne), dim=1) - 1      # rank per expert
    my_pos = pos.gather(-1, flat_e[..., None])[..., 0]
    return torch.where(my_pos < cap, flat_e * cap + my_pos,
                       torch.full_like(flat_e, ne * cap))


def moe_apply(params, x, cfg, capacity_factor: float = None):
    """x: (B, S, E) -> (y, aux_loss)."""
    bsz, s, d = x.shape
    ne, k = cfg.num_experts, cfg.top_k
    if capacity_factor is None:
        capacity_factor = cfg.capacity_factor
    cap = capacity(cfg, s, capacity_factor)
    dt = x.dtype

    _, experts, weights, aux = route(params, x, cfg)
    slot = dispatch_slots(experts, ne, cap)                   # (B,S*k)
    token = (torch.arange(s * k, device=x.device) // k).expand(bsz, -1)
    # slot -> token (s: the zero row past the sequence) and its weight; the
    # last slot takes every overflow and is cut off
    disp = torch.full((bsz, ne * cap + 1), s, dtype=torch.int64,
                      device=x.device).scatter_(1, slot, token)[:, :-1]
    disp_w = torch.zeros((bsz, ne * cap + 1), dtype=dt, device=x.device
                         ).scatter_(1, slot, weights.reshape(bsz, -1).to(dt)
                                    )[:, :-1]

    x_pad = torch.cat([x, x.new_zeros((bsz, 1, d))], dim=1)
    expert_in = x_pad.gather(1, disp[..., None].expand(-1, -1, d)).reshape(
        bsz, ne, cap, d)
    act = act_fn(cfg.act)
    h = act(torch.einsum("becd,edf->becf", expert_in,
                         params["w_gate"].to(dt))) * \
        torch.einsum("becd,edf->becf", expert_in, params["w_up"].to(dt))
    expert_out = torch.einsum("becf,efd->becd", h, params["w_down"].to(dt))
    expert_out = expert_out.reshape(bsz, ne * cap, d) * disp_w[..., None]

    # combine: each choice's slot output (the overflow slot reads zeros),
    # summed over a token's k choices in choice order
    out_pad = torch.cat([expert_out, expert_out.new_zeros((bsz, 1, d))],
                        dim=1)
    per_choice = out_pad.gather(1, slot[..., None].expand(-1, -1, d)).reshape(
        bsz, s, k, d)
    y = per_choice[:, :, 0]
    for j in range(1, k):
        y = y + per_choice[:, :, j]

    if cfg.num_shared_experts:
        y = y + mlp_apply(params["shared"], x, cfg)
    return y, aux
