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

from repro_torch.core import tensor_parallel as tp
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


def route(params, x, cfg, load=None):
    """The router: fp32 probabilities (B, S, E), the top-k experts (B, S, k)
    with their renormalised weights, and the Switch load-balancing loss
    ``coef * E * sum_e f_e P_e``."""
    return route_logits((x @ params["router"].to(x.dtype)).float(), cfg,
                        load)


def route_logits(logits, cfg, load=None):
    """:func:`route` from the router's fp32 logits (B, S, E).

    ``load`` is the routed share f_e (E,) of a whole batch of which this
    call sees some rows (one data slice's, ``runtime/trainer.py``): the
    loss takes it in place of the call's own share. f_e carries no
    gradient, so the loss is linear in P_e, and the slices' losses with
    their own P_e, each weighed 1/n, add up to the whole batch's. A list
    for ``load`` takes the call's own share, appended to it (the trainer's
    routing pre-pass)."""
    ne = cfg.num_experts
    probs = torch.softmax(logits, dim=-1)                     # (B,S,E)
    weights, experts = torch.topk(probs, cfg.top_k, dim=-1)   # (B,S,k)
    weights = weights / weights.sum(-1, keepdim=True)
    f_e = F.one_hot(experts, ne).float().sum(2).mean((0, 1))  # routed share
    if isinstance(load, list):
        load.append(f_e)
    elif load is not None:
        f_e = load.to(f_e.device)
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


def expert_outputs(params, x, slot, weights, cfg, cap: int, first: int = 0):
    """The routed experts' output (B, S, E) for the experts ``params``
    holds, from expert ``first`` on (all of them, or one model
    coordinate's): each of their slots takes its token, and each token
    sums its choices' slot outputs in choice order, zero for a choice that
    dropped or whose expert another coordinate holds. slot: (B, S k) from
    :func:`dispatch_slots`; weights: (B, S, k)."""
    bsz, s, d = x.shape
    k = cfg.top_k
    ne = params["w_gate"].shape[0]
    dt = x.dtype
    # this block's slots, the others' and the overflow to its own overflow
    local = slot - first * cap
    slot = torch.where((local >= 0) & (local < ne * cap), local,
                       torch.full_like(local, ne * cap))
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
    return y


def moe_apply(params, x, cfg, capacity_factor: float = None, load=None):
    """x: (B, S, E) -> (y, aux_loss); ``load`` as :func:`route_logits`."""
    if capacity_factor is None:
        capacity_factor = cfg.capacity_factor
    cap = capacity(cfg, x.shape[1], capacity_factor)
    _, experts, weights, aux = route(params, x, cfg, load)
    slot = dispatch_slots(experts, cfg.num_experts, cap)      # (B,S*k)
    y = expert_outputs(params, x, slot, weights, cfg, cap)
    if cfg.num_shared_experts:
        y = y + mlp_apply(params["shared"], x, cfg)
    return y, aux


def tp_moe_apply(parts, xs, cfg, spec, capacity_factor: float = None,
                 load=None):
    """:func:`moe_apply` over the model coordinates: ``parts`` each
    coordinate's blocks of the feed-forward's parameters, ``xs`` its copy
    of the normalised stream, ``spec`` the feed-forward's ParamSpecs. ->
    (outputs, whether they are partial sums, the aux loss).

    The reference's layout (src/repro/models/moe.py:26-37) splits the
    router's columns and the experts over the model axis, and the shared
    experts' MLP by "mlp". The router's logits are put together from the
    coordinates' blocks, and every coordinate routes whole (the same
    softmax, top-k and capacity); the aux loss is the first coordinate's,
    counted once, and only the first takes ``load`` (:func:`route_logits`).
    Each coordinate runs only its own experts' slots, so its output is a
    partial sum over the experts, and the shared experts' part
    joins the same partial sum: one all-reduce a block. The coordinates'
    outputs are added in coordinate order, each a sum of its choices in
    choice order, so the rounding differs from one model way's, which sums
    a token's k choices in choice order alone. A part the rules leave whole
    is computed on the first coordinate alone where the other is split (so
    the sum counts it once), and on every coordinate where both are
    whole."""
    if capacity_factor is None:
        capacity_factor = cfg.capacity_factor
    cap = capacity(cfg, xs[0].shape[1], capacity_factor)
    logits = [(x @ p["router"].to(x.dtype)).float()
              for p, x in zip(parts, xs)]
    if tp.is_split(parts[0]["router"], spec["router"].shape):
        logits = tp.whole(logits, logits[0].shape[:-1] + (cfg.num_experts,))
    e_split = tp.is_split(parts[0]["w_gate"], spec["w_gate"].shape)
    s_split = bool(cfg.num_shared_experts) and tp.is_split(
        parts[0]["shared"]["w_down"], spec["shared"]["w_down"].shape)
    partial = e_split or s_split
    ys, aux = [], None
    for m, (p, x, lg) in enumerate(zip(parts, xs, logits)):
        _, experts, weights, a = route_logits(lg, cfg,
                                              load if m == 0 else None)
        aux = a if aux is None else aux
        y = torch.zeros_like(x)
        if e_split or not partial or m == 0:
            slot = dispatch_slots(experts, cfg.num_experts, cap)
            first = m * p["w_gate"].shape[0] if e_split else 0
            y = expert_outputs(p, x, slot, weights, cfg, cap, first)
        if cfg.num_shared_experts and (s_split or not partial or m == 0):
            y = y + mlp_apply(p["shared"], x, cfg)
        ys.append(y)
    return ys, partial, aux
