"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Counterpart of ``repro.models.rglru``. The Real-Gated Linear Recurrent Unit:

    r_t = sigmoid(W_a x_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)            (input gate)
    log a_t = -c * r_t * softplus(Lambda)   (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The temporal mix is: linear in, causal conv1d (width 4, no activation),
RG-LRU, gated by a GeLU branch, linear out. The prefill / forward scan
takes the hand-written CUDA kernel for CUDA tensors (through ``rglru_op``;
under autograd its backward is a kernel too) and a log-depth scan, the counterpart of the reference's
``jax.lax.associative_scan``, on the CPU. Decode steps the recurrence once
in plain torch, as the reference computes it outside any kernel.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.core import tensor_parallel as tp
from repro_torch.core.sharding import constrain
from repro_torch.device import on_card
from repro_torch.kernels.rglru.ops import rglru_op
from repro_torch.models.layers import ParamSpec

C_GATE = 8.0


def rglru_specs(cfg) -> Dict[str, Any]:
    e = cfg.d_model
    w = cfg.lru_width or e
    return {
        "in_proj": ParamSpec((e, 2 * w), ("embed", "mlp")),      # x, gate
        "conv_w": ParamSpec((cfg.conv_width, w), ((), "mlp")),
        "conv_b": ParamSpec((w,), ("mlp",), "zeros"),
        "w_a": ParamSpec((w, w), ("mlp", "state")),
        "b_a": ParamSpec((w,), ("state",), "zeros"),
        "w_x": ParamSpec((w, w), ("mlp", "state")),
        "b_x": ParamSpec((w,), ("state",), "zeros"),
        "lam": ParamSpec((w,), ("state",), "lru_a"),
        "out_proj": ParamSpec((w, e), ("mlp", "embed")),
    }


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _gates(params, x):
    """x: (B, S, W) -> (a, gated input b), both (B, S, W) fp32."""
    dt = x.dtype
    return _gate_values(x @ params["w_a"].to(dt) + params["b_a"].to(dt),
                        x @ params["w_x"].to(dt) + params["b_x"].to(dt),
                        params["lam"], x)


def _gate_values(pre_a, pre_x, lam, x):
    """The gates from their pre-activations ``x @ w + b`` (B, S, W) and
    the conv output x -> (a, gated input b), both fp32.

    The reference's formula, with each exp taken in fp64 and rounded once
    to fp32 (correctly rounded, as the reference's XLA exp is in practice,
    and the same on the card and the CPU). Where the recurrence gate r is
    near 0, 1 - exp(2 log a) cancels, and there torch's fp32 exp (on either
    device) and XLA's round one ulp apart often enough to move beta by a
    large fraction (ROADMAP.md, Queue 3)."""
    r = torch.sigmoid(pre_a.float())
    i = torch.sigmoid(pre_x.float())
    log_a = (-C_GATE * r * F.softplus(lam.float())).double()
    a = torch.exp(log_a).float()
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a).float(),
                                      1e-12))
    b = beta * (i * x.float())
    return a, b


def rglru_scan(a, b):
    """h_t = a_t h_{t-1} + b_t over axis 1, in log2(S) doubling steps: the
    plain CPU path, as the reference's associative scan (which combines in
    another tree, so the two round differently)."""
    s = a.shape[1]
    shift = 1
    while shift < s:
        # (a, b) at t absorbs the prefix ending at t - shift
        b = torch.cat([b[:, :shift], a[:, shift:] * b[:, :-shift]
                       + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
        shift *= 2
    return b


def _conv(x, w, bias):
    """Causal depthwise conv1d over (B, S, W), left-padded, then the bias:
    no activation (the SSD block's conv applies SiLU)."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):            # K is 4: unrolled taps
        out = out + pad[:, i:i + x.shape[1]] * w[i].to(x.dtype)
    return out + bias.to(x.dtype)


def _mixer(params, x, cfg, want_cache: bool):
    proj = x @ params["in_proj"].to(x.dtype)
    w = cfg.lru_width or cfg.d_model
    xb, gate = torch.split(proj, [w, w], dim=-1)
    conv = _conv(xb, params["conv_w"], params["conv_b"])
    a, b = _gates(params, conv)
    h = rglru_op(a, b) if on_card(x) else rglru_scan(a, b)
    y = h.to(x.dtype) * _gelu(gate)
    out = y @ params["out_proj"].to(x.dtype)
    if not want_cache:
        return out, None
    k = params["conv_w"].shape[0]
    # the last k - 1 rows; Python's slice semantics, as the reference's,
    # keep fewer when the prompt is shorter (rglru_decode then refuses it).
    # Copies, so the cache holds no view of the whole sequence's tensors.
    cache = {"conv": xb[:, xb.shape[1] - (k - 1):].clone(),
             "h": h[:, -1].clone()}
    return out, cache


def rglru_mixer_apply(params, x, cfg):
    """Temporal mix (training). x: (B,S,E)."""
    return _mixer(params, x, cfg, want_cache=False)[0]


def rglru_prefill(params, x, cfg):
    """Prefill: returns (y, cache) with the final recurrent and conv
    state."""
    return _mixer(params, x, cfg, want_cache=True)


# -- decode -----------------------------------------------------------------------


def rglru_cache_specs(cfg, batch: int) -> Dict[str, Any]:
    w = cfg.lru_width or cfg.d_model
    return {
        "conv": ParamSpec((batch, cfg.conv_width - 1, w),
                          ("batch", (), "mlp"), "zeros"),
        "h": ParamSpec((batch, w), ("batch", "state"), "zeros"),
    }


def _check_conv_cache(cache, k: int):
    if cache["conv"].shape[1] != k - 1:
        raise ValueError(
            f"rglru_decode: the conv cache holds {cache['conv'].shape[1]} "
            f"rows, not conv_width - 1 = {k - 1}; a prefill prompt shorter "
            f"than {k - 1} tokens leaves it short (the reference keeps such "
            "a cache too, and its rglru_decode then fails)")


def rglru_decode(params, x, cfg, cache):
    """One-token step. x: (B,1,E). The cache is updated in place (the
    reference returns a new one) and returned."""
    _check_conv_cache(cache, params["conv_w"].shape[0])
    proj = x @ params["in_proj"].to(x.dtype)
    w = cfg.lru_width or cfg.d_model
    xb, gate = torch.split(proj, [w, w], dim=-1)          # (B,1,W)
    window = torch.cat([cache["conv"], xb], dim=1)
    conv = torch.einsum("bkw,kw->bw", window, params["conv_w"].to(x.dtype))
    conv = (conv + params["conv_b"].to(x.dtype))[:, None, :]
    a, b = _gates(params, conv)                           # (B,1,W)
    h = a[:, 0] * cache["h"] + b[:, 0]
    y = h[:, None, :].to(x.dtype) * _gelu(gate)
    out = y @ params["out_proj"].to(x.dtype)
    cache["conv"].copy_(window[:, 1:])
    cache["h"].copy_(h)
    return out, cache


# -- tensor parallelism inside a slice ------------------------------------------
#
# The reference's layout (src/repro/models/rglru.py:31-39): ``in_proj``'s
# columns, the conv's channels, the rows of ``w_a``, ``w_x`` and
# ``out_proj`` over "mlp"; ``b_a``, ``b_x`` and ``lam`` over "state", which
# the rules leave whole. Each coordinate takes its block of the width, W /
# M channels of x and of the gate, from the projection's blocks put
# together; its conv and its rows of ``w_a`` / ``w_x`` give a partial sum
# of the whole gates' pre-activations, added before the sigmoid; it scans
# its channels alone (the recurrence is elementwise in W), and its output
# is a partial sum.


def _tp_width(parts, spec):
    """Each coordinate's (lo, hi) block of the width where the rules split
    ``out_proj``'s rows and, on the same blocks, the conv's channels and
    the rows of ``w_a`` and ``w_x``; else None."""
    p = parts[0]
    rows = p["out_proj"].shape[0]
    if not tp.is_split(p["out_proj"], spec["out_proj"].shape) or any(
            p[k].shape[-1 if k.startswith("conv") else 0] != rows
            for k in ("conv_w", "conv_b", "w_a", "w_x")):
        return None
    return [(m * rows, (m + 1) * rows) for m in range(len(parts))]


def _tp_proj(parts, hs, spec):
    """The whole projection [x, gate] (B, S, 2W) on the first coordinate's
    device: the coordinates' column blocks put together, or the first's
    where each holds ``in_proj`` whole."""
    if not tp.is_split(parts[0]["in_proj"], spec["in_proj"].shape):
        return hs[0] @ parts[0]["in_proj"].to(hs[0].dtype)
    return tp.all_gather([h @ p["in_proj"].to(h.dtype)
                          for p, h in zip(parts, hs)], -1)


def _tp_gates(parts, convs, spec, ranges):
    """The gates of each coordinate's channels: its conv output (B, S, W /
    M) times its rows of ``w_a`` and ``w_x``, partial sums of the whole
    pre-activations, added in coordinate order before the sigmoid."""
    sums = {}
    for w in ("w_a", "w_x"):
        sums[w] = constrain(tp.Partial([c @ p[w].to(c.dtype) for p, c in
                                        zip(parts, convs)]),
                            ("batch", "seq", "state"))
    bias = {k: tp.whole([p[k] for p in parts], spec[k].shape)
            for k in ("b_a", "b_x", "lam")}
    out = []
    for m, (c, (lo, hi)) in enumerate(zip(convs, ranges)):
        dt = c.dtype
        out.append(_gate_values(
            sums["w_a"][m][..., lo:hi] + bias["b_a"][m][lo:hi].to(dt),
            sums["w_x"][m][..., lo:hi] + bias["b_x"][m][lo:hi].to(dt),
            bias["lam"][m][lo:hi], c))
    return out


def tp_mixer(parts, hs, cfg, spec, want_cache: bool = False):
    """The temporal mix over the model coordinates: ``parts`` each
    coordinate's blocks of the mixer's parameters, ``hs`` its copy of the
    normalised stream, ``spec`` the mixer's ParamSpecs. -> (outputs,
    whether they are partial sums, the cache whole or None: the conv rows
    from the whole projection, h put together from the width's blocks)."""
    ranges = _tp_width(parts, spec)
    if ranges is None:
        return tp.run_whole(parts, hs, spec, lambda p, h: _mixer(
            p, h, cfg, want_cache))
    w = cfg.lru_width or cfg.d_model
    proj = _tp_proj(parts, hs, spec)
    convs = [_conv(proj[..., lo:hi].to(h.device), p["conv_w"], p["conv_b"])
             for p, h, (lo, hi) in zip(parts, hs, ranges)]
    outs, last = [], []
    for p, h, c, (a, b), (lo, hi) in zip(
            parts, hs, convs, _tp_gates(parts, convs, spec, ranges), ranges):
        hh = rglru_op(a, b) if on_card(c) else rglru_scan(a, b)
        y = hh.to(c.dtype) * _gelu(proj[..., w + lo:w + hi].to(h.device))
        outs.append(y @ p["out_proj"].to(y.dtype))
        last.append(hh[:, -1])
    if not want_cache:
        return outs, True, None
    k = parts[0]["conv_w"].shape[0]
    cache = {"conv": proj[:, proj.shape[1] - (k - 1):, :w].clone(),
             "h": tp.all_gather(last, -1)}
    return outs, True, cache


def tp_decode(parts, hs, cfg, spec, cache):
    """:func:`rglru_decode` over the model coordinates on a whole cache (on
    the first coordinate's device): each coordinate steps its channels'
    view of the conv rows and of h. -> (outputs, whether they are partial
    sums)."""
    ranges = _tp_width(parts, spec)
    if ranges is None:
        return tp.run_whole(parts, hs, spec, lambda p, h: rglru_decode(
            p, h, cfg, cache))[:2]
    k = parts[0]["conv_w"].shape[0]
    _check_conv_cache(cache, k)
    w = cfg.lru_width or cfg.d_model
    proj = _tp_proj(parts, hs, spec)
    windows, convs = [], []
    for p, h, (lo, hi) in zip(parts, hs, ranges):
        dt = h.dtype
        win = torch.cat([cache["conv"][..., lo:hi], proj[..., lo:hi]],
                        dim=1).to(h.device)
        conv = torch.einsum("bkw,kw->bw", win, p["conv_w"].to(dt))
        windows.append(win)
        convs.append((conv + p["conv_b"].to(dt))[:, None, :])
    outs, states = [], []
    for p, h, (a, b), (lo, hi) in zip(
            parts, hs, _tp_gates(parts, convs, spec, ranges), ranges):
        state = a[:, 0] * cache["h"][:, lo:hi].to(h.device) + b[:, 0]
        y = state[:, None, :].to(h.dtype) * _gelu(
            proj[..., w + lo:w + hi].to(h.device))
        outs.append(y @ p["out_proj"].to(y.dtype))
        states.append(state)
    for win, state, (lo, hi) in zip(windows, states, ranges):
        cache["conv"][..., lo:hi].copy_(win[:, 1:])
        cache["h"][:, lo:hi].copy_(state)
    return outs, True
