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
    """x: (B, S, W) -> (a, gated input b), both (B, S, W) fp32.

    The reference's formula, with each exp taken in fp64 and rounded once
    to fp32 (correctly rounded, as the reference's XLA exp is in practice,
    and the same on the card and the CPU). Where the recurrence gate r is
    near 0, 1 - exp(2 log a) cancels, and there torch's fp32 exp (on either
    device) and XLA's round one ulp apart often enough to move beta by a
    large fraction (ROADMAP.md, Queue 3)."""
    dt = x.dtype
    r = torch.sigmoid((x @ params["w_a"].to(dt) + params["b_a"].to(dt))
                      .float())
    i = torch.sigmoid((x @ params["w_x"].to(dt) + params["b_x"].to(dt))
                      .float())
    log_a = (-C_GATE * r * F.softplus(params["lam"].float())).double()
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


def rglru_decode(params, x, cfg, cache):
    """One-token step. x: (B,1,E). The cache is updated in place (the
    reference returns a new one) and returned."""
    k = params["conv_w"].shape[0]
    if cache["conv"].shape[1] != k - 1:
        raise ValueError(
            f"rglru_decode: the conv cache holds {cache['conv'].shape[1]} "
            f"rows, not conv_width - 1 = {k - 1}; a prefill prompt shorter "
            f"than {k - 1} tokens leaves it short (the reference keeps such "
            "a cache too, and its rglru_decode then fails)")
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
