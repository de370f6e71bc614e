"""Mamba-2 SSD (state-space duality) block — arXiv:2405.21060.

Counterpart of ``repro.models.ssm``: ``n_groups = 1`` (B/C shared across
heads), D skip connection, gated RMSNorm, causal conv1d, as in mamba2-130m.
The prefill / forward scan takes the hand-written CUDA SSD kernel for CUDA
tensors (through ``ssd_op``; under autograd its backward is a kernel too)
and the chunked SSD algorithm, ported from the reference, on the CPU. Decode steps the recurrence once in plain torch, as
the reference computes it outside any kernel.

On the card the kernel multiplies x by dt in fp32, where the chunked path
rounds ``x * dt`` to the model's dtype as the reference does, so in bf16 the
two differ by more than the order of their sums.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.device import on_card
from repro_torch.kernels.ssd.ops import ssd_op
from repro_torch.models.layers import ParamSpec, rms_norm


def ssd_specs(cfg) -> Dict[str, Any]:
    e, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * n
    return {
        "in_proj": ParamSpec((e, 2 * di + 2 * n + h), ("embed", "mlp")),
        "conv_w": ParamSpec((cfg.conv_width, conv_dim), ((), "mlp")),
        "conv_b": ParamSpec((conv_dim,), ("mlp",), "zeros"),
        "A_log": ParamSpec((h,), ("heads",), "ones"),
        "D": ParamSpec((h,), ("heads",), "ones"),
        "dt_bias": ParamSpec((h,), ("heads",), "zeros"),
        "norm": ParamSpec((di,), ("mlp",), "zeros"),
        "out_proj": ParamSpec((di, e), ("mlp", "embed")),
    }


def _split_proj(cfg, zxbcdt):
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z, xc, b, c, dt = torch.split(zxbcdt, [di, di, n, n, h], dim=-1)
    return z, xc, b, c, dt


def causal_conv1d(x, w, b):
    """x: (B, S, C); w: (K, C) depthwise; left-padded causal."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):            # K is 4: unrolled taps
        out = out + pad[:, i:i + x.shape[1]] * w[i].to(x.dtype)
    return F.silu(out + b.to(x.dtype))


def ssd_chunked(x, dt, a_log, b, c, chunk: int):
    """Chunked SSD. x: (B,S,H,P); dt: (B,S,H); b,c: (B,S,N) (n_groups=1).

    Returns (y (B,S,H,P), h_state (B,H,P,N) fp32). The chunk is halved
    until it divides S, as in the reference; unlike the reference, the
    chunk's cumulative sum of dt * a is taken in fp64.
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    while s % q:
        q //= 2
    nc = s // q
    a = -torch.exp(a_log.float())                          # (H,)
    dt = dt.float()
    da = dt * a[None, None, :]                             # (B,S,H)
    x_dt = x * dt[..., None].to(x.dtype)
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()

    h_state = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                          device=x.device)
    ys = []
    for ci in range(nc):
        sl = slice(ci * q, (ci + 1) * q)
        xc, dac = x_dt[:, sl].float(), da[:, sl]
        bc, cc = b[:, sl].float(), c[:, sl].float()
        # fp64 (the reference sums in fp32): at mamba2-130m's init seg
        # reaches -1e3 within a chunk, where an fp32 ulp is 6e-5, and every
        # decay below inherits that error; the CUDA kernel sums in fp64 too
        seg = torch.cumsum(dac.double(), dim=1)            # (B,q,H)
        total = seg[:, -1]                                 # (B,H)
        # intra-chunk (quadratic) term; mask inside the exp, where the
        # upper triangle would overflow
        li = seg[:, :, None, :] - seg[:, None, :, :]       # (B,q,q,H)
        li = torch.where(mask[None, :, :, None], li, -torch.inf)
        decay = torch.exp(li.float())
        cb = torch.einsum("bqn,bsn->bqs", cc, bc)
        att = cb[..., None] * decay                        # (B,q,q,H)
        y_intra = torch.einsum("bqsh,bshp->bqhp", att, xc)
        # inter-chunk: contribution of the carried state
        state_decay = torch.exp(seg.float())               # (B,q,H)
        y_inter = torch.einsum("bqn,bhpn->bqhp", cc, h_state) * \
            state_decay[..., None]
        # state update
        rem = torch.exp((total[:, None, :] - seg).float())  # (B,q,H)
        total = total.float()
        bx = torch.einsum("bqn,bqhp->bhpn", bc, xc * rem[..., None])
        h_state = h_state * torch.exp(total)[:, :, None, None] + bx
        ys.append((y_intra + y_inter).to(x.dtype))
    out = torch.cat(ys, dim=1) if nc > 1 else ys[0]
    return out, h_state


def _mixer(params, x, cfg, want_cache: bool):
    dt_proj = x @ params["in_proj"].to(x.dtype)
    z, xc, b, c, dt = _split_proj(cfg, dt_proj)
    conv_in = torch.cat([xc, b, c], dim=-1)
    conv_out = causal_conv1d(conv_in, params["conv_w"], params["conv_b"])
    di, n = cfg.d_inner, cfg.ssm_state
    xc, b, c = torch.split(conv_out, [di, n, n], dim=-1)
    h, p = cfg.ssm_heads, cfg.ssm_head_dim
    xh = xc.reshape(*xc.shape[:-1], h, p)      # a view of conv_out
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    if on_card(x):
        y, h_final = ssd_op(xh, dt, params["A_log"].float(), b, c,
                            chunk=cfg.ssd_chunk)
    else:
        y, h_final = ssd_chunked(xh, dt, params["A_log"], b, c,
                                 cfg.ssd_chunk)
    y = y + xh * params["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(*xc.shape[:-1], di)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    out = y @ params["out_proj"].to(x.dtype)
    if not want_cache:
        return out, None
    k = params["conv_w"].shape[0]
    # the last k - 1 rows; Python's slice semantics, as the reference's,
    # keep fewer when the prompt is shorter (ssd_decode then refuses it)
    cache = {"conv": conv_in[:, conv_in.shape[1] - (k - 1):],
             "state": h_final}
    return out, cache


def ssd_apply(params, x, cfg):
    """Full Mamba-2 mixer (training). x: (B,S,E)."""
    return _mixer(params, x, cfg, want_cache=False)[0]


def ssd_prefill(params, x, cfg):
    """Prefill: returns (y, cache) with the post-sequence SSM/conv state."""
    return _mixer(params, x, cfg, want_cache=True)


# -- decode ---------------------------------------------------------------------


def ssd_cache_specs(cfg, batch: int) -> Dict[str, Any]:
    di, n = cfg.d_inner, cfg.ssm_state
    conv_dim = di + 2 * n
    return {
        "conv": ParamSpec((batch, cfg.conv_width - 1, conv_dim),
                          ("batch", (), "mlp"), "zeros"),
        "state": ParamSpec((batch, cfg.ssm_heads, cfg.ssm_head_dim, n),
                           ("batch", "heads", (), "state"), "zeros"),
    }


def ssd_init_cache(cfg, batch: int, dtype, device):
    di, n = cfg.d_inner, cfg.ssm_state
    return {"conv": torch.zeros((batch, cfg.conv_width - 1, di + 2 * n),
                                dtype=dtype, device=device),
            "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, n),
                                 dtype=torch.float32, device=device)}


def ssd_decode(params, x, cfg, cache):
    """One-token step. x: (B,1,E). The cache is updated in place (the
    reference returns a new one) and returned."""
    k = params["conv_w"].shape[0]
    if cache["conv"].shape[1] != k - 1:
        raise ValueError(
            f"ssd_decode: the conv cache holds {cache['conv'].shape[1]} "
            f"rows, not conv_width - 1 = {k - 1}; a prefill prompt shorter "
            f"than {k - 1} tokens leaves it short (the reference keeps such "
            "a cache too, and its ssd_decode then fails)")
    dt_proj = x @ params["in_proj"].to(x.dtype)
    z, xc, b, c, dt = _split_proj(cfg, dt_proj)
    conv_in = torch.cat([xc, b, c], dim=-1)                # (B,1,C)
    window = torch.cat([cache["conv"], conv_in], dim=1)
    w, bias = params["conv_w"], params["conv_b"]
    conv_out = torch.einsum("bkc,kc->bc", window, w.to(x.dtype)) \
        + bias.to(x.dtype)
    conv_out = F.silu(conv_out)[:, None, :]
    di, n = cfg.d_inner, cfg.ssm_state
    xc, b, c = torch.split(conv_out, [di, n, n], dim=-1)
    h, p = cfg.ssm_heads, cfg.ssm_head_dim
    xh = xc.reshape(-1, h, p).float()
    dt = F.softplus(dt.float() + params["dt_bias"].float())[:, 0]
    a = -torch.exp(params["A_log"].float())
    da = torch.exp(dt * a[None, :])                        # (B,H)
    bx = torch.einsum("bn,bhp->bhpn", b[:, 0].float(), xh * dt[..., None])
    state = cache["state"] * da[..., None, None] + bx
    y = torch.einsum("bn,bhpn->bhp", c[:, 0].float(), state)
    y = y.to(x.dtype) + xh.to(x.dtype) * \
        params["D"].to(x.dtype)[None, :, None]
    y = y.reshape(-1, 1, di)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    out = y @ params["out_proj"].to(x.dtype)
    cache["conv"].copy_(window[:, 1:])
    cache["state"].copy_(state)
    return out, cache
