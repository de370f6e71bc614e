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

from repro_torch.core import tensor_parallel as tp
from repro_torch.core.sharding import constrain
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


def _conv_scan(params, conv_in, dt, cfg, conv_w, conv_b):
    """The conv and the scan on the heads of ``params["A_log"]`` (all of
    them, or one model coordinate's): conv_in (B, S, d + 2N) is those
    heads' x channels, then B and C; dt (B, S, heads) before its bias.
    -> (y (B, S, d) before the gate, h_final (B, heads, P, N) fp32)."""
    conv_out = causal_conv1d(conv_in, conv_w, conv_b)
    h, p, n = params["A_log"].shape[0], cfg.ssm_head_dim, cfg.ssm_state
    xc, b, c = torch.split(conv_out, [h * p, n, n], dim=-1)
    xh = xc.reshape(*xc.shape[:-1], h, p)      # a view of conv_out
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    if on_card(conv_in):
        y, h_final = ssd_op(xh, dt, params["A_log"].float(), b, c,
                            chunk=cfg.ssd_chunk)
    else:
        y, h_final = ssd_chunked(xh, dt, params["A_log"], b, c,
                                 cfg.ssd_chunk)
    y = y + xh * params["D"].to(conv_in.dtype)[None, None, :, None]
    return y.reshape(*xc.shape[:-1], h * p), h_final


def _conv_cache(conv_in, k: int):
    """The conv input's last k - 1 rows; Python's slice semantics, as the
    reference's, keep fewer when the prompt is shorter (ssd_decode then
    refuses it)."""
    return conv_in[:, conv_in.shape[1] - (k - 1):]


def _mixer(params, x, cfg, want_cache: bool):
    dt_proj = x @ params["in_proj"].to(x.dtype)
    z, xc, b, c, dt = _split_proj(cfg, dt_proj)
    conv_in = torch.cat([xc, b, c], dim=-1)
    y, h_final = _conv_scan(params, conv_in, dt, cfg, params["conv_w"],
                            params["conv_b"])
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    out = y @ params["out_proj"].to(x.dtype)
    if not want_cache:
        return out, None
    cache = {"conv": _conv_cache(conv_in, params["conv_w"].shape[0]),
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


def _check_conv_cache(cache, k: int):
    if cache["conv"].shape[1] != k - 1:
        raise ValueError(
            f"ssd_decode: the conv cache holds {cache['conv'].shape[1]} "
            f"rows, not conv_width - 1 = {k - 1}; a prefill prompt shorter "
            f"than {k - 1} tokens leaves it short (the reference keeps such "
            "a cache too, and its ssd_decode then fails)")


def _decode_heads(params, window, dt, state, cfg, conv_w, conv_b):
    """One step of the heads of ``params["A_log"]`` (all, or one model
    coordinate's): window (B, k, d + 2N), the conv's k rows of those heads'
    x channels then B and C; dt (B, 1, heads) before its bias; state (B,
    heads, P, N). -> (y (B, 1, d) before the gate, the new state)."""
    dtype = window.dtype
    conv_out = torch.einsum("bkc,kc->bc", window, conv_w.to(dtype)) \
        + conv_b.to(dtype)
    conv_out = F.silu(conv_out)[:, None, :]
    h, p, n = params["A_log"].shape[0], cfg.ssm_head_dim, cfg.ssm_state
    xc, b, c = torch.split(conv_out, [h * p, n, n], dim=-1)
    xh = xc.reshape(-1, h, p).float()
    dt = F.softplus(dt.float() + params["dt_bias"].float())[:, 0]
    a = -torch.exp(params["A_log"].float())
    da = torch.exp(dt * a[None, :])                        # (B,H)
    bx = torch.einsum("bn,bhp->bhpn", b[:, 0].float(), xh * dt[..., None])
    state = state * da[..., None, None] + bx
    y = torch.einsum("bn,bhpn->bhp", c[:, 0].float(), state)
    y = y.to(dtype) + xh.to(dtype) * params["D"].to(dtype)[None, :, None]
    return y.reshape(-1, 1, h * p), state


def ssd_decode(params, x, cfg, cache):
    """One-token step. x: (B,1,E). The cache is updated in place (the
    reference returns a new one) and returned."""
    _check_conv_cache(cache, params["conv_w"].shape[0])
    dt_proj = x @ params["in_proj"].to(x.dtype)
    z, xc, b, c, dt = _split_proj(cfg, dt_proj)
    conv_in = torch.cat([xc, b, c], dim=-1)                # (B,1,C)
    window = torch.cat([cache["conv"], conv_in], dim=1)
    y, state = _decode_heads(params, window, dt, cache["state"], cfg,
                             params["conv_w"], params["conv_b"])
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    out = y @ params["out_proj"].to(x.dtype)
    cache["conv"].copy_(window[:, 1:])
    cache["state"].copy_(state)
    return out, cache


# -- tensor parallelism inside a slice ------------------------------------------
#
# The reference's layout (src/repro/models/ssm.py:20-33): ``in_proj``'s
# columns, the conv's channels and the norm over "mlp", A_log / D / dt_bias
# over "heads", ``out_proj``'s rows over "mlp". A coordinate's columns of
# the projection do not line up with the five parts [z, x, B, C, dt], nor
# its conv channels with the heads: the projection's blocks are put
# together (``all_gather``, as the logits are) and the conv's weights
# gathered, and each coordinate runs the conv and the scan on its heads,
# the ones its rows of ``out_proj`` (and its A_log, D, dt_bias and norm)
# hold, with B and C whole (n_groups 1). Its output is a partial sum.


def _tp_heads(parts, cfg, spec):
    """Each coordinate's (channel, head) ranges where the rules split
    ``out_proj``'s rows, and with them the heads' leaves, on head
    boundaries; else None."""
    p = parts[0]
    rows = p["out_proj"].shape[0]
    hh = p["A_log"].shape[0]
    if not tp.is_split(p["out_proj"], spec["out_proj"].shape) or \
            hh * cfg.ssm_head_dim != rows or p["norm"].shape[0] != rows:
        return None
    return [(m * rows, (m + 1) * rows, m * hh, (m + 1) * hh)
            for m in range(len(parts))]


def _tp_proj(parts, hs, spec):
    """The whole projection [z, x, B, C, dt] (B, S, 2 di + 2N + H) on the
    first coordinate's device: the coordinates' column blocks put together,
    or the first's where each holds ``in_proj`` whole."""
    if not tp.is_split(parts[0]["in_proj"], spec["in_proj"].shape):
        return hs[0] @ parts[0]["in_proj"].to(hs[0].dtype)
    return tp.all_gather([h @ p["in_proj"].to(h.dtype)
                          for p, h in zip(parts, hs)], -1)


def _channels(t, lo, hi, di):
    """Channels ``lo:hi`` of x and then B and C, of a tensor whose last
    axis is [x (di), B, C]: a coordinate's conv channels."""
    return torch.cat([t[..., lo:hi], t[..., di:]], dim=-1)


def _tp_conv_weights(parts, spec, ranges, di):
    ws = tp.whole([p["conv_w"] for p in parts], spec["conv_w"].shape)
    bs = tp.whole([p["conv_b"] for p in parts], spec["conv_b"].shape)
    return [(_channels(w, lo, hi, di), _channels(b, lo, hi, di))
            for w, b, (lo, hi, _, _) in zip(ws, bs, ranges)]


def _tp_gated_norm(parts, ys, zs, cfg):
    """The reference's ``rms_norm(y * silu(z), norm)`` with each
    coordinate's channels of y and z: the mean is over the whole d_inner,
    so the sums of squares are added over the coordinates (in coordinate
    order) before any coordinate normalises its channels."""
    gs = [y * F.silu(z.to(y.device)) for y, z in zip(ys, zs)]
    sums = constrain(tp.Partial([g.float().square().sum(-1, keepdim=True)
                                 for g in gs]), ("batch", "seq", None))
    return [(g.float() * torch.rsqrt(s / cfg.d_inner + cfg.norm_eps)
             * (1.0 + p["norm"]).float()).to(g.dtype)
            for p, g, s in zip(parts, gs, sums)]


def tp_mixer(parts, hs, cfg, spec, want_cache: bool = False):
    """The mixer over the model coordinates: ``parts`` each coordinate's
    blocks of the mixer's parameters, ``hs`` its copy of the normalised
    stream, ``spec`` the mixer's ParamSpecs. -> (outputs, whether they are
    partial sums, the cache whole or None). The cache's state is put
    together from the heads' blocks; its conv rows are the whole
    projection's x, B and C."""
    ranges = _tp_heads(parts, cfg, spec)
    if ranges is None:
        return tp.run_whole(parts, hs, spec, lambda p, h: _mixer(
            p, h, cfg, want_cache))
    di, n = cfg.d_inner, cfg.ssm_state
    proj = _tp_proj(parts, hs, spec)
    convs = _tp_conv_weights(parts, spec, ranges, di)
    ys, zs, states = [], [], []
    for p, h, (lo, hi, h0, h1), (cw, cb) in zip(parts, hs, ranges, convs):
        dev = h.device
        conv_in = _channels(proj[..., di:2 * di + 2 * n], lo, hi, di)
        dt = proj[..., 2 * di + 2 * n + h0:2 * di + 2 * n + h1]
        y, h_final = _conv_scan(p, conv_in.to(dev), dt.to(dev), cfg, cw, cb)
        ys.append(y)
        zs.append(proj[..., lo:hi])
        states.append(h_final)
    ys = _tp_gated_norm(parts, ys, zs, cfg)
    outs = [y @ p["out_proj"].to(y.dtype) for p, y in zip(parts, ys)]
    if not want_cache:
        return outs, True, None
    cache = {"conv": _conv_cache(proj[..., di:2 * di + 2 * n],
                                 parts[0]["conv_w"].shape[0]),
             "state": tp.all_gather(states, 1)}
    return outs, True, cache


def tp_decode(parts, hs, cfg, spec, cache):
    """:func:`ssd_decode` over the model coordinates on a whole cache (on
    the first coordinate's device): each coordinate steps its heads' view
    of the state; the conv rows are written once, from the whole
    projection. -> (outputs, whether they are partial sums)."""
    ranges = _tp_heads(parts, cfg, spec)
    if ranges is None:
        return tp.run_whole(parts, hs, spec, lambda p, h: ssd_decode(
            p, h, cfg, cache))[:2]
    _check_conv_cache(cache, parts[0]["conv_w"].shape[0])
    di, n = cfg.d_inner, cfg.ssm_state
    proj = _tp_proj(parts, hs, spec)
    window = torch.cat([cache["conv"], proj[..., di:2 * di + 2 * n]], dim=1)
    convs = _tp_conv_weights(parts, spec, ranges, di)
    ys, zs, states = [], [], []
    for p, h, (lo, hi, h0, h1), (cw, cb) in zip(parts, hs, ranges, convs):
        dev = h.device
        dt = proj[..., 2 * di + 2 * n + h0:2 * di + 2 * n + h1]
        y, state = _decode_heads(
            p, _channels(window, lo, hi, di).to(dev), dt.to(dev),
            cache["state"][:, h0:h1].to(dev), cfg, cw, cb)
        ys.append(y)
        zs.append(proj[..., lo:hi])
        states.append(state)
    ys = _tp_gated_norm(parts, ys, zs, cfg)
    cache["conv"].copy_(window[:, 1:])
    for (_, _, h0, h1), state in zip(ranges, states):
        cache["state"][:, h0:h1].copy_(state)
    return [y @ p["out_proj"].to(y.dtype) for p, y in zip(parts, ys)], True
