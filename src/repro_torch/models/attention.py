"""Attention: GQA projections, chunked causal attention, the flash kernel
behind ``attn_impl``, local sliding windows, and the KV caches.

Counterpart of ``repro.models.attention`` for the "global" and "local"
kinds, and the "moe" block kind, whose attention is global. The prefill / forward attention takes the hand-written CUDA flash
kernel for CUDA tensors (``attn_impl="auto"``) and the chunked
online-softmax path, ported from the reference, on the CPU; a "local"
layer passes its sliding window to either. Decode attends over the cache in
plain torch, as the reference computes it outside any kernel. A "local"
layer's cache is a ring buffer of the window's size: position p sits in
slot p % window.

The "cross" kind is not ported yet: it raises ``NotImplementedError``
(ROADMAP.md, Queue 1, other model families: seamless).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.models.layers import ParamSpec, apply_rope, rms_norm, softcap

NEG_INF = -2.0 ** 30
ATTN_IMPLS = ("auto", "chunked")


# block kinds with self-attention: a "moe" block attends globally
KINDS = ("global", "local", "moe")


def window_of(cfg, kind: str) -> Optional[int]:
    """The sliding window of a ``kind`` layer: None for "global" and
    "moe"."""
    if kind not in KINDS:
        raise NotImplementedError(
            f"attention kind {kind!r} is not ported yet (ROADMAP.md, "
            "Queue 1, other model families: seamless)")
    return cfg.sliding_window if kind == "local" else None


def cache_length(cfg, kind: str, max_len: int) -> int:
    """Slots of a ``kind`` layer's KV cache: ``max_len``, or for a local
    layer a ring of its window's size when that is shorter."""
    return min(window_of(cfg, kind) or max_len, max_len)


def attention_specs(cfg) -> Dict[str, Any]:
    e, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs = {
        "wq": ParamSpec((e, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((e, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((e, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, e), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((hd,), ("head_dim",), init="zeros")
        specs["k_norm"] = ParamSpec((hd,), ("head_dim",), init="zeros")
    return specs


def _project_qkv(params, x, cfg, positions):
    dt = x.dtype
    q = torch.einsum("bse,ehd->bshd", x, params["wq"].to(dt))
    k = torch.einsum("bse,ehd->bshd", x, params["wk"].to(dt))
    v = torch.einsum("bse,ehd->bshd", x, params["wv"].to(dt))
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa_chunk(q, k, v, mask, cfg, state=None):
    """Online-softmax update of one (q-chunk, kv-chunk) pair.

    q: (B, Sq, KV, G, D); k/v: (B, Sk, KV, D); mask: (Sq, Sk) or None.
    state: (m, l, acc) running max / normalizer / weighted accumulator.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqkgd,bskd->bkgqs", q, k).float() * scale
    logits = softcap(logits, cfg.attn_logit_softcap)
    if mask is not None:
        logits = torch.where(mask[None, None, None], logits, NEG_INF)
    m_new = logits.amax(dim=-1)                            # (B,KV,G,Sq)
    if state is not None:
        m_prev, l_prev, acc_prev = state
        m_new = torch.maximum(m_prev, m_new)
    p = torch.exp(logits - m_new[..., None])
    l_new = p.sum(dim=-1)
    pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(q.dtype), v)
    if state is not None:
        corr = torch.exp(m_prev - m_new)
        l_new = l_new + corr * l_prev
        pv = pv + corr[..., None].to(q.dtype) * acc_prev
    return m_new, l_new, pv


def _finish(l, acc):
    return acc / l.clamp_min(1e-30)[..., None].to(acc.dtype)


def chunked_attention(q, k, v, cfg, *, causal: bool, window: Optional[int]):
    """Exact-FLOPs chunked attention (the plain path).

    q: (B, S, H, D) -> grouped (B, S, KV, G, D). The query axis is split in
    chunks; each chunk attends its key slice (its causal prefix, or its
    sliding window), carrying the online-softmax state over kv chunks.
    """
    b, s, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    q = q.reshape(b, s, kvh, g, d)
    c = min(cfg.attn_chunk, s)
    while s % c:
        c //= 2
    n_chunks = s // c
    ar = torch.arange(c, device=q.device)

    def one_chunk(q_i, k_slice, v_slice, i, lo, hi):
        q_pos = i * c + ar
        state = None
        for j in range((hi - lo) // c):
            kk = k_slice[:, j * c:(j + 1) * c]
            vv = v_slice[:, j * c:(j + 1) * c]
            kv_lo = lo + j * c
            mask = None
            # mask only where the chunk pair can be partly invalid: the
            # causal diagonal and the sliding-window edge
            diag = causal and kv_lo + c > i * c
            edge = window is not None and kv_lo < i * c + c - window
            if diag or edge:
                kv_pos = kv_lo + ar
                mask = torch.ones((c, c), dtype=torch.bool, device=q.device)
                if causal:
                    mask &= q_pos[:, None] >= kv_pos[None, :]
                if window is not None:
                    mask &= q_pos[:, None] - kv_pos[None, :] < window
            state = _sdpa_chunk(q_i, kk, vv, mask, cfg, state)
        return _finish(state[1], state[2])

    outs = []
    for i in range(n_chunks):
        q_i = q[:, i * c:(i + 1) * c]
        if causal:
            lo = 0 if window is None else max(0, (i * c + c) - window - c + 1)
            lo = (lo // c) * c
            hi = (i + 1) * c
        else:
            lo, hi = 0, s
        outs.append(one_chunk(q_i, k[:, lo:hi], v[:, lo:hi], i, lo, hi))
    out = torch.cat(outs, dim=-2) if len(outs) > 1 else outs[0]
    # (B,KV,G,S,D) -> (B,S,H,D)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)


def _attend(q, k, v, cfg, window: Optional[int]):
    """Causal attention on (B, S, H, D) tensors, within ``window`` keys when
    it is set, by ``attn_impl``: "auto" takes the flash kernel for CUDA
    tensors and the chunked path on the CPU; "chunked" always takes the
    chunked path."""
    impl = cfg.attn_impl
    if impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {impl!r} {ATTN_IMPLS}")
    if impl == "chunked" or (impl == "auto" and not q.is_cuda):
        return chunked_attention(q, k, v, cfg, causal=True, window=window)
    # (B, S, H, D) viewed as (B, H, S, D): the kernel takes the strides, and
    # writes into a (B, S, H, D) buffer, so the transpose back is free
    out = flash_attention_op(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=True, window=window,
                             softcap=cfg.attn_logit_softcap)
    return out.transpose(1, 2)


# -- KV cache ------------------------------------------------------------------


def cache_specs(cfg, batch: int, length: int) -> Dict[str, Any]:
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": ParamSpec((batch, length, kv, hd),
                       ("batch", "kv_seq", "kv_heads", "head_dim"), "zeros"),
        "v": ParamSpec((batch, length, kv, hd),
                       ("batch", "kv_seq", "kv_heads", "head_dim"), "zeros"),
        "pos": ParamSpec((length,), ("kv_seq",), "zeros"),
    }


def decode_attention(params, x, cfg, cache, pos: int, *,
                     window: Optional[int] = None):
    """One-token decode: write the cache at slot ``pos % length`` (a ring
    buffer for a local layer's window; a global cache is as long as the
    sequence) and attend over the positions it holds, within ``window``
    when it is set.

    x: (B, 1, E); pos: int. The cache is updated in place (the reference
    returns a new one) and returned. The ``pos`` vector is shared by the
    whole batch, and every row is written at ``pos``, as in the reference.
    """
    b = x.shape[0]
    length = cache["k"].shape[1]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, positions)
    slot = pos % length
    k_cache, v_cache, pos_arr = cache["k"], cache["v"], cache["pos"]
    k_cache[:, slot] = k[:, 0]
    v_cache[:, slot] = v[:, 0]
    pos_arr[slot] = pos

    kvh, hd = k.shape[2], k.shape[3]
    g = cfg.num_heads // kvh
    qg = q.reshape(b, 1, kvh, g, hd)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache).float()
    logits = softcap(logits * scale, cfg.attn_logit_softcap)
    valid = (pos_arr >= 0) & (pos_arr <= pos)
    if window is not None:
        valid &= pos_arr > pos - window
    logits = torch.where(valid[None, None, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bkgqd", p.to(x.dtype), v_cache)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, cfg.num_heads, hd)
    y = torch.einsum("bshd,hde->bse", out, params["wo"].to(x.dtype))
    return y, cache


def attention_apply(params, x, cfg, *, kind: str = "global"):
    """Training / prefill attention. kind: "global" | "local" | "moe"."""
    window = window_of(cfg, kind)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(params, x, cfg, positions)
    out = _attend(q, k, v, cfg, window)
    return torch.einsum("bshd,hde->bse", out, params["wo"].to(x.dtype))


def attention_prefill(params, x, cfg, *, kind: str = "global",
                      cache_len: int):
    """Full-sequence attention that also returns the filled KV cache.

    Global layers keep all S positions (padded up to ``cache_len``); local
    layers keep the trailing ``w = min(window, cache_len)`` positions in
    ring-buffer order (position p in slot p % w, unfilled slots at position
    -1), so that :func:`decode_attention` steps continue seamlessly.
    """
    window = window_of(cfg, kind)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(params, x, cfg, positions)
    out = _attend(q, k, v, cfg, window)
    y = torch.einsum("bshd,hde->bse", out, params["wo"].to(x.dtype))
    if kind == "local":
        w = cache_length(cfg, kind, cache_len)
        m = min(s, w)
        kept = torch.arange(s - m, s, device=x.device)
        slots = kept % w
        k_keep = k.new_zeros((b, w) + k.shape[2:])
        v_keep = v.new_zeros((b, w) + v.shape[2:])
        k_keep[:, slots] = k[:, s - m:]
        v_keep[:, slots] = v[:, s - m:]
        pos = torch.full((w,), -1, dtype=torch.int32, device=x.device)
        pos[slots] = kept.to(torch.int32)
        return y, {"k": k_keep, "v": v_keep, "pos": pos}
    pad = cache_len - s
    k_keep = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    v_keep = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    pos = torch.cat([torch.arange(s, dtype=torch.int32, device=x.device),
                     torch.full((pad,), -1, dtype=torch.int32,
                                device=x.device)])
    return y, {"k": k_keep, "v": v_keep, "pos": pos}
