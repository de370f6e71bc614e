"""Plain PyTorch flash attention (naive materialised softmax), forward and
backward.

``attention_ref`` is the counterpart of
``repro.kernels.flash_attention.ref.attention_ref``: the version the CUDA
forward is held against, and the one a CPU tensor takes (its gradients are
torch autograd's). ``attention_lse`` is the rows' log-sum-exp the forward
kernel writes for training, and ``attention_bwd_ref`` the backward kernel's
decomposition step by step (FlashAttention-2: P recomputed from the
log-sum-exp, delta = rowsum(dO * O)), which the tests hold against autograd
and ``jax.grad``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -2.0 ** 30


def _mask(sq: int, sk: int, causal: bool, window: Optional[int], device):
    """(Sq, Sk) bool: the keys each query row sees. Query positions are
    right-aligned to the keys: query row i sits at position
    ``i + Sk - Sq``."""
    qpos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    return mask


def _scores(q, k, causal, window, softcap):
    """Scaled, capped, masked fp32 scores (B, KV, G, Sq, Sk), and the
    softcap's tanh (None without one)."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, sq, d)
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg.float(),
                          k.float()) / math.sqrt(d)
    th = None
    if softcap is not None:
        th = torch.tanh(logits / softcap)
        logits = th * softcap
    mask = _mask(sq, sk, causal, window, q.device)
    return torch.where(mask[None, None, None], logits, NEG_INF), th


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, KV, Sk, D). GQA via H % KV == 0.

    Query positions are right-aligned to the keys: query row i sits at
    position ``i + Sk - Sq``.
    """
    b, h, sq, d = q.shape
    logits, _ = _scores(q, k, causal, window, softcap)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return out.reshape(b, h, sq, d).to(q.dtype)


def attention_lse(q, k, *, causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None) -> torch.Tensor:
    """The rows' log-sum-exp of the scaled, capped, masked scores: fp32
    (B, H, Sq), what the forward kernel writes for its backward."""
    b, h, sq, _ = q.shape
    logits, _ = _scores(q, k, causal, window, softcap)
    return torch.logsumexp(logits, dim=-1).reshape(b, h, sq)


def attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                      window: Optional[int] = None,
                      softcap: Optional[float] = None):
    """(dq, dk, dv) of ``attention_ref``'s output ``o`` given its gradient
    ``do`` and the rows' log-sum-exp ``lse``, by the backward kernel's
    equations, in fp32, each rounded to its input's dtype:

        delta = rowsum(do * o)
        P     = exp(S - lse)              (S scaled, capped, masked)
        dV    = P^T dO,   dP = dO V^T
        dS    = P (dP - delta) (1 - tanh^2) / sqrt(D)
        dK    = dS^T Q,   dQ = dS K

    dK and dV sum over each KV head's group of query heads."""
    b, h, sq, d = q.shape
    kvh = k.shape[1]
    g = h // kvh
    logits, th = _scores(q, k, causal, window, softcap)
    p = torch.exp(logits - lse.float().reshape(b, kvh, g, sq, 1))
    dog = do.float().reshape(b, kvh, g, sq, d)
    delta = (dog * o.float().reshape(b, kvh, g, sq, d)).sum(-1)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dog)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dog, v.float())
    ds = p * (dp - delta[..., None])
    if th is not None:
        ds = ds * (1.0 - th * th)
    ds = ds / math.sqrt(d)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, k.float())
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds,
                      q.float().reshape(b, kvh, g, sq, d))
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
