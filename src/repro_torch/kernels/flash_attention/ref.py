"""Plain PyTorch flash attention (naive materialised softmax).

Counterpart of ``repro.kernels.flash_attention.ref.attention_ref``: the
version the CUDA kernel is held against, and the one a CPU tensor takes.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -2.0 ** 30


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, KV, Sk, D). GQA via H % KV == 0.

    Query positions are right-aligned to the keys: query row i sits at
    position ``i + Sk - Sq``.
    """
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, kvh, g, sq, d)
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg.float(),
                          k.float()) / math.sqrt(d)
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    logits = torch.where(mask[None, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return out.reshape(b, h, sq, d).to(q.dtype)
