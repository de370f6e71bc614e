"""Model registry: config -> model instance + reduced smoke configs.

Counterpart of ``repro.models.registry``. ``build_model`` builds the whole
zoo: the dense "global" decoders (smollm-135m, qwen3-4b, granite-3-2b),
gemma2-27b's ("local", "global") layout with its logit softcaps, the
attention-free Mamba-2 stack of "ssd" blocks (mamba2-130m),
recurrentgemma-9b's ("rglru", "rglru", "local") pattern, the
mixture-of-experts "moe" blocks of phi3.5-moe-42b-a6.6b and
deepseek-moe-16b (shared experts, a first dense layer), paligemma-3b's
decoder with its patch frontend stub, and, as an ``EncDecLM``, the
encoder-decoder seamless-m4t-medium. Any pattern of these block kinds
builds, as in the reference (an "ssd" or "rglru" block beside "global"
ones, say); an unknown kind raises ``ValueError(kind)`` from the block
functions (``models/transformer.py``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.device import DEFAULT_DEVICE
from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import CausalLM

def build_model(cfg: ModelConfig, device=DEFAULT_DEVICE):
    """A ``CausalLM``, or an ``EncDecLM`` for family "encdec"."""
    if cfg.family == "encdec":
        return EncDecLM(cfg, device)
    return CausalLM(cfg, device)


def get_model(name: str, device=DEFAULT_DEVICE):
    from repro_torch.configs import get_config   # lazy: configs import models
    cfg = get_config(name)
    return build_model(cfg, device), cfg


def list_archs():
    from repro_torch.configs import list_archs as _la
    return _la()


def reduced_config(cfg: ModelConfig, *, layers: int = None,
                   vocab: int = 2048) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (as the reference's).

    Keeps the *structure* (pattern, GQA ratio, qk_norm, softcaps, MoE
    top-k, SSD/RG-LRU mixers, frontend) while shrinking width/depth/vocab.
    """
    n_pat = len(cfg.pattern)
    depth = layers if layers is not None else max(
        2 * n_pat, n_pat + cfg.first_dense_layers + 1)
    heads = max(min(cfg.num_heads, 4), 1) if cfg.num_heads else 0
    kv = max(1, heads // max(cfg.q_per_kv, 1)) if heads else 0
    updates = dict(
        num_layers=depth,
        d_model=128,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=32 if heads else 0,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=vocab,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window
        else None,
        attn_chunk=64,
        remat="none",
    )
    if cfg.num_experts:
        updates.update(num_experts=min(cfg.num_experts, 8),
                       top_k=min(cfg.top_k, 2), expert_d_ff=64,
                       capacity_factor=8.0,
                       first_dense_ff=256 if cfg.first_dense_layers else 0)
    if cfg.family == "ssm":
        updates.update(ssm_state=16, ssm_head_dim=16, ssd_chunk=16)
    if cfg.lru_width:
        updates.update(lru_width=128)
    if cfg.enc_layers:
        updates.update(enc_layers=2)
    if cfg.frontend_tokens:
        updates.update(frontend_tokens=8)
    return dataclasses.replace(cfg, **updates)


__all__ = ["build_model", "get_model", "reduced_config", "list_archs"]
