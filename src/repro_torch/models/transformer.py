"""Decoder-only LM over a stack of attention blocks.

Counterpart of ``repro.models.transformer.CausalLM`` for the pattern
``("global",)``. Parameters keep the reference's tree: the block parameters
are stacked under ``blocks.p0.*`` with a leading layers axis, and the
reference's ``jax.lax.scan`` over that axis is a loop here. ``loss`` comes
with the training slice (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (ParamSpec, embed_apply, embed_specs,
                                       init_from_specs, mlp_apply,
                                       mlp_specs, rms_norm, torch_dtype,
                                       tree_map, unembed_apply)


def stack_specs(specs, n: int):
    return tree_map(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.logical,
                            s.init, s.scale), specs)


def layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, so writes reach the stack)."""
    return tree_map(lambda x: x[i], tree)


# -- block definitions -------------------------------------------------------


def block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    e = cfg.d_model
    return {"ln1": ParamSpec((e,), ("embed",), "zeros"),
            "attn": attn.attention_specs(cfg),
            "ln2": ParamSpec((e,), ("embed",), "zeros"),
            "ffn": mlp_specs(cfg)}


def block_apply(params, x, cfg: ModelConfig):
    """One block, training / prefill path (full sequence)."""
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    x = x + attn.attention_apply(params["attn"], h, cfg)
    h = rms_norm(x, params["ln2"], cfg.norm_eps)
    return x + mlp_apply(params["ffn"], h, cfg)


def block_decode(params, x, cfg: ModelConfig, cache, pos: int):
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    y, cache = attn.decode_attention(params["attn"], h, cfg, cache, pos)
    x = x + y
    h = rms_norm(x, params["ln2"], cfg.norm_eps)
    return x + mlp_apply(params["ffn"], h, cfg), cache


def block_prefill(params, x, cfg: ModelConfig, max_len: int):
    """Full-sequence forward that also fills the block cache."""
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    y, cache = attn.attention_prefill(params["attn"], h, cfg,
                                      cache_len=max_len)
    x = x + y
    h = rms_norm(x, params["ln2"], cfg.norm_eps)
    return x + mlp_apply(params["ffn"], h, cfg), cache


# -- the model -----------------------------------------------------------------


class CausalLM:
    """Decoder-only LM of "global" attention blocks, on one device."""

    def __init__(self, cfg: ModelConfig, device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.device = resolve_device(device)

    # ---- parameters ----

    def specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {"embed": embed_specs(cfg),
                "blocks": stack_specs({"p0": block_specs(cfg)},
                                      cfg.num_layers),
                "final_norm": ParamSpec((cfg.d_model,), ("embed",), "zeros")}

    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Random parameters drawn from ``generator`` (a CPU generator)."""
        return init_from_specs(generator, self.specs(),
                               torch_dtype(self.cfg.param_dtype),
                               self.device)

    # ---- forward (training / prefill trunk) ----

    def _trunk(self, params, x):
        cfg = self.cfg
        for i in range(cfg.num_layers):
            x = block_apply(layer(params["blocks"]["p0"], i), x, cfg)
        return rms_norm(x, params["final_norm"], cfg.norm_eps)

    def forward(self, params, tokens):
        """tokens: (B, S) -> (fp32 logits (B, S, V), aux loss 0)."""
        x = embed_apply(params["embed"], tokens, self.cfg)
        x = self._trunk(params, x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return unembed_apply(params["embed"], x, self.cfg), aux

    # ---- serving ----

    def init_cache(self, batch: int, max_len: int):
        cfg = self.cfg
        one = attn.init_cache(cfg, batch, max_len, torch_dtype(cfg.dtype),
                              self.device)
        return {"blocks": {"p0": tree_map(
            lambda t: t.expand(cfg.num_layers, *t.shape).clone(), one)}}

    def prefill(self, params, tokens, max_len: int):
        """Run the full prompt, returning (last-position logits, cache)."""
        cfg = self.cfg
        x = embed_apply(params["embed"], tokens, cfg)
        caches = []
        for i in range(cfg.num_layers):
            x, c = block_prefill(layer(params["blocks"]["p0"], i), x, cfg,
                                 max_len)
            caches.append(c)
        cache = {"blocks": {"p0": {
            name: torch.stack([c[name] for c in caches])
            for name in ("k", "v", "pos")}}}
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = unembed_apply(params["embed"], x[:, -1:], cfg)
        return logits, cache

    def decode_step(self, params, cache, token, pos: int):
        """token: (B, 1) ints; pos: int. Returns (logits, cache); the cache
        is updated in place."""
        cfg = self.cfg
        x = embed_apply(params["embed"], token, cfg)
        blocks = params["blocks"]["p0"]
        for i in range(cfg.num_layers):
            x, _ = block_decode(layer(blocks, i), x, cfg,
                                layer(cache["blocks"]["p0"], i), pos)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = unembed_apply(params["embed"], x, cfg)
        return logits, cache
