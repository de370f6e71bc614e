"""Encoder-decoder LM (seamless-m4t's backbone: frames in, text out).

Counterpart of ``repro.models.encdec``. The modality frontend is a stub, as
in the reference: the caller supplies precomputed frame embeddings (B,
S_enc, E). The encoder is ``enc_in``, then bidirectional attention blocks
and ``enc_norm``; each decoder block is causal self-attention, cross
attention over the encoder's output and an MLP. Parameters keep the
reference's tree: ``embed``, ``enc_in``, the stacked ``enc_blocks`` and
``dec_blocks`` (a leading layers axis), ``enc_norm`` and ``final_norm``. The
reference's ``jax.lax.scan`` over each stack is a loop here, and its
``jax.checkpoint`` of each layer (``cfg.remat``) is ``torch.utils.checkpoint``.
The reference checkpoints with JAX's default policy, which saves nothing,
under any remat but "none", so "dots" recomputes each layer here exactly as
"nothing_saveable" does.

Decode keeps a self-attention KV cache plus the cross-attention keys and
values of the encoder's output, computed once by ``prefill``, as a seq2seq
server would. The encoder and the cross attention of ``forward`` and
``prefill`` run the flash kernel on CUDA tensors without a causal mask;
the cross attention attends the first Sq frames there, as the reference
does (``models/attention.py``), while ``decode_step`` attends every frame.
The reference's ``Server`` cannot serve this model (the reference's
``EncDecLM`` has no ``init_cache``), so neither does the port's launcher;
its path is ``prefill`` + ``decode_step``.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.core import tensor_parallel as tp
from repro_torch.core.sharding import model_ways
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (ParamSpec, embed_apply, embed_specs,
                                       init_from_specs, logical_tree,
                                       mlp_apply, mlp_specs, rms_norm,
                                       torch_dtype, unembed_apply)
from repro_torch.models.transformer import (layer, remat, stack_specs,
                                            tree_stack)


def _norm(cfg):
    return ParamSpec((cfg.d_model,), ("embed",), "zeros")


def enc_block_specs(cfg) -> Dict[str, Any]:
    return {"ln1": _norm(cfg), "attn": attn.attention_specs(cfg),
            "ln2": _norm(cfg), "ffn": mlp_specs(cfg)}


def dec_block_specs(cfg) -> Dict[str, Any]:
    return {"ln1": _norm(cfg), "self_attn": attn.attention_specs(cfg),
            "ln_x": _norm(cfg), "cross_attn": attn.cross_attention_specs(cfg),
            "ln2": _norm(cfg), "ffn": mlp_specs(cfg)}


def enc_block_apply(params, x, cfg):
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    x = x + attn.attention_apply(params["attn"], h, cfg, kind="global",
                                 causal=False)
    h = rms_norm(x, params["ln2"], cfg.norm_eps)
    return x + mlp_apply(params["ffn"], h, cfg)


def dec_block_apply(params, x, enc_out, cfg):
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    x = x + attn.attention_apply(params["self_attn"], h, cfg, kind="global")
    h = rms_norm(x, params["ln_x"], cfg.norm_eps)
    x = x + attn.attention_apply(params["cross_attn"], h, cfg, kind="cross",
                                 x_kv=enc_out)
    h = rms_norm(x, params["ln2"], cfg.norm_eps)
    return x + mlp_apply(params["ffn"], h, cfg)


class EncDecLM:
    """Encoder-decoder LM, on one device."""

    def __init__(self, cfg: ModelConfig, device=DEFAULT_DEVICE):
        if cfg.enc_layers <= 0:
            raise ValueError(f"{cfg.name}: an encoder-decoder needs "
                             f"enc_layers > 0")
        self.cfg = cfg
        self.device = resolve_device(device)

    # ---- parameters ----

    def specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "embed": embed_specs(cfg),
            "enc_in": ParamSpec((cfg.d_model, cfg.d_model),
                                ("frontend", "embed")),
            "enc_blocks": stack_specs(enc_block_specs(cfg), cfg.enc_layers),
            "enc_norm": _norm(cfg),
            "dec_blocks": stack_specs(dec_block_specs(cfg), cfg.num_layers),
            "final_norm": _norm(cfg),
        }

    def logical(self):
        return logical_tree(self.specs())

    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Random parameters drawn from ``generator`` (on its device; see
        ``layers.init_from_specs``)."""
        return init_from_specs(generator, self.specs(),
                               torch_dtype(self.cfg.param_dtype),
                               self.device)

    # ---- forward ----

    def check_tensor_parallel(self):
        """Tensor parallelism inside a slice does not cover the
        encoder-decoder yet: raise."""
        tp.refuse(f"{self.cfg.name}: the encoder-decoder (EncDecLM)")

    def encode(self, params, frames):
        """frames: (B, S_enc, E) stub frontend embeddings -> the encoder's
        normalised output (B, S_enc, E) in the compute type."""
        if model_ways() > 1:
            self.check_tensor_parallel()
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        x = frames.to(dt) @ params["enc_in"].to(dt)
        body = remat(cfg, lambda x, blk: enc_block_apply(blk, x, cfg),
                     policy="nothing_saveable")
        for i in range(cfg.enc_layers):
            x = body(x, layer(params["enc_blocks"], i))
        return rms_norm(x, params["enc_norm"], cfg.norm_eps)

    def forward(self, params, frames, tokens):
        """frames (B, S_enc, E), tokens (B, S) -> (fp32 logits (B, S, V),
        aux loss 0)."""
        cfg = self.cfg
        enc_out = self.encode(params, frames)
        x = embed_apply(params["embed"], tokens, cfg)
        body = remat(cfg, lambda x, enc_out, blk: dec_block_apply(
            blk, x, enc_out, cfg), policy="nothing_saveable")
        for i in range(cfg.num_layers):
            x = body(x, enc_out, layer(params["dec_blocks"], i))
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return unembed_apply(params["embed"], x, cfg), torch.zeros(
            (), dtype=torch.float32, device=x.device)

    def loss(self, params, batch):
        """batch: frontend (B, S_enc, E), tokens (B, S), labels (B, S) [-1
        = masked] -> (loss, {"ce", "aux"}): the mean fp32 cross-entropy over
        unmasked labels (at least one in the denominator)."""
        logits, aux = self.forward(params, batch["frontend"],
                                   batch["tokens"])
        labels = batch["labels"]
        mask = labels >= 0
        logp = F.log_softmax(logits.float(), dim=-1)
        ll = logp.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
        loss = -(ll * mask).sum() / mask.sum().clamp_min(1)
        return loss, {"ce": loss, "aux": aux}

    # ---- serving ----

    def cache_specs(self, batch: int, max_len: int) -> Dict[str, Any]:
        """As the reference's: each decoder layer's self cache and its
        cross keys and values, specified ``max_len`` long (``prefill``
        fills them from the frames, as long as the frames)."""
        cfg = self.cfg
        kv, hd = cfg.num_kv_heads, cfg.head_dim
        axes = ("batch", "kv_seq", "kv_heads", "head_dim")
        unit = {"self": attn.cache_specs(cfg, batch, max_len),
                "cross_k": ParamSpec((batch, max_len, kv, hd), axes, "zeros"),
                "cross_v": ParamSpec((batch, max_len, kv, hd), axes, "zeros")}
        return {"dec_blocks": stack_specs(unit, cfg.num_layers)}

    def init_cache(self, batch: int, max_len: int):
        """Zeros of ``cache_specs`` in the compute type, positions -1."""
        dtype = torch_dtype(self.cfg.dtype)

        def build(name, spec):
            if isinstance(spec, dict):
                return {k: build(k, v) for k, v in spec.items()}
            if name == "pos":
                return torch.full(spec.shape, -1, dtype=torch.int32,
                                  device=self.device)
            return torch.zeros(spec.shape, dtype=dtype, device=self.device)

        return build("", self.cache_specs(batch, max_len))

    def prefill(self, params, frames, tokens, max_len: int):
        """Encode, then run the decoder over the prompt: (last-position
        logits, cache), the cache holding each layer's self cache (``max_len``
        long) and the cross keys and values of the whole encoder output."""
        cfg = self.cfg
        enc_out = self.encode(params, frames)
        x = embed_apply(params["embed"], tokens, cfg)
        caches = []
        for i in range(cfg.num_layers):
            blk = layer(params["dec_blocks"], i)
            h = rms_norm(x, blk["ln1"], cfg.norm_eps)
            y, self_cache = attn.attention_prefill(
                blk["self_attn"], h, cfg, kind="global", cache_len=max_len)
            x = x + y
            h = rms_norm(x, blk["ln_x"], cfg.norm_eps)
            dt = x.dtype
            ck = torch.einsum("bse,ehd->bshd", enc_out,
                              blk["cross_attn"]["wk"].to(dt))
            cv = torch.einsum("bse,ehd->bshd", enc_out,
                              blk["cross_attn"]["wv"].to(dt))
            x = x + attn.attention_apply(blk["cross_attn"], h, cfg,
                                         kind="cross", x_kv=enc_out)
            h = rms_norm(x, blk["ln2"], cfg.norm_eps)
            x = x + mlp_apply(blk["ffn"], h, cfg)
            caches.append({"self": self_cache, "cross_k": ck, "cross_v": cv})
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = unembed_apply(params["embed"], x[:, -1:], cfg)
        return logits, {"dec_blocks": tree_stack(caches)}

    def decode_step(self, params, cache, token, pos: int):
        """token: (B, 1) ints; pos: int. Returns (logits, cache); the self
        caches are updated in place."""
        if model_ways() > 1:
            self.check_tensor_parallel()
        cfg = self.cfg
        x = embed_apply(params["embed"], token, cfg)
        for i in range(cfg.num_layers):
            blk = layer(params["dec_blocks"], i)
            c = layer(cache["dec_blocks"], i)
            h = rms_norm(x, blk["ln1"], cfg.norm_eps)
            y, _ = attn.decode_attention(blk["self_attn"], h, cfg, c["self"],
                                         pos)
            x = x + y
            h = rms_norm(x, blk["ln_x"], cfg.norm_eps)
            x = x + _cross_decode(blk["cross_attn"], h, cfg, c["cross_k"],
                                  c["cross_v"])
            h = rms_norm(x, blk["ln2"], cfg.norm_eps)
            x = x + mlp_apply(blk["ffn"], h, cfg)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return unembed_apply(params["embed"], x, cfg), cache


def _cross_decode(params, x, cfg, ck, cv):
    """One query's cross attention over every frame's precomputed keys and
    values ck / cv (B, S_enc, KV, D), in plain torch as the reference."""
    b = x.shape[0]
    dt = x.dtype
    q = torch.einsum("bse,ehd->bshd", x, params["wq"].to(dt))
    kvh, hd = ck.shape[2], ck.shape[3]
    g = cfg.num_heads // kvh
    qg = q.reshape(b, 1, kvh, g, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, ck).float()
    p = torch.softmax(logits / math.sqrt(hd), dim=-1)
    out = torch.einsum("bkgqs,bskd->bkgqd", p.to(dt), cv)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, cfg.num_heads, hd)
    return torch.einsum("bshd,hde->bse", out, params["wo"].to(dt))
