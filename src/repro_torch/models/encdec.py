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

Under tensor parallelism inside a slice (``model`` > 1 in the active
``activation_rules``) every method takes one parameter tree per model
coordinate and runs the layers in lockstep, as ``CausalLM`` does: the
self and cross attention by heads, the MLP by its columns, the vocab by
rows; ``enc_in`` (("frontend", "embed")) stays whole on every coordinate,
and each coordinate's cross attention reads its own copy of the encoder's
output. The cross keys and values of ``prefill``'s cache come back whole.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.core import tensor_parallel as tp
from repro_torch.core.sharding import constrain, model_ways
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (ParamSpec, embed_apply, embed_specs,
                                       init_from_specs, logical_tree,
                                       mlp_apply, mlp_specs, rms_norm,
                                       torch_dtype, unembed_apply)
from repro_torch.models.transformer import (BSE, kv_view, layer, remat,
                                            stack_specs, tp_attention_half,
                                            tp_embed, tp_ffn, tp_logits,
                                            tp_parts, tp_residual,
                                            tree_stack, vocab_parallel_nll,
                                            whole_cache)


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


# -- tensor parallelism: a layer in lockstep over the model coordinates -------


def tp_enc_block(parts, xs, cfg, spec):
    """:func:`enc_block_apply` over the model coordinates (``parts`` each
    coordinate's blocks of the layer, ``spec`` its ParamSpecs)."""
    xs, ys, partial = tp_attention_half(parts, xs, cfg, (
        lambda p, h, h0, m: attn.attention_apply(p, h, cfg, kind="global",
                                                 causal=False, head0=h0)))
    return tp_ffn(parts, tp_residual(xs, ys, partial), cfg, spec)[0]


def tp_dec_block(parts, xs, enc_outs, cfg, spec):
    """:func:`dec_block_apply` over the model coordinates: the cross
    attention of coordinate ``m`` reads its copy ``enc_outs[m]`` of the
    encoder's output."""
    xs, ys, partial = tp_attention_half(parts, xs, cfg, (
        lambda p, h, h0, m: attn.attention_apply(p, h, cfg, kind="global",
                                                 head0=h0)), key="self_attn")
    xs, ys, partial = tp_attention_half(
        parts, tp_residual(xs, ys, partial), cfg,
        lambda p, h, h0, m: attn.attention_apply(
            p, h, cfg, kind="cross", x_kv=enc_outs[m], head0=h0),
        ln="ln_x", key="cross_attn")
    return tp_ffn(parts, tp_residual(xs, ys, partial), cfg, spec)[0]


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

    def _tp_encode(self, parts, frames):
        """:meth:`encode` in lockstep: each coordinate's copy of the
        encoder's output."""
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        xs = constrain([frames.to(p["enc_in"].device, dt)
                        @ p["enc_in"].to(dt) for p in parts], BSE)
        spec = enc_block_specs(cfg)
        body = remat(cfg, lambda xs, blks: tp_enc_block(blks, xs, cfg, spec),
                     policy="nothing_saveable")
        for i in range(cfg.enc_layers):
            xs = body(xs, [layer(p["enc_blocks"], i) for p in parts])
        return [rms_norm(x, p["enc_norm"], cfg.norm_eps)
                for p, x in zip(parts, xs)]

    def _tp_decode_all(self, parts, frames, tokens):
        """The decoder over the whole prompt in lockstep: each
        coordinate's normalised hidden states."""
        cfg = self.cfg
        enc_outs = self._tp_encode(parts, frames)
        xs = tp_embed(parts, tokens, cfg)
        spec = dec_block_specs(cfg)
        body = remat(cfg, lambda xs, enc_outs, blks: tp_dec_block(
            blks, xs, enc_outs, cfg, spec), policy="nothing_saveable")
        for i in range(cfg.num_layers):
            xs = body(xs, enc_outs, [layer(p["dec_blocks"], i)
                                     for p in parts])
        return [rms_norm(x, p["final_norm"], cfg.norm_eps)
                for p, x in zip(parts, xs)]

    def encode(self, params, frames):
        """frames: (B, S_enc, E) stub frontend embeddings -> the encoder's
        normalised output (B, S_enc, E) in the compute type."""
        if model_ways() > 1:
            return self._tp_encode(tp_parts(params), frames)[0]
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
        if model_ways() > 1:
            parts = tp_parts(params)
            xs = self._tp_decode_all(parts, frames, tokens)
            return tp.all_gather(tp_logits(parts, xs, cfg)[0], -1), \
                torch.zeros((), dtype=torch.float32, device=xs[0].device)
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
        unmasked labels (at least one in the denominator); under tensor
        parallelism the cross-entropy over the vocab's blocks."""
        labels = batch["labels"]
        mask = labels >= 0
        if model_ways() > 1:
            parts = tp_parts(params)
            xs = self._tp_decode_all(parts, batch["frontend"],
                                     batch["tokens"])
            total = vocab_parallel_nll(*tp_logits(parts, xs, self.cfg),
                                       labels.clamp_min(0).long(), mask)
            loss = total / mask.sum().clamp_min(1).to(total.device)
            aux = torch.zeros((), dtype=torch.float32, device=loss.device)
            return loss, {"ce": loss, "aux": aux}
        logits, aux = self.forward(params, batch["frontend"],
                                   batch["tokens"])
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
        if model_ways() > 1:
            return self._tp_prefill(tp_parts(params), frames, tokens,
                                    max_len)
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
            return self._tp_decode_step(tp_parts(params), cache, token, pos)
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

    def _tp_prefill(self, parts, frames, tokens, max_len: int):
        """:meth:`prefill` in lockstep; each layer's self cache and cross
        keys and values come back whole (``whole_cache``)."""
        cfg = self.cfg
        enc_outs = self._tp_encode(parts, frames)
        xs = tp_embed(parts, tokens, cfg)
        spec = dec_block_specs(cfg)

        def cross(p, h, h0, m):
            dt = h.dtype
            kv = {w: torch.einsum("bse,ehd->bshd", enc_outs[m], p[f"w{w}"]
                                  .to(dt)) for w in ("k", "v")}
            return attn.attention_apply(p, h, cfg, kind="cross",
                                        x_kv=enc_outs[m], head0=h0), kv

        caches = []
        for i in range(cfg.num_layers):
            blks = [layer(p["dec_blocks"], i) for p in parts]
            xs, outs, partial = tp_attention_half(blks, xs, cfg, (
                lambda p, h, h0, m: attn.attention_prefill(
                    p, h, cfg, kind="global", cache_len=max_len, head0=h0)),
                key="self_attn")
            xs = tp_residual(xs, [y for y, _ in outs], partial)
            self_cache = whole_cache([c for _, c in outs], cfg)
            xs, outs, partial = tp_attention_half(blks, xs, cfg, cross,
                                                  ln="ln_x", key="cross_attn")
            xs = tp_residual(xs, [y for y, _ in outs], partial)
            kv = whole_cache([c for _, c in outs], cfg)
            xs = tp_ffn(blks, xs, cfg, spec)[0]
            caches.append({"self": self_cache, "cross_k": kv["k"],
                           "cross_v": kv["v"]})
        xs = [rms_norm(x[:, -1:], p["final_norm"], cfg.norm_eps)
              for p, x in zip(parts, xs)]
        return (tp.all_gather(tp_logits(parts, xs, cfg)[0], -1),
                {"dec_blocks": tree_stack(caches)})

    def _tp_decode_step(self, parts, cache, token, pos: int):
        """:meth:`decode_step` in lockstep on a whole cache: each
        coordinate reads and writes its KV heads' view (``kv_view``)."""
        cfg = self.cfg
        xs = tp_embed(parts, token, cfg)
        spec = dec_block_specs(cfg)
        for i in range(cfg.num_layers):
            blks = [layer(p["dec_blocks"], i) for p in parts]
            c = layer(cache["dec_blocks"], i)
            xs, ys, partial = tp_attention_half(blks, xs, cfg, (
                lambda p, h, h0, m: attn.decode_attention(
                    p, h, cfg, kv_view(c["self"], cfg, p, h0), pos,
                    head0=h0)[0]), key="self_attn")

            def cross(p, h, h0, m, c=c):
                kv = kv_view({"k": c["cross_k"], "v": c["cross_v"]}, cfg, p,
                             h0)
                return _cross_decode(p, h, cfg, kv["k"], kv["v"], head0=h0)

            xs, ys, partial = tp_attention_half(
                blks, tp_residual(xs, ys, partial), cfg, cross, ln="ln_x",
                key="cross_attn")
            xs = tp_ffn(blks, tp_residual(xs, ys, partial), cfg, spec)[0]
        xs = [rms_norm(x, p["final_norm"], cfg.norm_eps)
              for p, x in zip(parts, xs)]
        return tp.all_gather(tp_logits(parts, xs, cfg)[0], -1), cache


def _cross_decode(params, x, cfg, ck, cv, head0: int = 0):
    """One query's cross attention over every frame's precomputed keys and
    values ck / cv (B, S_enc, KV, D), in plain torch as the reference; under
    tensor parallelism on the query heads of ``params["wq"]`` from
    ``head0`` on (``attention.kv_for_heads``)."""
    b = x.shape[0]
    dt = x.dtype
    q = torch.einsum("bse,ehd->bshd", x, params["wq"].to(dt))
    h = q.shape[2]
    ck, cv = attn.kv_for_heads(ck, cv, cfg, head0, h)
    kvh, hd = ck.shape[2], ck.shape[3]
    qg = q.reshape(b, 1, kvh, h // kvh, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, ck).float()
    p = torch.softmax(logits / math.sqrt(hd), dim=-1)
    out = torch.einsum("bkgqs,bskd->bkgqd", p.to(dt), cv)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, h, hd)
    return torch.einsum("bshd,hde->bse", out, params["wo"].to(dt))
