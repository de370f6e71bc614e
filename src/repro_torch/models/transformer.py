"""Decoder-only LM over a repeating pattern of block kinds.

Counterpart of ``repro.models.transformer.CausalLM`` for the decoder
families: "global" attention (smollm, qwen3, granite), "local" and
"global" with softcaps (gemma2), "ssd" (mamba2), "rglru" with "local"
sliding-window attention (recurrentgemma), and "moe", global attention
with a mixture-of-experts feed-forward (phi3.5, deepseek, whose first
layers are dense). An attention kind in a "moe" family config also takes
the mixture-of-experts feed-forward, as in the reference. Parameters
and caches keep the reference's tree: ``head{i}`` for the first dense
layers, the pattern's blocks stacked under ``blocks.p{j}`` with a leading
layers axis, and an unstacked ``tail{t}`` when the depth is not a multiple
of the pattern. The reference's ``jax.lax.scan`` over the stacked axis is a
loop here, and its ``jax.checkpoint`` of each pattern unit (``cfg.remat``)
is ``torch.utils.checkpoint``, selective under "dots". ``loss`` is the
training objective: masked next-token cross-entropy, optionally over
sequence chunks so that the (B, S, V) logits never materialise, plus the
routers' summed load-balancing loss. A modality frontend (paligemma's
patches) is a stub, as in the reference: ``forward`` and ``prefill`` take
its embeddings (``extra_embeds``, ``batch["frontend"]`` in ``loss``) and
prepend them to the token embeddings; its positions carry no labels.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                     create_selective_checkpoint_contexts)

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (ParamSpec, embed_apply, embed_specs,
                                       init_from_specs, logical_tree,
                                       mlp_apply,
                                       mlp_specs, rms_norm, torch_dtype,
                                       tree_map, unembed_apply)


def stack_specs(specs, n: int):
    return tree_map(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.logical,
                            s.init, s.scale), specs)


def layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, so writes reach the stack)."""
    return tree_map(lambda x: x[i], tree)


def tree_stack(trees):
    """Trees of one structure -> one tree of tensors stacked on a new axis 0."""
    if isinstance(trees[0], dict):
        return {k: tree_stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# the matrix products that ``x @ w``, ``torch.matmul`` and ``einsum`` reach:
# what ``jax.checkpoint_policies.checkpoint_dots`` saves (every
# ``dot_general``, batched ones included); and the flash forward kernel's
# op, whose output and log-sum-exp stand for the attention products the
# reference's chunked attention saves
DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
        torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default,
        torch.ops.repro_torch.flash_attention_fwd.default)


def _save_dots():
    return create_selective_checkpoint_contexts(list(DOTS))


def remat(cfg: ModelConfig, unit, policy: Optional[str] = None):
    """``unit`` under ``cfg.remat`` when torch records a graph:
    "nothing_saveable" keeps only the unit's input and recomputes the rest
    in the backward pass (the reference's ``jax.checkpoint`` with
    ``nothing_saveable``); "dots" also keeps the outputs of the unit's
    matrix products (``DOTS``) and recomputes everything else (its
    ``checkpoint_dots``), by torch's selective checkpoint; "none" saves
    activations as usual. Under "dots" the flash forward's op is saved
    too, so the recompute does not launch it again (under
    "nothing_saveable" it does). ``policy``, when given, is what any remat but "none" saves: the
    encoder-decoder checkpoints each layer with JAX's default policy,
    "nothing_saveable", whatever ``cfg.remat`` names. Remat moves memory
    only, not numbers."""
    if cfg.remat not in ("none", "nothing_saveable", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return unit
    if (policy or cfg.remat) == "nothing_saveable":
        return lambda *args: checkpoint(unit, *args, use_reentrant=False)
    return lambda *args: checkpoint(unit, *args, use_reentrant=False,
                                    context_fn=_save_dots)


# -- block definitions -------------------------------------------------------


def block_specs(cfg: ModelConfig, kind: str, dense_ff: Optional[int] = None
                ) -> Dict[str, Any]:
    e = cfg.d_model

    def norm():
        return ParamSpec((e,), ("embed",), "zeros")

    if kind in attn.KINDS:
        # a "moe" block, or an attention block of a "moe" family config,
        # has a mixture-of-experts feed-forward unless it is a first dense
        # layer
        moe = ((kind == "moe" and not dense_ff)
               or (cfg.family == "moe" and dense_ff is None))
        return {"ln1": norm(), "attn": attn.attention_specs(cfg),
                "ln2": norm(),
                "ffn": (moe_mod.moe_specs(cfg) if moe
                        else mlp_specs(cfg, d_ff=dense_ff))}
    if kind == "ssd":
        return {"ln1": norm(), "mixer": ssm_mod.ssd_specs(cfg)}
    if kind == "rglru":
        return {"ln1": norm(), "mixer": rglru_mod.rglru_specs(cfg),
                "ln2": norm(), "ffn": mlp_specs(cfg)}
    raise ValueError(kind)


def ffn_apply(params, h, cfg: ModelConfig, capacity_factor=None):
    """The feed-forward of an attention block: the mixture of experts where
    it has a router, else the gated MLP. -> (y, aux loss or None)."""
    if "router" in params:
        return moe_mod.moe_apply(params, h, cfg,
                                 capacity_factor=capacity_factor)
    return mlp_apply(params, h, cfg), None


def block_apply(params, x, cfg: ModelConfig, kind: str, aux):
    """One block, training / prefill path (full sequence). -> (x, aux plus
    the block's router loss)."""
    if kind in attn.KINDS:
        h = rms_norm(x, params["ln1"], cfg.norm_eps)
        x = x + attn.attention_apply(params["attn"], h, cfg, kind=kind)
        h = rms_norm(x, params["ln2"], cfg.norm_eps)
        y, a = ffn_apply(params["ffn"], h, cfg)
        return x + y, aux if a is None else aux + a
    if kind == "ssd":
        h = rms_norm(x, params["ln1"], cfg.norm_eps)
        return x + ssm_mod.ssd_apply(params["mixer"], h, cfg), aux
    if kind == "rglru":
        h = rms_norm(x, params["ln1"], cfg.norm_eps)
        x = x + rglru_mod.rglru_mixer_apply(params["mixer"], h, cfg)
        h = rms_norm(x, params["ln2"], cfg.norm_eps)
        return x + mlp_apply(params["ffn"], h, cfg), aux
    raise ValueError(kind)


# -- block caches -------------------------------------------------------------


def block_cache_specs(cfg, kind: str, batch: int, max_len: int):
    if kind in attn.KINDS:
        return attn.cache_specs(cfg, batch,
                                attn.cache_length(cfg, kind, max_len))
    if kind == "ssd":
        return ssm_mod.ssd_cache_specs(cfg, batch)
    if kind == "rglru":
        return rglru_mod.rglru_cache_specs(cfg, batch)
    raise ValueError(kind)


def block_decode(params, x, cfg: ModelConfig, kind: str, cache, pos: int):
    """One-token step; the block's cache is updated in place."""
    if kind in attn.KINDS:
        h = rms_norm(x, params["ln1"], cfg.norm_eps)
        y, cache = attn.decode_attention(params["attn"], h, cfg, cache, pos,
                                         window=attn.window_of(cfg, kind))
        x = x + y
        h = rms_norm(x, params["ln2"], cfg.norm_eps)
        # capacity factor top_k, as the reference: at S 1 capacity's floor
        # gives every expert 8 slots, so no choice drops
        y, _ = ffn_apply(params["ffn"], h, cfg,
                         capacity_factor=float(cfg.top_k))
        return x + y, cache
    if kind == "ssd":
        h = rms_norm(x, params["ln1"], cfg.norm_eps)
        y, cache = ssm_mod.ssd_decode(params["mixer"], h, cfg, cache)
        return x + y, cache
    if kind == "rglru":
        h = rms_norm(x, params["ln1"], cfg.norm_eps)
        y, cache = rglru_mod.rglru_decode(params["mixer"], h, cfg, cache)
        x = x + y
        h = rms_norm(x, params["ln2"], cfg.norm_eps)
        return x + mlp_apply(params["ffn"], h, cfg), cache
    raise ValueError(kind)


def block_prefill(params, x, cfg: ModelConfig, kind: str, max_len: int):
    """Full-sequence forward that also fills the block cache."""
    if kind in attn.KINDS:
        h = rms_norm(x, params["ln1"], cfg.norm_eps)
        y, cache = attn.attention_prefill(params["attn"], h, cfg, kind=kind,
                                          cache_len=max_len)
        x = x + y
        h = rms_norm(x, params["ln2"], cfg.norm_eps)
        y, _ = ffn_apply(params["ffn"], h, cfg)
        return x + y, cache
    if kind == "ssd":
        h = rms_norm(x, params["ln1"], cfg.norm_eps)
        y, cache = ssm_mod.ssd_prefill(params["mixer"], h, cfg)
        return x + y, cache
    if kind == "rglru":
        h = rms_norm(x, params["ln1"], cfg.norm_eps)
        y, cache = rglru_mod.rglru_prefill(params["mixer"], h, cfg)
        x = x + y
        h = rms_norm(x, params["ln2"], cfg.norm_eps)
        return x + mlp_apply(params["ffn"], h, cfg), cache
    raise ValueError(kind)


# -- the model -----------------------------------------------------------------


class CausalLM:
    """Decoder-only LM over ``cfg.pattern``, on one device."""

    def __init__(self, cfg: ModelConfig, device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.device = resolve_device(device)

    # ---- layout ----

    def _pattern_layout(self) -> Tuple[int, int]:
        """(full pattern repeats, tail length) after the first dense layers."""
        cfg = self.cfg
        n = cfg.num_layers - cfg.first_dense_layers
        return n // len(cfg.pattern), n % len(cfg.pattern)

    def _layers(self):
        """(key, stacked slot or None, kind) of every block, in order:
        ``head{i}``, then ``blocks`` (slot ``(p{j}, repeat)``), then
        ``tail{t}``."""
        cfg = self.cfg
        reps, tail = self._pattern_layout()
        for i in range(cfg.first_dense_layers):
            yield f"head{i}", None, cfg.pattern[0]
        for r in range(reps):
            for j, kind in enumerate(cfg.pattern):
                yield "blocks", (f"p{j}", r), kind
        for t in range(tail):
            yield f"tail{t}", None, cfg.pattern[t]

    @staticmethod
    def _select(tree, key: str, slot):
        return tree[key] if slot is None else layer(tree[key][slot[0]],
                                                    slot[1])

    # ---- parameters ----

    def specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        reps, tail = self._pattern_layout()
        specs: Dict[str, Any] = {"embed": embed_specs(cfg)}
        for i in range(cfg.first_dense_layers):
            specs[f"head{i}"] = block_specs(
                cfg, cfg.pattern[0],
                dense_ff=cfg.first_dense_ff or cfg.d_ff)
        if reps > 0:
            unit = {f"p{j}": block_specs(cfg, kind)
                    for j, kind in enumerate(cfg.pattern)}
            specs["blocks"] = stack_specs(unit, reps)
        for t in range(tail):
            specs[f"tail{t}"] = block_specs(cfg, cfg.pattern[t])
        specs["final_norm"] = ParamSpec((cfg.d_model,), ("embed",), "zeros")
        return specs

    def logical(self):
        """The logical axis names of every parameter, the tree of
        ``specs()``."""
        return logical_tree(self.specs())

    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Random parameters drawn from ``generator`` (on its device; see
        ``layers.init_from_specs``)."""
        return init_from_specs(generator, self.specs(),
                               torch_dtype(self.cfg.param_dtype),
                               self.device)

    # ---- forward (training / prefill trunk) ----

    def _trunk(self, params, x):
        """-> (normalised hidden states, the routers' summed loss, fp32)."""
        cfg = self.cfg
        reps, tail = self._pattern_layout()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.first_dense_layers):
            x, aux = block_apply(params[f"head{i}"], x, cfg, cfg.pattern[0],
                                 aux)

        def unit(x, aux, unit_params):
            for j, kind in enumerate(cfg.pattern):
                x, aux = block_apply(unit_params[f"p{j}"], x, cfg, kind, aux)
            return x, aux

        unit = remat(cfg, unit)
        for r in range(reps):
            x, aux = unit(x, aux, layer(params["blocks"], r))
        for t in range(tail):
            x, aux = block_apply(params[f"tail{t}"], x, cfg, cfg.pattern[t],
                                 aux)
        return rms_norm(x, params["final_norm"], cfg.norm_eps), aux

    def _embed(self, params, tokens, extra_embeds=None):
        """Token embeddings (B, S, E), after ``extra_embeds`` (B, S_front, E)
        cast to the compute type when given."""
        x = embed_apply(params["embed"], tokens, self.cfg)
        if extra_embeds is None:
            return x
        return torch.cat([extra_embeds.to(x.dtype), x], dim=1)

    def forward(self, params, tokens, extra_embeds=None):
        """tokens: (B, S) -> (fp32 logits (B, S_front + S, V), aux loss);
        ``extra_embeds`` (B, S_front, E): the modality stub's embeddings,
        prepended to the sequence."""
        x, aux = self._trunk(params, self._embed(params, tokens,
                                                 extra_embeds))
        return unembed_apply(params["embed"], x, self.cfg), aux

    def loss(self, params, batch):
        """batch: tokens (B, S), labels (B, S) [-1 = masked], optionally
        frontend embeddings (B, S_front, E) -> (loss + aux, {"ce", "aux"}):
        the mean fp32 cross-entropy over unmasked labels (at least one in
        the denominator); the frontend positions carry no labels. With
        ``cfg.ce_chunk`` the trunk runs once, then the unembedding and
        log-softmax per chunk of that many positions, so the (B, S, V)
        logits never materialise."""
        cfg = self.cfg
        front = batch.get("frontend")
        n_front = 0 if front is None else front.shape[1]
        labels = batch["labels"]
        mask = labels >= 0
        labels = labels.clamp_min(0).long()
        denom = mask.sum().clamp_min(1)

        def nll(logits, labels, mask):
            lp = F.log_softmax(logits.float(), dim=-1)
            ll = lp.gather(-1, labels[..., None])[..., 0]
            return -(ll * mask).sum()

        if cfg.ce_chunk:
            x, aux = self._trunk(params, self._embed(params, batch["tokens"],
                                                     front))
            x = x[:, n_front:]
            c = cfg.ce_chunk
            total = sum(nll(unembed_apply(params["embed"], x[:, i:i + c],
                                          cfg),
                            labels[:, i:i + c], mask[:, i:i + c])
                        for i in range(0, x.shape[1], c))
        else:
            logits, aux = self.forward(params, batch["tokens"], front)
            total = nll(logits[:, n_front:], labels, mask)
        loss = total / denom
        return loss + aux, {"ce": loss, "aux": aux}

    # ---- serving ----

    def cache_specs(self, batch: int, max_len: int) -> Dict[str, Any]:
        cfg = self.cfg
        reps, tail = self._pattern_layout()
        out: Dict[str, Any] = {}
        for i in range(cfg.first_dense_layers):
            out[f"head{i}"] = block_cache_specs(cfg, cfg.pattern[0], batch,
                                                max_len)
        if reps > 0:
            unit = {f"p{j}": block_cache_specs(cfg, kind, batch, max_len)
                    for j, kind in enumerate(cfg.pattern)}
            out["blocks"] = stack_specs(unit, reps)
        for t in range(tail):
            out[f"tail{t}"] = block_cache_specs(cfg, cfg.pattern[t], batch,
                                                max_len)
        return out

    def init_cache(self, batch: int, max_len: int):
        """Zeros in the model's dtype, except the positions ("pos", -1) and
        the recurrent states ("state", "h", fp32)."""
        dtype = torch_dtype(self.cfg.dtype)

        def build(name, spec):
            if isinstance(spec, dict):
                return {k: build(k, v) for k, v in spec.items()}
            if name == "pos":
                return torch.full(spec.shape, -1, dtype=torch.int32,
                                  device=self.device)
            if name in ("state", "h"):
                return torch.zeros(spec.shape, dtype=torch.float32,
                                   device=self.device)
            return torch.zeros(spec.shape, dtype=dtype, device=self.device)

        return build("", self.cache_specs(batch, max_len))

    def prefill(self, params, tokens, max_len: int, extra_embeds=None):
        """Run the full prompt (after ``extra_embeds``, as in forward),
        returning (last-position logits, cache). With extra embeddings the
        cache holds their positions first: decode the next token at
        ``S_front + S``."""
        cfg = self.cfg
        x = self._embed(params, tokens, extra_embeds)
        cache: Dict[str, Any] = {}
        for key, slot, kind in self._layers():
            x, c = block_prefill(self._select(params, key, slot), x, cfg,
                                 kind, max_len)
            if slot is None:
                cache[key] = c
            else:
                cache.setdefault(key, {}).setdefault(slot[0], []).append(c)
        if "blocks" in cache:
            cache["blocks"] = {pj: tree_stack(cs)
                               for pj, cs in cache["blocks"].items()}
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = unembed_apply(params["embed"], x[:, -1:], cfg)
        return logits, cache

    def decode_step(self, params, cache, token, pos: int):
        """token: (B, 1) ints; pos: int. Returns (logits, cache); the cache
        is updated in place."""
        cfg = self.cfg
        x = embed_apply(params["embed"], token, cfg)
        for key, slot, kind in self._layers():
            x, _ = block_decode(self._select(params, key, slot), x, cfg,
                                kind, self._select(cache, key, slot), pos)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = unembed_apply(params["embed"], x, cfg)
        return logits, cache
