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

Under an ``activation_rules`` context whose mesh has ``model`` > 1 (tensor
parallelism inside a slice), ``forward``, ``loss``, ``prefill`` and
``decode_step`` take one parameter tree per model coordinate, each that
coordinate's blocks (``core.tensor_parallel.model_block``), and run the
blocks in lockstep over the coordinates: each sublayer once per
coordinate, its partial sums added by ``constrain`` at the reference's
points. The attention splits by heads and the MLP by its columns (the
down projection by rows); the SSD mixer by heads and the RG-LRU mixer by
its width (``ssm.tp_mixer``, ``rglru.tp_mixer``); the mixture of experts
by experts (``moe.tp_moe_apply``); the embedding and the logits split by
vocab, and ``loss`` is the cross-entropy over the vocab's blocks. Whether
a leaf is split is read from its shape against the whole shape of its
spec; whatever the rules leave whole every coordinate computes whole.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                     create_selective_checkpoint_contexts)

from repro_torch.core import tensor_parallel as tp
from repro_torch.core.sharding import (constrain, keep_activation_rules,
                                       model_ways)
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


def layer_key(key: str, slot=None) -> str:
    """The name of a block of ``CausalLM._layers()``: ``head{i}``,
    ``blocks.p{j}.{repeat}`` or ``tail{t}``."""
    return key if slot is None else f"{key}.{slot[0]}.{slot[1]}"


def block_load(loads, key: str, slot=None):
    """Block ``key`` (``slot``)'s entry of ``loads`` (its ``load``, by
    layer key: ``CausalLM.router_loads``), or None."""
    return None if loads is None else loads.get(layer_key(key, slot))


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
    # the recompute sees the activation rules of the forward call
    if (policy or cfg.remat) == "nothing_saveable":
        return lambda *args: checkpoint(keep_activation_rules(unit), *args,
                                        use_reentrant=False)
    return lambda *args: checkpoint(keep_activation_rules(unit), *args,
                                    use_reentrant=False,
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


def ffn_apply(params, h, cfg: ModelConfig, capacity_factor=None,
              load=None):
    """The feed-forward of an attention block: the mixture of experts where
    it has a router (``load`` as ``moe.route_logits``), else the gated
    MLP. -> (y, aux loss or None)."""
    if "router" in params:
        return moe_mod.moe_apply(params, h, cfg,
                                 capacity_factor=capacity_factor, load=load)
    return mlp_apply(params, h, cfg), None


def block_apply(params, x, cfg: ModelConfig, kind: str, aux, load=None):
    """One block, training / prefill path (full sequence). -> (x, aux plus
    the block's router loss); ``load``: the block's routed share of the
    whole batch, or a list to append its own to (``moe.route_logits``)."""
    if kind in attn.KINDS:
        h = rms_norm(x, params["ln1"], cfg.norm_eps)
        x = x + attn.attention_apply(params["attn"], h, cfg, kind=kind)
        h = rms_norm(x, params["ln2"], cfg.norm_eps)
        y, a = ffn_apply(params["ffn"], h, cfg, load=load)
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


# -- tensor parallelism: a block in lockstep over the model coordinates ------

BSE = ("batch", "seq", "embed")
MIXERS = {"ssd": ssm_mod, "rglru": rglru_mod}


def tp_parts(params) -> list:
    """``params`` as one tree per model coordinate, checked."""
    if not isinstance(params, (list, tuple)) or len(params) != model_ways():
        raise TypeError(f"under {model_ways()} model ways the model takes "
                        "one parameter tree per model coordinate")
    return list(params)


def tp_attention(parts, cfg, key: str = "attn"):
    """Each coordinate's attention parameters (``parts[m][key]``) and first
    query head, and whether its outputs are partial sums. Where the rules
    split the heads, a coordinate holds its block of ``wq`` and ``wo`` (a
    partial sum over its heads) and of ``wk`` / ``wv`` or, where the KV
    heads do not divide, all of them. Where the heads do not divide,
    ``wq`` and ``wo`` are whole and so is each coordinate's attention
    (summed once, not once per coordinate); ``wk`` and ``wv``, if split,
    are gathered first."""
    ps = [p[key] for p in parts]
    hq = ps[0]["wq"].shape[1]
    if hq < cfg.num_heads:
        return [(p, m * hq) for m, p in enumerate(ps)], True
    if ps[0]["wk"].shape[1] < cfg.num_kv_heads:
        ps = [dict(p, **{w: tp.all_gather([q[w] for q in ps], 1).to(
            p["wq"].device) for w in ("wk", "wv")}) for p in ps]
    return [(p, 0) for p in ps], False


def tp_residual(xs, ys, partial: bool):
    """``xs + ys`` on every coordinate, the sublayer outputs ``ys`` summed
    over the coordinates first where they are partial sums."""
    ys = constrain(tp.Partial(ys) if partial else ys, BSE)
    return [x + y for x, y in zip(xs, ys)]


def tp_ffn(parts, xs, cfg, spec, capacity_factor=None, load=None):
    """The feed-forward half of a block (``ln2``, ``ffn``) over the model
    coordinates: the gated MLP, ``w_gate`` and ``w_up`` by column and
    ``w_down`` by row, or the mixture of experts
    (``moe.tp_moe_apply``, which takes ``load``); each coordinate's output
    a partial sum where the rules split the leaves, which ``spec`` (the
    block's ParamSpecs) tells from the leaves' whole shapes. -> (xs, the
    aux loss or None)."""
    hs = [rms_norm(x, p["ln2"], cfg.norm_eps) for p, x in zip(parts, xs)]
    ffn = [p["ffn"] for p in parts]
    if "router" in ffn[0]:
        ys, partial, aux = moe_mod.tp_moe_apply(ffn, hs, cfg, spec["ffn"],
                                                capacity_factor, load)
    else:
        ys = [mlp_apply(p, h, cfg) for p, h in zip(ffn, hs)]
        partial = tp.is_split(ffn[0]["w_down"], spec["ffn"]["w_down"].shape)
        aux = None
    return tp_residual(xs, ys, partial), aux


def tp_attention_half(parts, xs, cfg, call, ln: str = "ln1",
                      key: str = "attn"):
    """The attention half of a block over the model coordinates up to the
    residual: ``call(p, h, head0, m)`` on each coordinate ``m``'s
    parameters and normalised stream. -> (xs, the calls' results, whether
    their outputs are partial sums)."""
    xs = constrain(xs, BSE)
    hs = [rms_norm(x, p[ln], cfg.norm_eps) for p, x in zip(parts, xs)]
    ps, partial = tp_attention(parts, cfg, key)
    return xs, [call(p, h, h0, m)
                for m, ((p, h0), h) in enumerate(zip(ps, hs))], partial


def _tp_mixer_half(parts, xs, cfg, kind, spec, call):
    """The mixer half of an "ssd" or "rglru" block over the model
    coordinates, to the residual: ``call(module, mixer blocks, hs, mixer
    specs)`` -> (ys, whether partial sums, extra). -> (xs, extra)."""
    if kind not in MIXERS:
        raise ValueError(kind)
    xs = constrain(xs, BSE)
    hs = [rms_norm(x, p["ln1"], cfg.norm_eps) for p, x in zip(parts, xs)]
    ys, partial, extra = call(MIXERS[kind], [p["mixer"] for p in parts], hs,
                              spec["mixer"])
    return tp_residual(xs, ys, partial), extra


def tp_block_apply(parts, xs, cfg: ModelConfig, kind: str, aux, spec,
                   load=None):
    """:func:`block_apply` over the model coordinates: ``parts`` each
    coordinate's blocks of the block's parameters, ``xs`` its copy of the
    residual stream, ``spec`` the block's ParamSpecs."""
    if kind in attn.KINDS:
        xs, ys, partial = tp_attention_half(parts, xs, cfg, (
            lambda p, h, h0, m: attn.attention_apply(p, h, cfg, kind=kind,
                                                     head0=h0)))
        xs, a = tp_ffn(parts, tp_residual(xs, ys, partial), cfg, spec,
                       load=load)
        return xs, aux if a is None else aux + a
    xs, _ = _tp_mixer_half(parts, xs, cfg, kind, spec, lambda mod, ps, hs, sp:
                           mod.tp_mixer(ps, hs, cfg, sp))
    return (xs if kind == "ssd" else tp_ffn(parts, xs, cfg, spec)[0]), aux


def whole_cache(caches, cfg):
    """One KV cache from the coordinates': their KV heads put together
    where each holds a block of them, else the first coordinate's (each
    holds them all); its other entries the first coordinate's."""
    if caches[0]["k"].shape[2] == cfg.num_kv_heads:
        return caches[0]
    return dict(caches[0], k=tp.all_gather([c["k"] for c in caches], 2),
                v=tp.all_gather([c["v"] for c in caches], 2))


def tp_block_prefill(parts, xs, cfg: ModelConfig, kind: str, max_len: int,
                     spec):
    """:func:`block_prefill` over the model coordinates; the cache comes
    back whole (``whole_cache``, the mixers' ``tp_mixer``)."""
    if kind in attn.KINDS:
        xs, outs, partial = tp_attention_half(parts, xs, cfg, (
            lambda p, h, h0, m: attn.attention_prefill(
                p, h, cfg, kind=kind, cache_len=max_len, head0=h0)))
        xs = tp_residual(xs, [y for y, _ in outs], partial)
        return (tp_ffn(parts, xs, cfg, spec)[0],
                whole_cache([c for _, c in outs], cfg))
    xs, cache = _tp_mixer_half(parts, xs, cfg, kind, spec, (
        lambda mod, ps, hs, sp: mod.tp_mixer(ps, hs, cfg, sp,
                                             want_cache=True)))
    return (xs if kind == "ssd" else tp_ffn(parts, xs, cfg, spec)[0]), cache


def kv_view(cache, cfg, p, head0: int):
    """The KV heads of a whole cache that a coordinate whose attention
    parameters are ``p`` and whose first query head is ``head0`` reads and
    writes: a view of its block, or the whole where it holds every KV
    head."""
    kv = p["wk"].shape[1]
    if kv == cfg.num_kv_heads:
        return cache
    lo = head0 // (cfg.num_heads // cfg.num_kv_heads)
    return dict(cache, k=cache["k"][:, :, lo:lo + kv],
                v=cache["v"][:, :, lo:lo + kv])


def tp_block_decode(parts, xs, cfg: ModelConfig, kind: str, cache,
                    pos: int, spec):
    """:func:`block_decode` over the model coordinates on a whole cache
    (on the first coordinate's device): each coordinate writes and reads
    its view of it (``kv_view``; the mixers' ``tp_decode``)."""
    if kind in attn.KINDS:
        xs, ys, partial = tp_attention_half(parts, xs, cfg, (
            lambda p, h, h0, m: attn.decode_attention(
                p, h, cfg, kv_view(cache, cfg, p, h0), pos, head0=h0,
                window=attn.window_of(cfg, kind))[0]))
        xs, _ = tp_ffn(parts, tp_residual(xs, ys, partial), cfg, spec,
                       capacity_factor=float(cfg.top_k))
        return xs, cache
    xs, _ = _tp_mixer_half(parts, xs, cfg, kind, spec, (
        lambda mod, ps, hs, sp: (*mod.tp_decode(ps, hs, cfg, sp, cache),
                                 None)))
    return (xs if kind == "ssd" else tp_ffn(parts, xs, cfg, spec)[0]), cache


def tp_embed(parts, tokens, cfg, extra_embeds=None):
    """Each coordinate's copy of the embeddings: its block of the vocab's
    rows looked up (zeros for the others) and summed, the frontend's
    embeddings prepended."""
    rows = parts[0]["embed"]["tokens"].shape[0]
    xs = [embed_apply(p["embed"], tokens.to(p["final_norm"].device), cfg,
                      first=m * rows) for m, p in enumerate(parts)]
    xs = constrain(tp.Partial(xs) if rows < cfg.vocab_size else xs, BSE)
    if extra_embeds is not None:
        xs = [torch.cat([extra_embeds.to(x.device, x.dtype), x], dim=1)
              for x in xs]
    return constrain(xs, BSE)


def tp_logits(parts, xs, cfg):
    """(fp32 logits, first vocab index) of each block of the vocab: one per
    coordinate where the rules split the vocab, else the first
    coordinate's whole logits."""
    n = (parts[0]["embed"]["tokens"].shape[0] if cfg.tie_embeddings
         else parts[0]["embed"]["unembed"].shape[1])
    if n == cfg.vocab_size:
        return [unembed_apply(parts[0]["embed"], xs[0], cfg)], [0]
    logits = constrain([unembed_apply(p["embed"], x, cfg)
                        for p, x in zip(parts, xs)],
                       ("batch", "seq", "vocab"))
    return logits, [m * n for m in range(len(parts))]


def vocab_parallel_nll(logits, firsts, labels, mask):
    """-sum over the unmasked positions of the log-softmax at the labels,
    where ``logits`` are fp32 blocks of the vocab, one per model
    coordinate, block ``m`` from vocab index ``firsts[m]``: the max over
    the blocks, the sum of the exponentials in coordinate order, and each
    label's logit from the block that holds it; on the first block's
    device."""
    home = logits[0].device
    top = torch.stack([lg.detach().amax(-1).to(home)
                       for lg in logits]).amax(0)
    sumexp, picked = 0, 0
    for lg, first in zip(logits, firsts):
        dev = lg.device
        sumexp = sumexp + torch.exp(lg - top.to(dev)[..., None]).sum(-1).to(
            home)
        local = labels.to(dev) - first
        own = (local >= 0) & (local < lg.shape[-1])
        at = lg.gather(-1, local.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
        picked = picked + torch.where(own, at, 0.0).to(home)
    ll = picked - top - torch.log(sumexp)
    return -(ll * mask.to(home)).sum()


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

    def _unit_loads(self, loads, r: int) -> list:
        """Each block's load of pattern unit ``r`` (``block_load``)."""
        return [block_load(loads, "blocks", (f"p{j}", r))
                for j in range(len(self.cfg.pattern))]

    def _trunk(self, params, x, loads=None):
        """-> (normalised hidden states, the routers' summed loss, fp32).
        ``loads``: each MoE block's ``load`` by layer key (the whole
        batch's routed shares, or lists to collect the blocks' own:
        ``router_loads``); ``remat``'s unit takes its blocks' loads as an
        argument, so that a recompute reads the same."""
        cfg = self.cfg
        reps, tail = self._pattern_layout()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.first_dense_layers):
            x, aux = block_apply(params[f"head{i}"], x, cfg, cfg.pattern[0],
                                 aux, block_load(loads, f"head{i}"))

        def unit(x, aux, unit_params, unit_loads):
            for j, kind in enumerate(cfg.pattern):
                x, aux = block_apply(unit_params[f"p{j}"], x, cfg, kind, aux,
                                     unit_loads[j])
            return x, aux

        unit = remat(cfg, unit)
        for r in range(reps):
            x, aux = unit(x, aux, layer(params["blocks"], r),
                          self._unit_loads(loads, r))
        for t in range(tail):
            x, aux = block_apply(params[f"tail{t}"], x, cfg, cfg.pattern[t],
                                 aux, block_load(loads, f"tail{t}"))
        return rms_norm(x, params["final_norm"], cfg.norm_eps), aux

    # ---- tensor parallelism inside a slice ----

    def _block_spec(self, key: str, kind: str):
        """The ParamSpecs of one block ``key`` of ``kind`` (unstacked), as
        ``specs()`` declares it: the whole shapes a coordinate's blocks are
        cut from."""
        cfg = self.cfg
        if key.startswith("head"):
            return block_specs(cfg, kind,
                               dense_ff=cfg.first_dense_ff or cfg.d_ff)
        return block_specs(cfg, kind)

    def _tp_trunk(self, parts, xs, loads=None):
        """:meth:`_trunk` in lockstep; ``remat``'s unit takes every
        coordinate's stream and parameters."""
        cfg = self.cfg
        reps, tail = self._pattern_layout()
        aux = torch.zeros((), dtype=torch.float32, device=xs[0].device)
        for i in range(cfg.first_dense_layers):
            xs, aux = tp_block_apply(
                [p[f"head{i}"] for p in parts], xs, cfg, cfg.pattern[0], aux,
                self._block_spec(f"head{i}", cfg.pattern[0]),
                block_load(loads, f"head{i}"))
        specs = [block_specs(cfg, kind) for kind in cfg.pattern]

        def unit(xs, aux, unit_parts, unit_loads):
            for j, kind in enumerate(cfg.pattern):
                xs, aux = tp_block_apply([u[f"p{j}"] for u in unit_parts],
                                         xs, cfg, kind, aux, specs[j],
                                         unit_loads[j])
            return xs, aux

        unit = remat(cfg, unit)
        for r in range(reps):
            xs, aux = unit(xs, aux, [layer(p["blocks"], r) for p in parts],
                           self._unit_loads(loads, r))
        for t in range(tail):
            xs, aux = tp_block_apply([p[f"tail{t}"] for p in parts], xs, cfg,
                                     cfg.pattern[t], aux, specs[t],
                                     block_load(loads, f"tail{t}"))
        return [rms_norm(x, p["final_norm"], cfg.norm_eps)
                for p, x in zip(parts, xs)], aux

    def _tp_forward(self, parts, tokens, extra_embeds=None):
        xs, aux = self._tp_trunk(parts, tp_embed(parts, tokens, self.cfg,
                                                 extra_embeds))
        return tp.all_gather(tp_logits(parts, xs, self.cfg)[0], -1), aux

    def _tp_loss(self, parts, batch, labels, mask, loads=None):
        """The summed masked cross-entropy and the aux loss, the logits by
        ``ce_chunk`` positions (all at once without it) and the
        cross-entropy over the vocab's blocks (``vocab_parallel_nll``)."""
        front = batch.get("frontend")
        n_front = 0 if front is None else front.shape[1]
        xs, aux = self._tp_trunk(parts, tp_embed(
            parts, batch["tokens"], self.cfg, front), loads)
        xs = [x[:, n_front:] for x in xs]
        c = self.cfg.ce_chunk or xs[0].shape[1]
        total = sum(vocab_parallel_nll(
            *tp_logits(parts, [x[:, i:i + c] for x in xs], self.cfg),
            labels[:, i:i + c], mask[:, i:i + c])
            for i in range(0, xs[0].shape[1], c))
        return total, aux

    def _tp_prefill(self, parts, tokens, max_len, extra_embeds=None):
        cfg = self.cfg
        xs = tp_embed(parts, tokens, cfg, extra_embeds)
        cache: Dict[str, Any] = {}
        for key, slot, kind in self._layers():
            xs, c = tp_block_prefill([self._select(p, key, slot)
                                      for p in parts], xs, cfg, kind,
                                     max_len, self._block_spec(key, kind))
            self._keep(cache, key, slot, c)
        self._stack_cache(cache)
        xs = [rms_norm(x[:, -1:], p["final_norm"], cfg.norm_eps)
              for p, x in zip(parts, xs)]
        return tp.all_gather(tp_logits(parts, xs, cfg)[0], -1), cache

    def _tp_decode_step(self, parts, cache, token, pos):
        cfg = self.cfg
        xs = tp_embed(parts, token, cfg)
        for key, slot, kind in self._layers():
            xs, _ = tp_block_decode([self._select(p, key, slot)
                                     for p in parts], xs, cfg, kind,
                                    self._select(cache, key, slot), pos,
                                    self._block_spec(key, kind))
        xs = [rms_norm(x, p["final_norm"], cfg.norm_eps)
              for p, x in zip(parts, xs)]
        return tp.all_gather(tp_logits(parts, xs, cfg)[0], -1), cache

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
        if model_ways() > 1:
            return self._tp_forward(tp_parts(params), tokens,
                                    extra_embeds)
        x, aux = self._trunk(params, self._embed(params, tokens,
                                                 extra_embeds))
        return unembed_apply(params["embed"], x, self.cfg), aux

    def loss(self, params, batch, loads=None):
        """batch: tokens (B, S), labels (B, S) [-1 = masked], optionally
        frontend embeddings (B, S_front, E) -> (loss + aux, {"ce", "aux"}):
        the mean fp32 cross-entropy over unmasked labels (at least one in
        the denominator); the frontend positions carry no labels. With
        ``cfg.ce_chunk`` the trunk runs once, then the unembedding and
        log-softmax per chunk of that many positions, so the (B, S, V)
        logits never materialise. ``loads``: each MoE block's routed share
        of a batch of which ``batch`` is one data slice's rows, by layer
        key (:meth:`router_loads`, averaged over the slices), for the
        router losses (``moe.route_logits``)."""
        cfg = self.cfg
        front = batch.get("frontend")
        n_front = 0 if front is None else front.shape[1]
        labels = batch["labels"]
        mask = labels >= 0
        labels = labels.clamp_min(0).long()
        denom = mask.sum().clamp_min(1)
        if model_ways() > 1:
            total, aux = self._tp_loss(tp_parts(params), batch, labels,
                                       mask, loads)
            loss = total / denom.to(total.device)
            return loss + aux, {"ce": loss, "aux": aux}

        def nll(logits, labels, mask):
            lp = F.log_softmax(logits.float(), dim=-1)
            ll = lp.gather(-1, labels[..., None])[..., 0]
            return -(ll * mask).sum()

        if cfg.ce_chunk or loads is not None:
            x, aux = self._trunk(params, self._embed(params, batch["tokens"],
                                                     front), loads)
            x = x[:, n_front:]
            c = cfg.ce_chunk or x.shape[1]
            total = sum(nll(unembed_apply(params["embed"], x[:, i:i + c],
                                          cfg),
                            labels[:, i:i + c], mask[:, i:i + c])
                        for i in range(0, x.shape[1], c))
        else:
            logits, aux = self.forward(params, batch["tokens"], front)
            total = nll(logits[:, n_front:], labels, mask)
        loss = total / denom
        return loss + aux, {"ce": loss, "aux": aux}

    @torch.no_grad()
    def router_loads(self, params, batch):
        """The routing pre-pass of a batch cut over data slices: a forward
        of the trunk without a graph, which returns each MoE block's
        routed share f_e (E,) of ``batch``'s rows by layer key (a dense
        first layer has none), for :meth:`loss`'s ``loads``. Under tensor
        parallelism the first coordinate's routing."""
        front = batch.get("frontend")
        loads = {layer_key(key, slot): [] for key, slot, _ in self._layers()}
        if model_ways() > 1:
            parts = tp_parts(params)
            self._tp_trunk(parts, tp_embed(parts, batch["tokens"], self.cfg,
                                           front), loads)
        else:
            self._trunk(params, self._embed(params, batch["tokens"], front),
                        loads)
        return {k: v[0] for k, v in loads.items() if v}

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

    @staticmethod
    def _keep(cache, key, slot, c):
        """File block ``key``'s cache ``c`` (a stacked slot's in a list)."""
        if slot is None:
            cache[key] = c
        else:
            cache.setdefault(key, {}).setdefault(slot[0], []).append(c)

    @staticmethod
    def _stack_cache(cache):
        if "blocks" in cache:
            cache["blocks"] = {pj: tree_stack(cs)
                               for pj, cs in cache["blocks"].items()}

    def prefill(self, params, tokens, max_len: int, extra_embeds=None):
        """Run the full prompt (after ``extra_embeds``, as in forward),
        returning (last-position logits, cache). With extra embeddings the
        cache holds their positions first: decode the next token at
        ``S_front + S``."""
        if model_ways() > 1:
            return self._tp_prefill(tp_parts(params), tokens, max_len,
                                    extra_embeds)
        cfg = self.cfg
        x = self._embed(params, tokens, extra_embeds)
        cache: Dict[str, Any] = {}
        for key, slot, kind in self._layers():
            x, c = block_prefill(self._select(params, key, slot), x, cfg,
                                 kind, max_len)
            self._keep(cache, key, slot, c)
        self._stack_cache(cache)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = unembed_apply(params["embed"], x[:, -1:], cfg)
        return logits, cache

    def decode_step(self, params, cache, token, pos: int):
        """token: (B, 1) ints; pos: int. Returns (logits, cache); the cache
        is updated in place."""
        if model_ways() > 1:
            return self._tp_decode_step(tp_parts(params), cache, token,
                                        pos)
        cfg = self.cfg
        x = embed_apply(params["embed"], token, cfg)
        for key, slot, kind in self._layers():
            x, _ = block_decode(self._select(params, key, slot), x, cfg,
                                kind, self._select(cache, key, slot), pos)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = unembed_apply(params["embed"], x, cfg)
        return logits, cache
