"""Model primitives: parameter specs, norms, RoPE, MLP, embeddings.

Counterpart of ``repro.models.layers``. Parameters are declared as
:class:`ParamSpec` trees (nested dicts); one spec tree drives
initialisation, so the port's parameter tree has the reference's key paths
and shapes and the bridge converts it one to one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    logical: tuple                 # logical axis names, same rank as shape
    init: str = "normal"           # normal | zeros | ones | lru_a
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"rank mismatch: {self.shape} {self.logical}")


def tree_node(cls):
    """Class decorator: instances of the dataclass ``cls`` are inner nodes
    of a tree, their fields its children in order (as the reference
    registers ``CGState`` with ``jax.tree_util``). Other dataclasses, such
    as :class:`ParamSpec`, stay leaves."""
    cls._tree_node = True
    return cls


def _is_node(tree) -> bool:
    return getattr(type(tree), "_tree_node", False)


def _children(tree):
    return [getattr(tree, f.name) for f in dataclasses.fields(tree)]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every leaf of a tree of nested dicts and
    :func:`tree_node` dataclasses (and to the leaves at the same paths of
    ``rest``, trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_node(tree):
        return type(tree)(*(tree_map(fn, *kids) for kids in zip(
            _children(tree), *map(_children, rest))))
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of a tree of nested dicts and :func:`tree_node`
    dataclasses, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if _is_node(tree):
        return [x for v in _children(tree) for x in tree_leaves(v)]
    return [tree]


def init_param(generator: torch.Generator, spec: ParamSpec,
               dtype: torch.dtype) -> torch.Tensor:
    """Draw one parameter from ``generator``, on the generator's device: a
    fan-in scaled normal, as ``repro.models.layers.init_param`` (the fan-in
    is the leading axis), or the RG-LRU's ``lru_a``."""
    dev = generator.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=dev)
    if spec.init == "lru_a":
        # the inverse softplus of -8 log u, u uniform in [0.9, 0.999), so
        # the recurrence's decay starts near 0.9-0.999 (Griffin, sec. 2.4)
        u = torch.rand(spec.shape, generator=generator, dtype=torch.float32,
                       device=dev)
        u = 0.9 + (0.999 - 0.9) * u
        return torch.log(torch.expm1(-torch.log(u) * 8.0)).to(dtype)
    if spec.init != "normal":
        raise ValueError(f"unknown init {spec.init!r}")
    fan_in = spec.shape[0] if len(spec.shape) > 1 else max(spec.shape[0], 1)
    std = spec.scale / math.sqrt(fan_in)
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=dev)
    return (x * std).to(dtype)


def init_from_specs(generator: torch.Generator, specs, dtype: torch.dtype,
                    device: torch.device):
    """Initialise every leaf in order from ``generator``, on its device,
    then move the tree to ``device``: a CPU generator gives the same
    weights on any device; a CUDA generator draws billions of parameters
    on the card in a moment (other numbers from the same seed)."""
    return tree_map(
        lambda s: init_param(generator, s, dtype).to(device), specs)


def logical_tree(specs):
    """The logical axis names of every leaf of a spec tree."""
    return tree_map(lambda s: s.logical, specs)


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


# -- functional layers ---------------------------------------------------------


def rms_norm(x, scale, eps: float = 1e-6, zero_centered: bool = True):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = (1.0 + scale) if zero_centered else scale
    return (x * w.float()).to(dt)


def act_fn(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def softcap(x, cap):
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


# -- RoPE ------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """Half-split RoPE. x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs      # (..., S, hd/2)
    angles = angles[..., None, :]                          # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -- gated MLP ---------------------------------------------------------------------


def mlp_specs(cfg, d_ff=None) -> Dict[str, Any]:
    e, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": ParamSpec((e, f), ("embed", "mlp")),
        "w_up": ParamSpec((e, f), ("embed", "mlp")),
        "w_down": ParamSpec((f, e), ("mlp", "embed")),
    }


def mlp_apply(params, x, cfg):
    act = act_fn(cfg.act)
    h = act(x @ params["w_gate"].to(x.dtype)) * \
        (x @ params["w_up"].to(x.dtype))
    return h @ params["w_down"].to(x.dtype)


# -- embeddings ----------------------------------------------------------------------


def embed_specs(cfg) -> Dict[str, Any]:
    specs = {"tokens": ParamSpec((cfg.vocab_size, cfg.d_model),
                                 ("vocab", "table_embed"))}
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                     ("table_embed", "vocab"))
    return specs


def embed_apply(params, tokens, cfg):
    # gather, then cast: the same values as casting the whole table first
    x = params["tokens"][tokens].to(torch_dtype(cfg.dtype))
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def unembed_apply(params, x, cfg):
    if cfg.tie_embeddings:
        logits = x @ params["tokens"].to(x.dtype).T
    else:
        logits = x @ params["unembed"].to(x.dtype)
    return softcap(logits.float(), cfg.final_logit_softcap)
