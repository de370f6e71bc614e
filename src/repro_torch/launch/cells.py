"""Cells: (arch x shape x mesh) -> one card's step on meta tensors.

Counterpart of ``repro.launch.cells``. A *cell* is one entry of the
dry-run's matrix. ``build_cell`` returns the step as a callable (the train
step, ``prefill`` or ``decode_step``), its arguments as meta tensors of
one card's blocks under the cell's rules (``roofline/count.py`` runs it on
the meta device), the model FLOPs and tokens of the global batch, and the
bytes the step moves between cards under those rules, counted from the
shardings' blocks (none on one card). The same function backs the dry-run,
the report and ``perf_iterate``.

The reference's ``units.py`` has no counterpart here: XLA's
``cost_analysis`` counts a while loop's body once, so the reference
compiles each scanned layer apart and extrapolates; the port's count sees
every op as it is dispatched, the layers' loop, the micro-batches and a
remat's recompute included.

The train step is the trainer's own (``runtime/trainer.py``), for the
first slice: ``slice_grads`` over the slice's share of ``accum``
micro-batches, on its whole parameters (gathered from their blocks under
``FSDP_RULES``), then ``apply_step`` (``apply_sharded_updates`` on the
slice's ZeRO-1 moment blocks, each parameter block put back together from
the updated blocks). With routers on several slices it first runs the
trainer's routing pre-pass over the slice's rows (``slice_router_loads``).
Its TrainState holds the first slice's blocks only; the parts of a
gathered buffer that other cards hold are left to the collectives counted
beside the step, and so are the gradients' sum over the data slices and
the router loads' (E fp32 values a MoE block and micro-batch).

On a mesh with a model axis (``model`` > 1) a slice is that many cards,
one model coordinate each, and the step runs them in lockstep as the
trainer does (``core/tensor_parallel.py``): every coordinate's blocks are
arguments, and ``roofline/count.py`` takes one card's share of the count
(``Cell.ways``) and the model axis's collectives from the step's own
calls. Serving cells take each coordinate's parameter blocks the same way;
a decode takes the cache whole over the model axis where the lockstep
decode reads it so (its heads' views), and each coordinate's block where
the rules split its sequence (``kv_seq``: each coordinate attends over its
block, and the partial outputs' combine is counted beside), the blocks the
other coordinates hold beside it as a buffer the step does not touch.
Under rules that cut the batch over the model axis too (``perf_iterate``'s
``dp_only``), the model axis is data parallelism: the mesh is counted as
that many data slices.

``AdamWConfig.grad_reduce_dtype`` casts each micro-batch's gradients
before they are summed in fp32 (for ``accum`` > 1, as the
reference's cell does); the trainer reads it the same way. Each
micro-batch weighs 1/``accum``, where the trainer weighs it by its share
of the batch's unmasked labels, which only a batch's values give. The
kernels take every ``cell_config`` value: the flash kernel tiles on its
own (``attn_chunk`` steers the chunked path only), and the SSD kernel
works in chunks of at most 128 rows, so ``ssd_chunk`` 512 runs the same
kernel program as 128 (the note of such a cell says so).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs import get_config
from repro_torch.core.meshes import Mesh, mesh_model_ways, mesh_num_slices
from repro_torch.core.sharding import (FSDP_RULES, LONG_CONTEXT_RULES,
                                       TP_DP_RULES, NamedSharding,
                                       PartitionSpec, ShardedTensor,
                                       ShardingRules, _as_tuple,
                                       activation_rules, intersect,
                                       rules_for_shape)
from repro_torch.core.tensor_parallel import model_spec, slices_of
from repro_torch.launch.shapes import SHAPES, ShapeSpec, applicable
from repro_torch.models import build_model
from repro_torch.models.layers import tree_leaves, tree_map, torch_dtype
from repro_torch.optim import AdamWConfig
from repro_torch.roofline.hardware import HBM_BYTES
from repro_torch.runtime.trainer import (apply_step, routers, slice_grads,
                                         slice_router_loads,
                                         train_state_shardings)

# -- per-cell deployment configuration (copies of the reference's) ------------

TRAIN_ACCUM = {
    "smollm-135m": 1, "granite-3-2b": 4, "qwen3-4b": 8, "gemma2-27b": 8,
    "recurrentgemma-9b": 4, "deepseek-moe-16b": 4,
    "phi3.5-moe-42b-a6.6b": 8, "seamless-m4t-medium": 1,
    "mamba2-130m": 2, "paligemma-3b": 4,
}

# Train cells whose fp32 params + grads per model way exceed this share of
# a card's HBM get FSDP: the reference's 6e9 bytes of a 16 GB chip
# (FSDP_BYTES_THRESHOLD), as a share, against the H100's 80 GB.
FSDP_HBM_SHARE = 0.375


def cell_config(cfg, shape: ShapeSpec):
    """Deployment-config overrides for one cell."""
    updates = {}
    if shape.seq_len >= 32_768 and shape.kind != "decode":
        updates["attn_chunk"] = 1024
        if cfg.family == "ssm":
            updates["ssd_chunk"] = 512
    return dataclasses.replace(cfg, **updates) if updates else cfg


def rules_for(shape: ShapeSpec, mesh: Mesh,
              base: ShardingRules = TP_DP_RULES) -> ShardingRules:
    return rules_for_shape(shape.name, shape.global_batch, mesh, base)


def train_rules(cfg, mesh: Mesh,
                threshold: Optional[float] = None) -> ShardingRules:
    """FSDP when fp32 parameters and gradients per model way exceed
    ``threshold`` bytes (default ``FSDP_HBM_SHARE`` of the H100's HBM)."""
    if threshold is None:
        threshold = FSDP_HBM_SHARE * HBM_BYTES
    per_dev = cfg.param_count() * 4 * 2 / mesh_model_ways(mesh)
    return FSDP_RULES if per_dev > threshold else TP_DP_RULES


def rules_name(rules: ShardingRules) -> str:
    for name, table in (("TP_DP_RULES", TP_DP_RULES),
                        ("FSDP_RULES", FSDP_RULES),
                        ("LONG_CONTEXT_RULES", LONG_CONTEXT_RULES)):
        if rules == table:
            return name
    return "custom"


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    fn: Callable
    args: Tuple[Any, ...]
    model_flops: float
    tokens: int
    rules: ShardingRules
    collectives: Dict[str, float]     # bytes a card sends, by kind
    note: str = ""
    shardings: Any = None             # a train cell's TrainState layout
    ways: int = 1                     # model coordinates run in lockstep


# -- one card's blocks -----------------------------------------------------------


def _box(shape, logical, rules: ShardingRules, mesh: Mesh,
         coord=None) -> tuple:
    """Card ``coord``'s block (default: the first card's) of a tensor of
    ``shape`` (global slices)."""
    spec = rules.spec_for(logical, shape, mesh)
    return NamedSharding(mesh, spec).index(
        shape, mesh.coords()[0] if coord is None else coord)


def _extent(box) -> tuple:
    return tuple(s.stop - s.start for s in box)


def _numel(box) -> int:
    n = 1
    for d in _extent(box):
        n *= d
    return n


def _inside(a: tuple, b: tuple) -> bool:
    """Whether box ``a`` lies inside box ``b``."""
    return all(y.start <= x.start and x.stop <= y.stop for x, y in zip(a, b))


def _overlap(a: tuple, b: tuple) -> int:
    """Elements boxes ``a`` and ``b`` share."""
    inter = intersect(a, b)
    return 0 if inter is None else _numel(inter)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _ring(n: int) -> float:
    """Bytes a card sends per byte of an all-reduce over ``n`` cards
    (ring: a reduce-scatter and an all-gather)."""
    return 2.0 * (n - 1) / n if n > 1 else 0.0


def _as_data(mesh: Mesh) -> Mesh:
    """``mesh`` with its model axis folded into the data axis."""
    return Mesh(mesh.devices.reshape(-1, 1), ("data", "model"))


# -- the train cell ----------------------------------------------------------------


def _train_cell(arch, shape, cfg, model, mesh, rules, opt_cfg, accum,
                dtype_param):
    n = mesh_num_slices(mesh)
    coords = slices_of(mesh)[0]
    first = coords[0]
    shapes = tree_map(lambda s: tuple(s.shape), model.specs())
    sh = train_state_shardings(model, opt_cfg, mesh, rules)

    def block(shape, dtype, sharding):
        return ShardedTensor(shape, dtype, sharding, {
            c: _meta(_extent(sharding.index(torch.Size(shape), c)), dtype)
            for c in coords})

    def blocks(dtype, tree):
        return tree_map(lambda s, h: block(s, dtype, h), shapes, tree)

    state = {"params": blocks(dtype_param, sh["params"]),
             "opt": {"mu": blocks(torch.float32, sh["opt"]["mu"]),
                     "nu": blocks(torch.float32, sh["opt"]["nu"]),
                     "step": block((), torch.int32, sh["opt"]["step"])},
             "rng": block((2,), torch.uint32, sh["rng"]),
             "step": block((), torch.int32, sh["step"])}
    rows = _extent(_box((shape.global_batch, shape.seq_len),
                        ("batch", "seq"), rules, mesh))[0]
    if rows % accum:
        raise ValueError(f"{arch} x {shape.name}: {rows} rows a card do not "
                         f"split into {accum} micro-batches")
    batch = _batch(cfg, shape, rows, "meta")
    moe_blocks = routers(model.specs()) if n > 1 else 0

    def train_step(state, batch):
        per = batch["tokens"].shape[0] // accum
        loss = torch.zeros((), dtype=torch.float32,
                           device=mesh.device(first))

        def micro_batch(i):
            return ({k: v[i * per:(i + 1) * per] for k, v in batch.items()},
                    1 / accum)

        loads = aux_weight = None
        if moe_blocks:
            # the slice's own loads stand for their mean over the slices
            loads = slice_router_loads(model, state["params"], coords, accum,
                                       micro_batch, rules)
            aux_weight = 1 / (n * accum)
        grads = slice_grads(model, state["params"], coords, accum,
                            micro_batch, loss, opt_cfg, rules, loads,
                            aux_weight)
        return apply_step(opt_cfg, state, grads, loss)

    # what the step moves between cards, per card: the parameters gathered
    # before the micro-batches and, where a moment block lies outside the
    # card's parameter block, over it for the update; the gradients'
    # all-reduce, per micro-batch as the reference's scan pins each one's
    # gradients to the parameters' sharding (in grad_reduce_dtype when
    # accum > 1); the updated blocks the card's parameter block is put
    # back together from; a card's share of each, its model block over the
    # data axes; and the router loads' all-reduce
    pbox = tree_map(lambda s, h: h.index(torch.Size(s), first), shapes,
                    sh["params"])
    mbox = tree_map(lambda s, h: h.index(torch.Size(s), first), shapes,
                    sh["opt"]["mu"])
    wbox = tree_map(lambda s, h: model_spec(h).index(torch.Size(s), first),
                    shapes, sh["params"])
    isize = torch.tensor([], dtype=dtype_param).element_size()
    leaves = list(zip(tree_leaves(wbox), tree_leaves(pbox),
                      tree_leaves(mbox)))
    gathered = sum(_numel(w) - _numel(p) for w, p, _ in leaves)
    gathered += sum(_numel(m) - _overlap(m, p) for _, p, m in leaves
                    if not _inside(m, p))
    coll = {}
    if gathered:
        coll["all-gather (FSDP parameters)"] = gathered * isize
    if n > 1:
        low = opt_cfg.grad_reduce_dtype if accum > 1 else None
        gsize = torch_dtype(low).itemsize if low else 4
        full = sum(_numel(w) for w, _, _ in leaves)
        coll["all-reduce (gradients)"] = accum * _ring(n) * full * gsize
        back = sum(_numel(p) - _overlap(m, p) for _, p, m in leaves)
        if back:
            coll["all-gather (ZeRO-1 parameter blocks)"] = back * isize
        if moe_blocks:
            coll["all-reduce (router loads)"] = \
                accum * _ring(n) * moe_blocks * cfg.num_experts * 4
    tokens = shape.global_batch * shape.seq_len
    return Cell(arch, shape.name, train_step, (state, batch),
                model_flops=6.0 * cfg.active_param_count() * tokens,
                tokens=tokens, rules=rules, collectives=coll,
                note=f"accum={accum}", shardings=sh, ways=len(coords))


def _batch(cfg, shape: ShapeSpec, rows: int, device) -> dict:
    """A batch of ``rows`` rows in the reference's layout
    (``_batch_abstract``): encdec splits the sequence into frames and
    text; a frontend's embeddings come before the text."""
    s = shape.seq_len
    if cfg.family == "encdec":
        text = s // 2
        frontend = (rows, s - text, cfg.d_model)
    else:
        text = s - cfg.frontend_tokens
        frontend = ((rows, cfg.frontend_tokens, cfg.d_model)
                    if cfg.frontend else None)
    out = {"tokens": torch.empty((rows, text), dtype=torch.int32,
                                 device=device),
           "labels": torch.empty((rows, text), dtype=torch.int32,
                                 device=device)}
    if frontend is not None:
        out["frontend"] = torch.empty(frontend, dtype=torch.float32,
                                      device=device)
    return out


# -- serving cells -----------------------------------------------------------------


def _model_on_seq_only(spec: PartitionSpec, logical) -> PartitionSpec:
    """``spec`` with the model axis kept on the cache's sequence
    (``kv_seq``) only: the lockstep decode reads a cache whole over the
    model axis (each coordinate its heads' view) but for a sequence the
    rules split over it."""
    out = []
    for part, name in zip(spec, logical):
        axes = _as_tuple(part)
        if name != "kv_seq":
            axes = tuple(ax for ax in axes if ax != "model")
        out.append(None if not axes else axes[0] if len(axes) == 1
                   else axes)
    return PartitionSpec(*out)


def _cache_blocks(model, cfg, batch: int, max_len: int, rules, mesh):
    """The first card's block of each cache leaf, in the dtypes of
    ``init_cache`` (positions int32, recurrent states fp32, the rest the
    compute type); what the lockstep decode takes of it (whole over the
    model axis but where it splits the sequence); and a buffer of the
    bytes the other model coordinates hold beside that (none where the
    leaf holds their blocks)."""
    dtype = torch_dtype(cfg.dtype)
    ways = mesh_model_ways(mesh)
    first = mesh.coords()[0]
    spare = 0

    def build(name, spec):
        nonlocal spare
        if isinstance(spec, dict):
            pairs = {k: build(k, v) for k, v in spec.items()}
            return ({k: v[0] for k, v in pairs.items()},
                    {k: v[1] for k, v in pairs.items()})
        dt = (torch.int32 if name == "pos" else
              torch.float32 if name in ("state", "h") else dtype)
        shape = tuple(spec.shape)
        part = rules.spec_for(spec.logical, shape, mesh)
        card = _meta(_extent(NamedSharding(mesh, part).index(shape, first)),
                     dt)
        held = _meta(_extent(NamedSharding(mesh, _model_on_seq_only(
            part, spec.logical)).index(shape, first)), dt)
        spare += ways * card.nbytes - held.nbytes
        return card, held

    specs = model.cache_specs(batch, max_len)
    cards, held = build("", specs)
    return cards, held, _meta((spare,), torch.uint8), specs


def _combine_bytes(specs, blocks, cfg) -> float:
    """Bytes a card sends to combine a decode's attention over a cache
    whose sequence (``kv_seq``) is split over the cards (the data axes or
    the model axis): each split layer's partial output (B, H, D) and its
    rows' max and sum, fp32, all-reduced over the cards that split it."""
    total = 0.0

    def walk(spec, block):
        nonlocal total
        for k, sub in spec.items():
            if isinstance(sub, dict):
                walk(sub, block[k])
                continue
            if k != "k" or "kv_seq" not in sub.logical:
                continue
            axis = sub.logical.index("kv_seq")
            ways = sub.shape[axis] // block[k].shape[axis]
            layers = sub.shape[0] if sub.logical[0] == "layers" else 1
            rows = block[k].shape[sub.logical.index("batch")]
            total += _ring(ways) * layers * rows * cfg.num_heads * (
                cfg.head_dim + 2) * 4

    walk(specs, blocks)
    return total


def _serve_cell(arch, shape, cfg, model, mesh, rules, dtype_param):
    coords = slices_of(mesh)[0]
    specs = model.specs()
    parts = [tree_map(lambda s, c=c: _meta(_extent(_box(
        tuple(s.shape), s.logical, rules, mesh, c)), dtype_param), specs)
        for c in coords]
    params = parts if len(parts) > 1 else parts[0]
    rows = _extent(_box((shape.global_batch, 1), ("batch", None), rules,
                        mesh))[0]
    n_active = cfg.active_param_count()
    if shape.kind == "prefill":
        batch = _batch(cfg, shape, rows, "meta")
        s = shape.seq_len

        @torch.no_grad()
        def prefill_step(params, batch):
            with activation_rules(mesh, rules):
                if cfg.family == "encdec":
                    return model.prefill(params, batch["frontend"],
                                         batch["tokens"], s // 2)
                return model.prefill(params, batch["tokens"], s,
                                     extra_embeds=batch.get("frontend"))

        tokens = shape.global_batch * s
        return Cell(arch, shape.name, prefill_step, (params, batch),
                    model_flops=2.0 * n_active * tokens, tokens=tokens,
                    rules=rules, collectives={}, ways=len(coords))
    max_len = shape.seq_len if cfg.family != "encdec" else shape.seq_len // 2
    cards, cache, spare, cspecs = _cache_blocks(
        model, cfg, shape.global_batch, max_len, rules, mesh)
    token = _meta((rows, 1), torch.int32)
    pos = max_len - 1

    @torch.no_grad()
    def serve_step(params, cache, token, spare):
        with activation_rules(mesh, rules):
            return model.decode_step(params, cache, token, pos)

    coll = {}
    combine = _combine_bytes(cspecs, cards, cfg)
    if combine:
        coll["all-reduce (attention over the split cache)"] = combine
    return Cell(arch, shape.name, serve_step, (params, cache, token, spare),
                model_flops=2.0 * n_active * shape.global_batch,
                tokens=shape.global_batch, rules=rules, collectives=coll,
                note=f"decode at pos {pos}", ways=len(coords))


def build_cell(arch: str, shape: Union[str, ShapeSpec], mesh: Mesh,
               rules: Optional[ShardingRules] = None,
               opt_cfg: AdamWConfig = AdamWConfig(),
               cfg_overrides: Optional[dict] = None,
               accum: Optional[int] = None) -> Cell:
    """The cell of ``arch`` at ``shape`` (a name of ``SHAPES`` or a
    ``ShapeSpec``) on ``mesh``; ``rules`` default to ``train_rules`` for
    a train cell, ``rules_for`` otherwise; ``cfg_overrides`` (``num_layers``
    among them) apply after ``cell_config``."""
    if isinstance(shape, str):
        ok, why = applicable(arch, shape)
        if not ok:
            raise ValueError(f"{arch} x {shape} skipped: {why}")
        shape = SHAPES[shape]
    if rules is not None and "model" in rules.mesh_axes_for("batch"):
        mesh = _as_data(mesh)
    cfg = cell_config(get_config(arch), shape)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    model = build_model(cfg, device="meta")
    dtype_param = torch_dtype(cfg.param_dtype)
    note = ""
    if cfg.family == "ssm" and cfg.ssd_chunk > 128:
        note = (f"; ssd_chunk {cfg.ssd_chunk}: the SSD kernel works in "
                "chunks of 128 rows")
    if shape.kind == "train":
        if rules is None:
            rules = train_rules(cfg, mesh)
        if accum is None:
            accum = TRAIN_ACCUM.get(cfg.name, 1)
        cell = _train_cell(arch, shape, cfg, model, mesh, rules, opt_cfg,
                           accum, dtype_param)
    else:
        if rules is None:
            rules = rules_for(shape, mesh)
        cell = _serve_cell(arch, shape, cfg, model, mesh, rules,
                           dtype_param)
    cell.note += note
    return cell
