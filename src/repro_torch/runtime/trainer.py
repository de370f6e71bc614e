"""Elastic trainer: the runtime that drives a malleable job.

Counterpart of ``repro.runtime.trainer``. ``ElasticTrainer`` owns a
TrainState (``params``, AdamW's ``opt``, the ``rng`` key and ``step``)
laid out on a mesh of data-parallel slices by ``cfg.rules``, each leaf a
``ShardedTensor``: the parameters replicated under ``TP_DP_RULES``, or
each slice holding its block of them where the rules split a parameter
axis over the data slices (``FSDP_RULES``: the ``embed`` axis); the
moments ZeRO-1 sharded (``optim.state_logical``). The train step runs
every slice's share of the batch in turn (``model.loss``, ``backward()``
over ``grad_accum`` micro-batches) on that slice's whole parameters,
gathered from the blocks first where they are sharded and freed after the
slice's backward; it sums the slices' gradients in slice order and applies
``apply_sharded_updates``, which updates each block from its part of the
sum: an FSDP step's all-gather and reduce-scatter, carried out on one
card. The numbers do not depend on the layout. Each slice's loss is scaled
by its share of the global batch's unmasked labels, so the gradients and
the reported loss are the global batch's mean, as in the reference's
jitted step. A mixture of experts' router loss is a product of two means
over the batch, so on several slices the step first routes every slice's
rows without a graph (``slice_router_loads``), and each slice's router
loss takes the whole micro-batch's routed shares, weighed 1 / (slices x
accum) (``moe.route_logits``); on one slice the step is as it was. With
``AdamWConfig.grad_reduce_dtype`` set and more than one micro-batch, each
micro-batch's gradients are cast to it and summed in fp32, as the
reference's dry-run cell sums them (``launch/cells.py`` counts this step:
``slice_grads`` and ``apply_step`` for one card).

The training loop exposes *reconfiguration points* at step boundaries:
every ``check_period`` steps it calls the DMR API; on EXPAND or SHRINK it
builds a mesh of the granted slice count and reshards the whole TrainState
(``core.reshard``: runtime data redistribution, not a checkpoint restart).
Checkpoint/restart is the *fault* path: a step that raises restores the
latest checkpoint onto the current mesh; the same step failing again after
that restore raises, so a fault that repeats (a kernel that cannot build or
launch) is not retried forever. ``recoveries`` lists every restore.

The slices of a mesh may be cards or virtual slices of one card
(``core.meshes.slice_devices``). With ``model_ways > 1`` (tensor
parallelism inside a slice) each slice is ``model_ways`` mesh
coordinates, cards or virtual devices of one card, and a slice's step runs
its model coordinates in lockstep under ``activation_rules``: each reads
its model block of every parameter (``tensor_parallel.model_block``,
gathered over the data axes under ``FSDP_RULES``), the model splits its
sublayers over them and adds their partial sums, and the slice's gradient
of a parameter is put together from its coordinates' blocks, those of a
parameter every coordinate holds whole (the norms, and whatever the rules
leave unsplit) summed in coordinate order, as GSPMD's all-reduce gives it.
Every model family splits so: the attention and MLP blocks, the SSD and
RG-LRU mixers, the mixture of experts and the encoder-decoder.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.core import (DMR, TP_DP_RULES, Action, ShardedTensor,
                              ShardingRules, make_mesh, place, reshard,
                              resized_mesh)
from repro_torch.core.reshard import synchronize
from repro_torch.core.sharding import (activation_rules, copy_to,
                                       logical_to_sharding, read_box, zeros)
from repro_torch.core.tensor_parallel import (collective, model_block,
                                              slices_of)
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.models.layers import (torch_dtype, tree_leaves,
                                      tree_map)
from repro_torch.optim import (AdamWConfig, apply_sharded_updates,
                               state_logical)
from repro_torch.prng import fold_in, prng_key


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    grad_accum: int = 1
    check_period: int = 10            # steps between reconfiguration points
    min_slices: int = 1
    max_slices: int = 8
    factor: int = 2
    preferred: Optional[int] = None
    model_ways: int = 1               # TP width inside a slice
    ckpt_dir: Optional[str] = None
    ckpt_period: int = 50
    log_period: int = 10
    rules: ShardingRules = TP_DP_RULES


def _on(device: torch.device):
    """Make ``device`` current for the kernels launched on it."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def train_state_shardings(model, opt_cfg: AdamWConfig, mesh,
                          rules: ShardingRules):
    """The NamedShardings of a TrainState of ``model`` on ``mesh``: the
    parameters by ``rules``, the moments by ``state_logical`` (ZeRO-1 as
    ``opt_cfg`` says), the key and the step replicated."""
    shapes = tree_map(lambda s: s.shape, model.specs())
    logical = model.logical()
    tree_logical = {
        "params": logical,
        "opt": state_logical(logical, shapes, mesh, rules,
                             zero1=opt_cfg.zero1),
        "rng": (None,),
        "step": (),
    }
    tree_shapes = {"params": shapes,
                   "opt": {"mu": shapes, "nu": shapes, "step": ()},
                   "rng": (2,), "step": ()}
    return logical_to_sharding(tree_logical, tree_shapes, mesh, rules)


def routers(specs) -> int:
    """The mixture-of-experts blocks of a model's ParamSpecs: one a
    router, a stacked router one a layer."""
    if "router" in specs:
        shape = specs["router"].shape
        return shape[0] if len(shape) == 3 else 1
    return sum(routers(v) for v in specs.values() if isinstance(v, dict))


def _coordinate_parts(params, coords):
    """Each of ``coords``' model block of every parameter (ShardedTensors),
    on its device: a view of its own block, or gathered from the blocks
    where the rules split the parameter over the data axes too."""
    return [tree_map(lambda x, c=c: read_box(x, model_block(x, c), c),
                     params) for c in coords]


def slice_router_loads(model, params, coords, accum: int, micro_batch,
                       rules: ShardingRules = TP_DP_RULES) -> list:
    """One slice's routing pre-pass: for each of its ``accum`` micro-batches
    (``micro_batch(i)`` -> (batch, weight)), each MoE block's routed share
    of the slice's rows by layer key (``model.router_loads``), on the first
    coordinate's device; no graph is kept, and the parameters read are
    freed on return."""
    mesh = next(iter(tree_leaves(params))).sharding.mesh
    parts = _coordinate_parts(params, coords)
    with _on(mesh.device(coords[0])), activation_rules(mesh, rules):
        return [model.router_loads(parts if len(parts) > 1 else parts[0],
                                   micro_batch(i)[0]) for i in range(accum)]


def mean_loads(shares: list) -> dict:
    """The whole micro-batch's routed share of each MoE block from its
    slices' equal-sized shares: their sum in slice order over their
    number, on the first's device (on N cards, an all-reduce of E fp32
    values a block)."""
    home = next(iter(shares[0].values())).device
    return {k: sum(s[k].to(home) for s in shares) / len(shares)
            for k in shares[0]}


def slice_grads(model, params, coords, accum: int, micro_batch, loss,
                opt_cfg: AdamWConfig, rules: ShardingRules = TP_DP_RULES,
                loads=None, aux_weight: float = None):
    """One slice's gradients. ``coords``: the slice's mesh coordinates, one
    per model coordinate, in order. Each reads its model block of every
    parameter (``params``, ShardedTensors) on its device, gathered from the
    blocks where the rules split it over the data axes too (and freed with
    the slice's step); then each of ``accum`` micro-batches
    (``micro_batch(i)`` -> (batch, weight)) goes through ``model.loss``,
    with more than one model coordinate in lockstep under
    ``activation_rules`` of ``rules``, scaled by its weight, and
    ``backward()``; each part's loss is added into the tensor ``loss``.
    The gradients add up in the blocks' ``.grad``, or, with
    ``opt_cfg.grad_reduce_dtype`` and more than one micro-batch, each
    micro-batch's are cast to that dtype (the reduction over the slices
    runs in it) and summed in fp32, as the reference's cell step sums
    them. ``loads``, where the slice is one of several data slices of a
    model with routers, gives each micro-batch's routed shares of its
    whole rows (``mean_loads`` of the slices' ``slice_router_loads``): the
    cross-entropy then takes the micro-batch's weight, and the router loss
    ``aux_weight`` (1 / (slices x accum)), so that the slices' router
    losses add up to the whole micro-batch's (``moe.route_logits``).
    Returns the gradients, whole tensors on the first coordinate's device
    (``_slice_sum``)."""
    mesh = next(iter(tree_leaves(params))).sharding.mesh
    dev = mesh.device(coords[0])
    parts = [tree_map(lambda x: x.detach().requires_grad_(True), p)
             for p in _coordinate_parts(params, coords)]
    low = opt_cfg.grad_reduce_dtype if accum > 1 else None
    summed = None

    with _on(dev), activation_rules(mesh, rules):
        for i in range(accum):
            mb, weight = micro_batch(i)
            p = parts if len(parts) > 1 else parts[0]
            if loads is None:
                part, _ = model.loss(p, mb)
                part = part * weight
            else:
                _, terms = model.loss(p, mb, loads[i])
                part = terms["ce"] * weight + terms["aux"] * aux_weight
            part.backward()
            loss += part.detach().to(loss.device)
            if low is not None:
                g = tree_map(lambda g: g.to(torch_dtype(low)).float(),
                             _slice_sum(params, parts, coords))
                summed = g if summed is None else tree_map(
                    torch.Tensor.add_, summed, g)
    return summed if low is not None else _slice_sum(params, parts, coords)


def _slice_sum(params, parts, coords):
    """The slice's whole gradient of each parameter from its coordinates'
    blocks' ``.grad`` (zeros where a block got none), each cleared once
    read: one coordinate's is the whole; several coordinates' blocks are
    put together on the first coordinate's device, the blocks that several
    coordinates hold whole (``model_block`` gives them one box) summed in
    coordinate order: on N cards an all-reduce over the model axis."""
    def grad(p):
        return torch.zeros_like(p) if p.grad is None else p.grad

    if len(coords) == 1:
        out = tree_map(grad, parts[0])
        for p in tree_leaves(parts[0]):
            p.grad = None
        return out

    def leaf(x, *blocks):
        out = torch.zeros(x.shape, dtype=blocks[0].dtype,
                          device=blocks[0].device)
        boxes = [model_block(x, c) for c in coords]
        summed = boxes[0] == boxes[-1]
        with collective("all-reduce", out.nbytes, len(coords)) if summed \
                else contextlib.nullcontext():
            for box, p in zip(boxes, blocks):
                out[box] += grad(p).to(out.device)
                p.grad = None
        return out

    return tree_map(leaf, params, *parts)


def apply_step(opt_cfg: AdamWConfig, state, grads, loss):
    """The step after the gradients: ``apply_sharded_updates`` on each
    coordinate's blocks, the key folded once (every other coordinate gets
    a copy of it), the step counted. Returns (new state, metrics)."""
    new_params, opt, metrics = apply_sharded_updates(
        opt_cfg, state["params"], grads, state["opt"])
    rng = state["rng"]
    key = fold_in(rng.shards[rng.sharding.mesh.coords()[0]], 0)
    rng = rng.map(lambda k: copy_to(key, k.device))
    new_state = {"params": new_params, "opt": opt, "rng": rng,
                 "step": state["step"].map(lambda t: t + 1)}
    return new_state, dict(metrics, loss=loss)


class ElasticTrainer:
    """``data`` is a :class:`DataConfig` (the synthetic stream) or any
    object with ``batch(step)`` returning {"tokens", "labels"}.
    ``devices`` lists the devices slices may take, in order (default: the
    model's device, once); ``slices`` the job's starting slice count
    (default: as many as ``devices`` and ``cfg.max_slices`` allow); ``rms``
    an ``RMSProtocol`` to ask at each reconfiguration point."""

    def __init__(self, model, opt_cfg: AdamWConfig, data, cfg: TrainerConfig,
                 rms=None, job_id: int = 0, devices=None,
                 slices: Optional[int] = None):
        self.model = model
        self.opt_cfg = opt_cfg
        self.data = (SyntheticLMData(data) if isinstance(data, DataConfig)
                     else data)
        self.cfg = cfg
        self.devices = (list(devices) if devices is not None
                        else [model.device])
        self.slices = min(cfg.max_slices, len(self.devices) // cfg.model_ways)
        if slices is not None:
            if not 0 < slices <= self.slices:
                raise ValueError(f"{slices} slices: at most {self.slices}")
            self.slices = slices
        self.mesh = make_mesh(self.slices, cfg.model_ways,
                              devices=self.devices)
        self.dmr = DMR(rms, job_id, current_slices=self.slices) \
            if rms is not None else None
        self.store = CheckpointStore(cfg.ckpt_dir) if cfg.ckpt_dir else None
        self.metrics: list = []
        self.resize_log: list = []
        self.recoveries: list = []

    # -- sharding ------------------------------------------------------------

    def _state_shardings(self, mesh):
        return train_state_shardings(self.model, self.opt_cfg, mesh,
                                     self.cfg.rules)

    def on_mesh(self, state):
        """``state`` laid out on the trainer's mesh: a state of plain
        tensors (e.g. from ``bridge.state_from_jax``) is placed there."""
        if isinstance(state["step"], ShardedTensor):
            return state
        return tree_map(place, state, self._state_shardings(self.mesh))

    # -- state ---------------------------------------------------------------

    def init_state(self, seed: int = 0, params=None):
        """A fresh TrainState on the mesh: ``params`` (drawn from ``seed``
        unless given) laid out by the rules, on every slice or in blocks,
        zero AdamW moments, the key
        ``prng_key(seed + 1)`` and step 0."""
        if params is None:
            params = self.model.init(torch.Generator().manual_seed(seed))
        sh = self._state_shardings(self.mesh)

        def moments():
            return tree_map(lambda p, s: zeros(p.shape, torch.float32, s),
                            params, sh["opt"]["mu"])

        def step0(s):
            return zeros((), torch.int32, s)

        return {"params": tree_map(place, params, sh["params"]),
                "opt": {"mu": moments(), "nu": moments(),
                        "step": step0(sh["opt"]["step"])},
                "rng": place(prng_key(seed + 1), sh["rng"]),
                "step": step0(sh["step"])}

    # -- the step ------------------------------------------------------------

    def train_step(self, state, batch):
        """One optimizer step on the global ``batch``; returns (new state,
        metrics). Slice ``j`` takes rows ``j`` of each micro-batch cut in as
        many blocks as there are slices, and runs its model coordinates
        together (``slice_grads``). A model with routers on several slices
        first routes every slice's rows without a graph
        (``slice_router_loads``), so that each slice's router loss takes
        the whole micro-batch's routed shares, as the reference's step
        over the whole batch does; each slice's activations are still
        freed after its backward."""
        mesh, accum = self.mesh, self.cfg.grad_accum
        slices = slices_of(mesh)
        n = len(slices)
        rows = batch["tokens"].shape[0]
        if rows % (accum * n):
            raise ValueError(f"global batch {rows} does not split into "
                             f"{accum} micro-batches over {n} slices")
        micro, per = rows // accum, rows // accum // n
        counts = (batch["labels"] >= 0).reshape(accum, n, -1).sum(-1)
        counts = counts.tolist()
        loss = torch.zeros((), dtype=torch.float32,
                           device=mesh.device(slices[0][0]))

        def micro_batch(j):
            dev = mesh.device(slices[j][0])

            def rows(i):
                lo = i * micro + j * per
                # this slice's share of micro-batch i's unmasked labels
                return ({k: v[lo:lo + per].to(dev) for k, v in batch.items()},
                        max(counts[i][j], 1) / max(sum(counts[i]), 1) / accum)
            return rows

        loads = aux_weight = None
        if n > 1 and routers(self.model.specs()):
            shares = [slice_router_loads(self.model, state["params"], coords,
                                         accum, micro_batch(j),
                                         self.cfg.rules)
                      for j, coords in enumerate(slices)]
            loads = [mean_loads([s[i] for s in shares]) for i in range(accum)]
            aux_weight = 1 / (n * accum)
        reduced = None
        for j, coords in enumerate(slices):
            grads = slice_grads(self.model, state["params"], coords, accum,
                                micro_batch(j), loss, self.opt_cfg,
                                self.cfg.rules, loads, aux_weight)
            if reduced is None:
                reduced = grads
            else:
                tree_map(lambda r, g: r.add_(g.to(r.device)), reduced, grads)
        return apply_step(self.opt_cfg, state, reduced, loss)

    # -- reconfiguration (the paper's §5.2 protocol) -----------------------------

    def maybe_reconfigure(self, state):
        if self.dmr is None:
            return state
        action, new_slices, handler = self.dmr.check_status(
            minimum=self.cfg.min_slices, maximum=self.cfg.max_slices,
            factor=self.cfg.factor, preferred=self.cfg.preferred)
        if action is Action.NO_ACTION:
            return state
        # the resize alone: the step's queued work finishes first
        synchronize(state)
        t0 = time.perf_counter()
        new_mesh = resized_mesh(self.mesh, new_slices, devices=self.devices)
        state = reshard(state, self._state_shardings(new_mesh))
        synchronize(state)
        dt = time.perf_counter() - t0
        if handler is not None:
            handler.new_mesh = new_mesh
            handler.resize_time_s = dt
        self.resize_log.append(
            {"step": int(state["step"]), "action": action.name,
             "from": self.slices, "to": new_slices, "resize_s": dt})
        self.mesh = new_mesh
        self.slices = new_slices
        return state

    # -- loop -----------------------------------------------------------------

    def train(self, state=None, seed: int = 0):
        state = self.init_state(seed) if state is None else \
            self.on_mesh(state)
        start = int(state["step"])
        step, failed_at = start, None
        while step < self.cfg.steps:
            if self.dmr is not None and step > start and \
                    step % self.cfg.check_period == 0:
                state = self.maybe_reconfigure(state)
            batch = self.data.batch(step)
            try:
                state, metrics = self.train_step(state, batch)
            except Exception:
                if failed_at == step:
                    raise
                failed_at = step
                state = self._recover()
                self.recoveries.append({"failed": step,
                                        "restored": int(state["step"])})
                step = int(state["step"])
                continue
            step += 1
            if step % self.cfg.log_period == 0 or step == self.cfg.steps:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["slices"] = self.slices
                self.metrics.append(m)
            if self.store is not None and step % self.cfg.ckpt_period == 0:
                self.store.save_async(step, state)
        if self.store is not None:
            self.store.wait()
        return state

    def _recover(self):
        """Fault path: restore the latest checkpoint onto the current
        mesh."""
        if self.store is None:
            raise RuntimeError("step failed and no checkpoint store")
        self.store.wait()
        step = self.store.latest_step()
        if step is None:
            raise RuntimeError("step failed before first checkpoint")
        shardings = self._state_shardings(self.mesh)
        return self.store.restore(step, shardings, shardings)
