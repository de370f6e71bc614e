"""Elastic trainer, at one slice for now.

Counterpart of ``repro.runtime.trainer``: ``ElasticTrainer`` owns a
TrainState (``params``, AdamW's ``opt``, ``step``) and runs the train step,
``model.loss`` with ``loss.backward()`` over ``grad_accum`` micro-batches
(their gradients and losses averaged, as the reference's scan sums them and
divides), then ``apply_updates``. ``train`` logs ``loss``, ``lr``,
``grad_norm``, ``step`` and ``slices`` every ``log_period`` steps.

This slice trains on one device. What makes the trainer elastic is not
ported yet and raises: the DMR reconfiguration points (``rms``), more than
one slice or model-parallel ways (resharding, ROADMAP.md Queue 1 item 2)
and checkpoints (item 3). The reference's ``rng`` leaf, which no step
reads, is left out, as are the options of those parts (``check_period``,
``min_slices``, ``factor``, ``preferred``, ``ckpt_period``, the sharding
``rules``, ``donate``) and ``job_id``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.models.layers import tree_map
from repro_torch.optim import AdamWConfig, apply_updates, init_state


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    grad_accum: int = 1
    max_slices: int = 1
    model_ways: int = 1               # TP width inside a slice
    ckpt_dir: Optional[str] = None
    log_period: int = 10


class ElasticTrainer:
    """``data`` is a :class:`DataConfig` (the synthetic stream) or any
    object with ``batch(step)`` returning {"tokens", "labels"}."""

    def __init__(self, model, opt_cfg: AdamWConfig, data, cfg: TrainerConfig,
                 rms=None):
        not_yet = []
        if rms is not None:
            not_yet.append("DMR reconfiguration (rms)")
        if cfg.max_slices > 1 or cfg.model_ways > 1:
            not_yet.append(f"{cfg.max_slices} slices x {cfg.model_ways} "
                           "model ways (resharding, ROADMAP.md Queue 1 "
                           "item 2)")
        if cfg.ckpt_dir is not None:
            not_yet.append("checkpoints (ROADMAP.md Queue 1 item 3)")
        if not_yet:
            raise NotImplementedError(
                "not ported yet: " + "; ".join(not_yet) + " (ROADMAP.md, "
                "Queue 1 items 2-3)")
        self.model = model
        self.opt_cfg = opt_cfg
        self.data = (SyntheticLMData(data) if isinstance(data, DataConfig)
                     else data)
        self.cfg = cfg
        self.slices = 1
        self.metrics: list = []

    # -- state ---------------------------------------------------------------

    def init_state(self, seed: int = 0, params=None):
        """A fresh TrainState: ``params`` (drawn from ``seed`` unless
        given), zero AdamW moments, step 0."""
        if params is None:
            params = self.model.init(torch.Generator().manual_seed(seed))
        return {"params": params, "opt": init_state(params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=self.model.device)}

    # -- the step ------------------------------------------------------------

    def train_step(self, state, batch):
        """One optimizer step on ``batch``; returns (new state, metrics)."""
        accum = self.cfg.grad_accum
        params = tree_map(lambda p: p.detach().requires_grad_(True),
                          state["params"])
        batch = {k: v.to(self.model.device) for k, v in batch.items()}
        loss = torch.zeros((), dtype=torch.float32, device=self.model.device)
        for i in range(accum):
            micro = {k: v.reshape((accum, -1) + v.shape[1:])[i]
                     for k, v in batch.items()}
            micro_loss, _ = self.model.loss(params, micro)
            micro_loss.backward()
            loss = loss + micro_loss.detach()
        grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                         else p.grad / accum if accum > 1 else p.grad, params)
        params = tree_map(lambda p: p.detach(), params)
        params, opt, metrics = apply_updates(self.opt_cfg, params, grads,
                                             state["opt"])
        new_state = {"params": params, "opt": opt,
                     "step": state["step"] + 1}
        return new_state, dict(metrics, loss=loss / accum)

    # -- loop ----------------------------------------------------------------

    def train(self, state=None, seed: int = 0):
        if state is None:
            state = self.init_state(seed)
        step = int(state["step"])
        while step < self.cfg.steps:
            state, metrics = self.train_step(state, self.data.batch(step))
            step += 1
            if step % self.cfg.log_period == 0 or step == self.cfg.steps:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["slices"] = self.slices
                self.metrics.append(m)
        return state
