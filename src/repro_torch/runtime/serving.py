"""Batched serving loop: continuous batching over prefill + decode.

Counterpart of ``repro.runtime.serving``, kept a faithful twin so that both
emit the same tokens from the same weights. It is generic over the model's
cache: the KV cache of attention models (smollm-135m, qwen3-4b,
granite-3-2b, and the "moe" blocks of phi3.5-moe and deepseek-moe), the
conv window and SSM state of Mamba-2 (mamba2-130m), and the local layers'
ring-buffer KV cache (the window's size, position p in slot p % window)
of gemma2-27b and of recurrentgemma-9b, beside the latter's conv window
and recurrent state ``h``. That includes
three behaviours of the reference that the port mirrors rather than fixes:

- ``add`` prefills a slot by stepping its prompt through full-batch decode
  steps with token 0 in every other row, so those steps overwrite the other
  rows' KV cache at the same positions, and advance the other rows'
  recurrent states (SSM state, ``h``) and conv windows by one token each;
- ``serve_step`` decodes every row at one ``pos``, the largest over the
  active slots;
- the KV cache's ``pos`` vector is shared by the whole batch.

A :class:`Server` owns a params copy and a slot-based cache; requests join
free slots, decode steps advance all active slots together, finished
sequences free their slots.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new_tokens: int = 32
    out: Optional[List[int]] = None


class Server:
    def __init__(self, model, params, *, batch: int, max_len: int,
                 temperature: float = 0.0):
        self.model = model
        self.params = params
        self.batch = batch
        self.max_len = max_len
        self.temperature = temperature
        self.cache = model.init_cache(batch, max_len)
        self.pos = np.zeros(batch, np.int32)
        self.active: Dict[int, Request] = {}
        self.slot_of: Dict[int, int] = {}

    def free_slots(self) -> List[int]:
        used = set(self.slot_of.values())
        return [i for i in range(self.batch) if i not in used]

    def add(self, req: Request) -> bool:
        if len(req.prompt) > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt length {len(req.prompt)} "
                f"exceeds the KV cache (max_len={self.max_len})")
        slots = self.free_slots()
        if not slots:
            return False
        slot = slots[0]
        self.slot_of[req.rid] = slot
        self.active[req.rid] = req
        req.out = []
        # prefill this slot by stepping the prompt (slot-local decode), as
        # the reference does
        for t, tok in enumerate(req.prompt[:-1]):
            self._step_slot(slot, int(tok), t)
        self.pos[slot] = len(req.prompt) - 1
        return True

    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(toks).to(self.model.device)

    @torch.inference_mode()
    def _step_slot(self, slot: int, token: int, pos: int):
        toks = np.zeros((self.batch, 1), np.int32)
        toks[slot, 0] = token
        _, self.cache = self.model.decode_step(self.params, self.cache,
                                               self._tokens(toks), pos)

    @torch.inference_mode()
    def serve_step(self) -> Dict[int, int]:
        """One batched decode step for all active requests."""
        if not self.active:
            return {}
        toks = np.zeros((self.batch, 1), np.int32)
        for rid, req in self.active.items():
            slot = self.slot_of[rid]
            last = req.out[-1] if req.out else int(req.prompt[-1])
            toks[slot, 0] = last
        pos = int(max(self.pos[self.slot_of[r]] for r in self.active))
        logits, self.cache = self.model.decode_step(
            self.params, self.cache, self._tokens(toks), pos)
        emitted = {}
        logits = logits[:, -1].float().cpu().numpy()
        for rid, req in list(self.active.items()):
            slot = self.slot_of[rid]
            if self.temperature > 0:
                p = np.exp(logits[slot] / self.temperature)
                nxt = int(np.argmax(np.random.default_rng(rid).multinomial(
                    1, p / p.sum())))
            else:
                nxt = int(np.argmax(logits[slot]))
            req.out.append(nxt)
            self.pos[slot] += 1
            emitted[rid] = nxt
            # finish on budget, or evict when the next decode position
            # would fall outside the KV cache
            if len(req.out) >= req.max_new_tokens or \
                    self.pos[slot] >= self.max_len:
                del self.active[rid]
                del self.slot_of[rid]
        return emitted

    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        queue = list(requests)
        done: Dict[int, List[int]] = {}
        while queue or self.active:
            while queue and self.add(queue[0]):
                queue.pop(0)
            before = set(self.active)
            self.serve_step()
            for rid in before - set(self.active):
                req = next(r for r in requests if r.rid == rid)
                done[rid] = req.out
        return done
