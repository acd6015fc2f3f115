"""Batched serving engine: continuous batching over the decode step.

A request pool, a fixed decode batch with slot reuse (a finished
request's slot is refilled from the queue on the next step — continuous
batching), ring-buffer KV reuse, and per-request max_tokens/EOS
termination.

The decode batch never changes shape.  Slot refill resets that slot's
entries in every layer's state (KV cache, SSM ``h``/``conv``, RWKV
``wkv``/``shift_*``) from a fresh copy.  A tick feeds each slot one
token (a prompt token while prefilling, else its last generated one)
and picks the next greedily (argmax on the device; one (B,) read).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig


@dataclass
class Request:
    uid: int
    prompt: list[int]
    max_tokens: int = 16
    generated: list[int] = field(default_factory=list)
    done: bool = False


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: lm.LM,
                 batch_slots: int = 4, cache_len: int = 256,
                 eos_id: int | None = None, greedy: bool = True):
        # ``greedy`` is accepted and ignored, as in the reference: decoding
        # is always greedy
        self.cfg = cfg
        self.params = params
        self.device = params.device
        self.slots: list[Request | None] = [None] * batch_slots
        self.cache_len = cache_len
        self.eos_id = eos_id
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self.states = lm.init_decode_state(params, cfg, batch_slots,
                                           cache_len)
        self._fresh = lm.init_decode_state(params, cfg, batch_slots,
                                           cache_len)
        self.positions = np.zeros(batch_slots, np.int32)
        self.pending = np.zeros(batch_slots, np.int32)  # prompt cursor

    def submit(self, req: Request):
        self.queue.append(req)

    @torch.no_grad()
    def _reset(self, slot: int) -> None:
        """The slot's state in every layer back to its fresh value."""
        for st, fresh in zip(self.states, self._fresh, strict=True):
            for s, f in zip(_leaves(st), _leaves(fresh), strict=True):
                s[slot] = f[slot]

    def _fill_slots(self):
        for i, slot in enumerate(self.slots):
            if (slot is None or slot.done) and self.queue:
                self.slots[i] = self.queue.pop(0)
                self.positions[i] = 0
                self.pending[i] = 0
                self._reset(i)

    def _next_tokens(self, logits: torch.Tensor) -> np.ndarray:
        return logits.argmax(-1).to(torch.int32).cpu().numpy()

    def step(self):
        """One engine tick: feed prompt tokens or sample, per slot."""
        self._fill_slots()
        tokens = np.zeros(len(self.slots), np.int32)
        for i, req in enumerate(self.slots):
            if req is None or req.done:
                continue
            cursor = int(self.pending[i])
            if cursor < len(req.prompt):
                tokens[i] = req.prompt[cursor]
            elif req.generated:
                tokens[i] = req.generated[-1]
            else:
                tokens[i] = req.prompt[-1]
        self.states, logits = lm.decode_step(
            self.params, self.cfg, self.states,
            torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(self.positions).to(self.device))
        nxt = self._next_tokens(logits)
        for i, req in enumerate(self.slots):
            if req is None or req.done:
                continue
            self.positions[i] += 1
            cursor = int(self.pending[i])
            if cursor < len(req.prompt) - 1:
                self.pending[i] = cursor + 1      # still prefilling
                continue
            self.pending[i] = cursor + 1
            tok = int(nxt[i])
            req.generated.append(tok)
            if (self.eos_id is not None and tok == self.eos_id) \
                    or len(req.generated) >= req.max_tokens:
                req.done = True
                self.finished.append(req)

    def run_until_done(self, max_ticks: int = 10_000):
        ticks = 0
        while (self.queue or any(r is not None and not r.done
                                 for r in self.slots)):
            self.step()
            ticks += 1
            if ticks >= max_ticks:
                raise RuntimeError("serving did not converge")
        return ticks
