"""Batched decode serving engine (continuous batching over a fixed slot grid).

The port of the JAX package's ``repro.serve.engine``, with its choices
kept, so that the same weights give the same tokens:

  * ``n_slots`` sequences share one KV cache (slot = batch index);
    requests queue and are admitted in submission order into free slots;
  * a prompt is fed token by token through the same ``decode_step`` as
    generation (the prompt's next token is appended while it lasts), then
    generation is greedy (argmax of the logits);
  * one ``pos`` is shared by all slots and advances every tick (lock
    step): a request admitted later writes and reads from the current
    ``pos`` on, and a slot's cache is not reset on admit, so it attends
    over what earlier requests in that slot left below ``pos``.

The model holds its weights, so the engine takes no ``params``.  The
cache is whatever ``model.cache_struct`` gives (zamba2's nested one
too), handed back and forth unread.  As in the reference the engine
serves token ids only (llava decodes text without its patch prefix), and
it refuses an encoder, which has no decode step.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from ..models.model import TransformerLM


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_tokens: int = 16
    out: List[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, model: TransformerLM, n_slots: int, smax: int) -> None:
        if model.cfg.is_encoder:
            raise ValueError(f"{model.cfg.name}: encoder archs are not served "
                             "(no decode step)")
        self.model = model
        self.n_slots = n_slots
        self.smax = smax
        self.cache = model.cache_struct(n_slots, smax)
        self.step_fn = model.decode_step
        self.queue: List[Request] = []
        self.active: List[Optional[Request]] = [None] * n_slots
        self.pos = 0  # lockstep position across slots
        self.stats = {"ticks": 0, "tokens": 0}

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for i in range(self.n_slots):
            if self.active[i] is None and self.queue:
                self.active[i] = self.queue.pop(0)

    def _slot_token(self, req: Optional[Request]) -> int:
        if req is None:
            return 0
        consumed = len(req.out)
        if consumed < len(req.prompt):
            return req.prompt[consumed]
        return req.out[-1] if req.out else (req.prompt[-1] if req.prompt else 0)

    def tick(self) -> int:
        """Run one decode step for all slots; returns #generated tokens."""
        self._admit()
        if all(r is None for r in self.active) or self.pos >= self.smax:
            return 0
        toks = torch.tensor([self._slot_token(r) for r in self.active],
                            dtype=torch.int32, device=self.model.device)
        self.cache, logits = self.step_fn(self.cache, toks, self.pos)
        nxt = logits.argmax(dim=-1).cpu().tolist()
        produced = 0
        for i, req in enumerate(self.active):
            if req is None:
                continue
            consumed = len(req.out)
            if consumed + 1 < len(req.prompt):
                req.out.append(int(req.prompt[consumed + 1]))  # prompt feed
            else:
                req.out.append(int(nxt[i]))
                produced += 1
            if len(req.out) - len(req.prompt) >= req.max_tokens:
                req.done = True
                self.active[i] = None
        self.pos += 1
        self.stats["ticks"] += 1
        self.stats["tokens"] += produced
        return produced

    def run(self, max_ticks: int = 10_000) -> Dict[str, float]:
        t0 = time.perf_counter()
        while (self.queue or any(self.active)) and self.stats["ticks"] < max_ticks:
            if self.tick() == 0 and not self.queue and not any(self.active):
                break
            if self.pos >= self.smax:
                break
        dt = time.perf_counter() - t0
        return {
            **self.stats,
            "wall_s": dt,
            "tok_per_s": self.stats["tokens"] / max(dt, 1e-9),
        }
