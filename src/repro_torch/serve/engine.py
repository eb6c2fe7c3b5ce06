"""Batched serving engine: continuous-batching-lite decode over a fixed
slot pool with true per-slot positions and KV cache. Port of
`repro.serve.engine`.

The engine keeps `num_slots` concurrent sequences. Each call to
`step_all()` decodes one token for every active slot with one decode
step that takes a (num_slots,) position vector, so a slot refilled
mid-run restarts at position 0 with a zeroed cache row (KV, or the
recurrent state of Mamba, xLSTM and RWKV layers, every leaf zeroed as in
JAX, the stabiliser m included) and can neither attend to nor overwrite
the previous occupant's. Finished or empty
slots are refilled from the request queue.

Prefill: newly filled slots consume their whole prompt in one call
(`_prefill_scan`): a Python loop over the padded prompt drives the same
per-slot decode step, with a per-slot validity mask selecting which
slots' cache rows, positions and logits advance at each step, so slots
mid-generation and shorter prompts in the same batch are untouched
beyond their length, and the result is step for step the token-by-token
decode path. Prompt lengths are padded to power-of-two buckets, as in
JAX (where the bucket bounds the number of compiles).

Sampling is greedy at temperature 0, else Gumbel-max with noise drawn
from `np.random.RandomState(seed)` on the host, so both packages draw
the same noise. Everything runs under `torch.inference_mode()` on the
engine's device; the params must already be there.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import Device, resolve_device


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 32
    out: Optional[List[int]] = None


class ServeEngine:
    def __init__(self, model, params, num_slots: int = 8,
                 max_seq: int = 512, temperature: float = 0.0,
                 cache_dtype: torch.dtype = torch.float32, seed: int = 0,
                 use_prefill: bool = True, device: Device = "cuda"):
        self.device = resolve_device(device)
        where = next(params.parameters()).device
        if where.type != self.device.type:
            raise ValueError(f"params are on {where}, the engine on "
                             f"{self.device}: move them with .to()")
        self.model = model
        self.params = params
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.temperature = temperature
        self.use_prefill = use_prefill
        with torch.inference_mode():
            self.cache = model.init_cache(num_slots, max_seq, cache_dtype,
                                          device=self.device)
        self.pos = np.zeros(num_slots, np.int32)       # per-slot next write
        self.active: List[Optional[Request]] = [None] * num_slots
        self.queue: List[Request] = []
        self.done: Dict[int, Request] = {}
        self._last_tok = np.zeros((num_slots, 1), np.int32)
        self._pending_prompt: Dict[int, List[int]] = {}
        self._rng = np.random.RandomState(seed)
        self.decode_steps = 0    # decode-step calls, prefill steps included

    def submit(self, req: Request):
        req.out = []
        self.queue.append(req)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.int64)).to(self.device)

    def _reset_slots(self, slots: List[int]):
        """Zero the given slots across the whole KV cache in one pass per
        leaf (batch is axis 1 of every leaf, after the stacked-layer
        axis)."""
        idx = self._tensor(slots)
        with torch.inference_mode():
            for leaves in self.cache.values():
                for leaf in leaves.values():
                    leaf[:, idx] = 0

    def _refill(self):
        filled = []
        for s in range(self.num_slots):
            if self.active[s] is None and self.queue:
                req = self.queue.pop(0)
                self.active[s] = req
                self.pos[s] = 0
                self._last_tok[s, 0] = 0
                filled.append(s)
                self._pending_prompt[s] = list(req.prompt)
        if filled:
            self._reset_slots(filled)
            if self.use_prefill:
                self._prefill_slots(filled)

    def _prefill_slots(self, filled: List[int]):
        """Consume the pending prompts of `filled` in one call.

        Other slots ride along with lens=0: the validity mask keeps their
        cache rows, positions, and logits untouched. The last valid
        logits per slot yield the first generated token, exactly what the
        token-by-token path samples after consuming the final prompt
        token."""
        lens = np.zeros(self.num_slots, np.int32)
        for s in filled:
            lens[s] = len(self._pending_prompt[s])
        longest = int(lens.max())
        if longest == 0:
            return
        bucket = 1 << (longest - 1).bit_length()       # power-of-two pad
        toks = np.zeros((self.num_slots, bucket), np.int32)
        for s in filled:
            toks[s, :lens[s]] = self._pending_prompt[s]
        last_logits, self.cache = _prefill_scan(
            self.model.decode_step, self.model.cfg.vocab_size, self.params,
            self.cache, self._tensor(toks), self._tensor(lens),
            self._tensor(self.pos))
        self.decode_steps += bucket
        self.pos += lens
        nxt = self._sample(last_logits.cpu().numpy())
        for s in filled:
            if lens[s] == 0:
                continue
            self._pending_prompt[s] = []
            req = self.active[s]
            req.out.append(int(nxt[s]))
            self._last_tok[s, 0] = nxt[s]
            if len(req.out) >= req.max_new or self.pos[s] >= self.max_seq - 1:
                self.done[req.rid] = req
                self.active[s] = None

    def _sample(self, logits: np.ndarray) -> np.ndarray:
        """logits: (num_slots, V) -> next token per slot. Greedy at
        temperature 0, else Gumbel-max (vectorized exact categorical)."""
        if self.temperature <= 0:
            return logits.argmax(-1)
        u = self._rng.uniform(1e-12, 1.0, size=logits.shape)
        g = -np.log(-np.log(u))
        return (logits / self.temperature + g).argmax(-1)

    def step_all(self) -> int:
        """One decode step for all slots; returns #active slots."""
        self._refill()
        pending = self._pending_prompt
        n_active = sum(r is not None for r in self.active)
        if n_active == 0:
            return 0
        # choose this step's input token per slot
        toks = np.zeros((self.num_slots, 1), np.int32)
        for s, req in enumerate(self.active):
            if req is None:
                continue
            if pending.get(s):
                toks[s, 0] = pending[s].pop(0)
            else:
                toks[s, 0] = self._last_tok[s, 0]
        logits, self.cache = self.model.decode_step(
            self.params, self.cache, self._tensor(toks),
            self._tensor(self.pos))
        self.decode_steps += 1
        nxt = self._sample(logits[:, 0].cpu().numpy())
        for s, req in enumerate(self.active):
            if req is None:
                continue
            self.pos[s] += 1
            if pending.get(s):
                continue  # still consuming prompt
            req.out.append(int(nxt[s]))
            self._last_tok[s, 0] = nxt[s]
            if len(req.out) >= req.max_new or self.pos[s] >= self.max_seq - 1:
                self.done[req.rid] = req
                self.active[s] = None
        return n_active

    def run(self, max_steps: int = 10_000) -> Dict[int, Request]:
        steps = 0
        while (self.queue or any(self.active)) and steps < max_steps:
            self.step_all()
            steps += 1
        return self.done


def _prefill_scan(decode_step, vocab_size: int, params, cache, toks, lens,
                  pos):
    """Run the decode step over a padded prompt batch, one position at a
    time.

    toks: (B, L) padded prompts; lens: (B,) valid lengths (0 = slot not
    prefilling); pos: (B,) each slot's current write position. Returns
    (last valid logits (B, V) fp32, updated cache). Steps at t >=
    lens[b] leave slot b's cache row, position, and logits unchanged, so
    idle and mid-generation slots are bit-identical before and after.
    JAX merges the whole new cache with the old one per slot; here the
    decode step does the same merge where it writes (`write=valid`): an
    attention layer writes only entry pos[b] of each valid row, a
    recurrent layer keeps the old state of rows that are not valid."""
    B, L = toks.shape
    with torch.inference_mode():
        last = torch.zeros((B, vocab_size), dtype=torch.float32,
                           device=toks.device)
        for t in range(L):
            valid = t < lens                                 # (B,)
            logits, cache = decode_step(params, cache, toks[:, t:t + 1], pos,
                                        write=valid)
            last = torch.where(valid[:, None], logits[:, 0].float(), last)
            pos = torch.where(valid, pos + 1, pos)
    return last, cache
