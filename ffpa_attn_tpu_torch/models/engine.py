"""Continuous-batching serving engine: dynamic admission over paged pools.

``serve_batch_paged`` serves a fixed batch to completion; here requests
arrive and finish at different times and the batch membership changes
between steps:

* device state keeps its shape: the per-layer page pools never change;
  admission and eviction rewrite one page-table row (``assign_sequence``)
  and fill the slot's pages from the new request's prefill (``fill_slot``);
* the host owns page accounting through one ``PageAllocator`` (the tables
  are identical across layers, so a slot's page run is acquired once and
  reused by every layer's pool);
* idle slots point at the null page with ``lens`` at capacity, so the paged
  decode kernel walks only the null page for them and their outputs are
  ignored;
* each ``step()`` runs one batch decode step, then the host checks for
  finished requests (token budget or EOS), releases their pages and admits
  queued requests into the freed slots.

Sampling draws from a ``torch.Generator`` seeded from ``seed``: greedy
streams equal the JAX package's, sampled ones follow the same distribution
with other draws.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from ..ops.config import cdiv
from ..ops.paged import PageAllocator, PagedKVCache, assign_sequence, fill_slot
from .generate import init_kv_cache, prefill
from .sampling import sample_logits
from .serving import _paged_decode_step
from .transformer import Transformer


@dataclass
class _Slot:
    active: bool = False
    request_id: int = -1
    pages: list = field(default_factory=list)
    prompt_len: int = 0
    emitted: list = field(default_factory=list)
    max_new: int = 0


class ServingEngine:
    """Dynamic continuous batching over per-layer paged KV pools.

    Usage::

        eng = ServingEngine(model, batch_slots=4, max_len=4096)
        rid = eng.submit(prompt_tokens, max_new_tokens=128)
        while not eng.done():
            finished = eng.step()   # {request_id: [tokens...]} completions

    ``eos_id``: optional early-stop token. Prefill runs per admitted request
    (B=1 dense) and loads the slot's pages. Runs on the model's device.
    """

    @torch.inference_mode()
    def __init__(
        self,
        model: Transformer,
        batch_slots: int,
        max_len: int,
        page_size: int = 128,
        quantized: bool = False,
        eos_id: Optional[int] = None,
        extra_pages: Optional[int] = None,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
    ):
        cfg = model.cfg
        self.model = model
        self.cfg = cfg
        self.device = model.embed.device
        self.batch = batch_slots
        self.max_len = max_len
        self.page_size = page_size
        self.eos_id = eos_id
        self.max_pages = cdiv(max_len, page_size)
        num_pages = 1 + batch_slots * self.max_pages + (extra_pages or 0)
        self.alloc = PageAllocator(num_pages, reserved=1)

        def empty_pool():
            # extra_pages sizes the physical pools too: the allocator hands
            # those ids out. The engine owns the table: every slot starts
            # idle on the null page with lens at capacity.
            c = PagedKVCache.alloc(
                batch_slots, max_len, cfg.n_kv_heads, cfg.head_dim, page_size=page_size,
                dtype=cfg.torch_dtype, quantized=quantized, extra_pages=extra_pages or 0,
                device=self.device,
            )
            c.page_table.zero_()
            c.lens.fill_(max_len)
            return c

        self.caches = [empty_pool() for _ in range(cfg.n_layers)]
        self.slots = [_Slot() for _ in range(batch_slots)]
        self.tokens = torch.zeros((batch_slots,), dtype=torch.int64, device=self.device)
        self.queue: list = []
        self._next_id = 0
        self.steps_run = 0
        # Requests that complete outside step()'s decode (a budget of 1, EOS
        # on the prefill token) wait here until step() drains them.
        self._completed: dict = {}
        # Sampling controls (temperature 0 = greedy); one generator for the
        # whole engine: deterministic per (seed, arrival order).
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))

    def _sample(self, logits):
        return sample_logits(logits, self._gen, temperature=self.temperature,
                             top_k=self.top_k, top_p=self.top_p)

    # -- request lifecycle -------------------------------------------------

    def submit(self, prompt, max_new_tokens: int) -> int:
        prompt = torch.as_tensor(prompt, device=self.device).to(torch.int64)
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if int(prompt.shape[0]) + 1 > self.max_len:
            # A slot must hold the prompt plus at least one generated row.
            raise ValueError(
                f"prompt of {int(prompt.shape[0])} tokens cannot fit a slot "
                f"of max_len={self.max_len}"
            )
        rid = self._next_id
        self._next_id += 1
        self.queue.append((rid, prompt, max_new_tokens))
        self._admit()
        return rid

    def done(self) -> bool:
        return (
            not self.queue
            and not self._completed  # step() must drain instant finishes
            and not any(s.active for s in self.slots)
        )

    # -- internals -----------------------------------------------------------

    @torch.inference_mode()
    def _admit(self) -> None:
        # A degenerate request (budget 1, instant EOS) frees its slot during
        # this pass; keep admitting until no slot can take work.
        while self.queue and (i := self._free_slot()) is not None:
            rid, prompt, max_new = self.queue[0]
            n = int(prompt.shape[0])
            # The prompt was checked at submit(); the slot's row budget is
            # clipped to max_len, so need <= max_pages.
            need = cdiv(min(n + max_new, self.max_len), self.page_size)
            pages = self.alloc.acquire(need)
            if pages is None:
                if not any(s.active for s in self.slots):
                    raise RuntimeError(
                        f"request {rid} needs {need} pages but only "
                        f"{self.alloc.free_pages} are free with an idle "
                        "batch — pool too small (raise extra_pages)"
                    )
                return  # pool full; the request waits for evictions
            self.queue.pop(0)

            # Prefill the request alone (B=1 dense), then load its pages.
            pad = cdiv(n, self.page_size) * self.page_size
            dense = init_kv_cache(self.cfg, 1, pad, device=self.device)
            logits, dense = prefill(self.model, prompt[None], dense)
            first = self._sample(logits)[0]
            for li in range(self.cfg.n_layers):
                assign_sequence(self.caches[li], i, pages)
                fill_slot(self.caches[li], i, dense[li]["k"][0], dense[li]["v"][0], n)
            self.tokens[i] = first
            first = int(first)
            self.slots[i] = _Slot(
                active=True, request_id=rid, pages=pages, prompt_len=n,
                emitted=[first], max_new=max_new,
            )
            # The prefill token may already complete the request (a budget
            # of 1, or EOS straight away): finish before any decode step.
            if max_new <= 1 or (self.eos_id is not None and first == self.eos_id):
                self._finish(i, self._completed)

    def _free_slot(self):
        for i, slot in enumerate(self.slots):
            if not slot.active:
                return i
        return None

    def _finish(self, i: int, finished: dict) -> None:
        slot = self.slots[i]
        finished[slot.request_id] = slot.emitted
        self.alloc.release(slot.pages)
        for cache in self.caches:
            # Idle again: a null table row, lens at capacity.
            assign_sequence(cache, i, [])
            cache.lens[i] = self.max_len
        self.slots[i] = _Slot()

    @torch.inference_mode()
    def step(self) -> dict:
        """One batch decode step; returns completions {request_id: tokens}."""
        finished, self._completed = self._completed, {}
        if not any(s.active for s in self.slots):
            self._admit()
            finished.update(self._completed)
            self._completed = {}
            if not any(s.active for s in self.slots):
                return finished

        logits, self.caches = _paged_decode_step(self.model, self.caches, self.tokens)
        nxt = self._sample(logits)
        self.tokens = nxt
        self.steps_run += 1
        # One device-to-host copy each for the tokens and lens.
        nxt_host = nxt.cpu().tolist()
        lens_host = self.caches[0].lens.cpu().tolist()

        for i, slot in enumerate(self.slots):
            if not slot.active:
                continue
            slot.emitted.append(int(nxt_host[i]))
            hit_eos = self.eos_id is not None and int(nxt_host[i]) == self.eos_id
            cap = int(lens_host[i]) >= min(slot.prompt_len + slot.max_new, self.max_len)
            if hit_eos or cap or len(slot.emitted) >= slot.max_new:
                self._finish(i, finished)
        self._admit()
        finished.update(self._completed)
        self._completed = {}
        return finished


__all__ = ["ServingEngine"]
