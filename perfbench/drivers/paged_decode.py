"""Closed-loop decode over a paged latent cache: absorbed MLA through the
port's public ``PagedKVCache``, ``append_token`` and
``paged_decode_attention``.

A step runs every layer: it appends each request's nq new latent rows
(K is the row, V its first Dv columns, a view of K's pool) and attends
them with the configuration's softmax scale. After the last layer the
step restores every layer's ``lens`` with one copy, so every step of every
run does the same work. The harness ends the step with a synchronize.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

from ffpa_attn_tpu_torch import PagedKVCache, append_token, paged_decode_attention

from .. import traffic_gen as tg
from ..refs import mla_absorbed as ref
from ..roofline import latent_decode_counts

# Queries and new rows a step cycles through (drawn in set-up).
RING = 5
# Layer calls of the window that the check keeps and compares.
SAMPLES = 24


def mla_shape(config: dict) -> dict:
    """Absorbed-MLA attention shape of a configuration: query heads, the
    latent row's width D (``kv_lora_rank`` + ``qk_rope_head_dim``), V's
    width Dv (``kv_lora_rank``), layers and the softmax scale."""
    rank, rope = int(config["kv_lora_rank"]), int(config["qk_rope_head_dim"])
    return dict(hq=int(config["num_attention_heads"]), d=rank + rope, dv=rank,
                layers=int(config["num_hidden_layers"]), scale=softmax_scale(config))


def softmax_scale(config: dict) -> float:
    """(qk_nope_head_dim + qk_rope_head_dim)^-0.5, times mscale^2 under
    YaRN, mscale = 0.1 * mscale_all_dim * ln(factor) + 1 (DeepSeek-V3's
    published inference code; Kimi-K2 runs the same)."""
    scale = (int(config["qk_nope_head_dim"]) + int(config["qk_rope_head_dim"])) ** -0.5
    rs = config.get("rope_scaling") or {}
    if rs.get("type") == "yarn" and rs.get("mscale_all_dim"):
        mscale = 0.1 * float(rs["mscale_all_dim"]) * math.log(float(rs["factor"])) + 1.0
        scale *= mscale * mscale
    return scale


def latents(seed: int, layer: int, num_pages: int, page: int, d: int, device) -> torch.Tensor:
    """Layer ``layer``'s pool of latent rows [pages, 1, page, D] bf16,
    drawn on the device in one call from the seed."""
    g = torch.Generator(device=device)
    g.manual_seed(tg.torch_seed(seed, tg.STREAM_LATENTS, layer))
    return torch.randn((num_pages, 1, page, d), generator=g, dtype=torch.bfloat16, device=device)


def _draw(seed: int, stream: int, shape, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(tg.torch_seed(seed, stream))
    return torch.randn(shape, generator=g, dtype=torch.bfloat16, device=device)


class Driver:
    """One cell's program state and inputs: a ``PagedKVCache`` a layer over
    pools drawn from the seed, a ring of queries and new rows, and the
    sampled outputs that the check compares."""

    def __init__(self, config: dict, mix: dict, seed: int, device, *, pool: str = "bf16"):
        self.seed, self.device, self.pool = int(seed), torch.device(device), pool
        s = mla_shape(config)
        self.hq, self.d, self.dv, self.layers, self.scale = (
            s["hq"], s["d"], s["dv"], s["layers"], s["scale"])
        self.batch, self.nq, self.page = int(mix["batch"]), int(mix["nq"]), int(mix["page_size"])
        self.lens = tg.lengths(mix)
        table, self.num_pages = tg.page_table(self.lens, self.nq, self.page, seed)
        dev = self.device
        self.table = torch.from_numpy(table).to(dev)
        self.lens0 = torch.from_numpy(np.tile(self.lens.astype(np.int32), (self.layers, 1))).to(dev)
        self.lens_all = self.lens0.clone()  # row l is layer l's cache.lens
        self.q = _draw(seed, tg.STREAM_Q, (RING, self.batch, self.hq, self.nq, self.d), dev)
        self.rows = _draw(seed, tg.STREAM_ROWS, (RING, self.batch, 1, self.nq, self.d), dev)
        self.caches = [self._cache(layer) for layer in range(self.layers)]
        self._sampler = tg.rng(seed, tg.STREAM_SAMPLE)
        self.kept: list = []  # (step, layer, ring index, output)
        self.host_us: list = []
        self.recording = False
        self._seen = 0

    def _cache(self, layer: int) -> PagedKVCache:
        k = latents(self.seed, layer, self.num_pages, self.page, self.d, self.device)
        lens = self.lens_all[layer]
        if self.pool == "bf16":
            return PagedKVCache(k_pages=k, v_pages=k[..., :self.dv], page_table=self.table,
                                lens=lens)
        if self.pool == "int8":  # the program's own lower precision: the control
            from ffpa_attn_tpu_torch.ops.paged import fill_slot

            shape, dev = (self.num_pages, 1, self.page), self.device
            pools = [torch.zeros(shape + (w,), dtype=torch.int8, device=dev)
                     for w in (self.d, self.dv)]
            scales = [torch.ones(shape, dtype=torch.float32, device=dev) for _ in range(2)]
            # fill_slot takes K and V of one width: each pool is filled alone.
            fills = [PagedKVCache(k_pages=p, v_pages=p, page_table=self.table, lens=lens,
                                  k_scales=s, v_scales=s) for p, s in zip(pools, scales)]
            for b, n in enumerate(self.lens):
                rows = ref.gather_rows(k, self.table[b], int(n))[None]
                for fill, w in zip(fills, (self.d, self.dv)):
                    fill_slot(fill, b, rows[..., :w], rows[..., :w], int(n))
            return PagedKVCache(k_pages=pools[0], v_pages=pools[1], page_table=self.table,
                                lens=lens, k_scales=scales[0], v_scales=scales[1])
        raise ValueError(f"unknown pool {self.pool!r}")

    # -- the timed path ---------------------------------------------------

    def tokens_per_step(self) -> int:
        return self.batch * self.nq

    def _slot(self):
        """Reservoir sample over the window's layer calls: the slot this
        call's output is kept in, or None."""
        self._seen += 1
        if len(self.kept) < SAMPLES:
            self.kept.append(None)
            return len(self.kept) - 1
        j = int(self._sampler.integers(self._seen))
        return j if j < SAMPLES else None

    def step(self, step: int, spans: bool = False) -> None:
        span = torch.profiler.record_function if spans else (lambda _: contextlib.nullcontext())
        nq, dv = self.nq, self.dv
        for layer, cache in enumerate(self.caches):
            i = (step * self.layers + layer) % RING
            t0 = time.perf_counter()
            with span("perfbench.append"):
                rows = self.rows[i]
                for t in range(nq):
                    k_new = rows[:, :, t:t + 1]
                    append_token(cache, k_new, k_new[..., :dv])
            with span("perfbench.attend"):
                o = paged_decode_attention(self.q[i], cache, scale=self.scale)
            if self.recording:
                self.host_us.append((time.perf_counter() - t0) * 1e6)
                slot = self._slot()
                if slot is not None:
                    self.kept[slot] = (step, layer, i, o)
        with span("perfbench.restore"):
            self.lens_all.copy_(self.lens0)

    # -- counts for the readers -------------------------------------------

    def counts(self) -> dict:
        flops, nbytes = latent_decode_counts(self.lens, hq=self.hq, nq=self.nq, d=self.d,
                                             dv=self.dv)
        return dict(calls_per_step=self.layers, flops_per_call=flops, bytes_per_call=nbytes,
                    host_call_us=list(self.host_us), walk_kernels=("paged_tma_kernel",),
                    merge_kernels=("split_merge_kernel",))

    # -- the check ----------------------------------------------------------

    def free(self) -> None:
        """Drop the program's state (pools, caches, lens); the sampled
        outputs and the inputs stay for the check."""
        self.caches = []
        self.lens_all = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: str | None = None) -> dict:
        """Compare every sampled output, every request of it, with the
        plain reference over the same latents (drawn again from the seed),
        queries and new rows: the largest absolute gap, and the largest
        relative RMS gap of one sampled call. ``control="fp8"`` puts the
        reference computed from float8 e4m3 inputs in the program's place."""
        kept = sorted((k for k in self.kept if k is not None), key=lambda k: k[1])
        max_abs = torch.zeros((), device=self.device)
        rel = []
        pool_layer, pool = None, None
        for _, layer, i, o in kept:
            if layer != pool_layer:
                pool = None
                pool = latents(self.seed, layer, self.num_pages, self.page, self.d, self.device)
                pool_layer = layer
            num = torch.zeros((), device=self.device)
            den = torch.zeros((), device=self.device)
            for b, n in enumerate(self.lens):
                rows = torch.cat([ref.gather_rows(pool, self.table[b], int(n)),
                                  self.rows[i][b, 0]], dim=0)
                q = self.q[i][b]
                want = ref.decode_request(q, rows, dv=self.dv, scale=self.scale)
                got = o[b].float() if control is None else ref.decode_request(
                    q, rows, dv=self.dv, scale=self.scale, precision=control)
                gap = got - want
                max_abs = torch.maximum(max_abs, gap.abs().max())
                num += gap.square().sum()
                den += want.square().sum()
            rel.append((num / den).sqrt())
        pool = None
        return dict(samples=len(kept), max_abs_err=float(max_abs),
                    rms_rel_err=float(torch.stack(rel).max()) if rel else float("nan"))
