"""Continuous batching: mixed-length prefill through the varlen kernel.

Prompts of different lengths are packed into ONE [T, H, D] varlen attention
call per layer (``prefill_packed``; the kernel walks only each query tile's
interval of key tiles, so cross-segment tiles cost nothing), their K/V are
scattered into per-sequence cache slots, and generation proceeds with a
batched decode step, over either

* the dense shared-row cache (``serve_batch``): every sequence writes
  generated token t at cache row ``base + t`` and the raggedness lives in a
  per-sequence validity bias (the split-KV decode kernel), or
* per-layer page pools (``serve_batch_paged``): rows are true positions and
  the paged decode kernel reads ``lens[b]`` rows per sequence.

Batch shapes are static (B sequences, cache length ``max_len``); prompt
lengths are dynamic. The JAX package's ``lax.scan`` loops are Python loops
under ``torch.inference_mode()``, and caches are written in place.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..interface import ffpa_attn_func, ffpa_attn_varlen_func
from ..ops.paged import PagedKVCache, append_token, fill_from_prefill, paged_decode_attention
from ..ops.reference import DEFAULT_MASK_VALUE
from .generate import init_kv_cache
from .transformer import Transformer, _feature_kwargs, _mlp, _rmsnorm, _rope


def pack_prompts(prompts: Sequence[torch.Tensor], pad_to: int):
    """Pack 1-D token prompts into (packed [T] int32, cu_seqlens [B+1]
    int32) on the prompts' device. ``pad_to`` fixes the packed length; the
    tail is padding tokens (id 0) that form the varlen pseudo-segment B."""
    lens = [int(p.shape[0]) for p in prompts]
    total = sum(lens)
    assert total <= pad_to, (total, pad_to)
    dev = prompts[0].device
    packed = torch.cat([p.to(torch.int32) for p in prompts]
                       + [torch.zeros((pad_to - total,), dtype=torch.int32, device=dev)])
    cu = torch.tensor([0] + torch.tensor(lens).cumsum(0).tolist(), dtype=torch.int32,
                      device=dev)
    return packed, cu


@torch.inference_mode()
def prefill_packed(model: Transformer, packed, cu_seqlens, max_seqlen: int, cache):
    """Mixed-length prefill: one varlen attention call per layer.

    Args:
      packed: [T] int32 packed prompt tokens (B segments + tail padding).
      cu_seqlens: [B+1] int32 segment offsets.
      max_seqlen: bound on the longest prompt.
      cache: per-layer KV cache [B, Hkv, max_len, Dh] (``init_kv_cache``),
        written in place.

    Returns (last_logits [B, vocab], cache): logits at each sequence's
    final prompt token.
    """
    cfg = model.cfg
    t = packed.shape[0]
    batch = cache[0]["k"].shape[0]
    dh = cfg.head_dim
    dev = packed.device
    t_ids = torch.arange(t, dtype=torch.int32, device=dev)
    seg = torch.searchsorted(cu_seqlens[1:].contiguous(), t_ids, right=True)
    seg_c = seg.clamp(0, batch - 1)
    pos = t_ids - cu_seqlens[seg_c]
    # Padding rows (past cu_seqlens[-1]) are not scattered into the cache:
    # the valid rows are the prefix [0, cu_seqlens[-1]) (one host read).
    n_valid = int(cu_seqlens[-1])
    seg_v, pos_v = seg_c[:n_valid], pos[:n_valid].long()

    x = model.embed[packed][None]  # [1, T, D]
    enable_gqa = cfg.n_heads != cfg.n_kv_heads
    for li, layer in enumerate(model.layers):
        h = _rmsnorm(x, layer.attn_norm)
        n = h.shape[1]
        q = layer.wq(h).reshape(n, cfg.n_heads, dh)
        k = layer.wk(h).reshape(n, cfg.n_kv_heads, dh)
        v = layer.wv(h).reshape(n, cfg.n_kv_heads, dh)
        # Rope with per-segment positions (restart at each prompt).
        q = _rope(q.transpose(0, 1)[None], pos)[0].transpose(0, 1)
        k = _rope(k.transpose(0, 1)[None], pos)[0].transpose(0, 1)
        # In place, where the JAX package scatters with mode="drop".
        cache[li]["k"][seg_v, :, pos_v] = k[:n_valid]
        cache[li]["v"][seg_v, :, pos_v] = v[:n_valid]
        o = ffpa_attn_varlen_func(
            q, k, v, cu_seqlens, cu_seqlens, max_seqlen, max_seqlen,
            causal=True, enable_gqa=enable_gqa, **_feature_kwargs(cfg, layer),
        )
        x = x + layer.wo(o.reshape(n, cfg.n_heads * dh))[None]
        h = _rmsnorm(x, layer.mlp_norm)
        x = x + _mlp(layer, h)

    x = _rmsnorm(x[0], model.final_norm)  # [T, D]
    last_rows = (cu_seqlens[1:] - 1).clamp_min(0).long()
    return x[last_rows] @ model.embed.T, cache


def _prompts_on(model: Transformer, prompts):
    dev = model.embed.device
    return [torch.as_tensor(p, device=dev) for p in prompts]


@torch.inference_mode()
def serve_batch(model: Transformer, prompts: Sequence[torch.Tensor], steps: int, max_len: int,
                pack_to: int | None = None):
    """Continuous-batching generation for B mixed-length prompts: one packed
    varlen prefill + ``steps - 1`` batched decode steps over the dense
    shared-row cache. Returns greedy tokens [B, steps]."""
    cfg = model.cfg
    prompts = _prompts_on(model, prompts)
    batch = len(prompts)
    lens_list = [int(p.shape[0]) for p in prompts]
    lens = torch.tensor(lens_list, dtype=torch.int32, device=model.embed.device)
    packed, cu = pack_prompts(prompts, pack_to or sum(lens_list))
    max_seqlen = max(lens_list)
    # Shared-row layout: generated token t of every sequence lands at cache
    # row base + t (base = the longest prompt); RoPE carries each token's
    # true position lens[b] + t. The highest row written is base + steps - 2
    # (the last sampled token is returned, never cached); a cache row past
    # max_len would be an out-of-bounds write, so the bound is asserted.
    base = max_seqlen
    assert base + steps - 1 <= max_len, (base, steps, max_len)
    cache = init_kv_cache(cfg, batch, max_len, device=model.embed.device)
    logits, cache = prefill_packed(model, packed, cu, max_seqlen, cache)
    tok = logits.argmax(-1)
    toks = [tok]
    for t in range(steps - 1):
        logits, cache = _batched_decode_step(model, cache, lens, t, tok, base)
        tok = logits.argmax(-1)
        toks.append(tok)
    return torch.stack(toks, dim=1)  # [B, steps]


def _token_block(model: Transformer, token, positions, attend):
    """The per-token transformer stack of every decode flavour: embed ->
    [norm, QKV, RoPE at ``positions``, attend(li, q, k, v) -> o, residual,
    MLP] x layers -> final norm -> logits. ``attend`` owns the cache write
    and the attention call (shared-row dense or paged pools)."""
    cfg = model.cfg
    b = token.shape[0]
    dh = cfg.head_dim
    x = model.embed[token][:, None]  # [B, 1, D]
    for li, layer in enumerate(model.layers):
        h = _rmsnorm(x, layer.attn_norm)
        q = layer.wq(h).reshape(b, 1, cfg.n_heads, dh).transpose(1, 2)
        k = layer.wk(h).reshape(b, 1, cfg.n_kv_heads, dh).transpose(1, 2)
        v = layer.wv(h).reshape(b, 1, cfg.n_kv_heads, dh).transpose(1, 2)
        q = _rope_at(q, positions)
        k = _rope_at(k, positions)
        o = attend(li, q, k, v)
        x = x + layer.wo(o.transpose(1, 2).reshape(b, 1, -1))
        h = _rmsnorm(x, layer.mlp_norm)
        x = x + _mlp(layer, h)
    x = _rmsnorm(x[:, -1], model.final_norm)
    return x @ model.embed.T


def shared_row_bias(lens: torch.Tensor, t: int, base: int, max_len: int,
                    sliding_window: int = 0) -> torch.Tensor:
    """The validity bias [B, 1, 1, max_len] (fp32: 0 or MASK_VALUE) of the
    shared-row decode step ``t``: sequence b attends its prompt rows
    ``[0, lens[b])`` and the generated rows ``[base, base + t]``; the gap
    ``[lens[b], base)`` is masked out. A sliding window counts true
    positions: prompt row c sits at position c, generated row c at
    ``lens[b] + (c - base)``. ``lens`` is on the cache's device."""
    cols = torch.arange(max_len, device=lens.device)[None, :]
    prompt_ok = cols < lens[:, None]
    gen_ok = (cols >= base) & (cols <= base + t)
    if sliding_window > 0:
        w = sliding_window
        prompt_ok = prompt_ok & (cols >= (lens + t)[:, None] - w)
        gen_ok = gen_ok & (cols >= base + t - w)
    return torch.where(prompt_ok | gen_ok, 0.0, DEFAULT_MASK_VALUE).float()[:, None, None, :]


@torch.inference_mode()
def _batched_decode_step(model: Transformer, cache, lens, t: int, token, base: int):
    """One decode step for a ragged batch at shared step index ``t``.

    Sequence b's token has true position ``lens[b] + t`` (RoPE) and is
    cached at shared row ``base + t``. Valid attention columns are the
    prompt rows ``[0, lens[b])`` plus the generated rows ``[base, base + t]``;
    the gap ``[lens[b], base)`` is masked out."""
    cfg = model.cfg
    positions = lens + t
    write_row = base + t
    bias = shared_row_bias(lens, t, base, cache[0]["k"].shape[2], cfg.sliding_window)
    enable_gqa = cfg.n_heads != cfg.n_kv_heads

    def attend(li, q, k, v):
        # One whole-batch cache write at the shared row, in place.
        cache[li]["k"][:, :, write_row:write_row + 1] = k
        cache[li]["v"][:, :, write_row:write_row + 1] = v
        return ffpa_attn_func(
            q, cache[li]["k"], cache[li]["v"], attn_mask=bias, enable_gqa=enable_gqa,
            **_feature_kwargs(cfg, model.layers[li], window=False),
        )

    return _token_block(model, token, positions, attend), cache


def _rope_at(x, positions):
    """Rope for [B, H, 1, Dh] at per-batch positions [B]."""
    outs = _rope(x.permute(2, 1, 0, 3), positions)  # [1, H, B, Dh], one position per "row"
    return outs[0].transpose(0, 1)[:, :, None, :]


@torch.inference_mode()
def serve_batch_paged(model: Transformer, prompts: Sequence[torch.Tensor], steps: int,
                      max_len: int, page_size: int = 128, pack_to: int | None = None,
                      quantized: bool = False):
    """Continuous batching over paged KV (``ops/paged.py``): per-layer page
    pools + per-sequence page tables, so a ragged batch reads bytes in
    proportion to its true lengths. The same contract as ``serve_batch``;
    cache rows are true positions (no row remap, no mask gap). Returns
    greedy tokens [B, steps]."""
    cfg = model.cfg
    dev = model.embed.device
    prompts = _prompts_on(model, prompts)
    batch = len(prompts)
    lens_list = [int(p.shape[0]) for p in prompts]
    lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    packed, cu = pack_prompts(prompts, pack_to or sum(lens_list))
    max_seqlen = max(lens_list)
    # The highest token index ever cached is lens[b] + steps - 2.
    assert max_seqlen + steps - 1 <= max_len, (max_seqlen, steps, max_len)

    dense = init_kv_cache(cfg, batch, max_seqlen, device=dev)
    logits, dense = prefill_packed(model, packed, cu, max_seqlen, dense)
    caches = [
        fill_from_prefill(
            PagedKVCache.alloc(batch, max_len, cfg.n_kv_heads, cfg.head_dim, page_size,
                               dtype=cfg.torch_dtype, quantized=quantized, device=dev),
            dense[li]["k"], dense[li]["v"], lens,
        )
        for li in range(cfg.n_layers)
    ]
    del dense
    tok = logits.argmax(-1)
    toks = [tok]
    for _ in range(steps - 1):
        logits, caches = _paged_decode_step(model, caches, tok)
        tok = logits.argmax(-1)
        toks.append(tok)
    return torch.stack(toks, dim=1)  # [B, steps]


@torch.inference_mode()
def _paged_decode_step(model: Transformer, caches, token):
    """One decode step over per-layer paged pools. The new token's true
    position is ``caches[0].lens`` (rows are positions); its K/V are
    appended before attention so the kernel's ``[0, lens)`` includes it.
    Sliding window, softcap and sinks apply in the paged kernel (the window
    as a page-walk cut)."""
    cfg = model.cfg
    # A copy: the appends below advance every layer's lens in place.
    positions = caches[0].lens.clone()

    def attend(li, q, k, v):
        cache = append_token(caches[li], k, v)
        layer = model.layers[li]
        return paged_decode_attention(
            q, cache, scale=cfg.head_dim**-0.5, softcap=cfg.attn_softcap,
            window_left=cfg.sliding_window if cfg.sliding_window > 0 else -1,
            sinks=layer.attn_sinks if cfg.attn_sinks else None,
        )

    return _token_block(model, token, positions, attend), caches


__all__ = [
    "pack_prompts",
    "prefill_packed",
    "serve_batch",
    "serve_batch_paged",
    "shared_row_bias",
]
