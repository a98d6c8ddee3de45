"""KV-cache autoregressive generation for the FFPA transformer.

The prefill runs the causal forward kernel over the prompt while writing the
per-layer KV cache; each decode step computes one token's q/k/v, writes it
into the cache and attends over the whole cache through the split-KV decode
kernel, with an additive validity bias masking the rows past the current
position (``decode_block``, which also teacher-forces up to 8 tokens at
once for speculative decoding). The cache has a static shape [B, Hkv, max_len, Dh].
"""

from __future__ import annotations

from typing import Optional

import torch

from ..env import resolve_device
from ..interface import ffpa_attn_func
from ..ops.reference import DEFAULT_MASK_VALUE
from .sampling import sample_logits
from .transformer import (
    ModelConfig, Transformer, _feature_kwargs, _mlp, _project_qkv, _rmsnorm,
)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    dev = resolve_device(device)
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return [
        {
            "k": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
        }
        for _ in range(cfg.n_layers)
    ]


@torch.inference_mode()
def prefill(model: Transformer, tokens, cache):
    """Run the prompt through the model, filling ``cache[:, :, :n]``.

    Returns (logits_last [B, vocab], cache)."""
    cfg = model.cfg
    b, n = tokens.shape
    x = model.embed[tokens]
    positions = torch.arange(n, device=tokens.device)
    enable_gqa = cfg.n_heads != cfg.n_kv_heads
    for li, layer in enumerate(model.layers):
        h = _rmsnorm(x, layer.attn_norm)
        q, k, v = _project_qkv(layer, h, cfg, positions)
        # In place, where the JAX package returns a new cache from
        # dynamic_update_slice: rows [0, n) of this layer's cache.
        cache[li]["k"][:, :, :n] = k
        cache[li]["v"][:, :, :n] = v
        o = ffpa_attn_func(
            q, k, v, is_causal=True, enable_gqa=enable_gqa,
            **_feature_kwargs(cfg, layer),
        )
        o = o.transpose(1, 2).reshape(b, n, cfg.n_heads * cfg.head_dim)
        x = x + layer.wo(o)
        h = _rmsnorm(x, layer.mlp_norm)
        x = x + _mlp(layer, h)
    x = _rmsnorm(x[:, -1:], model.final_norm)
    return (x @ model.embed.T)[:, 0], cache


def validity_bias(pos: int, m: int, max_len: int, sliding_window: int = 0, device=None):
    """The additive validity bias [1, 1, m, max_len] (fp32) of m tokens at
    positions pos..pos+m-1 over the cache: row t sees cache rows <= pos + t,
    and with a sliding window W only those >= pos + t - W."""
    rows = pos + torch.arange(m, device=device)[:, None]
    cols = torch.arange(max_len, device=device)[None, :]
    valid = cols <= rows
    if sliding_window > 0:
        valid = valid & (cols >= rows - sliding_window)
    return torch.where(valid, 0.0, DEFAULT_MASK_VALUE).float()[None, None]


@torch.inference_mode()
def decode_block(model: Transformer, cache, pos: int, toks):
    """Teacher-force ``toks`` [B, m] (m <= 8, the decode route) at positions
    pos..pos+m-1: ``decode_step`` is its m = 1 case, speculative decoding's
    verify block its m = k_spec + 1 case.

    Writes their K/V into the cache in place (rows pos..pos+m-1, where the
    JAX package uses dynamic_update_slice) and attends over the whole cache
    under ``validity_bias``. Returns (logits [B, m, vocab], cache)."""
    cfg = model.cfg
    b, m = toks.shape
    dev = toks.device
    x = model.embed[toks]  # [B, m, D]
    positions = pos + torch.arange(m, device=dev)
    bias = validity_bias(pos, m, cache[0]["k"].shape[2], cfg.sliding_window, device=dev)
    enable_gqa = cfg.n_heads != cfg.n_kv_heads
    for li, layer in enumerate(model.layers):
        h = _rmsnorm(x, layer.attn_norm)
        q, k, v = _project_qkv(layer, h, cfg, positions)
        cache[li]["k"][:, :, pos : pos + m] = k
        cache[li]["v"][:, :, pos : pos + m] = v
        o = ffpa_attn_func(
            q, cache[li]["k"], cache[li]["v"], attn_mask=bias,
            enable_gqa=enable_gqa, **_feature_kwargs(cfg, layer, window=False),
        )
        x = x + layer.wo(o.transpose(1, 2).reshape(b, m, -1))
        h = _rmsnorm(x, layer.mlp_norm)
        x = x + _mlp(layer, h)
    x = _rmsnorm(x, model.final_norm)
    return x @ model.embed.T, cache


def decode_step(model: Transformer, cache, pos: int, token):
    """One autoregressive step.

    Args:
      cache: per-layer KV cache, updated in place and returned.
      pos: index the new token is written at.
      token: [B] int.

    Returns (logits [B, vocab], cache).
    """
    logits, cache = decode_block(model, cache, pos, token[:, None])
    return logits[:, 0], cache


@torch.inference_mode()
def generate(
    model: Transformer,
    prompt: torch.Tensor,
    steps: int,
    max_len: Optional[int] = None,
    greedy: bool = True,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    generator: Optional[torch.Generator] = None,
):
    """Autoregressive generation: prompt [B, Np] -> tokens [B, steps].

    One prefill, then one ``decode_step`` per output token (the JAX
    package's scan becomes a Python loop). The default is greedy argmax; a
    positive ``temperature`` samples with optional top-k / top-p from
    ``generator``. Runs on the model's device.
    """
    cfg = model.cfg
    dev = model.embed.device
    prompt = prompt.to(dev)
    b, np_ = prompt.shape
    max_len = max_len or (np_ + steps)
    cache = init_kv_cache(cfg, b, max_len, device=dev)
    if not greedy and temperature <= 0.0:
        temperature = 1.0
    ctl = dict(temperature=temperature, top_k=top_k, top_p=top_p,
               sampled=float(temperature) > 0.0)

    logits, cache = prefill(model, prompt, cache)
    tok = sample_logits(logits, generator, **ctl)
    toks = []
    for i in range(steps):
        logits, cache = decode_step(model, cache, np_ + i, tok)
        toks.append(tok)
        tok = sample_logits(logits, generator, **ctl)
    return torch.stack(toks, dim=1)


__all__ = ["init_kv_cache", "prefill", "decode_step", "generate"]
