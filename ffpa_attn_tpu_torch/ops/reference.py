"""fp32-accumulated reference attention: the test oracle.

Plain PyTorch exact attention with every FFPA feature: tail-aligned causal
masking, additive masks, GQA head expansion, softcap, sliding window, ALiBi,
attention sinks, the deterministic hash dropout of ``rng.py`` and LSE
output. The kernels are held to it at fp16 1e-2 / bf16 2e-2, and it is the
compute path of the SDPA fallback.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .rng import dropout_keep_mask, make_row_col_ids

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def expand_kv_heads(kv: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """Expand [B, Hkv, N, D] -> [B, Hq, N, D] by repeating each group."""
    b, hkv, n, d = kv.shape
    group = num_q_heads // hkv
    if group == 1:
        return kv
    return kv[:, :, None].expand(b, hkv, group, n, d).reshape(b, num_q_heads, n, d)


def reduce_q_heads(grad: torch.Tensor, num_kv_heads: int) -> torch.Tensor:
    """Reduce [B, Hq, N, D] grads back to [B, Hkv, N, D] by group-sum."""
    b, hq, n, d = grad.shape
    group = hq // num_kv_heads
    if group == 1:
        return grad
    return grad.reshape(b, num_kv_heads, group, n, d).sum(dim=2)


def tail_aligned_causal_mask(nq: int, nkv: int, device=None) -> torch.Tensor:
    """Boolean [nq, nkv] mask: row m attends cols <= m + (nkv - nq)."""
    rows, cols = make_row_col_ids(nq, nkv, device=device)
    return cols <= rows + (nkv - nq)


def band_mask(nq: int, nkv: int, wl: int, wr: int, device=None) -> Optional[torch.Tensor]:
    """Boolean [nq, nkv] sliding-window band around the tail-aligned
    diagonal (``-1`` = unbounded side), or None when both sides are open."""
    if wl < 0 and wr < 0:
        return None
    rows, cols = make_row_col_ids(nq, nkv, device=device)
    pos = rows + (nkv - nq)
    band = torch.ones((nq, nkv), dtype=torch.bool, device=device)
    if wr >= 0:
        band = band & (cols <= pos + wr)
    if wl >= 0:
        band = band & (cols >= pos - wl)
    return band


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    is_causal: bool = False,
    scale: Optional[float] = None,
    dropout_p: float = 0.0,
    dropout_seed: int = 0,
    return_lse: bool = False,
    softcap: float = 0.0,
    window: tuple = (-1, -1),
    alibi_slopes: Optional[torch.Tensor] = None,
    sinks: Optional[torch.Tensor] = None,
):
    """Exact attention with fp32 accumulation.

    Args:
      q: [B, Hq, Nq, D]
      k, v: [B, Hq, Nkv, D] (GQA expansion must already have happened;
        callers use :func:`expand_kv_heads`). ``v`` may have a different
        last dim Dv.
      bias: additive float bias broadcastable to [B, Hq, Nq, Nkv] or None.
      is_causal: tail-aligned causal masking.
      scale: defaults to 1/sqrt(D).
      dropout_p / dropout_seed: hash dropout (``rng.py``).
      return_lse: also return natural-log LSE [B, Hq, Nq] fp32.
      softcap: ``s = cap * tanh(s / cap)`` on the scaled scores, before bias,
        ALiBi and masking (0 = off).
      window: ``(left, right)`` band around the tail-aligned diagonal, -1 =
        unbounded; ``is_causal`` composes as right = 0.
      alibi_slopes: fp32 slopes ``[Hq]`` or ``[B, Hq]``; adds
        ``-slope * |p - col|``.
      sinks: per-head sink logits ``[Hq]`` fp32: extra softmax-denominator
        mass that attends no value.

    Returns:
      out [B, Hq, Nq, Dv] in q.dtype (and lse if requested).
    """
    b_, hq, nq, d = q.shape
    nkv = k.shape[2]
    dev = q.device
    if scale is None:
        scale = 1.0 / math.sqrt(d)

    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap and softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    offset = nkv - nq
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32, device=dev)
        if slopes.ndim == 1:
            slopes = slopes[None].expand(b_, hq)
        rows, cols = make_row_col_ids(nq, nkv, device=dev)
        dist = (rows + offset - cols).abs().float()
        s = s - slopes[:, :, None, None] * dist[None, None]
    if bias is not None:
        s = s + bias.float()
    wl, wr = int(window[0]), int(window[1])
    if is_causal:
        wr = 0
    band = band_mask(nq, nkv, wl, wr, device=dev)
    if band is not None:
        s = torch.where(band[None, None], s, DEFAULT_MASK_VALUE)

    m = s.amax(dim=-1, keepdim=True)
    if sinks is not None:
        sink_col = torch.as_tensor(sinks, dtype=torch.float32, device=dev)[None, :, None, None]
        m = torch.maximum(m, sink_col)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if sinks is not None:
        l = l + torch.exp(sink_col - m)
    lse = (m + torch.log(l))[..., 0]

    p = p / torch.where(l == 0.0, torch.ones_like(l), l)

    if dropout_p > 0.0:
        rows, cols = make_row_col_ids(nq, nkv, device=dev)
        bi = torch.arange(b_, device=dev)[:, None, None, None]
        hi = torch.arange(hq, device=dev)[None, :, None, None]
        keep = dropout_keep_mask(dropout_seed, bi, hi, rows, cols, dropout_p)
        p = torch.where(keep, p, 0.0) / (1.0 - dropout_p)

    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    if return_lse:
        return out, lse
    return out


__all__ = [
    "DEFAULT_MASK_VALUE",
    "expand_kv_heads",
    "reduce_q_heads",
    "tail_aligned_causal_mask",
    "band_mask",
    "reference_attention",
]
