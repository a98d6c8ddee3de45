"""Head-sharded tensor-parallel attention.

Attention needs no communication under head sharding: Q heads and their
GQA KV groups split over the ``tp`` axis (Q heads ``[r*Hq/tp,
(r+1)*Hq/tp)`` keep KV heads ``[r*Hkv/tp, ...)``), and each rank runs the
kernel on its heads. The communication belongs to the surrounding
projections (the all-reduce after the output projection, in
``models/transformer.py``). The whole-tensor entries here take global
tensors on every rank and gather the ranks' heads back.
"""

from __future__ import annotations

from typing import Optional

from ..interface import ffpa_attn_func
from ._collectives import gather, shard
from .mesh import axis_group, axis_size


def _check_heads(hq: int, hkv: int, tp: int, head_axis: str) -> None:
    if hq % tp != 0:
        raise ValueError(f"Hq={hq} not divisible by {head_axis}={tp}")
    if hkv % tp != 0:
        raise ValueError(
            f"Hkv={hkv} not divisible by {head_axis}={tp}; replicate KV heads or "
            "choose a smaller head axis"
        )


def head_parallel_attention(
    q,
    k,
    v,
    mesh,
    *,
    head_axis: str = "tp",
    scale: Optional[float] = None,
    is_causal: bool = False,
    enable_gqa: bool = False,
):
    """Attention sharded over Q / KV heads; no collectives inside.

    Requires Hq % tp == 0 and, under GQA, Hkv % tp == 0 (KV heads
    co-located with their Q-head group). Differentiable; each rank's
    gradients are the global ones."""
    tp = axis_size(mesh, head_axis)
    _check_heads(q.shape[1], k.shape[1], tp, head_axis)
    group = axis_group(mesh, head_axis)
    q, k, v = (shard(x, 1, group) for x in (q, k, v))
    o = ffpa_attn_func(q, k, v, is_causal=is_causal, scale=scale, enable_gqa=enable_gqa)
    return gather(o, 1, group)


def paged_head_parallel_decode(
    q,
    cache,
    mesh,
    *,
    head_axis: str = "tp",
    scale: Optional[float] = None,
):
    """Head-sharded paged decode: the page pools (and int8 scales) are cut
    on their Hkv axis, so each rank holds its KV heads' pages (the pool
    memory scales down with tp), the page table and lens are replicated,
    and the paged kernel runs per rank on its local GQA group. No
    collectives inside; the ranks' heads are gathered back. A caller whose
    ranks keep only their own heads' pools calls ``paged_decode_attention``
    on them directly."""
    from ..ops.paged import PagedKVCache, paged_decode_attention

    tp = axis_size(mesh, head_axis)
    _check_heads(q.shape[1], cache.k_pages.shape[1], tp, head_axis)
    group = axis_group(mesh, head_axis)
    pools = [None if t is None else shard(t, 1, group)
             for t in (cache.k_pages, cache.v_pages, cache.k_scales, cache.v_scales)]
    local = PagedKVCache(pools[0], pools[1], cache.page_table, cache.lens, pools[2], pools[3])
    o = paged_decode_attention(shard(q, 1, group), local, scale=scale)
    return gather(o, 1, group)


__all__ = ["head_parallel_attention", "paged_head_parallel_decode"]
