"""Ulysses-style sequence parallelism: all-to-all head-scatter attention.

Activations arrive sequence-sharded [B, H, N/S, D]; an all-to-all re-shards
them head-sharded [B, H/S, N, D], so each rank runs ONE dense attention call
over the FULL sequence on its head slice, and the inverse all-to-all
restores sequence sharding:

    q/k/v [B, H, N/S, D]  --all_to_all(head->seq)-->  [B, H/S, N, D]
    o = ffpa(q, k, v)      (full-sequence kernel, exact causal/tail masks)
    o [B, H/S, N, D]      --all_to_all(seq->head)-->  [B, H, N/S, D]

Against the ring: Ulysses moves activations twice but runs the kernel at
full sequence length, the better choice when H >= S and N is moderate; the
ring keeps activations resident and overlaps its rotations with compute,
the better choice for very long N or H < S.

Gradients: the exchange is an autograd function whose backward is the
inverse all-to-all (``_collectives.all_to_all``), and the attention is
``ffpa_attn_func``'s own autograd.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..interface import ffpa_attn_func
from ._collectives import all_to_all, copy_to, gather, shard


def _ulysses_local(
    q, k, v, *, group, scale, causal, enable_gqa,
    softcap=0.0, window=(-1, -1), alibi_slopes=None, sinks=None,
):
    # [B, H, Nl, D] -> [B, Hl, N, D]: scatter heads, gather sequence.
    q_h, k_h, v_h = (all_to_all(x, 1, 2, group) for x in (q, k, v))
    # Each rank holds the FULL sequence for its head block, so every feature
    # works unchanged; per-head operands (ALiBi slopes, sinks) slice to the
    # rank's head range: the all-to-all gives rank i heads [i*Hl, (i+1)*Hl).
    extra = {}
    if softcap and softcap > 0.0:
        extra["softcap"] = softcap
    if tuple(window) != (-1, -1):
        extra["window_size"] = tuple(window)
    idx, hl = dist.get_rank(group), q_h.shape[1]
    if alibi_slopes is not None:
        extra["alibi_slopes"] = torch.as_tensor(alibi_slopes)[..., idx * hl:(idx + 1) * hl]
    if sinks is not None:
        extra["sinks"] = torch.as_tensor(sinks)[idx * hl:(idx + 1) * hl]
    o_h = ffpa_attn_func(q_h, k_h, v_h, is_causal=causal, scale=scale, enable_gqa=enable_gqa,
                         **extra)
    # [B, Hl, N, D] -> [B, H, Nl, D]: gather heads, scatter sequence.
    return all_to_all(o_h, 2, 1, group)


def ulysses_attention(
    q,
    k,
    v,
    *,
    group,
    scale: Optional[float] = None,
    causal: bool = False,
    enable_gqa: bool = False,
    softcap: float = 0.0,
    window=(-1, -1),
    alibi_slopes=None,
    sinks=None,
):
    """Per-shard entry: every rank of ``group`` calls it with its shard.

    Per-shard shapes: q [B, Hq, Nq/S, D], k / v [B, Hkv, Nkv/S, D].
    Requires Hq % S == 0 (and Hkv % S == 0 under GQA): the all-to-all
    scatters the head axis over the S ranks. softcap / window / ALiBi /
    sinks compose (full sequence per head block; the per-head operands are
    given whole and cut here). The gradient of ``sinks`` is this rank's
    heads' part; a caller holding them replicated sums it over the group."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return _ulysses_local(
        q, k, v, group=group, scale=float(scale), causal=causal, enable_gqa=enable_gqa,
        softcap=softcap, window=tuple(window), alibi_slopes=alibi_slopes, sinks=sinks,
    )


def ulysses_attention_sharded(
    q,
    k,
    v,
    mesh,
    *,
    seq_axis: str = "sp",
    scale: Optional[float] = None,
    causal: bool = False,
    enable_gqa: bool = False,
    softcap: float = 0.0,
    window=(-1, -1),
    alibi_slopes=None,
    sinks=None,
):
    """Whole-tensor entry: every rank holds the global q, k, v, keeps its
    shard of the sequence on ``seq_axis`` and gets the global output back,
    differentiable. softcap / window / ALiBi / sinks compose (see
    ``ulysses_attention``)."""
    group = mesh.get_group(seq_axis)
    sp = dist.get_world_size(group)
    hq, hkv = q.shape[1], k.shape[1]
    if hq % sp != 0:
        raise ValueError(f"Ulysses requires Hq % sp == 0, got {hq} % {sp}")
    if hkv % sp != 0:
        raise ValueError(f"Ulysses requires Hkv % sp == 0, got {hkv} % {sp}")
    q, k, v = (shard(x, 2, group) for x in (q, k, v))
    if alibi_slopes is not None:
        alibi_slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32, device=q.device)
    if sinks is not None:
        sinks = copy_to(torch.as_tensor(sinks, dtype=torch.float32, device=q.device), group)
    o = ulysses_attention(q, k, v, group=group, scale=scale, causal=causal,
                          enable_gqa=enable_gqa, softcap=softcap, window=window,
                          alibi_slopes=alibi_slopes, sinks=sinks)
    return gather(o, 2, group)


__all__ = ["ulysses_attention", "ulysses_attention_sharded"]
