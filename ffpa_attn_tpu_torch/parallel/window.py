"""Sequence-sharded sliding-window attention by halo exchange.

Windowed attention under sequence sharding needs no ring: a query row at
global position p attends only ``[p - W, p]`` (causal window), so a rank
owning rows ``[i*Nl, (i+1)*Nl)`` needs at most ``H = ceil(W / Nl)``
left-neighbour shards of K / V. One rotation per halo step fetches them,
O(H * Nl) bytes per rank against the ring's O(S * Nl), and every query's
window is then local: no cross-rank LSE merge, so softcap, ALiBi and sinks
compose exactly.

Positions are kept in the extended layout: local Q row r is global
``r + i*Nl``, extended KV column c is global ``c + (i - H)*Nl``, so with the
kernels' tail-aligned offset ``nkv_ext - nq = H*Nl`` the causal band, the
window band and the ALiBi distance equal their unsharded values. Ranks
``i < H`` receive wrapped-around blocks from the sequence end; a key-only
validity bias ``[1, 1, 1, (H+1)*Nl]`` masks the columns whose global
position is negative, as the unsharded window clips at position 0.

Gradients: the shift is an autograd function whose backward sends each
halo block's dK / dV back to its owner (the transpose of the JAX module's
``ppermute``, which ``jax.grad`` derives there), and the attention is
``ffpa_attn_func``'s own autograd.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..interface import ffpa_attn_func
from ..ops.reference import DEFAULT_MASK_VALUE
from ._collectives import copy_to, gather, shard
from .ring import _groups, _rotate


class _ShiftLeftBlock(torch.autograd.Function):
    """Each rank receives its left neighbour's block (rank i gets i - 1);
    the gradient goes back the other way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _rotate(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _rotate(g.contiguous(), ctx.group, -1), None


def _shift_left_block(x, group):
    return _ShiftLeftBlock.apply(x, group)


def halo_bias(nl: int, halo: int, idx: int, device=None) -> torch.Tensor:
    """The key-only validity bias of rank ``idx``: extended column c is
    global ``(idx - halo)*nl + c``; a negative position gets the mask
    value. [1, 1, 1, (halo+1)*nl] fp32."""
    cols = torch.arange((halo + 1) * nl, dtype=torch.int32, device=device)
    valid = cols >= (halo - idx) * nl
    bias = torch.where(valid, 0.0, DEFAULT_MASK_VALUE).to(torch.float32)
    return bias[None, None, None, :]


def window_attention(
    q,
    k,
    v,
    *,
    group,
    window_left: int,
    scale: Optional[float] = None,
    softcap: float = 0.0,
    alibi_slopes=None,
    sinks=None,
):
    """Per-shard causal sliding-window attention: every rank of ``group``
    calls it with its shard.

    Shapes per shard: q [B, Hq, Nl, D], k / v [B, Hkv, Nl, D], Q and KV
    sharded alike on the sequence. ``window_left`` is the causal left
    window W (global semantics: row p attends [p - W, p]). The gradient of
    ``sinks`` is this rank's rows' part; a caller holding them replicated
    sums it over the group."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    axis_size, idx = dist.get_world_size(group), dist.get_rank(group)
    nl = q.shape[2]
    halo = max(0, -(-int(window_left) // nl))  # ceil(W / Nl)
    if halo >= axis_size:
        raise ValueError(
            f"window_left={window_left} needs {halo} halo shards but the "
            f"axis has only {axis_size}; at W >= N the window is dense — "
            "use ring/zigzag attention instead"
        )
    ks, vs = [k], [v]
    for _ in range(halo):
        # After s shifts the resident block came from rank i - s: prepend
        # so the concatenation is in global order [i-H, .., i-1, i].
        ks.insert(0, _shift_left_block(ks[0], group))
        vs.insert(0, _shift_left_block(vs[0], group))
    k_ext, v_ext = torch.cat(ks, dim=2), torch.cat(vs, dim=2)
    return ffpa_attn_func(
        q, k_ext, v_ext,
        attn_mask=halo_bias(nl, halo, idx, device=q.device),
        is_causal=True,
        scale=scale,
        enable_gqa=q.shape[1] != k.shape[1],
        window_size=(int(window_left), -1),
        softcap=softcap,
        alibi_slopes=alibi_slopes,
        sinks=sinks,
    )


def window_attention_sharded(
    q,
    k,
    v,
    mesh,
    *,
    seq_axis: str = "sp",
    head_axis: Optional[str] = None,
    window_left: int,
    scale: Optional[float] = None,
    softcap: float = 0.0,
    alibi_slopes=None,
    sinks=None,
):
    """Whole-tensor entry: causal sliding-window attention with q, k, v
    sharded on ``seq_axis`` (and the heads on ``head_axis``) by halo
    exchange. Composes with softcap / ALiBi / sinks (replicated [Hq]
    operands, cut to the rank's heads). Differentiable; each rank's
    gradients are the global ones."""
    seq, heads = _groups(mesh, seq_axis, head_axis)
    q, k, v = (shard(shard(x, 1, heads), 2, seq) for x in (q, k, v))
    if alibi_slopes is not None:
        alibi_slopes = shard(torch.as_tensor(alibi_slopes, dtype=torch.float32,
                                             device=q.device), 0, heads)
    if sinks is not None:
        sinks = copy_to(shard(torch.as_tensor(sinks, dtype=torch.float32, device=q.device),
                              0, heads), seq)
    o = window_attention(q, k, v, group=seq, window_left=window_left, scale=scale,
                         softcap=softcap, alibi_slopes=alibi_slopes, sinks=sinks)
    return gather(gather(o, 2, seq), 1, heads)


__all__ = ["halo_bias", "window_attention", "window_attention_sharded"]
