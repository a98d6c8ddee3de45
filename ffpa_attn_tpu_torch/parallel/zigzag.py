"""Zigzag (load-balanced) causal ring attention.

The causal ring (``ring.py``) skips whole steps: rank s skips the KV blocks
of ranks after it, so the last rank works every step while rank 0 mostly
idles, and the causal saving is lost to the wait. The zigzag layout
balances it: the sequence is cut into ``2S`` chunks and rank s owns the
pair (C_s, C_{2S-1-s}), one early chunk and one late one, so every rank
launches the same kernels, 2S + 1 chunk pairs a layer each (the zigzag
schedule of ring-flash-attention).

At ring step r (the KV pair of rank src = (s - r) mod S):

    Q chunk a = C_s        vs K chunk a' = C_src       : diag r=0 / full src<s
    Q chunk a = C_s        vs K chunk b' = C_{2S-1-src}: never visible
    Q chunk b = C_{2S-1-s} vs K chunk a' = C_src       : always full
    Q chunk b = C_{2S-1-s} vs K chunk b' = C_{2S-1-src}: diag r=0 / full src>s

``zigzag_schedule`` counts each rank's pairs. Inputs and outputs of the
whole-tensor entry are in natural sequence order; ``zigzag_shuffle`` /
``zigzag_unshuffle`` reorder the chunks at its boundary. The backward is
``ring.py``'s rotating-accumulator scheme.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops.flash_bwd import flash_attention_backward
from ..ops.flash_fwd import flash_attention_forward
from ._collectives import gather, shard
from .ring import _groups, _merge, _rotate_start


def _chunk_order(s_count: int) -> np.ndarray:
    """order[2s] = s, order[2s+1] = 2S-1-s: rank s's two chunks."""
    order = np.empty(2 * s_count, np.int32)
    for s in range(s_count):
        order[2 * s] = s
        order[2 * s + 1] = 2 * s_count - 1 - s
    return order


def _reorder(x, s_count: int, axis: int, order: np.ndarray):
    n = x.shape[axis]
    if n % (2 * s_count):
        raise ValueError(f"zigzag: length {n} does not split into {2 * s_count} chunks")
    c = n // (2 * s_count)
    xc = x.reshape(x.shape[:axis] + (2 * s_count, c) + x.shape[axis + 1:])
    idx = torch.as_tensor(order, dtype=torch.long, device=x.device)
    return xc.index_select(axis, idx).reshape(x.shape)


def zigzag_shuffle(x, s_count: int, axis: int = 2):
    """Natural order -> zigzag layout along ``axis``."""
    return _reorder(x, s_count, axis, _chunk_order(s_count))


def zigzag_unshuffle(x, s_count: int, axis: int = 2):
    """Zigzag layout -> natural order along ``axis``."""
    return _reorder(x, s_count, axis, np.argsort(_chunk_order(s_count)))


def zigzag_schedule(s_count: int, rank: int) -> dict:
    """Chunk pairs a rank attends in one layer: {"causal": diagonal pairs,
    "full": fully visible pairs}; 2 and 2S - 1 for every rank."""
    causal, full = 2, 1
    for r in range(1, s_count):
        src = (rank - r) % s_count
        full += 1 + int(src < rank) + int(src > rank)
    return {"causal": causal, "full": full}


def _zigzag_fwd_impl(q, k, v, *, group, scale: float):
    """Per-shard forward. Local layout [B, H, 2c, D] = (C_s, C_{2S-1-s}).
    Returns (o, lse [B, H, 2c] fp32)."""
    n, s_idx = dist.get_world_size(group), dist.get_rank(group)
    c = q.shape[2] // 2
    qa, qb = q[:, :, :c], q[:, :, c:]
    acc = {}

    def attend(name, q_, k_, v_, causal):
        o_s, l_s = flash_attention_forward(q_, k_, v_, None, scale=scale, is_causal=causal)
        if name not in acc:
            shape = o_s.shape
            acc[name] = (torch.zeros(shape, dtype=torch.float32, device=q.device),
                         torch.full(shape[:3], -torch.inf, dtype=torch.float32,
                                    device=q.device))
        acc[name] = _merge(*acc[name], o_s, l_s)

    blk = [k, v]
    for r in range(n):
        nxt = _rotate_start(blk, group) if r + 1 < n else None
        ka, kb = blk[0][:, :, :c], blk[0][:, :, c:]
        va, vb = blk[1][:, :, :c], blk[1][:, :, c:]
        src = (s_idx - r) % n
        if r == 0:
            attend("a", qa, ka, va, True)
            attend("b", qb, ka, va, False)
            attend("b", qb, kb, vb, True)
        else:
            if src < s_idx:
                attend("a", qa, ka, va, False)
            attend("b", qb, ka, va, False)
            if src > s_idx:
                attend("b", qb, kb, vb, False)
        if nxt is not None:
            blk = nxt.wait()
    (oa, la), (ob, lb) = acc["a"], acc["b"]
    return torch.cat([oa, ob], dim=2).to(q.dtype), torch.cat([la, lb], dim=2)


def _zigzag_bwd_impl(q, k, v, o, lse, do, *, group, scale: float):
    """Rotating-accumulator backward (dK / dV ride the ring home)."""
    n, s_idx = dist.get_world_size(group), dist.get_rank(group)
    c = q.shape[2] // 2
    qa, qb = q[:, :, :c], q[:, :, c:]
    oa, ob = o[:, :, :c], o[:, :, c:]
    la, lb = lse[:, :, :c], lse[:, :, c:]
    da, db = do[:, :, :c], do[:, :, c:]
    dqa = torch.zeros(qa.shape, dtype=torch.float32, device=q.device)
    dqb = torch.zeros(qb.shape, dtype=torch.float32, device=q.device)
    acc = [torch.zeros(k.shape, dtype=torch.float32, device=k.device),
           torch.zeros(v.shape, dtype=torch.float32, device=v.device)]

    def bwd(q_, k_, v_, o_, l_, do_, causal):
        dq_, dk_, dv_, _ = flash_attention_backward(
            q_, k_, v_, None, o_, l_, do_, scale=scale, is_causal=causal,
            grad_kv_storage_dtype="f32", grad_q_storage_dtype="f32")
        return dq_, dk_, dv_

    blk, acc_rot = [k, v], None
    for r in range(n):
        nxt = _rotate_start(blk, group) if r + 1 < n else None
        ka, kb = blk[0][:, :, :c], blk[0][:, :, c:]
        va, vb = blk[1][:, :, :c], blk[1][:, :, c:]
        src = (s_idx - r) % n
        parts_a, parts_b = [], []  # (dk, dv) of the a' and b' chunks
        if r == 0 or src < s_idx:
            dq_, dk_, dv_ = bwd(qa, ka, va, oa, la, da, causal=r == 0)
            dqa += dq_
            parts_a.append((dk_, dv_))
        dq_, dk_, dv_ = bwd(qb, ka, va, ob, lb, db, causal=False)
        dqb += dq_
        parts_a.append((dk_, dv_))
        if r == 0 or src > s_idx:
            dq_, dk_, dv_ = bwd(qb, kb, vb, ob, lb, db, causal=r == 0)
            dqb += dq_
            parts_b.append((dk_, dv_))
        if acc_rot is not None:
            acc, acc_rot = acc_rot.wait(), None
        for i in range(2):
            acc[i][:, :, :c] += sum(p[i] for p in parts_a)
            for p in parts_b:
                acc[i][:, :, c:] += p[i]
        if nxt is not None:
            blk = nxt.wait()
            acc_rot = _rotate_start(acc, group, tag=2)
    if n > 1:
        acc = _rotate_start(acc, group, tag=2).wait()
    dq = torch.cat([dqa, dqb], dim=2)
    return dq.to(q.dtype), acc[0].to(k.dtype), acc[1].to(v.dtype)


class _ZigzagAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, scale):
        o, lse = _zigzag_fwd_impl(q, k, v, group=group, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.scale = group, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _zigzag_bwd_impl(q, k, v, o, lse, do.contiguous().to(o.dtype),
                                      group=ctx.group, scale=ctx.scale)
        return dq, dk, dv, None, None


def zigzag_ring_attention(q, k, v, *, group, scale: Optional[float] = None):
    """Per-shard causal entry: each rank of ``group`` passes its chunk
    pair, [B, H, 2c, D] in zigzag layout (``zigzag_shuffle`` of the
    sequence, then the rank's slice of 2c rows)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return _ZigzagAttention.apply(q, k, v, group, float(scale))


def zigzag_ring_attention_sharded(
    q,
    k,
    v,
    mesh,
    *,
    seq_axis: str = "sp",
    head_axis: Optional[str] = None,
    scale: Optional[float] = None,
):
    """Whole-tensor causal zigzag ring attention (natural sequence order).

    Requires N % (2 * the seq_axis size) == 0 and self-attention shapes
    (Nq == Nkv; GQA KV heads travel with their shard). ``head_axis`` adds
    head (TP) sharding on top of the sequence ring, as in
    ``ring_attention_sharded``."""
    seq, heads = _groups(mesh, seq_axis, head_axis)
    s_count = dist.get_world_size(seq)
    q, k, v = (shard(shard(zigzag_shuffle(x, s_count), 1, heads), 2, seq) for x in (q, k, v))
    o = zigzag_ring_attention(q, k, v, group=seq, scale=scale)
    return zigzag_unshuffle(gather(gather(o, 2, seq), 1, heads), s_count)


__all__ = ["zigzag_shuffle", "zigzag_unshuffle", "zigzag_schedule", "zigzag_ring_attention",
           "zigzag_ring_attention_sharded"]
