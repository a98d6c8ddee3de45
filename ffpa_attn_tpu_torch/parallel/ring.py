"""Sequence-sharded ring attention over ``torch.distributed``.

KV blocks rotate around the sequence-parallel group while each rank runs
the forward kernel on its resident Q shard; the partial results merge by
their log-sum-exp (the reference's split-KV stage-2 formula
``O = sum_c exp(LSE_c - LSE) * O_c``, here across ranks).

* **Forward**: a Python loop over the S ring steps. The rotation for step
  s + 1 is issued before step s's kernel, so the transfer runs while the
  kernel does.
* **Causal**: Q and KV are sharded alike, so the block a rank holds at
  step s comes from rank ``(idx - s) % S``: step 0 is the diagonal
  (tail-aligned causal in the kernel), steps ``s <= idx`` are fully
  visible (non-causal kernel), steps ``s > idx`` are masked and launch
  nothing. The rank is fixed per process, so a Python ``if`` takes the
  JAX module's ``lax.cond``.
* **Backward** (a ``torch.autograd.Function``): the rotating-accumulator
  scheme. K and V rotate again; each rank adds its dK / dV for the block it
  holds to accumulators that ride the same ring, one extra rotation at the
  end bringing each home; dQ accumulates locally. Gradients are stored in
  fp32 by the backward kernels (``grad_kv_storage_dtype="f32"``) and summed
  in fp32.

Dropout is not offered across the ring: it would need element ids global
over the shards.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..ops.flash_bwd import flash_attention_backward
from ..ops.flash_fwd import flash_attention_forward
from ._collectives import gather, point_to_point_staged, shard
from .mesh import axis_group


def _merge(o_a, lse_a, o_b, lse_b):
    """LSE-merge two normalized partial attention results, in fp32."""
    lse_max = torch.maximum(lse_a, lse_b)
    # exp(-inf - -inf) guard: where both are -inf the weights are 0.
    ref = torch.where(torch.isinf(lse_max), torch.zeros_like(lse_max), lse_max)
    w_a = torch.exp(lse_a - ref)
    w_b = torch.exp(lse_b - ref)
    denom = w_a + w_b
    denom_safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    o = (o_a.float() * (w_a / denom_safe)[..., None]
         + o_b.float() * (w_b / denom_safe)[..., None])
    return o, lse_max + torch.log(denom_safe)


class _Rotation:
    """A rotation in flight; ``wait()`` returns the received tensors."""

    def __init__(self, reqs, recvs, devices):
        self.reqs, self.recvs, self.devices = reqs, recvs, devices

    def wait(self) -> list:
        for r in self.reqs:
            r.wait()
        return [r.to(d, non_blocking=True) for r, d in zip(self.recvs, self.devices)]


def _rotate_start(xs: Sequence[torch.Tensor], group, shift: int = 1, tag: int = 0) -> _Rotation:
    """Send each of ``xs`` to the rank ``shift`` places on and receive its
    counterpart from the rank ``shift`` places back, all in one
    ``batch_isend_irecv`` (tags ``tag``, ``tag + 1``, ...), so the sends and
    receives pair up without deadlock. A CUDA tensor over gloo goes through
    pinned host memory (``point_to_point_staged``)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + shift) % n)
    src = dist.get_global_rank(group, (r - shift) % n)
    ops, recvs, devices = [], [], []
    for i, x in enumerate(xs):
        x = x.contiguous()
        if point_to_point_staged(group, x):
            send = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            send.copy_(x)
            recv = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        else:
            send, recv = x, torch.empty_like(x)
        ops += [dist.P2POp(dist.isend, send, dst, group, tag + i),
                dist.P2POp(dist.irecv, recv, src, group, tag + i)]
        recvs.append(recv)
        devices.append(x.device)
    return _Rotation(dist.batch_isend_irecv(ops), recvs, devices)


def _rotate(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """``x`` of the rank ``shift`` places back in ``group`` (rank r sends to
    r + shift)."""
    if dist.get_world_size(group) == 1:
        return x
    return _rotate_start([x], group, shift).wait()[0]


def _ring_fwd_impl(q, k, v, *, group, scale: float, causal: bool):
    """Per-shard ring forward: (o [B, Hq, Nl, Dv] in q.dtype, lse fp32)."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    b, hq, nl, _ = q.shape
    o_acc = torch.zeros((b, hq, nl, v.shape[-1]), dtype=torch.float32, device=q.device)
    lse_acc = torch.full((b, hq, nl), -torch.inf, dtype=torch.float32, device=q.device)
    blk = [k, v]
    for s in range(n):
        nxt = _rotate_start(blk, group) if s + 1 < n else None
        if not causal or s <= idx:
            o_s, lse_s = flash_attention_forward(q, blk[0], blk[1], None, scale=scale,
                                                 is_causal=causal and s == 0)
            o_acc, lse_acc = _merge(o_acc, lse_acc, o_s, lse_s)
        if nxt is not None:
            blk = nxt.wait()
    return o_acc.to(q.dtype), lse_acc


def _ring_bwd_impl(q, k, v, o, lse, do, *, group, scale: float, causal: bool):
    """Rotating-accumulator ring backward: (dq, dk, dv), dk / dv delivered
    to the home shard of each KV block."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    acc = [torch.zeros(k.shape, dtype=torch.float32, device=k.device),
           torch.zeros(v.shape, dtype=torch.float32, device=v.device)]
    blk, acc_rot = [k, v], None
    for s in range(n):
        # K / V for the next step go out before this step's kernels; the
        # accumulators' rotation (it must carry this step's sums) is waited
        # for only where they are next added to.
        nxt = _rotate_start(blk, group) if s + 1 < n else None
        grads = None
        if not causal or s <= idx:
            dq_s, dk_s, dv_s, _ = flash_attention_backward(
                q, blk[0], blk[1], None, o, lse, do, scale=scale, is_causal=causal and s == 0,
                grad_kv_storage_dtype="f32", grad_q_storage_dtype="f32")
            grads = (dk_s, dv_s)
            dq_acc += dq_s
        if acc_rot is not None:
            acc, acc_rot = acc_rot.wait(), None
        if grads is not None:
            acc[0] += grads[0]
            acc[1] += grads[1]
        if nxt is not None:
            blk = nxt.wait()
            acc_rot = _rotate_start(acc, group, tag=2)
    # One rotation short of a full cycle: the last one brings each home.
    if n > 1:
        acc = _rotate_start(acc, group, tag=2).wait()
    return dq_acc.to(q.dtype), acc[0].to(k.dtype), acc[1].to(v.dtype)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, scale, causal):
        o, lse = _ring_fwd_impl(q, k, v, group=group, scale=scale, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.scale, ctx.causal = group, scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd_impl(q, k, v, o, lse, do.contiguous().to(o.dtype),
                                    group=ctx.group, scale=ctx.scale, causal=ctx.causal)
        return dq, dk, dv, None, None, None


def ring_attention(q, k, v, *, group, scale: Optional[float] = None, causal: bool = False):
    """Per-shard entry: every rank of ``group`` calls it with its shard.

    Shapes per shard: q [B, Hq, Nq/S, D], k / v [B, Hkv, Nkv/S, D]
    (GQA from Hq vs Hkv), S the group's size; shard i holds the i-th
    block of the sequence. Returns the rank's [B, Hq, Nq/S, Dv]."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return _RingAttention.apply(q, k, v, group, float(scale), causal)


def _groups(mesh, seq_axis: str, head_axis: Optional[str]):
    return mesh.get_group(seq_axis), axis_group(mesh, head_axis)


def ring_attention_sharded(
    q,
    k,
    v,
    mesh,
    *,
    seq_axis: str = "sp",
    head_axis: Optional[str] = None,
    scale: Optional[float] = None,
    causal: bool = False,
):
    """Whole-tensor entry: every rank holds the global q, k, v; each keeps
    its shard of the sequence on ``seq_axis`` (and of the heads on
    ``head_axis``), runs ``ring_attention`` and gets the global output back,
    differentiable (each rank's gradients are the global ones)."""
    seq, heads = _groups(mesh, seq_axis, head_axis)
    q, k, v = (shard(shard(x, 1, heads), 2, seq) for x in (q, k, v))
    o = ring_attention(q, k, v, group=seq, scale=scale, causal=causal)
    return gather(gather(o, 2, seq), 1, heads)


__all__ = ["ring_attention", "ring_attention_sharded"]
