"""FFPA attention core op and the forward routing of a normalized call.

``ffpa_attention_core`` is a ``torch.autograd.Function`` whose forward runs
the forward kernel (``flash_fwd.py``); its backward raises until the
training slice ports the backward kernels. ``apply_attention`` routes decode
shapes (Nq <= 8) to the split-KV decode kernel (GQA) or to the fp32
composite (MHA), and everything else to the core op.

fp16 runs natively on the card: no cast to bf16, no hi+lo split.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..functional import AttentionMeta, CudaBackend
from .config import BlockConfig
from .flash_fwd import _TRAINING_SLICE, flash_attention_forward
from .reference import reference_attention


@dataclass(frozen=True)
class StaticArgs:
    """Static kernel parameters of one core-op call."""

    scale: float
    is_causal: bool
    dropout_p: float
    fwd_config: Optional[BlockConfig]
    # Logit soft-capping cap*tanh(s/cap) (0 = off) and the sliding-window
    # (left, right) band (-1 = unbounded).
    softcap: float = 0.0
    window: tuple = (-1, -1)


def apply_sinks(o, lse, sinks, head_axis: int = 1):
    """Fold per-head sink logits into the softmax normalizer.

    The kernels compute the sink-free softmax (o, lse); the sink-inclusive
    result is a rescale, ``lse' = logaddexp(lse, sink)`` and
    ``o' = o * exp(lse - lse')``, because the sink adds denominator mass but
    no value row."""
    shape = [1] * lse.ndim
    shape[head_axis] = -1
    sink_col = sinks.to(device=lse.device, dtype=torch.float32).reshape(shape)
    lse_s = torch.logaddexp(lse, sink_col)
    o_s = (o.float() * torch.exp(lse - lse_s)[..., None]).to(o.dtype)
    return o_s, lse_s


class _FFPAAttentionCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, static: StaticArgs, q, k, v, bias, alibi, sinks, seed):
        o, lse = flash_attention_forward(
            q, k, v, bias,
            scale=static.scale,
            is_causal=static.is_causal,
            dropout_p=static.dropout_p,
            dropout_seed=seed,
            config=static.fwd_config,
            softcap=static.softcap,
            window=static.window,
            alibi_slopes=alibi,
        )
        if sinks is not None:
            o, _ = apply_sinks(o, lse, sinks)
        return o

    @staticmethod
    def backward(ctx, do):
        raise NotImplementedError(f"the attention backward: {_TRAINING_SLICE}")


def ffpa_attention_core(static: StaticArgs, q, k, v, bias, alibi, sinks, seed):
    return _FFPAAttentionCore.apply(static, q, k, v, bias, alibi, sinks, seed)


def apply_attention(
    meta: AttentionMeta,
    q,
    k,
    v,
    bias,
    dropout_seed=0,
    alibi_slopes=None,
    sinks=None,
):
    """Dispatch a normalized attention call: decode shapes to the split-KV
    kernel (GQA) or the fp32 composite (MHA), the rest to the core op."""
    fwd_be = meta.forward_backend
    softcap = float(getattr(meta, "softcap", 0.0) or 0.0)
    window = tuple(getattr(meta, "window", (-1, -1)))
    alibi = None
    if alibi_slopes is not None:
        alibi = torch.as_tensor(alibi_slopes, dtype=torch.float32, device=q.device)
        if alibi.ndim == 1:
            alibi = alibi[None].expand(q.shape[0], q.shape[1])
    if sinks is not None:
        sinks = torch.as_tensor(sinks, dtype=torch.float32, device=q.device)

    nq = q.shape[2]
    if nq <= 8 and meta.dropout_p == 0.0 and alibi is None:
        # Decode path, Nq 1..8 (speculative decoding included). ALiBi decode
        # takes the dense kernel.
        from .decode import (
            _DECODE_BWD_COMPOSITE_MAX_ELEMS,
            decode_attention,
            decode_attention_supported,
        )

        if decode_attention_supported(q, k):
            if (
                q.shape[1] == k.shape[1]
                and q.numel() * k.shape[2] // q.shape[3]
                <= _DECODE_BWD_COMPOSITE_MAX_ELEMS
            ):
                # MHA decode: with no PackGQA fold the kernel has no
                # bandwidth edge over the composite (both stream K/V once);
                # GQA keeps the kernel, whose fold cuts K/V traffic by the
                # group size.
                return reference_attention(
                    q, k, v, bias,
                    is_causal=meta.is_causal,
                    scale=meta.scale,
                    softcap=softcap,
                    window=window,
                    sinks=sinks,
                )
            return decode_attention(
                q, k, v, bias,
                scale=meta.scale,
                is_causal=meta.is_causal,
                softcap=softcap,
                window=window,
                sinks=sinks,
            )

    fwd_config = None
    if isinstance(fwd_be, CudaBackend) and (
        fwd_be.block_q is not None or fwd_be.block_kv is not None
    ):
        base = BlockConfig()
        fwd_config = BlockConfig(
            block_q=fwd_be.block_q or base.block_q,
            block_kv=fwd_be.block_kv or base.block_kv,
        )
    static = StaticArgs(
        scale=meta.scale,
        is_causal=meta.is_causal,
        dropout_p=meta.dropout_p,
        fwd_config=fwd_config,
        softcap=softcap,
        window=window,
    )
    return ffpa_attention_core(static, q, k, v, bias, alibi, sinks, dropout_seed)


__all__ = ["StaticArgs", "apply_sinks", "ffpa_attention_core", "apply_attention"]
