"""FFPA attention core op and the routing of a normalized call.

``ffpa_attention_core`` is a ``torch.autograd.Function`` (the JAX package's
``jax.custom_vjp``): its forward runs the forward kernel
(``flash_fwd.py``) and saves (q, k, v, bias, alibi, sinks, o, lse); its
backward routes by backend, ``_core_bwd`` of the JAX package:

* ``CudaBackend``: ``flash_attention_backward`` (``flash_bwd.py``), the
  dS-handoff or recompute tier, sinks by their closed form;
* ``SDPABackend``: autograd through the fp32 oracle ``reference_attention``.

``apply_attention`` routes decode shapes (Nq <= 8) to the split-KV decode
kernel (GQA) or to the fp32 composite (MHA), and everything else to the
core op.

fp16 runs natively on the card: no cast to bf16, no hi+lo split, and the
gradients come back in the inputs' dtype.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..functional import AttentionMeta, CudaBackend, SDPABackend
from ..logger import init_logger
from .config import BlockConfig
from .flash_bwd import flash_attention_backward
from .flash_fwd import _S_RESIDENT_SLICE, flash_attention_forward
from .reference import expand_kv_heads, reference_attention

logger = init_logger(__name__)


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
    bwd_config: Optional[BlockConfig] = None
    backward_is_sdpa: bool = False
    grad_kv_storage_dtype: Optional[str] = None
    grad_q_storage_dtype: Optional[str] = None
    ds_handoff: Optional[bool] = None
    save_scores: Optional[bool] = None
    has_alibi: bool = False


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


def sink_grad(do, o, lse, sinks, head_axis: int = 1):
    """Closed-form sink gradient from the sink-inclusive residuals:
    ``dsink_h = -sum exp(sink_h - lse') * rowsum(dO * O)`` over every
    non-head axis."""
    delta = (do.float() * o.float()).sum(dim=-1)
    shape = [1] * lse.ndim
    shape[head_axis] = -1
    p_sink = torch.exp(sinks.float().reshape(shape) - lse)
    axes = tuple(ax for ax in range(lse.ndim) if ax != head_axis)
    return (-(p_sink * delta).sum(dim=axes)).to(sinks.dtype)


def _window_active(static: StaticArgs) -> bool:
    wl, wr = static.window
    return wl >= 0 or (not static.is_causal and wr >= 0)


def _wants_scores(static: StaticArgs, q, bias) -> bool:
    """Whether an explicit ``save_scores=True`` asks for the S-resident
    backward, as the JAX package's residency policy reads it: not for the
    SDPA tier, a window, softcap with an additive term, or fp16 inputs
    (whose 1e-2 gradient contract the bf16 S residual would erode; those
    take the dS handoff)."""
    if not static.save_scores or static.backward_is_sdpa or _window_active(static):
        return False
    if static.softcap > 0.0 and (bias is not None or static.has_alibi):
        return False
    if q.dtype == torch.float16:
        logger.warning_once(
            "save_scores=True ignored for float16 inputs: the bf16 S residual "
            "would erode the fp16 1e-2 gradient contract; using the dS-handoff "
            "backward instead."
        )
        return False
    return True


class _FFPAAttentionCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, static: StaticArgs, q, k, v, bias, alibi, sinks, seed):
        if (any(ctx.needs_input_grad[1:4]) and q.device.type != "cpu"
                and _wants_scores(static, q, bias)):
            raise NotImplementedError(f"save_scores=True: {_S_RESIDENT_SLICE}")
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
            # The residuals are sink-inclusive: every backward tier is exact
            # under them (apply_sinks).
            o, lse = apply_sinks(o, lse, sinks)
        ctx.static, ctx.seed = static, seed
        ctx.save_for_backward(q, k, v, bias, alibi, sinks, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        static = ctx.static
        q, k, v, bias, alibi, sinks, o, lse = ctx.saved_tensors
        need_bias = bias is not None and ctx.needs_input_grad[4]
        dsinks = None
        if static.backward_is_sdpa:
            dq, dk, dv, dbias, dsinks = _sdpa_backward(static, ctx.seed, q, k, v, bias, alibi,
                                                       sinks, do, need_bias)
        else:
            dq, dk, dv, dbias = flash_attention_backward(
                q, k, v, bias, o, lse, do.to(o.dtype),
                scale=static.scale,
                is_causal=static.is_causal,
                dropout_p=static.dropout_p,
                dropout_seed=ctx.seed,
                config=static.bwd_config,
                grad_kv_storage_dtype=static.grad_kv_storage_dtype,
                grad_q_storage_dtype=static.grad_q_storage_dtype,
                ds_handoff=static.ds_handoff,
                softcap=static.softcap,
                window=static.window,
                alibi_slopes=alibi,
                bias_grad=need_bias,
            )
            if sinks is not None:
                dsinks = sink_grad(do, o, lse, sinks)
        # ALiBi slopes are positional hyperparameters, not weights: zero grad.
        dalibi = None if alibi is None or not ctx.needs_input_grad[5] else torch.zeros_like(alibi)
        return None, dq, dk, dv, dbias, dalibi, dsinks, None


def _sdpa_backward(static: StaticArgs, seed, q, k, v, bias, alibi, sinks, do, need_bias):
    """The SDPA tier: autograd through the fp32 oracle; dK / dV come back
    group-reduced through ``expand_kv_heads``."""
    hq = q.shape[1]
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    bias_l = bias.detach().requires_grad_() if need_bias else bias
    sinks_l = None if sinks is None else sinks.detach().requires_grad_()
    with torch.enable_grad():
        out = reference_attention(
            leaves[0], expand_kv_heads(leaves[1], hq), expand_kv_heads(leaves[2], hq), bias_l,
            is_causal=static.is_causal, scale=static.scale, dropout_p=static.dropout_p,
            dropout_seed=seed, softcap=static.softcap, window=static.window,
            alibi_slopes=alibi, sinks=sinks_l,
        )
        wrt = leaves + ([bias_l] if need_bias else []) + ([sinks_l] if sinks is not None else [])
        grads = list(torch.autograd.grad(out, wrt, do.to(out.dtype)))
    dq, dk, dv = grads[:3]
    dbias = grads[3] if need_bias else None
    dsinks = grads[-1] if sinks is not None else None
    return dq, dk.to(k.dtype), dv.to(v.dtype), dbias, dsinks


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
    bwd_be = meta.backward_backend
    bwd = {}
    if isinstance(bwd_be, CudaBackend):
        bwd = dict(
            grad_kv_storage_dtype=bwd_be.grad_kv_storage_dtype,
            grad_q_storage_dtype=bwd_be.grad_q_storage_dtype,
            ds_handoff=bwd_be.ds_handoff,
            save_scores=bwd_be.save_scores,
        )
        if bwd_be.block_q_dq is not None:
            from .dispatch import pick_backward_config

            picked = pick_backward_config(d=q.shape[-1], dv=v.shape[-1], nq=nq,
                                          nkv=k.shape[2], dtype=q.dtype)
            bwd["bwd_config"] = BlockConfig(block_q_dq=bwd_be.block_q_dq,
                                            dkdv_col_passes=picked.dkdv_col_passes)
    static = StaticArgs(
        scale=meta.scale,
        is_causal=meta.is_causal,
        dropout_p=meta.dropout_p,
        fwd_config=fwd_config,
        softcap=softcap,
        window=window,
        backward_is_sdpa=isinstance(bwd_be, SDPABackend),
        has_alibi=alibi is not None,
        **bwd,
    )
    return ffpa_attention_core(static, q, k, v, bias, alibi, sinks, dropout_seed)


__all__ = ["StaticArgs", "apply_sinks", "sink_grad", "ffpa_attention_core", "apply_attention"]
