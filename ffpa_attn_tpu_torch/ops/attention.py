"""FFPA attention core op and the routing of a normalized call.

``ffpa_attention_core`` is a ``torch.autograd.Function`` (the JAX package's
``jax.custom_vjp``): its forward runs the forward kernel
(``flash_fwd.py``), with the S residual for the first m query heads that the
residency policy ``_resident_head_count`` picks, and saves (q, k, v, bias,
alibi, sinks, o, lse, scores); its backward routes by backend, ``_core_bwd``
of the JAX package:

* ``CudaBackend``: ``flash_attention_backward`` (``flash_bwd.py``), the
  S-resident tier for the resident heads and the dS-handoff or recompute
  tier for the rest, sinks by their closed form;
* ``SDPABackend``: autograd through the fp32 oracle ``reference_attention``.

``apply_attention`` routes decode shapes (Nq <= 8) to the split-KV decode
kernel, MHA and GQA alike, and everything else to the core op; with
``CudaBackend(autotune=True)`` it first searches the kernels' run-time
knobs for the call's variant (``_online_autotune``).

fp16 runs natively on the card: no cast to bf16, no hi+lo split, and the
gradients come back in the inputs' dtype.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch

from ..env import ENV
from ..functional import AttentionMeta, CudaBackend, SDPABackend
from ..logger import init_logger
from .config import BlockConfig
from .dispatch import head_layout
from .flash_bwd import flash_attention_backward
from .flash_fwd import flash_attention_forward, scores_padding
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


def _resident_head_count(static: StaticArgs, q, k, v, bias) -> int:
    """S-residency policy, head-granular, as the JAX package's: m in {0,
    group, .., Hq}. The forward emits the bf16 S residual for the first m
    query heads (whole GQA groups), whose backward takes the S-resident
    tier; the other heads take the dS-handoff / recompute backward.

    Never with the SDPA tier, a sliding window (out-of-band S tiles are
    never written) or softcap with a bias or ALiBi (the tanh factor is read
    back from S). An explicit ``save_scores`` decides (fp16 refuses it with
    a warning: the bf16 S would erode the 1e-2 gradient contract); auto
    (None) takes bf16 inputs only and fits the exact padded residual into
    min(``scores_residual_limit_bytes``, headroom / assumed layers), where
    the headroom is the card's memory less this call's tensors and the
    model margin. A partial pick keeps room for the other heads' handoff
    slabs and needs ``dropout_p == 0`` (the second launch would see
    shifted head ids in the dropout hash)."""
    hq = q.shape[1]
    group = hq // k.shape[1]
    if static.backward_is_sdpa or _window_active(static):
        return 0
    if static.softcap > 0.0 and (bias is not None or static.has_alibi):
        return 0
    if static.save_scores is not None:
        if static.save_scores and q.dtype == torch.float16:
            logger.warning_once(
                "save_scores=True ignored for float16 inputs: the bf16 S residual "
                "would erode the fp16 1e-2 gradient contract; using the dS-handoff "
                "backward instead."
            )
            return 0
        return hq if static.save_scores else 0
    if q.dtype != torch.bfloat16:
        return 0
    limit = ENV.scores_residual_limit_bytes()
    if limit <= 0:
        return 0
    b, _, nq, d = q.shape
    nq_pad, nkv_pad = scores_padding(nq, k.shape[2], d, v.shape[-1], q.dtype, static.fwd_config,
                                     causal=static.is_causal, has_bias=bias is not None,
                                     dropout=static.dropout_p > 0.0, **head_layout(hq, k.shape[1]))
    per_head_bytes = b * nq_pad * nkv_pad * 2
    layers = max(1, ENV.scores_auto_assumed_layers())
    residents = 2 * (5 * q.numel() + 4 * k.numel())
    headroom = ENV.hbm_bytes() - residents - ENV.hbm_model_margin_bytes()
    budget = min(limit, max(headroom, 0) // layers)
    m = min(hq, budget // per_head_bytes)
    if m < hq:
        reserve = min(ENV.ds_handoff_limit_bytes(), 3 * 1024**3 // 2, budget // 4)
        m = min(hq, max(0, budget - reserve) // per_head_bytes)
    m = (m // group) * group
    if m < hq and static.dropout_p > 0.0:
        return 0
    return int(m)


def _should_save_scores(static: StaticArgs, q, k, v, bias) -> bool:
    """True iff full S-residency applies."""
    return _resident_head_count(static, q, k, v, bias) == q.shape[1]


def _slice_bias_heads(bias, lo, hi):
    if bias is None or bias.shape[1] == 1:
        return bias
    return bias[:, lo:hi]


def _slice_alibi_heads(alibi, lo, hi):
    return None if alibi is None else alibi[..., lo:hi]


class _FFPAAttentionCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, static: StaticArgs, q, k, v, bias, alibi, sinks, seed):
        hq = q.shape[1]
        group = hq // k.shape[1]
        m = _resident_head_count(static, q, k, v, bias) if any(ctx.needs_input_grad) else 0
        fwd = functools.partial(
            flash_attention_forward,
            scale=static.scale,
            is_causal=static.is_causal,
            dropout_p=static.dropout_p,
            dropout_seed=seed,
            config=static.fwd_config,
            softcap=static.softcap,
            window=static.window,
        )
        scores = None
        if 0 < m < hq:
            # Partial residency: heads [0, m) emit S, the rest do not; two
            # launches over disjoint head ranges.
            mk = m // group
            o1, lse1, scores = fwd(q[:, :m], k[:, :mk], v[:, :mk], _slice_bias_heads(bias, 0, m),
                                   return_scores=True, alibi_slopes=_slice_alibi_heads(alibi, 0, m))
            o2, lse2 = fwd(q[:, m:], k[:, mk:], v[:, mk:], _slice_bias_heads(bias, m, hq),
                           alibi_slopes=_slice_alibi_heads(alibi, m, hq))
            o, lse = torch.cat([o1, o2], dim=1), torch.cat([lse1, lse2], dim=1)
        elif m == hq:
            o, lse, scores = fwd(q, k, v, bias, return_scores=True, alibi_slopes=alibi)
        else:
            o, lse = fwd(q, k, v, bias, alibi_slopes=alibi)
        if sinks is not None:
            # The residuals are sink-inclusive: every backward tier is exact
            # under them (apply_sinks).
            o, lse = apply_sinks(o, lse, sinks)
        ctx.static, ctx.seed = static, seed
        ctx.save_for_backward(q, k, v, bias, alibi, sinks, o, lse, scores)
        return o

    @staticmethod
    def backward(ctx, do):
        static = ctx.static
        q, k, v, bias, alibi, sinks, o, lse, scores = ctx.saved_tensors
        need_bias = bias is not None and ctx.needs_input_grad[4]
        dsinks = None
        if static.backward_is_sdpa:
            dq, dk, dv, dbias, dsinks = _sdpa_backward(static, ctx.seed, q, k, v, bias, alibi,
                                                       sinks, do, need_bias)
        else:
            if scores is not None:
                if getattr(ctx, "scores_consumed", False):
                    raise RuntimeError(
                        "the S-resident backward overwrites its S residual with dS, so it "
                        "runs once; pass save_scores=False to backward through this call "
                        "again")
                ctx.scores_consumed = True
            dq, dk, dv, dbias = _flash_backward(static, ctx.seed, q, k, v, bias, alibi, o, lse,
                                                do.to(o.dtype), need_bias, scores)
            if sinks is not None:
                dsinks = sink_grad(do, o, lse, sinks)
        # ALiBi slopes are positional hyperparameters, not weights: zero grad.
        dalibi = None if alibi is None or not ctx.needs_input_grad[5] else torch.zeros_like(alibi)
        return None, dq, dk, dv, dbias, dalibi, dsinks, None


def _flash_backward(static: StaticArgs, seed, q, k, v, bias, alibi, o, lse, do, need_bias,
                    scores):
    """The kernel tiers: S-resident for heads [0, m) when the forward kept
    their S residual (m = its head count), dS handoff / recompute for the
    rest, whose handoff gate sees the live residual as extra residency."""
    bwd = functools.partial(
        flash_attention_backward,
        scale=static.scale,
        is_causal=static.is_causal,
        dropout_p=static.dropout_p,
        dropout_seed=seed,
        config=static.bwd_config,
        grad_kv_storage_dtype=static.grad_kv_storage_dtype,
        grad_q_storage_dtype=static.grad_q_storage_dtype,
        ds_handoff=static.ds_handoff,
        softcap=static.softcap,
        window=static.window,
        bias_grad=need_bias,
    )
    hq = q.shape[1]
    if scores is None or scores.shape[1] == hq:
        return bwd(q, k, v, bias, o, lse, do, scores=scores, alibi_slopes=alibi)
    m = scores.shape[1]
    mk = m * k.shape[1] // hq
    dq1, dk1, dv1, db1 = bwd(q[:, :m], k[:, :mk], v[:, :mk], _slice_bias_heads(bias, 0, m),
                             o[:, :m], lse[:, :m], do[:, :m], scores=scores,
                             alibi_slopes=_slice_alibi_heads(alibi, 0, m))
    dq2, dk2, dv2, db2 = bwd(q[:, m:], k[:, mk:], v[:, mk:], _slice_bias_heads(bias, m, hq),
                             o[:, m:], lse[:, m:], do[:, m:],
                             alibi_slopes=_slice_alibi_heads(alibi, m, hq),
                             extra_resident_bytes=scores.numel() * scores.element_size())
    dbias = None
    if need_bias:
        dbias = ((db1.float() + db2.float()).to(bias.dtype) if bias.shape[1] == 1
                 else torch.cat([db1, db2], dim=1))
    return (torch.cat([dq1, dq2], dim=1), torch.cat([dk1, dk2], dim=1),
            torch.cat([dv1, dv2], dim=1), dbias)


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


_AUTOTUNE_CACHE: dict = {}


def _online_autotune(direction, q, k, v, bias, meta, mode) -> Optional[BlockConfig]:
    """Per-call timed search (the JAX package's ``_online_autotune``): runs
    ``autotune_forward`` or ``autotune_backward`` on the call's tensors and
    memoises the winner by the JAX package's variant key (direction,
    shapes, dtype, bias shape, causal, dropout, mode). Under CUDA-graph
    capture or ``torch.compile`` (the JAX package's jit tracing) nothing
    can be timed: one warning, and None (the tuned store's config or the
    default)."""
    capturing = q.device.type == "cuda" and torch.cuda.is_current_stream_capturing()
    if capturing or torch.compiler.is_compiling():
        logger.warning_once(
            "autotune=True under CUDA-graph capture or torch.compile: cannot time "
            "candidates; using persistent-store/heuristic config. Run the call once "
            "eagerly (or `python -m ffpa_attn_tpu_torch.autotune`) to tune."
        )
        return None
    key = (
        direction, tuple(q.shape), tuple(k.shape), tuple(v.shape), str(q.dtype),
        None if bias is None else tuple(bias.shape),
        meta.is_causal, meta.dropout_p > 0.0, mode,
    )
    if key in _AUTOTUNE_CACHE:
        return _AUTOTUNE_CACHE[key]
    from ..autotune.search import autotune_backward, autotune_forward

    tune = autotune_forward if direction == "fwd" else autotune_backward
    with torch.no_grad():
        cfg = tune(q.detach(), k.detach(), v.detach(), None if bias is None else bias.detach(),
                   scale=meta.scale, is_causal=meta.is_causal, dropout_p=meta.dropout_p,
                   mode=mode).config
    _AUTOTUNE_CACHE[key] = cfg
    return cfg


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
    kernel, the rest to the core op."""
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
        from .decode import decode_attention, decode_attention_supported

        if decode_attention_supported(q, k):
            # MHA too: the JAX package sends MHA decode to its XLA composite,
            # which XLA fuses and, under jax.grad, shares residuals with;
            # here that composite is the unfused fp32 oracle.
            return decode_attention(
                q, k, v, bias,
                scale=meta.scale,
                is_causal=meta.is_causal,
                softcap=softcap,
                window=window,
                sinks=sinks,
            )

    fwd_config = None
    if isinstance(fwd_be, CudaBackend):
        if fwd_be.block_q is not None or fwd_be.block_kv is not None:
            base = BlockConfig()
            fwd_config = BlockConfig(
                block_q=fwd_be.block_q or base.block_q,
                block_kv=fwd_be.block_kv or base.block_kv,
            )
        elif fwd_be.autotune:
            fwd_config = _online_autotune("fwd", q, k, v, bias, meta, fwd_be.autotune_mode)
    bwd_be = meta.backward_backend
    bwd = {}
    if isinstance(bwd_be, CudaBackend):
        bwd = dict(
            grad_kv_storage_dtype=bwd_be.grad_kv_storage_dtype,
            grad_q_storage_dtype=bwd_be.grad_q_storage_dtype,
            ds_handoff=bwd_be.ds_handoff,
            save_scores=bwd_be.save_scores,
        )
        if bwd_be.block_kv_dkdv is not None or bwd_be.block_q_dq is not None:
            bwd["bwd_config"] = BlockConfig(block_q_dq=bwd_be.block_q_dq or BlockConfig.block_q_dq)
        elif bwd_be.autotune and torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            # The port knows whether a backward can follow; the JAX package
            # searches the backward at every call.
            cfg = _online_autotune("bwd", q, k, v, bias, meta, bwd_be.autotune_mode)
            if cfg is not None:
                bwd["bwd_config"] = cfg
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
