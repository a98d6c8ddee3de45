"""Public API of the PyTorch/CUDA port.

``ffpa_attn_func`` has the ``torch.nn.functional.scaled_dot_product_attention``
signature, the JAX package's error taxonomy and fallback policy, and the same
extension kwargs. Fallback shapes run the port's own fp32 reference, never a
library attention call.

``patch_dot_product_attention`` routes
``torch.nn.functional.scaled_dot_product_attention`` through
``ffpa_attn_func``; what FFPA does not compute as the stock function does
goes to the stock function.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .functional import FFPAAttnMeta
from .logger import init_logger
from .ops.attention import apply_attention

logger = init_logger(__name__)


def _sdpa_fallback(
    query, key, value, attn_mask, dropout_p, is_causal, scale, enable_gqa,
    dropout_seed=0, softcap=0.0, window_size=(-1, -1), alibi_slopes=None,
    sinks=None,
):
    """Fallback shapes: the fp32 reference composite."""
    from .functional import normalize_attn_mask
    from .ops.reference import expand_kv_heads, reference_attention

    b, hq, nq, _ = query.shape
    nkv = key.shape[2]
    bias = None
    if attn_mask is not None:
        bias = normalize_attn_mask(attn_mask, b, hq, nq, nkv)
    k = expand_kv_heads(key, hq) if enable_gqa else key
    v = expand_kv_heads(value, hq) if enable_gqa else value
    if k.shape[1] != hq:
        raise ValueError(
            f"num_heads mismatch (q={hq}, kv={k.shape[1]}) requires "
            "enable_gqa=True"
        )
    return reference_attention(
        query, k, v, bias,
        is_causal=is_causal,
        scale=scale,
        dropout_p=dropout_p,
        dropout_seed=dropout_seed,
        softcap=softcap or 0.0,
        window=tuple(window_size),
        alibi_slopes=alibi_slopes,
        sinks=sinks,
    )


def ffpa_attn_func(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    attn_mask: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
    is_causal: bool = False,
    scale: Optional[float] = None,
    enable_gqa: bool = False,
    **kwargs,
) -> torch.Tensor:
    """FFPA: exact attention for large head dims (D > 256).

    Args:
      query: ``[B, Nh_q, Nq, D]`` fp16/bf16.
      key: ``[B, Nh_kv, Nkv, D]``; ``Nh_q % Nh_kv == 0`` under GQA.
      value: ``[B, Nh_kv, Nkv, Dv]``.
      attn_mask: bool (True participates) or additive float mask
        broadcastable to ``[B, Nh_q, Nq, Nkv]``.
      dropout_p: attention dropout in [0, 1) with the deterministic hash
        (``dropout_seed=<int>`` in kwargs), replayed by the backward.
      is_causal: tail-aligned causal (row m attends cols <= m + Nkv - Nq).
      scale: defaults to 1/sqrt(D).
      enable_gqa: opt into GQA/MQA semantics.
      **kwargs: ``backend`` / ``forward_backend`` / ``backward_backend``
        (str or Backend), ``dropout_seed``, ``softcap``, ``window_size``
        ((left, right), -1 = unbounded, an int means symmetric),
        ``alibi_slopes`` ([Hq] or [B, Hq]) and ``sinks`` ([Hq]). Anything
        else raises TypeError.

    Returns:
      ``[B, Nh_q, Nq, Dv]`` attention output in the input dtype, on the
      inputs' device (the kernels for CUDA tensors, their plain versions for
      CPU tensors), differentiable under ``torch.autograd`` on every route,
      the decode route (Nq <= 8) included.
    """
    dropout_seed = kwargs.pop("dropout_seed", 0)
    softcap = kwargs.pop("softcap", 0.0) or 0.0
    window_size = kwargs.pop("window_size", (-1, -1))
    if isinstance(window_size, int):
        window_size = (window_size, window_size)
    alibi_slopes = kwargs.pop("alibi_slopes", None)
    if alibi_slopes is not None:
        alibi_slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32, device=query.device)
    sinks = kwargs.pop("sinks", None)
    if sinks is not None:
        sinks = torch.as_tensor(sinks, dtype=torch.float32, device=query.device)
    meta = FFPAAttnMeta.from_kwargs(**kwargs)
    if meta.fallback(query, key, attn_mask, dropout_p):
        return _sdpa_fallback(
            query, key, value, attn_mask, dropout_p, is_causal, scale,
            enable_gqa, dropout_seed,
            softcap=softcap, window_size=window_size,
            alibi_slopes=alibi_slopes, sinks=sinks,
        )
    ameta, query, key, value, bias = meta.normalize(
        query, key, value, attn_mask, dropout_p, is_causal, scale, enable_gqa,
        softcap=softcap, window_size=window_size, alibi_slopes=alibi_slopes,
        sinks=sinks,
    )
    return apply_attention(
        ameta, query, key, value, bias, dropout_seed,
        alibi_slopes=alibi_slopes, sinks=sinks,
    )


def ffpa_attn_varlen_func(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cu_seqlens_q: torch.Tensor,
    cu_seqlens_k: Optional[torch.Tensor],
    max_seqlen_q: int,
    max_seqlen_k: int,
    *,
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    enable_gqa: bool = False,
    return_lse: bool = False,
    **kwargs,
):
    """Variable-length packed-THD attention (the FlashAttention-style
    surface of the JAX package's ``ffpa_attn_varlen_func``).

    Args:
      q: ``[Tq, Hq, D]`` fp16/bf16 packed queries; k: ``[Tk, Hkv, D]``;
        v: ``[Tk, Hkv, Dv]``.
      cu_seqlens_q / cu_seqlens_k: int32 ``[B + 1]`` segment offsets
        (``cu_seqlens_k=None`` reuses the queries'); a segment whose keys
        outnumber its queries is tail-aligned under ``causal``.
      **kwargs: ``softcap``, ``window_size``, ``alibi_slopes`` ([Hq]),
        ``sinks`` ([Hq]), ``block_q`` / ``block_kv`` (the kernel's tiles);
        the FlashAttention options the JAX package rejects raise one
        NotImplementedError naming them all, anything else TypeError.

    Returns:
      ``[Tq, Hq, Dv]`` in the input dtype (and the fp32 lse ``[Hq, Tq]``
      with ``return_lse``), on the inputs' device: the kernel for CUDA
      tensors, its plain version for CPU tensors. Under ``torch.autograd``
      the backward (packed training) gives dq, dk, dv in the inputs' dtypes
      from the varlen dK/dV and dQ kernels (their plain versions on the
      CPU), the sinks' gradient, and zeros for ALiBi slopes; the lse is not
      differentiable.
    """
    from .ops.varlen import ffpa_varlen_attention

    return ffpa_varlen_attention(
        q, k, v, cu_seqlens_q, cu_seqlens_k, max_seqlen_q, max_seqlen_k,
        dropout_p=dropout_p, softmax_scale=softmax_scale, causal=causal,
        enable_gqa=enable_gqa, return_lse=return_lse, **kwargs,
    )


# ---------------------------------------------------------------------------
# Monkey-patch of torch.nn.functional.scaled_dot_product_attention
# ---------------------------------------------------------------------------

_ORIG_SDPA = None
# The pristine function, captured at import, so that the passthrough can
# never recurse into the patched symbol.
_IMPORT_TIME_SDPA = F.scaled_dot_product_attention
_PATCH_DTYPES = (torch.float16, torch.bfloat16)


def _original_sdpa():
    original = _ORIG_SDPA or _IMPORT_TIME_SDPA
    if original is _sdpa_compatible_ffpa:  # pragma: no cover - safety net
        original = _IMPORT_TIME_SDPA
    return original


def _stock_reason(query, key, value, attn_mask, dropout_p, is_causal, args, kwargs):
    """Why a call must go to the stock function, or None for FFPA."""
    if args or kwargs:
        return "arguments FFPA does not take (%s)" % ", ".join(
            sorted(kwargs) or ["positional extras"])
    if dropout_p > 0.0:
        # SDPA has no seed argument: a fixed dropout_seed would repeat one
        # keep mask on every call.
        return "dropout_p > 0 (no dropout seed in the SDPA signature)"
    tensors = (query, key, value)
    if not all(isinstance(t, torch.Tensor) and t.ndim == 4 for t in tensors):
        return "inputs that are not 4-D tensors"
    if query.dtype not in _PATCH_DTYPES or key.dtype != query.dtype or value.dtype != query.dtype:
        return "dtypes other than float16 / bfloat16"
    if is_causal and query.shape[2] != key.shape[2]:
        # Stock is_causal is top-left aligned (row 0 sees key 0); FFPA's is
        # tail-aligned (row m sees keys <= m + Nkv - Nq).
        return "is_causal with Nq != Nkv (top-left alignment)"
    if FFPAAttnMeta.from_kwargs().fallback(query, key, attn_mask, dropout_p):
        return "shapes outside FFPA's range (head dim or sequence length)"
    return None


def _sdpa_compatible_ffpa(query, key, value, attn_mask=None, dropout_p=0.0, is_causal=False,
                          *args, scale=None, enable_gqa=False, **kwargs):
    """``ffpa_attn_func`` under the ``scaled_dot_product_attention``
    signature (the layout is already ``[B, H, N, D]``).

    The stock function takes a call with arguments FFPA does not take
    (it raises as it would), ``dropout_p > 0``, ``is_causal`` with Nq !=
    Nkv, inputs that are not 4-D fp16 / bf16, and every shape
    ``FFPAAttnMeta.fallback`` sends away; a patched user gets the stock
    semantics there, never another function. Everything else runs through
    ``ffpa_attn_func``, differentiable under ``torch.autograd``.
    """
    reason = _stock_reason(query, key, value, attn_mask, dropout_p, is_causal, args, kwargs)
    if reason is not None:
        logger.warning_once(
            "scaled_dot_product_attention called with %s; routing to the original "
            "implementation", reason)
        return _original_sdpa()(
            query, key, value, attn_mask, dropout_p, is_causal, *args,
            scale=scale, enable_gqa=enable_gqa, **kwargs)
    return ffpa_attn_func(query, key, value, attn_mask=attn_mask, is_causal=is_causal,
                          scale=scale, enable_gqa=enable_gqa)


def patch_dot_product_attention() -> None:
    """One-line integration: route
    ``torch.nn.functional.scaled_dot_product_attention`` through FFPA, with
    the stock function for what FFPA does not compute alike. Idempotent."""
    global _ORIG_SDPA
    if _ORIG_SDPA is None:
        _ORIG_SDPA = F.scaled_dot_product_attention
    F.scaled_dot_product_attention = _sdpa_compatible_ffpa
    logger.info_once("torch.nn.functional.scaled_dot_product_attention patched with FFPA")


def unpatch_dot_product_attention() -> None:
    """Restore the function ``patch_dot_product_attention`` replaced.
    Idempotent."""
    global _ORIG_SDPA
    if _ORIG_SDPA is not None:
        F.scaled_dot_product_attention = _ORIG_SDPA
        _ORIG_SDPA = None


__all__ = [
    "ffpa_attn_func",
    "ffpa_attn_varlen_func",
    "patch_dot_product_attention",
    "unpatch_dot_product_attention",
]
