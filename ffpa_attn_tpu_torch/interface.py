"""Public API of the PyTorch/CUDA port.

``ffpa_attn_func`` has the ``torch.nn.functional.scaled_dot_product_attention``
signature, the JAX package's error taxonomy and fallback policy, and the same
extension kwargs. Fallback shapes run the port's own fp32 reference, never a
library attention call.
"""

from __future__ import annotations

from typing import Optional

import torch

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


__all__ = ["ffpa_attn_func", "ffpa_attn_varlen_func"]
