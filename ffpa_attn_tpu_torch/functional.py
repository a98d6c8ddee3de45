"""Dispatch, validation and backend configuration of the PyTorch/CUDA port.

* ``Backend`` dataclasses: ``SDPABackend`` (the fp32 reference composite)
  and ``CudaBackend`` (the hand-written Hopper kernels), also under the
  JAX package's name ``PallasBackend``. The other kernel tier names the
  JAX package accepts ("pallas", "mosaic", "triton", "cutedsl") alias to
  ``CudaBackend``.
* ``FFPAAttnMeta``: kwarg parsing with unknown-key TypeError, the fallback
  predicate, input validation / normalization, and boolean -> additive mask
  normalization.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Union

import torch

from .env import ENV
from .logger import init_logger

logger = init_logger(__name__)

# Head dims the kernel path is designed for: above 256 (smaller ones take
# the reference unless FFPA_TORCH_ALLOW_SMALL_D), up to 1024.
MIN_LARGE_D = 257
MAX_LARGE_D = 1024

_SUPPORTED_DTYPES = (torch.float16, torch.bfloat16)


@dataclass(frozen=True)
class Backend:
    """Base backend config; one config can serve as forward, backward or
    both."""

    name: str = "base"

    def validate(self) -> None:  # pragma: no cover - overridden
        pass


@dataclass(frozen=True)
class SDPABackend(Backend):
    """The fp32-accumulated reference composite."""

    name: str = "sdpa"


@dataclass(frozen=True)
class CudaBackend(Backend):
    """The hand-written Hopper kernel tier.

    ``autotune`` / ``autotune_mode``: a timed search at the call, the JAX
    package's ``PallasBackend(autotune=True)``: the first call of each
    variant (shapes, dtype, bias shape, causal, dropout, mode) searches the
    forward's (and, under autograd, the backward's) run-time knobs
    (``autotune/search.py``) and later calls reuse its winner
    (``ops/attention.py`` ``_online_autotune``). Under CUDA-graph capture or
    ``torch.compile`` nothing can be timed: the call warns once and takes
    the tuned store's config or the default. The Hopper knobs have one
    space, which "fast" and "max" both search; another mode raises.
    ``block_q`` / ``block_kv``: manual forward block-shape overrides (None =
    the cost model's pick; a manual block skips the search). ``block_q``
    must be a row tile the forward kernel is compiled for, ``block_kv`` its
    KV tile. ``block_kv_dkdv``: the JAX package's dK/dV KV tile override,
    validated (the compiled KV tile) and kept for parity with its API: the
    dK/dV launchers take their own 64-row KV tile.
    ``block_q_dq``: the JAX package's dQ row tile override, validated (one
    of the row tiles) and kept for parity with its API; the dense recompute
    dQ and the packed varlen dQ take their own 64-row tile at every head
    dim and do not read it.
    ``grad_kv_storage_dtype`` / ``grad_q_storage_dtype``: the dtype the
    backward returns dK/dV and dQ in ('f16', 'bf16', 'f32'; None = the
    input's).
    ``ds_handoff``: the dS-handoff backward (None = auto by the device
    memory budget, True / False = force).
    ``save_scores``: the S-resident backward, in which the forward keeps
    its bf16 score matrix and the backward reads it instead of recomputing
    it. None = auto, as in the JAX package: bf16 inputs keep as many whole
    GQA groups of heads' residuals as fit min(``FFPA_TORCH_SCORES_
    RESIDUAL_LIMIT_BYTES``, the card's headroom / ``FFPA_TORCH_SCORES_AUTO_
    ASSUMED_LAYERS``); True = every head (fp16 inputs warn and take the dS
    handoff); False = never. Never with a sliding window, softcap with a
    bias or ALiBi, or the SDPA backward.
    """

    name: str = "cuda"
    autotune: bool = False
    autotune_mode: str = "fast"
    block_q: Optional[int] = None
    block_kv: Optional[int] = None
    block_kv_dkdv: Optional[int] = None
    block_q_dq: Optional[int] = None
    grad_kv_storage_dtype: Optional[str] = None
    grad_q_storage_dtype: Optional[str] = None
    ds_handoff: Optional[bool] = None
    save_scores: Optional[bool] = None

    def validate(self) -> None:
        from .ops.config import FWD_ROW_TILES, KV_TILE

        if self.autotune_mode not in ("fast", "max"):
            raise ValueError(
                f"autotune_mode must be 'fast' or 'max', got {self.autotune_mode!r}"
            )
        if self.block_q is not None and self.block_q not in FWD_ROW_TILES:
            raise ValueError(f"block_q must be one of {FWD_ROW_TILES}, got {self.block_q}")
        for attr in ("block_kv", "block_kv_dkdv"):
            val = getattr(self, attr)
            if val is not None and val != KV_TILE:
                raise ValueError(f"{attr} must be {KV_TILE}, got {val}")
        if self.block_q_dq is not None and self.block_q_dq not in FWD_ROW_TILES:
            raise ValueError(
                f"block_q_dq must be one of {FWD_ROW_TILES}, got {self.block_q_dq}"
            )
        for attr in ("grad_kv_storage_dtype", "grad_q_storage_dtype"):
            val = getattr(self, attr)
            if val is not None and val not in ("f16", "bf16", "f32"):
                raise ValueError(
                    f"{attr} must be one of 'f16', 'bf16', 'f32', got {val!r}"
                )


# The JAX package's name of the kernel tier, so that its ``from ... import
# PallasBackend`` finds the port's.
PallasBackend = CudaBackend

_BACKEND_ALIASES = {
    "sdpa": SDPABackend,
    "cuda": CudaBackend,
    "pallas": CudaBackend,
    "mosaic": CudaBackend,
    "triton": CudaBackend,
    "cutedsl": CudaBackend,
}


def _coerce_backend(value: Union[str, Backend, None]) -> Optional[Backend]:
    if value is None or isinstance(value, Backend):
        if isinstance(value, Backend):
            value.validate()
        return value
    if isinstance(value, str):
        key = value.lower()
        if key not in _BACKEND_ALIASES:
            raise ValueError(
                f"unknown backend {value!r}; expected one of "
                f"{sorted(_BACKEND_ALIASES)}"
            )
        if key not in ("sdpa", "cuda"):
            logger.info_once("backend '%s' names another kernel tier; using the CUDA tier", key)
        return _BACKEND_ALIASES[key]()
    raise TypeError(f"backend must be a str or Backend, got {type(value)!r}")


@dataclass(frozen=True)
class AttentionMeta:
    """Normalized attention call description handed to the kernel layer."""

    scale: float
    is_causal: bool
    dropout_p: float
    num_q_heads: int
    num_kv_heads: int
    enable_gqa: bool
    forward_backend: Backend = field(default_factory=CudaBackend)
    backward_backend: Backend = field(default_factory=CudaBackend)
    softcap: float = 0.0
    window: tuple = (-1, -1)


@dataclass(frozen=True)
class FFPAAttnMeta:
    """Pre-normalization meta built from user kwargs: kwargs are parsed
    first (so unknown keys raise TypeError before any tensor checks), then
    ``fallback`` decides the reference short-circuit, then ``normalize``
    validates and canonicalizes tensors."""

    forward_backend: Optional[Backend] = None
    backward_backend: Optional[Backend] = None
    backend_forced: bool = False

    _ALLOWED_KWARGS = ("backend", "forward_backend", "backward_backend")

    @classmethod
    def from_kwargs(cls, **kwargs: object) -> "FFPAAttnMeta":
        unknown = [k for k in kwargs if k not in cls._ALLOWED_KWARGS]
        if unknown:
            raise TypeError(
                f"ffpa_attn_func() got unexpected keyword argument(s): "
                f"{', '.join(sorted(unknown))}; supported extension kwargs "
                f"are {list(cls._ALLOWED_KWARGS)}"
            )
        shared = _coerce_backend(kwargs.get("backend"))  # type: ignore[arg-type]
        fwd = _coerce_backend(kwargs.get("forward_backend"))  # type: ignore[arg-type]
        bwd = _coerce_backend(kwargs.get("backward_backend"))  # type: ignore[arg-type]
        forced = any(kwargs.get(k) is not None for k in cls._ALLOWED_KWARGS)
        return cls(
            forward_backend=fwd or shared,
            backward_backend=bwd or shared,
            backend_forced=forced,
        )

    def fallback(self, query, key, attn_mask, dropout_p: float) -> bool:
        """True when the call should short-circuit to the fp32 reference:

        * explicit sdpa forward backend;
        * D <= 256 unless FFPA_TORCH_ALLOW_SMALL_D;
        * D > 1024, beyond the designed range;
        * 8 < Nq < min_seqlen_q or Nkv < min_seqlen_kv (Nq <= 8 is decode).
        """
        if isinstance(self.forward_backend, SDPABackend):
            return True
        if query.ndim != 4 or key.ndim != 4:
            return False  # let normalize raise a precise error
        d = query.shape[-1]
        if d < MIN_LARGE_D and not ENV.allow_small_d():
            if self.backend_forced:
                logger.warning_once(
                    "head_dim %d <= 256: falling back to the reference despite "
                    "explicit backend (set FFPA_TORCH_ALLOW_SMALL_D=1 to force "
                    "the kernel path)",
                    d,
                )
            return True
        if d > MAX_LARGE_D:
            logger.warning_once(
                "head_dim %d > %d: falling back to the reference", d, MAX_LARGE_D
            )
            return True
        nq, nkv = query.shape[2], key.shape[2]
        if 8 < nq < ENV.min_seqlen_q() or nkv < ENV.min_seqlen_kv():
            return True
        return False

    def normalize(
        self,
        query,
        key,
        value,
        attn_mask,
        dropout_p: float,
        is_causal: bool,
        scale: Optional[float],
        enable_gqa: bool,
        softcap: float = 0.0,
        window_size=(-1, -1),
        alibi_slopes=None,
        sinks=None,
    ):
        """Validate and canonicalize inputs. Returns
        ``(meta, query, key, value, bias)`` with ``bias`` an additive fp32
        bias (or None), 4-D with broadcast dims kept size 1."""
        if not (0.0 <= dropout_p < 1.0):
            raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
        if softcap is None:
            softcap = 0.0
        if softcap < 0.0:
            raise ValueError(f"softcap must be >= 0, got {softcap}")
        try:
            wl, wr = int(window_size[0]), int(window_size[1])
        except (TypeError, IndexError):
            raise ValueError(
                f"window_size must be a (left, right) pair of ints, got "
                f"{window_size!r}"
            ) from None
        if wl < -1 or wr < -1:
            raise ValueError(
                f"window_size entries must be >= -1 (-1 = unbounded), got "
                f"({wl}, {wr})"
            )
        if query.dtype not in _SUPPORTED_DTYPES:
            raise TypeError(
                f"query dtype must be float16 or bfloat16, got {query.dtype}"
            )
        if key.dtype != query.dtype or value.dtype != query.dtype:
            raise TypeError(
                f"q/k/v dtypes must match, got {query.dtype}/{key.dtype}/"
                f"{value.dtype}"
            )
        for name, t in (("query", query), ("key", key), ("value", value)):
            if t.ndim != 4:
                raise ValueError(
                    f"{name} must be 4-D [B, H, N, D], got shape {tuple(t.shape)}"
                )
        b, hq, nq, d = query.shape
        bk, hkv, nkv, dk = key.shape
        bv, hv, nv, dv = value.shape
        if bk != b or bv != b:
            raise ValueError(f"batch mismatch: q={b}, k={bk}, v={bv}")
        if dk != d:
            raise ValueError(f"head_dim mismatch: q={d}, k={dk}")
        if hv != hkv or nv != nkv:
            raise ValueError(
                "key and value must share num_heads and seqlen, got "
                f"k=[{hkv},{nkv}], v=[{hv},{nv}]"
            )
        if hq != hkv:
            if not enable_gqa:
                raise ValueError(
                    f"num_heads mismatch (q={hq}, kv={hkv}) requires "
                    "enable_gqa=True"
                )
            if hq % hkv != 0:
                raise ValueError(
                    f"GQA requires Nh_q % Nh_kv == 0, got {hq} % {hkv}"
                )
        if is_causal and nkv < nq:
            raise ValueError(
                f"is_causal=True requires Nkv >= Nq (tail-aligned causal), "
                f"got Nq={nq}, Nkv={nkv}"
            )
        if (wl >= 0 or wr >= 0) and nkv < nq:
            raise ValueError(
                f"window_size requires Nkv >= Nq (tail-aligned band), got "
                f"Nq={nq}, Nkv={nkv}"
            )
        if alibi_slopes is not None:
            ashape = tuple(alibi_slopes.shape)
            if ashape not in ((hq,), (b, hq)):
                raise ValueError(
                    f"alibi_slopes must have shape ({hq},) or ({b}, {hq}), "
                    f"got {ashape}"
                )
        if sinks is not None and tuple(sinks.shape) != (hq,):
            raise ValueError(
                f"sinks must have shape ({hq},) (one logit per query "
                f"head), got {tuple(sinks.shape)}"
            )
        if scale is None:
            scale = 1.0 / math.sqrt(d)

        bias = None
        if attn_mask is not None:
            bias = normalize_attn_mask(attn_mask, b, hq, nq, nkv)

        meta = AttentionMeta(
            scale=float(scale),
            is_causal=bool(is_causal),
            dropout_p=float(dropout_p),
            num_q_heads=hq,
            num_kv_heads=hkv,
            enable_gqa=bool(enable_gqa),
            forward_backend=self.forward_backend or CudaBackend(),
            backward_backend=self.backward_backend or CudaBackend(),
            softcap=float(softcap),
            window=(wl, wr),
        )
        return meta, query, key, value, bias


def _validate_attn_mask_shape(shape, b, hq, nq, nkv) -> None:
    """4-D mask dims must be broadcast-compatible with [B, Hq, Nq, Nkv]."""
    expected = (b, hq, nq, nkv)
    for dim, (got, want) in enumerate(zip(shape, expected)):
        if got != 1 and got != want:
            raise ValueError(
                f"attn_mask shape {tuple(shape)} is not broadcastable to "
                f"[B={b}, Hq={hq}, Nq={nq}, Nkv={nkv}] (dim {dim}: {got} vs "
                f"{want})"
            )


def normalize_attn_mask(attn_mask, b: int, hq: int, nq: int, nkv: int):
    """Boolean masks -> additive fp32 bias; 2-D/3-D -> 4-D; broadcast dims
    stay size 1."""
    if attn_mask.ndim == 2:
        attn_mask = attn_mask[None, None]
    elif attn_mask.ndim == 3:
        attn_mask = attn_mask[:, None]
    elif attn_mask.ndim != 4:
        raise ValueError(
            f"attn_mask must be 2-D, 3-D or 4-D, got {attn_mask.ndim}-D"
        )
    _validate_attn_mask_shape(attn_mask.shape, b, hq, nq, nkv)
    if attn_mask.dtype == torch.bool:
        # SDPA semantics: True participates; False gets a -inf-like bias.
        from .ops.reference import DEFAULT_MASK_VALUE

        zero = torch.zeros((), dtype=torch.float32, device=attn_mask.device)
        return torch.where(attn_mask, zero, DEFAULT_MASK_VALUE)
    return attn_mask.float()


__all__ = [
    "Backend",
    "SDPABackend",
    "CudaBackend",
    "PallasBackend",
    "AttentionMeta",
    "FFPAAttnMeta",
    "normalize_attn_mask",
    "MIN_LARGE_D",
    "MAX_LARGE_D",
]
