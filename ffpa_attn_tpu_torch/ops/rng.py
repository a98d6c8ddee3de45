"""Deterministic, layout-independent attention-dropout RNG.

A counter-based integer hash over ``(seed, b, h, row, col)`` gives one fixed
uniform per logical score element, whatever the kernel's tiling. The hash is
a murmur3-finalizer-based combine in uint32 arithmetic; torch has no uint32
multiply, so every value lives in int64 and is cut back with
``& 0xFFFFFFFF`` after each step. The keep masks are bit-identical to the
JAX package's.

Keep rule: ``uniform(b,h,i,j) >= p`` keeps the element; kept elements are
scaled by ``1/(1-p)``.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9  # 2^32 / phi, the classic hash_combine constant.


def _u32(x, device=None) -> torch.Tensor:
    if isinstance(x, int):
        return torch.tensor(x & _MASK32, dtype=torch.int64, device=device)
    return torch.as_tensor(x, device=device).to(torch.int64) & _MASK32


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2^32`` for ``0 <= h < 2^32`` without int64 overflow: the
    constant is split in 16-bit halves so no partial product passes 2^48."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer (full avalanche)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def _combine(state: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """boost::hash_combine-style fold of one 32-bit word into the state."""
    mixed = (value + _GOLDEN + ((state << 6) & _MASK32) + (state >> 2)) & _MASK32
    return _fmix32(state ^ mixed)


def uniform_for_scores(seed, batch_idx, head_idx, row_ids, col_ids) -> torch.Tensor:
    """float32 uniform in [0, 1) for logical score elements ``[b, h, row, col]``.

    ``row_ids`` / ``col_ids`` are integer tensors (broadcastable against each
    other) holding global Q-row / KV-col indices; ``seed`` / ``batch_idx`` /
    ``head_idx`` are Python ints or integer scalars.
    """
    device = row_ids.device if isinstance(row_ids, torch.Tensor) else None
    state = _fmix32(_u32(seed, device) ^ 0x46465041)  # 'FFPA'
    state = _combine(state, _u32(batch_idx, device))
    state = _combine(state, _u32(head_idx, device))
    state = _combine(state, _u32(row_ids, device))
    state = _combine(state, _u32(col_ids, device))
    return (state >> 8).to(torch.float32) * (1.0 / (1 << 24))


def dropout_keep_mask(seed, batch_idx, head_idx, row_ids, col_ids, dropout_p) -> torch.Tensor:
    """Boolean keep mask with the contract ``keep <=> uniform >= p``."""
    u = uniform_for_scores(seed, batch_idx, head_idx, row_ids, col_ids)
    return u >= float(dropout_p)  # compared in float32, as in JAX


def make_row_col_ids(nq: int, nkv: int, row_offset=0, col_offset=0, device=None):
    """Global (row, col) index grids for a tile of shape (nq, nkv), as
    broadcast views (no nq*nkv allocation)."""
    rows = torch.arange(nq, device=device, dtype=torch.int64)[:, None] + row_offset
    cols = torch.arange(nkv, device=device, dtype=torch.int64)[None, :] + col_offset
    return rows.expand(nq, nkv), cols.expand(nq, nkv)


__all__ = ["uniform_for_scores", "dropout_keep_mask", "make_row_col_ids"]
