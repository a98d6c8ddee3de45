"""Sequence-length bucketing for autotune keys.

The JAX package's ``autotune/bucket.py`` semantics, kept as the port's own
copy (the port imports nothing of the JAX package):

* fast mode: 1024-wide bins, capped at 8192;
* max mode: piecewise bins: 64 up to 512, 128 up to 1024, 256 up to 2048,
  512 up to 4096, 1024 above, capped at 16384;
* ``exact_autotune_seqlen_keys``: a context in which bucketing is off and
  exact lengths are recorded.
"""

from __future__ import annotations

import contextlib
import contextvars

_EXACT_KEYS = contextvars.ContextVar("ffpa_torch_exact_seqlen_keys", default=False)

FAST_CAP = 8192
MAX_CAP = 16384


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def bucket_autotune_seqlen(n: int, mode: str = "fast") -> int:
    """Bucket a sequence length for autotune cache keys."""
    if _EXACT_KEYS.get():
        return n
    if n <= 0:
        return 0
    if mode == "fast":
        return min(_round_up(n, 1024), FAST_CAP)
    if mode != "max":
        raise ValueError(f"mode must be 'fast' or 'max', got {mode!r}")
    if n <= 512:
        return _round_up(n, 64)
    if n <= 1024:
        return _round_up(n, 128)
    if n <= 2048:
        return _round_up(n, 256)
    if n <= 4096:
        return _round_up(n, 512)
    return min(_round_up(n, 1024), MAX_CAP)


@contextlib.contextmanager
def exact_autotune_seqlen_keys():
    """Within this context bucketing is off: exact lengths are recorded."""
    token = _EXACT_KEYS.set(True)
    try:
        yield
    finally:
        _EXACT_KEYS.reset(token)
