"""Analytic attention FLOPs model (the JAX package's ``cli/_flops.py``).

fwd = 2 * B * Hq * (D + Dv) * valid_pairs (two GEMMs: QK^T and PV);
bwd = 2.5 * fwd, fwd_bwd = 3.5 * fwd. ``attention_valid_pairs`` counts the
exact tail-aligned causal / window (q, k) pairs, the decode tail included:
the work a kernel that skips masked tiles must still do.
"""

from __future__ import annotations


def attention_valid_pairs(
    nq: int, nkv: int, causal: bool = False, window: tuple = (-1, -1)
) -> int:
    """Exact number of attended (q, k) pairs of one head.

    Tail-aligned causal: row m (0-based) attends cols <= m + (nkv - nq),
    i.e. (nkv - nq + m + 1) pairs. A sliding window ``(left, right)``
    bounds cols to [p - left, p + right] around the tail-aligned position
    p = m + nkv - nq (-1 = unbounded; causal forces right = 0). A row that
    sees no column (causal with nkv < nq) counts 0.
    """
    wl = int(window[0])
    wr = 0 if causal else int(window[1])
    offset = nkv - nq
    if wl < 0 and not causal and wr < 0:
        return nq * nkv
    if wl < 0 and causal and offset >= 0:
        # sum_{m=0}^{nq-1} (offset + m + 1)
        return nq * (offset + 1) + (nq - 1) * nq // 2
    pairs = 0
    for m in range(nq):
        p = m + offset
        hi = nkv - 1 if wr < 0 else min(p + wr, nkv - 1)
        lo = 0 if wl < 0 else max(p - wl, 0)
        if hi >= lo:
            pairs += hi - lo + 1
    return pairs


def attention_flops(
    b: int,
    hq: int,
    nq: int,
    nkv: int,
    d: int,
    dv: int | None = None,
    *,
    causal: bool = False,
    direction: str = "fwd",
    window: tuple = (-1, -1),
) -> float:
    dv = d if dv is None else dv
    pairs = attention_valid_pairs(nq, nkv, causal, window)
    fwd = 2.0 * b * hq * pairs * (d + dv)
    if direction == "fwd":
        return fwd
    if direction == "bwd":
        return 2.5 * fwd
    if direction == "fwd_bwd":
        return 3.5 * fwd
    raise ValueError(f"direction must be fwd|bwd|fwd_bwd, got {direction}")


def tflops_from_ms(flops: float, ms: float) -> float:
    return flops / (ms * 1e-3) / 1e12


def format_tflops(tflops: float) -> str:
    """Compact '97T' formatting."""
    if tflops >= 10:
        return f"{tflops:.0f}T"
    return f"{tflops:.1f}T"
