"""The yardstick's arithmetic: published peaks, the least time a call can
take, and the operations and bytes of an attention call.

Frozen copies of the port's ``utils/profiling.py`` (``PEAK_BF16_FLOPS``,
``PEAK_HBM_BW``, ``bound_ms``) and ``cli/_flops.py``
(``attention_valid_pairs``, ``attention_flops``), kept here so that a change
to the port cannot move the benchmark's yardstick.
"""

from __future__ import annotations

# Published NVIDIA H100 SXM peaks (dense): bf16/fp16 tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BW = 3.35e12


def bound_ms(flops: float, nbytes: float) -> tuple:
    """(least time in ms, "operations" or "bytes": whichever bounds it)."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BW
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attention_valid_pairs(nq: int, nkv: int, causal: bool = False,
                          window: tuple = (-1, -1)) -> int:
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
        return nq * (offset + 1) + (nq - 1) * nq // 2
    pairs = 0
    for m in range(nq):
        p = m + offset
        hi = nkv - 1 if wr < 0 else min(p + wr, nkv - 1)
        lo = 0 if wl < 0 else max(p - wl, 0)
        if hi >= lo:
            pairs += hi - lo + 1
    return pairs


def attention_flops(b: int, hq: int, nq: int, nkv: int, d: int, dv: int | None = None, *,
                    causal: bool = False, window: tuple = (-1, -1)) -> float:
    """Forward operations: 2 * B * Hq * (D + Dv) per attended pair (QK^T and PV)."""
    dv = d if dv is None else dv
    return 2.0 * b * hq * attention_valid_pairs(nq, nkv, causal, window) * (d + dv)


def latent_decode_counts(lens, *, hq: int, nq: int, d: int, dv: int,
                         itemsize: int = 2) -> tuple:
    """(operations, bytes) of one absorbed-MLA decode call over a latent
    cache: request b holds ``lens[b]`` rows before the step's ``nq`` new
    ones, and its token t attends ``lens[b] + 1 + t`` of them (tail-aligned
    causal). The latent row (D wide; V is its first Dv columns) is read
    once, whatever the kernel reads again, and so is q; o is written once.
    The softmax's lse is the kernel's own and is not counted."""
    flops = sum(attention_flops(1, hq, nq, int(n) + nq, d, dv, causal=True) for n in lens)
    rows = sum(int(n) + nq for n in lens)
    nbytes = (rows * d + len(lens) * hq * nq * (d + dv)) * itemsize
    return flops, nbytes
