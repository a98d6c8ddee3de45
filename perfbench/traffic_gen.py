"""The one generator of the benchmark's traffic: a mix's parameters (a
``traffic/<mix>.json`` file) and a seed in, request lengths and a page
table out. The lengths are the mix's alone; the page table, like every
other input, comes from ``numpy``'s generator seeded by the run's seed
and a stream number, so one seed gives one traffic."""

from __future__ import annotations

from statistics import NormalDist

import numpy as np

# Streams of one seed: each kind of input draws from its own.
STREAM_PAGES, STREAM_LATENTS, STREAM_Q, STREAM_ROWS, STREAM_SAMPLE = range(2, 7)


def seed_words(seed: int, *stream: int) -> list:
    """The seed's words for ``numpy.random.SeedSequence``: any whole number,
    negative or wider than 64 bits included, maps to one entropy word."""
    return [int(seed) % (1 << 64), *stream]


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(seed_words(seed, *stream)))


def torch_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for a ``torch.Generator``, from the run's seed and a stream."""
    words = np.random.SeedSequence(seed_words(seed, *stream)).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def lengths(mix: dict) -> np.ndarray:
    """Cached rows of each request before a step, [batch] int64: the same
    for every run, whatever its seed.

    The lognormal's (``median``, ``sigma``) quantiles at (i + 1/2) / batch,
    clipped to [``min``, ``max``], then scaled (and clipped again, until
    both hold) so that they sum to exactly ``total``, dealt longest first.
    The paged walk's grid takes requests in batch order, one block an SM,
    so the order decides the last wave: longest first is the order that a
    scheduler which sorts its batch by context gives, and it leaves no
    request's place to chance. A run's seed draws the page tables, latents
    and queries."""
    spec, batch = mix["lengths"], int(mix["batch"])
    lo, hi, total = int(spec["min"]), int(spec["max"]), int(spec["total"])
    if not batch * lo <= total <= batch * hi:
        raise ValueError(f"{batch} lengths in [{lo}, {hi}] cannot sum to {total}")
    z = np.array([NormalDist().inv_cdf((i + 0.5) / batch) for i in range(batch)])
    x = np.exp(np.log(spec["median"]) + spec["sigma"] * z)
    for _ in range(1000):
        x = np.clip(x, lo, hi)
        x = x * (total / x.sum())
        if x.min() >= lo and x.max() <= hi:
            break
    n = np.clip(np.rint(x), lo, hi).astype(np.int64)
    diff = total - int(n.sum())
    while diff:
        step = 1 if diff > 0 else -1
        idx = np.flatnonzero(n < hi if step > 0 else n > lo)
        k = min(abs(diff), idx.size)
        pick = idx[np.argsort(-(x[idx] - n[idx]) * step, kind="stable")[:k]]
        n[pick] += step
        diff -= step * k
    return np.sort(n)[::-1].copy()


def page_table(lens: np.ndarray, nq: int, page: int, seed: int) -> tuple:
    """(table [batch, max_pages] int32, pool pages): request b holds
    ceil((lens[b] + nq) / page) pages, room for its cached rows and the
    step's nq new ones, drawn from a shuffled pool as in a pool that has
    served traffic. Page 0 is the null page; unused entries point at it."""
    need = -(-(np.asarray(lens, dtype=np.int64) + nq) // page)
    total = int(need.sum())
    perm = 1 + rng(seed, STREAM_PAGES).permutation(total)
    table = np.zeros((need.size, int(need.max())), dtype=np.int32)
    start = 0
    for b, k in enumerate(need):
        table[b, :k] = perm[start:start + k]
        start += k
    return table, total + 1
