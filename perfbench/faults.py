"""Faults planted under the timed path, each of which the check has to
catch: the cells' answers are the attention outputs, and their state the
latent cache. ``control.py`` reads them at a cell's full size on the card;
the tests run them at a tiny size.

Each fault wraps the port's function that the driver calls and is planted
by name with ``planted(name)``."""

from __future__ import annotations

import contextlib

from .drivers import paged_decode


def _stale_append(real):
    """An append that leaves the cache unchanged: no row written, no length grown."""
    def append(cache, k_new, v_new):
        return cache
    return append


def _half_batch(real):
    """Half of the batch left out, the mean over the rest in its place."""
    def attend(q, cache, **kw):
        o = real(q, cache, **kw)
        half = o.shape[0] // 2
        o[half:] = o[:half].mean(dim=0, keepdim=True)
        return o
    return attend


def _altered(real):
    """One request's answer altered where it is produced: request 1's in its place."""
    def attend(q, cache, **kw):
        o = real(q, cache, **kw)
        o[0] = o[1]
        return o
    return attend


FAULTS = {
    "stale_append": ("append_token", _stale_append),
    "half_batch": ("paged_decode_attention", _half_batch),
    "altered_answer": ("paged_decode_attention", _altered),
}


@contextlib.contextmanager
def planted(name: str):
    """The driver's call of the port's function swapped for the fault ``name``."""
    attr, fault = FAULTS[name]
    real = getattr(paged_decode, attr)
    setattr(paged_decode, attr, fault(real))
    try:
        yield
    finally:
        setattr(paged_decode, attr, real)
