"""Token sampling for the generation tier: temperature, top-k and nucleus
(top-p) filtering, greedy argmax at ``temperature == 0``.

Sampling draws from an explicit ``torch.Generator``; it will not give the
JAX package's draws for the same seed (different generators), only the same
distribution. Greedy decoding gives the same tokens.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG = -1e30


def filter_logits(logits, *, temperature=1.0, top_k=0, top_p=1.0):
    """Temperature-scale + top-k + nucleus-filter ``logits`` [..., vocab]
    (filtered-out entries get -1e30). The best token always survives:
    ``top_p <= 0`` collapses to argmax, ``top_k <= 0`` disables top-k."""
    x = logits.float() / max(float(temperature), 1e-6)
    vocab = x.shape[-1]
    sorted_x = torch.sort(x, dim=-1, descending=True).values
    eff_k = min(max(int(top_k) if int(top_k) > 0 else vocab, 1), vocab)
    kth = sorted_x[..., eff_k - 1 : eff_k]
    x = torch.where(x >= kth, x, _NEG)
    # nucleus: keep every sorted logit whose prefix mass EXCLUDING itself is
    # < p; the top-1 token always survives.
    probs = torch.softmax(sorted_x, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_p
    keep_sorted[..., 0] = True
    cutoff = torch.where(keep_sorted, sorted_x, float("inf")).amin(dim=-1, keepdim=True)
    return torch.where(x >= cutoff, x, _NEG)


def sample_logits(
    logits,
    generator: Optional[torch.Generator] = None,
    *,
    temperature=1.0,
    top_k=0,
    top_p=1.0,
    sampled=None,
):
    """Sample token ids from ``logits`` [..., vocab] -> int64 [...].

    ``temperature <= 0`` means greedy argmax (generator unused)."""
    if sampled is None:
        sampled = float(temperature) > 0.0
    if not sampled:
        return torch.argmax(logits, dim=-1)
    x = filter_logits(logits, temperature=temperature, top_k=top_k, top_p=top_p)
    probs = torch.softmax(x, dim=-1)
    flat = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1, generator=generator)
    return flat.reshape(probs.shape[:-1])


__all__ = ["sample_logits", "filter_logits"]
