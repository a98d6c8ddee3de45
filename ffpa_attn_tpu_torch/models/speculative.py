"""Speculative decoding: a draft model proposes, the target verifies.

A cheap DRAFT model proposes ``k_spec`` tokens one at a time; the TARGET
model then scores all ``k_spec + 1`` positions in ONE attention call per
layer, which takes the decode kernel at Nq = k_spec + 1 (the rows of a GQA
group packed together) and streams the KV cache once where k_spec + 1
single-token steps would stream it k_spec + 1 times.

Both modes are exact for any draft; the draft only changes how many tokens
each target call yields:

* ``temperature == 0``: greedy speculation, the emitted stream is the
  target's greedy stream;
* ``temperature > 0``: rejection sampling (:func:`speculative_accept`), the
  emitted stream is distributed as target sampling under the same
  temperature / top-k / top-p controls. The draws come from a
  ``torch.Generator``, so a seed does not give the JAX package's draws.

The verify block (the JAX package's ``_verify_block``) is
``generate.decode_block`` at m = k_spec + 1: it teacher-forces the tail,
writing its K/V in place, under a per-row validity bias over the cache (row
t sees positions <= pos + t; a model sliding window refines it). Rejected
rows leave K/V behind in both caches; that is harmless by
construction: position p is only attended once some query reaches it, and
every position is written again by the token that really occupies it
before that happens.
"""

from __future__ import annotations

from typing import Optional

import torch

from .generate import decode_block, decode_step, init_kv_cache, prefill
from .sampling import filter_logits, sample_logits
from .transformer import Transformer


def speculative_accept(p_target, p_draft, drafts, generator: Optional[torch.Generator] = None):
    """Rejection-sampling acceptance (Leviathan et al. / DeepMind 2023).

    Args:
      p_target: [..., k, vocab] target probabilities at the k draft positions.
      p_draft: [..., k, vocab] draft probabilities at the same positions.
      drafts: [..., k] int proposed tokens.
      generator: the source of the draws, on the tensors' device.

    Returns (n_acc, next_token), each [...]: ``n_acc`` is the accepted
    prefix length in [0, k], draft t accepted with probability
    ``min(1, p_t[d_t] / p_d[d_t])``; ``next_token`` is a sample of the
    residual ``max(0, p_t - p_d)`` (renormalised) at the first rejected
    position, meaningless where everything was accepted (the caller then
    samples the bonus position itself).
    """
    k, vocab = p_target.shape[-2:]
    idx = drafts[..., None].long()
    pt_d = p_target.gather(-1, idx)[..., 0]
    pd_d = p_draft.gather(-1, idx)[..., 0].clamp_min(1e-30)
    u = torch.rand(pt_d.shape, generator=generator, device=pt_d.device)
    accept = u < (pt_d / pd_d).clamp(max=1.0)
    n_acc = accept.long().cumprod(-1).sum(-1)
    # The residual at the first rejected position (clamped to k - 1 for the
    # index; unused when n_acc == k).
    j = n_acc.clamp(max=k - 1)[..., None, None].expand(*n_acc.shape, 1, vocab)
    pt_j, pd_j = p_target.gather(-2, j)[..., 0, :], p_draft.gather(-2, j)[..., 0, :]
    resid = (pt_j - pd_j).clamp_min(0.0)
    mass = resid.sum(-1, keepdim=True)
    # Mass 0 (p_t <= p_d everywhere) cannot coincide with a rejection
    # unless rounding colludes; fall back to the target distribution.
    resid = torch.where(mass > 0.0, resid / mass.clamp_min(1e-30), pt_j)
    nxt = torch.multinomial(resid.reshape(-1, vocab), 1, generator=generator)
    return n_acc, nxt.reshape(n_acc.shape)


def _spec_loop(model_t, model_d, cache_t, cache_d, first, start: int, steps: int, k_spec: int,
               ctl: dict, generator):
    """Iterate draft-propose / target-verify until ``steps`` tokens past
    ``first`` are emitted (at most ``steps`` iterations: each emits 1 to
    k_spec + 1). Returns (the emitted tokens [B, >= steps], stats)."""
    sampled = ctl["sampled"]

    def probs(logits):
        x = filter_logits(logits, temperature=ctl["temperature"], top_k=ctl["top_k"],
                          top_p=ctl["top_p"])
        return torch.softmax(x, dim=-1)

    emitted, pos, tok = [], start, first
    count = accepted = n_iter = 0
    while count < steps:
        # The draft proposes k_spec tokens. One EXTRA step (k_spec + 1 in
        # all) writes the last draft's K/V into the draft cache: on full
        # acceptance the next iteration resumes past that position and would
        # otherwise attend a zero row, which lowers acceptance exactly where
        # it is high. Its proposal is discarded.
        drafts, p_draft, cur = [], [], tok
        for t in range(k_spec + 1):
            logits, cache_d = decode_step(model_d, cache_d, pos + t, cur)
            if sampled:
                p = probs(logits)
                p_draft.append(p)
                cur = torch.multinomial(p, 1, generator=generator)[:, 0]
            else:
                cur = logits.argmax(-1)
            drafts.append(cur)
        drafts = torch.stack(drafts[:k_spec], dim=1)  # [B, k_spec]

        # The target scores tok + drafts in ONE (k_spec + 1)-row call a layer.
        block = torch.cat([tok[:, None], drafts], dim=1)
        logits, cache_t = decode_block(model_t, cache_t, pos, block)

        # The batch advances by its minimum acceptance. Reading it on the
        # host is the one synchronisation an iteration needs.
        if sampled:
            p_t = probs(logits)  # [B, k + 1, vocab]
            n_acc_b, resid_b = speculative_accept(
                p_t[:, :k_spec], torch.stack(p_draft[:k_spec], dim=1), drafts, generator)
            bonus_b = torch.multinomial(p_t[:, k_spec], 1, generator=generator)[:, 0]
            n_acc = int(n_acc_b.min())
            # A row that accepted past the cut emits its draft there; the
            # others their residual sample, or the bonus sample when every
            # draft was accepted.
            new_tok = torch.where(n_acc_b > n_acc, drafts[:, min(n_acc, k_spec - 1)],
                                  bonus_b if n_acc == k_spec else resid_b)
        else:
            greedy = logits.argmax(-1)  # [B, k + 1]
            match = (drafts == greedy[:, :k_spec]).long()
            n_acc = int(match.cumprod(dim=1).sum(dim=1).min())
            new_tok = greedy[:, n_acc]
        # Emit drafts[:n_acc], then the token at the cut (the bonus token
        # when everything was accepted).
        emitted.append(torch.cat([drafts[:, :n_acc], new_tok[:, None]], dim=1))
        pos, tok = pos + n_acc + 1, new_tok
        count, accepted, n_iter = count + n_acc + 1, accepted + n_acc, n_iter + 1
    stats = {"emitted": count + 1, "draft_accepted": accepted, "proposals": n_iter * k_spec,
             "target_calls": n_iter}
    return torch.cat(emitted, dim=1), stats


@torch.inference_mode()
def speculative_generate(
    model_target: Transformer,
    model_draft: Transformer,
    prompt: torch.Tensor,
    steps: int,
    max_len: int,
    k_spec: int = 4,
    return_stats: bool = False,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    generator: Optional[torch.Generator] = None,
):
    """Speculative decoding: prompt [B, Np] -> tokens [B, steps].

    ``temperature == 0`` (the default) is greedy speculation: the target's
    greedy stream for any draft. ``temperature > 0`` is rejection-sampling
    speculation, distributed as target sampling with the same controls and
    drawn from ``generator`` (on the models' device). The draft shares the
    target's vocabulary; each model has its own cache.

    ``max_len`` must leave ``steps + k_spec + 1`` rows past the prompt (the
    last verify block writes up to k_spec + 1 rows beyond the last emitted
    position); ``k_spec <= 7`` keeps the verify block (k_spec + 1 rows) on
    the decode route. With ``return_stats`` also returns the JAX package's
    stats: ``emitted``, ``draft_accepted``, ``proposals``,
    ``target_calls``.
    """
    if not 1 <= k_spec <= 7:
        raise ValueError(f"k_spec must be in [1, 7], got {k_spec}")
    b, n = prompt.shape
    if max_len < n + steps + k_spec + 1:
        raise ValueError(
            f"max_len {max_len} < prompt {n} + steps {steps} + k_spec {k_spec} + 1")
    dev = model_target.embed.device
    prompt = prompt.to(dev)
    cache_t = init_kv_cache(model_target.cfg, b, max_len, device=dev)
    cache_d = init_kv_cache(model_draft.cfg, b, max_len, device=dev)
    logits_t, cache_t = prefill(model_target, prompt, cache_t)
    _, cache_d = prefill(model_draft, prompt, cache_d)
    ctl = dict(temperature=temperature, top_k=top_k, top_p=top_p,
               sampled=float(temperature) > 0.0)
    first = sample_logits(logits_t, generator, **ctl)
    rest, stats = _spec_loop(model_target, model_draft, cache_t, cache_d, first, n, steps,
                             k_spec, ctl, generator)
    toks = torch.cat([first[:, None], rest], dim=1)[:, :steps]
    return (toks, stats) if return_stats else toks


__all__ = ["speculative_accept", "speculative_generate"]
