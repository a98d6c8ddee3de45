"""Timed search over the Hopper kernels' run-time knobs.

The counterpart of the JAX package's ``autotune/search.py``: a resilient
walk over candidate configs (a failing candidate is skipped, one that runs
past its deadline too), candidates ordered with the plan first and capped
by ``FFPA_TORCH_AUTOTUNE_MAX_CONFIGS``, each timed by the bench's timers
(``cli/_bench.py`` ``time_fwd`` / ``time_bwd`` / ``time_queued``: CUDA
events, the median of windows). The TPU's knob, (block_q, block_kv) pruned
by a VMEM model, does not carry over: the Hopper kernels take 64 x 64
tiles of their own. What they take at run time is searched instead, pruned
by the port's shared-memory plans (no cap above a plan's depth, none below
the fewest stages its walk holds at once):

* ``bwd``: the backward rings' cap (``BlockConfig.bwd_ring_cap``) of the
  tier the step runs (``ops/attention.py`` ``_should_save_scores``: the
  from-S pass, or the dK/dV and dQ pair), from the plan's depth down to the
  fewest stages the walk needs (3 for the pair, 1 + ceil(nv / 2) for
  from-S), and the dS handoff's e4m3 storage where
  ``dispatch.fp8_ds_allowed``;
* ``varlen``: the packed backward pair's ring cap, timing the packed
  forward plus backward;
* ``fwd`` and ``decode``: the plan alone, recorded as ``verify``'s
  baseline. The forward's ring is fixed at compile time
  (``csrc/flash_fwd.cu`` ``stages_of``), and decode's split count is its
  rule's (``ops/decode.py`` ``_tma_splits``; a decode step is host-bound,
  so it is timed with the host's enqueue off the clock, ``time_queued``).

A candidate displaces the plan only where it wins by more than noise
(``search``): each is timed between two readings of the plan, and it must
beat the plan's median by more than the plan's own spread and by
``MIN_GAIN``. Otherwise the entry holds the plan, which routes as no entry
does.

fp16 runs natively (the port's deliberate difference from the JAX package,
which computes fp16 in bf16): an fp16 task feeds the kernels fp16 and is
never offered e4m3. The JAX package's ``mode`` ("fast" / "max") picks its
block ladder; the Hopper knobs have one space, which both modes search.
"""

from __future__ import annotations

import os
import signal
import statistics
import threading
from dataclasses import replace
from typing import Callable, Iterable, NamedTuple, Optional

import torch

from ..env import ENV
from ..logger import init_logger
from ..ops.config import (
    D_CHUNK,
    DKDV_MIN_STAGES,
    BlockConfig,
    cdiv,
    dkdv_plan,
    dq_plan,
    from_s_fits,
    from_s_min_stages,
    from_s_plan,
    varlen_dkdv_plan,
    varlen_dq_plan,
)

logger = init_logger(__name__)


# The least gain, as a share of the plan's ms, by which a candidate must
# beat the plan to displace it (besides the plan's own spread).
MIN_GAIN = 0.02


class Found(NamedTuple):
    """A search's winner and its ms (None, inf if every candidate failed),
    every reading as (config, ms) in the order taken (the plan's repeated),
    and the plan's median ms and spread (max - min of its readings; nan
    where the plan did not run)."""

    config: Optional[BlockConfig]
    ms: float
    tried: list
    plan_ms: float = float("nan")
    plan_spread: float = float("nan")


def _order_and_cap(cands: Iterable[BlockConfig]) -> list:
    """Candidates without repeats, in order (the plan first), cut to
    ``FFPA_TORCH_AUTOTUNE_MAX_CONFIGS`` where it is set."""
    out: list = []
    for c in cands:
        if c not in out:
            out.append(c)
    cap = ENV.autotune_max_configs()
    return out[:cap] if cap > 0 else out


def ring_caps(deepest: int, least: int) -> list:
    """Ring caps from the plan's ``deepest`` down: 0 (the plan's depth),
    then deepest - 1 down to ``least``, the fewest stages the walk needs."""
    return [0] + list(range(deepest - 1, least - 1, -1))


def _pad(x: int) -> int:
    return cdiv(x, D_CHUNK) * D_CHUNK


def _bwd_base(d: int, dv: int, nkv: int, itemsize: int) -> BlockConfig:
    """The backward config the dispatch picks with no store and no e4m3
    (``dispatch.pick_backward_config``'s default)."""
    from ..ops.dispatch import FROM_S_DK_IN_MAX_NKV

    return BlockConfig(dkdv_dk_in_kernel=nkv <= FROM_S_DK_IN_MAX_NKV
                       and from_s_fits(d, dv, True, itemsize))


def bwd_candidates(d: int, dv: int, nq: int, nkv: int, dtype: torch.dtype, has_bias: bool,
                   *, from_scores: bool, f16: bool = False) -> list:
    """Backward candidates of the tier the step runs: ``from_scores`` the
    from-S pass's ring (its wgmma routes; the mma.sync one has none), else
    the dK/dV and dQ pair's (one cap for both, each kernel held to its own
    least by ``config.ring_depth``; the pair's least is 3, DKDV_MIN_STAGES
    and DQ_MIN_STAGES alike). e4m3 dS storage is offered beside each
    cap off the from-S tier where ``dispatch.fp8_ds_allowed`` (the flag,
    bf16, no fp16 cotangent ``f16``, no bias, Nq * Nkv large enough)."""
    from ..ops.dispatch import fp8_ds_allowed

    itemsize = torch.empty((), dtype=dtype).element_size()
    base = _bwd_base(d, dv, nkv, itemsize)
    d_pad, dv_pad = _pad(d), _pad(dv)
    if from_scores:
        plan = from_s_plan(dv_pad, base.dkdv_dk_in_kernel, itemsize)
        caps = ([0] if plan.route == "mma_sync"
                else ring_caps(plan.stages, from_s_min_stages(dv_pad)))
        bits = (16,)
    else:
        deepest = max(dkdv_plan(d_pad, dv_pad, itemsize).stages,
                      dq_plan(d_pad, dv_pad, itemsize).stages)
        caps = ring_caps(deepest, DKDV_MIN_STAGES)
        fp8 = fp8_ds_allowed(nq=nq, nkv=nkv, dtype=dtype, has_bias=has_bias, f16=f16)
        bits = (16, 8) if fp8 else (16,)
    return _order_and_cap(replace(base, bwd_ring_cap=c, ds_store_bits=b)
                          for c in caps for b in bits)


def varlen_candidates(d: int, dv: int, dtype: torch.dtype) -> list:
    """Ring caps of the packed backward pair (``pick_varlen_backward_config``
    with ``bwd_ring_cap`` set)."""
    from ..ops.dispatch import pick_varlen_backward_config

    itemsize = torch.empty((), dtype=dtype).element_size()
    d_pad, dv_pad = _pad(d), _pad(dv)
    base = pick_varlen_backward_config(d=d_pad, dv=dv_pad, dtype=dtype)
    deepest = max(varlen_dkdv_plan(d_pad, dv_pad, itemsize).stages,
                  varlen_dq_plan(d_pad, dv_pad, itemsize).stages)
    caps = ring_caps(deepest, DKDV_MIN_STAGES)
    return _order_and_cap(replace(base, bwd_ring_cap=c) for c in caps)


class _Timeout(Exception):
    pass


def search(time_config: Callable[[BlockConfig], float], candidates: Iterable[BlockConfig],
           label: str = "") -> Found:
    """Time the candidates (``time_config(cfg)`` -> ms), the first being the
    plan, skipping one that raises or runs past
    ``FFPA_TORCH_AUTOTUNE_CANDIDATE_TIMEOUT`` seconds (default 420;
    SIGALRM, on the main thread only). The plan is timed again after each
    other candidate, so the two alternate. The fastest candidate wins only
    if it beats the plan's median by more than the plan's spread and by
    ``MIN_GAIN`` of it; else the plan wins at its median. Where the plan
    itself fails, the fastest candidate wins."""
    deadline = int(os.environ.get("FFPA_TORCH_AUTOTUNE_CANDIDATE_TIMEOUT", "420"))

    def _alarm(signum, frame):
        raise _Timeout()

    tried: list = []

    def timed(cfg) -> Optional[float]:
        use_alarm = deadline > 0 and threading.current_thread() is threading.main_thread()
        if use_alarm:
            old = signal.signal(signal.SIGALRM, _alarm)
            signal.alarm(deadline)
        try:
            ms = float(time_config(cfg))
        except _Timeout:
            logger.warning("autotune[%s]: config %s exceeded %ds deadline; skipped", label, cfg,
                           deadline)
            return None
        except Exception as exc:  # a launch the card refuses: skip it
            logger.warning("autotune[%s]: config %s failed: %s", label, cfg, str(exc)[:200])
            return None
        finally:
            if use_alarm:
                signal.alarm(0)
                signal.signal(signal.SIGALRM, old)
        logger.info("autotune[%s]: %s -> %.4f ms", label, cfg, ms)
        tried.append((cfg, ms))
        return ms

    cands = list(candidates)
    if not cands:
        return Found(None, float("inf"), tried)
    plan, plan_readings, others = cands[0], [], []
    ms = timed(plan)
    if ms is not None:
        plan_readings.append(ms)
    for cfg in cands[1:]:
        ms = timed(cfg)
        if ms is not None:
            others.append((cfg, ms))
        if plan_readings:
            ms = timed(plan)
            if ms is not None:
                plan_readings.append(ms)
    best = min(others, key=lambda x: x[1], default=(None, float("inf")))
    if not plan_readings:
        return Found(best[0], best[1], tried)
    plan_ms = statistics.median(plan_readings)
    spread = max(plan_readings) - min(plan_readings)
    if best[1] < plan_ms - max(spread, MIN_GAIN * plan_ms):
        return Found(best[0], best[1], tried, plan_ms, spread)
    return Found(plan, plan_ms, tried, plan_ms, spread)


def _timers():
    from ..cli import _bench

    return _bench


def autotune_forward(q, k, v, bias, *, scale, is_causal, dropout_p=0.0, mode="fast") -> Found:
    """The forward's plan alone, timed: its ring is fixed at compile time
    (``csrc/flash_fwd.cu`` ``stages_of``), so the entry records the plan's
    time as ``verify``'s baseline."""
    del mode
    from ..ops.config import default_config
    from ..ops.flash_fwd import flash_attention_forward

    d, dv, nq, nkv = q.shape[-1], v.shape[-1], q.shape[2], k.shape[2]
    cands = _order_and_cap([default_config(d, dv, nq, nkv, itemsize=q.element_size())])

    def time_config(cfg):
        return _timers().time_fwd(
            lambda: flash_attention_forward(q, k, v, bias, scale=scale, is_causal=is_causal,
                                            dropout_p=dropout_p, config=cfg),
            device=q.device)

    return search(time_config, cands, label=f"fwd d={d} n=({nq},{nkv})")


def backward_uses_scores(q, k, v, bias, *, scale, is_causal, dropout_p=0.0) -> bool:
    """Whether the training step's backward at these inputs takes the
    S-resident tier (the residency policy of ``ops/attention.py``)."""
    from ..ops.attention import StaticArgs, _should_save_scores

    static = StaticArgs(scale=scale, is_causal=is_causal, dropout_p=dropout_p, fwd_config=None)
    return _should_save_scores(static, q, k, v, bias)


def autotune_backward(q, k, v, bias, *, scale, is_causal, dropout_p=0.0, mode="fast") -> Found:
    """Time the backward tier the step runs (``backward_uses_scores``) at
    each of ``bwd_candidates``: a forward (with the S residual on the
    S-resident tier) then the timed backward, per iteration."""
    from ..ops.flash_bwd import flash_attention_backward
    from ..ops.flash_fwd import flash_attention_forward

    d, dv, nq, nkv = q.shape[-1], v.shape[-1], q.shape[2], k.shape[2]
    use_scores = backward_uses_scores(q, k, v, bias, scale=scale, is_causal=is_causal,
                                      dropout_p=dropout_p)
    f16 = q.dtype == torch.float16
    del mode
    cands = bwd_candidates(d, dv, nq, nkv, q.dtype, bias is not None, from_scores=use_scores,
                           f16=f16)
    do = torch.ones((*q.shape[:3], dv), dtype=q.dtype, device=q.device)
    kw = dict(scale=scale, is_causal=is_causal, dropout_p=dropout_p)

    def prepare(cfg):
        def run_forward():
            out = flash_attention_forward(q, k, v, bias, return_scores=use_scores, **kw)
            o, lse = out[0], out[1]
            scores = out[2] if use_scores else None
            return lambda: flash_attention_backward(q, k, v, bias, o, lse, do, config=cfg,
                                                    scores=scores, **kw)
        return run_forward

    def time_config(cfg):
        return _timers().time_bwd(prepare(cfg), device=q.device)

    return search(time_config, cands, label=f"bwd d={d} n=({nq},{nkv}) sres={use_scores}")


def autotune_decode(q, k, v, *, scale, mode="fast") -> Found:
    """The decode kernel at its rule's split count alone, timed with the
    host's enqueue off the clock: the entry records the plan's time as
    ``verify``'s baseline."""
    del mode
    from ..ops.decode import _decode_forward

    d, nkv = q.shape[-1], k.shape[2]

    def time_config(cfg):
        return _timers().time_queued(
            lambda: _decode_forward(q, k, v, None, scale=scale, is_causal=False),
            device=q.device)

    return search(time_config, [BlockConfig()], label=f"decode d={d} nkv={nkv}")


def autotune_varlen(q3, k3, v3, cu, max_seqlen, *, scale, causal=True, mode="fast") -> Found:
    """Time the packed forward plus backward (metadata and tile schedule
    included, as a call computes them) at each of ``varlen_candidates``."""
    del max_seqlen, mode
    from ..ops.varlen import _call_metadata, _call_walk, _varlen_backward, _varlen_forward

    t, d, dv = q3.shape[0], q3.shape[-1], v3.shape[-1]
    cands = varlen_candidates(d, dv, q3.dtype)
    do = torch.ones((t, q3.shape[1], dv), dtype=q3.dtype, device=q3.device)
    window = (-1, -1)

    def step(cfg):
        meta = _call_metadata(cu, cu, t, k3.shape[0], q3.device)
        walk = _call_walk(meta, t, causal, window)
        o, lse = _varlen_forward(q3, k3, v3, cu, cu, scale=scale, causal=causal, meta=meta,
                                 walk=walk)
        return _varlen_backward(q3, k3, v3, o, lse, do, meta, scale=scale, causal=causal,
                                config=cfg, walk=walk)

    def time_config(cfg):
        return _timers().time_fwd(lambda: step(cfg), device=q3.device)

    return search(time_config, cands, label=f"varlen t={t}")


__all__ = ["Found", "MIN_GAIN", "search", "ring_caps", "bwd_candidates", "varlen_candidates",
           "backward_uses_scores", "autotune_forward", "autotune_backward", "autotune_decode",
           "autotune_varlen"]
