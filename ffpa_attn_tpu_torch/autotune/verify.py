"""Verify tool: the stored config the lookup picks against a fresh search.

The counterpart of the JAX package's ``autotune/verify.py``. For each case
it times the config the store holds (``stored``: for ``bwd`` the one the
dispatch picks, for ``fwd``, whose calls read no entry, the entry itself),
the config with no store (``plan``: the kill-switch set) and the winner of
a fresh search (``fresh``), and reports whether the stored entry agrees with
the fresh winner and whether it beats the plan. A backward case also holds
the stored config's dQ, taken through ``ffpa_attn_func`` (whose dispatch
resolves the same entry), against the query-chunked fp32 composite
(``cli/_bench.py`` ``chunked_sdpa`` on fp32 copies of the inputs), at 5e-2
for bf16 and 1e-2 for fp16; a miss raises.

Run on the card: ``python -m ffpa_attn_tpu_torch.autotune.verify
--headdims 512 --seqlens 4096 --directions fwd bwd``.
"""

from __future__ import annotations

import argparse
import contextlib
import os

import torch

from ..logger import init_logger

logger = init_logger(__name__)

DQ_TOL = {torch.bfloat16: 5e-2, torch.float16: 1e-2}


@contextlib.contextmanager
def untuned():
    """The store's kill-switch set inside the block."""
    before = os.environ.get("FFPA_TORCH_SKIP_TUNED_CONFIG")
    os.environ["FFPA_TORCH_SKIP_TUNED_CONFIG"] = "1"
    try:
        yield
    finally:
        if before is None:
            del os.environ["FFPA_TORCH_SKIP_TUNED_CONFIG"]
        else:
            os.environ["FFPA_TORCH_SKIP_TUNED_CONFIG"] = before


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / (want.float().abs().max() + 1e-9))


def dq_numerics(q, k, v, do, *, causal: bool) -> float:
    """max|dQ - dQ_ref| / max|dQ_ref| of ``ffpa_attn_func`` (default
    dispatch: the tuned lookup) against the chunked fp32 composite."""
    from ..cli._bench import chunked_sdpa
    from ..interface import ffpa_attn_func

    def dq_of(fn, *xs):
        xs = [x.detach().clone().requires_grad_(True) for x in xs]
        out = fn(*xs)
        (dq,) = torch.autograd.grad((out.float() * do.float()).sum(), xs[0])
        return dq

    got = dq_of(lambda a, b, c: ffpa_attn_func(a, b, c, is_causal=causal), q, k, v)
    want = dq_of(lambda a, b, c: chunked_sdpa(a, b, c, None, causal=causal),
                 q.float(), k.float(), v.float())
    return _rel(got, want)


def verify_case(d: int, n: int, causal: bool, dtype_name: str, mode: str = "fast",
                direction: str = "fwd", device=None) -> dict:
    """One case at B1 H8: stored, plan and fresh configs and their ms (and
    the backward's dQ numerics gate)."""
    from ..cli import _bench
    from ..env import resolve_device
    from ..ops.dispatch import pick_backward_config, pick_forward_config
    from .store import lookup_tuned_config
    from ..ops.flash_bwd import flash_attention_backward
    from ..ops.flash_fwd import flash_attention_forward
    from .search import autotune_backward, autotune_forward, backward_uses_scores

    dev = resolve_device(device)
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = (torch.randn((1, 8, n, d), generator=gen, device=dev, dtype=dtype)
                   for _ in range(4))
    scale = 1.0 / d ** 0.5
    common = dict(d=d, dv=d, nq=n, nkv=n, dtype=dtype, causal=causal)
    numerics_rel = None
    if direction == "fwd":
        plan = pick_forward_config(d=d, dv=d, nq=n, nkv=n, dtype=dtype)
        stored = lookup_tuned_config(direction="fwd", d=d, nq=n, nkv=n, dtype=dtype_name,
                                     causal=causal, has_bias=False, dropout=False, gqa=False,
                                     same_head_dims=True) or plan
        found = autotune_forward(q, k, v, None, scale=scale, is_causal=causal, mode=mode)

        def run_with(cfg):
            return _bench.time_fwd(lambda: flash_attention_forward(
                q, k, v, None, scale=scale, is_causal=causal, config=cfg), device=dev)
    else:
        stored = pick_backward_config(**common)
        with untuned():
            plan = pick_backward_config(**common)
        found = autotune_backward(q, k, v, None, scale=scale, is_causal=causal, mode=mode)
        use_scores = backward_uses_scores(q, k, v, None, scale=scale, is_causal=causal)

        def run_with(cfg):
            def prepare():
                out = flash_attention_forward(q, k, v, None, scale=scale, is_causal=causal,
                                              return_scores=use_scores)
                scores = out[2] if use_scores else None
                return lambda: flash_attention_backward(q, k, v, None, out[0], out[1], do,
                                                        scale=scale, is_causal=causal,
                                                        config=cfg, scores=scores)
            return _bench.time_bwd(prepare, device=dev)

        numerics_rel = dq_numerics(q, k, v, do, causal=causal)
        if numerics_rel >= DQ_TOL[dtype]:
            raise RuntimeError(f"verify NUMERICS FAILED d={d} n={n} causal={causal} "
                               f"{direction}: dq rel={numerics_rel:.4f} >= {DQ_TOL[dtype]}")
    stored_ms, plan_ms = run_with(stored), run_with(plan)
    result = {
        "d": d, "n": n, "causal": causal, "dtype": dtype_name, "direction": direction,
        "stored_config": str(stored), "plan_config": str(plan), "fresh_config": str(found.config),
        "stored_ms": stored_ms, "plan_ms": plan_ms, "fresh_ms": found.ms,
        "agree": found.config is not None and stored == found.config,
        "stored_vs_fresh": stored_ms / found.ms if found.ms else float("nan"),
        "stored_vs_plan": stored_ms / plan_ms if plan_ms else float("nan"),
        "numerics_rel": numerics_rel,
    }
    logger.info("verify %s d=%d n=%d causal=%s: stored %.4f ms, plan %.4f ms, fresh %.4f ms "
                "(%s)%s", direction, d, n, causal, stored_ms, plan_ms, found.ms,
                "AGREE" if result["agree"] else "DIFFER",
                "" if numerics_rel is None else f" dq_rel={numerics_rel:.4f}")
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m ffpa_attn_tpu_torch.autotune.verify")
    parser.add_argument("--headdims", type=int, nargs="*", default=[512])
    parser.add_argument("--seqlens", type=int, nargs="*", default=[4096])
    parser.add_argument("--dtypes", nargs="*", default=["bfloat16"],
                        choices=["bfloat16", "float16"])
    parser.add_argument("--directions", nargs="*", default=["fwd"], choices=["fwd", "bwd"])
    parser.add_argument("--mode", choices=["fast", "max"], default="fast")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card); cpu runs the plain path")
    args = parser.parse_args(argv)
    worst = 1.0
    for d in args.headdims:
        for n in args.seqlens:
            for dtype in args.dtypes:
                for direction in args.directions:
                    for causal in (False, True):
                        res = verify_case(d, n, causal, dtype, args.mode, direction, args.device)
                        worst = max(worst, res["stored_vs_fresh"])
    logger.info("worst stored/fresh ratio: %.3f", worst)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
