"""The headline line: ``python -m ffpa_attn_tpu_torch.cli._headline``.

One JSON line on the card: self-attn forward, B1 H32 N8192 D512 bf16, as
FFPA TFLOP/s (``value``) and its speedup over the faster stock baseline
(``vs_baseline``); beside it the causal backward at the same shape
(``bwd_causal_tflops``, ``bwd_causal_vs_baseline``). Both are gated on
correctness before they are timed. Without a card it prints the error line
and exits 1.
"""

from __future__ import annotations

import json
import os
import sys

METRIC = "ffpa_fwd_tflops_d512_n8192_bf16"


def main() -> int:
    import torch

    from ..env import resolve_device
    from ._bench import make_case, run_case

    try:
        device = resolve_device(None)
    except RuntimeError as exc:
        print(json.dumps({"metric": METRIC, "value": 0.0, "unit": "TFLOPS",
                          "vs_baseline": 0.0, "error": str(exc)}))
        return 1
    # A single attention call per step, as the bench CLI declares it.
    os.environ.setdefault("FFPA_TORCH_SCORES_AUTO_ASSUMED_LAYERS", "1")
    row = run_case(make_case("self-attn", 1, 32, 8192, 512), torch.bfloat16, "fwd",
                   warmup=2, iters=10, device=device)
    out = {
        "metric": METRIC,
        "value": round(row["ffpa_tflops"], 2),
        "unit": "TFLOPS",
        "vs_baseline": round(row["speedup"], 3),
    }
    # The causal backward folded into the same line; an error there is
    # reported in the line and does not take the forward's number with it.
    try:
        brow = run_case(make_case("causal", 1, 32, 8192, 512), torch.bfloat16, "bwd",
                        warmup=2, iters=10, device=device)
        out["bwd_causal_tflops"] = round(brow["ffpa_tflops"], 2)
        out["bwd_causal_vs_baseline"] = round(brow["speedup"], 3)
    except Exception as exc:
        out["bwd_causal_error"] = str(exc)[:120]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
