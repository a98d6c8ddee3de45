"""The varlen forward's tile schedule for a packing, and the work it implies.

Run from the repository root (no card needed):

    python tools/torch_varlen_schedule.py [--lens 589,698,763,886] [--block-q 64]

For causal self-attention over prompts of the given lengths, prints each Q
tile's [jmin, jmax] interval of 64-key tiles (``ops/varlen.py``
``_tile_needed`` and ``_interval_schedule``, the JAX package's schedule, at
the kernel's tiles), the KV tiles the kernel walks, the tiles that
``_tile_needed`` marks needed inside those intervals, and the (row, col)
pairs each covers against the causal band's pairs. Prints one JSON line.
The default lengths are the serving bench's (``chip_smoke.py``).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ffpa_attn_tpu_torch.ops import varlen  # noqa: E402
from ffpa_attn_tpu_torch.ops.config import KV_TILE, cdiv  # noqa: E402
from ffpa_attn_tpu_torch.utils.profiling import band_pairs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lens", default="589,698,763,886")
    ap.add_argument("--block-q", type=int, default=64)
    args = ap.parse_args()
    lens = [int(x) for x in args.lens.split(",") if x]
    bq, t = args.block_q, sum(lens)
    cu = torch.tensor([0] + torch.tensor(lens).cumsum(0).tolist(), dtype=torch.int32)
    meta = varlen._segment_metadata(cu, cu, t, t, cdiv(t, bq) * bq, cdiv(t, KV_TILE) * KV_TILE)
    needed = varlen._tile_needed(*meta, bq, KV_TILE, True)
    lo, hi = varlen._interval_schedule(needed)
    walked = int((hi - lo + 1).sum())
    inside = int(sum(needed[i, lo[i]:hi[i] + 1].sum() for i in range(len(lo))))
    band = sum(band_pairs(n, n, causal=True) for n in lens)
    print(json.dumps({
        "lens": lens, "block_q": bq, "kv_tile": KV_TILE, "q_tiles": len(lo),
        "intervals": list(zip(lo.tolist(), hi.tolist())),
        "kv_tiles_walked": walked, "kv_tiles_needed": inside,
        "pairs_walked_per_head": walked * bq * KV_TILE,
        "pairs_needed_tiles_per_head": inside * bq * KV_TILE,
        "band_pairs_per_head": band,
        "walked_over_band": walked * bq * KV_TILE / band,
        "needed_over_band": inside * bq * KV_TILE / band,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
