"""The varlen kernels' tile schedules for a packing, and the work they imply.

Run from the repository root (no card needed):

    python tools/torch_varlen_schedule.py [--lens 589,698,763,886] [--block-q 64]

For causal self-attention over prompts of the given lengths, prints the
JAX package's schedule: each Q tile's [jmin, jmax] interval of 64-key
tiles (``ops/varlen.py`` ``_tile_needed`` and ``_interval_schedule`` at
``--block-q`` rows), every KV tile of those intervals, the tiles that
``_tile_needed`` marks needed inside them, and the (row, col) pairs each
covers against the causal band's pairs; then the forward kernel's walk (at
every width only the needed tiles at 64 x 64, ``_needed_tiles``), its
tiles per Q tile and the 64 x 32 consumer blocks its full-block test
(``_full_blocks`` at 64 x 32) lets skip the mask. Then the backward's
(``_backward_schedules`` on the forward's saved walk, at every width):
the pairs the dK/dV kernel walks at its 64 x 64 tiles (each KV
tile's [imin, imax] of Q tiles, the needed matrix transposed), with the
needed tiles inside the intervals and those the consumers' full-block
test (``_dkdv_full_blocks``: one segment, inside the band) lets skip the
mask; and dQ's walk (the needed tiles at 64 x 64, ``dq_wgmma``, with its
full 64 x 32 consumer blocks), against the band.
Prints one JSON line. The default lengths are the serving bench's; the packed-training
packing of ``chip_smoke.py`` is ``--lens
2048,1536,1200,1024,900,700,500,284``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ffpa_attn_tpu_torch.ops import varlen  # noqa: E402
from ffpa_attn_tpu_torch.ops.config import (  # noqa: E402
    KV_TILE, varlen_dkdv_plan, varlen_dq_plan,
)
from ffpa_attn_tpu_torch.utils.profiling import band_pairs  # noqa: E402


def _walked(lo, hi) -> int:
    return int((hi - lo + 1).sum())


def _spread(lo, hi) -> dict:
    """min, max and mean of the tiles each block's interval walks."""
    n = (hi - lo + 1).float()
    return {"min": int(n.min()), "max": int(n.max()), "mean": float(n.mean())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lens", default="589,698,763,886")
    ap.add_argument("--block-q", type=int, default=64)
    args = ap.parse_args()
    lens = [int(x) for x in args.lens.split(",") if x]
    bq, t = args.block_q, sum(lens)
    cu = torch.tensor([0] + torch.tensor(lens).cumsum(0).tolist(), dtype=torch.int32)
    meta = varlen._call_metadata(cu, cu, t, t, "cpu")
    needed = varlen._tile_needed(*varlen._q_tiles(meta, t, bq), bq, KV_TILE, True)
    lo, hi = varlen._interval_schedule(needed)
    walked = _walked(lo, hi)
    inside = int(sum(needed[i, lo[i]:hi[i] + 1].sum() for i in range(len(lo))))
    band = sum(band_pairs(n, n, causal=True) for n in lens)
    (imin, imax, _), _ = varlen._backward_schedules(
        meta, t, varlen_dkdv_plan(1024, 1024), varlen_dq_plan(1024, 1024), True, (-1, -1))
    pairs = _walked(imin, imax) * 64 * 64
    need = varlen._tile_needed(*meta, 64, 64, True).T  # [kv tile, q tile]
    walk = torch.zeros_like(need)  # the tiles the intervals walk
    for j in range(need.shape[0]):
        walk[j, imin[j]:imax[j] + 1] = True
    halves = varlen._dkdv_full_blocks(meta, True)  # [kv tile, 32-column block]
    full = halves.reshape(halves.shape[0], -1, 2).all(dim=2)
    dkdv = {"64x64": {
        "pairs_walked_per_head": pairs, "walked_over_band": pairs / band,
        "q_tiles_per_block": _spread(imin, imax), "tiles_walked": int(walk.sum()),
        "tiles_needed": int((need & walk).sum()), "tiles_full": int((full & walk).sum()),
        "consumer_blocks_full": int((halves & walk.repeat_interleave(2, dim=1)).sum())}}
    # The wgmma forward's walk: only the needed tiles at 64 x 64.
    wmeta = varlen._q_tiles(meta, t, 64)
    wneed = varlen._tile_needed(*wmeta, 64, KV_TILE, True)
    wlo, whi = varlen._interval_schedule(wneed)
    tiles, count, _ = varlen._needed_tiles(wneed)
    halves = varlen._full_blocks(wmeta, 64, 32, True)  # [Q tile, 32-column block]
    walked_halves = torch.zeros_like(halves)
    for i in range(tiles.shape[0]):
        for j in tiles[i, :int(count[i])].tolist():
            walked_halves[i, 2 * j:2 * j + 2] = True
    fwd_wgmma = {
        "tiles": f"64x{KV_TILE}", "q_tiles": int(count.shape[0]),
        "interval_tiles": _walked(wlo, whi), "kv_tiles_walked": int(count.sum()),
        "walked_over_band": int(count.sum()) * 64 * KV_TILE / band,
        "interval_over_band": _walked(wlo, whi) * 64 * KV_TILE / band,
        "kv_tiles_per_q_tile": {"min": int(count.min()), "max": int(count.max()),
                                "mean": float(count.float().mean())},
        "consumer_blocks_walked": int(walked_halves.sum()),
        "consumer_blocks_full": int((halves & walked_halves).sum()),
    }
    # dQ's walk: the forward's lists (saved at every width), read through
    # the backward's schedule: the same tiles and full blocks as the
    # forward's walk.
    saved = varlen._call_walk(meta, t, True, (-1, -1))
    (imin_s, imax_s, _), (dtiles, dcount, _) = varlen._backward_schedules(
        meta, t, varlen_dkdv_plan(512, 512), varlen_dq_plan(512, 512), True, (-1, -1), saved)
    assert torch.equal(dtiles, tiles) and torch.equal(dcount, count)
    assert torch.equal(imin_s, imin) and torch.equal(imax_s, imax)
    dq_wgmma = {
        "tiles": f"64x{KV_TILE}", "kv_tiles_walked": int(dcount.sum()),
        "walked_over_band": int(dcount.sum()) * 64 * KV_TILE / band,
        "interval_tiles_at_64_rows": _walked(wlo, whi),
        "kv_tiles_per_q_tile": {"min": int(dcount.min()), "max": int(dcount.max()),
                                "mean": float(dcount.float().mean())},
        "empty_q_tiles": int((dcount == 0).sum()),
        "consumer_blocks_walked": int(walked_halves.sum()),
        "consumer_blocks_full": int((halves & walked_halves).sum()),
    }
    print(json.dumps({
        "lens": lens, "block_q": bq, "kv_tile": KV_TILE, "q_tiles": len(lo),
        "intervals": list(zip(lo.tolist(), hi.tolist())),
        "kv_tiles_walked": walked, "kv_tiles_needed": inside,
        "pairs_walked_per_head": walked * bq * KV_TILE,
        "pairs_needed_tiles_per_head": inside * bq * KV_TILE,
        "band_pairs_per_head": band,
        "walked_over_band": walked * bq * KV_TILE / band,
        "needed_over_band": inside * bq * KV_TILE / band,
        "fwd_wgmma": fwd_wgmma,
        "dkdv": dkdv,
        "dq_wgmma": dq_wgmma,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
