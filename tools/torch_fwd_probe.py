"""Probe how the forward kernel's time scales, on a machine with a card.

Run from the repository root: ``python tools/torch_fwd_probe.py``.
``--schedule`` prints only the block-order model below and needs no card.

Times ``flash_attention_forward`` (device time per call from torch.profiler)
at B1 H8/4 N4096 bf16 over head dims 64…1024, causal and not, and the
mma.sync route's row tiles (the wgmma route, D <= 512, always takes 64
rows: one case), and prints one JSON line per case with its route and the
block-tile iterations
the launch runs (64-row KV tiles summed over blocks), so the cost per
iteration, per head-dim chunk and per block can be read apart.

First it prints a list-scheduling model of the causal grid at the prefill
shape: the makespan, in KV-tile times, of the forward's 512 blocks dispatched
in a given order onto 132 SMs holding one block each (each block's time
taken as its number of KV tiles), for the query tile varying fastest and for
the head varying fastest.
"""

from __future__ import annotations

import argparse
import heapq
import json
import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ffpa_attn_tpu_torch.ops import flash_fwd  # noqa: E402
from ffpa_attn_tpu_torch.ops.config import (  # noqa: E402
    FWD_ROW_TILES, BlockConfig, cdiv, fwd_fits,
)
from ffpa_attn_tpu_torch.utils.profiling import device_ms  # noqa: E402


def tile_iterations(n: int, bq: int, causal: bool, heads: int) -> int:
    per_head = 0
    for i in range(cdiv(n, bq)):
        last = min(n, (i + 1) * bq) - 1
        per_head += cdiv(last + 1, 64) if causal else cdiv(n, 64)
    return per_head * heads


def makespan(durations, slots: int) -> int:
    """Finish time of blocks started in order, each on the first free slot."""
    free = [0] * slots
    for d in durations:
        heapq.heappush(free, heapq.heappop(free) + d)
    return max(free)


def schedule_model(n: int = 4096, bq: int = 64, heads: int = 8, sms: int = 132) -> dict:
    tiles = cdiv(n, bq)
    kv = [cdiv(min(n, (t + 1) * bq), 64) for t in reversed(range(tiles))]  # longest first
    return dict(
        model="causal forward block order", n=n, block_q=bq, heads=heads, sms=sms,
        ideal=sum(kv) * heads / sms,
        query_tile_fastest=makespan([k for _ in range(heads) for k in kv], sms),
        head_fastest=makespan([k for k in kv for _ in range(heads)], sms),
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--schedule", action="store_true", help="print the block-order model only")
    args = ap.parse_args()
    print(json.dumps(schedule_model()), flush=True)
    if args.schedule:
        return 0
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, hq, hkv = 4096, 8, 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for d in (64, 128, 256, 512, 1024):
        q = torch.randn((1, hq, n, d), generator=gen, device="cuda").bfloat16()
        k = torch.randn((1, hkv, n, d), generator=gen, device="cuda").bfloat16()
        v = torch.randn((1, hkv, n, d), generator=gen, device="cuda").bfloat16()
        for causal in (True, False):
            plan = flash_fwd.fwd_kernel_plan(d, d)
            tiles = (plan.q_rows,) if plan.route == "wgmma" else FWD_ROW_TILES
            for bq in tiles:
                cfg = BlockConfig(block_q=bq)
                if not fwd_fits(cfg, d, d):
                    continue
                ms = device_ms(lambda: flash_fwd.flash_attention_forward(
                    q, k, v, None, scale=1 / math.sqrt(d), is_causal=causal, config=cfg), reps=5)
                its = tile_iterations(n, bq, causal, hq)
                print(json.dumps(dict(
                    d=d, causal=causal, route=plan.route, block_q=bq, ms=ms,
                    tile_iterations=its,
                    us_per_iteration_per_sm=ms * 1e3 * sms / its,
                    tflops=its * bq * 64 * 2 * (d + d) / (ms * 1e-3) / 1e12,
                )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
