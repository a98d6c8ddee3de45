"""Probe how the forward kernel's time scales, on a machine with a card.

Run from the repository root: ``python tools/torch_fwd_probe.py``.
``--schedule`` prints only the block-order model below and needs no card.

Times ``flash_attention_forward`` (device time per call from torch.profiler)
at B1 H8/4 N4096 bf16 over head dims 64…1024, causal and not (both routes
take 64 Q rows), and prints one JSON line per case with its route and the
block-tile iterations the launch runs (64-row KV tiles summed over blocks),
so the cost per iteration, per head-dim chunk and per block can be read
apart.

``--dsweep`` instead times the bench's D sweep shapes (B1 H32 N8192, D 512,
640 and 1024, causal and not, ``--dtype`` bf16 or fp16): the kernel (device
ms of the forward kernel by name, and CUDA-event ms), its plain version,
``scaled_dot_product_attention`` (with the backend torch takes) and the
bound, one JSON line each, the card's name and power limit first.

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
from ffpa_attn_tpu_torch.ops.config import cdiv  # noqa: E402
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


def dsweep(dtype: torch.dtype) -> None:
    """The bench's D sweep shapes: kernel, plain version, SDPA, bound."""
    import subprocess

    import torch.nn.functional as F

    from ffpa_attn_tpu_torch.cli._bench import sdpa_backend
    from ffpa_attn_tpu_torch.utils.profiling import band_pairs, bound_ms, cuda_ms, device_window

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps(dict(card=smi)), flush=True)
    b, h, n = 1, 32, 8192
    gen = torch.Generator(device="cuda").manual_seed(0)
    for d in (512, 640, 1024):
        q, k, v = (torch.randn((b, h, n, d), generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        for causal in (False, True):
            kw = dict(scale=1 / math.sqrt(d), is_causal=causal)

            def run():
                return flash_fwd.flash_attention_forward(q, k, v, None, **kw)

            def plain():
                return flash_fwd.flash_attention_forward_plain(q, k, v, None, **kw)

            def sdpa():
                return F.scaled_dot_product_attention(q, k, v, is_causal=causal)

            o, _ = run()
            po, _ = plain()
            err = float(((o.float() - po.float()).abs().amax(-1)
                         / po.float().abs().amax(-1).clamp_min(1e-30)).max())
            del o, po
            w = device_window(run, reps=5, warmup=1)
            kms = sum(ms for name, ms in w["by_kernel"].items()
                      if any(x in name for x in flash_fwd.FWD_KERNELS)) / 5
            flops = 2 * b * h * band_pairs(n, n, causal=causal) * (d + d)
            bms, bby = bound_ms(flops, 2 * 4 * b * h * n * d + 4 * b * h * n)
            print(json.dumps(dict(
                d=d, causal=causal, dtype=str(dtype)[6:],
                route=flash_fwd.fwd_kernel_plan(d, d).route, kernel_ms=kms,
                kernel_event_ms=cuda_ms(run, reps=5, warmup=1), tflops=flops / kms / 1e9,
                bound_ms=bms, bound_by=bby, plain_ms=cuda_ms(plain, reps=2, warmup=1),
                library_ms=cuda_ms(sdpa, reps=3, warmup=1),
                library=f"scaled_dot_product_attention ({sdpa_backend(q, k, v, is_causal=causal)})",
                row_rel_err_vs_plain=err,
            )), flush=True)
            torch.cuda.empty_cache()
        del q, k, v


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--schedule", action="store_true", help="print the block-order model only")
    ap.add_argument("--dsweep", action="store_true",
                    help="time the bench's D sweep shapes beside plain, SDPA and the bound")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float16"))
    args = ap.parse_args()
    if not args.dsweep:
        print(json.dumps(schedule_model()), flush=True)
    if args.schedule:
        return 0
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    if args.dsweep:
        dsweep(getattr(torch, args.dtype))
        return 0
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, hq, hkv = 4096, 8, 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for d in (64, 128, 256, 512, 640, 1024):
        q = torch.randn((1, hq, n, d), generator=gen, device="cuda").bfloat16()
        k = torch.randn((1, hkv, n, d), generator=gen, device="cuda").bfloat16()
        v = torch.randn((1, hkv, n, d), generator=gen, device="cuda").bfloat16()
        for causal in (True, False):
            plan = flash_fwd.fwd_kernel_plan(d, d)
            ms = device_ms(lambda: flash_fwd.flash_attention_forward(
                q, k, v, None, scale=1 / math.sqrt(d), is_causal=causal), reps=5)
            its = tile_iterations(n, plan.q_rows, causal, hq)
            print(json.dumps(dict(
                d=d, causal=causal, route=plan.route, q_rows=plan.q_rows, ms=ms,
                tile_iterations=its,
                us_per_iteration_per_sm=ms * 1e3 * sms / its,
                tflops=its * plan.q_rows * 64 * 2 * (d + d) / (ms * 1e-3) / 1e12,
            )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
