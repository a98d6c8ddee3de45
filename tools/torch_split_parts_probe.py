"""Reads a split-KV decode call's device time whole and by launch, many times.

``chip_smoke.py`` holds the dense and the paged decode's total device time
(one profiler window over the call) against the sum of its two launches'
(the walk and the merge, each in a profiler window of its own) and fails
where the total reads below 0.95 of that sum twice. This probe repeats
those readings ``--rounds`` times at the serving step (B4, max_len 1152, 64
tokens into generation; four layers' caches in turn) at D512 and D1024,
for the dense decode and for paged decode over pages of 256 rows, and
counts the rounds whose first reading already falls below that line.

It runs the package and the script of ``--root`` (default: this checkout),
so a second checkout, the parent commit unpacked with ``git archive`` into
a git-ignored directory, is measured with its own code. Compare two trees
only within one call on the card: parent, change, change, parent.

    python tools/torch_split_parts_probe.py [--root DIR] [--rounds 12] \\
        [--json parts.json]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path

import torch


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--rounds", type=int, default=12)
    parser.add_argument("--reps", type=int, default=100)
    parser.add_argument("--json", default=None)
    parser.add_argument("--tag", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_split_parts_probe: needs a CUDA card", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    import ffpa_attn_tpu_torch
    from ffpa_attn_tpu_torch.ops import decode, paged
    from ffpa_attn_tpu_torch.ops._build import build

    if not Path(ffpa_attn_tpu_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {ffpa_attn_tpu_torch.__file__}, not under {root}")
    t0 = time.perf_counter()
    build(("decode", "paged_decode"))
    build_s = time.perf_counter() - t0

    bf = torch.bfloat16
    hq, hkv = cs.SLICE["n_heads"], cs.SLICE["n_kv_heads"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    step_lens = [n + 64 for n in cs.SERVE_LENS]
    cases = {}
    for d in (512, 1024):
        scale = 1.0 / math.sqrt(d)
        caches = [(cs._randn((cs.SERVE_B, hkv, cs.SERVE_MAX_LEN, d), bf, gen),
                   cs._randn((cs.SERVE_B, hkv, cs.SERVE_MAX_LEN, d), bf, gen))
                  for _ in range(cs.SLICE["n_layers"])]
        qd = cs._randn((cs.SERVE_B, hq, 1, d), bf, gen)
        bias = cs._serve_gap_bias(cs.SERVE_MAX_LEN, cs.SERVE_LENS, 64)
        pools = [cs._paged_pools(step_lens, page=cs.SERVE_PAGE, max_len=cs.SERVE_MAX_LEN,
                                 hkv=hkv, d=d, quantized=False, gen=gen)
                 for _ in range(cs.SLICE["n_layers"])]
        it = iter(range(1 << 30))

        def run_dense(qd=qd, bias=bias, caches=caches, it=it, scale=scale):
            kc, vc = caches[next(it) % len(caches)]
            return decode._decode_forward(qd, kc, vc, bias, scale=scale, is_causal=False)

        def run_paged(qd=qd, pools=pools, it=it, scale=scale):
            return paged.paged_decode_attention(qd, pools[next(it) % len(pools)], scale=scale)

        cases[f"decode_d{d}"] = (run_dense, ("decode_tma_kernel",))
        cases[f"paged_decode_d{d}"] = (run_paged, ("paged_tma_kernel",))

    readings = {name: [] for name in cases}
    for _ in range(args.rounds):
        for name, (run, walk) in cases.items():
            total = cs._timed(run, args.reps, warmup=8)[0]
            parts = (cs._kernel_timed(run, walk, args.reps)[0],
                     cs._kernel_timed(run, ("split_merge_kernel",), args.reps)[0])
            readings[name].append([total, parts[0], parts[1]])

    summary = {}
    for name, rows in readings.items():
        ratios = [t / (w + m) for t, w, m in rows]
        sums = [w + m for _, w, m in rows]
        summary[name] = dict(
            total_median=statistics.median(r[0] for r in rows),
            parts_median=statistics.median(sums), parts_min=min(sums), parts_max=max(sums),
            ratio_min=min(ratios), ratio_median=statistics.median(ratios),
            below_095=sum(r < 0.95 for r in ratios), rounds=len(rows))
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    out = dict(tag=args.tag or str(root), root=str(root), card=smi, build_s=build_s,
               reps=args.reps, summary=summary, readings=readings)
    for name, s in summary.items():
        print(f"{out['tag']} {name}: total {s['total_median']:.4f} ms, walk + merge median "
              f"{s['parts_median']:.4f} [{s['parts_min']:.4f}, {s['parts_max']:.4f}] ms, "
              f"total / parts min {s['ratio_min']:.3f} median {s['ratio_median']:.3f}, "
              f"below 0.95 in {s['below_095']} of {s['rounds']} rounds")
    print(smi)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
