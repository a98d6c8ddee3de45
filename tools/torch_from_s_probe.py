"""Device times of the from-S dK/dV pass of the S-resident backward over
sequence lengths and head dims: its two variants (the input of the dispatch
rule ``BlockConfig.dkdv_dk_in_kernel``, ``ops/dispatch.py``), the route each
takes, and where the time of a whole S-resident backward goes.

Run on a machine with a card, from the repository root:

    python tools/torch_from_s_probe.py [--n 1024,2048,4096,8192] [--d 320,512]
        [--heads 8,4] [--rows]

At each (N, D), causal B1 bf16 with ``--heads`` query / KV heads: the from-S
kernel with dK in the kernel (where it takes D: ``config.from_s_fits``;
``null`` elsewhere), the from-S kernel with dK out of it plus banded dK,
and their difference; each variant's route (``config.from_s_plan``: dK out
of the kernel runs the wgmma kernel at D <= 512 and its 2-CTA cluster
above, dK in it the mma.sync one). Times are device ms per call from
torch.profiler (the from-S kernel alone, not the copy of S each call needs,
since the pass writes dS over S). The S residual and (o, lse) come from the
forward kernel.

``--rows`` adds, at each (N, D) and for causal and non-causal attention,
the device ms of one backward through ``ffpa_attn_func`` (auto residency:
the S-resident tier in bf16), as the bench's bwd rows run it, split into
the from-S kernel, banded dK, banded dQ, the rest of the port's kernels and
everything else (PyTorch's products and casts), with the from-S share.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ffpa_attn_tpu_torch import ffpa_attn_func  # noqa: E402
from ffpa_attn_tpu_torch.cli._bench import is_port_kernel  # noqa: E402
from ffpa_attn_tpu_torch.ops import flash_bwd, flash_fwd  # noqa: E402
from ffpa_attn_tpu_torch.ops.config import from_s_fits, from_s_plan  # noqa: E402
from ffpa_attn_tpu_torch.ops.dispatch import pick_backward_config  # noqa: E402
from ffpa_attn_tpu_torch.utils.profiling import device_window  # noqa: E402


# The banded dK kernel's name in the profiler: ``banded_dk_kernel`` in trees
# before the wgmma redesign, the dK instantiation of ``band::banded_kernel``
# after it; banded dQ's the other instantiation.
BANDED_DK = ("banded_dk_kernel", "banded_kernel<__nv_bfloat16, true>")
BANDED_DQ = ("banded_dq_kernel", "banded_kernel<__nv_bfloat16, false>")


def kernel_ms(fn, names: tuple, reps: int) -> float:
    """Device ms per call of the kernels whose name holds one of ``names``;
    raises where none ran, so a renamed kernel is not read as 0 ms."""
    w = device_window(fn, reps=reps, warmup=2)["by_kernel"]
    hits = {k: ms for k, ms in w.items() if any(n in k for n in names)}
    if not hits:
        raise RuntimeError(f"no kernel named like {names} ran; the profiler saw {sorted(w)}")
    return sum(hits.values()) / reps


def backward_split(q, k, v, do, causal: bool, reps: int) -> dict:
    """Device ms of one backward through ``ffpa_attn_func`` by kernel group
    (each call runs its own forward outside the window)."""
    def prepare():
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        out = ffpa_attn_func(qg, kg, vg, is_causal=causal, enable_gqa=q.shape[1] != k.shape[1])
        return lambda: torch.autograd.grad(out, (qg, kg, vg), do)

    # One warm-up and up to two windows (device_window profiles again once
    # where the profiler lost every event): each backward consumes its own
    # forward's S residual.
    it = iter([prepare() for _ in range(2 * reps + 1)])
    w = device_window(lambda: next(it)(), reps=reps, warmup=1)["by_kernel"]
    groups = {"from_s": flash_bwd.FROM_S_KERNELS, "banded_dk": BANDED_DK,
              "banded_dq": BANDED_DQ}
    split = dict.fromkeys((*groups, "other_port", "non_port"), 0.0)
    for name, ms in w.items():
        tag = next((g for g, ns in groups.items() if any(n in name for n in ns)), None)
        tag = tag or ("other_port" if is_port_kernel(name) else "non_port")
        split[tag] += ms / reps
    split["total"] = sum(split.values())
    split["from_s_share"] = split["from_s"] / split["total"]
    return {key: round(val, 4) for key, val in split.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", default="1024,2048,4096,8192")
    ap.add_argument("--d", default="320,512")
    ap.add_argument("--heads", default="8,4", help="query heads, KV heads")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rows", action="store_true",
                    help="also split a whole backward through ffpa_attn_func by kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    b = 1
    hq, hkv = (int(x) for x in args.heads.split(","))
    ds = [int(x) for x in args.d.split(",")]
    out, rows = {}, {}
    for d in ds:
        for n in (int(x) for x in args.n.split(",")):
            def randn(*shape):
                return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

            q, k, v, do = randn(b, hq, n, d), randn(b, hkv, n, d), randn(b, hkv, n, d), randn(
                b, hq, n, d)
            scale = 1.0 / math.sqrt(d)
            o, lse, s = flash_fwd.flash_attention_forward(q, k, v, None, scale=scale,
                                                          is_causal=True, return_scores=True)
            delta = (do.float() * o.float()).sum(-1)
            cfg = pick_backward_config(d=d, dv=d, nq=n, nkv=n, dtype=torch.bfloat16)
            kw = dict(scale=scale, is_causal=True, causal_offset=0, dropout_p=0.0,
                      group=hq // hkv, grad_kv_storage_dtype=None)
            t = {}
            for dk_in in (True, False):
                tag = "dk_in" if dk_in else "dk_out"
                if dk_in and not from_s_fits(d, d, True):
                    t[tag] = None
                    continue
                c = dataclasses.replace(cfg, dkdv_dk_in_kernel=dk_in)
                t[tag] = kernel_ms(
                    lambda c=c: flash_bwd._dkdv_from_s_launch(q, v, s.clone(), do, lse, delta,
                                                              0, c, **kw),
                    flash_bwd.FROM_S_KERNELS, args.reps)
            t["banded_dk"] = kernel_ms(lambda: flash_bwd._banded_dk_from_ds(
                s, q, cfg, scale=scale, group=hq // hkv, nq=n, nkv=n, causal_offset=0,
                dk_dtype=torch.bfloat16), BANDED_DK, args.reps)
            t["dk_out_total"] = t["dk_out"] + t["banded_dk"]
            t["in_minus_out"] = None if t["dk_in"] is None else t["dk_in"] - t["dk_out_total"]
            out[f"D{d}_N{n}"] = {key: None if val is None else round(val, 4)
                                 for key, val in t.items()}
            del o, lse, s, delta
            torch.cuda.empty_cache()
            if args.rows:
                for causal in (True, False):
                    rows[f"D{d}_N{n}_{'causal' if causal else 'self'}"] = backward_split(
                        q, k, v, do, causal, reps=3)
                    torch.cuda.empty_cache()
            del q, k, v, do
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    routes = {f"D{d}": {tag: from_s_plan(d, tag == "dk_in").route if from_s_fits(
        d, d, tag == "dk_in") else None for tag in ("dk_in", "dk_out")} for d in ds}
    print(json.dumps({"card": smi, "shape": f"B{b} H{hq}/{hkv} causal bf16", "routes": routes,
                      "device_ms": out, "backward_rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
