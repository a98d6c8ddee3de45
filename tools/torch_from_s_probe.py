"""Device times of the two from-S dK/dV variants of the S-resident backward
over sequence lengths and head dims, the input of the dispatch rule
``BlockConfig.dkdv_dk_in_kernel`` (``ops/dispatch.py``).

Run on a machine with a card, from the repository root:

    python tools/torch_from_s_probe.py [--n 1024,2048,4096,8192] [--d 320,512]

At each (N, D), causal B1 H8/4 bf16: the from-S kernel with dK in the kernel,
the from-S kernel with dK out of it plus banded dK, and their difference;
each variant's route (``config.from_s_plan``: dK out of the kernel at
D <= 512 runs the wgmma kernel, dK in it the mma.sync one).
Times are device ms per call from torch.profiler (the from-S kernel alone,
not the copy of S each call needs, since the pass writes dS over S). The S
residual and (o, lse) come from the forward kernel. Prints one JSON line.
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

from ffpa_attn_tpu_torch.ops import flash_bwd, flash_fwd  # noqa: E402
from ffpa_attn_tpu_torch.ops.config import from_s_plan  # noqa: E402
from ffpa_attn_tpu_torch.ops.dispatch import pick_backward_config  # noqa: E402
from ffpa_attn_tpu_torch.utils.profiling import device_window  # noqa: E402


# The banded dK kernel's name in the profiler: ``banded_dk_kernel`` in trees
# before the wgmma redesign, the dK instantiation of ``band::banded_kernel``
# after it.
BANDED_DK = ("banded_dk_kernel", "banded_kernel<__nv_bfloat16, true>")


def kernel_ms(fn, names: tuple, reps: int) -> float:
    """Device ms per call of the kernels whose name holds one of ``names``;
    raises where none ran, so a renamed kernel is not read as 0 ms."""
    w = device_window(fn, reps=reps, warmup=2)["by_kernel"]
    hits = {k: ms for k, ms in w.items() if any(n in k for n in names)}
    if not hits:
        raise RuntimeError(f"no kernel named like {names} ran; the profiler saw {sorted(w)}")
    return sum(hits.values()) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", default="1024,2048,4096,8192")
    ap.add_argument("--d", default="320,512")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, hq, hkv = 1, 8, 4
    out = {}
    for d in (int(x) for x in args.d.split(",")):
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
                c = dataclasses.replace(cfg, dkdv_dk_in_kernel=dk_in)
                t["dk_in" if dk_in else "dk_out"] = kernel_ms(
                    lambda c=c: flash_bwd._dkdv_from_s_launch(q, v, s.clone(), do, lse, delta,
                                                              0, c, **kw),
                    flash_bwd.FROM_S_KERNELS, args.reps)
            t["banded_dk"] = kernel_ms(lambda: flash_bwd._banded_dk_from_ds(
                s, q, cfg, scale=scale, group=hq // hkv, nq=n, nkv=n, causal_offset=0,
                dk_dtype=torch.bfloat16), BANDED_DK, args.reps)
            t["dk_out_total"] = t["dk_out"] + t["banded_dk"]
            t["in_minus_out"] = t["dk_in"] - t["dk_out_total"]
            out[f"D{d}_N{n}"] = {key: round(val, 4) for key, val in t.items()}
            del q, k, v, do, o, lse, s, delta
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    routes = {f"D{d}": {tag: from_s_plan(d, tag == "dk_in").route for tag in ("dk_in", "dk_out")}
              for d in (int(x) for x in args.d.split(","))}
    print(json.dumps({"card": smi, "routes": routes, "device_ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
