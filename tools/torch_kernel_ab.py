"""A/B device times of the port's CUDA kernels built from two source trees.

Run on a machine with a card, from the repository root:

    python tools/torch_kernel_ab.py --base DIR

DIR holds another version of the kernel sources (``flash_fwd.cu``,
``decode.cu`` and their headers; e.g. ``ffpa_attn_tpu_torch/csrc`` of a parent
checkout). Both versions are compiled with the package's nvcc flags and timed
at the serving shapes of ``chip_smoke.py`` (forward B1 H8/4 N4096 D512 causal
bf16; decode B1 H8/4 Nkv 4224 D512 with the validity bias, four caches in
turn so K/V are not L2-resident), in the order base, head, head, base,
through the same Python wrappers (the two share the C interface). Each time
is the kernels' device time per call from torch.profiler. Prints one JSON
line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from ffpa_attn_tpu_torch.ops import _build, decode, flash_fwd  # noqa: E402
from ffpa_attn_tpu_torch.ops.reference import DEFAULT_MASK_VALUE  # noqa: E402
from ffpa_attn_tpu_torch.utils.profiling import device_ms  # noqa: E402


def build_tree(src: Path, out: Path) -> dict:
    """Compile every source of ``src`` into ``out`` (nvcc in parallel) and
    load the libraries."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {
        name: subprocess.Popen([
            _build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src),
            "-o", str(out / f"lib{name}.so"), str(src / f"{name}.cu"),
        ])
        for name in _build.SOURCES
    }
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on {src / name}.cu")
    libs = {}
    for name in _build.SOURCES:
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        lib.ffpa_error_string.argtypes = [ctypes.c_int]
        lib.ffpa_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True, help="directory of the other kernel sources")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1

    trees = {
        "base": build_tree(Path(args.base).resolve(), REPO / "build" / "ab" / "base"),
        "head": build_tree(_build.CSRC_DIR, REPO / "build" / "ab" / "head"),
    }
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    b, hq, hkv, d, n, max_len = 1, 8, 4, 512, 4096, 4224
    scale = 1.0 / math.sqrt(d)
    q, k, v = randn(b, hq, n, d), randn(b, hkv, n, d), randn(b, hkv, n, d)
    qd = randn(b, hq, 1, d)
    caches = [(randn(b, hkv, max_len, d), randn(b, hkv, max_len, d)) for _ in range(4)]
    cols = torch.arange(max_len, device="cuda")
    bias = torch.where(cols <= n, 0.0, DEFAULT_MASK_VALUE).float()[None, None, None]
    turn = [0]

    def run_fwd():
        return flash_fwd.flash_attention_forward(q, k, v, None, scale=scale, is_causal=True)

    def run_decode():
        kc, vc = caches[turn[0] % len(caches)]
        turn[0] += 1
        return decode._decode_forward(qd, kc, vc, bias, scale=scale, is_causal=False)

    def use(tag):
        _build.load = lambda name: trees[tag][name]

    outs, times = {}, {"base": {"flash_fwd": [], "decode": []},
                       "head": {"flash_fwd": [], "decode": []}}
    for tag in ("base", "head", "head", "base"):
        use(tag)
        times[tag]["flash_fwd"].append(device_ms(run_fwd, reps=args.reps))
        times[tag]["decode"].append(device_ms(run_decode, reps=5 * args.reps))
        turn[0] = 0
        outs[tag] = (run_fwd()[0], run_decode()[0])
    torch.cuda.synchronize()
    diff = {
        name: float((outs["head"][i].float() - outs["base"][i].float()).abs().max())
        for i, name in enumerate(("flash_fwd", "decode"))
    }
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "order": "base head head base", "device_ms": times,
                      "max_abs_diff_head_vs_base": diff}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
