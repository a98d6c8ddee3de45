"""Where paged decode's time goes at the serving step, on a card.

Run from the repository root on a machine with a card:

    python tools/torch_paged_probe.py [--splits 6,8,10,16] [--variants base,nomath,...]

The shape is ``chip_smoke.py``'s serving step: B4, Hq8/Hkv4, nq 1, D = Dv =
512, page 256, lens [653, 762, 827, 950], four layers' pools in turn (bf16
and int8). Each reading is device ms per call from torch.profiler, the
walk (launch 1) and the merge (launch 2) apart.

* ``--splits``: the wrapper's split count (``paged._tma_splits``) replaced
  by each given count, beside the wrapper's own rule.
* ``--variants``: ``csrc/paged_decode.cu`` rebuilt with parts of the TMA
  kernel's consumer taken out, each library swapped into the wrapper in
  turns (v1 .. vn, vn .. v1): ``nomath`` drops the bf16 products (what
  streaming alone costs), ``q8_nowiden`` the widening of int8 stages,
  ``q8_nomma`` the int8 products, ``q8_nowiden_nomma`` both. Their outputs
  are wrong by design: this times, it does not check. Beside them, a
  read-only reference: ``torch.sum`` over one layer's bf16 K and V pools.

Prints the card's name and power limit, then one JSON line.
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

import chip_smoke as cs  # noqa: E402
from ffpa_attn_tpu_torch.ops import _build, paged  # noqa: E402
from ffpa_attn_tpu_torch.utils.profiling import device_window  # noqa: E402

REPS = 200
_MMA_BF16 = ("box_mma<T, ROWS, 0>(s, sm.ring + (size_t)st * STAGE_BYTES, sm.q + j * Q_BOX_BYTES, "
             "j == 0);")
_PV_BF16 = ("pv_mma<T>(*reinterpret_cast<float(*)[8]>(o + 8 * j), sm.ring + (size_t)st * "
            "STAGE_BYTES,\n                    pbox);")
_NOWIDEN = [("    widen_stage<T>(sm.ring + (size_t)st * STAGE_BYTES, stg, tid);\n", "")]
_NOMMA_Q8 = [
    ("        box_mma<T, ROWS, 0>(s, stg, sm.q + 2 * j * Q_BOX_BYTES, j == 0);\n", ""),
    ("          box_mma<T, ROWS, 0>(s, stg + BOX_BYTES, sm.q + (2 * j + 1) * Q_BOX_BYTES);\n",
     ";\n"),
    ("          pv_mma<T>(*reinterpret_cast<float(*)[8]>(o + 16 * j), stg, pbox);\n", ""),
    ("            pv_mma<T>(*reinterpret_cast<float(*)[8]>(o + 16 * j + 8), stg + BOX_BYTES, "
     "pbox);\n", ";\n"),
]
# variant -> (text, replacement) pairs applied to csrc/paged_decode.cu
VARIANTS = {
    "base": [],
    "nomath": [(_MMA_BF16, ""), (_PV_BF16, "")],
    "q8_nowiden": _NOWIDEN,
    "q8_nomma": _NOMMA_Q8,
    "q8_nowiden_nomma": _NOWIDEN + _NOMMA_Q8,
}


def build_variants(names, out: Path) -> dict:
    """Compile each variant's source with the package's flags, all at once."""
    src = (_build.CSRC_DIR / "paged_decode.cu").read_text()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for a, b in VARIANTS[name]:
            if a not in text:
                raise SystemExit(f"variant {name}: text not found in paged_decode.cu: {a[:70]!r}")
            text = text.replace(a, b)
        path = out / f"paged_{name}.cu"
        path.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o",
             str(out / f"libpaged_{name}.so"), str(path)])
    libs = {}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"nvcc failed on variant {name}")
        lib = ctypes.CDLL(str(out / f"libpaged_{name}.so"))
        lib.ffpa_error_string.argtypes = [ctypes.c_int]
        lib.ffpa_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def walk_and_merge(run) -> list:
    by_kernel = device_window(run, reps=REPS, warmup=10)["by_kernel"]
    walk = sum(ms for n, ms in by_kernel.items() if "paged" in n) / REPS
    merge = sum(ms for n, ms in by_kernel.items() if "merge" in n) / REPS
    return [round(walk, 5), round(merge, 5)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--splits", default="", help="comma-separated split counts")
    ap.add_argument("--variants", default="", help=f"comma-separated of {sorted(VARIANTS)}")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(13)
    lens = [n + 64 for n in cs.SERVE_LENS]
    d, hq, hkv = 512, 8, 4
    scale = 1.0 / math.sqrt(d)
    q = cs._randn((cs.SERVE_B, hq, 1, d), torch.bfloat16, gen)
    pools = {q8: [cs._paged_pools(lens, page=cs.SERVE_PAGE, max_len=cs.SERVE_MAX_LEN, hkv=hkv,
                                  d=d, quantized=q8, gen=gen) for _ in range(4)]
             for q8 in (False, True)}

    def runner(q8):
        it = iter(range(1 << 30))
        return lambda: paged.paged_decode_attention(q, pools[q8][next(it) % 4], scale=scale)

    res = {"lens": lens}
    if args.splits:
        rule = paged._tma_splits
        for q8, tag in ((False, "bf16"), (True, "int8")):
            for s in [None] + [int(x) for x in args.splits.split(",")]:
                paged._tma_splits = rule if s is None else (lambda *a, s=s: s)
                res[f"{tag} splits={s or 'rule'}"] = walk_and_merge(runner(q8))
            paged._tma_splits = rule
    if args.variants:
        names = args.variants.split(",")
        libs = build_variants(names, REPO / "build" / "paged_probe")
        kp, vp = pools[False][0].k_pages, pools[False][0].v_pages
        w = device_window(lambda: (kp.sum(dtype=torch.float32), vp.sum(dtype=torch.float32)),
                          reps=50, warmup=5)
        ms = w["device_ms"] / 50
        nbytes = 2 * kp.numel() * kp.element_size()
        res["torch.sum over one layer's bf16 pools"] = {
            "mb": round(nbytes / 1e6, 1), "ms": round(ms, 5),
            "tb_per_s": round(nbytes / ms / 1e9, 3)}
        load = _build.load
        for name in names + names[::-1]:
            _build.load = lambda n, name=name: libs[name] if n == "paged_decode" else load(n)
            for q8, tag in ((False, "bf16"), (True, "int8")):
                res.setdefault(f"{name} {tag}", []).append(walk_and_merge(runner(q8)))
        _build.load = load
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
