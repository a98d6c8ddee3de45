"""What the design choices of the wgmma varlen dK/dV and dQ kernels buy, on
a card.

Run from the repository root on a machine with a card:

    python tools/torch_varlen_dkdv_probe.py [--kernel dkdv|dq|dkdv_cluster|dq_cluster]

The shape is ``chip_smoke.py``'s packed-training backward: 8 documents of
2048..284 tokens (8192 in all), H8/4, D = Dv = 512 (D = Dv = 1024 for
``dkdv_cluster`` and ``dq_cluster``), causal, bf16, the kernel alone on the plain forward's
(o, lse) with its 64 x 64 schedule computed beforehand
(``varlen._backward_schedules``). Each reading is
device ms per call from torch.profiler, taken in turns (v1 .. vn, vn ..
v1), and each run's output is held against its plain version per row
(bf16 5e-2, a row's floor at 1e-3 of the tensor's max). dK/dV:

* ``longest_first``: the kernel as built, its KV tiles in the schedule's
  order (longest interval first);
* ``kv_tile_order``: the same library with the KV tiles in index order;
* ``no_fast_path``: ``csrc/varlen_bwd.cu`` rebuilt with its full-block test
  off, so every consumer block takes the per-element mask.

dQ:

* ``needed_tiles``: the kernel as built, each Q tile walking its needed KV
  tiles, the most needed Q tiles first;
* ``q_tile_order``: the same library with the Q tiles in index order;
* ``interval_tiles``: the same library walking every KV tile of each 64-row
  Q tile's [jmin, jmax] (the mma.sync route's walk);
* ``no_fast_path``: the rebuilt library, every consumer block masked
  element by element.

dK/dV on the cluster (D1024), where a consumer reads each Q tile's lse and
delta:

* ``rows_per_group``: the kernel as built, per column group where the group
  uses them;
* ``rows_before_products``: ``csrc/varlen_bwd.cu`` rebuilt to load all 16
  before the S^T products, as the one-block route does;
* ``rows_lookahead``: rebuilt to load each group's beside the group before.

dQ on the cluster (D1024):

* ``s_early``: the kernel as built, each consumer's partial S sent to the
  partner as soon as its products complete (under the dP products);
* ``s_beside_dp``: ``csrc/varlen_bwd.cu`` rebuilt to send it beside dP,
  after the dP products;
* ``no_fast_path``: rebuilt with its full-block test off.

Prints the card's name and power limit, each variant's ptxas registers and
spill bytes, then one JSON line; exits 1 if a run misses the tolerance.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from ffpa_attn_tpu_torch.ops import _build, varlen  # noqa: E402
from ffpa_attn_tpu_torch.ops.config import varlen_dkdv_plan, varlen_dq_plan  # noqa: E402
from ffpa_attn_tpu_torch.ops.dispatch import pick_varlen_backward_config  # noqa: E402
from ffpa_attn_tpu_torch.utils.profiling import device_ms  # noqa: E402

LENS = [2048, 1536, 1200, 1024, 900, 700, 500, 284]
REPS = 20
TOL = 5e-2
_PLAIN = "  const bool plain = p.alibi == nullptr && p.softcap <= 0.f && p.window_left < 0;\n"
# library -> (text, replacement) pairs applied to csrc/varlen_bwd.cu
_EARLY = ("    if constexpr (!SPLIT) {\n#pragma unroll\n      for (int jj = 0; jj < 4; ++jj) "
          "load_rows(jj, qc + 8 * jj + 2 * t4);\n    }\n")
_ALWAYS = ("#pragma unroll\n    for (int jj = 0; jj < 4; ++jj) "
           "load_rows(jj, qc + 8 * jj + 2 * t4);\n")
_GROUP = "        load_rows(jj, col);\n      }\n    };\n"
_CALL = "        group_rows(jj);\n"
SOURCES = {
    "dkdv": {"as_built": [], "no_fast_path": [(_PLAIN, "  const bool plain = false;\n")]},
    "dkdv_cluster": {
        "as_built": [],
        "rows_before_products": [(_EARLY, _ALWAYS), (_GROUP, "      }\n    };\n")],
        "rows_lookahead": [(_CALL, "        if (jj == 0) group_rows(0);\n"
                                   "        if (jj + 1 < 4) group_rows(jj + 1);\n")],
    },
}
SOURCES["dq"] = SOURCES["dkdv"]
_S_EARLY = ("      mbar_wait_cluster(&sm.part_free[C], (t + 1) & 1);\n"
            "      send(s, count(0), 0);\n    }\n")
_DP_SEND = "      send(dp, count(1), PART_BYTES);\n"
SOURCES["dq_cluster"] = {
    "as_built": [],
    "s_beside_dp": [(_S_EARLY, "    }\n"), (_DP_SEND, _S_EARLY.replace("    }\n", "") + _DP_SEND)],
    "no_fast_path": SOURCES["dkdv"]["no_fast_path"],
}


def build(out: Path, kernel: str) -> dict:
    """Compile each library's source with the package's flags and ptxas's
    report, all at once; print the wgmma kernel's registers and spills."""
    src = (_build.CSRC_DIR / "varlen_bwd.cu").read_text()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in SOURCES[kernel].items():
        text = src
        for a, b in edits:
            if a not in text:
                raise SystemExit(f"{name}: text not found in varlen_bwd.cu: {a[:70]!r}")
            text = text.replace(a, b)
        path = out / f"varlen_bwd_{name}.cu"
        path.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *_build.PTXAS_FLAGS, "-I", str(_build.CSRC_DIR),
             "-o", str(out / f"lib{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry" in ln and f"varlen_{kernel.split('_')[0]}_wgmma_kernel" in ln:
                spill = re.search(r"(\d+) bytes spill stores", lines[i + 2])
                regs = re.search(r"Used (\d+) registers", lines[i + 3])
                route = "cluster" if "Lb1E" in ln else "one block"
                print(f"{name} {'f16' if '__half' in ln else 'bf16'} {route}: {regs.group(1)} "
                      f"registers, {spill.group(1)} bytes spill stores")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        lib.ffpa_error_string.argtypes = [ctypes.c_int]
        lib.ffpa_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def row_rel(got, want, floor: float = 1e-3) -> float:
    got, want = got.float(), want.float()
    ref = want.abs().amax(-1).clamp_min(floor * float(want.abs().max()) + 1e-30)
    return float(((got - want).abs().amax(-1) / ref).max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=tuple(SOURCES), default="dkdv")
    kernel = ap.parse_args().kernel
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    libs = build(REPO / "build" / "varlen_dkdv_probe", kernel)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    t, hq, hkv = sum(LENS), 8, 4
    d = 1024 if kernel.endswith("_cluster") else 512
    cu = torch.tensor([0] + torch.tensor(LENS).cumsum(0).tolist(), dtype=torch.int32,
                      device="cuda")
    q, k, v, do = randn(t, hq, d), randn(t, hkv, d), randn(t, hkv, d), randn(t, hq, d)
    kw = dict(scale=d ** -0.5, causal=True, softcap=0.0, window=(-1, -1))
    meta = varlen._call_metadata(cu, cu, t, t, "cuda")
    o, lse = varlen._varlen_forward_plain(q, k, v, meta, scale=kw["scale"], causal=True)
    delta = varlen._varlen_delta(do, o)
    cfg = pick_varlen_backward_config(d=d, dv=d, dtype=torch.bfloat16)
    dkdv, dq = varlen._backward_schedules(meta, t, varlen_dkdv_plan(d, d), varlen_dq_plan(d, d),
                                          True, (-1, -1))
    ops = varlen._BwdOperands(q, k, v, do, lse, delta, None)
    if kernel == "dkdv_cluster":
        launch, sched = varlen._varlen_dkdv_kernel, dkdv
        want = varlen._varlen_dkdv_plain(q, k, v, do, lse, delta, meta, **kw)
        variants = {"rows_per_group": ("as_built", sched),
                    "rows_before_products": ("rows_before_products", sched),
                    "rows_lookahead": ("rows_lookahead", sched)}
    elif kernel == "dkdv":
        launch, sched = varlen._varlen_dkdv_kernel, dkdv
        want = varlen._varlen_dkdv_plain(q, k, v, do, lse, delta, meta, **kw)
        in_order = (sched[0], sched[1], torch.arange(sched[0].shape[0], dtype=torch.int32,
                                                     device="cuda"))
        # variant -> (library, schedule)
        variants = {"longest_first": ("as_built", sched), "kv_tile_order": ("as_built", in_order),
                    "no_fast_path": ("no_fast_path", sched)}
    else:
        def launch(ops_, meta_, sched_, cfg_, **k_):  # the dQ launcher reads no config
            return (varlen._varlen_dq_kernel(ops_, meta_, sched_, **k_),)

        sched = dq
        want = (varlen._varlen_dq_plain(q, k, v, do, lse, delta, meta, **kw),)
        tiles, count, order = sched
        in_order = (tiles, count, torch.arange(tiles.shape[0], dtype=torch.int32, device="cuda"))
        # Every KV tile of each Q tile's interval, listed as the kernel reads it.
        jmin, jmax = varlen._interval_schedule(varlen._tile_needed(
            *varlen._q_tiles(meta, t, 64), 64, 64, True))
        ids = torch.arange(tiles.shape[1], dtype=torch.int32, device="cuda")
        walk = (ids[None, :] >= jmin[:, None]) & (ids[None, :] <= jmax[:, None])
        interval = varlen._needed_tiles(walk)
        variants = {"needed_tiles": ("as_built", sched), "q_tile_order": ("as_built", in_order),
                    "interval_tiles": ("as_built", interval),
                    "no_fast_path": ("no_fast_path", sched)}
        if kernel == "dq_cluster":
            variants = {"s_early": ("as_built", sched), "s_beside_dp": ("s_beside_dp", sched),
                        "no_fast_path": ("no_fast_path", sched)}
    load = _build.load
    res, errs = {}, {}
    for name in list(variants) + list(variants)[::-1]:
        lib, sc = variants[name]
        _build.load = lambda n, lib=lib: libs[lib] if n == "varlen_bwd" else load(n)

        def run(sc=sc):
            return launch(ops, meta, sc, cfg, **kw)

        res.setdefault(name, []).append(round(device_ms(run, reps=REPS, warmup=3), 5))
        got = run()
        torch.cuda.synchronize()
        errs[name] = max(errs.get(name, 0.0), *(row_rel(g, w) for g, w in zip(got, want)))
    _build.load = load
    print(json.dumps({"kernel": kernel, "lens": LENS, "device_ms": res,
                      "row_rel_err_vs_plain": errs, "tol": TOL}))
    return 0 if all(e < TOL for e in errs.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
