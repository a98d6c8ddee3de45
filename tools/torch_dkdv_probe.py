"""What the design choices of the dense dK/dV kernel's cluster route buy, on
a card.

Run from the repository root on a machine with a card:

    python tools/torch_dkdv_probe.py

``csrc/flash_bwd.cu`` is compiled as built and with one choice undone or
changed, all at once, each with ptxas's report (registers and spill bytes
of both routes' kernels in both dtypes, and the count of C7515 / C7520
wgmma serialization notes):

* ``as_built``: the kernel as built;
* ``s_with_dp``: the cluster's partial S^T sent beside dP^T after both
  products, not as soon as its own products complete (the first build);
* ``stages3`` / ``stages4``: the ring capped at 3 / 4 stages on both routes
  (D = Dv = 1024 gets 3 anyway; D640 6, D512 5 as built).

Each library is timed in turns (v1 .. vn, vn .. v1) at B1 H8/4 N4096
causal with the dS slab: D1024 and D640 fp16 (the cluster route), D512
bf16 (one block); device ms per call from torch.profiler. Each run's dK,
dV and slab are held against the plain version per row (fp16 1e-2, bf16
5e-2, a row's floor at 1e-3 of the tensor's max). Prints the card's name
and power limit, the ptxas lines, then one JSON line; exits 1 if a run
misses its tolerance.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from ffpa_attn_tpu_torch.ops import _build, flash_bwd, flash_fwd  # noqa: E402
from ffpa_attn_tpu_torch.ops.dispatch import pick_backward_config  # noqa: E402
from ffpa_attn_tpu_torch.utils.profiling import device_ms  # noqa: E402

B, HQ, HKV, N, REPS = 1, 8, 4, 4096, 10
SHAPES = ((1024, torch.float16), (640, torch.float16), (512, torch.bfloat16))
TOL = {torch.float16: 1e-2, torch.bfloat16: 5e-2}
_EARLY_S = """    if constexpr (SPLIT) {
      drain();
      fence_operands(s);
      // The partner has read tile t - 1's partials (at t = 0 the wait for
      // parity 1 of a fresh barrier returns at once).
      mbar_wait_cluster(&sm.part_free[CW], (t + 1) & 1);
      send(s, nd, 0);
    }
    stream(dp, sm.v, nv);"""
_STAGES = "constexpr int MAX_STAGES = 6;"
# library -> (text, replacement) pairs applied to csrc/flash_bwd.cu
SOURCES = {
    "as_built": [],
    "s_with_dp": [(_EARLY_S, "    stream(dp, sm.v, nv);"),
                  ("      send(dp, nv, PART_BYTES);",
                   "      mbar_wait_cluster(&sm.part_free[CW], (t + 1) & 1);\n"
                   "      send(s, nd, 0);\n      send(dp, nv, PART_BYTES);")],
    "stages3": [(_STAGES, "constexpr int MAX_STAGES = 3;")],
    "stages4": [(_STAGES, "constexpr int MAX_STAGES = 4;")],
}


def build(out: Path) -> dict:
    """Compile each library's source with the package's flags and ptxas's
    report, all at once; print each dK/dV kernel's registers and spills."""
    src = (_build.CSRC_DIR / "flash_bwd.cu").read_text()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in SOURCES.items():
        text = src
        for a, b in edits:
            if text.count(a) != 1:
                raise SystemExit(f"{name}: text not found once in flash_bwd.cu: {a[:70]!r}")
            text = text.replace(a, b)
        path = out / f"flash_bwd_{name}.cu"
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
        notes = sum("C7515" in ln or "C7520" in ln for ln in lines)
        for i, ln in enumerate(lines):
            m = re.search(r"dkdv6kernelI(\w+?)Lb(\d)", ln)
            if "Compiling entry" in ln and m:
                spill = re.search(r"(\d+) bytes spill stores", lines[i + 2])
                regs = re.search(r"Used (\d+) registers", lines[i + 3])
                print(f"{name} {'f16' if 'half' in m.group(1) else 'bf16'} "
                      f"{'cluster' if m.group(2) == '1' else 'one block'}: {regs.group(1)} "
                      f"registers, {spill.group(1)} bytes spill stores")
        print(f"{name}: {notes} C7515 / C7520 notes")
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
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    libs = build(REPO / "build" / "dkdv_probe")
    gen = torch.Generator(device="cuda").manual_seed(0)
    load = _build.load
    res, errs, ok = {}, {}, True
    for d, dt in SHAPES:
        def randn(*shape, dt=dt):
            return torch.randn(shape, generator=gen, device="cuda").to(dt)

        q, do = randn(B, HQ, N, d), randn(B, HQ, N, d)
        k, v = randn(B, HKV, N, d), randn(B, HKV, N, d)
        scale = d ** -0.5
        o, lse = flash_fwd.flash_attention_forward_plain(q, k, v, None, scale=scale,
                                                         is_causal=True)
        delta = (do.float() * o.float()).sum(-1)
        del o
        cfg = pick_backward_config(d=d, dv=d, nq=N, nkv=N, dtype=dt)
        kw = dict(scale=scale, is_causal=True, causal_offset=0, dropout_p=0.0, group=HQ // HKV)

        def run(q=q, k=k, v=v, do=do, lse=lse, delta=delta, cfg=cfg, kw=kw):
            return flash_bwd._dkdv_launch(q, k, v, None, do, lse, delta, 0, cfg,
                                          grad_kv_storage_dtype=None, emit_ds=True, **kw)

        want = flash_bwd._dkdv_plain(q, k, v, None, do, lse, delta, scale=scale, emit_ds=True,
                                     nq_pad=N, nkv_pad=N, is_causal=True, causal_offset=0,
                                     dropout_p=0.0, seed=0, softcap=0.0, window=(-1, -1),
                                     alibi=None)
        shape = f"D{d}_{str(dt)[6:]}"
        for name in list(SOURCES) + list(SOURCES)[::-1]:
            _build.load = lambda n, lib=libs[name]: lib if n == "flash_bwd" else load(n)
            res.setdefault(shape, {}).setdefault(name, []).append(
                round(device_ms(run, reps=REPS, warmup=2), 5))
            got = run()
            torch.cuda.synchronize()
            e = max(row_rel(g, w) for g, w in zip(got, want))
            errs.setdefault(shape, {})[name] = max(errs.get(shape, {}).get(name, 0.0), e)
            ok = ok and e < TOL[dt]
            del got
        _build.load = load
        del want
        torch.cuda.empty_cache()
    print(json.dumps({"shape": f"B{B} H{HQ}/{HKV} N{N} causal, with the slab", "device_ms": res,
                      "row_rel_err_vs_plain": errs}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
