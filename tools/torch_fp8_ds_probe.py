"""The e4m3 dS handoff on a card: the dK/dV kernel's e4m3 slab writer and
banded dQ's e4m3 reader against their plain versions and against the
16-bit kernels, and their times.

Run from the repository root on a machine with a card:

    python tools/torch_fp8_ds_probe.py [--check]

Builds ``flash_fwd.cu`` and ``flash_bwd.cu`` (nvcc in parallel) and prints
the e4m3 instances' registers and spill bytes (``dkdv_kernel_attrs`` /
``banded_kernel_attrs`` with ``ds_bits=8``), the count of ptxas's C7515 /
C7520 notes in ``flash_bwd.cu``'s build log and whether banded dQ's plan
over an e4m3 slab equals its Python mirror (``config.banded_plan`` with
``ds_itemsize=1``) at every D from 64 to 1024. Then, for each case
(feature cases at N1024, the training shape B1 H8/4 N8192 D512 causal and
the cluster route B1 H8/4 N4096 D1024 causal, all bf16):

* the dK/dV kernel with an e4m3 slab: dK and dV bit-equal to the same
  kernel's 16-bit-slab launch, the slab within one e4m3 step of the plain
  version's (``_dkdv_plain(..., ds_fp8=True)``: the two fp32 dS differ in
  summation order only) on every element;
* under causal, banded dQ over the kernel's own e4m3 slab against the plain
  version on that slab, per row at 2e-2 (``grad_row_rel``, floored).

Without ``--check`` it times, at the training shape and on the cluster
route, in turns (16-bit, e4m3, e4m3, 16-bit; device ms from the profiler
and CUDA-event ms): the dK/dV kernel writing each slab, banded dQ reading
each, and the yardstick of banded dQ over e4m3: one ``torch.matmul`` of the
slab widened to bf16 and K (the widening copy timed alone beside it). Then
the whole dS-handoff backward at the training shape
(``flash_attention_backward``, ``ds_handoff=True``) with
``FFPA_TORCH_ALLOW_FP8_DS`` unset and set: the launches of each, and dQ's
RMS error and worst element of the e4m3 run against the 16-bit run, each
relative (RMS over RMS, max over max|dQ|), beside the JAX package's own
bounds for them (4e-2 and 8e-2, at N <= 512 in its test).

Prints the card's name and power limit, then one JSON line; exits 1 if a
check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from ffpa_attn_tpu_torch.ops import _build, flash_bwd, flash_fwd  # noqa: E402
from ffpa_attn_tpu_torch.ops.config import (  # noqa: E402
    DKDV_Q_TILE, DKDV_SLAB_COLS, BlockConfig, banded_plan, cdiv,
)
from ffpa_attn_tpu_torch.ops.reference import expand_kv_heads  # noqa: E402
from ffpa_attn_tpu_torch.utils.profiling import cuda_ms, device_ms  # noqa: E402

BF = torch.bfloat16
READER_TOL = 2e-2
# (name, shape and features): B1 H8/4 unless given; all bf16.
CASES = (
    ("causal_N1024", dict(n=1024)),
    ("ragged_nq1000_nkv1100", dict(nq=1000, nkv=1100)),
    ("noncausal", dict(n=1024, causal=False)),
    ("softcap_dropout", dict(n=1024, softcap=30.0, dropout=0.1)),
    ("alibi_group1", dict(n=1024, hkv=8, alibi=True)),
    ("d320_window", dict(n=1024, d=320, window=(256, -1))),
    ("d1024_cluster_N1024", dict(n=1024, d=1024)),
    ("d640_cluster_ragged", dict(nq=1000, nkv=1100, d=640)),
    ("train_N8192_D512", dict(n=8192)),
    ("cluster_N4096_D1024", dict(n=4096, d=1024)),
)
TIMED = ("train_N8192_D512", "cluster_N4096_D1024")


def grad_row_rel(got, want, floor: float = 1e-3) -> float:
    got, want = got.float(), want.float()
    ref = want.abs().amax(-1).clamp_min(floor * float(want.abs().max()) + 1e-30)
    return float(((got - want).abs().amax(-1) / ref).max())


def inputs(gen, *, n=None, nq=None, nkv=None, hq=8, hkv=4, d=512, causal=True, softcap=0.0,
           dropout=0.0, alibi=False, window=(-1, -1)):
    nq, nkv = nq or n, nkv or n

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(BF)

    q, do = randn(1, hq, nq, d), randn(1, hq, nq, d)
    k, v = randn(1, hkv, nkv, d), randn(1, hkv, nkv, d)
    al = torch.rand((1, hq), generator=gen, device="cuda") * 0.1 if alibi else None
    scale = d ** -0.5
    o, lse = flash_fwd.flash_attention_forward(q, k, v, None, scale=scale, is_causal=causal,
                                               dropout_p=dropout, dropout_seed=3, softcap=softcap,
                                               window=window, alibi_slopes=al)
    delta = (do.float() * o.float()).sum(-1)
    kern = dict(scale=scale, is_causal=causal, causal_offset=nkv - nq, dropout_p=dropout,
                group=hq // hkv, softcap=softcap, window=window, alibi=al)
    plain = dict(is_causal=causal, causal_offset=nkv - nq, dropout_p=dropout, seed=3,
                 softcap=softcap, window=window, alibi=al)
    return dict(q=q, k=k, v=v, do=do, o=o, lse=lse, delta=delta, kern=kern, plain=plain,
                nq=nq, nkv=nkv, hq=hq, hkv=hkv, d=d, causal=causal, scale=scale)


def dkdv(x, bits):
    cfg = BlockConfig(ds_store_bits=bits)
    return flash_bwd._dkdv_launch(x["q"], x["k"], x["v"], None, x["do"], x["lse"], x["delta"], 3,
                                  cfg, grad_kv_storage_dtype=None, emit_ds=True, **x["kern"])


def banded(x, ds):
    return flash_bwd._banded_dq_from_ds(ds, x["k"], None, scale=x["scale"],
                                        group=x["hq"] // x["hkv"], nq=x["nq"], nkv=x["nkv"],
                                        causal_offset=x["nkv"] - x["nq"], dq_dtype=BF)


def check_case(name, x) -> dict:
    """The writer against the 16-bit launch and the plain version, and the
    reader against its plain version on the writer's slab."""
    dk16, dv16, ds16 = dkdv(x, 16)
    dk8, dv8, ds8 = dkdv(x, 8)
    torch.cuda.synchronize()
    out = {"dk_dv_bit_equal": bool(torch.equal(dk16, dk8) and torch.equal(dv16, dv8)),
           "slab_dtype": str(ds8.dtype)}
    del dk16, dv16, ds16, dk8, dv8
    pad = dict(nq_pad=cdiv(x["nq"], DKDV_Q_TILE) * DKDV_Q_TILE,
               nkv_pad=cdiv(x["nkv"], DKDV_SLAB_COLS) * DKDV_SLAB_COLS)
    _, _, pds = flash_bwd._dkdv_plain(x["q"], x["k"], x["v"], None, x["do"], x["lse"],
                                      x["delta"], scale=x["scale"], emit_ds=True, ds_fp8=True,
                                      **pad, **x["plain"])
    steps = flash_bwd.e4m3_steps(ds8, pds)
    out["slab_max_steps"] = int(steps.max())
    out["slab_elements_off_by_one"] = int((steps == 1).sum())
    del pds, steps
    ok = out["dk_dv_bit_equal"] and out["slab_max_steps"] <= 1 and ds8.dtype == torch.float8_e4m3fn
    if x["causal"]:
        got = banded(x, ds8)
        torch.cuda.synchronize()
        want = flash_bwd._banded_dq_plain(ds8, x["k"], scale=x["scale"], nq=x["nq"], nkv=x["nkv"])
        out["banded_dq_row_rel"] = grad_row_rel(got, want)
        ok = ok and out["banded_dq_row_rel"] < READER_TOL and bool(torch.isfinite(got).all())
        del got, want
    del ds8
    out["ok"] = ok
    print(f"{name}: {out}", flush=True)
    return out


def turns(fns: dict, reps: int) -> dict:
    """Device ms (profiler) and CUDA-event ms of each fn, in turns a b b a."""
    res = {n: {"device_ms": [], "event_ms": []} for n in fns}
    order = list(fns) + list(fns)[::-1]
    for n in order:
        res[n]["device_ms"].append(round(device_ms(fns[n], reps=reps, warmup=2), 5))
        res[n]["event_ms"].append(round(cuda_ms(fns[n], reps=reps, warmup=1), 5))
    return res


def time_case(x) -> dict:
    _, _, ds16 = dkdv(x, 16)
    _, _, ds8 = dkdv(x, 8)
    kx = expand_kv_heads(x["k"], x["hq"])
    out = {"dkdv": turns({"16": lambda: dkdv(x, 16), "e4m3": lambda: dkdv(x, 8)}, 5)}
    if x["causal"]:
        out["banded_dq"] = turns({"16": lambda: banded(x, ds16), "e4m3": lambda: banded(x, ds8)},
                                 10)
        widen = {"widen_copy": lambda: ds8.to(BF),
                 "matmul_widened": lambda: torch.matmul(ds8.to(BF), kx)}
        out["yardstick"] = turns(widen, 5)
    out["slab_bytes"] = {"16": ds16.numel() * ds16.element_size(), "e4m3": ds8.numel()}
    del ds16, ds8, kx
    torch.cuda.empty_cache()
    return out


def handoff_errors(x) -> dict:
    """The whole dS-handoff backward with the flag unset and set: launches
    and dQ's error of the e4m3 run against the 16-bit run."""
    from ffpa_attn_tpu_torch.utils.profiling import launch_counts

    key, res = "FFPA_TORCH_ALLOW_FP8_DS", {}
    kw = dict(scale=x["scale"], is_causal=x["causal"], ds_handoff=True, dropout_seed=3)
    for flag in ("0", "1"):
        os.environ[key] = flag
        try:
            launch_counts(zero=True)
            res[flag] = flash_bwd.flash_attention_backward(x["q"], x["k"], x["v"], None, x["o"],
                                                           x["lse"], x["do"], **kw)
            torch.cuda.synchronize()
            res[f"launches_{flag}"] = {n: c for n, c in launch_counts().items() if c}
        finally:
            del os.environ[key]
    g8, g16 = res["1"][0].float(), res["0"][0].float()
    rms = float((g8 - g16).pow(2).mean().sqrt() / g16.pow(2).mean().sqrt())
    worst = float((g8 - g16).abs().max() / g16.abs().max())
    dkdv_equal = bool(torch.equal(res["1"][1], res["0"][1]) and torch.equal(res["1"][2], res["0"][2]))
    return {"launches_16": res["launches_0"], "launches_e4m3": res["launches_1"],
            "dq_rms_rel": rms, "dq_worst_rel": worst, "jax_bounds": {"rms": 4e-2, "worst": 8e-2},
            "dk_dv_bit_equal": dkdv_equal}


def build_report() -> dict:
    """Build both libraries and read the e4m3 instances' attributes, ptxas's
    notes and the plan mirror."""
    _build.build(("flash_fwd", "flash_bwd"))
    notes = sum("C7515" in ln or "C7520" in ln for ln in _build.build_log("flash_bwd").splitlines())
    attrs = {f"dkdv_{route}": flash_bwd.dkdv_kernel_attrs(route, BF, ds_bits=8)
             for route in ("wgmma", "wgmma_cluster")}
    attrs["banded_dq"] = flash_bwd.banded_kernel_attrs(False, BF, ds_bits=8)
    mismatch = [d for d in range(64, 1025, 64)
                if flash_bwd.banded_kernel_plan(d, 8) != banded_plan(d, ds_itemsize=1)]
    rep = {"c7515_c7520_notes": notes, "attrs_e4m3": attrs, "banded_plan_mismatch": mismatch,
           "banded_plan_d512_e4m3": str(flash_bwd.banded_kernel_plan(512, 8))}
    for ln in _build.build_log("flash_bwd").splitlines():
        if re.search(r"C75(15|20)", ln):
            print(ln)
    print(f"build: {rep}", flush=True)
    return rep


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true", help="checks only, no timing")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    rep = build_report()
    ok = (rep["c7515_c7520_notes"] == 0 and not rep["banded_plan_mismatch"]
          and all(a["local_bytes"] == 0 for a in rep["attrs_e4m3"].values()))
    gen = torch.Generator(device="cuda").manual_seed(26)
    cases, times = {}, {}
    for name, kw in CASES:
        x = inputs(gen, **kw)
        cases[name] = check_case(name, x)
        ok = ok and cases[name]["ok"]
        if not args.check and name in TIMED:
            times[name] = time_case(x)
            print(f"{name} times: {times[name]}", flush=True)
            if name == "train_N8192_D512":
                times[name]["handoff"] = handoff_errors(x)
                print(f"{name} handoff: {times[name]['handoff']}", flush=True)
        del x
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "build": rep, "cases": cases, "times": times, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
