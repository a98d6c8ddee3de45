"""Times the wide kernel routes of ``tools/torch_wide_bounds.py`` on the card,
each beside its bound, its plain version and one PyTorch call.

Run on a machine with a card, from the repository root:

    python tools/torch_wide_probe.py [--rows "3 (D > 512),7 (D > 512),..."]

Each route is forced at the shape ``torch_wide_bounds.routes()`` names,
through the wrapper that launches it (nothing here dispatches):

* ``3 (D > 512)``: ``flash_bwd._dq_launch`` at B1 H8/4 N8192 D1024 causal
  bf16, on the forward kernel's (o, lse); library: ``torch.autograd.grad``
  through ``scaled_dot_product_attention`` (dQ, dK and dV; K/V heads
  expanded);
* ``7 (D > 512)``: ``decode._decode_forward`` at B1 H8/4 Nkv 4224 D1024
  (the two-warpgroup block), one query row under the generate step's
  validity bias (4097 live rows), two caches in turn; library: SDPA with
  the bias, GQA;
* ``8``, ``9`` and ``10 (D > 512)``: ``varlen._varlen_forward``, and
  ``varlen._varlen_dkdv_kernel`` / ``_varlen_dq_kernel`` on their tile
  schedules, over 8 documents packed into 8192 tokens, H8/4 D1024 causal
  bf16; library: SDPA over the packed T with the block-diagonal causal bool
  mask (GQA) for the forward, its autograd (K/V heads expanded) for the
  backward pair;
* ``11 (page 24)`` and ``11 (D > 512)``: ``paged.paged_decode_attention``
  at the serving step (B4 H8/4, four pools in turn), D512 over pages of 24
  rows and D1024 (the two-warpgroup block) over pages of 256; yardstick:
  SDPA over the cache gathered dense with a length mask (the gather
  untimed).

Every route is held against its plain version per row first (a forward at
2e-2, a gradient at 5e-2 with a floor of 1e-3 of the tensor's max, the
bf16 tolerances of ``chip_smoke.py``); a miss exits 1 before any timing.
Times: ``kernel_ms``, the device ms per call of the route's kernels by
name from torch.profiler (decode's and paged decode's walk and split
merge; ``walk_ms`` the walk alone), ``event_ms`` CUDA events around the
wrapper's calls, ``plain_ms`` and ``library_ms`` device ms per call. The
loss a call, ``kernel_ms - bound_ms``, ranks the routes. Prints the card's
name and power limit, and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from ffpa_attn_tpu_torch.cli._bench import sdpa_backend  # noqa: E402
from ffpa_attn_tpu_torch.ops import _build, decode, flash_bwd, flash_fwd, paged, varlen  # noqa: E402,E501
from ffpa_attn_tpu_torch.ops.config import varlen_dkdv_plan, varlen_dq_plan  # noqa: E402
from ffpa_attn_tpu_torch.ops.dispatch import (  # noqa: E402
    pick_backward_config, pick_varlen_backward_config,
)
from ffpa_attn_tpu_torch.ops.reference import DEFAULT_MASK_VALUE, expand_kv_heads  # noqa: E402
from ffpa_attn_tpu_torch.utils.profiling import bound_ms, cuda_ms, device_window  # noqa: E402
from torch_wide_bounds import PACKING, SERVE_LENS, routes  # noqa: E402

FWD_TOL, GRAD_TOL = 2e-2, 5e-2
BF = torch.bfloat16


def row_rel(got, want, floor: float = 0.0) -> float:
    """The largest, over rows (the last dim), of a row's max|got - want|
    over the larger of that row's max|want| and ``floor`` times the
    tensor's."""
    g, w = got.float(), want.float()
    err, ref = (g - w).abs().amax(-1), w.abs().amax(-1)
    ref = torch.maximum(ref, floor * w.abs().max())
    return float(torch.where(err == 0, 0.0, err / ref.clamp_min(1e-30)).max())


def kernel_ms(fn, names: tuple, reps: int) -> float:
    """Device ms per call of the kernels whose name holds one of ``names``;
    raises where none ran, so a renamed kernel is not read as 0 ms."""
    w = device_window(fn, reps=reps, warmup=1)["by_kernel"]
    hits = [ms for n, ms in w.items() if any(x in n for x in names)]
    if not hits:
        raise RuntimeError(f"no kernel named like {names} ran; the profiler saw {sorted(w)}")
    return sum(hits) / reps


def device_ms(fn, reps: int) -> float:
    return device_window(fn, reps=reps, warmup=1)["device_ms"] / reps


def randn(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda").to(BF)


def dq_route(gen) -> dict:
    b, hq, hkv, n, d = 1, 8, 4, 8192, 1024
    q, do = randn(gen, b, hq, n, d), randn(gen, b, hq, n, d)
    k, v = randn(gen, b, hkv, n, d), randn(gen, b, hkv, n, d)
    scale = d ** -0.5
    o, lse = flash_fwd.flash_attention_forward(q, k, v, None, scale=scale, is_causal=True)
    delta = (do.float() * o.float()).sum(-1)
    del o
    cfg = pick_backward_config(d=d, dv=d, nq=n, nkv=n, dtype=BF)
    kw = dict(scale=scale, is_causal=True, causal_offset=0, dropout_p=0.0, group=hq // hkv)

    def run():
        return flash_bwd._dq_launch(q, k, v, None, do, lse, delta, 0, cfg,
                                    grad_q_storage_dtype=None, **kw)[0]

    def plain():
        return flash_bwd._dq_plain(q, k, v, None, do, lse, delta, scale=scale, emit_dbias=False,
                                   is_causal=True, causal_offset=0, dropout_p=0.0, seed=0,
                                   softcap=0.0, window=(-1, -1), alibi=None)[0]

    ql, ke, ve = (x.detach().requires_grad_() for x in
                  (q, expand_kv_heads(k, hq), expand_kv_heads(v, hq)))
    out = F.scaled_dot_product_attention(ql, ke, ve, is_causal=True)

    def library():
        return torch.autograd.grad(out, (ql, ke, ve), do, retain_graph=True)

    return dict(run=run, plain=plain, library=library, grad=True, reps=5, plain_reps=2,
                names=DQ_NAMES, library_label="torch.autograd.grad through SDPA "
                f"({sdpa_backend(ql, ke, ve, is_causal=True)} backend, causal, dQ dK dV)")


def decode_route(gen) -> dict:
    b, hq, hkv, nkv, d, valid = 1, 8, 4, 4224, 1024, 4097
    caches = [(randn(gen, b, hkv, nkv, d), randn(gen, b, hkv, nkv, d)) for _ in range(2)]
    q = randn(gen, b, hq, 1, d)
    cols = torch.arange(nkv, device="cuda")
    bias = torch.where(cols < valid, 0.0, DEFAULT_MASK_VALUE).float()[None, None, None]
    bias_bf = bias.to(BF)
    scale = d ** -0.5
    turn = [0]

    def pick():
        turn[0] += 1
        return caches[turn[0] % 2]

    def run():
        kc, vc = pick()
        return decode._decode_forward(q, kc, vc, bias, scale=scale, is_causal=False)[0]

    def plain():
        kc, vc = caches[turn[0] % 2]
        o, _ = decode._decode_plain(q.reshape(b, hkv, hq // hkv, d), kc, vc, bias, nq=1,
                                    scale=scale, is_causal=False, softcap=0.0, window_left=-1,
                                    window_right=-1)
        return o.reshape(q.shape)

    def library():
        kc, vc = pick()
        return F.scaled_dot_product_attention(q, kc, vc, attn_mask=bias_bf, enable_gqa=True)

    return dict(run=run, plain=plain, library=library, grad=False, reps=100, plain_reps=20,
                names=("decode_tma_kernel", "split_merge_kernel"), walk=("decode_tma_kernel",),
                library_label="SDPA with the validity bias, GQA")


def _packing(gen, d):
    hq, hkv = 8, 4
    t = sum(PACKING)
    q, k, v, do = (randn(gen, t, h, d) for h in (hq, hkv, hkv, hq))
    cu = torch.tensor(np.cumsum([0] + PACKING), dtype=torch.int32, device="cuda")
    seg = torch.repeat_interleave(torch.arange(len(PACKING), device="cuda"),
                                  torch.tensor(PACKING, device="cuda"))
    r = torch.arange(t, device="cuda")
    block_causal = (seg[:, None] == seg[None, :]) & (r[None, :] <= r[:, None])
    return q, k, v, do, cu, block_causal


def varlen_fwd_route(gen) -> dict:
    d = 1024
    q, k, v, _, cu, block_causal = _packing(gen, d)
    t = q.shape[0]
    kw = dict(scale=d ** -0.5, causal=True)
    meta = varlen._segment_metadata(cu, cu, t, t, t, t)
    qh, kh, vh = (x.transpose(0, 1)[None] for x in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=block_causal,
                                              enable_gqa=True)

    return dict(
        run=lambda: varlen._varlen_forward(q, k, v, cu, cu, **kw)[0],
        plain=lambda: varlen._varlen_forward_plain(q, k, v, meta, **kw)[0],
        library=library, grad=False, reps=10, plain_reps=3, names=varlen.FWD_KERNELS,
        library_label="SDPA over the packed T with the block-diagonal causal bool mask "
        f"({sdpa_backend(qh, kh, vh, attn_mask=block_causal, enable_gqa=True)} backend, GQA)")


def varlen_bwd_routes(gen) -> tuple:
    d, hq = 1024, 8
    q, k, v, do, cu, block_causal = _packing(gen, d)
    t = q.shape[0]
    kw = dict(scale=d ** -0.5, causal=True, softcap=0.0, window=(-1, -1))
    meta = varlen._call_metadata(cu, cu, t, t, "cuda")
    o, lse = varlen._varlen_forward(q, k, v, cu, cu, meta=meta, **kw)
    delta = varlen._varlen_delta(do, o)
    del o
    cfg = pick_varlen_backward_config(d=d, dv=d, dtype=BF)
    ops = varlen._BwdOperands(q, k, v, do, lse, delta, None)
    dkdv_sched, dq_sched = varlen._backward_schedules(
        meta, t, varlen_dkdv_plan(d, d), varlen_dq_plan(d, d), True, (-1, -1))
    qh = q.transpose(0, 1)[None].detach().requires_grad_()
    kh = expand_kv_heads(k.transpose(0, 1)[None], hq).detach().requires_grad_()
    vh = expand_kv_heads(v.transpose(0, 1)[None], hq).detach().requires_grad_()
    out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=block_causal)
    doh = do.transpose(0, 1)[None]

    def library():
        return torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True)

    label = ("torch.autograd.grad through SDPA over the packed T with the block-diagonal "
             f"causal bool mask ({sdpa_backend(qh, kh, vh, attn_mask=block_causal)} backend, "
             "K/V heads expanded; the dK/dV + dQ pair)")
    common = dict(library=library, grad=True, reps=5, plain_reps=2, library_label=label)
    dkdv = dict(common, run=lambda: varlen._varlen_dkdv_kernel(ops, meta, dkdv_sched, cfg, **kw),
                plain=lambda: varlen._varlen_dkdv_plain(q, k, v, do, lse, delta, meta, **kw),
                names=varlen.DKDV_KERNELS)
    dq = dict(common, run=lambda: varlen._varlen_dq_kernel(ops, meta, dq_sched, **kw),
              plain=lambda: varlen._varlen_dq_plain(q, k, v, do, lse, delta, meta, **kw),
              names=VARLEN_DQ_NAMES)
    return dkdv, dq


def paged_route(gen, d: int, page: int) -> dict:
    b, hq, hkv, max_len = len(SERVE_LENS), 8, 4, 1152
    n = max(SERVE_LENS)
    pools = []
    for _ in range(4):
        cache = paged.PagedKVCache.alloc(b, max_len, hkv, d, page_size=page, dtype=BF,
                                         device="cuda")
        pools.append(paged.fill_from_prefill(cache, randn(gen, b, hkv, n, d),
                                             randn(gen, b, hkv, n, d), list(SERVE_LENS)))
    q = randn(gen, b, hq, 1, d)
    scale = d ** -0.5
    turn = [0]
    dense = [(paged._dense_rows(c.k_pages, c.page_table), paged._dense_rows(c.v_pages,
                                                                            c.page_table))
             for c in pools]
    cols = torch.arange(dense[0][0].shape[2], device="cuda")
    valid = (cols[None, :] < torch.tensor(SERVE_LENS, device="cuda")[:, None])[:, None, None]

    def run():
        turn[0] += 1
        return paged.paged_decode_attention(q, pools[turn[0] % 4], scale=scale)

    def plain():
        o, _ = paged._paged_decode_plain(q.reshape(b, hkv, hq // hkv, d), pools[turn[0] % 4],
                                         nq=1, scale=scale, softcap=0.0, window_left=-1)
        return o.reshape(q.shape)

    def library():
        turn[0] += 1
        kc, vc = dense[turn[0] % 4]
        return F.scaled_dot_product_attention(q, kc, vc, attn_mask=valid, enable_gqa=True)

    return dict(run=run, plain=plain, library=library, grad=False, reps=100, plain_reps=20,
                names=("paged_tma_kernel", "split_merge_kernel"), walk=("paged_tma_kernel",),
                library_label="yardstick: SDPA over the cache gathered dense, length mask")


# The recompute dQ kernels of every tree this probe may time: the mma.sync
# block before the cluster route, the wgmma block and its cluster after.
DQ_NAMES = ("::dq_kernel<", "wgmma_dq_kernel<")
# The varlen dQ kernels of every tree: the mma.sync block an older tree ran
# above D512, the wgmma block (one block or the cluster).
VARLEN_DQ_NAMES = ("varlen_dq_kernel<", "varlen_dq_wgmma_kernel<")


def probe(row: str, spec: dict, bound: tuple) -> dict:
    run, plain = spec["run"], spec["plain"]
    got = run()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = plain()
    want = want if isinstance(want, tuple) else (want,)
    floor = 1e-3 if spec["grad"] else 0.0
    err = max(row_rel(g, w, floor) for g, w in zip(got, want))
    max_abs = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    tol = GRAD_TOL if spec["grad"] else FWD_TOL
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    print(f"{row}: row_rel_err {err:.3e} (tol {tol:g}) max|err| {max_abs:.3e} "
          f"{'ok' if err < tol and finite else 'FAIL'}", flush=True)
    if not (err < tol and finite):
        raise SystemExit(f"{row}: the kernel disagrees with its plain version")
    del got, want
    torch.cuda.empty_cache()
    reps = spec["reps"]
    seen = sorted({n[:90] for n in device_window(run, reps=1, warmup=0)["by_kernel"]
                   if any(x in n for x in spec["names"])})
    out = dict(kernels_seen=seen, row_rel_err=err, max_abs_err=max_abs,
               kernel_ms=kernel_ms(run, spec["names"], reps), event_ms=cuda_ms(run, reps=reps))
    if "walk" in spec:
        out["walk_ms"] = kernel_ms(run, spec["walk"], reps)
    out["plain_ms"] = device_ms(plain, spec["plain_reps"])
    torch.cuda.empty_cache()
    out["library_ms"] = device_ms(spec["library"], max(2, reps // 2))
    out["library"] = spec["library_label"]
    out["bound_ms"], out["bound_by"] = bound
    out["loss_ms"] = out["kernel_ms"] - out["bound_ms"]
    print(f"{row}: kernel {out['kernel_ms']:.4f} ms [{out['event_ms']:.4f}] bound "
          f"{out['bound_ms']:.4f} ({out['bound_by']}) plain {out['plain_ms']:.4f} library "
          f"{out['library_ms']:.4f} ms; kernels {seen}", flush=True)
    return out


BUILDERS = {"3 (D > 512)": dq_route, "7 (D > 512)": decode_route,
            "8 (D > 512)": varlen_fwd_route,
            "11 (page 24)": lambda gen: paged_route(gen, 512, 24),
            "11 (D > 512)": lambda gen: paged_route(gen, 1024, 256)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    names = [r[0] for r in routes()]
    ap.add_argument("--rows", default=",".join(names), help="comma-separated rows of routes()")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions stay fp32
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"build: {_build.build()}", flush=True)  # every library, nvcc in parallel
    wanted = [r for r in args.rows.split(",") if r]
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    pair = None
    for row, kernel, shape, launches, (flops, nbytes) in routes():
        if row not in wanted:
            continue
        if row in BUILDERS:
            spec = BUILDERS[row](gen)
        else:  # 9 and 10: one packing, one backward
            pair = pair or varlen_bwd_routes(gen)
            spec = pair[0] if row.startswith("9") else pair[1]
        res = probe(row, spec, bound_ms(flops, nbytes))
        results.append(dict(row=row, kernel=kernel, shape=shape, launches=launches, **res))
        del spec
        if row.startswith("10"):
            pair = None
        torch.cuda.empty_cache()
    results.sort(key=lambda r: -r["loss_ms"])
    print(json.dumps({"card": smi, "wide_routes": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
