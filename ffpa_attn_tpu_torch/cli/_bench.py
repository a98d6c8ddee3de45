"""Benchmark CLI of the port: the JAX package's ten cases against torch SDPA.

``python -m ffpa_attn_tpu_torch.bench``: the reference's eight cases
(self-attn / cross-attn / decode / gqa / causal / attn-mask / dropout /
non-aligned) plus decode-gqa and sliding-window, fwd and bwd, each gated on
correctness before it is timed, scored against the faster of two stock
baselines: ``torch.nn.functional.scaled_dot_product_attention`` (whichever
backend torch picks, logged per row) and the query-chunked fp32-softmax
composite a user writes when the scores do not fit. Exact causal / window
pair flop counts (``_flops.py``), markdown table and plot output as the
JAX package's ``cli/_bench.py``.

On the card times come from CUDA events (``time_fwd``, ``time_bwd``), with
the device time (``utils/profiling.queued_ms``, the host's enqueue off the
clock) and the profiler's split by kernel beside them; on the CPU
(``--device cpu``) from the host clock, which only checks the plumbing.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
import statistics
import sys
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..env import resolve_device
from ..interface import ffpa_attn_func
from ..ops.reference import band_mask, expand_kv_heads, reference_attention
from ..utils import profiling
from ._flops import attention_flops, format_tflops, tflops_from_ms

CASES = (
    "self-attn",
    "cross-attn",
    "decode",
    "decode-gqa",
    "gqa",
    "causal",
    "attn-mask",
    "dropout",
    "non-aligned",
    "sliding-window",
)

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
BASELINES = ("sdpa", "chunked")
WINDOWS = 5  # timing windows per measurement; the median is kept


@dataclass
class BenchCase:
    name: str
    b: int
    hq: int
    hkv: int
    nq: int
    nkv: int
    d: int
    causal: bool = False
    mask: bool = False
    dropout_p: float = 0.0
    window: tuple = (-1, -1)

    @property
    def window_active(self) -> bool:
        return self.window[0] >= 0 or (
            not self.causal and self.window[1] >= 0
        )


def make_case(name: str, b: int, h: int, n: int, d: int) -> BenchCase:
    if name == "self-attn":
        return BenchCase(name, b, h, h, n, n, d)
    if name == "cross-attn":
        return BenchCase(name, b, h, h, max(n // 8, 128), n, d)
    if name == "decode":
        return BenchCase(name, b, h, h, 1, n, d)
    if name == "decode-gqa":
        # Grouped-KV decode (Hq 32 / Hkv 8 at the defaults): the kernel
        # reads each KV head once for its whole Q group.
        return BenchCase(name, b, h, max(h // 4, 1), 1, n, d)
    if name == "gqa":
        return BenchCase(name, b, h, max(h // 4, 1), n, n, d)
    if name == "causal":
        return BenchCase(name, b, h, h, n, n, d, causal=True)
    if name == "attn-mask":
        return BenchCase(name, b, h, h, n, n, d, mask=True)
    if name == "dropout":
        return BenchCase(name, b, h, h, n, n, d, dropout_p=0.1)
    if name == "non-aligned":
        return BenchCase(name, b, h, h, n - 1, n - 1, d)
    if name == "sliding-window":
        # Mistral-style causal sliding window at W = N/8: FFPA computes
        # (and streams) only the band; the stock baselines mask the full
        # N^2.
        return BenchCase(
            name, b, h, h, n, n, d, causal=True,
            window=(max(n // 8, 512), -1),
        )
    raise ValueError(name)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _inputs(case: BenchCase, dtype, device, seed: int = 0):
    """q, k, v, the fp32 additive mask (or None) and dO, drawn in fp32 from
    a seeded ``torch.Generator`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(shape, dt=dtype):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).to(dt)

    q = randn((case.b, case.hq, case.nq, case.d))
    k = randn((case.b, case.hkv, case.nkv, case.d))
    v = randn((case.b, case.hkv, case.nkv, case.d))
    mask = None
    if case.mask:
        mask = randn((case.b, case.hq, case.nq, case.nkv), torch.float32)
    do = randn(q.shape)
    return q, k, v, mask, do


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _window_ms(calls: Callable[[], list], device: torch.device) -> float:
    """ms of the work ``calls`` does between the (start, end) pairs it
    returns: CUDA events on the card, host-clock readings on the CPU."""
    pairs = calls()
    if device.type == "cuda":
        pairs[-1][1].synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs)
    return sum(e - s for s, e in pairs) * 1e3


def _stamp(device: torch.device):
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def time_fwd(fn: Callable, *, device, warmup: int = 2, iters: int = 10) -> float:
    """ms per call of ``fn``: the median over WINDOWS windows of one (start,
    end) pair around ``iters`` back-to-back calls, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    _sync(device)

    def calls():
        start = _stamp(device)
        for _ in range(iters):
            fn()
        return [(start, _stamp(device))]

    return statistics.median(_window_ms(calls, device) / iters for _ in range(WINDOWS))


def time_bwd(prepare: Callable, *, device, warmup: int = 2, iters: int = 10) -> float:
    """ms per backward: ``prepare()`` runs a forward and returns the
    callable that runs its backward. Each iteration runs its own forward
    (the S-resident backward consumes its residual); one (start, end) pair
    brackets each backward alone. The median over WINDOWS windows of the
    mean over ``iters``, after ``warmup`` forward + backward pairs."""
    for _ in range(warmup):
        prepare()()
    _sync(device)

    def calls():
        pairs = []
        for _ in range(iters):
            backward = prepare()
            start = _stamp(device)
            backward()
            pairs.append((start, _stamp(device)))
        return pairs

    return statistics.median(_window_ms(calls, device) / iters for _ in range(WINDOWS))


# The port's kernels as the profiler names them: every kernel of
# ``csrc/*.cu`` lives in the file's top-level anonymous namespace (the TMA +
# wgmma ones one namespace deeper), the split-KV merge in ``ffpa``. PyTorch's
# own anonymous namespaces sit under ``at::native::``.
_PORT_KERNEL = re.compile(
    r"(?:^|\s)\(anonymous namespace\)::(?:(?:fwd|dkdv|dq|from_s|band|tma)::)?\w*kernel\b"
    r"|(?:^|\s)ffpa::split_merge_kernel\b"
)


def is_port_kernel(name: str) -> bool:
    return _PORT_KERNEL.search(name) is not None


_SDPA_BACKENDS = {"FLASH_ATTENTION": "flash", "EFFICIENT_ATTENTION": "efficient",
                  "CUDNN_ATTENTION": "cudnn", "MATH": "math"}


def sdpa_backend(q, k, v, attn_mask=None, is_causal: bool = False,
                 enable_gqa: bool = False) -> str:
    """The backend ``torch.nn.functional.scaled_dot_product_attention``
    takes for these arguments: torch's own dispatch decision
    (``torch._fused_sdp_choice``), which sees the inputs' device, dtypes,
    shapes, mask and ``requires_grad``; a backward runs its forward's
    backend."""
    from torch.nn.attention import SDPBackend

    kw = {"enable_gqa": True} if enable_gqa else {}
    choice = SDPBackend(torch._fused_sdp_choice(q, k, v, attn_mask=attn_mask, dropout_p=0.0,
                                                is_causal=is_causal, **kw))
    return _SDPA_BACKENDS.get(choice.name, choice.name.lower())


def _once(fn: Callable) -> Callable:
    """``fn`` for one call. A second call, the profiler's window taken
    again after it lost the first, raises ``LostDeviceEvents``: a backward
    cannot run twice on one graph."""
    calls = []

    def call():
        if calls:
            raise profiling.LostDeviceEvents("a backward cannot be profiled again")
        calls.append(1)
        return fn()

    return call


def _ffpa_fwd_fn(case: BenchCase, backend: Optional[str] = None):
    kwargs = {}
    if backend:
        kwargs["backend"] = backend
    if case.window_active:
        kwargs["window_size"] = case.window

    def fn(q, k, v, mask):
        return ffpa_attn_func(
            q,
            k,
            v,
            attn_mask=mask,
            is_causal=case.causal,
            dropout_p=case.dropout_p,
            enable_gqa=case.hq != case.hkv,
            **kwargs,
        )

    return fn


def chunked_sdpa(q, k, v, mask, *, causal: bool, chunk: int = 1024, window=(-1, -1)):
    """Query-chunked fp32-softmax attention: the memory-feasible composite
    a user writes when the full scores do not fit (scores materialized per
    chunk only). Under autograd each chunk runs in
    ``torch.utils.checkpoint``, so its backward recomputes the chunk's
    scores instead of keeping every chunk's fp32 softmax."""
    from torch.utils.checkpoint import checkpoint

    nq, d = q.shape[2], q.shape[3]
    nkv = k.shape[2]
    chunk = min(chunk, nq)
    scale = 1.0 / (d ** 0.5)
    wl = int(window[0])
    wr = 0 if causal else int(window[1])
    band = band_mask(nq, nkv, wl, wr, device=q.device)

    def one(qc, lo, mc):
        s = torch.matmul(qc, k.transpose(-1, -2)).float() * scale
        if mc is not None:
            s = s + mc
        if band is not None:
            s = torch.where(band[lo:lo + qc.shape[2]], s, -1e30)
        p = torch.softmax(s, dim=-1)
        return torch.matmul(p.to(v.dtype), v)

    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    outs = []
    for lo in range(0, nq, chunk):
        qc = q[:, :, lo:lo + chunk]
        mc = None
        if mask is not None:
            mc = mask if mask.shape[2] == 1 else mask[:, :, lo:lo + chunk]
        outs.append(checkpoint(one, qc, lo, mc, use_reentrant=False) if grad
                    else one(qc, lo, mc))
    return torch.cat(outs, dim=2)


@functools.cache
def _sdpa_takes_gqa() -> bool:
    """Whether the installed torch's SDPA takes ``enable_gqa``."""
    q, kv = torch.zeros(1, 2, 1, 8), torch.zeros(1, 1, 1, 8)
    try:
        F.scaled_dot_product_attention(q, kv, kv, enable_gqa=True)
    except TypeError:
        return False
    return True


def _sdpa_fwd_fn(case: BenchCase, variant: str):
    """One stock baseline variant. ``"sdpa"``:
    ``torch.nn.functional.scaled_dot_product_attention`` (GQA through
    ``enable_gqa`` where torch takes it, else K/V expanded; the sliding
    window as a bool band mask; the additive mask as given, which
    ``run_case`` casts to the inputs' dtype once before timing);
    ``"chunked"``: ``chunked_sdpa`` over expanded K/V. Neither has the
    hash dropout: the dropout case is timed against the dropout-free
    baseline."""
    group = case.hq != case.hkv
    bands = {}

    def sdpa_args(q, k, v, mask) -> tuple:
        """(q, k, v, keyword arguments) of the case's SDPA call."""
        if group and not _sdpa_takes_gqa():
            k, v = expand_kv_heads(k, case.hq), expand_kv_heads(v, case.hq)
        kw = {"enable_gqa": True} if k.shape[1] != case.hq else {}
        if case.window_active:
            if q.device not in bands:  # built once, outside the timed calls
                wl, wr = case.window
                bands[q.device] = band_mask(case.nq, case.nkv, wl, 0 if case.causal else wr,
                                            device=q.device)
            return q, k, v, dict(kw, attn_mask=bands[q.device])
        return q, k, v, dict(kw, attn_mask=mask, is_causal=case.causal)

    def fn(q, k, v, mask):
        if variant == "chunked":
            k, v = expand_kv_heads(k, case.hq), expand_kv_heads(v, case.hq)
            return chunked_sdpa(q, k, v, mask, causal=case.causal, window=case.window)
        q, k, v, kw = sdpa_args(q, k, v, mask)
        return F.scaled_dot_product_attention(q, k, v, **kw)

    fn.sdpa_args = sdpa_args
    return fn


def _rel(got, want) -> float:
    g, w = got.float(), want.float()
    return float((g - w).abs().max() / (w.abs().max() + 1e-9))


def _verify_case(case: BenchCase, dtype, direction: str, backend, device) -> None:
    """Correctness gate before timing: a fast-but-wrong config must never
    produce a table. Cases without mask and dropout are checked at the full
    bench shape against the chunked fp32-softmax composite (output, and dQ
    for bwd); the mask and dropout cases against the fp32 oracle
    ``reference_attention`` (hash dropout included) at a shape capped at
    2048, which runs the same kernel features without a second full-size
    fp32 mask. Tolerance: max|err| / max|ref| under 1e-2 fp16, 5e-2 bf16."""
    tol = 1e-2 if dtype == torch.float16 else 5e-2

    def check(label, r):
        if r >= tol:
            raise RuntimeError(f"bench verify FAILED for {label}: rel={r:.3f} >= {tol}")

    if case.dropout_p > 0.0 or case.mask:
        vcase = BenchCase(
            case.name, case.b, case.hq, case.hkv,
            min(case.nq, 2048), min(case.nkv, 2048), case.d,
            case.causal, case.mask, case.dropout_p,
        )
        q, k, v, mask, _ = _inputs(vcase, dtype, device, seed=7)
        with torch.no_grad():
            got = _ffpa_fwd_fn(vcase, backend)(q, k, v, mask)
            want = reference_attention(
                q, expand_kv_heads(k, vcase.hq), expand_kv_heads(v, vcase.hq), mask,
                is_causal=vcase.causal, scale=vcase.d ** -0.5, dropout_p=vcase.dropout_p,
            )
        check(vcase.name, _rel(got, want))
        return

    q, k, v, mask, do = _inputs(case, dtype, device, seed=7)
    ffpa, oracle = _ffpa_fwd_fn(case, backend), _sdpa_fwd_fn(case, "chunked")
    with torch.no_grad():
        check(f"{case.name} fwd", _rel(ffpa(q, k, v, mask), oracle(q, k, v, mask)))
    if direction == "bwd":
        def dq_of(fn):
            leaf = q.detach().requires_grad_()
            return torch.autograd.grad(fn(leaf, k, v, mask), leaf, do)[0]

        check(f"{case.name} bwd dq", _rel(dq_of(ffpa), dq_of(oracle)))


def _io_bytes(case: BenchCase, itemsize: int, direction: str) -> int:
    """Bytes the call must move: each input read once and each output
    written once (fwd: q, k, v, the fp32 mask, o; bwd: q, k, v, o, dO,
    lse, the mask, dq, dk, dv)."""
    q_b = case.b * case.hq * case.nq * case.d * itemsize
    kv_b = 2 * case.b * case.hkv * case.nkv * case.d * itemsize
    mask_b = case.b * case.hq * case.nq * case.nkv * 4 if case.mask else 0
    if direction == "fwd":
        return 2 * q_b + kv_b + mask_b
    return 4 * q_b + 2 * kv_b + mask_b + case.b * case.hq * case.nq * 4


def run_case(
    case: BenchCase,
    dtype,
    direction: str,
    backend: Optional[str] = None,
    warmup: int = 2,
    iters: int = 10,
    verify: bool = True,
    device=None,
):
    """One row: FFPA and each baseline timed on the same inputs, the
    correctness gate first. ``launches`` counts the port's kernels one FFPA
    call launched (a bwd row: its forward and its backward;
    ``backward_launches`` the backward's alone). On the card a row whose
    call launched none of them raises: a row timing a fallback against
    SDPA says nothing about FFPA."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    q, k, v, mask, do = _inputs(case, dtype, device)
    ffpa_fwd = _ffpa_fwd_fn(case, backend)

    if verify:
        _verify_case(case, dtype, direction, backend, device)
        if on_card:
            torch.cuda.empty_cache()

    def fwd_call(fn, m):
        def call():
            with torch.no_grad():
                return fn(q, k, v, m)
        return call

    def bwd_prepare(fn, m):
        def prepare():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = fn(*leaves, m)
            return lambda: out.backward(do)
        return prepare

    def timed(fn, m):
        if direction == "fwd":
            return time_fwd(fwd_call(fn, m), device=device, warmup=warmup, iters=iters)
        return time_bwd(bwd_prepare(fn, m), device=device, warmup=warmup, iters=iters)

    # FFPA: the launches of one call, counted from zero just before it and
    # read just after; a bwd row's call is its forward and its backward,
    # and the backward's own launches are kept apart.
    def launched(since=None):
        _sync(device)
        counts = profiling.launch_counts()
        return {n: c - (since or {}).get(n, 0) for n, c in counts.items()
                if c - (since or {}).get(n, 0)}

    profiling.launch_counts(zero=True)
    if direction == "fwd":
        fwd_call(ffpa_fwd, mask)()
        launches = launched()
    else:
        backward = bwd_prepare(ffpa_fwd, mask)()
        forward_launches = launched()
        backward()
        del backward
        launches = launched()
        backward_launches = launched(since=forward_launches)
    if on_card and not launches:
        raise RuntimeError(
            f"bench {case.name} {direction}: FFPA launched none of the port's kernels")
    t_ffpa = timed(ffpa_fwd, mask)

    flops = attention_flops(
        case.b,
        case.hq,
        case.nq,
        case.nkv,
        case.d,
        causal=case.causal,
        direction=direction,
        window=case.window,
    )
    bms, bby = profiling.bound_ms(flops, _io_bytes(case, q.element_size(), direction))

    device_ms, non_port_ms = None, None
    if on_card:
        # FFPA's device time, the host's enqueue held off the clock (a bwd
        # row: its backward alone); the median over WINDOWS windows.
        def queued() -> float:
            if direction == "fwd":
                call = fwd_call(ffpa_fwd, mask)
                return profiling.queued_ms(lambda: [call() for _ in range(iters)]) / iters
            return profiling.queued_ms(bwd_prepare(ffpa_fwd, mask)())

        device_ms = statistics.median(queued() for _ in range(WINDOWS))
        # The split by kernel from the profiler, kept only where its window
        # holds (nearly) the whole device time and the port's kernels: on an
        # H100 it lost device events in processes that had run large
        # baselines (a bench process's non-causal backward kept the fp32
        # products' GEMMs and lost the from-S kernel, whose launch the
        # counts above show), and a window of many small kernels sums to
        # less than the queued time by the gaps between them.
        try:
            if direction == "fwd":
                w = profiling.device_window(fwd_call(ffpa_fwd, mask), reps=iters, warmup=1)
            else:
                w = profiling.device_window(_once(bwd_prepare(ffpa_fwd, mask)()), warmup=0)
        except profiling.LostDeviceEvents:
            w = None
        reps = iters if direction == "fwd" else 1
        timed_launches = launches if direction == "fwd" else backward_launches
        port_ms = 0.0 if w is None else sum(
            ms for n, ms in w["by_kernel"].items() if is_port_kernel(n))
        if (w is not None and w["device_ms"] / reps >= 0.85 * device_ms
                and (port_ms > 0.0 or not timed_launches)):
            non_port_ms = (w["device_ms"] - port_ms) / reps
        else:
            print(f"  [{case.name} {direction}: the profiler lost device events; the split by "
                  f"kernel is not measured]", file=sys.stderr, flush=True)

    # Baselines: the additive mask cast once to the inputs' dtype for SDPA
    # (its fast backends take no fp32 bias on 16-bit inputs).
    base_ms = {}
    for variant in BASELINES:
        fn = _sdpa_fwd_fn(case, variant)
        m = mask.to(dtype) if (mask is not None and variant == "sdpa") else mask
        if variant == "sdpa":
            leaves = [t.detach().requires_grad_(direction == "bwd") for t in (q, k, v)]
            *qkv, kw = fn.sdpa_args(*leaves, m)
            backend_name = sdpa_backend(*qkv, **kw)
        try:
            base_ms[variant] = timed(fn, m)
        except torch.cuda.OutOfMemoryError as exc:  # a baseline variant only
            print(f"  [baseline {variant} out of memory: {str(exc)[:120]}]", flush=True)
            base_ms[variant] = float("inf")
        finally:
            del m
            if on_card:
                torch.cuda.empty_cache()
    best = min(base_ms, key=base_ms.get)
    t_sdpa = base_ms[best]

    return {
        "case": case.name,
        "direction": direction,
        "dtype": _dtype_name(dtype),
        "shape": f"B{case.b} Hq{case.hq} Hkv{case.hkv} Nq{case.nq} Nkv{case.nkv} D{case.d}",
        "ffpa_ms": t_ffpa,
        "sdpa_ms": t_sdpa,
        "ffpa_tflops": tflops_from_ms(flops, t_ffpa),
        "sdpa_tflops": tflops_from_ms(flops, t_sdpa),
        "speedup": t_sdpa / t_ffpa,
        "flops": flops,
        "baseline": best,
        "baseline_ms": base_ms,
        "sdpa_backend": backend_name,
        "ffpa_device_ms": device_ms,
        "non_port_device_ms": non_port_ms,
        "launches": launches,
        **({} if direction == "fwd" else {"backward_launches": backward_launches}),
        "bound_ms": bms,
        "bound_by": bby,
        "verified": verify,
        "device": device.type,
    }


def _device_label() -> str:
    """The card's name and power limit as nvidia-smi gives them (its name
    alone where nvidia-smi is missing); "cpu" without a card."""
    if not torch.cuda.is_available():
        return "cpu"
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
        return out[torch.cuda.current_device()]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name()


def md_preamble(rows, verified: bool = True) -> str:
    """Provenance header written above every generated table: device,
    date and the timing protocol."""
    on_cpu = any(r.get("device") == "cpu" for r in rows)
    device = "cpu (host clock: plumbing only, not a measurement)" if on_cpu else _device_label()
    has_bwd = any(r["direction"] == "bwd" for r in rows)
    clock = "host clock" if on_cpu else "CUDA events"
    proto = (
        f" Times: the median of {WINDOWS} windows, each the mean over back-to-back "
        f"calls after warm-up calls ({clock})."
    )
    if has_bwd:
        proto += (
            " Backward rows: every timed iteration runs its own forward (the "
            "S-resident backward consumes its residual) and one event pair "
            "brackets the backward alone, for FFPA and the baselines alike."
        )
    proto += (
        " SDPA is the faster of torch scaled_dot_product_attention and the "
        "query-chunked fp32-softmax composite; the dropout case is timed "
        "against the dropout-free baseline."
    )
    gate = (
        " pre-timing correctness gate on."
        if verified else " correctness gate SKIPPED (--no-verify)."
    )
    layers = os.environ.get("FFPA_TORCH_SCORES_AUTO_ASSUMED_LAYERS", "1")
    return (
        f"Measured {time.strftime('%Y-%m-%d')} on {device}; single-call "
        f"bench (FFPA_TORCH_SCORES_AUTO_ASSUMED_LAYERS={layers}),{gate}{proto}\n"
    )


def to_markdown(rows) -> str:
    lines = [
        "| case | dir | dtype | shape | FFPA ms | SDPA ms | FFPA | SDPA | speedup |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['case']} | {r['direction']} | {r['dtype']} | {r['shape']} "
            f"| {r['ffpa_ms']:.2f} | {r['sdpa_ms']:.2f} "
            f"| {format_tflops(r['ffpa_tflops'])} "
            f"| {format_tflops(r['sdpa_tflops'])} "
            f"| {r['speedup']:.2f}x |"
        )
    return "\n".join(lines)


def save_plot(rows, path: str, title: str) -> Optional[str]:
    """Grouped-bar TFLOPS comparison png; None where matplotlib is absent."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None

    import numpy as np

    labels = [f"{r['case']}\n{r['direction']}" for r in rows]
    ffpa = [r["ffpa_tflops"] for r in rows]
    sdpa = [r["sdpa_tflops"] for r in rows]
    x = np.arange(len(rows))
    w = 0.38

    fig, ax = plt.subplots(figsize=(max(6.0, 1.1 * len(rows)), 3.6), dpi=150)
    ax.bar(x - w / 2, ffpa, w, label="FFPA (CUDA port)", color="#2a78d6",
           edgecolor="white", linewidth=1.0)
    ax.bar(x + w / 2, sdpa, w, label="torch SDPA", color="#eb6834",
           edgecolor="white", linewidth=1.0)
    for xi, r in zip(x, rows):
        ax.annotate(
            f"{r['speedup']:.2f}x",
            (xi - w / 2, r["ffpa_tflops"]),
            textcoords="offset points", xytext=(0, 3),
            ha="center", fontsize=7, color="#333333",
        )
    ax.set_ylabel("TFLOPS")
    ax.set_title(title, fontsize=10)
    ax.set_xticks(x, labels, fontsize=7)
    ax.tick_params(axis="y", labelsize=7)
    ax.spines[["top", "right"]].set_visible(False)
    ax.grid(axis="y", color="#dddddd", linewidth=0.5, zorder=0)
    ax.set_axisbelow(True)
    ax.legend(frameon=False, fontsize=8)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def _row_line(row: dict, d: int, dtype_name: str) -> str:
    dev = "" if row["device"] == "cpu" else f", device {row['ffpa_device_ms']:.3f}ms"
    return (
        f"[{row['case']:>14s}] {row['direction']} D={d} {dtype_name}: FFPA "
        f"{row['ffpa_ms']:.3f}ms ({format_tflops(row['ffpa_tflops'])}{dev}) vs SDPA "
        f"{row['sdpa_ms']:.3f}ms "
        f"({format_tflops(row['sdpa_tflops'])}, {row['baseline']}; torch backend "
        f"{row['sdpa_backend']}) -> {row['speedup']:.2f}x; bound {row['bound_ms']:.3f}ms "
        f"({row['bound_by']}); launches {row['launches']}"
        + (f" (backward {row['backward_launches']})" if "backward_launches" in row else "")
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ffpa_attn_tpu_torch.bench",
        description="FFPA (PyTorch/CUDA port) benchmark vs torch SDPA",
    )
    parser.add_argument("--cases", nargs="*", default=list(CASES), choices=CASES)
    parser.add_argument("--B", type=int, default=1)
    parser.add_argument("--H", type=int, default=32)
    parser.add_argument("--N", type=int, default=8192)
    parser.add_argument("--D", type=int, nargs="*", default=[512])
    parser.add_argument(
        "--dtypes", nargs="*", default=["bfloat16"], choices=["bfloat16", "float16"]
    )
    parser.add_argument(
        "--directions", nargs="*", default=["fwd"], choices=["fwd", "bwd"]
    )
    parser.add_argument("--backend", default=None)
    parser.add_argument("--warmup", type=int, default=2)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument(
        "--no-verify", action="store_true",
        help="skip the pre-timing correctness gate (each case is otherwise "
        "validated against the fp32-softmax composite before measuring)",
    )
    parser.add_argument("--json", action="store_true", help="emit JSON lines")
    parser.add_argument("--output", default=None, help="markdown output path")
    parser.add_argument(
        "--plot", default=None,
        help="png output path (default: --output with a .png suffix, "
        "or skip when --output is not given)",
    )
    parser.add_argument(
        "--e2e", action="store_true",
        help="run end-to-end train/decode/serving tokens-per-second benchmarks "
        "instead of the kernel cases",
    )
    parser.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs the plain "
        "versions and checks the plumbing only)",
    )
    args = parser.parse_args(argv)

    # The kernel bench is a SINGLE attention call per step, so the
    # S-residency auto policy's stacked-model layer multiplier does not
    # apply: declare one layer. Explicit env settings still win.
    if os.environ.setdefault("FFPA_TORCH_SCORES_AUTO_ASSUMED_LAYERS", "1") == "1":
        print("[bench] single-call bench: FFPA_TORCH_SCORES_AUTO_ASSUMED_LAYERS=1")

    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"[bench] {exc}", file=sys.stderr)
        return 1

    if args.e2e:
        from ._e2e import main as e2e_main

        return e2e_main(device=str(device))

    rows = []
    for dtype_name in args.dtypes:
        dtype = DTYPES[dtype_name]
        for d in args.D:
            for name in args.cases:
                case = make_case(name, args.B, args.H, args.N, d)
                for direction in args.directions:
                    row = run_case(
                        case,
                        dtype,
                        direction,
                        backend=args.backend,
                        warmup=args.warmup,
                        iters=args.iters,
                        verify=not args.no_verify,
                        device=device,
                    )
                    rows.append(row)
                    print(json.dumps(row) if args.json else _row_line(row, d, dtype_name),
                          flush=True)
                if device.type == "cuda":
                    torch.cuda.empty_cache()

    md = to_markdown(rows)
    if args.output:
        with open(args.output, "w") as f:
            f.write(
                md_preamble(rows, verified=not args.no_verify)
                + "\n" + md + "\n"
            )
    else:
        print("\n" + md)

    plot_path = args.plot
    if plot_path is None and args.output:
        plot_path = str(
            __import__("pathlib").Path(args.output).with_suffix(".png")
        )
    if plot_path and rows:
        shape = rows[0]["shape"]
        written = save_plot(
            rows, plot_path, f"FFPA (CUDA port) vs torch SDPA — {shape}"
        )
        if written:
            print(f"plot written: {written}")
    return 0
