"""Timing and roofline helpers for the card.

* ``cuda_ms``: mean time per call between CUDA events around back-to-back
  calls; it includes host gaps when the host cannot keep the card busy.
* ``queued_ms``: device time of a block of work from CUDA events, the host's
  enqueue held off the clock by a spin kernel queued before it.
* ``device_window``: the kernels a block of work ran, from ``torch.profiler``
  (CUPTI): device time by kernel name, and the device's busy share of the
  wall-clock window. ``device_ms`` is its device time per call. Both raise
  when the profiler recorded no device time in two windows running, rather
  than report another clock under the same name.
* ``launch_counts``: every kernel wrapper's launch counter, by kernel.
* ``trace(path)``: a ``torch.profiler`` window exported as a Chrome trace
  (the JAX package's ``jax.profiler`` trace context);
* ``kernel_cost_summary``: the JAX package's analytic roofline estimate
  of one attention call, at the H100 SXM peaks below;
* ``bound_ms``: the least time the card could take for given operations
  and bytes, at the published H100 SXM peaks; ``backward_counts``,
  ``varlen_counts``, ``varlen_backward_counts`` and ``paged_decode_counts``
  give a kernel's operations and bytes for this run's shapes; ``band_pairs``
  (``cli/_flops.attention_valid_pairs``) the (row, col) score pairs inside
  the tail-aligned causal / window band of one head.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Callable, Iterator, Optional

import torch

from ..cli._flops import attention_valid_pairs as band_pairs

# Published NVIDIA H100 SXM peaks (dense): bf16/fp16 tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BW = 3.35e12


@contextlib.contextmanager
def trace(path: str) -> Iterator[None]:
    """Profile the block with ``torch.profiler`` (the host, and the card
    where there is one) and write its Chrome trace (``chrome://tracing``,
    Perfetto) to ``path``, making its directory."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    prof.export_chrome_trace(path)


def kernel_cost_summary(b: int, hq: int, nq: int, nkv: int, d: int, dv: Optional[int] = None,
                        *, causal: bool = False, direction: str = "fwd",
                        itemsize: int = 2) -> dict:
    """Roofline estimate of one attention call, the JAX package's: flop
    (``cli/_flops.attention_flops``), device-memory bytes (q, k and v per
    query head, an upper bound, and o; three times that for a backward)
    and the compute- and memory-bound ms at the H100 SXM peaks
    (``PEAK_BF16_FLOPS``, ``PEAK_HBM_BW``)."""
    from ..cli._flops import attention_flops

    dv = d if dv is None else dv
    flops = attention_flops(b, hq, nq, nkv, d, dv, causal=causal, direction=direction)
    io_bytes = (b * hq * nq * d + b * hq * nkv * (d + dv) + b * hq * nq * dv) * itemsize
    if direction != "fwd":
        io_bytes *= 3
    t_compute, t_memory = flops / PEAK_BF16_FLOPS, io_bytes / PEAK_HBM_BW
    return {
        "flops": flops,
        "hbm_bytes": io_bytes,
        "compute_bound_ms": t_compute * 1e3,
        "memory_bound_ms": t_memory * 1e3,
        "speed_of_light_ms": max(t_compute, t_memory) * 1e3,
        "bound": "compute" if t_compute >= t_memory else "memory",
    }


def bound_ms(flops: float, nbytes: float) -> tuple:
    """(least time in ms, "operations" or "bytes": whichever bounds it)."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BW
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def backward_counts(kernel: str, *, b: int, hq: int, hkv: int, nq: int, nkv: int, d: int,
                    dv: int, causal: bool, window=(-1, -1), itemsize: int = 2,
                    slab_bytes: int = 0, dk_in_kernel: bool = False,
                    ds_itemsize: Optional[int] = None) -> tuple:
    """(flop, bytes) one backward kernel needs, for ``bound_ms`` (the
    counterpart of the JAX package's ``cli/_flops.py`` for the backward).

    Products count 2 flop per multiply-add over the band's pairs only:
    dkdv does S = QK^T, dP = dO V^T, dV = P^T dO and dK = dS^T Q (4 units);
    dq does S, dP and dQ = dS K (3); banded_dq does dQ = dS K (1);
    dkdv_from_s does dP and dV (2 units; 3 with ``dk_in_kernel``: dK);
    banded_dk does dK = dS^T Q (1). Bytes count each input read once and
    each output written once: q, k, v, dO, lse and delta, the gradients, and
    ``slab_bytes`` of dS (written by dkdv and, over S in place, by
    dkdv_from_s) or dbias; dkdv_from_s reads the band's S, V, dO (and Q with
    dK) and no K; banded_dq reads the band's dS and K and writes dQ,
    banded_dk the band's dS and Q and writes dK. ``ds_itemsize`` is the
    bytes of a dS element banded dQ reads (1 for an e4m3 slab; default
    ``itemsize``)."""
    pairs = b * hq * band_pairs(nq, nkv, causal=causal, window=window)
    q_b, kv_b = b * hq * nq * d * itemsize, b * hkv * nkv * (d + dv) * itemsize
    do_b, rows_b = b * hq * nq * dv * itemsize, 2 * b * hq * nq * 4
    k_b, v_b = b * hkv * nkv * d * itemsize, b * hkv * nkv * dv * itemsize
    if kernel == "dkdv":
        return 2 * pairs * (2 * d + 2 * dv), q_b + 2 * kv_b + do_b + rows_b + slab_bytes
    if kernel == "dq":
        return 2 * pairs * (2 * d + dv), 2 * q_b + kv_b + do_b + rows_b + slab_bytes
    if kernel == "banded_dq":
        return 2 * pairs * d, pairs * (ds_itemsize or itemsize) + k_b + q_b
    if kernel == "dkdv_from_s":
        flops = 2 * pairs * (2 * dv + (d if dk_in_kernel else 0))
        nbytes = pairs * itemsize + 2 * v_b + do_b + rows_b + slab_bytes
        return flops, nbytes + (q_b + k_b if dk_in_kernel else 0)
    if kernel == "banded_dk":
        return 2 * pairs * d, pairs * itemsize + q_b + k_b
    raise ValueError(f"unknown backward kernel {kernel!r}")


def varlen_counts(seqs_q, seqs_k, *, hq: int, hkv: int, d: int, dv: int, causal: bool,
                  window=(-1, -1), itemsize: int = 2) -> tuple:
    """(flop, bytes) of one packed varlen forward: 2 * Hq * (D + Dv) flop
    per attended (row, col) pair, summed over the segments' tail-aligned
    bands (4 * Hq * D * sum band_pairs at D == Dv); q, k, v and o read or
    written once, and the fp32 lse."""
    pairs = sum(band_pairs(lq, lk, causal=causal, window=window)
                for lq, lk in zip(seqs_q, seqs_k))
    tq, tk = sum(seqs_q), sum(seqs_k)
    nbytes = (tq * hq * (d + dv) + tk * hkv * (d + dv)) * itemsize + 4 * hq * tq
    return 2 * hq * pairs * (d + dv), nbytes


def varlen_backward_counts(kernel: str, seqs_q, seqs_k, *, hq: int, hkv: int, d: int, dv: int,
                           causal: bool, window=(-1, -1), itemsize: int = 2) -> tuple:
    """(flop, bytes) of one packed varlen backward kernel, as
    ``backward_counts`` defines them, over the segments' tail-aligned bands:
    varlen_dkdv does 4 matmul units (S, dP, dV, dK) per band pair and
    varlen_dq 3 (S, dP, dQ), 2 flop per multiply-add; bytes count q, k, v,
    dO, lse and delta read once and the gradients written once."""
    pairs = hq * sum(band_pairs(lq, lk, causal=causal, window=window)
                     for lq, lk in zip(seqs_q, seqs_k))
    tq, tk = sum(seqs_q), sum(seqs_k)
    q_b, kv_b = tq * hq * d * itemsize, tk * hkv * (d + dv) * itemsize
    do_b, rows_b = tq * hq * dv * itemsize, 2 * hq * tq * 4
    if kernel == "varlen_dkdv":
        return 2 * pairs * (2 * d + 2 * dv), q_b + 2 * kv_b + do_b + rows_b
    if kernel == "varlen_dq":
        return 2 * pairs * (2 * d + dv), 2 * q_b + kv_b + do_b + rows_b
    raise ValueError(f"unknown varlen backward kernel {kernel!r}")


def paged_decode_counts(lens, *, hq: int, hkv: int, d: int, dv: int, nq: int = 1,
                        itemsize: int = 2, quantized: bool = False) -> tuple:
    """(flop, bytes) of one paged decode call: sequence b's ``lens[b]``
    cached rows of K and V read once per KV head (one byte an element in an
    int8 pool, plus its fp32 row scales), q read and o written once; 2 *
    nq * Hq * (D + Dv) flop per cached row."""
    rows = sum(int(n) for n in lens)
    kv_bytes = rows * hkv * (d + dv) * (1 if quantized else itemsize)
    if quantized:
        kv_bytes += rows * hkv * 2 * 4
    qo_bytes = len(lens) * hq * nq * (d + dv) * itemsize
    return 2 * nq * hq * rows * (d + dv), kv_bytes + qo_bytes


def launch_counts(zero: bool = False) -> dict:
    """Each kernel wrapper's launch count (set to 0 first with ``zero``),
    under the kernel's name in ``chip_smoke.py``'s ``kernels`` line. A
    wrapper counts a launch of its kernel only; calls on CPU tensors run
    the plain version and count nothing. The dK/dV kernel writing an e4m3
    dS slab and banded dQ reading one count apart, as ``dkdv_fp8_ds`` and
    ``banded_dq_fp8_ds``."""
    from ..ops import decode, flash_bwd, flash_fwd, paged, varlen

    bwd = varlen._varlen_backward
    fns = {"flash_fwd": flash_fwd.flash_attention_forward, "dkdv": flash_bwd._dkdv_launch,
           "dq": flash_bwd._dq_launch, "banded_dq": flash_bwd._banded_dq_from_ds,
           "dkdv_from_s": flash_bwd._dkdv_from_s_launch, "banded_dk": flash_bwd._banded_dk_from_ds,
           "decode": decode._decode_forward, "varlen_fwd": varlen._varlen_forward,
           "paged_decode": paged.paged_decode_attention}
    fp8 = {"dkdv_fp8_ds": flash_bwd._dkdv_launch, "banded_dq_fp8_ds": flash_bwd._banded_dq_from_ds}
    if zero:
        for fn in fns.values():
            fn.launches = 0
        for fn in fp8.values():
            fn.fp8_launches = 0
        bwd.dkdv_launches = bwd.dq_launches = 0
    return dict({n: fn.launches for n, fn in fns.items()}, varlen_dkdv=bwd.dkdv_launches,
                varlen_dq=bwd.dq_launches, **{n: fn.fp8_launches for n, fn in fp8.items()})


def cuda_ms(fn: Callable, reps: int = 20, warmup: int = 3) -> float:
    """Mean time per call of ``fn`` between CUDA events over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(calls: Callable, cycles: int = 50_000_000) -> float:
    """Device ms of the work ``calls()`` enqueues, from CUDA events with the
    host's enqueue taken out: a spin kernel (``torch.cuda._sleep``) holds
    the stream while the host enqueues the work between two events, so the
    device runs it back to back. Where the host took longer to enqueue than
    the spin lasted, the spin is doubled and ``calls`` run again (a
    backward, which runs once, enqueues in well under the spin). No
    profiler: its device events can be lost (``device_window``)."""
    while True:
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        calls()
        ev[2].record()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].synchronize()
        if ev[0].elapsed_time(ev[1]) > host_ms:
            return ev[1].elapsed_time(ev[2])
        cycles *= 2


class LostDeviceEvents(RuntimeError):
    """torch.profiler recorded no device event in a window of device work."""


def device_window(fn: Callable, reps: int = 1, warmup: int = 1) -> dict:
    """Profile ``reps`` calls of ``fn``: {"device_ms": total device time,
    "wall_ms": the window's wall-clock time, "busy": device_ms / wall_ms,
    "by_kernel": {name: device ms}}. A window in which the profiler
    recorded no device event (it lost them: seen on an H100 in a window of
    ten matmuls, and in processes that had run large windows before) is
    profiled again once; a second such window raises ``LostDeviceEvents``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_kernel: dict = defaultdict(float)
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_kernel[e.name] += e.time_range.elapsed_us() / 1e3
        total = sum(by_kernel.values())
        if total > 0.0:
            return dict(device_ms=total, wall_ms=wall_ms, busy=total / wall_ms,
                        by_kernel=dict(by_kernel))
    raise LostDeviceEvents("torch.profiler recorded no device time, twice")


def device_ms(fn: Callable, reps: int = 10, warmup: int = 3) -> float:
    """Device time per call of the kernels ``fn`` launches (profiler)."""
    return device_window(fn, reps=reps, warmup=warmup)["device_ms"] / reps


__all__ = [
    "PEAK_BF16_FLOPS", "PEAK_HBM_BW", "trace", "kernel_cost_summary", "bound_ms", "band_pairs",
    "backward_counts",
    "varlen_counts", "varlen_backward_counts", "paged_decode_counts", "launch_counts", "cuda_ms",
    "queued_ms", "LostDeviceEvents", "device_window", "device_ms",
]
