"""Timing and roofline helpers for the card.

* ``cuda_ms``: mean time per call between CUDA events around back-to-back
  calls; it includes host gaps when the host cannot keep the card busy.
* ``device_window``: the kernels a block of work ran, from ``torch.profiler``
  (CUPTI): device time by kernel name, and the device's busy share of the
  wall-clock window. ``device_ms`` is its device time per call. Both raise
  when the profiler recorded no device time, rather than report another
  clock under the same name.
* ``bound_ms``: the least time the card could take for given operations
  and bytes, at the published H100 SXM peaks.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable

import torch

# Published NVIDIA H100 SXM peaks (dense): bf16/fp16 tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BW = 3.35e12


def bound_ms(flops: float, nbytes: float) -> tuple:
    """(least time in ms, "operations" or "bytes": whichever bounds it)."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BW
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


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


def device_window(fn: Callable, reps: int = 1, warmup: int = 1) -> dict:
    """Profile ``reps`` calls of ``fn``: {"device_ms": total device time,
    "wall_ms": the window's wall-clock time, "busy": device_ms / wall_ms,
    "by_kernel": {name: device ms}}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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
    if total <= 0.0:
        raise RuntimeError("torch.profiler recorded no device time")
    return dict(device_ms=total, wall_ms=wall_ms, busy=total / wall_ms,
                by_kernel=dict(by_kernel))


def device_ms(fn: Callable, reps: int = 10, warmup: int = 3) -> float:
    """Device time per call of the kernels ``fn`` launches (profiler)."""
    return device_window(fn, reps=reps, warmup=warmup)["device_ms"] / reps


__all__ = ["PEAK_BF16_FLOPS", "PEAK_HBM_BW", "bound_ms", "cuda_ms", "device_window", "device_ms"]
