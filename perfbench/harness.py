"""One run of one cell: set-up, the measured window, the traced window,
the check against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file found by name: ``BENCHMARK.json`` names the cell's configuration
(its ``file``) and mix (``traffic/<mix>.json``); the mix names its driver
(``drivers/<driver>.py``); each metric is read by ``e2e/<metric>.py`` or
``metrics/<metric>.py``; the check's limits are ``limits/<cell>.json``.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from . import devtrace

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = ROOT / "perfbench"
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "ffpa_attn_tpu")
# Steps run in set-up after the state is drawn, and steps traced after the window.
WARMUP_STEPS = 2
TRACE_STEPS = 8


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def _for_cell(metrics, cell: str) -> list:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def cell_spec(name: str, bench: dict | None = None) -> dict:
    """The cell ``name`` resolved to its files: the configuration, the mix,
    the check's limits and the metrics it reports."""
    bench = benchmark() if bench is None else bench
    cell = _named(bench["workloads"], name, "workload")
    entry = _named(bench["configs"], cell["config"], "configuration")
    return dict(
        name=name, cell=cell,
        config=load_json(ROOT / entry["file"]),
        mix=load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json"),
        limits=load_json(BENCH_DIR / "limits" / f"{name}.json"),
        end_to_end=_for_cell(bench["end_to_end"], name),
        per_layer=_for_cell(bench["per_layer"], name),
    )


def reader(kind: str, metric: str):
    """The ``read`` function of ``<kind>/<metric>.py`` (kind "e2e" or
    "metrics"); a metric's name may hold dots, so the file is loaded by path."""
    path = BENCH_DIR / kind / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{metric.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver_class(mix: dict):
    return importlib.import_module(f"perfbench.drivers.{mix['driver']}").Driver


def forbidden_modules() -> list:
    """Top-level names of loaded modules that a run may not load, each
    compared whole (``ffpa_attn_tpu_torch`` is not ``ffpa_attn_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


def card_info() -> dict:
    """The card's name, as torch gives it, and its power limit (nvidia-smi)."""
    info = {"kind": torch.cuda.get_device_name(0), "power_limit": "unknown"}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        if out.returncode == 0 and out.stdout.strip():
            info["power_limit"] = out.stdout.strip().splitlines()[0].split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return info


@dataclass
class Window:
    """The measured window, as the end-to-end readers see it."""

    steps: int
    window_s: float
    step_ms: list
    tokens: int
    setup_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _FullCollections:
    """The host's pauses for full (generation 2) garbage collections, in
    ms: the device idles through any that outlasts the work queued."""

    def __init__(self):
        self.ms: list = []
        self._start = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if info["generation"] != 2:
            return
        if phase == "start":
            self._start = time.perf_counter()
        else:
            self.ms.append((time.perf_counter() - self._start) * 1e3)


def log(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def run_cell(spec: dict, *, seed: int, seconds: float, trace: bool, device="cuda",
             t0: float | None = None, pool: str = "bf16", controls=()) -> dict:
    """One run of the cell ``spec`` (``cell_spec``): the result's fields,
    and under ``control_readings`` the check's numbers for each of
    ``controls`` put in the program's place."""
    t0 = time.perf_counter() if t0 is None else t0
    marks = [time.perf_counter()]
    dev = torch.device(device)
    mix = spec["mix"]
    drv = driver_class(mix)(spec["config"], mix, seed, dev, pool=pool)
    _sync(dev)
    marks.append(time.perf_counter())
    for i in range(WARMUP_STEPS):
        drv.step(i)
        _sync(dev)
    marks.append(time.perf_counter())
    setup_s = marks[-1] - t0
    phases = {"start": marks[0] - t0, "state": marks[1] - marks[0], "warmup": marks[2] - marks[1]}

    # Set-up's objects leave the collector's scans, as in a long-running
    # server, so a full collection in the window scans only what it made.
    gc.collect()
    gc.freeze()
    full_gc = _FullCollections()
    drv.recording = True
    gc.callbacks.append(full_gc)
    try:
        # Each step on the host's clock, from its first call to the return
        # of the synchronize that ends it: the time a user waits for a token.
        ends = [time.perf_counter()]
        while True:
            drv.step(WARMUP_STEPS + len(ends) - 1)
            _sync(dev)
            ends.append(time.perf_counter())
            if ends[-1] - ends[0] >= seconds:
                break
    finally:
        gc.callbacks.remove(full_gc)
    drv.recording = False
    steps, window_s = len(ends) - 1, ends[-1] - ends[0]
    win = Window(steps=steps, window_s=window_s,
                 step_ms=[(b - a) * 1e3 for a, b in zip(ends, ends[1:])],
                 tokens=steps * drv.tokens_per_step(), setup_s=setup_s)

    dtrace = None
    if trace:
        base = WARMUP_STEPS + steps
        rf = torch.profiler.record_function

        def traced(i):
            with rf(devtrace.STEP_SPAN):
                drv.step(base + i, spans=True)
                with rf("perfbench.sync"):
                    _sync(dev)

        dtrace = devtrace.profile_steps(traced, TRACE_STEPS)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    counts = drv.counts()
    drv.free()
    gc.unfreeze()
    readings = drv.check()
    control_readings = {c: drv.check(control=c) for c in controls}

    checks, correct = {}, readings["samples"] > 0
    for key, lim in spec["limits"]["limits"].items():
        value = readings[key]
        checks[key] = {"value": value, "limit": lim}
        correct = correct and math.isfinite(value) and value <= lim

    if trace:
        metrics = {}
        for m in spec["per_layer"]:
            value = reader("metrics", m["name"])(dtrace, counts)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": reader("e2e", m["name"])(win), "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    return dict(correct=bool(correct), attempted=win.tokens, failed=0, metrics=metrics,
                window=win, trace=dtrace, memory_peak_bytes=int(peak), checks=checks,
                samples=readings["samples"], control_readings=control_readings,
                setup_phases=phases, full_gc_ms=full_gc.ms)


def result_line(res: dict, device_kind: str, chips: int) -> dict:
    """The last line of standard output, with ``checks`` last."""
    device = {"platform": "gpu", "kind": device_kind, "count": chips,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    out = dict(correct=res["correct"], attempted=res["attempted"], failed=res["failed"],
               metrics=res["metrics"], device=device)
    tr = res["trace"]
    if tr is not None:
        device["busy_s"], device["window_s"] = tr.busy_s, tr.window_s
        out["breakdown"] = {
            "device_ops": devtrace.summarise(tr.by_op.items()),
            "idle_gaps": devtrace.summarise(devtrace.idle_gaps(tr)),
        }
    out["checks"] = res["checks"]
    return out
