"""Autotune CLI: sweep the task grid on the card, keep each task's fastest
config, merge-write the device's tuned-config file.

    python -m ffpa_attn_tpu_torch.autotune [--directions fwd bwd decode varlen]
        [--dtypes bfloat16 float16] [--headdims ...] [--seqlens ...]
        [--B 1] [--H 8] [--full-tasks] [--cross-tasks] [--skip-stored]
        [--isolate-tasks] [--num-workers N] [--output-dir DIR] [--device cpu]

The counterpart of the JAX package's ``autotune/cli.py``, with its task
grid and flags. What a task searches is ``search.py``'s: the backward
rings' cap and the e4m3 dS storage (``bwd``), the packed backward pair's
ring cap (``varlen``), and for ``fwd`` and ``decode`` the plan alone (the
forward's ring is fixed at compile time, ``csrc/flash_fwd.cu``
``stages_of``, and decode's split count is its rule's; the entry records
the plan's time as ``verify``'s baseline). A candidate replaces the plan
only where it beats it by more than the plan's own spread
(``search.search``); otherwise the entry holds the plan. Entries land in
``--output-dir``, else ``FFPA_TORCH_TUNED_CONFIG_DIR``, else the bundled
``configs/``.
"""

from __future__ import annotations

import argparse
import math
import time
from dataclasses import asdict, dataclass
from typing import Optional

from ..logger import init_logger

logger = init_logger(__name__)

DEFAULT_HEADDIMS = (320, 512, 640, 768, 1024)
DEFAULT_SEQLENS = (1024, 2048, 4096, 8192, 16384)


@dataclass(frozen=True)
class TuneTask:
    """One autotune case."""

    direction: str  # 'fwd' | 'bwd' | 'decode' | 'varlen'
    d: int
    nq: int
    nkv: int
    dtype: str
    causal: bool
    has_bias: bool = False
    dropout: bool = False
    gqa: bool = False  # Hkv = H // 4
    mqa: bool = False  # Hkv = 1
    b: int = 1
    h: int = 8

    @property
    def hkv(self) -> int:
        if self.mqa:
            return 1
        if self.gqa:
            return max(self.h // 4, 1)
        return self.h

    @property
    def group(self) -> int:
        g = self.h // self.hkv
        return g if g > 1 else 0


def _qkv_fits(b: int, h: int, n: int, d: int) -> bool:
    """Q, K, V and O of a task in at most half the card's memory
    (``ENV.hbm_bytes``): the JAX package's prune, which kept 8 GiB of a
    16 GB TPU."""
    from ..env import ENV

    return 4 * b * h * n * d * 2 <= ENV.hbm_bytes() // 2


def iter_tasks(args) -> list:
    tasks: list = []
    for direction in args.directions:
        for dtype in args.dtypes:
            for d in args.headdims:
                if direction in ("decode", "varlen"):
                    # Decode: Nq = 1 against each KV length; varlen: the packed
                    # total T per seqlen. Both keyed causal=False (varlen is
                    # timed causal, its common use).
                    for n in args.seqlens:
                        tasks.append(TuneTask(direction, d, 1 if direction == "decode" else n, n,
                                              dtype, False, b=args.B, h=args.H))
                        if args.full_tasks and direction == "decode":
                            tasks.append(TuneTask(direction, d, 1, n, dtype, False, gqa=True,
                                                  b=args.B, h=args.H))
                    continue
                if args.cross_tasks:
                    # Short-Nq cross attention (Nq = Nkv // 8).
                    for n in args.seqlens:
                        if n // 8 < 128:
                            continue
                        tasks.append(TuneTask(direction, d, n // 8, n, dtype, False, b=args.B,
                                              h=args.H))
                for n in args.seqlens:
                    if not _qkv_fits(args.B, args.H, n, d):
                        continue
                    for causal in (False, True):
                        tasks.append(TuneTask(direction, d, n, n, dtype, causal, b=args.B,
                                              h=args.H))
                        if args.full_tasks and not causal:
                            for extra in (dict(has_bias=True), dict(dropout=True),
                                          dict(gqa=True), dict(mqa=True)):
                                tasks.append(TuneTask(direction, d, n, n, dtype, False,
                                                      b=args.B, h=args.H, **extra))
    return tasks


def task_key(task: TuneTask):
    """The store key a task's entry lands under (``run_task`` and the
    ``--skip-stored`` filter)."""
    from .store import ConfigKey

    return ConfigKey(direction=task.direction, dtype=task.dtype, headdim=task.d,
                     headdim_v=task.d, seqlen_q=task.nq, seqlen_k=task.nkv, causal=task.causal,
                     has_bias=task.has_bias, dropout=task.dropout, gqa=task.gqa or task.mqa,
                     group=task.group)


def run_task(task: TuneTask, mode: str, device=None) -> Optional[dict]:
    """Tune one task on ``device`` (``resolve_device``: the card unless the
    caller asks for the CPU). Inputs come from a torch.Generator seeded 0.
    Returns the store entry (its ``tried`` list holds every reading, the
    plan's between the others', and ``plan_spread`` the plan's max - min),
    or None if every candidate failed."""
    import torch

    from ..env import resolve_device
    from .search import autotune_backward, autotune_decode, autotune_forward, autotune_varlen
    from .store import make_entry

    dev = resolve_device(device)
    dtype = getattr(torch, task.dtype)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dt=dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=dt)

    hkv = task.hkv
    q = randn(task.b, task.h, task.nq, task.d)
    k = randn(task.b, hkv, task.nkv, task.d)
    v = randn(task.b, hkv, task.nkv, task.d)
    bias = randn(task.b, task.h, task.nq, task.nkv, dt=torch.float32) if task.has_bias else None
    scale = 1.0 / task.d ** 0.5
    dropout_p = 0.1 if task.dropout else 0.0
    if task.direction == "decode":
        found = autotune_decode(q, k, v, scale=scale, mode=mode)
    elif task.direction == "varlen":
        # A mixed packing: 4 segments of T / 4.
        t = task.nkv
        cu = torch.tensor([0, t // 4, t // 2, 3 * t // 4, t], dtype=torch.int32, device=dev)
        q3, k3, v3 = (x[0].transpose(0, 1)[:t].contiguous() for x in (q, k, v))
        found = autotune_varlen(q3, k3, v3, cu, t // 4, scale=scale, mode=mode)
    else:
        tune = autotune_forward if task.direction == "fwd" else autotune_backward
        found = tune(q, k, v, bias, scale=scale, is_causal=task.causal, dropout_p=dropout_p,
                     mode=mode)
    if found.config is None:
        return None
    tried = [[asdict(c), ms] for c, ms in found.tried]
    entry = make_entry(task_key(task), found.config, ms=found.ms, tried=tried)
    if math.isfinite(found.plan_spread):
        entry["plan_spread"] = found.plan_spread
    return entry


def stored_task_keys(device_kind: Optional[str] = None) -> set:
    """The keys the device's store holds, normalised through ConfigKey (an
    entry written before a key field existed matches its task)."""
    from .store import ConfigKey, _entries_for_device, current_device_kind

    names = set(ConfigKey.__dataclass_fields__)
    stored = set()
    for e in _entries_for_device(device_kind or current_device_kind(initialise=True)):
        kd = e.get("key")
        if not isinstance(kd, dict):
            continue
        try:
            norm = ConfigKey(**{k: v for k, v in kd.items() if k in names})
        except TypeError:
            continue
        stored.add(tuple(sorted(norm.to_json().items())))
    return stored


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m ffpa_attn_tpu_torch.autotune",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--mode", choices=["fast", "max"], default="fast",
                        help="kept for the JAX CLI's flags: the Hopper knobs have one space, "
                        "which both modes search (max doubles the isolated task budget)")
    parser.add_argument("--directions", nargs="*", default=["fwd", "bwd"],
                        choices=["fwd", "bwd", "decode", "varlen"],
                        help="fwd and decode time the plan alone: the forward's ring is fixed "
                        "at compile time (csrc/flash_fwd.cu stages_of) and decode's split count "
                        "is its rule's, so their entries are verify's baseline")
    parser.add_argument("--dtypes", nargs="*", default=["bfloat16"],
                        choices=["bfloat16", "float16"])
    parser.add_argument("--headdims", type=int, nargs="*", default=list(DEFAULT_HEADDIMS))
    parser.add_argument("--seqlens", type=int, nargs="*", default=list(DEFAULT_SEQLENS))
    parser.add_argument("--B", type=int, default=1)
    parser.add_argument("--H", type=int, default=8)
    parser.add_argument("--full-tasks", action="store_true")
    parser.add_argument("--cross-tasks", action="store_true",
                        help="add short-Nq cross-attention tasks (Nq = Nkv // 8)")
    parser.add_argument("--overwrite", action="store_true",
                        help="no-op, kept for the JAX CLI's flags: a freshly measured entry "
                        "always replaces the stored one at its key (other keys are kept)")
    parser.add_argument("--num-workers", type=int, default=1,
                        help="worker processes, one per card (CUDA_VISIBLE_DEVICES)")
    parser.add_argument("--isolate-tasks", action="store_true",
                        help="run tasks in a worker process with a hard deadline, killed and "
                        "respawned on overrun; each entry is merge-written at once")
    parser.add_argument("--output-dir", default=None)
    parser.add_argument("--skip-stored", action="store_true",
                        help="drop tasks whose exact store key already has an entry")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card); cpu runs the plain path")
    args = parser.parse_args(argv)

    tasks = iter_tasks(args)
    if args.skip_stored:
        stored = stored_task_keys()
        before = len(tasks)
        tasks = [t for t in tasks if tuple(sorted(task_key(t).to_json().items())) not in stored]
        logger.info("--skip-stored: %d/%d tasks already have entries; %d to run",
                    before - len(tasks), before, len(tasks))
    logger.info("autotune: %d tasks, mode=%s", len(tasks), args.mode)

    if args.isolate_tasks:
        from .engine import run_isolated_autotune

        entries = run_isolated_autotune(tasks, args)
        logger.info("autotune finished: %d entries", len(entries))
        return 0
    if args.num_workers > 1:
        from .engine import run_multiprocess_autotune

        entries = run_multiprocess_autotune(tasks, args)
    else:
        entries = []
        t_start = time.time()
        for i, task in enumerate(tasks):
            t0 = time.time()
            try:
                entry = run_task(task, args.mode, args.device)
            except Exception as exc:
                logger.warning("task %s failed: %s", task, str(exc)[:200])
                continue
            if entry is not None:
                entries.append(entry)
                logger.info("[AUTOTUNED][%d/%d] %s d=%d n=%d causal=%s -> %s t=%.1fs", i + 1,
                            len(tasks), task.direction, task.d, task.nq, task.causal,
                            entry["config"], time.time() - t0)
        logger.info("autotune finished: %d entries in %.1fs", len(entries),
                    time.time() - t_start)

    from .store import current_device_kind, write_config_file

    path = write_config_file(entries, directory=args.output_dir, overwrite=True,
                             device_kind=current_device_kind(initialise=args.device != "cpu"))
    logger.info("wrote %s", path)
    return 0
