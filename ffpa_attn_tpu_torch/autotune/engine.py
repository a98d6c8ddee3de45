"""Worker processes of the autotune: one per card, or one with a deadline.

The counterpart of the JAX package's ``autotune/engine.py``.
``run_multiprocess_autotune`` spreads the tasks over one spawned worker per
card, each pinned by ``CUDA_VISIBLE_DEVICES`` before it touches CUDA.
``run_isolated_autotune`` runs the tasks in one reusable worker with a
hard deadline per task: an overrun (or a dead worker) kills it and the
next task gets a fresh one, and each entry is merge-written to the store
as soon as it lands, so a long sweep survives a crash. Workers share the
kernel build directory; ``ops/_build.py`` builds under a file lock there,
so two workers never compile one library at once.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as pyqueue
import time
import traceback
from typing import Any

from ..logger import init_logger

logger = init_logger(__name__)

# A reused isolated worker is retired after this many tasks (a leak
# backstop); each respawn pays the import and CUDA start-up once.
RECYCLE_AFTER = 12


def _task_result(task, mode, device) -> tuple:
    """(device name, entry or None) of one task run here."""
    from .cli import run_task
    from .store import current_device_kind

    entry = run_task(task, mode, device)
    return current_device_kind(initialise=device != "cpu"), entry


def _worker_run(job: tuple):
    """Run one task pinned to card ``index``; the traceback on failure."""
    index, task, mode, device = job
    os.environ["CUDA_VISIBLE_DEVICES"] = str(index)
    try:
        return _task_result(task, mode, device)
    except Exception:
        return traceback.format_exc()


def run_multiprocess_autotune(tasks, args) -> list:
    """Fill-then-drain over a pool of one worker per card; a failed task is
    logged and skipped, never retried. Entries are written by the caller."""
    ctx = mp.get_context("spawn")
    entries: list[dict[str, Any]] = []
    t_start = time.time()
    jobs = [(i % args.num_workers, task, args.mode, getattr(args, "device", None))
            for i, task in enumerate(tasks)]
    with ctx.Pool(processes=args.num_workers) as pool:
        for i, result in enumerate(pool.imap_unordered(_worker_run, jobs)):
            if isinstance(result, str):
                logger.warning("autotune task failed: %s", result[:300])
                continue
            if result[1] is not None:
                entries.append(result[1])
                logger.info("[AUTOTUNED][%d/%d] %s t=%.1fs", i + 1, len(tasks),
                            result[1].get("key", {}), time.time() - t_start)
    return entries


def _worker_loop(task_q, result_q):  # pragma: no cover - runs in the worker process
    """Serve tasks until a None arrives."""
    while True:
        item = task_q.get()
        if item is None:
            return
        task, mode, device = item
        try:
            result_q.put(_task_result(task, mode, device))
        except Exception:
            result_q.put(traceback.format_exc())


def _task_budget(task, mode: str) -> int:
    """Seconds a task may take: 900 (2400 at 16K tokens and beyond), twice
    that in max mode, or ``FFPA_TORCH_AUTOTUNE_TASK_BUDGET_S`` where it is a
    positive integer."""
    budget = 900 if max(task.nq, task.nkv) < 16384 else 2400
    if mode == "max":
        budget *= 2
    raw = os.environ.get("FFPA_TORCH_AUTOTUNE_TASK_BUDGET_S")
    if raw:
        try:
            override = int(raw)
        except ValueError:
            logger.warning("ignoring non-integer FFPA_TORCH_AUTOTUNE_TASK_BUDGET_S=%r", raw)
        else:
            if override > 0:
                return override
            logger.warning("ignoring non-positive FFPA_TORCH_AUTOTUNE_TASK_BUDGET_S=%r", raw)
    return budget


def run_isolated_autotune(tasks, args) -> list:
    """Each task in a reusable worker process with a hard deadline; every
    entry merge-written to the store at once (a fresh measurement replaces
    the stored entry at its key)."""
    from .store import write_config_file

    ctx = mp.get_context("spawn")
    device = getattr(args, "device", None)
    entries: list[dict[str, Any]] = []
    t_start = time.time()
    state: dict[str, Any] = dict(worker=None, task_q=None, result_q=None, served=0)

    def spawn():
        state["task_q"], state["result_q"] = ctx.Queue(), ctx.Queue()
        state["worker"] = ctx.Process(target=_worker_loop,
                                      args=(state["task_q"], state["result_q"]), daemon=True)
        state["worker"].start()
        state["served"] = 0

    def retire(kill: bool):
        worker = state["worker"]
        if worker is None:
            return
        if kill:
            worker.kill()
        else:
            state["task_q"].put(None)
        worker.join(timeout=30)
        if worker.is_alive():
            worker.kill()
            worker.join()
        state["worker"] = None

    try:
        for i, task in enumerate(tasks):
            budget = _task_budget(task, args.mode)
            if state["worker"] is not None and state["served"] >= RECYCLE_AFTER:
                retire(kill=False)
            if state["worker"] is None or not state["worker"].is_alive():
                spawn()
            worker, result_q = state["worker"], state["result_q"]
            t0 = time.time()
            state["task_q"].put((task, args.mode, device))
            state["served"] += 1
            deadline = t0 + budget
            pending = object()
            result = pending
            while time.time() < deadline:
                try:
                    result = result_q.get(timeout=min(5.0, max(0.1, deadline - time.time())))
                    break
                except pyqueue.Empty:
                    if not worker.is_alive():
                        break
            if result is pending and not worker.is_alive():
                try:  # a result put just before the worker exited
                    result = result_q.get(timeout=5)
                except pyqueue.Empty:
                    pass
            if result is pending:
                alive = worker.is_alive()
                retire(kill=True)
                logger.warning("[AUTOTUNE][%d/%d] %s d=%d n=(%d,%d): %s", i + 1, len(tasks),
                               task.direction, task.d, task.nq, task.nkv,
                               f"exceeded {budget}s; killed" if alive else "worker died")
                continue
            if isinstance(result, str):
                logger.warning("autotune task failed: %s", result[:300])
                retire(kill=True)
                continue
            kind, entry = result
            if entry is not None:
                entries.append(entry)
                write_config_file([entry], device_kind=kind, directory=args.output_dir,
                                  overwrite=True)
                logger.info("[AUTOTUNED][%d/%d] %s d=%d n=%d causal=%s -> %s t=%.1fs "
                            "(%.0fs total)", i + 1, len(tasks), task.direction, task.d, task.nkv,
                            task.causal, entry["config"], time.time() - t0,
                            time.time() - t_start)
    finally:
        retire(kill=False)
    return entries


__all__ = ["run_multiprocess_autotune", "run_isolated_autotune", "RECYCLE_AFTER"]
