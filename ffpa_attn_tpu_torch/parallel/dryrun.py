"""One sharded train step of a tiny model on N spawned ranks.

    python -m ffpa_attn_tpu_torch.parallel.dryrun --world N [--device cpu]
        [--backend gloo|nccl]

The counterpart of the JAX package's ``dryrun_multichip``: the mesh is
dp = N/4, tp 2, sp 2 when 4 divides N; dp = N/2, sp 2 when 2 does; dp = N
otherwise. The model is that function's tiny config (vocab 256, dm128, L1,
2 tp heads a tp rank, Dh320, bf16) on zero tokens of length 128 sp + 1,
random weights from numpy seed 0, one AdamW step; then, where sp > 1, its
window variant (window 96, softcap 30, sinks). Rank 0 prints one JSON line
per model with the loss, which must be finite; the exit code is non-zero
if any rank failed.

Ranks run on ``device`` (CUDA unless the caller asks for the CPU; every
rank on card ``rank % cards``) and meet through a file in a temporary
directory. ``backend`` defaults to NCCL on CUDA and gloo on the CPU; two
ranks on one card need gloo (NCCL refuses a duplicate device).

``spawn_ranks`` is the launcher: the tests and ``chip_smoke.py`` start
their ranks with it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import tempfile
import time
import traceback
import uuid
from datetime import timedelta
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RANK_TIMEOUT_S = 60


def _rank_main(rank: int, world: int, backend: str, init_method: str, env: dict,
               fn: Callable, args: tuple) -> None:
    os.environ.update({k: str(v) for k, v in env.items()})
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    if backend == "gloo" and not torch.cuda.is_available():
        torch.set_num_threads(1)
    from .mesh import initialize_distributed

    try:
        initialize_distributed(backend, timedelta(seconds=RANK_TIMEOUT_S),
                               init_method=init_method)
        fn(*args)
        dist.barrier()
    except Exception:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, args: tuple = (), *, backend: str,
                rdzv_dir: Optional[str] = None, env: Optional[dict] = None,
                timeout_s: float = 600) -> None:
    """Run ``fn(*args)`` on ``world`` spawned processes joined in one
    process group (``backend``, a ``file://`` rendezvous in ``rdzv_dir``, a
    temporary directory by default; ``env`` set in each first). Each rank
    has ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set; ``fn`` must be
    importable by name. Raises if a rank fails or the world outlives
    ``timeout_s`` (its ranks are then killed)."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(rdzv_dir or tmp, f'rdzv_{uuid.uuid4().hex}')}"
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, backend, init, dict(env or {}), fn, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.1))
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if alive:
        raise RuntimeError(f"ranks {alive} of {world} still running after {timeout_s} s")
    if any(c != 0 for c in codes):
        raise RuntimeError(f"a rank failed: exit codes {codes}")


def factorise(world: int) -> tuple:
    """(dp, tp, sp) of ``world`` ranks, as the JAX ``dryrun_multichip``."""
    if world % 4 == 0:
        return world // 4, 2, 2
    if world % 2 == 0:
        return world // 2, 1, 2
    return world, 1, 1


def tiny_config(tp: int, sp: int, window: bool = False):
    """The JAX dry run's model and its window variant."""
    from ..models import ModelConfig

    cfg = ModelConfig(vocab_size=256, d_model=128, n_layers=1, n_heads=2 * tp,
                      n_kv_heads=2 * tp, head_dim=320, max_seq_len=512, dtype="bfloat16")
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=96, attn_softcap=30.0, attn_sinks=True)
    return cfg


def _dryrun_rank(world: int, device: str, out: Optional[str]) -> None:
    from ..models import adamw, make_train_step, params_from_jax, random_params, shard_params
    from .mesh import make_mesh

    dp, tp, sp = factorise(world)
    mesh = make_mesh((dp, tp, sp), ("dp", "tp", "sp"), device=device)
    tokens = torch.zeros((dp, 128 * sp + 1), dtype=torch.long)
    rows = []
    for window in ((False, True) if sp > 1 else (False,)):
        cfg = tiny_config(tp, sp, window)
        model = shard_params(params_from_jax(random_params(cfg, seed=0), cfg, device=device),
                             mesh, cfg)
        opt = adamw(1e-3)
        step = make_train_step(cfg, opt, device=device, mesh=mesh, sp_axis="sp")
        _, loss = step(model, opt.init(list(model.parameters())), tokens)
        loss = float(loss)
        if not math.isfinite(loss):
            raise RuntimeError(f"non-finite loss {loss}")
        rows.append({"dryrun": world, "mesh": {"dp": dp, "tp": tp, "sp": sp},
                     "window": window, "loss": loss})
    if dist.get_rank() == 0:
        for row in rows:
            print(json.dumps(row), flush=True)
        if out:
            with open(out, "w") as f:
                json.dump(rows, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--device", default=None)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--out", default=None, help="rank 0 writes its JSON rows here too")
    args = ap.parse_args(argv)
    from ..env import resolve_device

    dev = resolve_device(args.device)
    backend = args.backend or ("nccl" if dev.type == "cuda" else "gloo")
    try:
        spawn_ranks(_dryrun_rank, args.world, (args.world, dev.type, args.out), backend=backend)
    except RuntimeError as exc:
        print(f"dryrun: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
