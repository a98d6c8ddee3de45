"""Rank code of ``test_torch_checkpoint_sharded.py``: the body that
``ffpa_attn_tpu_torch.parallel.dryrun.spawn_ranks`` runs in each of 4
spawned processes. It imports only torch, numpy and the port (never JAX)
and writes what each rank saw, as numpy, to ``rank<r>.pkl``.
"""

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from ffpa_attn_tpu_torch.models import (
    ModelConfig,
    adamw,
    gather_params_to_jax,
    gather_train_state,
    latest_step,
    make_train_step,
    params_from_jax,
    random_params,
    restore_train_state,
    save_train_state,
    shard_params,
)
from ffpa_attn_tpu_torch.parallel import make_mesh

SAME_MESH, SINGLE, RACE, UNSAVED = "same_mesh", "single", "race", "shard_without_mesh"
INIT = "init"
SINGLE_PARAMS = "single_params.pkl"


def host_state(state_dict: dict, opt_state: dict) -> dict:
    """A torch-layout train state as fp32 numpy (bf16 exactly), copied:
    a CPU fp32 tensor's ``numpy()`` shares its memory, and the step updates
    the state in place."""

    def np32(t):
        return t.detach().float().cpu().numpy().copy()

    return {"model": {n: np32(t) for n, t in state_dict.items()},
            "mu": [np32(t) for t in opt_state["mu"]], "nu": [np32(t) for t in opt_state["nu"]],
            "count": int(opt_state["count"])}


def _raises(exc, fn):
    try:
        fn()
    except exc as e:
        return str(e)
    return None


def checkpoint_rank(out_dir: str, cfg_kw: dict, device: str) -> None:
    """Every leg of the sharded checkpoint test on this rank:

    * dp1 x tp2 x sp2 (zigzag, N256): a save of the initial state (step 0,
      the JAX reference's ``shard_params`` of ``random_params`` seed 0), a
      step, a save at step 1, the
      uninterrupted step 2; a model of other weights restored from step 1
      takes step 2; each rank's shards compared with ``torch.equal``;
    * the test's single-process save (``SINGLE``) restored into tp2 shards;
    * a restore into a model of another config, and a save of a tp shard
      without its mesh: each must raise ValueError here; a restore where
      only rank 0 sees the file (a directory that is not shared): each
      must raise FileNotFoundError here;
    * dp2 x sp2: steps 1 to 4 saved with ``max_to_keep=2``.
    """
    cfg = ModelConfig(**cfg_kw)
    mesh = make_mesh((1, 2, 2), ("dp", "tp", "sp"), device=device)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 257)))
    opt = adamw(1e-3)
    step = make_train_step(cfg, opt, device=device, mesh=mesh, sp_axis="sp")

    def fresh(seed, cfg=cfg, mesh=mesh):
        model = shard_params(params_from_jax(random_params(cfg, seed), cfg, device=device),
                             mesh, cfg)
        return model, opt.init(list(model.parameters()))

    out = {}
    d = os.path.join(out_dir, SAME_MESH)
    model, state = fresh(0)
    save_train_state(os.path.join(out_dir, INIT), 0, model, state, mesh=mesh)
    state, _ = step(model, state, tokens)
    save_train_state(d, 1, model, state, mesh=mesh)
    out["latest_after_save"] = latest_step(d)
    out["step1_params"] = gather_params_to_jax(model, mesh)
    out["step1"] = host_state(*gather_train_state(model, state, mesh))
    state, loss = step(model, state, tokens)
    resumed, rstate = fresh(9)
    resumed, rstate, out["restored_step"] = restore_train_state(d, resumed, rstate, mesh=mesh)
    rstate, rloss = step(resumed, rstate, tokens)
    out["losses"] = (float(loss), float(rloss))
    out["shards_equal"] = (
        [torch.equal(a, b) for a, b in zip(model.parameters(), resumed.parameters())]
        + [torch.equal(a, b) for key in ("mu", "nu") for a, b in zip(state[key], rstate[key])])
    out["step2"] = host_state(*gather_train_state(model, state, mesh))
    out["resumed_step2"] = host_state(*gather_train_state(resumed, rstate, mesh))

    with open(os.path.join(out_dir, SINGLE_PARAMS), "rb") as f:
        want = shard_params(params_from_jax(pickle.load(f), cfg, device=device), mesh, cfg)
    into, istate = fresh(5)
    into, istate, _ = restore_train_state(os.path.join(out_dir, SINGLE), into, istate, mesh=mesh)
    out["into_tp2_slices_equal"] = [torch.equal(a, b)
                                    for a, b in zip(into.parameters(), want.parameters())]
    out["into_tp2"] = host_state(*gather_train_state(into, istate, mesh))

    other, ostate = fresh(0, cfg=ModelConfig(**dict(cfg_kw, d_model=96)))
    out["config_error"] = _raises(
        ValueError, lambda: restore_train_state(d, other, ostate, mesh=mesh))
    unsaved = os.path.join(out_dir, UNSAVED)
    out["unsaved_error"] = _raises(ValueError, lambda: save_train_state(unsaved, 1, model, state))
    out["unsaved_written"] = os.path.exists(unsaved)
    lone = d if dist.get_rank() == 0 else os.path.join(out_dir, f"lone{dist.get_rank()}")
    out["unshared_error"] = _raises(
        FileNotFoundError, lambda: restore_train_state(lone, *fresh(5), mesh=mesh))

    mesh2 = make_mesh((2, 1, 2), ("dp", "tp", "sp"), device=device)
    whole, wstate = fresh(0, mesh=mesh2)
    race = os.path.join(out_dir, RACE)
    out["race_latest"] = []
    for s in range(1, 5):
        save_train_state(race, s, whole, wstate, max_to_keep=2, mesh=mesh2)
        out["race_latest"].append(latest_step(race))
        # Rank 0 may start the next save before another rank has looked.
        dist.barrier()
    out["race_listing"] = sorted(os.listdir(race))
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.pkl"), "wb") as f:
        pickle.dump(out, f)
