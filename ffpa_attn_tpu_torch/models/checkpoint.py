"""Checkpoint and resume of the training state.

The state is what the train step holds: the model's parameters, the AdamW
state (``count``, ``mu``, ``nu``), the step, and the ``ModelConfig`` it was
trained under. Each step is one file, ``ckpt_<step>.pt``, written with
``torch.save`` and read with ``torch.load(..., weights_only=True)``. The
file holds the whole model, whatever layout it was trained in.

* A save is atomic: it writes a temporary file in the same directory,
  flushes it to disk and renames it over the step's name, so a reader sees
  a whole checkpoint or none; a temporary file left by a crash is never
  taken for a step.
* ``max_to_keep`` steps are kept; older ones are deleted after each save.
* Restore validates the checkpoint against live templates (a freshly built
  model and ``optimizer.init``): the config, every tensor's name, whole
  shape and dtype must match, or it raises. It copies into the templates in
  place, on their device, so a resumed run continues the optimizer's
  trajectory bit for bit.
* Over a mesh (``mesh=``, the ``DeviceMesh`` of ``make_train_step``, its
  leaves cut on the "tp" axis), every rank calls both, and ``directory``
  must be on storage that every rank shares. The save gathers the tp-cut
  leaves and their moments within global rank 0's tp group (as
  ``convert.gather_train_state`` gathers them); rank 0 alone
  writes and prunes, since dp and sp replicas hold the same state after
  the step's all-reduce; a world all-reduce of rank 0's status then
  returns on every rank once the step is durable, or raises on every rank
  if rank 0 failed. The restore first agrees over the world that every
  rank sees the same step's file (or every rank raises), reads the whole
  file on every rank and keeps the rank's tp slices
  (``convert.shard_train_state``), so a checkpoint saved under any
  dp x tp x sp restores into one process or into any mesh whose tp divides
  Hq and Hkv.
"""

from __future__ import annotations

import dataclasses
import os
import re
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.mesh import axis_rank, axis_size
from .convert import _check_moments, _cut_dim, _whole_leaves, shard_train_state
from .transformer import Transformer

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step}.pt")


def _steps(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m)


def _opt_tensors(opt_state: dict) -> dict:
    return {f"{key}.{i}": t for key in ("mu", "nu") for i, t in enumerate(opt_state[key])}


def _whole_shape(t: torch.Tensor, dim: Optional[int], tp: int) -> tuple:
    shape = list(t.shape)
    if dim is not None:
        shape[dim] *= tp
    return tuple(shape)


def _check_layout(model: Transformer, tp: int) -> None:
    """``model``'s leaves are its config's cut ``tp`` ways (whole at tp 1)."""
    dim = _cut_dim(model.cfg)
    whole = Transformer(model.cfg, device="meta").state_dict()
    for name, t in model.state_dict().items():
        want = tuple(whole[name].shape)
        if _whole_shape(t, dim(name), tp) != want:
            raise ValueError(f"{name} holds {tuple(t.shape)} of the config's {want}: not a "
                             f"shard_params model over tp={tp} (pass the mesh it was cut on)")


def _write(directory: str, step: int, payload: dict, max_to_keep: int) -> None:
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".ckpt_", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, _path(directory, step))
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    for old in _steps(directory)[:-max_to_keep]:
        os.unlink(_path(directory, old))


def _payload(step: int, model: Transformer, state: dict, opt_state: dict) -> dict:
    return {
        "step": int(step),
        "config": dataclasses.asdict(model.cfg),
        "model": state,
        "opt_state": {"count": int(opt_state["count"]), "mu": list(opt_state["mu"]),
                      "nu": list(opt_state["nu"])},
    }


def save_train_state(directory: str, step: int, model: Transformer, opt_state: dict, *,
                     max_to_keep: int = 3, mesh=None) -> None:
    """Persist (model, opt_state) at ``step``; atomic, with the newest
    ``max_to_keep`` steps kept. With ``mesh`` every rank calls it with its
    ``shard_params`` model and state; one file of the whole state is
    written by global rank 0 into ``directory``, which every rank must
    share, and every rank returns once it is durable. Raises ValueError
    when ``model`` is not its config cut over ``mesh``'s "tp" axis (a shard
    saved without its mesh)."""
    _check_layout(model, axis_size(mesh, "tp"))
    _check_moments(model, opt_state)  # here, on every rank, not only in the gathering ones
    if mesh is None or mesh.size() == 1:
        _write(directory, step, _payload(step, model, model.state_dict(), opt_state),
               max_to_keep)
        return
    writer = dist.get_rank() == 0
    state, mu, nu = {}, [], []
    # The gathers run within each tp group; only rank 0's group (dp 0, sp 0)
    # supplies the file, so the other groups skip them.
    if all(axis_rank(mesh, axis) == 0 for axis in mesh.mesh_dim_names if axis != "tp"):
        for name, p, m, v in _whole_leaves(model, opt_state, mesh):
            if writer:  # only the writer keeps the gathered copy, on the host
                state[name] = p.cpu()
                mu.append(m.cpu())
                nu.append(v.cpu())
    error = None
    if writer:
        try:
            _write(directory, step, _payload(step, model, state, dict(opt_state, mu=mu, nu=nu)),
                   max_to_keep)
        except Exception as e:  # re-raised below, after the other ranks have been told
            error = e
        del state, mu, nu
    failed = torch.tensor([float(error is not None)], device=next(model.parameters()).device)
    dist.all_reduce(failed)  # every rank waits here for rank 0's write and prune
    if error is not None:
        raise error
    if failed.item():
        raise RuntimeError(f"rank 0 failed to save step {step} under {directory}")


def latest_step(directory: str) -> Optional[int]:
    """The newest checkpointed step in ``directory``, or None."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def _found_on_every_rank(step: Optional[int], found: bool, device) -> bool:
    """Whether every rank of the world found the file of one same step."""
    s = -1 if step is None else int(step)
    flags = torch.tensor([s, -s, int(not found)], dtype=torch.int64, device=device)
    dist.all_reduce(flags, op=dist.ReduceOp.MAX)
    top, neg_low, missing = flags.tolist()
    return top == -neg_low and not missing


def _check(label: str, got: dict, want: dict) -> None:
    """``want``: name -> (whole shape, dtype)."""
    if sorted(got) != sorted(want):
        raise ValueError(f"checkpoint {label} names differ from the template's: "
                         f"{sorted(set(got) ^ set(want))}")
    for name, (shape, dtype) in want.items():
        g = got[name]
        if tuple(g.shape) != shape or g.dtype != dtype:
            raise ValueError(f"checkpoint {label} {name}: {tuple(g.shape)} {g.dtype}, "
                             f"the template's {shape} {dtype} (whole)")


def restore_train_state(directory: str, model: Transformer, opt_state_template: dict, *,
                        step: Optional[int] = None, mesh=None):
    """Restore (model, opt_state, step) into the templates, in place on
    their device: ``model`` a freshly built one of the same config (with
    ``mesh``, its ``shard_params`` cut on every rank), ``opt_state_template``
    its ``optimizer.init(list(model.parameters()))``. The newest step
    unless ``step`` is given. Raises FileNotFoundError when there is
    nothing to restore (with ``mesh``: when any rank does not see the same
    step's file, so ``directory`` must be on storage that every rank
    shares) and ValueError when the checkpoint's config, names, whole
    shapes or dtypes differ from the templates'. Every rank raises alike:
    the file's presence is agreed over the world, and each rank checks the
    file's contents on its own."""
    if step is None:
        step = latest_step(directory)
    path = None if step is None else _path(directory, step)
    found = path is not None and os.path.isfile(path)
    shared = mesh is not None and mesh.size() > 1
    if shared:
        found = _found_on_every_rank(step, found, next(model.parameters()).device)
    if not found:
        raise FileNotFoundError(f"no checkpoint{'' if step is None else f' of step {step}'} "
                                f"under {directory}"
                                + (" on every rank (it must be on storage that every rank shares)"
                                   if shared else ""))
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if ckpt["config"] != dataclasses.asdict(model.cfg):
        raise ValueError(f"checkpoint config {ckpt['config']} is not the model's {model.cfg}")
    tp = axis_size(mesh, "tp")
    dim = _cut_dim(model.cfg)
    names = [name for name, _ in model.named_parameters()]
    params = dict(model.named_parameters())
    _check("model", ckpt["model"],
           {n: (_whole_shape(params[n], dim(n), tp), params[n].dtype) for n in names})
    moment_dim = {f"{key}.{i}": dim(n) for key in ("mu", "nu") for i, n in enumerate(names)}
    _check("optimizer", _opt_tensors(ckpt["opt_state"]),
           {k: (_whole_shape(t, moment_dim.get(k), tp), t.dtype)
            for k, t in _opt_tensors(opt_state_template).items()})
    state, moments = shard_train_state({n: ckpt["model"][n] for n in names}, ckpt["opt_state"],
                                       mesh, model.cfg)
    with torch.no_grad():
        for n in names:
            params[n].copy_(state[n])
        for key in ("mu", "nu"):
            for dst, src in zip(opt_state_template[key], moments[key]):
                dst.copy_(src)
    opt_state = dict(opt_state_template, count=ckpt["opt_state"]["count"])
    return model, opt_state, int(ckpt["step"])


__all__ = ["save_train_state", "restore_train_state", "latest_step"]
