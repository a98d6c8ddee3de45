"""Checkpoint and resume of the training state.

The state is what the train step holds: the model's parameters, the AdamW
state (``count``, ``mu``, ``nu``), the step, and the ``ModelConfig`` it was
trained under. Each step is one file, ``ckpt_<step>.pt``, written with
``torch.save`` and read with ``torch.load(..., weights_only=True)``.

* A save is atomic: it writes a temporary file in the same directory,
  flushes it to disk and renames it over the step's name, so a reader sees
  a whole checkpoint or none; a temporary file left by a crash is never
  taken for a step.
* ``max_to_keep`` steps are kept; older ones are deleted after each save.
* Restore validates the checkpoint against live templates (a freshly built
  model and ``optimizer.init``): the config, every tensor's name, shape and
  dtype must match, or it raises. It copies into the templates in place,
  on their device, so a resumed run continues the optimizer's trajectory
  bit for bit.
* One file holds the whole model, so a model cut over tensor parallelism
  (``shard_params``) is refused by both: every tp rank would write its
  slice under the same name and read back another rank's, whose shapes
  are the same.
"""

from __future__ import annotations

import dataclasses
import os
import re
import tempfile
from typing import Optional

import torch

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


def _refuse_tp_shard(model: Transformer) -> None:
    full = model.cfg.n_heads * model.cfg.head_dim
    for i, layer in enumerate(model.layers):
        if layer.wq.weight.shape[0] != full:
            raise ValueError(f"layer {i}'s wq holds {layer.wq.weight.shape[0]} of the config's "
                             f"{full} rows (a tensor-parallel shard): a checkpoint holds the "
                             "whole model, so a shard_params model cannot be saved or restored")


def save_train_state(directory: str, step: int, model: Transformer, opt_state: dict, *,
                     max_to_keep: int = 3) -> None:
    """Persist (model, opt_state) at ``step``; atomic, with the newest
    ``max_to_keep`` steps kept. Raises ValueError for a tensor-parallel
    shard."""
    _refuse_tp_shard(model)
    os.makedirs(directory, exist_ok=True)
    payload = {
        "step": int(step),
        "config": dataclasses.asdict(model.cfg),
        "model": model.state_dict(),
        "opt_state": {"count": int(opt_state["count"]), "mu": list(opt_state["mu"]),
                      "nu": list(opt_state["nu"])},
    }
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


def latest_step(directory: str) -> Optional[int]:
    """The newest checkpointed step in ``directory``, or None."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def _check(label: str, got: dict, want: dict) -> None:
    if sorted(got) != sorted(want):
        raise ValueError(f"checkpoint {label} names differ from the template's: "
                         f"{sorted(set(got) ^ set(want))}")
    for name, t in want.items():
        g = got[name]
        if g.shape != t.shape or g.dtype != t.dtype:
            raise ValueError(f"checkpoint {label} {name}: {tuple(g.shape)} {g.dtype}, "
                             f"the template's {tuple(t.shape)} {t.dtype}")


def restore_train_state(directory: str, model: Transformer, opt_state_template: dict, *,
                        step: Optional[int] = None):
    """Restore (model, opt_state, step) into the templates, in place on
    their device: ``model`` a freshly built one of the same config,
    ``opt_state_template`` its ``optimizer.init(list(model.parameters()))``.
    The newest step unless ``step`` is given. Raises FileNotFoundError when
    there is nothing to restore and ValueError when the checkpoint's config,
    names, shapes or dtypes differ from the templates', or ``model`` is a
    tensor-parallel shard."""
    _refuse_tp_shard(model)
    if step is None:
        step = latest_step(directory)
    path = None if step is None else _path(directory, step)
    if path is None or not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint{'' if step is None else f' of step {step}'} "
                                f"under {directory}")
    dev = next(model.parameters()).device
    ckpt = torch.load(path, map_location=dev, weights_only=True)
    if ckpt["config"] != dataclasses.asdict(model.cfg):
        raise ValueError(f"checkpoint config {ckpt['config']} is not the model's {model.cfg}")
    _check("model", ckpt["model"], model.state_dict())
    _check("optimizer", _opt_tensors(ckpt["opt_state"]), _opt_tensors(opt_state_template))
    with torch.no_grad():
        model.load_state_dict(ckpt["model"])
        for key in ("mu", "nu"):
            for dst, src in zip(opt_state_template[key], ckpt["opt_state"][key]):
                dst.copy_(src)
    opt_state = dict(opt_state_template, count=ckpt["opt_state"]["count"])
    return model, opt_state, int(ckpt["step"])


__all__ = ["save_train_state", "restore_train_state", "latest_step"]
