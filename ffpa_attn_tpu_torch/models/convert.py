"""Carry model weights into the port.

``params_from_jax`` turns the JAX package's parameter pytree (nested dicts
and lists, as numpy arrays) into a ``Transformer``. The JAX model computes
``x @ w`` with ``w`` stored [in, out]; ``nn.Linear`` stores its weight
[out, in] and computes ``x @ weight.T``, so the seven projections ``wq``,
``wk``, ``wv``, ``wo``, ``w_up``, ``w_gate`` and ``w_down`` are TRANSPOSED
on the way in. ``embed`` [vocab, d_model], the norms and ``attn_sinks`` are
copied as they are.

``params_to_jax`` is the inverse, as float32 numpy arrays: of the weights,
or of their gradients, so that both can be compared leaf by leaf with the
JAX package's pytrees.

``random_params`` makes such a pytree from a numpy seed, with the shapes and
scales of the JAX package's ``init_params``, for runs that need no JAX.

Tensor parallelism: ``param_specs`` names, per leaf and in torch layout,
the dims cut on the tp axis (the JAX ``param_specs`` with the projections'
two dims swapped); ``shard_params`` keeps a rank's slices of a whole
model, and ``gather_params_to_jax`` is ``params_to_jax`` of the whole model
from its shards (every rank of the tp axis calls it). For checkpoints, in
torch layout and dtypes: ``gather_train_state`` gathers a sharded model's
``state_dict`` and its AdamW moments whole, and ``shard_train_state`` cuts
a whole state back to a rank's slices, as ``shard_params`` does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..env import resolve_device
from .transformer import ModelConfig, Transformer

_TRANSPOSED = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down")
_AS_IS = ("attn_norm", "mlp_norm")


def _tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):  # init_params' leaves
        return x.to(device=device, dtype=dtype)
    # numpy has no bfloat16: go through float32, which holds bf16 exactly.
    return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(device=device, dtype=dtype)


@torch.no_grad()
def params_from_jax(params_np, cfg: ModelConfig, device=None) -> Transformer:
    """A ``Transformer`` on ``device`` (CUDA unless asked otherwise) holding
    the weights of a JAX-layout parameter pytree."""
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    model = Transformer(cfg, device="meta").to_empty(device=dev)
    model.embed.copy_(_tensor(params_np["embed"], dt, dev))
    model.final_norm.copy_(_tensor(params_np["final_norm"], dt, dev))
    if len(params_np["layers"]) != cfg.n_layers:
        raise ValueError(
            f"params have {len(params_np['layers'])} layers, cfg.n_layers={cfg.n_layers}"
        )
    for layer, p in zip(model.layers, params_np["layers"]):
        for name in _TRANSPOSED:
            getattr(layer, name).weight.copy_(_tensor(p[name], dt, dev).T)
        for name in _AS_IS:
            getattr(layer, name).copy_(_tensor(p[name], dt, dev))
        if cfg.attn_sinks:
            layer.attn_sinks.copy_(_tensor(p["attn_sinks"], torch.float32, dev))
    return model


def _pytree(model: Transformer, grads: bool, fetch):
    """The JAX-layout pytree of ``model`` (or of its gradients), each
    leaf's fp32 tensor passed through ``fetch(tensor, name)`` first."""

    def leaf(p, name, transpose=False):
        t = p.grad if grads else p
        if t is None:
            raise ValueError("a parameter has no gradient")
        t = fetch(t.detach().float(), name).cpu()
        return (t.T if transpose else t).contiguous().numpy()

    out = {"embed": leaf(model.embed, "embed"),
           "final_norm": leaf(model.final_norm, "final_norm"), "layers": []}
    for layer in model.layers:
        p = {name: leaf(getattr(layer, name).weight, name, True) for name in _TRANSPOSED}
        p.update({name: leaf(getattr(layer, name), name) for name in _AS_IS})
        if model.cfg.attn_sinks:
            p["attn_sinks"] = leaf(layer.attn_sinks, "attn_sinks")
        out["layers"].append(p)
    return out


def params_to_jax(model: Transformer, *, grads: bool = False):
    """The JAX-layout pytree (float32 numpy) of ``model``'s weights, or of
    their ``.grad`` with ``grads=True``; the seven projections are
    transposed back to [in, out]."""
    return _pytree(model, grads, lambda t, name: t)


def param_specs(cfg: ModelConfig, tp_axis: Optional[str] = "tp"):
    """Per leaf of the JAX-layout pytree, the torch tensor's dims as a
    tuple: the tp axis name on the dim it is cut along, None elsewhere;
    () for a replicated leaf of one dim. ``nn.Linear`` keeps [out, in], so
    ``wq``, ``wk``, ``wv``, ``w_up`` and ``w_gate`` (JAX ``P(None, t)``)
    are cut on dim 0 and ``wo`` and ``w_down`` (``P(t, None)``) on dim 1."""
    t = tp_axis
    layer = {"attn_norm": (), "wq": (t, None), "wk": (t, None), "wv": (t, None),
             "wo": (None, t), "mlp_norm": (), "w_up": (t, None), "w_gate": (t, None),
             "w_down": (None, t)}
    if cfg.attn_sinks:
        layer["attn_sinks"] = ()
    return {"embed": (), "final_norm": (), "layers": [dict(layer) for _ in range(cfg.n_layers)]}


def _tp(mesh, tp_axis):
    from ..parallel.mesh import axis_group, axis_rank, axis_size

    return axis_group(mesh, tp_axis), axis_size(mesh, tp_axis), axis_rank(mesh, tp_axis)


def _cut_dim(cfg: ModelConfig):
    """``name -> dim``: the dim along which the "tp" axis cuts the
    ``state_dict`` entry ``name``, or None for a replicated one."""
    layer = param_specs(cfg, "tp")["layers"][0]

    def dim(name: str) -> Optional[int]:
        parts = name.split(".")
        spec = layer[parts[2]] if parts[0] == "layers" else ()
        return spec.index("tp") if "tp" in spec else None

    return dim


def _narrow(t: torch.Tensor, dim: Optional[int], tp: int, rank: int) -> torch.Tensor:
    if dim is None or tp == 1:
        return t
    size = t.shape[dim] // tp
    return t.narrow(dim, rank * size, size).clone()


@torch.no_grad()
def shard_params(model: Transformer, mesh, cfg: ModelConfig, tp_axis: str = "tp") -> Transformer:
    """Keep only this rank's tp slices of ``model``'s projections (in
    place; returns ``model``): Q heads ``[r*Hq/tp, (r+1)*Hq/tp)`` with their
    GQA group of KV heads, the matching rows of ``wo``, and the rank's
    block of the MLP's hidden units. Initialise the optimizer state after
    this. Refuses Hq or Hkv not divisible by tp, as
    ``parallel.head_parallel_attention`` does."""
    _, tp, rank = _tp(mesh, tp_axis)
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(f"Hq={cfg.n_heads}/Hkv={cfg.n_kv_heads} not divisible by "
                         f"{tp_axis}={tp}")
    if tp == 1:
        return model
    specs = param_specs(cfg, tp_axis)["layers"][0]
    for layer in model.layers:
        for name in _TRANSPOSED:
            lin = getattr(layer, name)
            lin.weight = nn.Parameter(_narrow(lin.weight, specs[name].index(tp_axis), tp, rank))
            lin.out_features, lin.in_features = lin.weight.shape
    return model


def gather_params_to_jax(model: Transformer, mesh, tp_axis: str = "tp", *,
                         grads: bool = False):
    """``params_to_jax`` of the whole model from a ``shard_params`` model:
    the tp-cut leaves all-gathered over the tp axis (a collective: every
    rank of the axis calls it; each gets the whole pytree)."""
    from ..parallel._collectives import _all_gather

    group, _, _ = _tp(mesh, tp_axis)
    specs = param_specs(model.cfg, tp_axis)["layers"][0]

    def fetch(t, name):
        spec = specs.get(name, ())
        if group is None or tp_axis not in spec:
            return t
        return _all_gather(t, spec.index(tp_axis), group)

    return _pytree(model, grads, fetch)


def _check_moments(model: Transformer, opt_state: dict) -> None:
    n = len(list(model.parameters()))
    if not n == len(opt_state["mu"]) == len(opt_state["nu"]):
        raise ValueError(f"{n} parameters, {len(opt_state['mu'])} mu and "
                         f"{len(opt_state['nu'])} nu in the optimizer state")


def _whole_leaves(model: Transformer, opt_state: dict, mesh):
    """Per parameter, in ``model.parameters()`` order: its ``state_dict``
    name and the whole parameter, ``mu`` and ``nu``, each tp-cut one
    all-gathered along its cut (a collective over the "tp" axis)."""
    from ..parallel._collectives import _all_gather

    group, _, _ = _tp(mesh, "tp")
    dim = _cut_dim(model.cfg)
    _check_moments(model, opt_state)
    for (name, p), mu, nu in zip(model.named_parameters(), opt_state["mu"], opt_state["nu"]):
        d = dim(name)
        leaves = (p.detach(), mu, nu)
        if group is not None and d is not None:
            leaves = tuple(_all_gather(t, d, group) for t in leaves)
        yield (name, *leaves)


@torch.no_grad()
def gather_train_state(model: Transformer, opt_state: dict, mesh):
    """The whole train state of a ``shard_params`` model, in torch layout:
    ``(state_dict, opt_state)``, the ``state_dict`` at the model's dtype and
    ``opt_state``'s fp32 ``mu`` / ``nu`` in ``model.parameters()`` order,
    each leaf cut on the mesh's "tp" axis, as ``make_train_step`` cuts it,
    and its moments all-gathered along the leaf's cut (a collective: every
    rank of the tp axis calls it; each gets the whole state). ``opt_state`` is the model's AdamW state. A leaf that is not
    cut is returned as the model's or optimizer's own tensor, not a copy."""
    state, mu, nu = {}, [], []
    for name, p, m, v in _whole_leaves(model, opt_state, mesh):
        state[name] = p
        mu.append(m)
        nu.append(v)
    return state, dict(opt_state, mu=mu, nu=nu)


@torch.no_grad()
def shard_train_state(state_dict: dict, opt_state: dict, mesh, cfg: ModelConfig):
    """The inverse of ``gather_train_state``: this rank's tp slices of a
    whole ``state_dict`` and of ``opt_state``'s whole moments (which follow
    the ``state_dict``'s order, that of ``model.parameters()``), narrowed
    as ``shard_params`` narrows. No collective."""
    _, tp, rank = _tp(mesh, "tp")
    dim = _cut_dim(cfg)
    dims = [dim(name) for name in state_dict]
    state = {name: _narrow(t, d, tp, rank) for (name, t), d in zip(state_dict.items(), dims)}
    moments = {key: [_narrow(t, d, tp, rank) for t, d in zip(opt_state[key], dims)]
               for key in ("mu", "nu")}
    return state, dict(opt_state, **moments)


def random_params(cfg: ModelConfig, seed: int = 0):
    """JAX-layout float32 parameter pytree drawn from ``numpy`` with
    ``seed``: normal weights scaled by 1/sqrt(fan_in) (embedding 0.02),
    norms at one, sinks at zero."""
    rng = np.random.default_rng(seed)

    def dense(shape, scale=None):
        scale = scale if scale is not None else 1.0 / (shape[0] ** 0.5)
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    dm, dh = cfg.d_model, cfg.head_dim
    hidden = cfg.mlp_ratio * dm
    params = {
        "embed": dense((cfg.vocab_size, dm), scale=0.02),
        "final_norm": np.ones((dm,), np.float32),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        layer = {
            "attn_norm": np.ones((dm,), np.float32),
            "wq": dense((dm, cfg.n_heads * dh)),
            "wk": dense((dm, cfg.n_kv_heads * dh)),
            "wv": dense((dm, cfg.n_kv_heads * dh)),
            "wo": dense((cfg.n_heads * dh, dm)),
            "mlp_norm": np.ones((dm,), np.float32),
            "w_up": dense((dm, hidden)),
            "w_gate": dense((dm, hidden)),
            "w_down": dense((hidden, dm)),
        }
        if cfg.attn_sinks:
            layer["attn_sinks"] = np.zeros((cfg.n_heads,), np.float32)
        params["layers"].append(layer)
    return params


__all__ = ["params_from_jax", "params_to_jax", "random_params", "param_specs", "shard_params",
           "gather_params_to_jax", "gather_train_state", "shard_train_state"]
