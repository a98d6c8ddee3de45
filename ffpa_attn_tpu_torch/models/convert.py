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
"""

from __future__ import annotations

import numpy as np
import torch

from ..env import resolve_device
from .transformer import ModelConfig, Transformer

_TRANSPOSED = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down")
_AS_IS = ("attn_norm", "mlp_norm")


def _tensor(x, dtype, device) -> torch.Tensor:
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


def params_to_jax(model: Transformer, *, grads: bool = False):
    """The JAX-layout pytree (float32 numpy) of ``model``'s weights, or of
    their ``.grad`` with ``grads=True``; the seven projections are
    transposed back to [in, out]."""

    def leaf(p, transpose=False):
        t = p.grad if grads else p
        if t is None:
            raise ValueError("a parameter has no gradient")
        t = t.detach().float().cpu()
        return (t.T if transpose else t).contiguous().numpy()

    out = {"embed": leaf(model.embed), "final_norm": leaf(model.final_norm), "layers": []}
    for layer in model.layers:
        p = {name: leaf(getattr(layer, name).weight, True) for name in _TRANSPOSED}
        p.update({name: leaf(getattr(layer, name)) for name in _AS_IS})
        if model.cfg.attn_sinks:
            p["attn_sinks"] = leaf(layer.attn_sinks)
        out["layers"].append(p)
    return out


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


__all__ = ["params_from_jax", "params_to_jax", "random_params"]
