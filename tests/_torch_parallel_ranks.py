"""Rank code of ``test_torch_parallel*.py``: the bodies that
``ffpa_attn_tpu_torch.parallel.dryrun.spawn_ranks`` runs in each spawned
process. It imports only torch, numpy and the port (never JAX), reads its
inputs from files the test wrote, and writes numpy results for the test to
compare with the JAX package.
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
    make_train_step,
    params_from_jax,
    shard_params,
)
from ffpa_attn_tpu_torch.parallel import (
    head_parallel_attention,
    make_mesh,
    paged_head_parallel_decode,
    ring_attention_sharded,
    ulysses_attention_sharded,
    window_attention_sharded,
    zigzag_ring_attention_sharded,
)

BF16 = torch.bfloat16


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _dump(path, obj):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def _t(x, dtype=BF16, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dtype)
    return t.requires_grad_(grad)


def _np(t):
    return t.detach().float().numpy()


def _fwd_bwd(fn, q, k, v, do, extra=()):
    """Output and the gradients of sum(out * do) w.r.t. q, k, v and
    ``extra`` (numpy)."""
    leaves = [_t(x, grad=True) for x in (q, k, v)]
    extra = [_t(x, torch.float32, grad=True) for x in extra]
    out = fn(*leaves, *extra)
    (out.float() * _t(do).float()).sum().backward()
    return [_np(out)] + [_np(x.grad) for x in leaves + extra]


def ops_rank(inputs_path: str, out_path: str) -> None:
    """Every sharded op over the world's ranks, on the inputs of
    ``inputs_path``; rank 0 writes {case: [numpy results]}."""
    x = _load(inputs_path)
    world = dist.get_world_size()
    sp = make_mesh((world,), ("sp",), device="cpu")
    tp = make_mesh((world,), ("tp",), device="cpu")
    q, k, v, do = x["q"], x["k"], x["v"], x["do"]
    kf, vf = x["k_mha"], x["v_mha"]
    res = {}
    for causal in (False, True):
        res[f"ring_causal{int(causal)}"] = _fwd_bwd(
            lambda a, b, c: ring_attention_sharded(a, b, c, sp, causal=causal), q, k, v, do)
    res["zigzag"] = _fwd_bwd(lambda a, b, c: zigzag_ring_attention_sharded(a, b, c, sp),
                             q, k, v, do)
    for w in x["windows"]:
        res[f"window{w}"] = _fwd_bwd(
            lambda a, b, c, s: window_attention_sharded(a, b, c, sp, window_left=w,
                                                        softcap=25.0, sinks=s),
            q, k, v, do, extra=[x["sinks"]])
    res["ulysses"] = _fwd_bwd(
        lambda a, b, c, s: ulysses_attention_sharded(
            a, b, c, sp, causal=True, softcap=25.0, window=(x["ulysses_window"], -1),
            alibi_slopes=torch.from_numpy(x["slopes"]), sinks=s),
        q, kf, vf, do, extra=[x["sinks"]])
    res["head_parallel"] = _fwd_bwd(
        lambda a, b, c: head_parallel_attention(a, b, c, tp, is_causal=True), q, kf, vf, do)
    if world == 4:
        mesh2 = make_mesh((2, 2), ("tp", "sp"), device="cpu")
        res["ring_2d"] = _fwd_bwd(
            lambda a, b, c: ring_attention_sharded(a, b, c, mesh2, head_axis="tp", causal=True),
            q, kf, vf, do)
    from ffpa_attn_tpu_torch.ops.paged import PagedKVCache

    p = x["paged"]
    cache = PagedKVCache(_t(p["k_pages"]), _t(p["v_pages"]),
                         torch.from_numpy(p["page_table"]), torch.from_numpy(p["lens"]))
    with torch.inference_mode():
        res["paged"] = [_np(paged_head_parallel_decode(_t(p["q"]), cache, tp))]
    if dist.get_rank() == 0:
        _dump(out_path, res)


def train_rank(params_path: str, tokens_path: str, cfg_kw: dict, axes: dict, sp_axis,
               out_path: str) -> None:
    """One sharded train step (AdamW 1e-4) of ``cfg_kw``'s model from the
    JAX-layout params at ``params_path`` on the global tokens at
    ``tokens_path``, over a mesh of ``axes`` ({name: size}); rank 0 writes
    the loss, the gathered gradients and the gathered updated params."""
    cfg = ModelConfig(**cfg_kw)
    mesh = make_mesh(tuple(axes.values()), tuple(axes), device="cpu")
    model = shard_params(params_from_jax(_load(params_path), cfg, device="cpu"), mesh, cfg)
    opt = adamw(1e-4)
    step = make_train_step(cfg, opt, device="cpu", mesh=mesh, sp_axis=sp_axis)
    _, loss = step(model, opt.init(list(model.parameters())), torch.from_numpy(_load(tokens_path)))
    grads = gather_params_to_jax(model, mesh, grads=True)
    params = gather_params_to_jax(model, mesh)
    if dist.get_rank() == 0:
        _dump(out_path, {"loss": float(loss), "grads": grads, "params": params})


def pid_rank(out_dir: str) -> None:
    """Each rank writes its rank and pid (the launcher's own test)."""
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}"), "w") as f:
        f.write(f"{dist.get_rank()} {dist.get_world_size()} {os.getpid()}")
