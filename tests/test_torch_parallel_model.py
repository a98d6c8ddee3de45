"""The port's sharded train step against the JAX package, on the CPU.

A tiny model (vocab 64, dm64, L1, Dh320) takes one ``make_train_step``
step (AdamW 1e-4) over a mesh of spawned ranks (``_torch_parallel_ranks``
``train_rank``; gloo, a ``file://`` rendezvous, bounded joins): dp2 on a
batch of 2, tp2 x sp2 through the zigzag ring (N256) and through the
contiguous causal ring (N254, not a multiple of 2 sp), and the window model
(window 96, softcap 30, sinks) under sp2 through the halo. The loss and
every gradient leaf, gathered to the JAX layout (``gather_params_to_jax``),
are held against ``jax.value_and_grad`` of the JAX package's unsharded
``loss_fn`` on the same weights and tokens, at ``tests/test_torch_train.py``'s
tolerances (loss 2e-2 relative, gradients 5e-2 of each leaf's max|g|); the
updated weights are those of the port's AdamW applied to the gathered
gradients, bit for bit (AdamW is elementwise, so sharding moves none of
its arithmetic). The dry run at world 4 (dp1 tp2 sp2, the JAX
``dryrun_multichip`` config and its window variant) is held the same way
on its loss.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parallel_ranks as ranks
from _torch_parity import jax_modules, rel_err
from ffpa_attn_tpu_torch.models import (
    ModelConfig,
    adamw,
    params_from_jax,
    random_params,
)
from ffpa_attn_tpu_torch.parallel.dryrun import factorise, spawn_ranks, tiny_config

GRAD_TOL, LOSS_TOL = 5e-2, 2e-2  # tests/test_torch_train.py
TINY = dict(vocab_size=64, d_model=64, n_layers=1, n_heads=4, n_kv_heads=2, head_dim=320,
            max_seq_len=512)
CASES = {
    "dp2": (dict(TINY, n_heads=2, n_kv_heads=1), {"dp": 2}, None, (2, 128)),
    "tp2_sp2_zigzag": (TINY, {"tp": 2, "sp": 2}, "sp", (1, 256)),
    "tp2_sp2_ring": (TINY, {"tp": 2, "sp": 2}, "sp", (1, 254)),
    "sp2_window": (dict(TINY, sliding_window=96, attn_softcap=30.0, attn_sinks=True),
                   {"sp": 2}, "sp", (1, 256)),
}


def _jax_params(params_np, cfg_kw):
    """The numpy pytree as JAX arrays in the model's dtype (sinks fp32)."""
    jax, jnp = jax_modules("jax", "jax.numpy")
    dt = jnp.dtype(cfg_kw.get("dtype", "bfloat16"))

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        return jnp.asarray(x, jnp.float32 if "attn_sinks" in name else dt)

    return jax.tree_util.tree_map_with_path(leaf, params_np)


def _jax_loss_and_grads(params_np, tokens, cfg_kw):
    jax, jnp, jmodels = jax_modules("jax", "jax.numpy", "ffpa_attn_tpu.models")
    cfg = jmodels.ModelConfig(**{k: v for k, v in cfg_kw.items() if k != "attn_save_scores"})
    loss, grads = jax.value_and_grad(jmodels.loss_fn)(
        _jax_params(params_np, cfg_kw), jnp.asarray(tokens, jnp.int32), cfg)
    return float(loss), grads


def _run(tmp_path, cfg_kw, axes, sp_axis, tokens, seed=0):
    params = random_params(ModelConfig(**cfg_kw), seed=seed)
    for name, obj in (("params", params), ("tokens", tokens)):
        with open(tmp_path / f"{name}.pkl", "wb") as f:
            pickle.dump(obj, f)
    world = int(np.prod(list(axes.values())))
    spawn_ranks(ranks.train_rank, world,
                (str(tmp_path / "params.pkl"), str(tmp_path / "tokens.pkl"), cfg_kw, axes,
                 sp_axis, str(tmp_path / "out.pkl")),
                backend="gloo", rdzv_dir=str(tmp_path), timeout_s=240)
    with open(tmp_path / "out.pkl", "rb") as f:
        return params, pickle.load(f)


def _adamw_from(params_np, grads_np, cfg_kw):
    """The port's single-process AdamW (1e-4) step on the gathered
    gradients, from the same bf16 weights: the JAX-layout pytree after."""
    from ffpa_attn_tpu_torch.models import params_to_jax

    cfg = ModelConfig(**cfg_kw)
    model = params_from_jax(params_np, cfg, device="cpu")
    tgrads = params_from_jax(grads_np, cfg, device="cpu")
    for p, g in zip(model.parameters(), tgrads.parameters()):
        p.grad = g.detach()
    opt = adamw(1e-4)
    params = list(model.parameters())
    updates, _ = opt.update([p.grad for p in params], opt.init(params), params)
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.copy_((p.float() + u).to(p.dtype))
    return params_to_jax(model)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_jax(tmp_path, case):
    jax, = jax_modules("jax")
    cfg_kw, axes, sp_axis, (b, n) = CASES[case]
    tokens = np.random.default_rng(1).integers(0, cfg_kw["vocab_size"], (b, n + 1))
    params, got = _run(tmp_path, cfg_kw, axes, sp_axis, tokens)
    jloss, jgrads = _jax_loss_and_grads(params, tokens, cfg_kw)
    assert abs(got["loss"] - jloss) < LOSS_TOL * abs(jloss), (got["loss"], jloss)
    assert jax.tree.structure(got["grads"]) == jax.tree.structure(jgrads)
    leaves = jax.tree_util.tree_leaves_with_path(jgrads)
    for (path, jg), tg in zip(leaves, jax.tree.leaves(got["grads"])):
        assert tg.shape == jg.shape, path
        assert rel_err(tg, jg) < GRAD_TOL, (case, jax.tree_util.keystr(path), rel_err(tg, jg))
    want = _adamw_from(params, got["grads"], cfg_kw)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got["params"])):
        np.testing.assert_array_equal(g, w)


def test_softcap_without_window_is_refused_under_sp(tmp_path):
    """The JAX model's refusal: softcap or sinks need the halo path."""
    cfg_kw = dict(TINY, attn_softcap=30.0)
    tokens = np.zeros((1, 257), np.int64)
    with pytest.raises(RuntimeError, match="a rank failed"):
        _run(tmp_path, cfg_kw, {"sp": 2}, "sp", tokens)


def test_dryrun_world4_matches_jax(tmp_path):
    """``python -m ffpa_attn_tpu_torch.parallel.dryrun --world 4 --device
    cpu``: dp1 tp2 sp2, the JAX dry run's tiny config and its window
    variant, one step each; each loss against the JAX package's on the
    same weights and zero tokens."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "rows.json"
    proc = subprocess.run([sys.executable, "-m", "ffpa_attn_tpu_torch.parallel.dryrun",
                           "--world", "4", "--device", "cpu", "--out", str(out)],
                          capture_output=True, text=True, timeout=300, cwd=root)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = json.loads(out.read_text())
    dp, tp, sp = factorise(4)
    assert [r["window"] for r in rows] == [False, True]
    for row in rows:
        assert row["mesh"] == {"dp": dp, "tp": tp, "sp": sp}
        cfg = tiny_config(tp, sp, row["window"])
        cfg_kw = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
        jloss, _ = _jax_loss_and_grads(random_params(cfg, seed=0),
                                       np.zeros((dp, 128 * sp + 1), np.int64), cfg_kw)
        assert np.isfinite(row["loss"])
        assert abs(row["loss"] - jloss) < LOSS_TOL * abs(jloss), (row, jloss)


@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_factorise_matches_jax_dryrun(world):
    """dp = N/4, tp 2, sp 2 where 4 | N; dp = N/2, sp 2 where 2 | N (the
    JAX dry run's 8 | N branch is its 4 | N one)."""
    want = ((world // 4, 2, 2) if world % 4 == 0 else (world // 2, 1, 2) if world % 2 == 0
            else (world, 1, 1))
    assert factorise(world) == want


def test_single_card_branch_is_the_plain_step():
    """No mesh: loss_fn and make_train_step take the single-card code
    (the same loss as before the mesh route, bit for bit)."""
    from ffpa_attn_tpu_torch.models import loss_fn, make_train_step

    cfg = ModelConfig(**dict(TINY, n_heads=2, n_kv_heads=1))
    model = params_from_jax(random_params(cfg, seed=3), cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 64, (1, 129)))
    a = loss_fn(model, tokens)
    b = loss_fn(model, tokens, mesh=None, sp_axis="sp")
    assert torch.equal(a, b)
    opt = adamw(1e-4)
    _, loss = make_train_step(cfg, opt, device="cpu", mesh=None, sp_axis="sp")(
        model, opt.init(list(model.parameters())), tokens)
    assert torch.equal(loss, a.detach())
