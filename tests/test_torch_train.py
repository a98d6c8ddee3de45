"""The port's training path against the JAX package's, at a tiny size.

The model is ``tests/test_torch_generate.py``'s (vocab 64, dm 64, L1, H2/1,
Dh320) with weights from the JAX package's ``init_params``, on 129 tokens
(N128 after the shift), so the attention takes the kernel route: JAX runs
its Pallas kernels in interpret mode, the port their plain versions. The
loss and every gradient come back through ``params_to_jax`` and are
compared leaf by leaf with ``jax.value_and_grad(loss_fn)``.

Tolerances: gradients 5e-2 relative to each leaf's max|g| (the bf16
gradient contract, tests/test_ffpa_bwd.py:19); the loss 2e-2 relative (the
bf16 forward tolerance, tests/test_features.py:127, as the logits). One
AdamW step against ``optax.adamw(1e-4)`` on the same fp32 parameters and
gradients: 1e-4 relative to max|update| (optax forms the bias corrections
1 - b**t in fp32, the port in double: 6e-6 relative at t = 1).
"""

import numpy as np
import pytest
import torch

from _torch_parity import cuda, jax_modules, rel_err  # noqa: F401
from ffpa_attn_tpu_torch.models import (
    ModelConfig,
    adamw,
    loss_fn,
    make_train_step,
    params_from_jax,
    params_to_jax,
    random_params,
)
from ffpa_attn_tpu_torch.ops import flash_bwd as tbwd

GRAD_TOL, LOSS_TOL, ADAMW_TOL = 5e-2, 2e-2, 1e-4
SIZE = dict(vocab_size=64, d_model=64, n_layers=1, n_heads=2, n_kv_heads=1,
            head_dim=320, max_seq_len=256)
N = 128


def _tokens(seed=1):
    return np.random.default_rng(seed).integers(0, SIZE["vocab_size"], (1, N + 1))


def _leaves(tree):
    import jax

    return jax.tree_util.tree_leaves_with_path(tree)


def _compare_with_jax(cfg_kw, seed=0):
    jax, jnp, jmodels = jax_modules("jax", "jax.numpy", "ffpa_attn_tpu.models")
    jcfg, tcfg = jmodels.ModelConfig(**cfg_kw), ModelConfig(**cfg_kw)
    params = jmodels.init_params(jax.random.PRNGKey(seed), jcfg)
    tokens = _tokens()
    jloss, jgrads = jax.value_and_grad(jmodels.loss_fn)(params, jnp.asarray(tokens, jnp.int32),
                                                        jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    loss = loss_fn(model, torch.from_numpy(tokens))
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - float(jloss)) < LOSS_TOL * abs(float(jloss))
    tgrads = params_to_jax(model, grads=True)
    assert jax.tree.structure(tgrads) == jax.tree.structure(jgrads)
    for (path, jg), tg in zip(_leaves(jgrads), jax.tree.leaves(tgrads)):
        assert tg.shape == jg.shape, path
        assert rel_err(tg, jg) < GRAD_TOL, (jax.tree_util.keystr(path), rel_err(tg, jg))


def test_loss_and_grads_match_jax():
    """The dS-handoff tier (causal, no window): dkdv with dS, banded dQ."""
    _compare_with_jax(SIZE)


def test_save_scores_model_grads_match_jax():
    """``attn_save_scores=True``: the S-resident tier (the forward keeps S,
    the from-S pass, dK and dQ from the slab) on both sides."""
    _compare_with_jax(dict(SIZE, attn_save_scores=True))


def test_mistral_like_grads_match_jax():
    """A sliding window takes the recompute tier (dkdv, then dq)."""
    _compare_with_jax(dict(SIZE, sliding_window=48))


def test_params_to_jax_inverts_params_from_jax():
    cfg = ModelConfig(**dict(SIZE, attn_sinks=True))
    params = random_params(cfg, seed=4)
    back = params_to_jax(params_from_jax(params, cfg, device="cpu"))

    def bf16(x):  # the model stores bf16; the sinks stay fp32
        return torch.from_numpy(x).to(torch.bfloat16).float().numpy()

    for name in ("embed", "final_norm"):
        np.testing.assert_array_equal(back[name], bf16(params[name]), err_msg=name)
    for got, want in zip(back["layers"], params["layers"]):
        assert set(got) == set(want)
        for name, w in want.items():
            np.testing.assert_array_equal(got[name], w if name == "attn_sinks" else bf16(w),
                                          err_msg=name)


def test_adamw_step_matches_optax():
    jax, jnp, optax = jax_modules("jax", "jax.numpy", "optax")
    rng = np.random.default_rng(5)
    params = [rng.standard_normal((8, 16)).astype(np.float32),
              rng.standard_normal((16,)).astype(np.float32)]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) for p in params]
             for _ in range(2)]
    opt = optax.adamw(1e-4)
    jstate = opt.init([jnp.asarray(p) for p in params])
    topt = adamw(1e-4)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    tstate = topt.init(tparams)
    jparams = [jnp.asarray(p) for p in params]
    for g in grads:
        jup, jstate = opt.update([jnp.asarray(x) for x in g], jstate, jparams)
        tup, tstate = topt.update([torch.from_numpy(x) for x in g], tstate, tparams)
        for ju, tu in zip(jup, tup):
            assert rel_err(tu, ju) < ADAMW_TOL
        jparams = [p + u for p, u in zip(jparams, jup)]
        tparams = [p + u for p, u in zip(tparams, tup)]
    assert tstate["count"] == 2


def test_train_step_on_cpu_lowers_the_loss():
    cfg = ModelConfig(**SIZE)
    model = params_from_jax(random_params(cfg, seed=6), cfg, device="cpu")
    opt = adamw(1e-3)
    state = opt.init(list(model.parameters()))
    step = make_train_step(cfg, opt, device="cpu")
    tokens = torch.from_numpy(_tokens(7))
    before = tbwd._dkdv_launch.launches
    losses = []
    for _ in range(3):
        state, loss = step(model, state, tokens)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert tbwd._dkdv_launch.launches == before  # CPU: plain versions
    assert model.embed.dtype == torch.bfloat16


def test_make_train_step_defaults_to_cuda():
    cfg = ModelConfig(**SIZE)
    if torch.cuda.is_available():
        step = make_train_step(cfg, adamw(1e-4))
        model = params_from_jax(random_params(cfg, 0), cfg, device="cpu")
        with pytest.raises(ValueError, match="the step on cuda"):
            step(model, adamw(1e-4).init(list(model.parameters())), _tokens())
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(cfg, adamw(1e-4))


@pytest.mark.parametrize("save_scores", [False, True])
def test_train_steps_on_card_match_cpu(cuda, save_scores):
    """Two steps on the card and on the CPU from the same weights: the
    losses agree within the bf16 forward tolerance, and every step launches
    the forward, dkdv and banded-dQ kernels once per layer (with
    ``attn_save_scores`` the from-S pass instead of dkdv)."""
    from ffpa_attn_tpu_torch.ops import flash_fwd as tfwd

    cfg = ModelConfig(**SIZE, attn_save_scores=save_scores)
    params = random_params(cfg, seed=8)
    tokens = torch.from_numpy(_tokens(9))
    losses = {}
    for dev in ("cpu", "cuda"):
        model = params_from_jax(params, cfg, device=dev)
        opt = adamw(1e-3)
        state = opt.init(list(model.parameters()))
        step = make_train_step(cfg, opt, device=dev)
        counts = (tfwd.flash_attention_forward.launches, tbwd._dkdv_launch.launches,
                  tbwd._banded_dq_from_ds.launches, tbwd._dq_launch.launches,
                  tbwd._dkdv_from_s_launch.launches)
        losses[dev] = []
        for _ in range(2):
            state, loss = step(model, state, tokens)
            losses[dev].append(float(loss))
        launched = (tfwd.flash_attention_forward.launches - counts[0],
                    tbwd._dkdv_launch.launches - counts[1],
                    tbwd._banded_dq_from_ds.launches - counts[2],
                    tbwd._dq_launch.launches - counts[3],
                    tbwd._dkdv_from_s_launch.launches - counts[4])
        want = ((0, 0, 0, 0, 0) if dev == "cpu" else
                (2, 0, 2, 0, 2) if save_scores else (2, 2, 2, 0, 0))
        assert launched == want, (dev, launched)
    for a, b in zip(losses["cuda"], losses["cpu"]):
        assert abs(a - b) < LOSS_TOL * abs(b), losses
