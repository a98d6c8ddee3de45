"""The port's train-state checkpoints, held as the JAX package's orbax ones
are (tests/test_models.py:382-427): a restored (model, optimizer state)
continues the trajectory bit for bit, and a checkpoint of another config
fails loudly.

The model is ``tests/test_torch_train.py``'s (vocab 64, dm 64, L1, H2/1,
Dh320) with weights from ``random_params`` (numpy seed 0), trained on 129
tokens (N128 after the shift, the forward- and backward-kernel routes, their
plain versions on the CPU) by ``make_train_step`` with AdamW 1e-3.
"""

import os

import numpy as np
import pytest
import torch

from ffpa_attn_tpu_torch.models import (
    ModelConfig,
    adamw,
    latest_step,
    make_train_step,
    params_from_jax,
    random_params,
    restore_train_state,
    save_train_state,
)

SIZE = dict(vocab_size=64, d_model=64, n_layers=1, n_heads=2, n_kv_heads=1,
            head_dim=320, max_seq_len=256)


def _fresh(cfg, seed=0):
    model = params_from_jax(random_params(cfg, seed), cfg, device="cpu")
    opt = adamw(1e-3)
    return model, opt, opt.init(list(model.parameters()))


def _tokens():
    return torch.from_numpy(np.random.default_rng(1).integers(0, SIZE["vocab_size"], (1, 129)))


def test_resume_is_bit_faithful(tmp_path):
    cfg = ModelConfig(**SIZE)
    model, opt, state = _fresh(cfg)
    step = make_train_step(cfg, opt, device="cpu")
    tokens = _tokens()
    for _ in range(2):
        state, _ = step(model, state, tokens)
    d = str(tmp_path / "ckpt")
    save_train_state(d, 2, model, state)
    assert latest_step(d) == 2

    fresh, _, template = _fresh(cfg, seed=9)  # other weights, zero moments
    rmodel, rstate, rstep = restore_train_state(d, fresh, template)
    assert rstep == 2 and rmodel is fresh and rstate["count"] == state["count"] == 2
    state, la = step(model, state, tokens)
    rstate, lb = step(rmodel, rstate, tokens)
    assert torch.equal(la, lb)
    for (name, p), rp in zip(model.named_parameters(), rmodel.parameters()):
        assert torch.equal(p, rp), name
    for key in ("mu", "nu"):
        for a, b in zip(state[key], rstate[key]):
            assert torch.equal(a, b)


def _saved(tmp_path, cfg, steps=(1,), **kw):
    model, _, state = _fresh(cfg)
    d = str(tmp_path / "ckpt")
    for s in steps:
        save_train_state(d, s, model, state, **kw)
    return d


@pytest.mark.parametrize("change", [
    dict(d_model=96),
    dict(n_kv_heads=2),
    dict(dtype="float16"),
    dict(sliding_window=32),
])
def test_another_config_raises(tmp_path, change):
    d = _saved(tmp_path, ModelConfig(**SIZE))
    model, _, state = _fresh(ModelConfig(**dict(SIZE, **change)))
    with pytest.raises(ValueError, match="config"):
        restore_train_state(d, model, state)


def test_another_optimizer_template_raises(tmp_path):
    """Names, shapes and dtypes are held against the templates, not only the
    config: a moment of another dtype fails loudly."""
    cfg = ModelConfig(**SIZE)
    d = _saved(tmp_path, cfg)
    model, _, state = _fresh(cfg)
    state["mu"][0] = state["mu"][0].to(torch.bfloat16)
    with pytest.raises(ValueError, match="mu.0"):
        restore_train_state(d, model, state)
    state["mu"] = state["mu"][:-1]
    with pytest.raises(ValueError, match="names"):
        restore_train_state(d, model, state)


def test_max_to_keep_prunes(tmp_path):
    d = _saved(tmp_path, ModelConfig(**SIZE), steps=(1, 5, 2, 10, 7), max_to_keep=2)
    assert sorted(os.listdir(d)) == ["ckpt_10.pt", "ckpt_7.pt"]
    assert latest_step(d) == 10


def test_restore_a_given_step(tmp_path):
    cfg = ModelConfig(**SIZE)
    d = _saved(tmp_path, cfg, steps=(3, 4))
    model, _, state = _fresh(cfg)
    assert restore_train_state(d, model, state, step=3)[2] == 3
    with pytest.raises(FileNotFoundError):
        restore_train_state(d, model, state, step=5)


def test_latest_step_is_none_without_checkpoints(tmp_path):
    assert latest_step(str(tmp_path)) is None
    assert latest_step(str(tmp_path / "missing")) is None


def test_nothing_to_restore_raises(tmp_path):
    model, _, state = _fresh(ModelConfig(**SIZE))
    with pytest.raises(FileNotFoundError):
        restore_train_state(str(tmp_path), model, state)


def test_a_leftover_temp_file_is_ignored(tmp_path):
    """A save cut off before its rename leaves a temporary file: it is
    neither a step nor pruned as one, and the whole step before it
    restores."""
    cfg = ModelConfig(**SIZE)
    d = _saved(tmp_path, cfg, steps=(4,))
    with open(os.path.join(d, ".ckpt_x1y2.tmp"), "wb") as f:
        f.write(b"partial")
    assert latest_step(d) == 4
    model, _, state = _fresh(cfg, seed=9)
    assert restore_train_state(d, model, state)[2] == 4
    saved = _fresh(cfg)[0]
    for p, want in zip(model.parameters(), saved.parameters()):
        assert torch.equal(p, want)

