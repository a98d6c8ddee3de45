"""The port's checkpoint over a mesh, held as the JAX package's orbax save of
a sharded state is (``ffpa_attn_tpu/models/checkpoint.py``): a state cut
over dp x tp x sp is saved whole and restores into any layout bit for bit.

The model is ``tests/test_torch_parallel_model.py``'s TINY (vocab 64, dm64,
L1, H4/2, Dh320, bf16) with weights from ``random_params`` (numpy seed 0)
and tokens from numpy seed 1 (1 x 257: N256, two zigzag chunk pairs over
sp2), trained by ``make_train_step`` with AdamW 1e-3. One world of 4 gloo
ranks (``_torch_checkpoint_ranks.checkpoint_rank``, a ``file://``
rendezvous, a bounded join) runs every leg; each test reads what the ranks
wrote. States are held bit-equal; the loss of a restored model against the
JAX package's within 2e-2 relative (``tests/test_torch_train.py``).
"""

import os
import pickle

import numpy as np
import pytest
import torch

import _torch_checkpoint_ranks as ranks
from _torch_parity import cuda, jax_modules  # noqa: F401
from ffpa_attn_tpu_torch.models import (
    ModelConfig,
    adamw,
    loss_fn,
    make_train_step,
    params_from_jax,
    params_to_jax,
    random_params,
    restore_train_state,
    save_train_state,
)
from ffpa_attn_tpu_torch.parallel.dryrun import spawn_ranks

LOSS_TOL = 2e-2  # tests/test_torch_train.py
WORLD = 4
TINY = dict(vocab_size=64, d_model=64, n_layers=1, n_heads=4, n_kv_heads=2, head_dim=320,
            max_seq_len=512)


def _tokens():
    return np.random.default_rng(1).integers(0, TINY["vocab_size"], (1, 257))


def _run_world(out_dir: str, device: str) -> tuple:
    """The test process's single-process save (step 1 of another model,
    whole), then the world of ranks; returns that save's state and each
    rank's results."""
    cfg = ModelConfig(**TINY)
    model = params_from_jax(random_params(cfg, seed=3), cfg, device="cpu")
    opt = adamw(1e-3)
    state, _ = make_train_step(cfg, opt, device="cpu")(
        model, opt.init(list(model.parameters())), torch.from_numpy(_tokens()))
    save_train_state(os.path.join(out_dir, ranks.SINGLE), 1, model, state)
    with open(os.path.join(out_dir, ranks.SINGLE_PARAMS), "wb") as f:
        pickle.dump(params_to_jax(model), f)
    single = ranks.host_state(model.state_dict(), state)
    spawn_ranks(ranks.checkpoint_rank, WORLD, (out_dir, TINY, device), backend="gloo",
                rdzv_dir=out_dir, timeout_s=240)
    res = []
    for r in range(WORLD):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return single, res


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("ckpt_world")
    single, res = _run_world(str(out_dir), "cpu")
    return str(out_dir), single, res


def _assert_states_equal(got: dict, want: dict):
    assert got["count"] == want["count"]
    assert list(got["model"]) == list(want["model"])
    for name in want["model"]:
        np.testing.assert_array_equal(got["model"][name], want["model"][name], err_msg=name)
    for key in ("mu", "nu"):
        assert len(got[key]) == len(want[key])
        for i, (g, w) in enumerate(zip(got[key], want[key])):
            np.testing.assert_array_equal(g, w, err_msg=f"{key}.{i}")


def _hold_same_mesh_resume(res):
    for r, rr in enumerate(res):
        assert rr["latest_after_save"] == 1, r
        assert rr["restored_step"] == 1, r
        loss, rloss = rr["losses"]
        assert loss == rloss and np.isfinite(loss), (r, rr["losses"])
        assert all(rr["shards_equal"]), (r, rr["shards_equal"])
        assert rr["step2"]["count"] == 2
        _assert_states_equal(rr["resumed_step2"], rr["step2"])
        _assert_states_equal(rr["step2"], res[0]["step2"])


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    """The JAX package's orbax save of a dp1 x tp2 x sp2 ``shard_params``
    state with ``optax.adam`` (one update, so the moments are not zero),
    restored into an unsharded template: ``(saved, restored, step, latest)``
    with ``saved`` and ``restored`` the (params, opt state) pairs."""
    jax, jnp, optax, jmodels, jtransformer, jmesh = jax_modules(
        "jax", "jax.numpy", "optax", "ffpa_attn_tpu.models", "ffpa_attn_tpu.models.transformer",
        "ffpa_attn_tpu.parallel.mesh")
    cfg = jmodels.ModelConfig(**TINY)

    def params(seed):
        return jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16),
                            random_params(ModelConfig(**TINY), seed))

    mesh = jmesh.make_mesh((1, 2, 2), ("dp", "tp", "sp"))
    sharded = jtransformer.shard_params(params(0), mesh, cfg)
    assert sharded["layers"][0]["wq"].sharding.spec == jax.sharding.PartitionSpec(None, "tp")
    opt = optax.adam(1e-3)
    _, st = opt.update(sharded, opt.init(sharded), sharded)
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    jmodels.save_train_state(d, 1, sharded, st)
    template = params(9)
    rp, rs, step = jmodels.restore_train_state(d, template, opt.init(template))
    return (sharded, st), (rp, rs), step, jmodels.latest_step(d)


def test_jax_sharded_save_restores_unsharded(jax_reference):
    """The reference: the JAX package's orbax save of a sharded state
    restores into an unsharded template bit for bit."""
    jax, jnp = jax_modules("jax", "jax.numpy")
    saved, restored, step, latest = jax_reference
    assert step == 1 and latest == 1
    want, got = jax.tree.leaves(saved), jax.tree.leaves(restored)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert len(g.sharding.device_set) == 1
        np.testing.assert_array_equal(np.asarray(g.astype(jnp.float32)),
                                      np.asarray(w.astype(jnp.float32)))


def test_the_port_sharded_save_restores_as_the_jax_one(world, jax_reference):
    """The same state saved by both: the port's dp1 x tp2 x sp2 ranks save
    ``shard_params`` of ``random_params`` seed 0 (before any step), the JAX
    package saves its ``shard_params`` of the same weights; each restored
    into one unsharded model, the port's ``params_to_jax`` equals the JAX
    restore's parameters bit for bit."""
    jax, jnp = jax_modules("jax", "jax.numpy")
    out_dir = world[0]
    cfg = ModelConfig(**TINY)
    model = params_from_jax(random_params(cfg, seed=9), cfg, device="cpu")
    model, state, step = restore_train_state(os.path.join(out_dir, ranks.INIT), model,
                                             adamw(1e-3).init(list(model.parameters())))
    assert step == 0 and state["count"] == 0
    got, want = params_to_jax(model), jax_reference[1][0]
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, np.asarray(w.astype(jnp.float32)))


def test_resume_on_the_same_mesh_is_bit_faithful(world):
    """dp1 x tp2 x sp2: a model of other weights restored from step 1 takes
    step 2 to the uninterrupted run's loss and, on every rank, its shards
    of the parameters and moments, bit for bit."""
    _hold_same_mesh_resume(world[2])


def test_a_sharded_save_restores_into_one_process(world):
    """The step-1 file of the tp2 x sp2 ranks restores into one unsharded
    model: its JAX-layout weights equal the ranks' ``gather_params_to_jax``
    and its moments their gathered ones, bit for bit; its loss is the JAX
    package's on the same weights."""
    jax, jnp, jmodels = jax_modules("jax", "jax.numpy", "ffpa_attn_tpu.models")
    out_dir, _, res = world
    cfg = ModelConfig(**TINY)
    model = params_from_jax(random_params(cfg, seed=9), cfg, device="cpu")
    template = adamw(1e-3).init(list(model.parameters()))
    model, state, step = restore_train_state(os.path.join(out_dir, ranks.SAME_MESH), model,
                                             template)
    assert step == 1
    _assert_states_equal(ranks.host_state(model.state_dict(), state), res[0]["step1"])
    got = params_to_jax(model)
    want = res[0]["step1_params"]
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w)
    tokens = _tokens()
    loss = float(loss_fn(model, torch.from_numpy(tokens)).detach())
    jparams = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), got)
    jloss = float(jmodels.loss_fn(jparams, jnp.asarray(tokens, jnp.int32),
                                  jmodels.ModelConfig(**TINY)))
    assert abs(loss - jloss) < LOSS_TOL * abs(jloss), (loss, jloss)


def test_a_single_process_save_restores_into_tp2(world):
    """A whole model saved by one process restores into tp2 ranks: each
    rank's slices are ``shard_params`` of the saved model, and the state
    gathered back is the saved one, bit for bit."""
    _, single, res = world
    for r, rr in enumerate(res):
        assert all(rr["into_tp2_slices_equal"]), (r, rr["into_tp2_slices_equal"])
        _assert_states_equal(rr["into_tp2"], single)


def test_one_writer_one_pruner_under_dp_and_sp(world):
    """dp2 x sp2, every rank holding the whole model, saves steps 1 to 4
    with ``max_to_keep=2``: no rank raises, each sees its step at once, and
    the directory holds the two newest steps and no temporary file."""
    out_dir, _, res = world
    for r, rr in enumerate(res):
        assert rr["race_latest"] == [1, 2, 3, 4], (r, rr["race_latest"])
        assert rr["race_listing"] == ["ckpt_3.pt", "ckpt_4.pt"], (r, rr["race_listing"])
    assert sorted(os.listdir(os.path.join(out_dir, ranks.RACE))) == ["ckpt_3.pt", "ckpt_4.pt"]


def test_another_config_raises_on_every_rank(world):
    """A restore into shards of another config raises ValueError on every
    rank (each checks alone, so none waits on another)."""
    for r, rr in enumerate(world[2]):
        assert rr["config_error"] is not None and "config" in rr["config_error"], r


def test_a_shard_saved_without_its_mesh_raises_on_every_rank(world):
    """A tp shard saved without the mesh it was cut on would write a slice
    as the whole model: every rank raises ValueError and nothing is
    written."""
    for r, rr in enumerate(world[2]):
        assert rr["unsaved_error"] is not None and "shard_params" in rr["unsaved_error"], r
        assert not rr["unsaved_written"], r


def test_a_checkpoint_one_rank_cannot_see_raises_on_every_rank(world):
    """A restore where only rank 0 sees the file (a directory that is not
    on shared storage) raises FileNotFoundError on every rank, rank 0
    included, and none hangs."""
    for r, rr in enumerate(world[2]):
        assert rr["unshared_error"] is not None and "every rank" in rr["unshared_error"], r


def test_sharded_resume_on_card_is_bit_faithful(cuda, tmp_path):
    """The same world on the card (4 ranks on one card over gloo): the
    resumed step's loss and every rank's shards equal the uninterrupted
    run's, and the other legs hold as on the CPU."""
    single, res = _run_world(str(tmp_path), "cuda")
    _hold_same_mesh_resume(res)
    for rr in res:
        assert all(rr["into_tp2_slices_equal"])
        _assert_states_equal(rr["into_tp2"], single)
        assert rr["race_listing"] == ["ckpt_3.pt", "ckpt_4.pt"]
        assert rr["config_error"] and rr["unsaved_error"] and rr["unshared_error"]
