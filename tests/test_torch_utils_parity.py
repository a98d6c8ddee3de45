"""The smaller public names of the JAX package and their counterparts in
the port, on the CPU: ``utils/profiling.py`` ``trace`` (a Chrome trace of a
CPU call) and ``kernel_cost_summary`` (the same flop and bytes as the JAX
package's over a grid of shapes, ms at the H100 peaks), ``env.EnvSnapshot``
(the shared flags read alike, the TPU-only ones absent),
``functional.MIN_LARGE_D``, ``models.init_params`` (the JAX package's
shapes and dtypes leaf by leaf, its scales from a ``torch.Generator``),
``autotune.store.config_dirs`` and ``logger.reset_once_cache``.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from _torch_parity import jax_modules
from ffpa_attn_tpu_torch import ffpa_attn_func
from ffpa_attn_tpu_torch import functional as tfunc
from ffpa_attn_tpu_torch.env import ENV, EnvSnapshot
from ffpa_attn_tpu_torch.models import ModelConfig, init_params, params_from_jax
from ffpa_attn_tpu_torch.utils import profiling as tprof


def test_trace_writes_a_chrome_trace_of_a_cpu_call(tmp_path):
    q = torch.randn(1, 2, 128, 320, dtype=torch.bfloat16)
    path = tmp_path / "traces" / "call.json"
    with tprof.trace(str(path)):
        ffpa_attn_func(q, q, q, is_causal=True)
    events = json.loads(path.read_text())["traceEvents"]
    assert any("einsum" in str(e.get("name", "")) or "bmm" in str(e.get("name", ""))
               for e in events)


@pytest.mark.parametrize("direction", ["fwd", "bwd", "fwd_bwd"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,hq,nq,nkv,d,dv", [(1, 32, 8192, 8192, 512, None),
                                              (2, 8, 1024, 4096, 1024, 320),
                                              (4, 16, 1, 4224, 320, None)])
def test_kernel_cost_summary_counts_as_the_jax_package(direction, causal, b, hq, nq, nkv, d,
                                                       dv):
    (jprof,) = jax_modules("ffpa_attn_tpu.utils.profiling")
    if causal and nkv < nq:
        pytest.skip("tail-aligned causal needs Nkv >= Nq")
    kw = dict(causal=causal, direction=direction)
    want = jprof.kernel_cost_summary(b, hq, nq, nkv, d, dv, **kw)
    got = tprof.kernel_cost_summary(b, hq, nq, nkv, d, dv, **kw)
    assert (got["flops"], got["hbm_bytes"]) == (want["flops"], want["hbm_bytes"])
    # The port's times are at the H100's peaks, not the TPU's.
    assert got["compute_bound_ms"] == pytest.approx(got["flops"] / 989e12 * 1e3)
    assert got["memory_bound_ms"] == pytest.approx(got["hbm_bytes"] / 3.35e12 * 1e3)
    assert got["speed_of_light_ms"] == max(got["compute_bound_ms"], got["memory_bound_ms"])
    assert got["bound"] == ("compute" if got["compute_bound_ms"] >= got["memory_bound_ms"]
                            else "memory")


def test_env_snapshot_reads_the_ports_flags(monkeypatch):
    (jenv,) = jax_modules("ffpa_attn_tpu.env")
    monkeypatch.setenv("FFPA_TORCH_MIN_SEQLEN_Q", "96")
    monkeypatch.setenv("FFPA_TORCH_SKIP_TUNED_CONFIG", "1")
    monkeypatch.setenv("FFPA_TORCH_TUNED_CONFIG_DIR", "/tmp/tuned")
    snap = ENV.snapshot()
    assert isinstance(snap, EnvSnapshot)
    assert (snap.min_seqlen_q, snap.skip_persistent_tuned_config, snap.tuned_config_dir) == (
        96, True, "/tmp/tuned")
    with pytest.raises(AttributeError):
        snap.min_seqlen_q = 1  # frozen
    jfields = set(jenv.EnvSnapshot.__dataclass_fields__)
    tfields = set(EnvSnapshot.__dataclass_fields__)
    assert jfields - tfields == {"interpret", "vmem_limit_bytes"}  # TPU-only: absent
    for name in tfields:
        assert getattr(snap, name) == getattr(ENV, name)()


def test_min_large_d_is_the_jax_packages():
    (jfunc,) = jax_modules("ffpa_attn_tpu.functional")
    assert (tfunc.MIN_LARGE_D, tfunc.MAX_LARGE_D) == (jfunc.MIN_LARGE_D, jfunc.MAX_LARGE_D)
    # Below it the call takes the reference, at it the kernel path.
    meta = tfunc.FFPAAttnMeta.from_kwargs()
    small = torch.zeros(1, 1, 256, tfunc.MIN_LARGE_D - 1)
    large = torch.zeros(1, 1, 256, tfunc.MIN_LARGE_D)
    assert meta.fallback(small, small, None, 0.0) and not meta.fallback(large, large, None, 0.0)


@pytest.mark.parametrize("dtype,sinks", [("bfloat16", False), ("float16", True)])
def test_init_params_has_the_jax_packages_leaves(dtype, sinks):
    jax, jnp, jmodels = jax_modules("jax", "jax.numpy", "ffpa_attn_tpu.models")
    kw = dict(vocab_size=96, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=320,
              dtype=dtype, attn_sinks=sinks)
    want = jmodels.init_params(jax.random.PRNGKey(0), jmodels.ModelConfig(**kw))
    cfg = ModelConfig(**kw)
    got = init_params(cfg, torch.Generator().manual_seed(0))
    wl, wdef = jax.tree_util.tree_flatten(want)
    gl, gdef = jax.tree_util.tree_flatten(got)
    assert wdef == gdef
    for w, g in zip(wl, gl):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).rpartition(".")[2] == str(jnp.dtype(w.dtype))
    # The JAX package's scales: 0.02 for the embedding, 1/sqrt(fan_in) for
    # the projections; norms one, sinks zero.
    assert float(got["embed"].float().std()) == pytest.approx(0.02, rel=0.1)
    wq = got["layers"][0]["wq"].float()
    assert float(wq.std()) == pytest.approx(64 ** -0.5, rel=0.1)
    assert bool((got["layers"][1]["mlp_norm"] == 1).all())
    again = init_params(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(gl, jax.tree_util.tree_leaves(again)))
    model = params_from_jax(got, cfg, device="cpu")
    assert torch.equal(model.layers[0].wq.weight, got["layers"][0]["wq"].T)
    np.testing.assert_array_equal(model.embed.detach().float().numpy(),
                                  got["embed"].float().numpy())


def test_config_dirs_and_once_cache_as_the_jax_package(monkeypatch, tmp_path):
    jstore, jlog = jax_modules("ffpa_attn_tpu.autotune.store", "ffpa_attn_tpu.logger")
    from ffpa_attn_tpu_torch import logger as tlog
    from ffpa_attn_tpu_torch.autotune import store as tstore

    monkeypatch.setenv("FFPA_TPU_TUNED_CONFIG_DIR", str(tmp_path))
    monkeypatch.setenv("FFPA_TORCH_TUNED_CONFIG_DIR", str(tmp_path))
    got, want = tstore.config_dirs(), jstore.config_dirs()
    assert got[0] == want[0] == tmp_path and len(got) == len(want) == 2
    assert got[1].name == want[1].name == "configs"
    monkeypatch.delenv("FFPA_TORCH_TUNED_CONFIG_DIR")
    assert [d.name for d in tstore.config_dirs()] == ["configs"]
    log = tlog.init_logger("parity_once")
    log.warning_once("once %d", 1)
    assert (log.name, "once 1") in tlog._ONCE_SEEN
    tlog.reset_once_cache()
    assert not tlog._ONCE_SEEN
    jlog.reset_once_cache()
