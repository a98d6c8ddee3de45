"""The search at the call: ``CudaBackend(autotune=True)`` (also named
``PallasBackend``, the JAX package's name) against the JAX package's
``PallasBackend(autotune=True)``, on the CPU with the timers stubbed.

The forward is searched once per variant key (the JAX package's: shapes,
dtype, bias shape, causal, dropout, mode) and its output held to the JAX
package's at ``tests/test_ffpa_fwd.py``'s tolerance; the backward is
searched only where a gradient can follow; under ``torch.compile`` (the JAX
package's jit tracing) the call warns once and takes the store or the
default; a bad mode raises the JAX package's ValueError. On a card, a
stored forward ring cap reaches the launch's argument list.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_parity import cuda, jax_modules, np32, randn, to_jax, to_torch  # noqa: F401
from ffpa_attn_tpu_torch import CudaBackend, PallasBackend, ffpa_attn_func
from ffpa_attn_tpu_torch import functional as tfunc
from ffpa_attn_tpu_torch.autotune import search as tsearch
from ffpa_attn_tpu_torch.autotune import store as tstore
from ffpa_attn_tpu_torch.ops import attention as tattn
from ffpa_attn_tpu_torch.ops.config import BlockConfig


@pytest.fixture
def counted(monkeypatch, tmp_path):
    """Stubbed timers (each step runs once; a forward at the plan's depth
    reads 1.0 ms and one at a capped ring 0.5, so the first capped
    candidate wins), an empty autotune cache, an empty store, and the
    searches counted."""
    from ffpa_attn_tpu_torch.cli import _bench
    from ffpa_attn_tpu_torch.ops import flash_fwd

    monkeypatch.setattr(tattn, "_AUTOTUNE_CACHE", {})
    monkeypatch.setenv("FFPA_TORCH_TUNED_CONFIG_DIR", str(tmp_path))
    tstore.clear_lookup_cache()
    last = {}
    real_fwd = flash_fwd.flash_attention_forward

    def recording(*a, config=None, **kw):
        last["cfg"] = config
        return real_fwd(*a, config=config, **kw)

    monkeypatch.setattr(flash_fwd, "flash_attention_forward", recording)

    def timed(fn, *, device, warmup=2, iters=10):
        fn()
        cfg = last.get("cfg")
        return 1.0 if cfg is None or cfg.fwd_ring_cap == 0 else 0.5

    monkeypatch.setattr(_bench, "time_fwd", timed)
    monkeypatch.setattr(_bench, "time_bwd", lambda prep, *, device, warmup=2, iters=10: (
        prep()(), 0.5)[1])
    calls = {"fwd": 0, "bwd": 0}
    for direction, name in (("fwd", "autotune_forward"), ("bwd", "autotune_backward")):
        real = getattr(tsearch, name)

        def count(*a, _real=real, _d=direction, **kw):
            calls[_d] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(tsearch, name, count)
    yield calls
    tstore.clear_lookup_cache()


def _qkv(seed, shape=(1, 2, 256, 320)):
    rng = np.random.default_rng(seed)
    return [to_torch(randn(rng, shape), "bfloat16") for _ in range(3)]


def test_search_runs_once_per_variant(counted):
    q, k, v = _qkv(0)
    be = CudaBackend(autotune=True)
    o1 = ffpa_attn_func(q, k, v, backend=be)
    o2 = ffpa_attn_func(q, k, v, backend=be)
    assert counted == {"fwd": 1, "bwd": 0} and torch.equal(o1, o2)
    ffpa_attn_func(q, k, v, backend=be, is_causal=True)  # another variant
    ffpa_attn_func(q[:, :, :128], k, v, backend=be)  # another shape
    ffpa_attn_func(q, k, v, backend=CudaBackend(autotune=True, autotune_mode="max"))
    assert counted["fwd"] == 4
    keys = list(tattn._AUTOTUNE_CACHE)
    assert keys[0] == ("fwd", (1, 2, 256, 320), (1, 2, 256, 320), (1, 2, 256, 320),
                       "torch.bfloat16", None, False, False, "fast")
    # The stub makes every other candidate beat the plan: the winner is the
    # first of them, the plan's depth less one.
    assert tattn._AUTOTUNE_CACHE[keys[0]].fwd_ring_cap == 7
    # A manual block skips the search.
    ffpa_attn_func(q, k, v, backend=CudaBackend(autotune=True, block_q=64), is_causal=True,
                   dropout_p=0.0, scale=0.1)
    assert counted["fwd"] == 4


def test_backward_searched_only_under_grad(counted):
    q, k, v = _qkv(1)
    be = CudaBackend(autotune=True)
    with torch.no_grad():
        ffpa_attn_func(q, k, v, backend=be)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ffpa_attn_func(*leaves, backend=be)
    out.float().sum().backward()
    assert counted == {"fwd": 1, "bwd": 1}
    assert all(x.grad is not None and torch.isfinite(x.grad.float()).all() for x in leaves)
    (bkey,) = [key for key in tattn._AUTOTUNE_CACHE if key[0] == "bwd"]
    assert tattn._AUTOTUNE_CACHE[bkey] is not None
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ffpa_attn_func(*leaves, backend=be).float().sum().backward()
    assert counted == {"fwd": 1, "bwd": 1}
    # A manual dK/dV tile skips the backward's search.
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ffpa_attn_func(*leaves, backend=CudaBackend(autotune=True, block_kv_dkdv=64),
                   is_causal=True).float().sum().backward()
    assert counted["bwd"] == 1


def test_output_matches_the_jax_autotuned_call(counted, monkeypatch):
    """The same numpy inputs through both packages' autotuned call
    (``tests/test_ffpa_fwd.py``'s test: 5e-2, the bf16 forward's)."""
    jfa, jbench = jax_modules("ffpa_attn_tpu", "ffpa_attn_tpu.cli._bench")
    monkeypatch.setenv("FFPA_TPU_AUTOTUNE_MAX_CONFIGS", "2")
    monkeypatch.setenv("FFPA_TORCH_AUTOTUNE_MAX_CONFIGS", "2")
    monkeypatch.setattr(jbench, "time_chained", lambda step, q, *rest, iters=5: 1.0)
    rng = np.random.default_rng(2)
    x = randn(rng, (1, 2, 256, 320))
    jo = jfa.ffpa_attn_func(*(to_jax(x, "bfloat16"),) * 3,
                            backend=jfa.PallasBackend(autotune=True))
    to = ffpa_attn_func(*(to_torch(x, "bfloat16"),) * 3, backend=PallasBackend(autotune=True))
    np.testing.assert_allclose(np32(to), np32(jo), atol=5e-2, rtol=5e-2)
    assert counted["fwd"] == 1


def test_capture_warns_once_and_takes_the_store(counted, monkeypatch):
    from ffpa_attn_tpu_torch import logger as tlog

    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    seen = set(tlog._ONCE_SEEN)
    q, k, v = _qkv(3)
    be = CudaBackend(autotune=True)
    o1 = ffpa_attn_func(q, k, v, backend=be)
    o2 = ffpa_attn_func(q, k, v, backend=be)
    new = [m for _, m in tlog._ONCE_SEEN - seen if "autotune=True" in m]
    assert len(new) == 1 and "torch.compile" in new[0]
    assert counted == {"fwd": 0, "bwd": 0} and not tattn._AUTOTUNE_CACHE
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: False)
    assert torch.equal(o1, ffpa_attn_func(q, k, v)) and torch.equal(o1, o2)


def test_bad_mode_raises_as_the_jax_package():
    (jfunc,) = jax_modules("ffpa_attn_tpu.functional")
    with pytest.raises(ValueError) as jerr:
        jfunc.PallasBackend(autotune=True, autotune_mode="turbo").validate()
    with pytest.raises(ValueError) as terr:
        CudaBackend(autotune=True, autotune_mode="turbo").validate()
    assert str(terr.value) == str(jerr.value)
    q, k, v = _qkv(4, (1, 2, 128, 320))
    with pytest.raises(ValueError, match="autotune_mode"):
        ffpa_attn_func(q, k, v, backend=PallasBackend(autotune_mode="turbo"))


@pytest.mark.parametrize("field", ["block_kv", "block_kv_dkdv"])
def test_kv_tile_overrides_are_the_compiled_tile(field):
    CudaBackend(**{field: 64}).validate()
    with pytest.raises(ValueError, match=field):
        CudaBackend(**{field: 128}).validate()


def test_pallas_backend_is_the_cuda_backend():
    import ffpa_attn_tpu_torch

    assert PallasBackend is CudaBackend is tfunc.PallasBackend
    assert "PallasBackend" in ffpa_attn_tpu_torch.__all__
    names = {f for f in CudaBackend.__dataclass_fields__}
    assert {"autotune", "autotune_mode", "block_kv_dkdv"} <= names
    (jfunc,) = jax_modules("ffpa_attn_tpu.functional")
    assert set(jfunc.PallasBackend.__dataclass_fields__) <= names


def test_stored_forward_cap_reaches_the_launch_on_card(cuda, monkeypatch, tmp_path):  # noqa: F811
    """A stored ``fwd_ring_cap`` is the ring cap the forward and the packed
    forward pass to their libraries; with the kill-switch, 0."""
    from ffpa_attn_tpu_torch.ops import _build, flash_fwd, varlen

    flash_fwd._fwd_lib()  # the entry points' argument types, set on the libraries
    varlen._varlen_lib()
    seen = []
    real = _build.load

    class Recorder:
        def __init__(self, lib):
            self._lib = lib

        def __getattr__(self, name):
            fn = getattr(self._lib, name)
            if name not in ("ffpa_flash_fwd", "ffpa_varlen_fwd"):
                return fn

            def call(*args):
                seen.append((name, args[-2]))
                return fn(*args)

            call.argtypes = fn.argtypes
            return call

    monkeypatch.setattr(_build, "load", lambda name: Recorder(real(name)))
    monkeypatch.setenv("FFPA_TORCH_TUNED_CONFIG_DIR", str(tmp_path))
    kind = torch.cuda.get_device_name(0)
    key = dict(dtype="bfloat16", headdim=512, headdim_v=512, seqlen_q=1024, seqlen_k=1024,
               causal=True, has_bias=False, dropout=False, gqa=True, group=2)
    tstore.write_config_file([
        tstore.make_entry(tstore.ConfigKey(direction="fwd", **key), BlockConfig(fwd_ring_cap=3)),
        tstore.make_entry(tstore.ConfigKey(direction="varlen", **dict(
            key, causal=False, gqa=False, group=0)), BlockConfig(fwd_ring_cap=5)),
    ], device_kind=kind)
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((1, 8, 1024, 512), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((1, 4, 1024, 512), generator=g, device="cuda").bfloat16()
            for _ in range(2))
    tuned = ffpa_attn_func(q, k, v, is_causal=True, enable_gqa=True)
    cu = torch.tensor([0, 512, 1024], dtype=torch.int32, device="cuda")
    q3, k3, v3 = (x[0].transpose(0, 1).contiguous() for x in (q, k, v))
    vt = varlen._varlen_forward(q3, k3, v3, cu, cu, scale=512 ** -0.5, causal=True)[0]
    monkeypatch.setenv("FFPA_TORCH_SKIP_TUNED_CONFIG", "1")
    plain = ffpa_attn_func(q, k, v, is_causal=True, enable_gqa=True)
    vp = varlen._varlen_forward(q3, k3, v3, cu, cu, scale=512 ** -0.5, causal=True)[0]
    tstore.clear_lookup_cache()
    assert seen == [("ffpa_flash_fwd", 3), ("ffpa_varlen_fwd", 5), ("ffpa_flash_fwd", 0),
                    ("ffpa_varlen_fwd", 0)]
    assert torch.equal(tuned, plain) and torch.equal(vt, vp)
