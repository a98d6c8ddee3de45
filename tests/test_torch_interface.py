"""``ffpa_attn_func`` of the port against the JAX package's: the dense and
decode routes, the fallback rules, the error taxonomy, the kernel-only
options, and the rule that the port never imports JAX.

Tolerances: bf16 outputs 2e-2 relative to max|o| (tests/test_features.py:127);
the fallback paths are the fp32 oracle on both sides, compared at 1e-2
after rounding to bf16 (one bf16 ulp of the output).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # JAX is the reference; absent beside the card

from _torch_parity import randn, rel_err, to_jax, to_torch
from ffpa_attn_tpu import ffpa_attn_func as jax_attn
from ffpa_attn_tpu_torch import CudaBackend, SDPABackend, ffpa_attn_func as torch_attn
from ffpa_attn_tpu_torch.functional import _coerce_backend
from ffpa_attn_tpu_torch.ops import decode as tdec
from ffpa_attn_tpu_torch.ops import flash_fwd as tfwd
from ffpa_attn_tpu_torch.ops.reference import DEFAULT_MASK_VALUE

BF16_TOL = 2e-2
FALLBACK_TOL = 1e-2
PKG = Path(__file__).resolve().parent.parent / "ffpa_attn_tpu_torch"


def _qkv(b, hq, hkv, nq, nkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (randn(rng, (b, hq, nq, d)), randn(rng, (b, hkv, nkv, d)),
            randn(rng, (b, hkv, nkv, d)))


def _both(q, k, v, dtype="bfloat16", **kw):
    jo = jax_attn(to_jax(q, dtype), to_jax(k, dtype), to_jax(v, dtype), **kw)
    to = torch_attn(to_torch(q, dtype), to_torch(k, dtype), to_torch(v, dtype), **kw)
    return jo, to


ROUTES = {
    "dense_causal_gqa": dict(shape=(1, 4, 2, 128, 128, 512), is_causal=True, enable_gqa=True),
    "dense_bool_mask": dict(shape=(1, 2, 2, 128, 160, 320), mask="bool"),
    "dense_softcap_window": dict(shape=(1, 2, 1, 128, 128, 512), is_causal=True,
                                 enable_gqa=True, softcap=5.0, window_size=(48, 0)),
    "dense_sinks_alibi": dict(shape=(1, 2, 2, 128, 128, 512), is_causal=True,
                              sinks=True, alibi=True),
    "decode_gqa_bias": dict(shape=(1, 4, 2, 1, 256, 512), enable_gqa=True, mask="valid"),
    "decode_gqa_nq4_causal": dict(shape=(1, 8, 2, 4, 192, 512), enable_gqa=True,
                                  is_causal=True),
    "decode_mha_composite": dict(shape=(1, 2, 2, 1, 192, 512), mask="valid"),
    "decode_gqa_sinks": dict(shape=(1, 4, 2, 2, 192, 512), enable_gqa=True, sinks=True),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_ffpa_attn_func_matches_jax(name):
    spec = dict(ROUTES[name])
    b, hq, hkv, nq, nkv, d = spec.pop("shape")
    q, k, v = _qkv(b, hq, hkv, nq, nkv, d)
    rng = np.random.default_rng(9)
    mask = spec.pop("mask", None)
    if mask == "bool":
        mask = rng.random((b, 1, nq, nkv)) > 0.2
    elif mask == "valid":
        mask = np.where(np.arange(nkv) < nkv - 37, 0.0, DEFAULT_MASK_VALUE).astype(
            np.float32)[None, None, None]
    kw = {}
    if spec.pop("sinks", False):
        kw["sinks"] = randn(rng, (hq,))
    if spec.pop("alibi", False):
        kw["alibi_slopes"] = rng.uniform(0.01, 0.2, (hq,)).astype(np.float32)
    jkw = {k_: to_jax(v_) for k_, v_ in kw.items()}
    tkw = {k_: to_torch(v_) for k_, v_ in kw.items()}
    jo = jax_attn(to_jax(q, "bfloat16"), to_jax(k, "bfloat16"), to_jax(v, "bfloat16"),
                  attn_mask=None if mask is None else to_jax(mask.astype(np.float32)).astype(mask.dtype),
                  **spec, **jkw)
    to = torch_attn(to_torch(q, "bfloat16"), to_torch(k, "bfloat16"), to_torch(v, "bfloat16"),
                    attn_mask=None if mask is None else torch.from_numpy(mask), **spec, **tkw)
    assert to.dtype == torch.bfloat16 and tuple(to.shape) == (b, hq, nq, d)
    assert rel_err(to, jo) < BF16_TOL, name


@pytest.mark.parametrize("d", [128, 1088])
def test_fallback_head_dims_match_jax(d):
    q, k, v = _qkv(1, 4, 2, 64, 64, d)
    jo, to = _both(q, k, v, is_causal=True, enable_gqa=True)
    assert rel_err(to, jo) < FALLBACK_TOL


def test_fallback_small_seq_and_sdpa_backend():
    q, k, v = _qkv(1, 2, 2, 24, 24, 512)
    jo, to = _both(q, k, v, is_causal=True)  # 8 < Nq < 128
    assert rel_err(to, jo) < FALLBACK_TOL
    q, k, v = _qkv(1, 2, 2, 128, 128, 512)
    jo, to = _both(q, k, v, is_causal=True, backend="sdpa")
    assert rel_err(to, jo) < FALLBACK_TOL


def test_error_taxonomy():
    q = torch.zeros((1, 4, 128, 512), dtype=torch.bfloat16)
    kv = torch.zeros((1, 2, 128, 512), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="unexpected keyword"):
        torch_attn(q, q, q, bogus=1)
    q256 = torch.zeros((1, 4, 256, 512), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Nkv >= Nq"):
        torch_attn(q256, q, q, is_causal=True)
    with pytest.raises(ValueError, match="enable_gqa"):
        torch_attn(q, kv, kv)
    with pytest.raises(ValueError, match="window_size"):
        torch_attn(q, q, q, window_size=(-2, 3))
    with pytest.raises(ValueError, match="window_size"):
        torch_attn(q, q, q, window_size=(3,))
    with pytest.raises(ValueError, match="sinks"):
        torch_attn(q, q, q, sinks=torch.zeros(3))
    with pytest.raises(ValueError, match="alibi_slopes"):
        torch_attn(q, q, q, alibi_slopes=torch.zeros(2, 2))
    with pytest.raises(TypeError, match="float16 or bfloat16"):
        torch_attn(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="unknown backend"):
        torch_attn(q, q, q, backend="tpu9")
    with pytest.raises(ValueError, match="block_q"):
        torch_attn(q, q, q, backend=CudaBackend(block_q=48))


def test_backend_names_keep_their_meaning():
    assert isinstance(_coerce_backend("sdpa"), SDPABackend)
    for name in ("cuda", "pallas", "mosaic", "triton", "cutedsl", "CUDA"):
        assert isinstance(_coerce_backend(name), CudaBackend)
    assert _coerce_backend(None) is None


def test_kernel_route_options_raise_not_implemented():
    """Every option of the kernel route is ported: meta tensors, which
    stand in for CUDA tensors, reach the forward (with save_scores=True its
    S residual) and are refused there as non-CUDA tensors; CPU tensors run
    the plain versions under autograd, with dropout and S residency, and
    through the decode route's backward."""
    q = torch.empty((1, 2, 128, 512), device="meta", dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        torch_attn(q, q, q, is_causal=True, backward_backend=CudaBackend(save_scores=True))
    for kw in (dict(dropout_p=0.1), dict(backward_backend=CudaBackend(save_scores=True))):
        qc = torch.randn((1, 2, 128, 512), dtype=torch.bfloat16, requires_grad=True)
        out = torch_attn(qc, qc, qc, is_causal=True, **kw)
        out.float().sum().backward()
        assert bool(torch.isfinite(qc.grad.float()).all())
    qd = torch.randn((1, 4, 1, 512), dtype=torch.bfloat16, requires_grad=True)
    kd = torch.randn((1, 2, 128, 512), dtype=torch.bfloat16, requires_grad=True)
    out = torch_attn(qd, kd, kd, enable_gqa=True)
    out.float().sum().backward()
    assert bool(torch.isfinite(qd.grad.float()).all()) and bool(torch.isfinite(kd.grad.float()).all())


def test_dropout_on_cpu_matches_jax():
    """CPU tensors take the plain version, which has the hash dropout."""
    q, k, v = _qkv(1, 2, 2, 128, 128, 320)
    jo, to = _both(q, k, v, dropout_p=0.25, is_causal=True, dropout_seed=11)
    assert rel_err(to, jo) < BF16_TOL


def test_cpu_calls_launch_no_kernel():
    q, k, v = _qkv(1, 4, 2, 1, 256, 512)
    f0, d0 = tfwd.flash_attention_forward.launches, tdec._decode_forward.launches
    torch_attn(to_torch(q, "bfloat16"), to_torch(k, "bfloat16"), to_torch(v, "bfloat16"),
               enable_gqa=True)
    assert (tfwd.flash_attention_forward.launches, tdec._decode_forward.launches) == (f0, d0)


def test_package_never_imports_jax():
    code = (
        "import sys, ffpa_attn_tpu_torch, ffpa_attn_tpu_torch.models, "
        "ffpa_attn_tpu_torch.ops.decode, ffpa_attn_tpu_torch.ops._build\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'ffpa_attn_tpu' or m.startswith('ffpa_attn_tpu.'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(PKG.parent), timeout=120)
    assert res.returncode == 0, res.stderr
    pat = re.compile(r"ffpa_attn_tpu\.|^\s*(import jax|from jax)", re.M)
    for path in sorted(PKG.rglob("*.py")):
        hits = pat.findall(path.read_text())
        assert not hits, f"{path.name}: {hits}"


def test_mha_decode_takes_the_decode_route(monkeypatch):
    """Decode shapes take the decode route for MHA as for GQA (the JAX
    package's MHA composite would be the unfused fp32 oracle here)."""
    from ffpa_attn_tpu_torch.ops import decode as tdec_mod

    calls = []
    real = tdec_mod.decode_attention

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(tdec_mod, "decode_attention", spy)
    q, k, v = _qkv(1, 4, 4, 1, 256, 512)
    jo, to = _both(q, k, v)
    assert calls == [torch.Size([1, 4, 1, 512])]
    assert rel_err(to, jo) < BF16_TOL
