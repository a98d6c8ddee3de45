"""Gradients through the port's ``ffpa_attn_func`` against ``jax.grad``
through the JAX package's, for each backward tier: the S-resident tier
(``save_scores=True``), the dS handoff, the recompute pair
(``ds_handoff=False``) and the SDPA oracle, with sinks and the bias
gradient, and partial S residency under a budget. JAX runs its Pallas
kernels in interpret mode, the port (on the CPU) their plain versions.

Tolerances: the JAX suite's gradient contract (tests/test_ffpa_bwd.py:19),
bf16 5e-2 and fp16 1e-2 relative to max|grad| of each gradient. JAX
computes fp16 in bf16 (with its hi+lo split of dV), the port natively: the
fp16 case holds both to the fp32 oracle at 1e-2.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import cuda, grad_row_rel_err, jax_modules, randn, rel_err, to_torch  # noqa: F401
from ffpa_attn_tpu_torch import CudaBackend, SDPABackend, ffpa_attn_func as torch_attn
from ffpa_attn_tpu_torch.ops import attention as tattn
from ffpa_attn_tpu_torch.ops import flash_bwd as tbwd
from ffpa_attn_tpu_torch.ops.reference import expand_kv_heads, reference_attention

TOL = {"bfloat16": 5e-2, "float16": 1e-2}
TIERS = ("resident", "handoff", "recompute", "sdpa")

CASES = {
    "causal_gqa": dict(shape=(1, 4, 2, 128, 128, 320), is_causal=True),
    "cross_bias": dict(shape=(1, 2, 2, 128, 192, 320), mask="full"),
    "causal_sinks_keybias": dict(shape=(1, 2, 1, 128, 160, 512), is_causal=True, sinks=True,
                                 mask="key"),
    "window_softcap": dict(shape=(1, 2, 1, 160, 160, 320), is_causal=True, softcap=5.0,
                           window_size=(48, -1)),
}


def _inputs(case, seed=0):
    b, hq, hkv, nq, nkv, d = case["shape"]
    rng = np.random.default_rng(seed)
    x = dict(q=randn(rng, (b, hq, nq, d)), k=randn(rng, (b, hkv, nkv, d)),
             v=randn(rng, (b, hkv, nkv, d)), do=randn(rng, (b, hq, nq, d)))
    if case.get("mask") == "full":
        x["mask"] = randn(rng, (b, 1, nq, nkv))
    elif case.get("mask") == "key":
        x["mask"] = randn(rng, (1, 1, 1, nkv))
    if case.get("sinks"):
        x["sinks"] = randn(rng, (hq,))
    return x


def _kwargs(case):
    kw = {k: case[k] for k in ("is_causal", "softcap", "window_size") if k in case}
    kw["enable_gqa"] = case["shape"][1] != case["shape"][2]
    return kw


def _backends(tier, jax_side):
    if jax_side:
        from ffpa_attn_tpu.functional import PallasBackend, SDPABackend as JSDPA

        return {"resident": PallasBackend(save_scores=True),
                "handoff": PallasBackend(ds_handoff=True, save_scores=False),
                "recompute": PallasBackend(ds_handoff=False, save_scores=False),
                "sdpa": JSDPA()}[tier]
    return {"resident": CudaBackend(save_scores=True),
            "handoff": CudaBackend(ds_handoff=True, save_scores=False),
            "recompute": CudaBackend(ds_handoff=False, save_scores=False),
            "sdpa": SDPABackend()}[tier]


def _jax_grads(case, x, tier, dtype):
    jax, jnp, jiface = jax_modules("jax", "jax.numpy", "ffpa_attn_tpu")
    names = [n for n in ("q", "k", "v", "mask", "sinks") if n in x]

    def f(*args):
        a = dict(zip(names, args))
        kw = _kwargs(case)
        if "mask" in a:
            kw["attn_mask"] = a["mask"]
        if "sinks" in a:
            kw["sinks"] = a["sinks"]
        return jiface.ffpa_attn_func(a["q"], a["k"], a["v"],
                                     backward_backend=_backends(tier, True), **kw)

    args = [jnp.asarray(x[n], getattr(jnp, dtype) if n in "qkv" else jnp.float32)
            for n in names]
    out, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(x["do"], out.dtype))
    return dict(zip(names, (np.asarray(g, np.float32) for g in grads)))


def _torch_grads(case, x, tier, dtype, device="cpu"):
    names = [n for n in ("q", "k", "v", "mask", "sinks") if n in x]
    t = {n: to_torch(x[n], dtype if n in "qkv" else "float32", device).requires_grad_()
         for n in names}
    kw = _kwargs(case)
    if "mask" in t:
        kw["attn_mask"] = t["mask"]
    if "sinks" in t:
        kw["sinks"] = t["sinks"]
    out = torch_attn(t["q"], t["k"], t["v"], backward_backend=_backends(tier, False), **kw)
    grads = torch.autograd.grad(out, [t[n] for n in names], to_torch(x["do"], dtype, device))
    return dict(zip(names, grads))


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_grads_match_jax(name, tier):
    case = CASES[name]
    x = _inputs(case)
    want = _jax_grads(case, x, tier, "bfloat16")
    got = _torch_grads(case, x, tier, "bfloat16")
    assert set(got) == set(want)
    for n in got:
        assert tuple(got[n].shape) == want[n].shape, n
        if n in "qkv":
            assert got[n].dtype == torch.bfloat16, n
        assert rel_err(got[n], want[n]) < TOL["bfloat16"], n


# Above D512, through the S-resident tier: dK out of the kernel, on a card
# the from-S cluster of two blocks.
WIDE_CASES = {
    "d640_causal_gqa": dict(shape=(1, 4, 2, 128, 160, 640), is_causal=True),
    "d1024_cross_keybias": dict(shape=(1, 2, 1, 128, 192, 1024), mask="key"),
}


@pytest.mark.parametrize("name", sorted(WIDE_CASES))
def test_wide_resident_grads_match_jax(name):
    case = WIDE_CASES[name]
    x = _inputs(case, seed=5)
    want = _jax_grads(case, x, "resident", "bfloat16")
    got = _torch_grads(case, x, "resident", "bfloat16")
    assert set(got) == set(want)
    for n in got:
        assert tuple(got[n].shape) == want[n].shape, n
        assert rel_err(got[n], want[n]) < TOL["bfloat16"], n


@pytest.mark.parametrize("name", sorted(WIDE_CASES))
def test_wide_resident_grads_on_card_match_cpu(cuda, name):
    """One from-S launch (the cluster route), banded dQ and dK under causal."""
    case = WIDE_CASES[name]
    x = _inputs(case, seed=6)
    before = _launches()
    got = _torch_grads(case, x, "resident", "bfloat16", cuda)
    torch.cuda.synchronize()
    causal = int(case.get("is_causal", False))
    assert tuple(a - b for a, b in zip(_launches(), before)) == (0, 0, causal, 1, causal)
    want = _torch_grads(case, x, "resident", "bfloat16")
    for n in got:
        measure = grad_row_rel_err if n in "qkv" else rel_err
        assert measure(got[n], want[n]) < TOL["bfloat16"], n


# Above D512 through the recompute tier (a window takes it whatever the
# backend asks): on a card the dK/dV and dQ clusters of two blocks.
WIDE_RECOMPUTE_CASES = {
    "d640_window_gqa": dict(shape=(1, 4, 2, 160, 160, 640), is_causal=True,
                            window_size=(48, -1)),
}


@pytest.mark.parametrize("name", sorted(WIDE_RECOMPUTE_CASES))
def test_wide_recompute_grads_match_jax(name):
    case = WIDE_RECOMPUTE_CASES[name]
    x = _inputs(case, seed=7)
    want = _jax_grads(case, x, "recompute", "bfloat16")
    got = _torch_grads(case, x, "recompute", "bfloat16")
    assert set(got) == set(want)
    for n in got:
        assert tuple(got[n].shape) == want[n].shape, n
        assert rel_err(got[n], want[n]) < TOL["bfloat16"], n


@pytest.mark.parametrize("name", sorted(WIDE_RECOMPUTE_CASES))
def test_wide_recompute_grads_on_card_match_cpu(cuda, name):
    """One dK/dV and one dQ launch (both on the cluster route)."""
    case = WIDE_RECOMPUTE_CASES[name]
    x = _inputs(case, seed=8)
    before = _launches()
    got = _torch_grads(case, x, "recompute", "bfloat16", cuda)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launches(), before)) == (1, 1, 0, 0, 0)
    want = _torch_grads(case, x, "recompute", "bfloat16")
    for n in got:
        assert grad_row_rel_err(got[n], want[n]) < TOL["bfloat16"], n


def test_fp16_grads_meet_the_oracle():
    case = CASES["causal_gqa"]
    x = _inputs(case, seed=1)
    hq = case["shape"][1]
    q, k, v = (to_torch(x[n], "float16").float().requires_grad_() for n in "qkv")
    ref = reference_attention(q, expand_kv_heads(k, hq), expand_kv_heads(v, hq), is_causal=True)
    want = torch.autograd.grad(ref, (q, k, v), to_torch(x["do"], "float16").float())
    jwant = _jax_grads(case, x, "handoff", "float16")
    for tier in ("handoff", "recompute"):
        got = _torch_grads(case, x, tier, "float16")
        for n, w in zip("qkv", want):
            assert got[n].dtype == torch.float16
            assert rel_err(got[n], w) < TOL["float16"], (tier, n)
            assert rel_err(jwant[n], w) < TOL["float16"], n


def test_save_scores_true_on_the_cpu_takes_the_handoff(monkeypatch):
    """An explicit save_scores=True on CPU tensors takes the S-resident
    tier, not the dS handoff: the forward keeps every head's S residual and
    the backward reads it (the from-S pass, dK and dQ from the slab, none of
    the recompute); the gradients match ``jax.grad`` with
    ``PallasBackend(save_scores=True)``."""
    case = CASES["causal_gqa"]
    x = _inputs(case, seed=2)
    calls = []
    real = tbwd.flash_attention_backward

    def spy(*args, **kw):
        calls.append(kw.get("scores"))
        return real(*args, **kw)

    monkeypatch.setattr(tattn, "flash_attention_backward", spy)
    got = _torch_grads(case, x, "resident", "bfloat16")
    assert len(calls) == 1 and calls[0] is not None and calls[0].shape[1] == case["shape"][1]
    want = _jax_grads(case, x, "resident", "bfloat16")
    for n in ("q", "k", "v"):
        assert rel_err(got[n], want[n]) < TOL["bfloat16"], n


def test_cpu_backward_never_counts_a_launch():
    case = CASES["causal_sinks_keybias"]
    before = (tbwd._dkdv_launch.launches, tbwd._dq_launch.launches,
              tbwd._banded_dq_from_ds.launches)
    for tier in ("handoff", "recompute"):
        _torch_grads(case, _inputs(case), tier, "bfloat16")
    assert (tbwd._dkdv_launch.launches, tbwd._dq_launch.launches,
            tbwd._banded_dq_from_ds.launches) == before


def _launches():
    return (tbwd._dkdv_launch.launches, tbwd._dq_launch.launches,
            tbwd._banded_dq_from_ds.launches, tbwd._dkdv_from_s_launch.launches,
            tbwd._banded_dk_from_ds.launches)


@pytest.mark.parametrize("tier", ("resident", "handoff", "recompute"))
@pytest.mark.parametrize("name", sorted(CASES))
def test_grads_on_card_match_cpu(cuda, name, tier):
    """The kernels under autograd against the plain versions on the CPU:
    the S-resident tier launches the from-S pass (dK out of the kernel,
    ``FROM_S_DK_IN_MAX_NKV``) and, under causal, banded dQ and banded dK;
    the handoff tier dkdv and, under causal, banded dQ; the recompute tier
    (and any windowed call) dkdv and dq. Launch counts: (dkdv, dq, banded
    dQ, from-S, banded dK)."""
    case = CASES[name]
    x = _inputs(case, seed=3)
    before = _launches()
    got = _torch_grads(case, x, tier, "bfloat16", cuda)
    torch.cuda.synchronize()
    want = _torch_grads(case, x, tier, "bfloat16")
    windowed = "window_size" in case
    causal = int(case.get("is_causal", False))
    launched = tuple(a - b for a, b in zip(_launches(), before))
    if windowed or tier == "recompute":
        assert launched == (1, 1, 0, 0, 0)
    elif tier == "handoff":
        assert launched == (1, 0, causal, 0, 0)
    else:
        assert launched == (0, 0, causal, 1, causal)
    for n in got:
        measure = grad_row_rel_err if n in "qkv" else rel_err
        assert measure(got[n], want[n]) < TOL["bfloat16"], n


def test_partial_residency_grads_match_jax(monkeypatch):
    """Auto residency under a budget of 3 heads' S residuals (a quarter
    kept for the other heads' handoff slabs leaves 2.25) keeps the first
    GQA group (2 of 4 heads); the rest take the dS handoff. Both
    packages pick m = 2 and their gradients (with a key bias, whose
    gradient sums the two halves) agree; with dropout the split is refused
    (m = 0), as in the JAX package."""
    from ffpa_attn_tpu.ops.attention import StaticArgs as JStatic
    from ffpa_attn_tpu.ops.attention import _resident_head_count as jcount

    jnp, = jax_modules("jax.numpy")
    case = dict(shape=(1, 4, 2, 128, 128, 320), is_causal=True, mask="key")
    b, hq, hkv, nq, nkv, d = case["shape"]
    limit = 3 * b * nq * nkv * 2  # 3 heads' bf16 S residuals (no padding at N128)
    for pre in ("FFPA_TPU_", "FFPA_TORCH_"):
        monkeypatch.setenv(pre + "SCORES_RESIDUAL_LIMIT_BYTES", str(limit))
    seen = []
    real = tattn.flash_attention_backward

    def spy(*args, **kw):
        seen.append(None if kw.get("scores") is None else kw["scores"].shape[1])
        return real(*args, **kw)

    monkeypatch.setattr(tattn, "flash_attention_backward", spy)
    x = _inputs(case, seed=4)
    names = ("q", "k", "v", "mask")
    t = {n: to_torch(x[n], "bfloat16" if n in "qkv" else "float32").requires_grad_()
         for n in names}
    out = torch_attn(t["q"], t["k"], t["v"], attn_mask=t["mask"], is_causal=True,
                     enable_gqa=True, backward_backend=CudaBackend())
    got = dict(zip(names, torch.autograd.grad(out, [t[n] for n in names],
                                              to_torch(x["do"], "bfloat16"))))
    assert seen == [2, None]
    from ffpa_attn_tpu.functional import PallasBackend

    jax, jiface = jax_modules("jax", "ffpa_attn_tpu")

    def f(q, k, v, mask):
        return jiface.ffpa_attn_func(q, k, v, attn_mask=mask, is_causal=True, enable_gqa=True,
                                     backward_backend=PallasBackend())

    args = [jnp.asarray(x[n], jnp.bfloat16 if n in "qkv" else jnp.float32) for n in names]
    out_j, vjp = jax.vjp(f, *args)
    want = dict(zip(names, vjp(jnp.asarray(x["do"], out_j.dtype))))
    for n in names:
        assert rel_err(got[n], np.asarray(want[n], np.float32)) < TOL["bfloat16"], n
    jq = jnp.zeros((b, hq, nq, d), jnp.bfloat16)
    jkv = jnp.zeros((b, hkv, nkv, d), jnp.bfloat16)
    jst = JStatic(scale=d ** -0.5, is_causal=True, dropout_p=0.0, fwd_config=None,
                  bwd_config=None, backward_is_sdpa=False, grad_kv_storage_dtype=None,
                  grad_q_storage_dtype=None)
    tst = tattn.StaticArgs(scale=d ** -0.5, is_causal=True, dropout_p=0.0, fwd_config=None)
    tq, tkv = torch.zeros(b, hq, nq, d, dtype=torch.bfloat16), torch.zeros(
        b, hkv, nkv, d, dtype=torch.bfloat16)
    assert jcount(jst, jq, jkv, jkv, None) == tattn._resident_head_count(tst, tq, tkv, tkv,
                                                                         None) == 2
    jst_d = dataclasses.replace(jst, dropout_p=0.1)
    tst_d = dataclasses.replace(tst, dropout_p=0.1)
    assert jcount(jst_d, jq, jkv, jkv, None) == tattn._resident_head_count(
        tst_d, tq, tkv, tkv, None) == 0


def test_save_scores_policy_on_a_non_cpu_tensor(monkeypatch):
    """Meta tensors stand in for CUDA tensors: an explicit save_scores=True
    under autograd reaches the forward with ``return_scores``, except for
    fp16 inputs, which the policy sends to the dS handoff with a warning,
    as in the JAX package; the forward then refuses the meta tensor as a
    non-CUDA one."""
    seen = []
    real = tattn.flash_attention_forward

    def spy(*args, **kw):
        seen.append(kw.get("return_scores", False))
        return real(*args, **kw)

    monkeypatch.setattr(tattn, "flash_attention_forward", spy)
    warned = []
    monkeypatch.setattr(tattn.logger, "warning_once", lambda msg, *a: warned.append(msg))
    kw = dict(is_causal=True, backward_backend=CudaBackend(save_scores=True))
    q = torch.empty((1, 2, 128, 512), device="meta", dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        torch_attn(q, q, q, **kw)
    q16 = torch.empty((1, 2, 128, 512), device="meta", dtype=torch.float16, requires_grad=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        torch_attn(q16, q16, q16, **kw)
    assert seen == [True, False]
    assert len(warned) == 1 and "float16" in warned[0]
