"""The port's monkey-patch of ``torch.nn.functional.scaled_dot_product_attention``
against the JAX package's patch of ``jax.nn.dot_product_attention``.

A patched call FFPA computes runs ``ffpa_attn_func`` (bit-equal to calling
it directly; within 5e-2 of the fp32 oracle, the bf16 tolerance of
tests/test_monkey_patch.py, and within 2e-2 of the JAX package's patched
call on the same numpy inputs, the bf16 forward tolerance of
tests/test_features.py:127). Every call routed to the stock function gives
the pristine function's output exactly.

One routing reason is a fault of the reference, not copied: the JAX
adapter passes ``is_causal`` to FFPA, whose causal mask is tail-aligned
(row m sees keys <= m + Nkv - Nq), where the stock functions are top-left
aligned (row 0 sees key 0). ``test_causal_cross_length_goes_to_stock``
measures the gap on both packages.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import ffpa_attn_tpu_torch
from _torch_parity import cuda, jax_modules, np32, rel_err, to_torch  # noqa: F401
from ffpa_attn_tpu_torch import interface
from ffpa_attn_tpu_torch.ops.reference import reference_attention

BF16_TOL, ORACLE_TOL = 2e-2, 5e-2


def _qkv(b, hq, hkv, nq, nkv, d, seed=0, dtype="bfloat16"):
    rng = np.random.default_rng(seed)
    x = [rng.standard_normal(s).astype(np.float32)
         for s in ((b, hq, nq, d), (b, hkv, nkv, d), (b, hkv, nkv, d))]
    return x, [to_torch(a, dtype) for a in x]


@pytest.fixture
def patched():
    ffpa_attn_tpu_torch.patch_dot_product_attention()
    try:
        yield
    finally:
        ffpa_attn_tpu_torch.unpatch_dot_product_attention()
    assert F.scaled_dot_product_attention is interface._IMPORT_TIME_SDPA


def test_patched_large_d_runs_ffpa(patched):
    _, (q, k, v) = _qkv(1, 2, 2, 256, 256, 320)
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    assert F.scaled_dot_product_attention is interface._sdpa_compatible_ffpa
    assert torch.equal(out, ffpa_attn_tpu_torch.ffpa_attn_func(q, k, v, is_causal=True))
    ref = reference_attention(q.float(), k.float(), v.float(), None, is_causal=True)
    assert rel_err(out, ref) < ORACLE_TOL


def test_patched_call_matches_the_jax_patch(patched):
    """GQA (H4/2) D320 causal, Nq = Nkv: the JAX patch takes [B, N, H, D]."""
    jax, jnp, jpkg = jax_modules("jax", "jax.numpy", "ffpa_attn_tpu")
    x, (q, k, v) = _qkv(1, 4, 2, 256, 256, 320, seed=1)
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
    jq, jk, jv = (jnp.swapaxes(jnp.asarray(a, jnp.bfloat16), 1, 2) for a in x)
    try:
        jpkg.patch_dot_product_attention()
        want = jnp.swapaxes(jax.nn.dot_product_attention(jq, jk, jv, is_causal=True), 1, 2)
    finally:
        jpkg.unpatch_dot_product_attention()
    assert rel_err(out, want) < BF16_TOL


# Each reason a call goes to the stock function: (name, shapes, dtype, call kwargs).
STOCK_CASES = {
    "d64": ((1, 2, 2, 256, 256, 64), "bfloat16", dict(is_causal=True)),
    "d1280": ((1, 2, 2, 256, 256, 1280), "bfloat16", dict()),
    "short_nq": ((1, 2, 2, 64, 256, 320), "bfloat16", dict()),
    "dropout": ((1, 2, 2, 256, 256, 320), "bfloat16", dict(dropout_p=0.1)),
    "causal_nq_ne_nkv": ((1, 2, 2, 4, 256, 320), "bfloat16", dict(is_causal=True)),
    "float32": ((1, 2, 2, 256, 256, 320), "float32", dict(is_causal=True)),
    # fp16 GQA with a bool mask at a short Nq (the fallback rule's 8 < Nq < 128).
    "float16_gqa_mask_short_nq": ((1, 4, 2, 100, 256, 320), "float16",
                                  dict(enable_gqa=True, mask=True)),
}


@pytest.mark.parametrize("name", sorted(STOCK_CASES))
def test_routed_calls_equal_the_pristine_function(patched, name):
    shape, dtype, kw = STOCK_CASES[name]
    kw = dict(kw)
    _, (q, k, v) = _qkv(*shape, seed=2, dtype=dtype)
    if kw.pop("mask", False):
        kw["attn_mask"] = torch.rand(q.shape[2], k.shape[2],
                                     generator=torch.Generator().manual_seed(3)) > 0.2
    torch.manual_seed(4)
    got = F.scaled_dot_product_attention(q, k, v, **kw)
    torch.manual_seed(4)
    want = interface._IMPORT_TIME_SDPA(q, k, v, **kw)
    assert torch.equal(got, want)


def test_three_d_inputs_equal_the_pristine_function(patched):
    _, (q, k, v) = _qkv(1, 2, 2, 256, 256, 320, seed=5)
    q, k, v = q[0], k[0], v[0]
    assert torch.equal(F.scaled_dot_product_attention(q, k, v),
                       interface._IMPORT_TIME_SDPA(q, k, v))


def test_unknown_arguments_raise_as_stock(patched):
    _, (q, k, v) = _qkv(1, 2, 2, 256, 256, 320)
    with pytest.raises(TypeError, match="unexpected keyword"):
        F.scaled_dot_product_attention(q, k, v, window_size=(8, 8))
    with pytest.raises(TypeError, match="positional"):
        F.scaled_dot_product_attention(q, k, v, None, 0.0, False, 0.5)


def test_causal_cross_length_goes_to_stock(patched):
    """Nq 4 < Nkv 256 under is_causal: the port's patch gives the stock
    (top-left) function; the tail-aligned FFPA call differs from it by about
    its own size, and so does the JAX package's patched call from stock
    jax.nn.dot_product_attention."""
    jax, jnp, jpkg = jax_modules("jax", "jax.numpy", "ffpa_attn_tpu")
    x, (q, k, v) = _qkv(1, 2, 2, 4, 256, 320, seed=6)
    got = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    assert torch.equal(got, interface._IMPORT_TIME_SDPA(q, k, v, is_causal=True))
    tail = ffpa_attn_tpu_torch.ffpa_attn_func(q, k, v, is_causal=True)
    assert rel_err(tail, got) > 0.5
    jq, jk, jv = (jnp.swapaxes(jnp.asarray(a, jnp.bfloat16), 1, 2) for a in x)
    stock = np32(jax.nn.dot_product_attention(jq, jk, jv, is_causal=True))
    try:
        jpkg.patch_dot_product_attention()
        jpatched = np32(jax.nn.dot_product_attention(jq, jk, jv, is_causal=True))
    finally:
        jpkg.unpatch_dot_product_attention()
    assert rel_err(jpatched, stock) > 0.5
    assert rel_err(np.swapaxes(stock, 1, 2), got) < BF16_TOL


def test_patch_twice_does_not_recurse(patched):
    ffpa_attn_tpu_torch.patch_dot_product_attention()
    assert interface._ORIG_SDPA is interface._IMPORT_TIME_SDPA
    _, (q, k, v) = _qkv(1, 2, 2, 128, 128, 64, seed=7)
    assert torch.equal(F.scaled_dot_product_attention(q, k, v),
                       interface._IMPORT_TIME_SDPA(q, k, v))


def test_unpatch_restores_the_pristine_object():
    ffpa_attn_tpu_torch.unpatch_dot_product_attention()  # idempotent when not patched
    assert F.scaled_dot_product_attention is interface._IMPORT_TIME_SDPA
    ffpa_attn_tpu_torch.patch_dot_product_attention()
    ffpa_attn_tpu_torch.unpatch_dot_product_attention()
    ffpa_attn_tpu_torch.unpatch_dot_product_attention()
    assert F.scaled_dot_product_attention is interface._IMPORT_TIME_SDPA
    assert interface._ORIG_SDPA is None


def test_gradients_flow_through_the_patched_call(patched):
    _, qkv = _qkv(1, 4, 2, 128, 128, 320, seed=8)
    leaves = [t.clone().requires_grad_() for t in qkv]
    do = torch.randn(1, 4, 128, 320, generator=torch.Generator().manual_seed(9)).bfloat16()
    out = F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True)
    grads = torch.autograd.grad(out, leaves, do)
    direct = [t.clone().requires_grad_() for t in qkv]
    want = torch.autograd.grad(
        ffpa_attn_tpu_torch.ffpa_attn_func(*direct, is_causal=True, enable_gqa=True), direct, do)
    for g, w, t in zip(grads, want, qkv):
        assert g.shape == t.shape and g.dtype == t.dtype
        assert bool(torch.isfinite(g.float()).all())
        assert torch.equal(g, w)


def test_patched_call_on_card_launches_the_forward(cuda, patched):
    from ffpa_attn_tpu_torch.ops import flash_fwd

    _, (q, k, v) = _qkv(1, 4, 2, 256, 256, 320, seed=10)
    q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
    f0 = flash_fwd.flash_attention_forward.launches
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
    torch.cuda.synchronize()
    assert flash_fwd.flash_attention_forward.launches - f0 == 1
    assert torch.equal(out, ffpa_attn_tpu_torch.ffpa_attn_func(q, k, v, is_causal=True,
                                                               enable_gqa=True))
    d64 = [t[..., :64].contiguous() for t in (q, k, v)]
    f1 = flash_fwd.flash_attention_forward.launches
    assert torch.equal(F.scaled_dot_product_attention(*d64, enable_gqa=True),
                       interface._IMPORT_TIME_SDPA(*d64, enable_gqa=True))
    assert flash_fwd.flash_attention_forward.launches == f1
