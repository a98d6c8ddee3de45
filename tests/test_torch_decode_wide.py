"""Decode above D512 (the two-warpgroup instance of ``csrc/decode.cu``'s
TMA block) against the JAX package, at a tiny size.

On the CPU the port runs the kernel's plain version on PackGQA rows; JAX
runs its Pallas decode kernel in interpret mode. Inputs are rounded to bf16
once, from the same numpy arrays (Nkv <= 300).

* ``decode_attention`` at D640, D1024 and D1024 / Dv320 over GQA group 2
  (and 1, 4), a validity bias and a per-head bias, softcap, a causal
  window and Nq 4;
* the fp32 score residual of ``_decode_forward(return_scores=True)``;
* a tiny model with head dim 576 (L2, d_model 64, vocab 128): ``prefill``
  and teacher-forced ``decode_step`` logits, greedy ``generate``, the
  shared-row ``_batched_decode_step`` and ``serve_batch``.

Tolerances: bf16 outputs and logits 2e-2 relative to max|x| (the JAX
suite's forward tolerance, tests/test_features.py:127); LSE is fp32 math
on identical inputs, 1e-4 relative to max|lse|; the score residual 2e-2
on the attended columns, as ``tests/test_torch_decode.py`` holds it.
Greedy tokens must be equal.
"""

import math

import numpy as np
import pytest
import torch

from _torch_parity import jax_modules, randn, rel_err, to_jax, to_torch
from ffpa_attn_tpu_torch.models import (
    ModelConfig,
    decode_step,
    generate,
    init_kv_cache,
    pack_prompts,
    params_from_jax,
    prefill,
    prefill_packed,
    serve_batch,
)
from ffpa_attn_tpu_torch.models import serving as tserving
from ffpa_attn_tpu_torch.ops import decode as tdec
from ffpa_attn_tpu_torch.ops.config import decode_plan
from ffpa_attn_tpu_torch.ops.reference import DEFAULT_MASK_VALUE

BF16_TOL = 2e-2
LSE_TOL = 1e-4
HKV, NKV = 2, 300

CASES = {
    # name: (D, Dv, Nq, group, features)
    "d640_g2_valid": (640, 640, 1, 2, dict(valid_len=250)),
    "d1024_g2_valid": (1024, 1024, 1, 2, dict(valid_len=271)),
    "d1024_g1_softcap": (1024, 1024, 1, 1, dict(valid_len=200, softcap=3.0)),
    "d1024_nq4_causal_window": (1024, 1024, 4, 2, dict(is_causal=True, window=(90, -1))),
    "d1024_dv320_head_bias": (1024, 320, 2, 2, dict(head_bias=True)),
    "d1024_dv320_nq4_g4_causal": (1024, 320, 4, 4, dict(is_causal=True)),
    "d640_nq4_window_right": (640, 640, 4, 2, dict(window=(60, 0))),
}


def _inputs(name, seed=0):
    d, dv, nq, group, f = CASES[name]
    rng = np.random.default_rng(seed)
    hq = HKV * group
    x = dict(q=randn(rng, (1, hq, nq, d)), k=randn(rng, (1, HKV, NKV, d)),
             v=randn(rng, (1, HKV, NKV, dv)), bias=None)
    if "valid_len" in f:  # the serving validity bias [1, 1, 1, Nkv]
        x["bias"] = np.where(np.arange(NKV) < f["valid_len"], 0.0, DEFAULT_MASK_VALUE).astype(
            np.float32)[None, None, None]
    if f.get("head_bias"):
        x["bias"] = randn(rng, (1, hq, nq, NKV))
    kw = dict(scale=1.0 / math.sqrt(d), is_causal=f.get("is_causal", False),
              softcap=f.get("softcap", 0.0), window=f.get("window", (-1, -1)))
    return x, kw


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_attention_above_d512_matches_jax(name):
    """``decode_attention`` (the route every decode shape takes), port
    against the JAX package; the plan names the two-warpgroup block."""
    (jdec,) = jax_modules("ffpa_attn_tpu.ops.decode")
    d, dv, nq, group, _ = CASES[name]
    assert decode_plan(d, dv, nq * group).consumers == 2
    x, kw = _inputs(name)
    jo = jdec.decode_attention(to_jax(x["q"], "bfloat16"), to_jax(x["k"], "bfloat16"),
                               to_jax(x["v"], "bfloat16"), to_jax(x["bias"]), **kw)
    to = tdec.decode_attention(to_torch(x["q"], "bfloat16"), to_torch(x["k"], "bfloat16"),
                               to_torch(x["v"], "bfloat16"), to_torch(x["bias"]), **kw)
    assert tuple(to.shape) == tuple(jo.shape) == (1, HKV * group, nq, dv)
    assert to.dtype == torch.bfloat16
    assert rel_err(to, jo) < BF16_TOL, name


@pytest.mark.parametrize("name", sorted(n for n in CASES if "window" not in n))
def test_decode_forward_above_d512_lse_and_scores_match_jax(name):
    """``_decode_forward``: lse, and the fp32 score residual of the packed
    rows against the JAX kernel's on the attended columns (both hold the
    mask value elsewhere); (o, lse) unchanged by asking for it."""
    (jdec,) = jax_modules("ffpa_attn_tpu.ops.decode")
    d, dv, nq, group, _ = CASES[name]
    x, kw = _inputs(name, seed=1)
    jx = [to_jax(x[n], "bfloat16") for n in ("q", "k", "v")] + [to_jax(x["bias"])]
    tx = [to_torch(x[n], "bfloat16") for n in ("q", "k", "v")] + [to_torch(x["bias"])]
    _, jl, js = jdec._decode_forward(*jx, return_scores=True, **kw)
    to, tl, ts = tdec._decode_forward(*tx, return_scores=True, **kw)
    o0, l0 = tdec._decode_forward(*tx, **kw)
    assert torch.equal(to, o0) and torch.equal(tl, l0)
    assert rel_err(tl, jl) < LSE_TOL, name
    rows = group * nq
    assert tuple(ts.shape) == (1, HKV, rows, 320)  # Nkv padded to the 64-row tile
    want = np.asarray(js, np.float32)[:, :, :rows, :NKV]
    got = ts[..., :NKV].numpy()
    live = want > DEFAULT_MASK_VALUE / 2
    assert np.array_equal(live, got > DEFAULT_MASK_VALUE / 2)
    assert rel_err(np.where(live, got, 0.0), np.where(live, want, 0.0)) < BF16_TOL, name


# The tiny model above D512: every decode step takes the two-warpgroup
# block's plan (its plain version on the CPU).
SIZE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=2, n_kv_heads=1, head_dim=576,
            max_seq_len=512)
PROMPT, STEPS = 100, 4
LENS = (60, 40, 25)


@pytest.fixture(scope="module")
def jm():
    """jax, jax.numpy, the JAX package's models and its serving module."""
    return jax_modules("jax", "jax.numpy", "ffpa_attn_tpu.models",
                       "ffpa_attn_tpu.models.serving")


@pytest.fixture(scope="module")
def tiny(jm):
    jax, _, jmodels, _ = jm
    jcfg, tcfg = jmodels.ModelConfig(**SIZE), ModelConfig(**SIZE)
    params = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    group = tcfg.n_heads // tcfg.n_kv_heads
    assert decode_plan(tcfg.head_dim, tcfg.head_dim, group).consumers == 2
    return jcfg, params, model


def test_wide_prefill_and_decode_logits_match_jax(jm, tiny):
    """``prefill`` on a 100-token prompt, then teacher-forced
    ``decode_step``s (the same token on both sides each step)."""
    _, jnp, jmodels, _ = jm
    jcfg, params, model = tiny
    prompt = np.random.default_rng(1).integers(0, SIZE["vocab_size"], (1, PROMPT))
    max_len = PROMPT + STEPS
    jl, jcache = jmodels.prefill(params, jnp.asarray(prompt, jnp.int32), jcfg,
                                 jmodels.init_kv_cache(jcfg, 1, max_len))
    tl, tcache = prefill(model, torch.from_numpy(prompt), init_kv_cache(model.cfg, 1, max_len,
                                                                        device="cpu"))
    assert rel_err(tl, jl) < BF16_TOL, "prefill logits"
    tokens = np.random.default_rng(2).integers(0, SIZE["vocab_size"], (3,))
    for i, tok in enumerate(tokens):
        pos = PROMPT + i
        jl, jcache = jmodels.decode_step(params, jcache, jnp.int32(pos),
                                         jnp.asarray([tok], jnp.int32), jcfg)
        tl, tcache = decode_step(model, tcache, pos, torch.tensor([int(tok)]))
        assert rel_err(tl, jl) < BF16_TOL, f"decode step {i}"


def test_wide_greedy_generate_tokens_equal_jax(jm, tiny):
    _, jnp, jmodels, _ = jm
    jcfg, params, model = tiny
    prompt = np.random.default_rng(3).integers(0, SIZE["vocab_size"], (1, PROMPT))
    want = np.asarray(jmodels.generate(params, jnp.asarray(prompt, jnp.int32), STEPS, jcfg))
    d0 = tdec._decode_forward.launches
    got = generate(model, torch.from_numpy(prompt), STEPS)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tdec._decode_forward.launches == d0  # CPU tensors: the plain version


def _serving_inputs(jm):
    jnp, jserv = jm[1], jm[3]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, SIZE["vocab_size"], (n,)).astype(np.int32) for n in LENS]
    jp, jcu = jserv.pack_prompts([jnp.asarray(p) for p in prompts], sum(LENS))
    tp, tcu = pack_prompts([torch.from_numpy(p) for p in prompts], sum(LENS))
    return prompts, (jp, jcu), (tp, tcu)


def test_wide_batched_decode_step_matches_jax(jm, tiny):
    """A teacher-forced shared-row decode step after the packed prefill, at
    shared step t = 2 (rows base and base + 1 hold zeros on both sides)."""
    jnp, jmodels, jserv = jm[1], jm[2], jm[3]
    jcfg, params, model = tiny
    _, (jp, jcu), (tp, tcu) = _serving_inputs(jm)
    base, max_len = max(LENS), 128
    _, jc = jserv.prefill_packed(params, jp, jcu, base, jcfg,
                                 jmodels.init_kv_cache(jcfg, len(LENS), max_len))
    _, tc = prefill_packed(model, tp, tcu, base,
                           init_kv_cache(model.cfg, len(LENS), max_len, device="cpu"))
    lens, t = np.asarray(LENS, np.int32), 2
    tok = np.random.default_rng(5).integers(0, SIZE["vocab_size"], (len(LENS),))
    jl, _ = jserv._batched_decode_step(params, list(jc), jnp.asarray(lens), jnp.int32(t),
                                       jnp.asarray(tok, jnp.int32), jcfg, base)
    tl, _ = tserving._batched_decode_step(model, tc, torch.from_numpy(lens), t,
                                          torch.from_numpy(tok), base)
    assert rel_err(tl, jl) < BF16_TOL


def test_wide_serve_batch_tokens_equal_jax(jm, tiny):
    jcfg, params, model = tiny
    jnp, jserv = jm[1], jm[3]
    prompts, _, _ = _serving_inputs(jm)
    max_len = max(LENS) + STEPS
    want = np.asarray(jserv.serve_batch(params, [jnp.asarray(p) for p in prompts], STEPS, jcfg,
                                        max_len))
    d0 = tdec._decode_forward.launches
    got = serve_batch(model, [torch.from_numpy(p) for p in prompts], STEPS, max_len)
    assert tuple(got.shape) == (len(LENS), STEPS)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tdec._decode_forward.launches == d0
