"""The port's fp32 oracle and dropout hash against the JAX package's.

Tolerances: the oracle runs in fp32 on both sides from identical inputs, so
outputs and LSE agree to summation-order rounding: 1e-5 relative to the
largest value. Dropout keep masks are integer hashes and must be equal bit
for bit.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # JAX is the reference; absent beside the card

from _torch_parity import np32, randn, rel_err, to_jax, to_torch
from ffpa_attn_tpu.functional import normalize_attn_mask as jax_normalize_mask
from ffpa_attn_tpu.ops import reference as jref
from ffpa_attn_tpu.ops import rng as jrng
from ffpa_attn_tpu_torch.functional import normalize_attn_mask as torch_normalize_mask
from ffpa_attn_tpu_torch.ops import reference as tref
from ffpa_attn_tpu_torch.ops import rng as trng

ORACLE_TOL = 1e-5  # fp32 on both sides; only summation order differs

CASES = {
    "plain": dict(),
    "causal": dict(is_causal=True),
    "causal_nonaligned": dict(is_causal=True, nq=40, nkv=96),
    "cross_nonaligned": dict(nq=72, nkv=40),
    "gqa": dict(hq=4, hkv=1, is_causal=True),
    "bias_float": dict(bias="float"),
    "bias_bool": dict(bias="bool", is_causal=True),
    "softcap": dict(softcap=5.0),
    "window": dict(window=(16, 8)),
    "window_causal": dict(window=(12, -1), is_causal=True, nq=48, nkv=80),
    "alibi": dict(alibi=True, nq=48, nkv=80),
    "alibi_batched": dict(alibi="batched"),
    "sinks": dict(sinks=True, is_causal=True),
    "dropout": dict(dropout_p=0.2, dropout_seed=7),
    "everything": dict(is_causal=True, hq=4, hkv=2, bias="float", softcap=3.0,
                       window=(20, -1), alibi=True, sinks=True, nq=48, nkv=80),
}


def _inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    b, hq, hkv = 2, case.get("hq", 2), case.get("hkv", 2)
    nq, nkv, d = case.get("nq", 64), case.get("nkv", 64), 32
    x = dict(
        q=randn(rng, (b, hq, nq, d)),
        k=randn(rng, (b, hkv, nkv, d)),
        v=randn(rng, (b, hkv, nkv, d)),
        bias=None, alibi=None, sinks=None,
    )
    if case.get("bias") == "float":
        x["bias"] = randn(rng, (1, hq, nq, nkv))
    elif case.get("bias") == "bool":
        x["bias"] = rng.random((b, 1, nq, nkv)) > 0.3
    if case.get("alibi") == "batched":
        x["alibi"] = rng.uniform(0.01, 0.5, (b, hq)).astype(np.float32)
    elif case.get("alibi"):
        x["alibi"] = rng.uniform(0.01, 0.5, (hq,)).astype(np.float32)
    if case.get("sinks"):
        x["sinks"] = randn(rng, (hq,))
    return x


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_attention_matches_jax(name):
    case = CASES[name]
    x = _inputs(case)
    hq = x["q"].shape[1]
    b, _, nq, _ = x["q"].shape
    nkv = x["k"].shape[2]
    kw = dict(
        is_causal=case.get("is_causal", False),
        dropout_p=case.get("dropout_p", 0.0),
        dropout_seed=case.get("dropout_seed", 0),
        softcap=case.get("softcap", 0.0),
        window=case.get("window", (-1, -1)),
        return_lse=True,
    )
    if x["bias"] is not None and x["bias"].dtype == np.bool_:
        jb = jax_normalize_mask(to_jax(x["bias"], "float32").astype(bool), b, hq, nq, nkv)
        tb = torch_normalize_mask(torch.from_numpy(x["bias"]), b, hq, nq, nkv)
        assert np.array_equal(np32(jb), np32(tb))
    else:
        jb, tb = to_jax(x["bias"]), to_torch(x["bias"])
    jo, jl = jref.reference_attention(
        to_jax(x["q"]),
        jref.expand_kv_heads(to_jax(x["k"]), hq),
        jref.expand_kv_heads(to_jax(x["v"]), hq),
        jb, alibi_slopes=to_jax(x["alibi"]), sinks=to_jax(x["sinks"]), **kw,
    )
    to, tl = tref.reference_attention(
        to_torch(x["q"]),
        tref.expand_kv_heads(to_torch(x["k"]), hq),
        tref.expand_kv_heads(to_torch(x["v"]), hq),
        tb, alibi_slopes=to_torch(x["alibi"]), sinks=to_torch(x["sinks"]), **kw,
    )
    assert rel_err(to, jo) < ORACLE_TOL, name
    assert rel_err(tl, jl) < ORACLE_TOL, name


def test_head_helpers_match_jax():
    rng = np.random.default_rng(1)
    kv = randn(rng, (2, 2, 8, 4))
    assert np.array_equal(
        np32(tref.expand_kv_heads(to_torch(kv), 6)),
        np32(jref.expand_kv_heads(to_jax(kv), 6)),
    )
    g = randn(rng, (2, 6, 8, 4))
    assert rel_err(tref.reduce_q_heads(to_torch(g), 2), jref.reduce_q_heads(to_jax(g), 2)) < ORACLE_TOL
    for nq, nkv in ((5, 9), (9, 9), (1, 7)):
        assert np.array_equal(
            tref.tail_aligned_causal_mask(nq, nkv).numpy(),
            np.asarray(jref.tail_aligned_causal_mask(nq, nkv)),
        )


@pytest.mark.parametrize(
    "seed,b,h,row_off,col_off",
    [(0, 0, 0, 0, 0), (7, 1, 3, 0, 0), (2**31 - 1, 5, 2, 100_000, 70_000),
     (-3, 2, 1, 123, 4_000_000)],
)
def test_dropout_keep_mask_bit_identical(seed, b, h, row_off, col_off):
    nq, nkv, p = 64, 96, 0.3
    jrows, jcols = jrng.make_row_col_ids(nq, nkv, row_off, col_off)
    trows, tcols = trng.make_row_col_ids(nq, nkv, row_off, col_off)
    ju = np.asarray(jrng.uniform_for_scores(seed, b, h, jrows, jcols))
    tu = trng.uniform_for_scores(seed, b, h, trows, tcols).numpy()
    assert np.array_equal(ju.view(np.uint32), tu.view(np.uint32))
    jm = np.asarray(jrng.dropout_keep_mask(seed, b, h, jrows, jcols, p))
    tm = trng.dropout_keep_mask(seed, b, h, trows, tcols, p).numpy()
    assert np.array_equal(jm, tm)
    assert 0.6 < tm.mean() < 0.8  # keeps about 1 - p
