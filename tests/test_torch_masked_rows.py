"""A row masked everywhere under a sliding window: the plain versions of the
port's dense forward and decode against the JAX package.

A bias of MASK_VALUE over every column of one row makes every score of that
row MASK_VALUE, inside the window as outside it, so the softmax is uniform
over the columns a pass visits. The plain versions (one pass over every
column, as the JAX package's oracle) give that row the mean of V over all
columns and lse = MASK_VALUE + log(Nkv); the JAX package's kernels give
the same at these shapes, whose Nkv is a multiple of their KV tile (at a
ragged Nkv the JAX decode kernel also counts its padding columns, V = 0,
in such a row's mean: 200 / 256 of it at Nkv 200). The port's kernels walk
only the window's tiles and so give the mean over those (``chip_smoke.py``
``_fwd_case`` / ``_decode_case`` with ``masked_row``; ``ROADMAP.md``,
deliberate numerics differences).

Tolerances: bf16 outputs 2e-2 relative to max|o| (tests/test_features.py:127),
the masked row 2e-2 of its own max, lse 1e-4 relative.
"""

import math

import numpy as np
import pytest
import torch

from _torch_parity import jax_modules, np32, randn, rel_err, to_jax, to_torch
from ffpa_attn_tpu_torch.ops import decode as tdec
from ffpa_attn_tpu_torch.ops import flash_fwd as tfwd
from ffpa_attn_tpu_torch.ops.reference import DEFAULT_MASK_VALUE

BF16_TOL = 2e-2
LSE_TOL = 1e-4


def _row_checks(o, lse, jo, jl, v, row):
    """o / lse [..., Nq, Dv] / [..., Nq] of the port against the JAX
    package's, and the masked ``row`` against the mean of V over every
    column (v [B, Hkv, Nkv, Dv] in the input type)."""
    o, jo, lse, jl = np32(o), np32(jo), np32(lse), np32(jl)
    assert rel_err(o, jo) < BF16_TOL and rel_err(lse, jl) < LSE_TOL
    mean = np32(v.float().mean(dim=2))  # [B, Hkv, Dv]
    got, want = o[..., row, :], jo[..., row, :]
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < BF16_TOL * scale
    group = o.shape[1] // mean.shape[1]
    assert np.abs(got - np.repeat(mean, group, axis=1)).max() < BF16_TOL * scale
    empty = DEFAULT_MASK_VALUE + math.log(v.shape[2])
    np.testing.assert_allclose(lse[..., row], empty, rtol=1e-6)


@pytest.mark.parametrize("window,causal", [((64, -1), True), ((40, 24), False)])
def test_forward_masked_row_under_window_matches_jax(window, causal):
    (jfwd,) = jax_modules("ffpa_attn_tpu.ops.flash_fwd")
    rng = np.random.default_rng(3)
    nq, nkv, d, row = 256, 384, 128, 200
    q, k, v = randn(rng, (1, 2, nq, d)), randn(rng, (1, 1, nkv, d)), randn(rng, (1, 1, nkv, d))
    bias = randn(rng, (1, 1, nq, nkv))
    bias[..., row, :] = DEFAULT_MASK_VALUE
    kw = dict(scale=1.0 / math.sqrt(d), is_causal=causal, window=window)
    jo, jl = jfwd.flash_attention_forward(*(to_jax(t, "bfloat16") for t in (q, k, v)),
                                          to_jax(bias), **kw)
    tv = to_torch(v, "bfloat16")
    o, lse = tfwd.flash_attention_forward(to_torch(q, "bfloat16"), to_torch(k, "bfloat16"), tv,
                                          to_torch(bias), **kw)
    _row_checks(o, lse, jo, jl, tv, row)


def test_decode_masked_row_under_window_matches_jax():
    (jdec,) = jax_modules("ffpa_attn_tpu.ops.decode")
    rng = np.random.default_rng(4)
    b, hkv, group, nkv, d = 2, 2, 2, 256, 128
    q = randn(rng, (b, hkv * group, 1, d))
    k, v = randn(rng, (b, hkv, nkv, d)), randn(rng, (b, hkv, nkv, d))
    bias = np.zeros((b, 1, 1, nkv), np.float32)
    bias[1] = DEFAULT_MASK_VALUE  # every column of batch 1's row
    kw = dict(scale=1.0 / math.sqrt(d), is_causal=True, softcap=0.0, window=(60, -1))
    jo, jl = jdec._decode_forward(*(to_jax(t, "bfloat16") for t in (q, k, v)), to_jax(bias),
                                  **kw)
    tv = to_torch(v, "bfloat16")
    o, lse = tdec._decode_forward(to_torch(q, "bfloat16"), to_torch(k, "bfloat16"), tv,
                                  to_torch(bias), **kw)
    assert tuple(o.shape) == tuple(jo.shape)
    _row_checks(o[1:], lse[1:], np32(jo)[1:], np32(jl)[1:], tv[1:], 0)
    assert rel_err(o[:1], np32(jo)[:1]) < BF16_TOL
