"""The port's ``_decode_forward`` against the JAX package's.

On the CPU the port runs the kernel's plain version on PackGQA rows; JAX
runs its Pallas decode kernel in interpret mode. Inputs are rounded to bf16
once, from the same numpy arrays.

Tolerances: bf16 outputs 2e-2 relative to max|o| (the JAX suite's forward
tolerance, tests/test_features.py:127); LSE is fp32 math on identical inputs
on both sides, 1e-4 relative to max|lse|; the split-KV merge identity is
fp32 algebra, 1e-5. On the card, kernel vs plain holds the same output
tolerances (fp16 1e-2) to each row's max|o| (``row_rel_err``).
"""

import math

import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401
    cuda, jax_modules, randn, rel_err, row_rel_err, to_jax, to_torch,
)
from ffpa_attn_tpu_torch.ops import decode as tdec
from ffpa_attn_tpu_torch.ops.reference import DEFAULT_MASK_VALUE

BF16_TOL = 2e-2
LSE_TOL = 1e-4
MERGE_TOL = 1e-5

HKV, NKV, D = 2, 200, 512

CASES = {
    **{
        f"nq{nq}_g{g}": dict(nq=nq, group=g, valid_len=150)
        for nq in (1, 4) for g in (1, 2, 4)
    },
    "softcap": dict(nq=1, group=2, valid_len=170, softcap=3.0),
    "window": dict(nq=1, group=2, window=(60, -1), is_causal=True),
    "window_nq4": dict(nq=4, group=4, window=(90, 0)),
    "causal_nq4": dict(nq=4, group=2, is_causal=True),
    "head_bias": dict(nq=2, group=2, head_bias=True),
    "batch2_head_bias": dict(b=2, nq=1, group=2, head_bias=True, softcap=3.0),
}


def _inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    b, nq, hq = case.get("b", 1), case["nq"], HKV * case["group"]
    x = dict(
        q=randn(rng, (b, hq, nq, D)), k=randn(rng, (b, HKV, NKV, D)),
        v=randn(rng, (b, HKV, NKV, D)), bias=None,
    )
    if "valid_len" in case:  # the serving validity bias [1, 1, 1, Nkv]
        cols = np.arange(NKV)
        x["bias"] = np.where(cols < case["valid_len"], 0.0, DEFAULT_MASK_VALUE).astype(
            np.float32)[None, None, None, :]
    if case.get("head_bias"):
        x["bias"] = randn(rng, (b, hq, nq, NKV))
    return x


def _kwargs(case):
    return dict(
        scale=1.0 / math.sqrt(D),
        is_causal=case.get("is_causal", False),
        softcap=case.get("softcap", 0.0),
        window=case.get("window", (-1, -1)),
    )


def _torch_dec(x, case, dtype="bfloat16", device="cpu"):
    return tdec._decode_forward(
        to_torch(x["q"], dtype, device), to_torch(x["k"], dtype, device),
        to_torch(x["v"], dtype, device), to_torch(x["bias"], device=device),
        **_kwargs(case),
    )


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_matches_jax(name):
    (jdec,) = jax_modules("ffpa_attn_tpu.ops.decode")
    case = CASES[name]
    x = _inputs(case)
    jo, jl = jdec._decode_forward(
        to_jax(x["q"], "bfloat16"), to_jax(x["k"], "bfloat16"),
        to_jax(x["v"], "bfloat16"), to_jax(x["bias"]), **_kwargs(case),
    )
    to, tl = _torch_dec(x, case)
    assert tuple(to.shape) == tuple(jo.shape) and to.dtype == torch.bfloat16
    assert rel_err(to, jo) < BF16_TOL, name
    assert rel_err(tl, jl) < LSE_TOL, name


def test_key_broadcast_bias_follows_the_oracle():
    """A bias with a key dim of 1 applies to every key. The JAX decode
    kernel zero-pads that dim (ffpa_attn_tpu/ops/decode.py:258) and applies
    it to key 0 only (ROADMAP.md, queue 3), so the port is held to the fp32
    oracle here, not to the JAX kernel."""
    (jref,) = jax_modules("ffpa_attn_tpu.ops.reference")
    case = dict(nq=1, group=2)
    x = _inputs(case, seed=8)
    bias = np.full((1, 1, 1, 1), -3.0, np.float32)
    hq = x["q"].shape[1]
    want = jref.reference_attention(
        to_jax(x["q"], "bfloat16"), jref.expand_kv_heads(to_jax(x["k"], "bfloat16"), hq),
        jref.expand_kv_heads(to_jax(x["v"], "bfloat16"), hq), to_jax(bias),
        scale=1.0 / math.sqrt(D),
    )
    got, _ = tdec._decode_forward(
        to_torch(x["q"], "bfloat16"), to_torch(x["k"], "bfloat16"),
        to_torch(x["v"], "bfloat16"), to_torch(bias), scale=1.0 / math.sqrt(D),
        is_causal=False,
    )
    assert rel_err(got, want) < BF16_TOL


def test_split_kv_merge_identity():
    """The kernel's split-KV plan and LSE merge, in plain fp32: partials
    over the splits ``_tma_splits`` / ``decode_split_ranges`` / ``_kv_band``
    choose (both instances' rules), merged by LSE, equal one pass over the
    whole band."""
    case = dict(nq=1, group=2, window=(130, -1), is_causal=True)
    x = _inputs(case, seed=4)
    nq, g = case["nq"], case["group"]
    qp = to_torch(x["q"]).reshape(1, HKV, g * nq, D)
    k, v = to_torch(x["k"]), to_torch(x["v"])
    kw = dict(nq=nq, scale=1.0 / math.sqrt(D), is_causal=True, softcap=0.0,
              window_left=130, window_right=-1)
    start, end = tdec._kv_band(nq, NKV, True, 130, -1)
    assert start == 64 and end == NKV  # the band [69, 200) starts in tile 1
    tiles = -(-(end - start) // tdec.KV_TILE)
    whole_o, whole_l = tdec._decode_plain(qp, k, v, None, **kw)
    for blocks_per_sm in (2, 1):  # D, Dv <= 512 and above
        splits = tdec._tma_splits(HKV, tiles, 132, blocks_per_sm)
        parts = []
        for lo, hi in tdec.decode_split_ranges(start, end, splits):
            # A split sees only its own columns; the band mask is taken on
            # the full row positions, so slice after masking via a bias.
            bias = torch.full((NKV,), float("-inf"))
            bias[lo:hi] = 0.0
            parts.append(tdec._decode_plain(qp, k, v, bias, **kw))
        lses = torch.stack([p[1] for p in parts])
        lse = torch.logsumexp(lses, dim=0)
        o = sum(torch.exp(l - lse)[..., None] * p[0].float() for p, l in zip(parts, lses))
        assert splits > 1
        assert rel_err(lse, whole_l) < MERGE_TOL
        assert rel_err(o, whole_o.float()) < BF16_TOL  # partials are rounded to the dtype


SCORES = sorted(n for n in CASES if "window" not in CASES[n])


@pytest.mark.parametrize("name", SCORES)
def test_decode_return_scores_matches_jax(name):
    """The fp32 score residual of the packed rows against the JAX kernel's
    on the attended columns (both hold the mask value elsewhere), and
    (o, lse) unchanged by it."""
    (jdec,) = jax_modules("ffpa_attn_tpu.ops.decode")
    case = CASES[name]
    x = _inputs(case)
    _, _, js = jdec._decode_forward(
        to_jax(x["q"], "bfloat16"), to_jax(x["k"], "bfloat16"),
        to_jax(x["v"], "bfloat16"), to_jax(x["bias"]), return_scores=True, **_kwargs(case),
    )
    to, tl, ts = tdec._decode_forward(
        to_torch(x["q"], "bfloat16"), to_torch(x["k"], "bfloat16"), to_torch(x["v"], "bfloat16"),
        to_torch(x["bias"]), return_scores=True, **_kwargs(case))
    o0, l0 = _torch_dec(x, case)
    assert torch.equal(to, o0) and torch.equal(tl, l0)
    rows = x["q"].shape[1] // HKV * case["nq"]
    assert ts.dtype == torch.float32 and tuple(ts.shape) == (x["q"].shape[0], HKV, rows, 256)
    want = np.asarray(js, np.float32)[:, :, :rows, :NKV]
    got = ts[..., :NKV].numpy()
    live = want > DEFAULT_MASK_VALUE / 2
    assert np.array_equal(live, got > DEFAULT_MASK_VALUE / 2)
    assert rel_err(np.where(live, got, 0.0), np.where(live, want, 0.0)) < BF16_TOL
    assert (ts[..., NKV:] == DEFAULT_MASK_VALUE).all()


GRAD_CASES = {
    "nq1_g2_valid": dict(nq=1, group=2, valid_len=150),
    "nq4_g4_causal": dict(nq=4, group=4, is_causal=True),
    "softcap": dict(nq=1, group=2, softcap=3.0),
    "softcap_bias_recompute": dict(nq=1, group=2, valid_len=170, softcap=3.0),
    "window_recompute": dict(nq=2, group=2, window=(60, -1), is_causal=True),
    "head_bias_sinks": dict(nq=2, group=2, head_bias=True, sinks=True),
}


def _decode_grads(case, x, side, device="cpu"):
    """Gradients of q, k, v (and sinks) through ``ffpa_attn_func`` on a
    GQA decode shape, for the port (``side="torch"``) or the JAX package."""
    kw = dict(is_causal=case.get("is_causal", False), softcap=case.get("softcap", 0.0),
              window_size=case.get("window", (-1, -1)), enable_gqa=True)
    names = ["q", "k", "v"] + (["sinks"] if "sinks" in x else [])
    if side == "jax":
        jax, jnp, jiface = jax_modules("jax", "jax.numpy", "ffpa_attn_tpu")

        def f(*args):
            a = dict(zip(names, args))
            return jiface.ffpa_attn_func(a["q"], a["k"], a["v"], attn_mask=to_jax(x["bias"]),
                                         sinks=a.get("sinks"), **kw)

        args = [jnp.asarray(x[n], jnp.bfloat16 if n in "qkv" else jnp.float32) for n in names]
        out, vjp = jax.vjp(f, *args)
        return dict(zip(names, (np.asarray(g, np.float32) for g in
                                vjp(jnp.asarray(x["do"], out.dtype)))))
    from ffpa_attn_tpu_torch import ffpa_attn_func

    t = {n: to_torch(x[n], "bfloat16" if n in "qkv" else "float32", device).requires_grad_()
         for n in names}
    out = ffpa_attn_func(t["q"], t["k"], t["v"], attn_mask=to_torch(x["bias"], device=device),
                         sinks=t.get("sinks"), **kw)
    return dict(zip(names, torch.autograd.grad(out, [t[n] for n in names],
                                               to_torch(x["do"], "bfloat16", device))))


def _grad_inputs(case, seed=5):
    x = _inputs(case, seed)
    rng = np.random.default_rng(seed + 100)
    x["do"] = randn(rng, x["q"].shape)
    if case.get("sinks"):
        x["sinks"] = randn(rng, (x["q"].shape[1],))
    return x


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_decode_grads_match_jax(name, monkeypatch):
    """``torch.autograd.grad`` through the decode route (the grouped fp32
    composite backward, from the score residual where the forward keeps it,
    from recomputed scores under a window or softcap with a bias) against
    ``jax.grad``: bf16 5e-2 of each gradient's max (tests/test_ffpa_bwd.py:19)."""
    case = GRAD_CASES[name]
    x = _grad_inputs(case)
    kept = []
    real = tdec._decode_emits_scores

    def spy(*args):
        kept.append(real(*args))
        return kept[-1]

    monkeypatch.setattr(tdec, "_decode_emits_scores", spy)
    got = _decode_grads(case, x, "torch")
    assert kept == ["recompute" not in name]
    want = _decode_grads(case, x, "jax")
    for n in want:
        assert rel_err(got[n], want[n]) < 5e-2, n


def test_decode_backward_tiled_fallback_matches_jax(monkeypatch):
    """Above ``_DECODE_BWD_COMPOSITE_MAX_ELEMS`` score elements the decode
    backward takes the tiled flash backward (here forced with a limit of
    0); its gradients still match the JAX package's composite."""
    case = GRAD_CASES["nq1_g2_valid"]
    x = _grad_inputs(case)
    monkeypatch.setattr(tdec, "_DECODE_BWD_COMPOSITE_MAX_ELEMS", 0)
    got = _decode_grads(case, x, "torch")
    want = _decode_grads(case, x, "jax")
    for n in want:
        assert rel_err(got[n], want[n]) < 5e-2, n


def test_decode_backward_from_scores_equals_recompute():
    """The composite backward reads P from the score residual or recomputes
    it from (q, k, lse): the two agree to fp32 rounding."""
    case = dict(nq=2, group=2, valid_len=150, is_causal=True)
    x = _grad_inputs(case, seed=9)
    q, k, v = (to_torch(x[n], "bfloat16") for n in ("q", "k", "v"))
    bias, do = to_torch(x["bias"]), to_torch(x["do"], "bfloat16")
    kw = dict(scale=1.0 / math.sqrt(D), is_causal=True)
    o, lse, s = tdec._decode_forward(q, k, v, bias, return_scores=True, **kw)
    args = (kw["scale"], True, 0.0, (-1, -1), q, k, v, bias, None, o, lse)
    from_s = tdec._decode_core_bwd(*args, s, do, False)
    recompute = tdec._decode_core_bwd(*args, None, do, False)
    for a, b in zip(from_s[:3], recompute[:3]):
        assert rel_err(a, b) < 1e-2


def test_decode_scores_budget_gate(monkeypatch):
    """The residual is kept under the budget divided by the assumed live
    layers, never with softcap plus a bias or with a window."""
    x = _inputs(CASES["nq1_g2"])
    q, k = to_torch(x["q"], "bfloat16"), to_torch(x["k"], "bfloat16")
    assert tdec._decode_emits_scores(q, k, None, 0.0, (-1, -1))
    assert not tdec._decode_emits_scores(q, k, torch.zeros(1, 1, 1, NKV), 3.0, (-1, -1))
    assert not tdec._decode_emits_scores(q, k, None, 0.0, (60, -1))
    nbytes = 1 * HKV * 2 * 1 * 256 * 4
    monkeypatch.setenv("FFPA_TORCH_SCORES_AUTO_ASSUMED_LAYERS",
                       str(tdec._DECODE_SCORES_MAX_BYTES // nbytes + 1))
    assert not tdec._decode_emits_scores(q, k, None, 0.0, (-1, -1))


@pytest.mark.parametrize("name", SCORES)
def test_decode_scores_on_card_match_plain(cuda, name):
    case = CASES[name]
    x = _inputs(case, seed=7)
    args = [to_torch(x[n], "bfloat16", cuda) for n in ("q", "k", "v")]
    ko, kl, ks = tdec._decode_forward(*args, to_torch(x["bias"], device=cuda),
                                      return_scores=True, **_kwargs(case))
    torch.cuda.synchronize()
    po, pl, ps = tdec._decode_forward(*(a.cpu() for a in args), to_torch(x["bias"]),
                                      return_scores=True, **_kwargs(case))
    live = ps > DEFAULT_MASK_VALUE / 2
    assert torch.equal(live, ks.cpu() > DEFAULT_MASK_VALUE / 2)
    assert rel_err(torch.where(live, ks.cpu(), 0.0), torch.where(live, ps, 0.0)) < 1e-3
    assert row_rel_err(ko, po) < BF16_TOL


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_decode_grads_on_card_match_cpu(cuda, name):
    case = GRAD_CASES[name]
    x = _grad_inputs(case)
    got = _decode_grads(case, x, "torch", cuda)
    want = _decode_grads(case, x, "torch")
    for n in want:
        assert rel_err(got[n], want[n]) < 5e-2, n


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dtype,tol", [("bfloat16", BF16_TOL), ("float16", 1e-2)])
def test_kernel_matches_plain_on_card(cuda, name, dtype, tol):
    case = CASES[name]
    x = _inputs(case, seed=6)
    before = tdec._decode_forward.launches
    ko, kl = _torch_dec(x, case, dtype, cuda)
    torch.cuda.synchronize()
    assert tdec._decode_forward.launches == before + 1
    po, pl = _torch_dec(x, case, dtype, "cpu")
    assert row_rel_err(ko, po) < tol, name
    assert rel_err(kl, pl) < LSE_TOL, name
