"""The port's S-resident tier against the JAX package's.

The forward's S residual (``return_scores``), the from-S dK/dV launcher in
both ``dkdv_dk_in_kernel`` variants, banded dK and ``_dk_from_ds``, the
``scores=`` route of ``flash_attention_backward`` and the residency policy
``_resident_head_count``: the same numpy inputs go to both packages. JAX runs
its Pallas kernels in interpret mode, the port (on the CPU) their plain
versions. Each side computes its own S residual, padded to its own tiles;
only the band (rows < Nq, columns < Nkv, causal mask) is compared.

Tolerances: the forward and S 2e-2 relative to max|want| (the JAX suite's
forward tolerance, tests/test_features.py:127); gradients and dS bf16 5e-2
(tests/test_ffpa_bwd.py:19). On the card each kernel is held to its plain
version per row (``grad_row_rel_err``) at the same tolerances.
"""

import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401
    cuda, grad_row_rel_err, jax_modules, randn, rel_err, to_jax, to_torch,
)
from ffpa_attn_tpu_torch.ops import flash_bwd as tbwd
from ffpa_attn_tpu_torch.ops import flash_fwd as tfwd
from ffpa_attn_tpu_torch.ops.config import from_s_fits
from ffpa_attn_tpu_torch.ops.dispatch import pick_backward_config

FWD_TOL, GRAD_TOL = 2e-2, 5e-2

CASES = {
    "causal_gqa": dict(hq=4, hkv=2, nq=130, nkv=150, causal=True),
    "noncausal": dict(nq=100, nkv=160),
    "bias_full": dict(nq=120, nkv=150, bias="full"),
    "bias_key_causal": dict(nq=130, nkv=150, causal=True, bias="key"),
    "softcap": dict(nq=130, nkv=150, causal=True, softcap=5.0),
    "dropout": dict(nq=130, nkv=150, causal=True, dropout=0.2),
    "alibi": dict(nq=128, nkv=128, causal=True, alibi=True),
    "short_nq": dict(nq=20, nkv=140, causal=True),
    # Dv above 512: from-S with dK out of the kernel (dK in does not fit,
    # so the dK-in variant falls back to it), the cluster route on a card.
    "d640_causal_gqa": dict(hq=4, hkv=2, nq=130, nkv=150, causal=True, d=640),
    "d1024_dropout": dict(nq=130, nkv=150, causal=True, dropout=0.2, d=1024),
    "d512_dv1024_softcap": dict(nq=130, nkv=150, causal=True, softcap=5.0, d=512, dv=1024),
}


def _inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    b, hq, hkv = case.get("b", 1), case.get("hq", 2), case.get("hkv", 1)
    nq, nkv, d = case["nq"], case["nkv"], case.get("d", 320)
    dv = case.get("dv", d)
    x = dict(q=randn(rng, (b, hq, nq, d)), k=randn(rng, (b, hkv, nkv, d)),
             v=randn(rng, (b, hkv, nkv, dv)), do=randn(rng, (b, hq, nq, dv)), bias=None,
             alibi=None)
    if case.get("bias") == "full":
        x["bias"] = randn(rng, (b, 1, nq, nkv))
    elif case.get("bias") == "key":
        x["bias"] = randn(rng, (1, 1, 1, nkv))
    if case.get("alibi"):
        x["alibi"] = rng.uniform(0.01, 0.3, (b, hq)).astype(np.float32)
    return x


def _fwd_kw(case, x):
    return dict(scale=1.0 / math.sqrt(x["q"].shape[-1]), is_causal=case.get("causal", False),
                dropout_p=case.get("dropout", 0.0), dropout_seed=3,
                softcap=case.get("softcap", 0.0))


def _band(case, x):
    nq, nkv = x["q"].shape[2], x["k"].shape[2]
    rows, cols = np.arange(nq)[:, None], np.arange(nkv)[None, :]
    if case.get("causal"):
        return cols <= rows + nkv - nq
    return np.ones((nq, nkv), bool)


def _banded(a, band):
    """The band of a padded [B, H, nq_pad, nkv_pad] slab as fp32 numpy, zeros
    elsewhere."""
    nq, nkv = band.shape
    a = np.asarray(a[:, :, :nq, :nkv].float() if isinstance(a, torch.Tensor) else
                   np.asarray(a, np.float32)[:, :, :nq, :nkv], np.float32)
    return np.where(band, a, 0.0)


@functools.lru_cache(maxsize=None)
def _jax_side(name):
    """The JAX forward with its S residual, and its from-S backward pieces,
    as numpy."""
    import jax.numpy as jnp
    from ffpa_attn_tpu.ops import flash_bwd as jbwd
    from ffpa_attn_tpu.ops import flash_fwd as jfwd
    from ffpa_attn_tpu.ops.config import BlockConfig

    case = CASES[name]
    x = _inputs(case)
    kw = _fwd_kw(case, x)
    q, k, v, do = (to_jax(x[n], "bfloat16") for n in ("q", "k", "v", "do"))
    bias, alibi = to_jax(x["bias"]), to_jax(x["alibi"])
    o, lse, s = jfwd.flash_attention_forward(q, k, v, bias, return_scores=True,
                                             alibi_slopes=alibi, **kw)
    o0, lse0 = jfwd.flash_attention_forward(q, k, v, bias, alibi_slopes=alibi, **kw)
    delta = jnp.sum(do.astype(jnp.float32) * o.astype(jnp.float32), axis=-1)
    nq, nkv, d, d_v = x["q"].shape[2], x["k"].shape[2], x["q"].shape[-1], x["v"].shape[-1]
    group = x["q"].shape[1] // x["k"].shape[1]
    seed = jnp.asarray(3, jnp.int32).reshape(1, 1)
    out = dict(o=o, lse=lse, s=s, o0=o0, lse0=lse0, delta=delta)
    for dk_in in (True, False):
        cfg = dataclasses.replace(BlockConfig().clamp(nq, nkv), dkdv_dk_in_kernel=dk_in)
        cfg = jbwd._fit_blocks_to_scores(cfg, s.shape[2], s.shape[3], d, d_v, q.dtype)
        dk, dv, ds = jbwd._dkdv_from_s_launch(
            q, v, jnp.array(s), do, lse, delta, seed, cfg, scale=kw["scale"],
            is_causal=kw["is_causal"], causal_offset=nkv - nq, dropout_p=kw["dropout_p"],
            group=group, grad_kv_storage_dtype=None, interpret=True, softcap=kw["softcap"])
        tag = "in" if dk_in else "out"
        out[f"dv_{tag}"], out[f"ds_{tag}"] = dv, ds
        if dk is not None:
            out["dk_in"] = dk
        if not dk_in:
            bkw = dict(scale=kw["scale"], group=group, nq=nq, nkv=nkv,
                       dk_dtype=jnp.bfloat16)
            if kw["is_causal"]:
                out["banded_dk"] = jbwd._banded_dk_from_ds(ds, q, cfg, causal_offset=nkv - nq,
                                                           interpret=True, **bkw)
            else:
                out["dk_from_ds"] = jbwd._dk_from_ds(ds, q, **bkw)
    grads = jbwd.flash_attention_backward(q, k, v, bias, o, lse, do, scores=jnp.array(s),
                                          alibi_slopes=alibi, **kw)
    for n, g in zip(("dq", "dk", "dv", "dbias"), grads):
        if g is not None:
            out[f"bwd_{n}"] = g
    return x, {n: np.array(a, np.float32) for n, a in out.items()}


@pytest.fixture(scope="module")
def jax_ready():
    jax_modules("jax", "ffpa_attn_tpu.ops.flash_bwd")


def _port_forward(case, x, device="cpu"):
    kw = _fwd_kw(case, x)
    q, k, v = (to_torch(x[n], "bfloat16", device) for n in ("q", "k", "v"))
    extra = dict(alibi_slopes=to_torch(x["alibi"], device=device))
    bias = to_torch(x["bias"], device=device)
    o, lse, s = tfwd.flash_attention_forward(q, k, v, bias, return_scores=True, **kw, **extra)
    o0, lse0 = tfwd.flash_attention_forward(q, k, v, bias, **kw, **extra)
    return o, lse, s, o0, lse0


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_scores_match_jax(jax_ready, name):
    case = CASES[name]
    x, j = _jax_side(name)
    o, lse, s, o0, lse0 = _port_forward(case, x)
    assert torch.equal(o, o0) and torch.equal(lse, lse0)  # return_scores changes nothing
    band = _band(case, x)
    assert s.dtype == torch.bfloat16 and s.shape[2] % 32 == 0 and s.shape[3] % 64 == 0
    assert rel_err(_banded(s, band), _banded(j["s"], band)) < FWD_TOL
    assert rel_err(o, j["o"]) < FWD_TOL
    assert rel_err(lse, j["lse"]) < 1e-4
    # Outside the band the plain S holds the mask value, never +-inf.
    assert torch.isfinite(s.float()).all()


def test_forward_scores_refuse_a_window():
    x = _inputs(dict(nq=64, nkv=64))
    q, k, v = (to_torch(x[n], "bfloat16") for n in ("q", "k", "v"))
    with pytest.raises(ValueError, match="sliding windows"):
        tfwd.flash_attention_forward(q, k, v, None, scale=0.05, is_causal=True,
                                     window=(16, -1), return_scores=True)


def _from_s(case, x, dk_in, device="cpu"):
    """The from-S launcher on ``device`` over the port's own forward there,
    with the variant the backward takes for that S residual: dK stays in
    the kernel only where it fits (``_fit_blocks_to_scores``), as on the
    JAX side."""
    kw = _fwd_kw(case, x)
    nq, nkv, d, dv = x["q"].shape[2], x["k"].shape[2], x["q"].shape[-1], x["v"].shape[-1]
    q, v, do = (to_torch(x[n], "bfloat16", device) for n in ("q", "v", "do"))
    o, lse, s, _, _ = _port_forward(case, x, device)
    delta = (do.float() * o.float()).sum(-1)
    cfg = dataclasses.replace(pick_backward_config(d=d, dv=dv, nq=nq, nkv=nkv,
                                                   dtype=torch.bfloat16),
                              dkdv_dk_in_kernel=dk_in)
    cfg = tbwd._fit_blocks_to_scores(cfg, s.shape[2], s.shape[3], d, dv, torch.bfloat16)
    return tbwd._dkdv_from_s_launch(
        q, v, s, do, lse, delta, 3, cfg, scale=kw["scale"],
        is_causal=kw["is_causal"], causal_offset=nkv - nq, dropout_p=kw["dropout_p"],
        group=x["q"].shape[1] // x["k"].shape[1], grad_kv_storage_dtype=None,
        softcap=kw["softcap"])


@pytest.mark.parametrize("dk_in", [True, False])
@pytest.mark.parametrize("name", sorted(CASES))
def test_dkdv_from_s_matches_jax(jax_ready, name, dk_in):
    case = CASES[name]
    x, j = _jax_side(name)
    tag = "in" if dk_in else "out"
    dk, dv, ds = _from_s(case, x, dk_in)
    # The port keeps dK in the kernel only where it fits; JAX's keeps it.
    dk_kept = dk_in and from_s_fits(x["q"].shape[-1], x["v"].shape[-1], True)
    assert (dk is None) == (not dk_kept)
    assert rel_err(dv, j[f"dv_{tag}"]) < GRAD_TOL, "dv"
    if dk_kept:
        assert rel_err(dk, j["dk_in"]) < GRAD_TOL, "dk"
    band = _band(case, x)
    assert rel_err(_banded(ds, band), _banded(j[f"ds_{tag}"], band)) < GRAD_TOL, "ds"
    # Every tile of the slab is defined: zeros outside the band and on padding.
    nq, nkv = band.shape
    assert not ds[:, :, nq:].any() and not ds[:, :, :, nkv:].any()
    assert not ds[:, :, :nq, :nkv].float().numpy()[..., ~band].any()


@pytest.mark.parametrize("name", sorted(n for n in CASES if CASES[n].get("causal")))
def test_banded_dk_matches_jax(jax_ready, name):
    """Both sides read the JAX slab (cropped, re-padded to the port's
    padding), so only the product is compared."""
    case = CASES[name]
    x, j = _jax_side(name)
    nq, nkv = x["q"].shape[2], x["k"].shape[2]
    _, _, s, _, _ = _port_forward(case, x)
    slab = torch.zeros_like(s)
    slab[:, :, :nq, :nkv] = to_torch(j["ds_out"][:, :, :nq, :nkv], "bfloat16")
    dk = tbwd._banded_dk_from_ds(
        slab, to_torch(x["q"], "bfloat16"), None, scale=_fwd_kw(case, x)["scale"],
        group=x["q"].shape[1] // x["k"].shape[1], nq=nq, nkv=nkv, causal_offset=nkv - nq,
        dk_dtype=torch.bfloat16)
    assert dk.dtype == torch.bfloat16 and tuple(dk.shape) == x["k"].shape
    assert rel_err(dk, j["banded_dk"]) < GRAD_TOL


@pytest.mark.parametrize("name", sorted(n for n in CASES if not CASES[n].get("causal")))
def test_dk_from_ds_matches_jax(jax_ready, name):
    case = CASES[name]
    x, j = _jax_side(name)
    nq, nkv = x["q"].shape[2], x["k"].shape[2]
    dk = tbwd._dk_from_ds(to_torch(j["ds_out"], "bfloat16"), to_torch(x["q"], "bfloat16"),
                          scale=_fwd_kw(case, x)["scale"],
                          group=x["q"].shape[1] // x["k"].shape[1], nq=nq, nkv=nkv,
                          dk_dtype=torch.bfloat16)
    assert rel_err(dk, j["dk_from_ds"]) < GRAD_TOL


@pytest.mark.parametrize("name", sorted(CASES))
def test_scores_backward_matches_jax(jax_ready, name):
    """The ``scores=`` route: from-S dK/dV, dK and dQ from the slab, dbias
    from the slab."""
    case = CASES[name]
    x, j = _jax_side(name)
    kw = _fwd_kw(case, x)
    o, lse, s, _, _ = _port_forward(case, x)
    q, k, v, do = (to_torch(x[n], "bfloat16") for n in ("q", "k", "v", "do"))
    bias = to_torch(x["bias"])
    launches = (tbwd._dkdv_from_s_launch.launches, tbwd._banded_dk_from_ds.launches)
    got = tbwd.flash_attention_backward(q, k, v, bias, o, lse, do, scores=s,
                                        alibi_slopes=to_torch(x["alibi"]), **kw)
    assert (tbwd._dkdv_from_s_launch.launches, tbwd._banded_dk_from_ds.launches) == launches
    for n, g in zip(("dq", "dk", "dv", "dbias"), got):
        if f"bwd_{n}" not in j:
            assert g is None, n
            continue
        assert tuple(g.shape) == j[f"bwd_{n}"].shape, n
        assert rel_err(g, j[f"bwd_{n}"]) < GRAD_TOL, n


def test_scores_backward_refuses_a_window_and_softcap_with_bias():
    x = _inputs(dict(nq=64, nkv=64))
    q, k, v, do = (to_torch(x[n], "bfloat16") for n in ("q", "k", "v", "do"))
    o, lse, s = tfwd.flash_attention_forward(q, k, v, None, scale=0.05, is_causal=True,
                                             return_scores=True)
    with pytest.raises(ValueError, match="sliding windows"):
        tbwd.flash_attention_backward(q, k, v, None, o, lse, do, scale=0.05, is_causal=True,
                                      window=(16, -1), scores=s)
    with pytest.raises(ValueError, match="softcap"):
        tbwd.flash_attention_backward(q, k, v, torch.zeros(1, 1, 1, 64), o, lse, do, scale=0.05,
                                      is_causal=True, softcap=5.0, scores=s)


def test_fit_blocks_to_scores_takes_dk_out_past_one_pass():
    """dK stays in the from-S kernel only where one column pass holds it."""
    cfg = dataclasses.replace(pick_backward_config(d=512, dv=512, nq=256, nkv=256,
                                                   dtype=torch.bfloat16), dkdv_dk_in_kernel=True)
    assert tbwd._fit_blocks_to_scores(cfg, 256, 256, 512, 512, torch.bfloat16).dkdv_dk_in_kernel
    wide = tbwd._fit_blocks_to_scores(cfg, 256, 256, 1024, 1024, torch.bfloat16)
    assert not wide.dkdv_dk_in_kernel
    with pytest.raises(ValueError, match="multiple"):
        tbwd._fit_blocks_to_scores(cfg, 256, 200, 512, 512, torch.bfloat16)


def test_banded_dq_takes_a_slab_padded_to_32_rows():
    """An S residual of a short query is padded to 32 rows: banded dQ reads
    it with 32-row panels (the plain version on the CPU, the tile choice in
    the wrapper on the card)."""
    case = CASES["short_nq"]
    x = _inputs(case)
    o, lse, s, _, _ = _port_forward(case, x)
    assert s.shape[2] == 32
    kw = _fwd_kw(case, x)
    q, k, v, do = (to_torch(x[n], "bfloat16") for n in ("q", "k", "v", "do"))
    got = tbwd.flash_attention_backward(q, k, v, None, o, lse, do, scores=s, **kw)
    want = tbwd.flash_attention_backward(q, k, v, None, o, lse, do, ds_handoff=False, **kw)
    for n, g, w in zip(("dq", "dk", "dv"), got, want):
        assert rel_err(g, w) < 2e-2, n


# ---------------------------------------------------------------------------
# The residency policy
# ---------------------------------------------------------------------------

GIB = 1024**3


def _statics(**kw):
    from ffpa_attn_tpu.ops.attention import StaticArgs as JStatic
    from ffpa_attn_tpu_torch.ops.attention import StaticArgs as TStatic

    base = dict(scale=0.05, is_causal=kw.pop("is_causal", True), dropout_p=0.0, fwd_config=None)
    base.update(kw)
    jbase = dict(base, bwd_config=None, backward_is_sdpa=base.get("backward_is_sdpa", False),
                 grad_kv_storage_dtype=None, grad_q_storage_dtype=None)
    return JStatic(**jbase), TStatic(**base)


BUDGET = dict(HBM_BYTES=80 * 10**9, HBM_MODEL_MARGIN_BYTES=16 * GIB,
              SCORES_RESIDUAL_LIMIT_BYTES=8 * GIB, SCORES_AUTO_ASSUMED_LAYERS=2,
              DS_HANDOFF_LIMIT_BYTES=5 * GIB)
# This call's tensors by the policy's count, 2 * (5 q + 4 k) bytes, and one
# head's padded S residual, at GQA 8/4 N2048 D512 bf16.
RESIDENTS, PER_HEAD = 2 * (5 * 8 + 4 * 4) * 2048 * 512, 2048 * 2048 * 2


def _budget_env(monkeypatch, **vals):
    """The same budget for both packages: FFPA_TPU_* and FFPA_TORCH_*."""
    for name, val in dict(BUDGET, **vals).items():
        monkeypatch.setenv(f"FFPA_TPU_{name}", str(val))
        monkeypatch.setenv(f"FFPA_TORCH_{name}", str(val))


POLICY = {
    # name: (static kwargs, dtype, bias, env)
    "full": (dict(), "bfloat16", None, dict()),
    # 6 heads' budget: 1/4 is kept for the other heads' handoff slabs, so
    # 4.5 heads fit, rounded down to whole GQA groups: 4.
    "partial": (dict(), "bfloat16", None, dict(SCORES_RESIDUAL_LIMIT_BYTES=6 * PER_HEAD)),
    # 3 heads' headroom: 2.25 heads after the reserve, 2 in whole groups.
    "partial_by_headroom": (dict(), "bfloat16", None,
                            dict(HBM_BYTES=20 * GIB,
                                 HBM_MODEL_MARGIN_BYTES=20 * GIB - RESIDENTS - 3 * PER_HEAD,
                                 SCORES_AUTO_ASSUMED_LAYERS=1)),
    "partial_dropout_refused": (dict(dropout_p=0.1), "bfloat16", None,
                                dict(SCORES_RESIDUAL_LIMIT_BYTES=6 * PER_HEAD)),
    "full_dropout": (dict(dropout_p=0.1), "bfloat16", None, dict()),
    "fp16_auto_refused": (dict(), "float16", None, dict()),
    "fp16_explicit_refused": (dict(save_scores=True), "float16", None, dict()),
    "explicit_true_over_budget": (dict(save_scores=True), "bfloat16", None,
                                  dict(SCORES_RESIDUAL_LIMIT_BYTES=1)),
    "explicit_false": (dict(save_scores=False), "bfloat16", None, dict()),
    "limit_zero": (dict(), "bfloat16", None, dict(SCORES_RESIDUAL_LIMIT_BYTES=0)),
    "window": (dict(window=(256, -1)), "bfloat16", None, dict()),
    "softcap_bias": (dict(softcap=5.0), "bfloat16", "key", dict()),
    "sdpa": (dict(backward_is_sdpa=True), "bfloat16", None, dict()),
    # 7.5 heads' headroom over 2 assumed layers: 3.75 heads, 2.8 after the
    # reserve, 2 in whole groups.
    "two_layers_assumed": (dict(), "bfloat16", None,
                           dict(HBM_BYTES=17 * GIB + RESIDENTS + 15 * PER_HEAD // 2,
                                HBM_MODEL_MARGIN_BYTES=17 * GIB)),
}


@pytest.mark.parametrize("name", sorted(POLICY))
def test_resident_head_count_matches_jax(monkeypatch, name):
    """GQA 8/4, N2048 D512: both packages pick the same m at equal budget
    settings (the padded footprint is the unpadded one at N2048 on both)."""
    jax, jnp, jatt = jax_modules("jax", "jax.numpy", "ffpa_attn_tpu.ops.attention")
    from ffpa_attn_tpu_torch.ops import attention as tatt

    skw, dtype, bias, env = POLICY[name]
    _budget_env(monkeypatch, **env)
    jst, tst = _statics(**skw)
    shape_q, shape_kv = (1, 8, 2048, 512), (1, 4, 2048, 512)
    jq, jkv = jnp.zeros(shape_q, getattr(jnp, dtype)), jnp.zeros(shape_kv, getattr(jnp, dtype))
    tq = torch.empty(shape_q, dtype=getattr(torch, dtype), device="meta")
    tkv = torch.empty(shape_kv, dtype=getattr(torch, dtype), device="meta")
    jb = tb = None
    if bias == "key":
        jb, tb = jnp.zeros((1, 1, 1, 2048), jnp.float32), torch.zeros(1, 1, 1, 2048)
    want = jatt._resident_head_count(jst, jq, jkv, jkv, jb)
    got = tatt._resident_head_count(tst, tq, tkv, tkv, tb)
    assert got == want
    expect = {"full": 8, "partial": 4, "partial_by_headroom": 2, "full_dropout": 8,
              "explicit_true_over_budget": 8, "two_layers_assumed": 2}.get(name, 0)
    assert got == expect, (name, got)
    assert tatt._should_save_scores(tst, tq, tkv, tkv, tb) == (got == 8)


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_scores_on_card_match_plain(cuda, name):
    case = CASES[name]
    x = _inputs(case, seed=2)
    before = tfwd.flash_attention_forward.launches
    o, lse, s, o0, lse0 = _port_forward(case, x, cuda)
    torch.cuda.synchronize()
    assert tfwd.flash_attention_forward.launches == before + 2
    assert torch.equal(o, o0) and torch.equal(lse, lse0)
    _, _, ps, _, _ = _port_forward(case, x)
    assert tuple(s.shape) == tuple(ps.shape)
    band = _band(case, x)
    assert rel_err(_banded(s.cpu(), band), _banded(ps, band)) < 1e-2


@pytest.mark.parametrize("dk_in", [True, False])
@pytest.mark.parametrize("name", sorted(CASES))
def test_dkdv_from_s_kernel_on_card_matches_plain(cuda, name, dk_in):
    """The kernel reads the forward kernel's slab; its garbage outside the
    band (tiles the forward never writes) must not reach any output."""
    case = CASES[name]
    x = _inputs(case, seed=2)
    before = tbwd._dkdv_from_s_launch.launches
    kdk, kdv, kds = _from_s(case, x, dk_in, cuda)
    torch.cuda.synchronize()
    assert tbwd._dkdv_from_s_launch.launches == before + 1
    pdk, pdv, pds = _from_s(case, x, dk_in)
    assert (kdk is None) == (pdk is None)
    assert grad_row_rel_err(kdv, pdv) < GRAD_TOL
    if pdk is not None:
        assert grad_row_rel_err(kdk, pdk) < GRAD_TOL
    assert torch.isfinite(kds.float()).all()
    assert grad_row_rel_err(kds, pds) < GRAD_TOL
    if case.get("causal"):
        nq, nkv = x["q"].shape[2], x["k"].shape[2]
        kw = dict(scale=_fwd_kw(case, x)["scale"], group=x["q"].shape[1] // x["k"].shape[1],
                  nq=nq, nkv=nkv, causal_offset=nkv - nq, dk_dtype=torch.bfloat16)
        q = to_torch(x["q"], "bfloat16")
        before = tbwd._banded_dk_from_ds.launches
        got = tbwd._banded_dk_from_ds(kds, q.to(cuda), None, **kw)
        torch.cuda.synchronize()
        assert tbwd._banded_dk_from_ds.launches == before + 1
        assert grad_row_rel_err(got, tbwd._banded_dk_from_ds(kds.cpu(), q, None, **kw)) < GRAD_TOL


@pytest.mark.parametrize("name", ["causal_gqa", "bias_key_causal", "short_nq"])
def test_nan_filled_slab_on_card_matches_plain(cuda, name):
    """Everything of the S residual outside the band (the tiles the forward
    never writes, the padding) set to NaN before the backward reads it: the
    gradients and the bias gradient stay finite and match the plain
    versions, so the from-S pass, banded dK / dQ and dbias from the slab
    read only the band or the zeros the from-S pass writes."""
    case = CASES[name]
    x = _inputs(case, seed=5)
    kw = _fwd_kw(case, x)
    nq, nkv = x["q"].shape[2], x["k"].shape[2]
    got = {}
    for dev in (cuda, "cpu"):
        q, k, v, do = (to_torch(x[n], "bfloat16", dev) for n in ("q", "k", "v", "do"))
        bias = to_torch(x["bias"], device=dev)
        o, lse, s = tfwd.flash_attention_forward(q, k, v, bias, return_scores=True, **kw)
        rows = torch.arange(s.shape[2], device=dev)[:, None]
        cols = torch.arange(s.shape[3], device=dev)[None, :]
        s.masked_fill_(~((rows < nq) & (cols <= rows + nkv - nq)), float("nan"))
        got[str(dev)] = tbwd.flash_attention_backward(q, k, v, bias, o, lse, do, scores=s, **kw)
    for n, g, w in zip(("dq", "dk", "dv", "dbias"), got[str(cuda)], got["cpu"]):
        if w is None:
            continue
        assert torch.isfinite(g.float()).all(), n
        measure = rel_err if n == "dbias" else grad_row_rel_err
        assert measure(g.cpu(), w) < GRAD_TOL, n
