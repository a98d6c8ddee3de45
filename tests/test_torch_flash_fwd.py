"""The port's ``flash_attention_forward`` against the JAX package's.

On the CPU the port runs the kernel's plain version; JAX runs its Pallas
kernel in interpret mode. Inputs are rounded to bf16 (or fp16) once, from
the same numpy arrays, so both sides see identical values.

Tolerances: bf16 outputs 2e-2 relative to max|o| (the JAX suite's forward
tolerance, tests/test_features.py:127); fp16 1e-2 against the fp32 oracle
(tests/test_ffpa_bwd.py:19) for each side (JAX computes fp16 in bf16, the
port natively) and 2e-2 between them; LSE is fp32 math on identical inputs
on both sides, 1e-4 relative to max|lse|. On the card, kernel vs plain holds
the same output tolerances to each row's max|o| (``row_rel_err``): late
causal rows are far smaller than row 0.
"""

import math

import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401
    cuda, jax_modules, randn, rel_err, row_rel_err, to_jax, to_torch,
)
from ffpa_attn_tpu_torch.ops import flash_fwd as tfwd

BF16_TOL = 2e-2
F16_TOL = 1e-2
LSE_TOL = 1e-4

CASES = {
    "causal_gqa": dict(hq=4, hkv=2, nq=256, nkv=256, d=512, is_causal=True),
    "bias": dict(nq=128, nkv=256, d=512, bias=True),
    "softcap": dict(nq=128, nkv=128, d=512, softcap=4.0, is_causal=True),
    "window": dict(nq=256, nkv=256, d=512, window=(40, 8)),
    "alibi": dict(hq=2, hkv=1, nq=128, nkv=192, d=512, alibi=True, is_causal=True),
    "ragged_nkv": dict(nq=128, nkv=200, d=512, is_causal=True),
    "d320": dict(hq=2, hkv=1, nq=128, nkv=128, d=320, is_causal=True),
    "d1024": dict(nq=128, nkv=128, d=1024, is_causal=True),
    "batch2_bias_alibi": dict(b=2, hq=4, hkv=2, nq=128, nkv=160, d=512, bias=True,
                              alibi=True, is_causal=True),
}


def _inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    b, hq, hkv = case.get("b", 1), case.get("hq", 2), case.get("hkv", 2)
    nq, nkv, d = case["nq"], case["nkv"], case["d"]
    x = dict(
        q=randn(rng, (b, hq, nq, d)), k=randn(rng, (b, hkv, nkv, d)),
        v=randn(rng, (b, hkv, nkv, d)), bias=None, alibi=None,
    )
    if case.get("bias"):
        x["bias"] = randn(rng, (b, 1, nq, nkv))
    if case.get("alibi"):
        x["alibi"] = rng.uniform(0.01, 0.3, (b, hq)).astype(np.float32)
    return x


def _kwargs(case):
    return dict(
        scale=1.0 / math.sqrt(case["d"]),
        is_causal=case.get("is_causal", False),
        softcap=case.get("softcap", 0.0),
        window=case.get("window", (-1, -1)),
    )


@pytest.fixture(scope="module")
def jax_ref():
    return jax_modules("ffpa_attn_tpu.ops.flash_fwd", "ffpa_attn_tpu.ops.reference")


def _jax_fwd(jfwd, x, case, dtype):
    return jfwd.flash_attention_forward(
        to_jax(x["q"], dtype), to_jax(x["k"], dtype), to_jax(x["v"], dtype),
        to_jax(x["bias"]), alibi_slopes=to_jax(x["alibi"]), **_kwargs(case),
    )


def _torch_fwd(x, case, dtype, device="cpu"):
    return tfwd.flash_attention_forward(
        to_torch(x["q"], dtype, device), to_torch(x["k"], dtype, device),
        to_torch(x["v"], dtype, device), to_torch(x["bias"], device=device),
        alibi_slopes=to_torch(x["alibi"], device=device), **_kwargs(case),
    )


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax_bf16(jax_ref, name):
    case = CASES[name]
    x = _inputs(case)
    jo, jl = _jax_fwd(jax_ref[0], x, case, "bfloat16")
    to, tl = _torch_fwd(x, case, "bfloat16")
    assert to.dtype == torch.bfloat16 and tuple(to.shape) == tuple(jo.shape)
    assert rel_err(to, jo) < BF16_TOL, name
    assert rel_err(tl, jl) < LSE_TOL, name


def test_forward_fp16_native_vs_jax_bf16_compute(jax_ref):
    jfwd, jref = jax_ref
    case = CASES["causal_gqa"]
    x = _inputs(case, seed=3)
    hq = x["q"].shape[1]
    # fp32 oracle on the fp16-rounded inputs.
    q16, k16, v16 = (to_jax(x[n], "float16").astype(np.float32) for n in ("q", "k", "v"))
    want = jref.reference_attention(
        q16, jref.expand_kv_heads(k16, hq), jref.expand_kv_heads(v16, hq), None, **_kwargs(case),
    )
    # The JAX core computes fp16 in bf16 (ops/attention.py:_to_compute_dtype).
    jo, _ = jfwd.flash_attention_forward(
        to_jax(x["q"], "float16").astype("bfloat16"),
        to_jax(x["k"], "float16").astype("bfloat16"),
        to_jax(x["v"], "float16").astype("bfloat16"), None, **_kwargs(case),
    )
    to, _ = _torch_fwd(x, case, "float16")
    assert to.dtype == torch.float16
    assert rel_err(to, want) < F16_TOL
    assert rel_err(jo, want) < F16_TOL
    assert rel_err(to, jo) < BF16_TOL


def test_kernel_options_raise_not_implemented():
    """What the forward still refuses: a tensor that is neither on the CPU
    nor on a card (meta), as such, with dropout or the S residual; and the
    S residual under a sliding window (its out-of-band tiles are never
    written). On the CPU ``return_scores`` gives the plain S residual."""
    q = torch.empty((1, 2, 128, 512), device="meta", dtype=torch.bfloat16)
    for kw in (dict(dropout_p=0.1), dict(return_scores=True)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            tfwd.flash_attention_forward(q, q, q, None, scale=0.1, is_causal=True, **kw)
    cpu = torch.zeros((1, 2, 128, 512), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="sliding windows"):
        tfwd.flash_attention_forward(cpu, cpu, cpu, None, scale=0.1, is_causal=True,
                                     window=(32, -1), return_scores=True)
    o, lse, s = tfwd.flash_attention_forward(cpu, cpu, cpu, None, scale=0.1, is_causal=True,
                                             return_scores=True)
    assert s.shape == (1, 2, 128, 128) and s.dtype == torch.bfloat16


def test_cpu_forward_never_counts_a_launch():
    x = _inputs(CASES["d320"])
    before = tfwd.flash_attention_forward.launches
    _torch_fwd(x, CASES["d320"], "bfloat16")
    assert tfwd.flash_attention_forward.launches == before


def test_row_measure_catches_late_causal_row_errors():
    """The card tests' measure must see a 10% error in the late causal rows,
    which max|err| / max|o| over the whole tensor lets pass: row 0 is V's row
    0, while a row that averages 500 keys or more is ~10x smaller."""
    case = dict(hq=1, hkv=1, nq=1024, nkv=1024, d=320, is_causal=True)
    o, _ = _torch_fwd(_inputs(case), case, "bfloat16")
    bad = o.float()
    bad[:, :, case["nq"] // 2:] *= 1.1
    assert rel_err(bad, o) < BF16_TOL
    assert row_rel_err(bad, o) > 4 * BF16_TOL
    assert row_rel_err(o, o) == 0.0


@pytest.mark.parametrize("dtype,tol", [("bfloat16", BF16_TOL), ("float16", F16_TOL)])
def test_dropout_kernel_matches_plain_on_card(cuda, dtype, tol):
    """The kernel drops P with the hash of ops/rng.py: a mask that differed
    from the plain version's would move whole rows far past the tolerance."""
    case = CASES["causal_gqa"]
    x = _inputs(case, seed=7)
    kw = dict(_kwargs(case), dropout_p=0.2, dropout_seed=5)
    args = [to_torch(x[n], dtype, cuda) for n in ("q", "k", "v")]
    ko, kl = tfwd.flash_attention_forward(*args, None, **kw)
    po, pl = tfwd.flash_attention_forward_plain(*args, None, **kw)
    torch.cuda.synchronize()
    assert row_rel_err(ko, po) < tol
    assert rel_err(kl, pl) < LSE_TOL


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dtype,tol", [("bfloat16", BF16_TOL), ("float16", F16_TOL)])
def test_kernel_matches_plain_on_card(cuda, name, dtype, tol):
    case = CASES[name]
    x = _inputs(case, seed=5)
    before = tfwd.flash_attention_forward.launches
    ko, kl = _torch_fwd(x, case, dtype, cuda)
    torch.cuda.synchronize()
    assert tfwd.flash_attention_forward.launches == before + 1
    po, pl = tfwd.flash_attention_forward_plain(
        to_torch(x["q"], dtype, cuda), to_torch(x["k"], dtype, cuda),
        to_torch(x["v"], dtype, cuda), to_torch(x["bias"], device=cuda),
        alibi_slopes=to_torch(x["alibi"], device=cuda), **_kwargs(case),
    )
    assert row_rel_err(ko, po) < tol, name
    assert rel_err(kl, pl) < LSE_TOL, name


# ---------------------------------------------------------------------------
# The cluster route's split (D or Dv > 512), emulated in plain PyTorch
# ---------------------------------------------------------------------------

MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)  # the kernels' masked score

# D640, D1024, D != Dv both ways; causal, windows, a bias with ALiBi and
# softcap, ragged Nkv and Nq not a multiple of 64; a few heads, N <= 256.
CLUSTER_CASES = {
    "d640_causal_nq200": dict(hq=2, hkv=1, nq=200, nkv=200, d=640, is_causal=True),
    "d1024_bias_ragged_nkv": dict(nq=96, nkv=200, d=1024, bias=True),
    "d1024_dv320_causal": dict(nq=100, nkv=160, d=1024, dv=320, is_causal=True),
    "d320_dv1024_window": dict(nq=128, nkv=128, d=320, dv=1024, window=(40, 8)),
    "d1024_causal_window": dict(nq=192, nkv=256, d=1024, window=(100, -1), is_causal=True),
    "d640_bias_alibi_softcap": dict(hq=2, hkv=1, nq=70, nkv=130, d=640, bias=True, alibi=True,
                                    softcap=4.0, is_causal=True),
}


def _cluster_walk(q, k, v, bias, *, scale, is_causal, window, softcap, alibi, plan, dtype):
    """The cluster kernel's arithmetic in fp32 on 64 x 64 tiles: per 64-row
    block the KV tiles of its band; per tile each rank's partial S over its
    D boxes (box by box), S = own + partner in both ranks' order (held
    bit-equal), the scores' features and masks, the online softmax, P
    rounded to the input type, and O accumulated per rank's Dv boxes.
    Returns (o, lse) fp32."""
    b, hq, nq, _ = q.shape
    nkv, dv = k.shape[2], v.shape[-1]
    group = hq // k.shape[1]
    qf = q.float()
    kf, vf = (x.float().repeat_interleave(group, dim=1) for x in (k, v))
    off, (wl, wr) = nkv - nq, window
    wr = 0 if is_causal else wr
    o = torch.zeros((b, hq, nq, dv))
    lse = torch.zeros((b, hq, nq))
    for row0 in range(0, nq, 64):
        rows = torch.arange(row0, min(row0 + 64, nq))
        kv_lo, kv_hi = 0, nkv
        if wr >= 0:
            kv_hi = min(nkv, int(rows[-1]) + off + wr + 1)
        if wl >= 0:
            kv_lo = max(0, row0 + off - wl) // 64 * 64
        m = torch.full((b, hq, len(rows)), -math.inf)
        l = torch.zeros((b, hq, len(rows)))
        acc = [torch.zeros((b, hq, len(rows), vw)) for _, (_, vw) in plan.rank_blocks]
        for kv0 in range(kv_lo, kv_hi, 64):
            cols = torch.arange(kv0, min(kv0 + 64, nkv))
            qt, kt = qf[:, :, rows], kf[:, :, cols]
            part = []
            for (d0, dw), _ in plan.rank_blocks:
                p_r = torch.zeros((b, hq, len(rows), len(cols)))
                for c in range(d0, d0 + dw, 64):
                    p_r = p_r + qt[..., c:c + 64] @ kt[..., c:c + 64].transpose(-1, -2)
                part.append(p_r)
            s_rank0, s_rank1 = part[0] + part[1], part[1] + part[0]
            assert torch.equal(s_rank0, s_rank1)
            s = s_rank0 * scale
            if softcap > 0.0:
                s = softcap * torch.tanh(s / softcap)
            dist = (rows[:, None] + off - cols[None, :]).float()
            if alibi is not None:
                s = s - alibi.float()[..., None, None] * dist.abs()
            if bias is not None:
                s = s + bias.float()[:, :, rows][..., cols]
            if wr >= 0:
                s = torch.where(-dist > wr, MASK_VALUE, s)
            if wl >= 0:
                s = torch.where(dist > wl, MASK_VALUE, s)
            s = torch.where(cols[None, :] >= kv_hi, -math.inf, s)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.where(m_new == -math.inf, 1.0, torch.exp(m - m_new))
            p = torch.where(m_new[..., None] == -math.inf, 0.0, torch.exp(s - m_new[..., None]))
            l = alpha * l + p.sum(-1)
            pt = p.to(dtype).float()
            for r, (_, (v0, vw)) in enumerate(plan.rank_blocks):
                acc[r] = acc[r] * alpha[..., None] + pt @ vf[:, :, cols, v0:v0 + vw]
            m = m_new
        l_safe = torch.where(l == 0, 1.0, l)
        o[:, :, rows] = torch.cat(acc, dim=-1) / l_safe[..., None]
        lse[:, :, rows] = m + torch.log(torch.clamp(l, min=1e-38))
    return o, lse


@pytest.mark.parametrize("name", sorted(CLUSTER_CASES))
def test_cluster_split_emulation_matches_jax(jax_ref, name):
    """The two ranks' S are bit-equal and the split's (o, lse) hold to the
    JAX forward (2e-2 / 1e-4, the suite's forward tolerances)."""
    from ffpa_attn_tpu_torch.ops.config import fwd_plan

    case = CLUSTER_CASES[name]
    d, dv = case["d"], case.get("dv", case["d"])
    plan = fwd_plan(d, dv)
    assert plan.route == "wgmma_cluster"
    rng = np.random.default_rng(len(name))
    b, hq, hkv, nq, nkv = 1, case.get("hq", 2), case.get("hkv", 2), case["nq"], case["nkv"]
    x = dict(q=randn(rng, (b, hq, nq, d)), k=randn(rng, (b, hkv, nkv, d)),
             v=randn(rng, (b, hkv, nkv, dv)), bias=None, alibi=None)
    if case.get("bias"):
        x["bias"] = randn(rng, (b, 1, nq, nkv))
    if case.get("alibi"):
        x["alibi"] = rng.uniform(0.01, 0.3, (b, hq)).astype(np.float32)
    jo, jl = _jax_fwd(jax_ref[0], x, case, "bfloat16")
    q, k, v = (to_torch(x[n], "bfloat16") for n in ("q", "k", "v"))
    kw = _kwargs(case)
    o, lse = _cluster_walk(q, k, v, to_torch(x["bias"]), alibi=to_torch(x["alibi"]), plan=plan,
                           dtype=torch.bfloat16, is_causal=kw["is_causal"], scale=kw["scale"],
                           window=kw["window"], softcap=kw["softcap"])
    assert tuple(o.shape) == tuple(jo.shape)
    assert rel_err(o.to(torch.bfloat16), jo) < BF16_TOL, name
    assert rel_err(lse, jl) < LSE_TOL, name
