"""The port's packed varlen attention against the JAX package's.

The metadata (segment ids, tail-aligned ranks, the tile schedule) must equal
the JAX package's exactly, the pseudo-segment of a padded tail and a
length-0 segment included. Outputs: the same numpy inputs, rounded to bf16
(or fp16) once, go through ``ffpa_attn_varlen_func`` of both packages; on
the CPU the port runs the kernel's plain version, JAX its Pallas kernel in
interpret mode (T <= 256: one grid tile of its 256-row blocks).

Tolerances: bf16 outputs 2e-2 relative to max|o| (tests/test_features.py:127);
lse 1e-2 absolute and relative (tests/test_ffpa_varlen.py:91); fp16 1e-2
against the fp32 per-segment oracle for the port (native fp16) and for JAX
(which computes fp16 in bf16), 2e-2 between them. On the card, kernel vs
plain per row (``row_rel_err``) at bf16 2e-2 / fp16 1e-2, lse 1e-4 relative.
"""

import math

import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401
    cuda, jax_modules, randn, rel_err, row_rel_err, to_jax, to_torch,
)
from ffpa_attn_tpu_torch import ffpa_attn_varlen_func
from ffpa_attn_tpu_torch.ops import varlen as tvar
from ffpa_attn_tpu_torch.ops.config import BlockConfig
from ffpa_attn_tpu_torch.ops.reference import DEFAULT_MASK_VALUE

BF16_TOL = 2e-2
F16_TOL = 1e-2
LSE_TOL = 1e-2
CARD_LSE_TOL = 1e-4

CASES = {
    "self": dict(seqs=[40, 72, 16]),
    "self_causal": dict(seqs=[40, 72, 16], causal=True),
    "cross": dict(seqs=[30, 20], seqs_k=[90, 70]),
    "cross_causal": dict(seqs=[30, 20], seqs_k=[90, 70], causal=True),
    "gqa_causal": dict(seqs=[40, 72, 16], hq=4, hkv=2, causal=True),
    "window_causal": dict(seqs=[40, 72, 16], causal=True, window=(16, -1)),
    "window_two_sided": dict(seqs=[40, 72, 16], window=(8, 8)),
    "softcap": dict(seqs=[40, 72, 16], causal=True, softcap=5.0),
    "alibi": dict(seqs=[40, 72, 16], causal=True, alibi=True),
    "sinks": dict(seqs=[40, 72, 16], causal=True, sinks=True),
    "d512": dict(seqs=[40, 72, 16], causal=True, d=512),
    "padded_tail_empty_segment": dict(seqs=[40, 0, 56], pad_q=20, causal=True),
    # Above D512: the forward's cluster route (and the backward's).
    "d1024": dict(seqs=[40, 72, 16], causal=True, d=1024),
    "d640_dv1024": dict(seqs=[40, 72, 16], causal=True, d=640, dv=1024),
}


def _inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    seqs = case["seqs"]
    seqs_k = case.get("seqs_k", seqs)
    hq, hkv, d = case.get("hq", 2), case.get("hkv", 2), case.get("d", 320)
    tq = sum(seqs) + case.get("pad_q", 0)
    tk = sum(seqs_k) + case.get("pad_q", 0)
    x = dict(
        q=randn(rng, (tq, hq, d)), k=randn(rng, (tk, hkv, d)),
        v=randn(rng, (tk, hkv, case.get("dv", d))),
        cu_q=np.cumsum([0] + list(seqs)).astype(np.int32),
        cu_k=np.cumsum([0] + list(seqs_k)).astype(np.int32),
        alibi=rng.uniform(0.01, 0.3, (hq,)).astype(np.float32) if case.get("alibi") else None,
        sinks=randn(rng, (hq,)) if case.get("sinks") else None,
    )
    return x


def _kwargs(case):
    kw = dict(causal=case.get("causal", False), return_lse=True,
              enable_gqa=case.get("hq", 2) != case.get("hkv", 2))
    if "window" in case:
        kw["window_size"] = case["window"]
    if "softcap" in case:
        kw["softcap"] = case["softcap"]
    return kw


def _max_seqlens(x):
    return int(np.diff(x["cu_q"]).max()), int(np.diff(x["cu_k"]).max())


def _jax_varlen(jv, x, case, dtype):
    jnp = jv[0]
    kw = _kwargs(case)
    if x["alibi"] is not None:
        kw["alibi_slopes"] = to_jax(x["alibi"])
    if x["sinks"] is not None:
        kw["sinks"] = to_jax(x["sinks"])
    return jv[1].ffpa_attn_varlen_func(
        *(to_jax(x[n], dtype) for n in ("q", "k", "v")),
        jnp.asarray(x["cu_q"], jnp.int32), jnp.asarray(x["cu_k"], jnp.int32),
        *_max_seqlens(x), **kw)


def _torch_varlen(x, case, dtype, device="cpu"):
    kw = _kwargs(case)
    if x["alibi"] is not None:
        kw["alibi_slopes"] = to_torch(x["alibi"], device=device)
    if x["sinks"] is not None:
        kw["sinks"] = to_torch(x["sinks"], device=device)
    cu = [torch.from_numpy(x[n]).to(device) for n in ("cu_q", "cu_k")]
    return ffpa_attn_varlen_func(
        *(to_torch(x[n], dtype, device) for n in ("q", "k", "v")), *cu, *_max_seqlens(x), **kw)


@pytest.fixture(scope="module")
def jv():
    """jax.numpy and the JAX package."""
    return jax_modules("jax.numpy", "ffpa_attn_tpu")


@pytest.fixture(scope="module")
def jvar():
    return jax_modules("jax.numpy", "ffpa_attn_tpu.ops.varlen")


@pytest.mark.parametrize("cu,tq,tk", [
    ([0, 70, 300, 301, 512], 512, 512),
    ([0, 40, 40, 112], 130, 130),  # a length-0 segment and a padded tail (pseudo-segment B)
    ([0, 30, 50], 50, 50),
])
@pytest.mark.parametrize("cu_k_shift", [0, 40])
def test_segment_metadata_equals_jax(jvar, cu, tq, tk, cu_k_shift):
    """q_seg, q_rank, k_seg, k_pos bit for bit, padded to the kernel's
    tiles; with cu_k_shift the keys outnumber the queries in the last
    segment (tail-aligned cross varlen)."""
    jnp, jvl = jvar
    cu_q = np.asarray(cu, np.int32)
    cu_k = cu_q.copy()
    cu_k[-1] += cu_k_shift
    tk += cu_k_shift
    tq_pad, tk_pad = -(-tq // 64) * 64, -(-tk // 64) * 64
    want = jvl._segment_metadata(jnp.asarray(cu_q), jnp.asarray(cu_k), tq, tk, tq_pad, tk_pad)
    got = tvar._segment_metadata(torch.from_numpy(cu_q), torch.from_numpy(cu_k), tq, tk,
                                 tq_pad, tk_pad)
    for g, w, name in zip(got, want, ("q_seg", "q_rank", "k_seg", "k_pos")):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if cu == [0, 40, 40, 112]:
        # The padded tail [112, 130) is segment B = 3, not -1; rows past T are -1.
        assert set(got[0][112:130].tolist()) == {3} and set(got[0][130:].tolist()) == {-1}


@pytest.mark.parametrize("causal,window", [
    (False, (-1, -1)), (True, (-1, -1)), (True, (24, -1)), (False, (16, 8)),
])
@pytest.mark.parametrize("bq", [64, 32])
def test_tile_schedule_equals_jax(jvar, causal, window, bq):
    """_tile_needed and _interval_schedule at the kernel's tiles, the [0, 0]
    interval of an empty tile row included."""
    jnp, jvl = jvar
    cu = np.asarray([0, 70, 70, 200, 201, 300], np.int32)
    tq = tk = 330  # tail [300, 330) is the pseudo-segment
    tq_pad, tk_pad = -(-tq // bq) * bq + bq, -(-tk // 64) * 64  # one all-padding Q tile
    wl, wr = window[0], -1 if causal else window[1]
    jmeta = jvl._segment_metadata(jnp.asarray(cu), jnp.asarray(cu), tq, tk, tq_pad, tk_pad)
    tmeta = tvar._segment_metadata(torch.from_numpy(cu), torch.from_numpy(cu), tq, tk, tq_pad,
                                   tk_pad)
    jneed = jvl._tile_needed(*jmeta, bq, 64, causal, wl, wr)
    tneed = tvar._tile_needed(*tmeta, bq, 64, causal, wl, wr)
    np.testing.assert_array_equal(tneed.numpy(), np.asarray(jneed))
    for g, w in zip(tvar._interval_schedule(tneed), jvl._interval_schedule(jneed)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    lo, hi = tvar._interval_schedule(tneed)
    assert int(lo[-1]) == 0 and int(hi[-1]) == 0  # the all-padding tile


@pytest.mark.parametrize("name", sorted(CASES))
def test_varlen_matches_jax(jv, name):
    case = CASES[name]
    x = _inputs(case)
    jo, jl = _jax_varlen(jv, x, case, "bfloat16")
    f0 = tvar._varlen_forward.launches
    to, tl = _torch_varlen(x, case, "bfloat16")
    assert tvar._varlen_forward.launches == f0  # CPU tensors run the plain version
    assert to.dtype == torch.bfloat16 and tuple(to.shape) == tuple(jo.shape)
    assert tuple(tl.shape) == tuple(jl.shape) and tl.dtype == torch.float32
    assert rel_err(to, jo) < BF16_TOL, name
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LSE_TOL, rtol=LSE_TOL)


def _oracle(x, case, dtype):
    """fp32 per-segment dense attention on the inputs rounded to ``dtype``."""
    from ffpa_attn_tpu_torch.ops.reference import expand_kv_heads, reference_attention

    q, k, v = (to_torch(x[n], dtype).float() for n in ("q", "k", "v"))
    outs = []
    for (q0, q1), (k0, k1) in zip(zip(x["cu_q"][:-1], x["cu_q"][1:]),
                                  zip(x["cu_k"][:-1], x["cu_k"][1:])):
        qs, ks, vs = (t.transpose(0, 1)[None] for t in (q[q0:q1], k[k0:k1], v[k0:k1]))
        o = reference_attention(qs, expand_kv_heads(ks, q.shape[1]),
                                expand_kv_heads(vs, q.shape[1]), is_causal=case.get("causal"))
        outs.append(o[0].transpose(0, 1))
    return torch.cat(outs)


def test_varlen_fp16_native_vs_jax_bf16_compute(jv):
    case = CASES["gqa_causal"]
    x = _inputs(case, seed=3)
    want = _oracle(x, case, "float16")
    jo, _ = _jax_varlen(jv, x, case, "float16")
    to, _ = _torch_varlen(x, case, "float16")
    assert to.dtype == torch.float16
    assert rel_err(to, want) < F16_TOL
    assert rel_err(jo, want) < F16_TOL
    assert rel_err(to, jo) < BF16_TOL


def test_varlen_rejected_kwargs():
    """The JAX package's taxonomy (tests/test_ffpa_varlen.py:142)."""
    case = dict(seqs=[128])
    x = _inputs(case)
    q, k, v = (to_torch(x[n], "bfloat16") for n in ("q", "k", "v"))
    cu = torch.from_numpy(x["cu_q"])
    with pytest.raises(NotImplementedError) as exc:
        ffpa_attn_varlen_func(q, k, v, cu, cu, 128, 128, score_mod=object(),
                              seqused_k=torch.zeros((1,), dtype=torch.int32))
    assert "score_mod" in str(exc.value) and "seqused_k" in str(exc.value)
    with pytest.raises(NotImplementedError):
        ffpa_attn_varlen_func(q, k, v, cu, cu, 128, 128, dropout_p=0.1)
    with pytest.raises(TypeError):
        ffpa_attn_varlen_func(q, k, v, cu.float(), cu, 128, 128)
    with pytest.raises(TypeError, match="bogus"):
        ffpa_attn_varlen_func(q, k, v, cu, cu, 128, 128, bogus=1)
    with pytest.raises(ValueError, match="enable_gqa"):
        ffpa_attn_varlen_func(q, k[:, :1], v[:, :1], cu, cu, 128, 128)
    with pytest.raises(ValueError, match="block_kv"):
        ffpa_attn_varlen_func(q, k, v, cu, cu, 128, 128, block_kv=128)
    # num_splits at its default is not an offence.
    out = ffpa_attn_varlen_func(q, k, v, cu, None, 128, 128, num_splits=1)
    assert tuple(out.shape) == tuple(q.shape)


def test_wide_packed_call_walks_once(monkeypatch):
    """One D1024 packed forward + backward through ``ffpa_attn_varlen_func``
    builds one 64 x 64 walk: the forward computes it (``_call_walk``) and
    saves it, and the backward reads the saved one."""
    calls = []
    walk = tvar._walk_schedule

    def counted(*args, **kw):
        calls.append(args[2])
        return walk(*args, **kw)

    monkeypatch.setattr(tvar, "_walk_schedule", counted)
    case = dict(seqs=[40, 72, 16], causal=True, d=1024)
    x = _inputs(case, seed=8)
    q, k, v = (to_torch(x[n], "bfloat16").requires_grad_() for n in ("q", "k", "v"))
    cu = torch.from_numpy(x["cu_q"])
    o = ffpa_attn_varlen_func(q, k, v, cu, cu, 72, 72, causal=True)
    assert calls == [64] and len(o.grad_fn.saved_tensors) == 15
    o.float().sum().backward()
    assert calls == [64]
    assert all(t.grad is not None and bool(torch.isfinite(t.grad.float()).all())
               for t in (q, k, v))


def test_varlen_backward_matches_jax_vjp(jv):
    """The packed-training slice: ``o.float().sum().backward()`` (an
    expanded, stride-0 cotangent) runs the varlen backward and matches
    ``jax.vjp`` of the JAX package with a ones cotangent, at the bf16
    gradient tolerance 5e-2 (tests/test_ffpa_varlen.py:19)."""
    import jax

    jnp = jv[0]
    case = dict(seqs=[64, 32], causal=True)
    x = _inputs(case)
    q, k, v = (to_torch(x[n], "bfloat16").requires_grad_() for n in ("q", "k", "v"))
    cu = torch.from_numpy(x["cu_q"])
    o = ffpa_attn_varlen_func(q, k, v, cu, cu, 64, 64, causal=True)
    o.float().sum().backward()
    jcu = jnp.asarray(x["cu_q"], jnp.int32)
    jo, vjp = jax.vjp(lambda *a: jv[1].ffpa_attn_varlen_func(*a, jcu, jcu, 64, 64, causal=True),
                      *(to_jax(x[n], "bfloat16") for n in ("q", "k", "v")))
    for g, w in zip((q.grad, k.grad, v.grad), vjp(jnp.ones_like(jo))):
        assert g.dtype == torch.bfloat16
        assert rel_err(g, w) < 5e-2


# -- on the card: the kernel against its plain version ----------------------

CARD_CASES = {
    **CASES,
    "mha_long": dict(seqs=[300, 17, 500], hq=4, hkv=4, causal=True),
    "tile_straddles_three_segments": dict(seqs=[20, 9, 50, 3], causal=True),
    # Keys fewer than queries, tail-aligned: the first 120 rows keep no key,
    # so the first 64-row Q tile needs no KV tile at all.
    "cross_causal_empty_rows": dict(seqs=[150, 40], seqs_k=[30, 40], causal=True),
    # The forward's cluster: D = Dv, an odd box count (rank 0 five of nine),
    # a rank without a D box (D64 / Dv1024) and one without a Dv box (D1024 /
    # Dv64).
    "d640": dict(seqs=[40, 72, 16], causal=True, d=640),
    "d576_odd_boxes": dict(seqs=[20, 9, 50, 3], causal=True, d=576),
    "d64_dv1024": dict(seqs=[40, 72, 16], causal=True, d=64, dv=1024),
    "d1024_dv64": dict(seqs=[40, 72, 16], window=(16, 8), d=1024, dv=64),
}


def _kernel_walk(q, k, v, meta, schedule, plan, *, scale, causal, softcap=0.0, window=(-1, -1),
                 alibi=None):
    """The forward kernel's walk in plain fp32 PyTorch, one block or the
    cluster as ``plan`` (``varlen_fwd_plan``) names: the 64-row Q tiles in
    the schedule's order, each an online softmax over only its listed KV
    tiles with m started at MASK_VALUE, P rounded to the input type for P V;
    a 64 x 32 block that ``_full_blocks`` marks full skips the keep-mask.
    On the cluster S is rank 0's partial over its half of D's boxes plus rank
    1's over the other half (a rank without a box adds 0), each in fp32, and
    each rank accumulates and writes only its half of Dv's columns (every
    column written once). ``window`` is normalized. (o, lse) as
    ``_varlen_forward_plain`` returns them."""
    tiles, count, order = schedule
    tq, hq, d = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    q_seg, q_rank, k_seg, k_pos = meta
    nqb, tk_pad = tiles.shape[0], k_seg.shape[0]
    mask = torch.tensor(DEFAULT_MASK_VALUE, dtype=torch.float32)
    qf = torch.zeros((hq, nqb * 64, d))
    qf[:, :tq] = q.transpose(0, 1).float()
    kf, vf = torch.zeros((hkv, tk_pad, d)), torch.zeros((hkv, tk_pad, dv))
    kf[:, :k.shape[0]], vf[:, :k.shape[0]] = k.transpose(0, 1).float(), v.transpose(0, 1).float()
    kf, vf = kf.repeat_interleave(hq // hkv, 0), vf.repeat_interleave(hq // hkv, 0)
    full = tvar._full_blocks(meta, 64, 32, causal, window, softcap=softcap,
                             alibi=alibi is not None)
    d_pad, dv_pad = -(-d // 64) * 64, -(-dv // 64) * 64
    if plan.rank_blocks:
        d_cols = [dc for dc, _ in plan.rank_blocks]
        v_cols = [vc for _, vc in plan.rank_blocks]
        assert sum(w for _, w in d_cols) == d_pad and sum(w for _, w in v_cols) == dv_pad
    else:
        d_cols, v_cols = [(0, d_pad)], [(0, dv_pad)]
    o, lse = torch.full((hq, nqb * 64, dv), float("nan")), torch.zeros((hq, nqb * 64))
    for i in order.tolist():
        r = slice(64 * i, 64 * i + 64)
        m, l, acc = mask.expand(hq, 64, 1).clone(), torch.zeros((hq, 64, 1)), torch.zeros(
            (hq, 64, dv))
        for j in tiles[i, :int(count[i])].tolist():
            c = slice(64 * j, 64 * j + 64)
            s = torch.zeros((hq, 64, 64))
            for d0, dw in d_cols:  # each rank's partial, summed in rank order
                s = s + torch.einsum("hqd,hkd->hqk", qf[:, r, d0:d0 + dw], kf[:, c, d0:d0 + dw])
            s = s * scale
            if softcap > 0.0:
                s = softcap * torch.tanh(s / softcap)
            if alibi is not None:
                s = s - alibi.float()[:, None, None] * (
                    q_rank[r, None] - k_pos[None, c]).abs().float()
            keep = tvar._varlen_mask(q_seg[r, None], q_rank[r, None], k_seg[None, c],
                                     k_pos[None, c], causal, window[0], window[1])
            keep = keep | full[i, 2 * j:2 * j + 2].repeat_interleave(32)[None, :]
            s = torch.where(keep, s, mask)
            mn = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.where(keep, torch.exp(s - mn), 0.0)
            alpha = torch.exp(m - mn)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = alpha * acc + torch.einsum("hqk,hkd->hqd", p.to(q.dtype).float(), vf[:, c])
            m = mn
        for v0, vw in v_cols:  # each rank writes its own columns
            cols = slice(v0, min(v0 + vw, dv))
            assert bool(o[:, r, cols].isnan().all())
            o[:, r, cols] = acc[..., cols] / torch.where(l == 0.0, 1.0, l)
        lse[:, r] = (m + torch.log(l.clamp_min(1e-38)))[..., 0]
    assert sorted(order.tolist()) == list(range(nqb))
    assert not bool(o.isnan().any())
    return o[:, :tq].transpose(0, 1).to(q.dtype), lse[:, :tq]


@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_kernel_walk_matches_plain(name):
    """The forward's schedule (only the needed KV tiles, the Q tiles most
    needed first), its full-block fast path and, above D512, the cluster's
    split (summed partial S, each rank's Dv columns) compute the plain
    version's function: o per row at the bf16 tolerance (the walk rounds P
    to bf16 as the kernel does), lse of the rows that keep a key at 1e-4,
    and every row that keeps none (a Q tile with no KV tile among them)
    exactly MASK_VALUE + log(1e-38), as the plain version gives."""
    case = CARD_CASES[name]
    x = _inputs(case, seed=7)
    q, k, v = (to_torch(x[n], "bfloat16") for n in ("q", "k", "v"))
    tq, tk = q.shape[0], k.shape[0]
    causal = case.get("causal", False)
    window = case.get("window", (-1, -1))
    window = (window[0], -1 if causal else window[1])
    kw = dict(scale=q.shape[-1] ** -0.5, causal=causal, softcap=case.get("softcap", 0.0),
              window=window, alibi=to_torch(x["alibi"]))
    meta = tvar._call_metadata(*(torch.from_numpy(x[n]) for n in ("cu_q", "cu_k")), tq, tk, "cpu")
    d_pad, dv_pad = -(-q.shape[-1] // 64) * 64, -(-v.shape[-1] // 64) * 64
    cfg = BlockConfig(block_q=64)
    plan, rows, cut, sched = tvar._varlen_fwd_tiles(meta, tq, d_pad, dv_pad, cfg, causal, window)
    assert plan.route == ("wgmma_cluster" if max(d_pad, dv_pad) > 512 else "wgmma")
    assert rows == 64 and bool(plan.rank_blocks) == (plan.route == "wgmma_cluster")
    wo, wl = _kernel_walk(q, k, v, cut, sched, plan, **kw)
    po, pl = tvar._varlen_forward_plain(q, k, v, meta, **kw)
    assert row_rel_err(wo, po) < BF16_TOL, name
    empty = torch.tensor(DEFAULT_MASK_VALUE, dtype=torch.float32) + torch.log(
        torch.tensor(1e-38, dtype=torch.float32))
    live = pl > DEFAULT_MASK_VALUE / 2
    np.testing.assert_allclose(wl[live].numpy(), pl[live].numpy(), atol=1e-4, rtol=1e-4)
    assert bool((pl[~live] == empty).all()) and bool((wl[~live] == empty).all()), name
    if name == "cross_causal_empty_rows":
        assert int((~live).sum()) == 120 * q.shape[1] and int(sched[1].min()) == 0


@pytest.mark.parametrize("name", sorted(CARD_CASES))
@pytest.mark.parametrize("dtype,tol", [("bfloat16", BF16_TOL), ("float16", F16_TOL)])
def test_varlen_kernel_matches_plain_on_card(cuda, name, dtype, tol):
    case = CARD_CASES[name]
    x = _inputs(case, seed=5)
    f0 = tvar._varlen_forward.launches
    ko, kl = _torch_varlen(x, case, dtype, cuda)
    torch.cuda.synchronize()
    assert tvar._varlen_forward.launches == f0 + 1
    po, pl = _torch_varlen(x, case, dtype)  # the plain version on the CPU
    assert row_rel_err(ko, po) < tol, name
    assert rel_err(kl, pl) < CARD_LSE_TOL, name


def test_varlen_strided_inputs_on_card(cuda):
    """q/k/v read through their strides: a view of a wider buffer gives the
    same output as its contiguous copy."""
    case = dict(seqs=[100, 60], hq=2, hkv=2, causal=True, d=512)
    x = _inputs(case, seed=6)
    wide = to_torch(np.concatenate([x["q"], x["q"]], axis=1), "bfloat16", cuda)
    cu = torch.from_numpy(x["cu_q"]).to(cuda)
    k, v = (to_torch(x[n], "bfloat16", cuda) for n in ("k", "v"))
    got = ffpa_attn_varlen_func(wide[:, :2], k, v, cu, cu, 100, 100, causal=True)
    want = ffpa_attn_varlen_func(wide[:, :2].contiguous(), k, v, cu, cu, 100, 100, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert math.isfinite(float(got.float().abs().max()))
