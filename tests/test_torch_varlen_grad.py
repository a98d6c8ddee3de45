"""Packed (varlen) training: the port's backward against the JAX package's.

``torch.autograd.grad`` through the port's ``ffpa_attn_varlen_func`` against
``jax.vjp`` of the JAX one, the same numpy inputs and cotangent rounded to
bf16 (or fp16) once. On the CPU the port runs the kernels' plain versions,
JAX its Pallas kernels in interpret mode (T <= 256: one grid tile of its
256-row blocks). The cases are the forward's (``tests/test_torch_varlen.py``),
and above D512 (``WIDE_CASES``) the head dims of the backward's cluster
routes.

Tolerances: bf16 gradients 5e-2 relative to max|g| (tests/test_ffpa_varlen.py:19,
tests/test_ffpa_bwd.py:19), the sink gradient 5e-2, the ALiBi gradient
exactly 0; fp16 1e-2 against the fp32 per-segment oracle for the port
(native fp16), 5e-2 against JAX (which computes fp16 in bf16). On the card,
each kernel against its plain version per row (``grad_row_rel_err``) at
bf16 5e-2 / fp16 1e-2.
"""

import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401
    cuda, grad_row_rel_err, jax_modules, randn, rel_err, to_jax, to_torch,
)
from ffpa_attn_tpu_torch import ffpa_attn_varlen_func
from ffpa_attn_tpu_torch.ops import varlen as tvar
from ffpa_attn_tpu_torch.ops.config import varlen_dkdv_plan, varlen_dq_plan, varlen_fwd_plan
from test_torch_varlen import CARD_CASES, CASES, _inputs, _kwargs, _max_seqlens

GRAD_TOL = {"bfloat16": 5e-2, "float16": 1e-2}
SINK_TOL = 5e-2


def _cotangent(x, seed=1):
    return randn(np.random.default_rng(seed), x["q"].shape[:2] + x["v"].shape[2:])


def _call_kwargs(case):
    return dict(_kwargs(case), return_lse=False)


@pytest.fixture(scope="module")
def jv():
    """jax and the JAX package."""
    return jax_modules("jax", "ffpa_attn_tpu")


def _jax_grads(jv, x, case, do, dtype):
    """(dq, dk, dv, dsinks or None) of the JAX package by ``jax.vjp``."""
    jax, jpkg = jv
    import jax.numpy as jnp

    kw = _call_kwargs(case)
    if x["alibi"] is not None:
        kw["alibi_slopes"] = to_jax(x["alibi"])
    cu = [jnp.asarray(x[n], jnp.int32) for n in ("cu_q", "cu_k")]
    primals = [to_jax(x[n], dtype) for n in ("q", "k", "v")]
    has_sinks = x["sinks"] is not None
    if has_sinks:
        primals.append(to_jax(x["sinks"]))

    def f(q, k, v, *sinks):
        return jpkg.ffpa_attn_varlen_func(q, k, v, *cu, *_max_seqlens(x),
                                          sinks=sinks[0] if sinks else None, **kw)

    _, vjp = jax.vjp(f, *primals)
    grads = vjp(to_jax(do, dtype))
    return tuple(grads) + (() if has_sinks else (None,))


def _torch_grads(x, case, do, dtype, device="cpu"):
    """(dq, dk, dv, dsinks or None, dalibi or None) of the port by
    ``torch.autograd.grad``; sinks and ALiBi slopes are leaves too."""
    leaves = [to_torch(x[n], dtype, device).requires_grad_() for n in ("q", "k", "v")]
    extras = {}
    for name, kwarg in (("sinks", "sinks"), ("alibi", "alibi_slopes")):
        if x[name] is not None:
            extras[kwarg] = to_torch(x[name], device=device).requires_grad_()
    cu = [torch.from_numpy(x[n]).to(device) for n in ("cu_q", "cu_k")]
    out = ffpa_attn_varlen_func(*leaves, *cu, *_max_seqlens(x), **extras, **_call_kwargs(case))
    grads = torch.autograd.grad(out, leaves + list(extras.values()),
                                to_torch(do, dtype, device))
    named = dict(zip(extras, grads[3:]))
    return grads[:3] + (named.get("sinks"), named.get("alibi_slopes"))


@pytest.mark.parametrize("name", sorted(CASES))
def test_varlen_grads_match_jax(jv, name):
    case = CASES[name]
    x = _inputs(case)
    do = _cotangent(x)
    want = _jax_grads(jv, x, case, do, "bfloat16")
    counts = (tvar._varlen_backward.dkdv_launches, tvar._varlen_backward.dq_launches)
    got = _torch_grads(x, case, do, "bfloat16")
    # CPU tensors run the plain version
    assert (tvar._varlen_backward.dkdv_launches, tvar._varlen_backward.dq_launches) == counts
    for g, w, src, n in zip(got, want, ("q", "k", "v"), ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == x[src].shape, n
        assert rel_err(g, w) < GRAD_TOL["bfloat16"], (name, n)
    if x["sinks"] is not None:
        assert got[3].dtype == torch.float32
        assert rel_err(got[3], want[3]) < SINK_TOL, name
    if x["alibi"] is not None:
        assert torch.equal(got[4], torch.zeros_like(got[4]))


def _oracle_grads(x, case, do, dtype):
    """fp32 per-segment dense attention's gradients on the inputs rounded to
    ``dtype``, by autograd."""
    from ffpa_attn_tpu_torch.ops.reference import expand_kv_heads, reference_attention

    leaves = [to_torch(x[n], dtype).float().requires_grad_() for n in ("q", "k", "v")]
    q, k, v = leaves
    outs = []
    for (q0, q1), (k0, k1) in zip(zip(x["cu_q"][:-1], x["cu_q"][1:]),
                                  zip(x["cu_k"][:-1], x["cu_k"][1:])):
        qs, ks, vs = (t.transpose(0, 1)[None] for t in (q[q0:q1], k[k0:k1], v[k0:k1]))
        o = reference_attention(qs, expand_kv_heads(ks, q.shape[1]),
                                expand_kv_heads(vs, q.shape[1]), is_causal=case.get("causal"))
        outs.append(o[0].transpose(0, 1))
    return torch.autograd.grad(torch.cat(outs), leaves, to_torch(do, dtype).float())


def test_varlen_fp16_grads_vs_oracle_and_jax(jv):
    case = CASES["gqa_causal"]
    x = _inputs(case, seed=3)
    do = _cotangent(x, seed=4)
    want = _oracle_grads(x, case, do, "float16")
    jg = _jax_grads(jv, x, case, do, "float16")
    got = _torch_grads(x, case, do, "float16")
    for g, w, j, n in zip(got, want, jg, ("dq", "dk", "dv")):
        assert g.dtype == torch.float16, n
        assert rel_err(g, w) < GRAD_TOL["float16"], n
        assert rel_err(g, j) < GRAD_TOL["bfloat16"], n


# Above D512 (the dK/dV and dQ cluster routes): T <= 256 as for CASES, bf16
# against JAX and fp16 against the fp32 oracle.
WIDE_CASES = {
    "d640_gqa_causal": dict(seqs=[40, 72, 16], hq=4, hkv=2, causal=True, d=640),
    "d1024_causal": dict(seqs=[40, 72, 16], causal=True, d=1024),
    "d1024_window_sinks": dict(seqs=[40, 72, 16], causal=True, window=(16, -1), sinks=True,
                               d=1024),
    "d576_softcap_two_sided": dict(seqs=[40, 72, 16], window=(8, 8), softcap=5.0, d=576),
}


@pytest.mark.parametrize("name", sorted(WIDE_CASES))
def test_varlen_grads_above_d512_match_jax(jv, name):
    """``torch.autograd.grad`` through the port against ``jax.vjp`` of the
    JAX package at head dims above 512, bf16 at 5e-2; no launch on the CPU."""
    case = WIDE_CASES[name]
    x = _inputs(case, seed=11)
    do = _cotangent(x, seed=12)
    want = _jax_grads(jv, x, case, do, "bfloat16")
    counts = (tvar._varlen_backward.dkdv_launches, tvar._varlen_backward.dq_launches)
    got = _torch_grads(x, case, do, "bfloat16")
    assert (tvar._varlen_backward.dkdv_launches, tvar._varlen_backward.dq_launches) == counts
    for g, w, src, n in zip(got, want, ("q", "k", "v"), ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == x[src].shape, n
        assert rel_err(g, w) < GRAD_TOL["bfloat16"], (name, n)
    if x["sinks"] is not None:
        assert rel_err(got[3], want[3]) < SINK_TOL, name


def test_varlen_fp16_grads_above_d512_vs_oracle_and_jax(jv):
    """fp16 at D1024 (GQA, causal): the port natively in fp16 within 1e-2 of
    the fp32 per-segment oracle, and within 5e-2 of JAX (which computes fp16
    in bf16)."""
    case = dict(seqs=[40, 72, 16], hq=4, hkv=2, causal=True, d=1024)
    x = _inputs(case, seed=13)
    do = _cotangent(x, seed=14)
    want = _oracle_grads(x, case, do, "float16")
    jg = _jax_grads(jv, x, case, do, "float16")
    got = _torch_grads(x, case, do, "float16")
    for g, w, j, n in zip(got, want, jg, ("dq", "dk", "dv")):
        assert g.dtype == torch.float16, n
        assert rel_err(g, w) < GRAD_TOL["float16"], n
        assert rel_err(g, j) < GRAD_TOL["bfloat16"], n


def _listed(tiles, count, nkb):
    """[Q tiles, KV tiles] bool: the KV tiles each Q tile's list holds."""
    out = torch.zeros((tiles.shape[0], nkb), dtype=torch.bool)
    for i in range(tiles.shape[0]):
        out[i, tiles[i, :int(count[i])].long()] = True
    return out


@pytest.mark.parametrize("causal,window", [
    (False, (-1, -1)), (True, (-1, -1)), (True, (24, -1)), (False, (16, 8)),
])
@pytest.mark.parametrize("cu_k_shift", [0, 40])
@pytest.mark.parametrize("given", [False, True], ids=["fresh", "given"])
@pytest.mark.parametrize("d", [512, 1024], ids=["wgmma", "cluster"])
def test_backward_schedules_cover_every_visible_pair(causal, window, cu_k_shift, given, d):
    """Every (query, key) pair the keep-mask attends lies inside its KV
    tile's [imin, imax] of the dK/dV schedule at the plan's 64 x 64 tiles
    and inside its 64-row Q tile's list of needed KV tiles of the dQ
    schedule, on both routes of both kernels (one block at D512, the
    cluster at D1024, as the id names), from a walk computed by
    ``_backward_schedules`` or given to it (``_walk_schedule``, what the
    forward saves); the dK/dV order lists every KV tile once, longest
    interval first; a padded tail (the pseudo-segment), a length-0 segment
    and tail-aligned cross keys."""
    cu_q = np.asarray([0, 70, 70, 200, 201, 300], np.int32)
    cu_k = cu_q.copy()
    cu_k[-1] += cu_k_shift
    tq, tk = 330, 330 + cu_k_shift
    wnorm = (window[0], -1 if causal else window[1])
    dkdv_plan, dq_plan = varlen_dkdv_plan(d, d), varlen_dq_plan(d, d)
    assert dkdv_plan.route == dq_plan.route == ("wgmma" if d == 512 else "wgmma_cluster")
    q_rows, kv_rows = dkdv_plan.q_rows, dkdv_plan.kv_rows
    assert (q_rows, kv_rows) == (dq_plan.q_rows, dq_plan.kv_rows) == (64, 64)
    meta = tvar._call_metadata(torch.from_numpy(cu_q), torch.from_numpy(cu_k), tq, tk, "cpu")
    walk = tvar._walk_schedule(meta, tq, 64, causal, wnorm) if given else None
    (imin, imax, order), dq = tvar._backward_schedules(meta, tq, dkdv_plan, dq_plan, causal,
                                                       wnorm, walk)
    q_seg, q_rank, k_seg, k_pos = meta
    assert imin.shape[0] == k_seg.shape[0] // kv_rows
    assert sorted(order.tolist()) == list(range(imin.shape[0]))
    lengths = (imax - imin)[order.long()]
    assert bool((lengths[:-1] >= lengths[1:]).all())
    keep = tvar._varlen_mask(q_seg[:, None], q_rank[:, None], k_seg[None, :], k_pos[None, :],
                             causal, *wnorm)
    rows, cols = (t.numpy() for t in torch.nonzero(keep, as_tuple=True))
    assert rows.size > 0 and rows.max() < tq and cols.max() < tk
    imin, imax = imin.numpy(), imax.numpy()
    i, j = rows // q_rows, cols // kv_rows
    assert ((imin[j] <= i) & (i <= imax[j])).all()
    tiles, count, qorder = dq
    assert tiles.shape[0] == -(-tq // 64)
    assert sorted(qorder.tolist()) == list(range(tiles.shape[0]))
    listed = _listed(tiles, count, k_seg.shape[0] // 64).numpy()
    assert listed[rows // 64, cols // 64].all()


def _saved_walk(x, case):
    """The schedule ``_VarlenCore`` saves from the forward of one
    ``ffpa_attn_varlen_func`` call on the CPU (the last four of its saved
    tensors: needed, tiles, count, order)."""
    leaves = [to_torch(x[n], "bfloat16").requires_grad_() for n in ("q", "k", "v")]
    cu = [torch.from_numpy(x[n]) for n in ("cu_q", "cu_k")]
    out = ffpa_attn_varlen_func(*leaves, *cu, *_max_seqlens(x), **_call_kwargs(case))
    return tuple(out.grad_fn.saved_tensors[-4:])


@pytest.mark.parametrize("causal,window", [
    (False, (-1, -1)), (True, (-1, -1)), (True, (24, -1)), (False, (16, 8)),
])
@pytest.mark.parametrize("cu_k_shift", [0, 40])
@pytest.mark.parametrize("route", ["wgmma", "wgmma_cluster"])
def test_saved_schedules_equal_fresh(causal, window, cu_k_shift, route):
    """The schedule the forward saves (64 x 64 needed tiles) is the one the
    backward would compute afresh, on the one-block routes (D, Dv <= 512;
    D64 here) and at D1024 (``route`` names the routes, the forward's and
    both backward kernels' clusters): the backward reads the saved walk at
    every width. dK/dV's intervals, order included, equal those of
    ``_tile_needed`` at 64 x 64 over the
    call's metadata (padded to 128 query rows: the extra Q tile holds only
    rows past Tq and is never needed), and dQ walks each 64-row Q tile's
    needed tiles, the saved lists. A padded tail, a length-0 segment,
    tail-aligned cross keys."""
    cu_q = np.asarray([0, 70, 70, 200, 201, 300], np.int32)
    cu_k = cu_q.copy()
    cu_k[-1] += cu_k_shift
    tq, tk = 330, 330 + cu_k_shift
    rng = np.random.default_rng(2)
    x = dict(q=randn(rng, (tq, 2, 64)), k=randn(rng, (tk, 2, 64)), v=randn(rng, (tk, 2, 64)),
             cu_q=cu_q, cu_k=cu_k)
    case = dict(causal=causal, window=window)
    walk = _saved_walk(x, case)
    wnorm = (window[0], -1 if causal else window[1])
    meta = tvar._call_metadata(torch.from_numpy(cu_q), torch.from_numpy(cu_k), tq, tk, "cpu")
    fresh = tvar._walk_schedule(meta, tq, 64, causal, wnorm)
    assert walk[0].dtype == torch.bool and walk[0].shape == (-(-tq // 64), -(-tk // 64))
    assert all(torch.equal(a, b) for a, b in zip(walk, fresh))
    d = 64 if route == "wgmma" else 1024
    dkdv_plan, dq_plan = varlen_dkdv_plan(d, d), varlen_dq_plan(d, d)
    assert dkdv_plan.route == dq_plan.route == varlen_fwd_plan(d, d).route == route
    saved = tvar._call_walk(meta, tq, causal, wnorm)
    assert all(torch.equal(a, b) for a, b in zip(saved, fresh))
    (imin, imax, order), dq = tvar._backward_schedules(meta, tq, dkdv_plan, dq_plan, causal,
                                                       wnorm, saved)
    want_dkdv = tvar._dkdv_intervals(tvar._tile_needed(*meta, 64, 64, causal, *wnorm))
    for got, want, from_walk in zip((imin, imax, order), want_dkdv,
                                    tvar._dkdv_intervals(walk[0])):
        assert torch.equal(got, want) and torch.equal(got, from_walk)
    tiles, count, qorder = dq
    assert all(torch.equal(a, b) for a, b in zip(dq, walk[1:]))
    assert sorted(qorder.tolist()) == list(range(tiles.shape[0]))
    for i in range(tiles.shape[0]):
        listed = tiles[i, :int(count[i])]
        assert torch.equal(listed, torch.nonzero(walk[0][i]).flatten().to(torch.int32))


def _dq_walk(q, k, v, do, lse, delta, meta, schedule, plan, *, scale, causal, softcap=0.0,
             window=(-1, -1), alibi=None):
    """The dQ kernel's walk in plain fp32 PyTorch, one block or the cluster
    of two as ``plan`` says: the 64-row Q tiles in the schedule's order,
    each visiting only its listed KV tiles. On the cluster rank r computes
    partial S and dP over its own D and Dv columns (``plan.rank_blocks``)
    and each rank adds the partner's partial to its own: the same two fp32
    values, so the same sum in both ranks. A 64 x 32 block that
    ``_full_blocks`` marks full skips the keep-mask, any other selects P to
    0 where the mask drops the pair; dS (softcap's factor included) rounded
    to the input type before dS K; each consumer (rank by rank:
    ``plan.dq_blocks``) stores its own dQ columns once. A Q tile with no
    listed tile gives dQ = 0. ``window`` is normalized. dq [Tq, Hq, D] as
    ``_varlen_dq_plain`` returns it."""
    tiles, count, order = schedule
    tq, hq, d = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    d_pad, dv_pad = -(-d // 64) * 64, -(-dv // 64) * 64
    q_seg, q_rank, k_seg, k_pos = meta
    nqb, tk_pad = tiles.shape[0], k_seg.shape[0]

    def rows_of(t, n, width):  # [T, H, W] -> [H, n, width] fp32, zeros past T and W
        out = torch.zeros((t.shape[1], n, width))
        out[:, :t.shape[0], :t.shape[2]] = t.transpose(0, 1).float()
        return out

    qf, dof = rows_of(q, nqb * 64, d_pad), rows_of(do, nqb * 64, dv_pad)
    kf = rows_of(k, tk_pad, d_pad).repeat_interleave(hq // hkv, 0)
    vf = rows_of(v, tk_pad, dv_pad).repeat_interleave(hq // hkv, 0)
    lsef, deltaf = torch.zeros((hq, nqb * 64)), torch.zeros((hq, nqb * 64))
    lsef[:, :tq], deltaf[:, :tq] = lse, delta
    full = tvar._full_blocks(meta, 64, 32, causal, window, softcap=softcap,
                             alibi=alibi is not None)
    ranks = plan.rank_blocks or (((0, d_pad), (0, dv_pad)),)
    dq = torch.full((hq, nqb * 64, d_pad), float("nan"))
    for i in order.tolist():
        r = slice(64 * i, 64 * i + 64)
        acc = torch.zeros((hq, 64, d_pad))
        for j in tiles[i, :int(count[i])].tolist():
            c = slice(64 * j, 64 * j + 64)
            parts = [(torch.einsum("hqd,hkd->hqk", qf[:, r, d0:d0 + nd], kf[:, c, d0:d0 + nd]),
                      torch.einsum("hqd,hkd->hqk", dof[:, r, v0:v0 + nv], vf[:, c, v0:v0 + nv]))
                     for (d0, nd), (v0, nv) in ranks]
            if len(parts) == 2:  # own + partner, in either rank
                (s0, p0), (s1, p1) = parts
                assert torch.equal(s0 + s1, s1 + s0) and torch.equal(p0 + p1, p1 + p0)
                s, dp = s0 + s1, p0 + p1
            else:
                s, dp = parts[0]
            s = s * scale
            cap = 1.0
            if softcap > 0.0:
                s = softcap * torch.tanh(s / softcap)
                cap = 1.0 - torch.square(s / softcap)
            if alibi is not None:
                s = s - alibi.float()[:, None, None] * (
                    q_rank[r, None] - k_pos[None, c]).abs().float()
            keep = tvar._varlen_mask(q_seg[r, None], q_rank[r, None], k_seg[None, c],
                                     k_pos[None, c], causal, window[0], window[1])
            keep = keep | full[i, 2 * j:2 * j + 2].repeat_interleave(32)[None, :]
            p = torch.where(keep, torch.exp(s - lsef[:, r, None]), 0.0)
            ds = p * (dp - deltaf[:, r, None]) * cap
            acc += torch.einsum("hqk,hkd->hqd", ds.to(q.dtype).float(), kf[:, c])
        # Each consumer of each rank stores its own columns once.
        for c0, w in plan.dq_blocks:
            assert bool(dq[:, r, c0:c0 + w].isnan().all())
            dq[:, r, c0:c0 + w] = acc[..., c0:c0 + w] * scale
    assert sorted(order.tolist()) == list(range(nqb))
    assert not bool(dq.isnan().any())
    return dq[:, :tq, :d].transpose(0, 1).to(q.dtype)


@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_dq_walk_matches_plain(name):
    """The dQ kernel's walk on the route its plan names (the forward's
    walk: only the needed 64 x 64 tiles, the Q tiles most needed first) and
    its full-block fast path compute ``_varlen_dq_plain``'s function: dq per row at the
    bf16 gradient tolerance (the walk rounds dS to bf16 as the kernel
    does), and every Q tile with no listed KV tile exactly 0, as the plain
    version gives."""
    case = CARD_CASES[name]
    x = _inputs(case, seed=8)
    q, k, v = (to_torch(x[n], "bfloat16") for n in ("q", "k", "v"))
    do = to_torch(_cotangent(x, seed=9), "bfloat16")
    tq, tk = q.shape[0], k.shape[0]
    causal = case.get("causal", False)
    window = case.get("window", (-1, -1))
    window = (window[0], -1 if causal else window[1])
    alibi = to_torch(x["alibi"])
    kw = dict(scale=q.shape[-1] ** -0.5, causal=causal, softcap=case.get("softcap", 0.0),
              window=window)
    meta = tvar._call_metadata(*(torch.from_numpy(x[n]) for n in ("cu_q", "cu_k")), tq, tk, "cpu")
    o, lse = tvar._varlen_forward_plain(q, k, v, meta, alibi=alibi, **kw)
    if x["sinks"] is not None:
        o, lse = tvar._varlen_apply_sinks(o, lse, to_torch(x["sinks"]))
    delta = tvar._varlen_delta(do, o)
    walk = tvar._walk_schedule(meta, tq, 64, causal, window)
    plan = varlen_dq_plan(q.shape[-1], v.shape[-1])  # the cluster at D1024
    got = _dq_walk(q, k, v, do, lse, delta, tvar._q_tiles(meta, tq, 64), walk[1:], plan,
                   alibi=alibi, **kw)
    want = tvar._varlen_dq_plain(q, k, v, do, lse, delta, meta, alibi=alibi, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert grad_row_rel_err(got, want) < GRAD_TOL["bfloat16"], name
    tiles, count, _ = walk[1:]
    for i in torch.nonzero(count == 0).flatten().tolist():
        assert bool((got[64 * i:64 * i + 64] == 0).all()) and bool(
            (want[64 * i:64 * i + 64] == 0).all()), name
    if name == "cross_causal_empty_rows":
        assert int(count[0]) == 0


def _dkdv_walk(q, k, v, do, lse, delta, meta, schedule, plan, *, scale, causal, softcap=0.0,
               window=(-1, -1), alibi=None):
    """The wgmma dK/dV kernel's walk in plain fp32 PyTorch, one block or
    the cluster of two as ``plan`` says: the KV tiles in the schedule's
    order, each walking the 64-row Q tiles of its [imin, imax] for every
    member of its GQA group. On the cluster rank r computes partial S^T and
    dP^T over its own D and Dv columns (``plan.rank_blocks``) and each rank
    adds the partner's partial to its own: the same two fp32 values, so the
    same sum in both ranks. A 64 x 32 block that ``_dkdv_full_blocks``
    marks full skips the keep-mask, any other selects P to 0 where the mask
    drops the pair; P and dS (softcap's factor included) are rounded to the
    input type; each block of a KV tile (rank by rank, pass by pass:
    ``plan.d_blocks`` / ``plan.dv_blocks``) accumulates its own dK and dV
    columns over the group in fp32 and stores them once, rows past Tk not.
    ``window`` is normalized. (dk, dv) as ``_varlen_dkdv_plain`` returns
    them."""
    imin, imax, order = schedule
    tq, hq, d = q.shape
    tk, hkv, dv = v.shape
    group = hq // hkv
    q_seg, q_rank, k_seg, k_pos = meta
    nq_pad, nkb = q_seg.shape[0], imin.shape[0]

    def rows_of(t, n):  # [T, H, W] -> [H, n, W] fp32, zero rows past T
        out = torch.zeros((t.shape[1], n, t.shape[2]))
        out[:, :t.shape[0]] = t.transpose(0, 1).float()
        return out

    qf, dof = rows_of(q, nq_pad), rows_of(do, nq_pad)
    kf, vf = rows_of(k, nkb * 64), rows_of(v, nkb * 64)
    lsef, deltaf = torch.zeros((hq, nq_pad)), torch.zeros((hq, nq_pad))
    lsef[:, :tq], deltaf[:, :tq] = lse, delta
    full = tvar._dkdv_full_blocks(meta, causal, window, softcap=softcap,
                                  alibi=alibi is not None)  # [KV tiles, 32-column Q blocks]
    ranks = plan.rank_blocks or (((0, d), (0, dv)),)
    dk = torch.full((hkv, nkb * 64, d), float("nan"))
    dvo = torch.full((hkv, nkb * 64, dv), float("nan"))
    for j in order.tolist():
        c = slice(64 * j, 64 * j + 64)
        for kvh in range(hkv):
            acc_k, acc_v = torch.zeros((64, d)), torch.zeros((64, dv))
            for h in range(kvh * group, (kvh + 1) * group):
                for i in range(int(imin[j]), int(imax[j]) + 1):
                    r = slice(64 * i, 64 * i + 64)
                    parts = [(torch.einsum("kd,qd->kq", kf[kvh, c, d0:d0 + nd],
                                           qf[h, r, d0:d0 + nd]),
                              torch.einsum("kd,qd->kq", vf[kvh, c, v0:v0 + nv],
                                           dof[h, r, v0:v0 + nv]))
                             for (d0, nd), (v0, nv) in ranks]
                    if len(parts) == 2:  # own + partner, in either rank
                        (s0, p0), (s1, p1) = parts
                        assert torch.equal(s0 + s1, s1 + s0) and torch.equal(p0 + p1, p1 + p0)
                        st, dpt = s0 + s1, p0 + p1
                    else:
                        st, dpt = parts[0]
                    st = st * scale
                    cap = 1.0
                    if softcap > 0.0:
                        st = softcap * torch.tanh(st / softcap)
                        cap = 1.0 - torch.square(st / softcap)
                    if alibi is not None:
                        dist = (q_rank[None, r] - k_pos[c, None]).abs().float()
                        st = st - alibi[h].float() * dist
                    keep = tvar._varlen_mask(q_seg[None, r], q_rank[None, r], k_seg[c, None],
                                             k_pos[c, None], causal, window[0], window[1])
                    keep = keep | full[j, 2 * i:2 * i + 2].repeat_interleave(32)[None, :]
                    pt = torch.where(keep, torch.exp(st - lsef[h, None, r]), 0.0)
                    dst = pt * (dpt - deltaf[h, None, r]) * cap
                    acc_k += torch.einsum("kq,qd->kd", dst.to(q.dtype).float(), qf[h, r])
                    acc_v += torch.einsum("kq,qd->kd", pt.to(q.dtype).float(), dof[h, r])
            # Each block stores its own columns once.
            for (c0, w), (v0, wv) in zip(plan.d_blocks, plan.dv_blocks):
                assert bool(dk[kvh, c, c0:c0 + w].isnan().all())
                assert bool(dvo[kvh, c, v0:v0 + wv].isnan().all())
                dk[kvh, c, c0:c0 + w] = acc_k[:, c0:c0 + w] * scale
                dvo[kvh, c, v0:v0 + wv] = acc_v[:, v0:v0 + wv]
    assert sorted(order.tolist()) == list(range(nkb))
    assert not bool(dk.isnan().any()) and not bool(dvo.isnan().any())
    return (dk[:, :tk].transpose(0, 1).to(k.dtype), dvo[:, :tk].transpose(0, 1).to(v.dtype))


# The cluster's head dims: D = Dv, D != Dv, a rank without a box of the
# narrow dim; the features that take the element-by-element path.
DKDV_WALK_CASES = {
    "d640": dict(d=640, dv=640, causal=True),
    "d1024_gqa4": dict(d=1024, dv=1024, causal=True, hq=8, hkv=2),
    "d1024_dv320_softcap": dict(d=1024, dv=320, causal=True, softcap=5.0),
    "d64_dv1024_alibi": dict(d=64, dv=1024, causal=True, alibi=True),
    "d1024_dv64_two_sided": dict(d=1024, dv=64, causal=False, window=(24, 24)),
    "d512_one_block": dict(d=512, dv=512, causal=True),
}


@pytest.mark.parametrize("name", sorted(DKDV_WALK_CASES))
def test_dkdv_cluster_walk_matches_plain(name):
    """The dK/dV kernel's walk on the cluster (the rank split, the summed
    partials, the full-block skip, each block's own columns, the GQA sum in
    fp32) and on one block (D512) computes ``_varlen_dkdv_plain``'s function:
    dk and dv per row at the bf16 gradient tolerance, over a packing whose
    Q tiles straddle segments and whose schedule is the backward's own
    (``_backward_schedules``: no saved walk above D512)."""
    case = DKDV_WALK_CASES[name]
    d, dv, hq, hkv = case["d"], case["dv"], case.get("hq", 4), case.get("hkv", 2)
    causal, softcap = case["causal"], case.get("softcap", 0.0)
    window = case.get("window", (-1, -1))
    window = (window[0], -1 if causal else window[1])
    seqs = [40, 72, 9, 100]
    rng = np.random.default_rng(21)
    t = sum(seqs)
    q, do = (to_torch(randn(rng, (t, hq, w)), "bfloat16") for w in (d, dv))
    k, v = (to_torch(randn(rng, (t, hkv, w)), "bfloat16") for w in (d, dv))
    alibi = torch.from_numpy(rng.uniform(0.01, 0.3, (hq,)).astype(np.float32)) \
        if case.get("alibi") else None
    cu = torch.from_numpy(np.cumsum([0] + seqs).astype(np.int32))
    kw = dict(scale=d ** -0.5, causal=causal, softcap=softcap, window=window)
    meta = tvar._call_metadata(cu, cu, t, t, "cpu")
    o, lse = tvar._varlen_forward_plain(q, k, v, meta, alibi=alibi, **kw)
    delta = tvar._varlen_delta(do, o)
    plan = varlen_dkdv_plan(d, dv)
    assert plan.route == ("wgmma" if max(d, dv) <= 512 else "wgmma_cluster")
    sched, _ = tvar._backward_schedules(meta, t, plan, varlen_dq_plan(d, dv), causal, window)
    got = _dkdv_walk(q, k, v, do, lse, delta, meta, sched, plan, alibi=alibi, **kw)
    want = tvar._varlen_dkdv_plain(q, k, v, do, lse, delta, meta, alibi=alibi, **kw)
    for g, w, n in zip(got, want, ("dk", "dv")):
        assert g.dtype == w.dtype and g.shape == w.shape, n
        assert grad_row_rel_err(g, w) < GRAD_TOL["bfloat16"], (name, n)


@pytest.mark.parametrize("name", sorted(DKDV_WALK_CASES))
def test_dq_cluster_walk_matches_plain(name):
    """The dQ kernel's walk on the cluster (the rank split, the summed
    partial S and dP, the full-block skip, each consumer's own columns) and
    on one block (D512) computes ``_varlen_dq_plain``'s function: dq per row
    at the bf16 gradient tolerance, over a packing whose Q tiles straddle
    segments and whose schedule is the backward's own
    (``_backward_schedules``: no saved walk above D512). The cases are the
    dK/dV walk's: D = Dv, D != Dv, a rank without a box of the narrow dim
    and the features that take the element-by-element path."""
    case = DKDV_WALK_CASES[name]
    d, dv, hq, hkv = case["d"], case["dv"], case.get("hq", 4), case.get("hkv", 2)
    causal, softcap = case["causal"], case.get("softcap", 0.0)
    window = case.get("window", (-1, -1))
    window = (window[0], -1 if causal else window[1])
    seqs = [40, 72, 9, 100]
    rng = np.random.default_rng(22)
    t = sum(seqs)
    q, do = (to_torch(randn(rng, (t, hq, w)), "bfloat16") for w in (d, dv))
    k, v = (to_torch(randn(rng, (t, hkv, w)), "bfloat16") for w in (d, dv))
    alibi = torch.from_numpy(rng.uniform(0.01, 0.3, (hq,)).astype(np.float32)) \
        if case.get("alibi") else None
    cu = torch.from_numpy(np.cumsum([0] + seqs).astype(np.int32))
    kw = dict(scale=d ** -0.5, causal=causal, softcap=softcap, window=window)
    meta = tvar._call_metadata(cu, cu, t, t, "cpu")
    o, lse = tvar._varlen_forward_plain(q, k, v, meta, alibi=alibi, **kw)
    delta = tvar._varlen_delta(do, o)
    plan = varlen_dq_plan(d, dv)
    assert plan.route == ("wgmma" if max(d, dv) <= 512 else "wgmma_cluster")
    _, sched = tvar._backward_schedules(meta, t, varlen_dkdv_plan(d, dv), plan, causal, window)
    got = _dq_walk(q, k, v, do, lse, delta, tvar._q_tiles(meta, t, 64), sched, plan,
                   alibi=alibi, **kw)
    want = tvar._varlen_dq_plain(q, k, v, do, lse, delta, meta, alibi=alibi, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert grad_row_rel_err(got, want) < GRAD_TOL["bfloat16"], name


# -- on the card: each kernel against its plain version ----------------------


def _card_backward(x, case, dtype, device, do=None):
    """The forward kernel's (o, lse), sink-inclusive where the case has
    sinks, then ``_varlen_backward`` on the card and its plain version on
    the same tensors."""
    kw = dict(scale=x["q"].shape[-1] ** -0.5, causal=bool(case.get("causal", False)),
              softcap=float(case.get("softcap", 0.0)), window=case.get("window", (-1, -1)))
    q, k, v = (to_torch(x[n], dtype, device) for n in ("q", "k", "v"))
    do = to_torch(_cotangent(x) if do is None else do, dtype, device)
    alibi = to_torch(x["alibi"], device=device)
    cu_q, cu_k = (torch.from_numpy(x[n]).to(device) for n in ("cu_q", "cu_k"))
    meta = tvar._call_metadata(cu_q, cu_k, q.shape[0], k.shape[0], device)
    o, lse = tvar._varlen_forward(q, k, v, cu_q, cu_k, alibi=alibi, meta=meta, **kw)
    if x["sinks"] is not None:
        o, lse = tvar._varlen_apply_sinks(o, lse, to_torch(x["sinks"], device=device))
    counts = (tvar._varlen_backward.dkdv_launches, tvar._varlen_backward.dq_launches)
    got = tvar._varlen_backward(q, k, v, o, lse, do, meta, alibi=alibi, **kw)
    torch.cuda.synchronize()
    assert (tvar._varlen_backward.dkdv_launches, tvar._varlen_backward.dq_launches) == (
        counts[0] + 1, counts[1] + 1)
    want = tvar._varlen_backward_plain(q, k, v, o, lse, do, meta, alibi=alibi, **kw)
    return got, want


@pytest.mark.parametrize("name", sorted(CARD_CASES))
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_varlen_backward_kernels_match_plain_on_card(cuda, name, dtype):
    case = CARD_CASES[name]
    x = _inputs(case, seed=5)
    got, want = _card_backward(x, case, dtype, cuda)
    for g, w, n in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == w.dtype and g.shape == w.shape, n
        assert bool(torch.isfinite(g).all()), (name, n)
        assert grad_row_rel_err(g, w) < GRAD_TOL[dtype], (name, n)


@pytest.mark.parametrize("name", sorted(CARD_CASES))
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_saved_schedule_gives_the_fresh_gradients_on_card(cuda, name, dtype):
    """``torch.autograd.grad`` through ``ffpa_attn_varlen_func`` (the
    backward on the forward's saved schedule) gives bit for bit the
    gradients of ``_varlen_backward`` with its schedules computed afresh,
    on the same inputs."""
    case = CARD_CASES[name]
    x = _inputs(case, seed=5)
    do = _cotangent(x)
    got = _torch_grads(x, case, do, dtype, device=cuda)[:3]
    fresh, _ = _card_backward(x, case, dtype, cuda, do=do)
    for g, w, n in zip(got, fresh, ("dq", "dk", "dv")):
        assert torch.equal(g, w), (name, n)


def test_varlen_backward_strided_and_expanded_on_card(cuda):
    """q read through its strides and an expanded (stride-0) cotangent, as
    ``o.float().sum().backward()`` hands it: the same gradients as the
    contiguous inputs with an explicit ones cotangent."""
    case = dict(seqs=[100, 60], hq=2, hkv=2, causal=True, d=512)
    x = _inputs(case, seed=6)
    cu = torch.from_numpy(x["cu_q"]).to(cuda)
    wide = to_torch(np.concatenate([x["q"], x["q"]], axis=1), "bfloat16", cuda)
    grads = []
    for q in (wide[:, :2], wide[:, :2].contiguous()):
        leaves = [q.detach().requires_grad_()] + [
            to_torch(x[n], "bfloat16", cuda).requires_grad_() for n in ("k", "v")]
        out = ffpa_attn_varlen_func(*leaves, cu, cu, 100, 100, causal=True)
        if len(grads) == 0:
            out.float().sum().backward()
        else:
            out.backward(torch.ones_like(out))
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    for g, w in zip(*grads):
        assert torch.equal(g, w)
