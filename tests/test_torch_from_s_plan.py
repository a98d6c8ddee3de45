"""The route and tiling of the from-S dK/dV kernel (``ops/config.py``
``from_s_plan``, the mirror of ``csrc/flash_bwd.cu`` ``from_s::make_plan``)
and, on a card, that kernel against its plain version.

dK out of the kernel at Dv up to 512 takes the TMA + wgmma block: 64 KV
rows, 64-row Q tiles, a ring of two-box stages that holds at least one
whole tile (its S box and its dO boxes) in the card's shared memory. Dv in
(512, 1024] takes a cluster of two such blocks, rank r holding its half of
Dv's boxes (rank 0 the larger) and the two exchanging partial dP^T through
two slots. dK in the kernel takes the mma.sync block (32 KV rows, 128-row
Q tiles). ``from_s_fits`` reads the plan. On a card the mirror is held
equal to the plan the library launches with, neither wgmma route spills,
and each route's outputs (dV, the dS written over the slab, and banded dK
on that slab) are held against the plain versions on the same inputs, per
row at the bf16 gradient tolerance 5e-2 with the 1e-3 floor
(``grad_row_rel_err``; tests/test_ffpa_bwd.py:19).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from _torch_parity import cuda, grad_row_rel_err, randn, to_torch  # noqa: F401
from ffpa_attn_tpu_torch.ops import flash_bwd as tbwd
from ffpa_attn_tpu_torch.ops import flash_fwd as tfwd
from ffpa_attn_tpu_torch.ops.config import (
    D_CHUNK,
    DKDV_MAX_COLS,
    FROM_S_MAX_DV,
    SMEM_LIMIT_BYTES,
    cdiv,
    from_s_fits,
    from_s_plan,
)
from ffpa_attn_tpu_torch.ops.dispatch import pick_backward_config

GRAD_TOL = 5e-2
WGMMA_MAX_DV = 512  # one consumer's half of dV, 64 x 256 fp32: 128 registers a thread
DVS = list(range(64, 1025, 64))
CLUSTER_DVS = [dv for dv in DVS if dv > WGMMA_MAX_DV]


def _route(dv, dk_in):
    if dk_in:
        return "mma_sync"
    return "wgmma" if dv <= WGMMA_MAX_DV else "wgmma_cluster"


@pytest.mark.parametrize("dk_in", [False, True])
@pytest.mark.parametrize("dv", DVS)
def test_from_s_plan_routes_by_dv_and_dk_in(dv, dk_in):
    plan = from_s_plan(dv, dk_in)
    nv = cdiv(dv, D_CHUNK)
    assert plan.route == _route(dv, dk_in)
    assert plan.stages >= 2 and plan.smem_bytes <= SMEM_LIMIT_BYTES
    start = 0
    for c0, w in plan.dv_blocks:  # the consumers' dV columns tile [0, Dv) in order
        assert c0 == start and w % D_CHUNK == 0
        start += w
    assert start == nv * D_CHUNK
    if plan.route == "wgmma":
        assert (plan.kv_rows, plan.q_rows) == (64, 64) and plan.rank_blocks == ()
        assert len(plan.dv_blocks) == 2 and plan.dv_blocks[0][1] == cdiv(nv, 2) * D_CHUNK
        assert plan.stages >= 1 + cdiv(nv, 2)  # a whole tile (S + dO stages) fits the ring
    elif plan.route == "wgmma_cluster":
        assert (plan.kv_rows, plan.q_rows) == (64, 64) and len(plan.rank_blocks) == 2
        assert len(plan.dv_blocks) == 4  # two consumers a rank
        assert plan.dv_blocks[0][1] + plan.dv_blocks[1][1] == plan.rank_blocks[0][1]
    else:
        assert (plan.kv_rows, plan.q_rows, plan.stages) == (32, 128, 4)
        assert plan.dv_blocks == ((0, dv),)
    fits = dv <= (DKDV_MAX_COLS if dk_in else FROM_S_MAX_DV)
    assert from_s_fits(dv, dv, dk_in) == fits
    assert from_s_plan(dv - 8, dk_in) == plan  # padded to 64-column boxes


@pytest.mark.parametrize("dv", CLUSTER_DVS)
def test_from_s_cluster_plan_splits_dv_across_ranks(dv):
    """Above Dv 512 the ranks' Dv blocks tile [0, Dv) in order, rank 0 the
    larger by at most a box and neither above 512 columns; each rank's two
    consumers split its block the same way (4 boxes at most: 128 fp32
    registers a thread); a whole tile (the S box, then ceil(n / 2) dO
    stages for rank 0's n boxes) fits the ring, and the block, the
    exchange's two 32 KB slots included, fits the card."""
    plan = from_s_plan(dv, False)
    (r0, w0), (r1, w1) = plan.rank_blocks
    assert (r0, r1, w0 + w1) == (0, w0, dv)
    assert 0 <= w0 - w1 <= D_CHUNK and w0 <= WGMMA_MAX_DV
    for r, (c0, w) in enumerate(plan.rank_blocks):
        (a0, aw), (b0, bw) = plan.dv_blocks[2 * r:2 * r + 2]
        assert (a0, b0, aw + bw) == (c0, c0 + aw, w)
        assert 0 <= aw - bw <= D_CHUNK and aw <= WGMMA_MAX_DV // 2
    assert plan.stages >= 1 + cdiv(w0 // D_CHUNK, 2)
    box = 64 * 64 * 2
    fixed = (w0 // D_CHUNK + 2) * box + 1024 + 8 + 2 * 2 * 64 * 32 * 4 + 4 * 8
    assert plan.smem_bytes == fixed + plan.stages * (2 * box + 16) <= SMEM_LIMIT_BYTES
    assert SMEM_LIMIT_BYTES - plan.smem_bytes < 2 * box + 16 or plan.stages == 12
    assert from_s_fits(dv, dv, False) and not from_s_fits(dv, dv, True)


def test_from_s_plan_d512_holds_almost_two_tiles():
    """At the training shape's Dv 512 a tile is 5 stages (the S box alone,
    then 4 pairs of dO boxes); 9 fit beside V and the P and dS boxes."""
    plan = from_s_plan(512, False)
    assert plan.stages == 9 and plan.dv_blocks == ((0, 256), (256, 256))
    assert SMEM_LIMIT_BYTES - plan.smem_bytes < 2 * 64 * 64 * 2 + 16  # no room for a 10th


@pytest.mark.parametrize("d,dv,dk_in", [(512, 512, True), (512, 512, False), (320, 1024, False),
                                        (1024, 1024, True), (576, 512, True)])
def test_fit_blocks_to_scores_reads_the_plan(d, dv, dk_in):
    """dK stays in the kernel only where ``from_s_fits`` (the plan's block
    and one column pass) holds; dK out takes every Dv up to 1024."""
    cfg = dataclasses.replace(pick_backward_config(d=d, dv=dv, nq=256, nkv=256,
                                                   dtype=torch.bfloat16), dkdv_dk_in_kernel=dk_in)
    got = tbwd._fit_blocks_to_scores(cfg, 256, 256, d, dv, torch.bfloat16)
    assert got.dkdv_dk_in_kernel == (dk_in and from_s_fits(d, dv, True))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dk_in", [False, True])
@pytest.mark.parametrize("dv", DVS)
def test_from_s_plan_matches_library_on_card(cuda, dv, dk_in):  # noqa: F811
    assert tbwd.from_s_kernel_plan(dv, dk_in) == from_s_plan(dv, dk_in)


def test_wgmma_from_s_kernel_spills_nothing_on_card(cuda):  # noqa: F811
    assert tbwd.from_s_kernel_attrs("wgmma")["local_bytes"] == 0


def test_cluster_from_s_kernel_spills_nothing_on_card(cuda):  # noqa: F811
    assert tbwd.from_s_kernel_attrs("wgmma_cluster")["local_bytes"] == 0


# Each case: head dims (D = Dv unless dv is given), GQA group, shape and the
# features the from-S pass replays; nan_fill sets everything of the S
# residual outside the band to NaN first. dK out of the kernel takes the
# wgmma block at Dv <= 512 and its cluster above; dK in, asked where it
# does not fit, falls back to dK out as the backward does.
CARD_CASES = {
    "dv64_group1": dict(d=64, hq=2, hkv=2, nq=200, nkv=200, causal=True),
    "dv128_group2": dict(d=128, hq=4, hkv=2, nq=130, nkv=150, causal=True),
    "dv320_group4_nq_ne_nkv": dict(d=320, hq=8, hkv=2, nq=150, nkv=300, causal=True),
    "dv448_noncausal": dict(d=448, hq=4, hkv=2, nq=100, nkv=230, causal=False),
    "dv512_dropout": dict(d=512, hq=4, hkv=2, nq=200, nkv=200, causal=True, dropout=0.2),
    "dv512_softcap": dict(d=512, hq=4, hkv=2, nq=130, nkv=150, causal=True, softcap=5.0),
    "dv512_rows32": dict(d=512, hq=4, hkv=2, nq=20, nkv=140, causal=True),
    "dv512_batch2": dict(d=512, b=2, hq=2, hkv=1, nq=256, nkv=320, causal=True),
    # The cluster (Dv > 512).
    "dv576_odd_boxes": dict(d=576, hq=4, hkv=2, nq=200, nkv=200, causal=True),
    "dv640_group2": dict(d=640, hq=4, hkv=2, nq=256, nkv=256, causal=True),
    "dv1024_group4_nq_ne_nkv": dict(d=1024, hq=8, hkv=2, nq=150, nkv=300, causal=True),
    "d64_dv1024": dict(d=64, dv=1024, hq=4, hkv=2, nq=130, nkv=150, causal=True),
    "d512_dv1024_noncausal": dict(d=512, dv=1024, hq=2, hkv=1, nq=100, nkv=230, causal=False),
    "dv1024_dropout": dict(d=1024, hq=4, hkv=2, nq=200, nkv=200, causal=True, dropout=0.2),
    "dv1024_softcap": dict(d=1024, hq=4, hkv=2, nq=130, nkv=150, causal=True, softcap=5.0),
    "dv1024_rows32": dict(d=1024, hq=4, hkv=2, nq=20, nkv=140, causal=True),
    "dv640_nan_filled_slab": dict(d=640, hq=4, hkv=2, nq=150, nkv=230, causal=True,
                                  nan_fill=True),
    # Many Q tiles a block (8 a head, 4 heads a group): a race between rank
    # 0's dS stores and rank 1's read of the same S tile would show as wrong
    # P in rank 1, so in dV's upper columns.
    "dv1024_many_q_tiles": dict(d=1024, hq=8, hkv=2, nq=512, nkv=512, causal=True),
}


def _card_inputs(case, device):
    rng = np.random.default_rng(11)
    b, hq, hkv, d = case.get("b", 1), case["hq"], case["hkv"], case["d"]
    dv, nq, nkv = case.get("dv", d), case["nq"], case["nkv"]
    return {n: to_torch(randn(rng, shape), "bfloat16", device) for n, shape in (
        ("q", (b, hq, nq, d)), ("k", (b, hkv, nkv, d)), ("v", (b, hkv, nkv, dv)),
        ("do", (b, hq, nq, dv)))}


@pytest.mark.parametrize("dk_in", [False, True])
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_from_s_kernel_on_card_matches_plain(cuda, name, dk_in):  # noqa: F811
    """The forward kernel's S residual (with its unwritten tiles above the
    band) goes to the kernel and, copied to the CPU, to the plain version:
    dV, the dS slab and (dK in the kernel) dK are held per row; under
    causal, banded dK on the kernel's slab against the plain product on
    the same slab."""
    case = CARD_CASES[name]
    x = _card_inputs(case, cuda)
    nq, nkv, d = case["nq"], case["nkv"], case["d"]
    dv = case.get("dv", d)
    group = case["hq"] // case["hkv"]
    kw = dict(scale=1.0 / math.sqrt(d), is_causal=case["causal"],
              dropout_p=case.get("dropout", 0.0), softcap=case.get("softcap", 0.0))
    o, lse, s = tfwd.flash_attention_forward(x["q"], x["k"], x["v"], None, return_scores=True,
                                             dropout_seed=3, **kw)
    if case["nq"] <= 32:
        assert s.shape[2] == 32  # the forward's 32-row slab
    if case.get("nan_fill"):
        rows = torch.arange(s.shape[2], device=cuda)[:, None]
        cols = torch.arange(s.shape[3], device=cuda)[None, :]
        band = (rows < nq) & (cols < nkv)
        if case["causal"]:
            band &= cols <= rows + nkv - nq
        s.masked_fill_(~band, float("nan"))
    delta = (x["do"].float() * o.float()).sum(-1)
    cfg = dataclasses.replace(pick_backward_config(d=d, dv=dv, nq=nq, nkv=nkv,
                                                   dtype=torch.bfloat16), dkdv_dk_in_kernel=dk_in)
    cfg = tbwd._fit_blocks_to_scores(cfg, s.shape[2], s.shape[3], d, dv, torch.bfloat16)
    assert cfg.dkdv_dk_in_kernel == (dk_in and from_s_fits(d, dv, True))
    route = from_s_plan(dv, cfg.dkdv_dk_in_kernel).route
    assert route == ("mma_sync" if cfg.dkdv_dk_in_kernel else
                     "wgmma" if dv <= WGMMA_MAX_DV else "wgmma_cluster")
    fkw = dict(scale=kw["scale"], is_causal=kw["is_causal"], causal_offset=nkv - nq,
               dropout_p=kw["dropout_p"], softcap=kw["softcap"])
    cpu = {n: t.cpu() for n, t in dict(q=x["q"], v=x["v"], do=x["do"], lse=lse, delta=delta,
                                       s=s).items()}
    before = tbwd._dkdv_from_s_launch.launches
    kdk, kdv, kds = tbwd._dkdv_from_s_launch(
        x["q"], x["v"], s.clone(), x["do"], lse, delta, 3, cfg, group=group,
        grad_kv_storage_dtype=None, **fkw)
    torch.cuda.synchronize()
    assert tbwd._dkdv_from_s_launch.launches == before + 1
    pdk, pdv, pds = tbwd._dkdv_from_s_launch(
        cpu["q"], cpu["v"], cpu["s"].clone(), cpu["do"], cpu["lse"], cpu["delta"], 3, cfg,
        group=group, grad_kv_storage_dtype=None, **fkw)
    assert torch.isfinite(kds.float()).all()
    assert grad_row_rel_err(kdv, pdv) < GRAD_TOL, "dv"
    assert grad_row_rel_err(kds, pds) < GRAD_TOL, "ds"
    assert not kds[:, :, nq:].any() and not kds[:, :, :, nkv:].any()  # padding: zeros
    assert (kdk is None) == (pdk is None) == (not cfg.dkdv_dk_in_kernel)
    if cfg.dkdv_dk_in_kernel:
        assert grad_row_rel_err(kdk, pdk) < GRAD_TOL, "dk"
    if case["causal"]:
        bkw = dict(scale=kw["scale"], group=group, nq=nq, nkv=nkv, causal_offset=nkv - nq,
                   dk_dtype=torch.bfloat16)
        got = tbwd._banded_dk_from_ds(kds, x["q"], None, **bkw)
        torch.cuda.synchronize()
        want = tbwd._banded_dk_from_ds(kds.cpu(), cpu["q"], None, **bkw)
        assert grad_row_rel_err(got, want) < GRAD_TOL, "banded dk"
