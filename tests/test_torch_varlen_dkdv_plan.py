"""The route and tiling of the packed varlen dK/dV kernel (``ops/config.py``
``varlen_dkdv_plan``, the mirror of ``csrc/varlen_bwd.cu``
``tma::make_plan``), the dispatch that takes its passes, the schedule at
its tiles and the wgmma consumer's full-block test.

The plan is the dense ``dkdv_plan`` at every width: D and Dv up to 512 take
the TMA + wgmma block (64 KV rows, 64-row Q tiles, column passes of at
most 256 columns of dK and of dV in whole 64-column boxes, in the card's
shared memory); wider heads, up to 1024, a cluster of two such blocks whose
ranks each hold half of D's and of Dv's boxes (rank 0 the larger half), the
same passes over a rank's half. A consumer block of
64 KV rows x 32 Q columns that ``varlen._dkdv_full_blocks`` marks full
skips the keep-mask on the card, so every pair in it must be kept
(``varlen._varlen_mask``). On a card the mirror is held equal to the plan
the library launches with, and the kernel against ``_varlen_dkdv_plain``
per row at bf16 5e-2 / fp16 1e-2 (``tests/test_ffpa_bwd.py:19``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_parity import cuda, grad_row_rel_err  # noqa: F401
from ffpa_attn_tpu_torch.ops import varlen as tvar
from ffpa_attn_tpu_torch.ops.config import (
    D_CHUNK,
    SMEM_LIMIT_BYTES,
    cdiv,
    dkdv_plan,
    varlen_dkdv_plan,
    varlen_dq_plan,
)
from ffpa_attn_tpu_torch.ops.dispatch import pick_varlen_backward_config

WGMMA_MAX_D = 512
PASS_MAX_COLS = 256  # 64 rows x 256 columns x 2 fp32 tiles: 128 registers a thread
# D, Dv over 64..512 in 64-column boxes, wider heads, D != Dv and a width
# that pads.
HEAD_DIMS = [(d, d) for d in range(64, 1025, 64)] + [
    (512, 320), (320, 512), (512, 64), (64, 512), (448, 64), (512, 1024), (1024, 320),
    (400, 400),
]
GRAD_TOL = {torch.bfloat16: 5e-2, torch.float16: 1e-2}


def _tiles(blocks, width):
    """The (first column, width) blocks cover [0, width) in order."""
    start = 0
    for c0, w in blocks:
        assert c0 == start and w % D_CHUNK == 0
        start += w
    return start == width


@pytest.mark.parametrize("d,dv", HEAD_DIMS)
def test_varlen_dkdv_plan_routes_by_head_dims(d, dv):
    plan = varlen_dkdv_plan(d, dv)
    d_pad, dv_pad = cdiv(d, D_CHUNK) * D_CHUNK, cdiv(dv, D_CHUNK) * D_CHUNK
    wide = max(d_pad, dv_pad) > WGMMA_MAX_D
    assert plan.route == ("wgmma_cluster" if wide else "wgmma")
    ranks = 2 if wide else 1
    assert len(plan.d_blocks) == len(plan.dv_blocks) == ranks * plan.passes
    assert _tiles(plan.d_blocks, d_pad) and _tiles(plan.dv_blocks, dv_pad)
    assert plan.smem_bytes <= SMEM_LIMIT_BYTES
    assert (plan.kv_rows, plan.q_rows) == (64, 64) and plan.stages >= 3
    # A block's passes: its boxes (a rank's half on the cluster) in passes
    # of at most 256 columns.
    widest = (max(plan.rank_blocks[0][0][1], plan.rank_blocks[0][1][1]) if wide
              else max(d_pad, dv_pad))
    assert plan.passes == cdiv(widest, PASS_MAX_COLS)
    for r in range(ranks):
        for blocks in (plan.d_blocks, plan.dv_blocks):
            widths = [w for _, w in blocks[r * plan.passes:(r + 1) * plan.passes]]
            assert max(widths) <= PASS_MAX_COLS
            assert max(widths) - min(widths) <= D_CHUNK  # as even as boxes allow
    assert varlen_dkdv_plan(d_pad, dv_pad) == plan


@pytest.mark.parametrize("d,dv", HEAD_DIMS)
def test_varlen_dkdv_plan_is_the_dense_plan(d, dv):
    """The packed dK/dV block is the dense block's tiling at every width:
    its segment metadata and schedule live in device memory and cost no
    shared memory."""
    assert varlen_dkdv_plan(d, dv) == dkdv_plan(d, dv)
    assert varlen_dkdv_plan(d, dv, 2) == dkdv_plan(d, dv, 2)


def test_varlen_dkdv_cluster_at_d1024_holds_three_stages():
    """A rank's K and V halves (16 boxes), the P and dS boxes, one 32 KB
    exchange slot and 3 stages of 16,400 B, within the card's 232,448 B."""
    plan = varlen_dkdv_plan(1024, 1024)
    assert plan.route == "wgmma_cluster" and plan.passes == 2 and plan.stages == 3
    assert plan.smem_bytes == 181_288 + 3 * 16_400 <= SMEM_LIMIT_BYTES
    assert plan.rank_blocks == (((0, 512), (0, 512)), ((512, 512), (512, 512)))
    assert plan.d_blocks == plan.dv_blocks == ((0, 256), (256, 256), (512, 256), (768, 256))


@pytest.mark.parametrize("d,dv", [hd for hd in HEAD_DIMS if max(hd) > WGMMA_MAX_D]
                         + [(64, 1024), (1024, 64)])
def test_varlen_dkdv_cluster_ranks_take_their_halves(d, dv):
    """Each rank holds its half of D's and of Dv's boxes, rank 0 the larger
    (a 64 / 1024 pair leaves rank 1 without a box of the narrow dim); the
    two halves tile the head dims in order, and each rank's passes tile its
    own half."""
    plan = varlen_dkdv_plan(d, dv)
    d_pad, dv_pad = cdiv(d, D_CHUNK) * D_CHUNK, cdiv(dv, D_CHUNK) * D_CHUNK
    assert plan.route == "wgmma_cluster"
    (d0, v0), (d1, v1) = plan.rank_blocks
    assert _tiles((d0, d1), d_pad) and _tiles((v0, v1), dv_pad)
    for first, second in ((d0, d1), (v0, v1)):
        assert 0 <= first[1] - second[1] <= D_CHUNK
    if min(d, dv) == 64:
        assert min(d1[1], v1[1]) == 0
    for r, (dr, vr) in enumerate(plan.rank_blocks):
        own = slice(r * plan.passes, (r + 1) * plan.passes)
        for (c0, width), blocks in ((dr, plan.d_blocks[own]), (vr, plan.dv_blocks[own])):
            assert blocks[0][0] == c0 and sum(w for _, w in blocks) == width


def test_varlen_dkdv_plan_d448_takes_passes_of_256_and_192():
    plan = varlen_dkdv_plan(448, 448)
    assert plan.route == "wgmma" and plan.passes == 2
    assert plan.d_blocks == plan.dv_blocks == ((0, 256), (256, 192))


@pytest.mark.parametrize("d,dv", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_pick_varlen_backward_config_takes_the_plans_passes(d, dv, dtype):
    cfg = pick_varlen_backward_config(d=cdiv(d, D_CHUNK) * D_CHUNK,
                                      dv=cdiv(dv, D_CHUNK) * D_CHUNK, dtype=dtype)
    assert cfg.dkdv_col_passes == varlen_dkdv_plan(d, dv).passes


# Packings that exercise the full-block test's edges: a tile straddling
# three segments, length-0 segments, a padded tail (the pseudo-segment) and
# tail-aligned cross keys.
PACKINGS = {
    "straddle_three": dict(q=[20, 9, 50, 3, 300]),
    "empty_and_tail": dict(q=[70, 0, 130, 1, 99], pad=30),
    "cross_keys": dict(q=[100, 60, 200], k=[300, 60, 260]),
    "long_segments": dict(q=[256, 512, 128]),
}


def _meta(packing):
    seqs = packing["q"]
    seqs_k = packing.get("k", seqs)
    pad = packing.get("pad", 0)
    cu_q = torch.from_numpy(np.cumsum([0] + seqs).astype(np.int32))
    cu_k = torch.from_numpy(np.cumsum([0] + seqs_k).astype(np.int32))
    return tvar._call_metadata(cu_q, cu_k, sum(seqs) + pad, sum(seqs_k) + pad, "cpu")


@pytest.mark.parametrize("name", sorted(PACKINGS))
@pytest.mark.parametrize("causal,window", [
    (True, (-1, -1)), (False, (-1, -1)), (True, (32, -1)), (False, (-1, 40)), (False, (24, 24)),
])
def test_full_blocks_keep_every_pair(name, causal, window):
    """Every 64 x 32 block the full-block test marks full has every pair
    kept by the keep-mask; without a left window, causal packings with long
    segments have full blocks, and a left window has none."""
    meta = _meta(PACKINGS[name])
    wnorm = (window[0], -1 if causal else window[1])
    full = tvar._dkdv_full_blocks(meta, causal, wnorm)
    q_seg, q_rank, k_seg, k_pos = meta
    keep = tvar._varlen_mask(q_seg[None, :], q_rank[None, :], k_seg[:, None], k_pos[:, None],
                             causal, *wnorm)  # [kv, q]
    nkb, nqc = full.shape
    assert (nkb * 64, nqc * 32) == tuple(keep.shape)
    blocks_kept = keep.reshape(nkb, 64, nqc, 32).all(dim=3).all(dim=1)
    assert not bool((full & ~blocks_kept).any())
    if wnorm[0] >= 0:
        assert not bool(full.any())
    elif name == "long_segments":
        assert int(full.sum()) > 0


def test_full_blocks_off_under_features():
    meta = _meta(PACKINGS["long_segments"])
    assert int(tvar._dkdv_full_blocks(meta, True).sum()) > 0
    assert not bool(tvar._dkdv_full_blocks(meta, True, softcap=30.0).any())
    assert not bool(tvar._dkdv_full_blocks(meta, True, alibi=True).any())


# -- on the card ---------------------------------------------------------------


@pytest.mark.parametrize("d,dv", HEAD_DIMS)
def test_varlen_dkdv_plan_matches_library_on_card(cuda, d, dv):  # noqa: F811
    assert tvar.varlen_dkdv_kernel_plan(d, dv) == varlen_dkdv_plan(d, dv)


@pytest.mark.parametrize("route", ["wgmma", "wgmma_cluster"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_varlen_dkdv_kernel_spills_nothing_on_card(cuda, route, dtype):  # noqa: F811
    attrs = tvar.varlen_dkdv_kernel_attrs(route, dtype)
    assert attrs["local_bytes"] == 0 and attrs["registers"] > 0


CARD_CASES = {
    "d512_dv320": dict(seqs=[300, 17, 500], d=512, dv=320),
    "d320_dv512": dict(seqs=[300, 17, 500], d=320, dv=512),
    "fp16": dict(seqs=[300, 17, 500], d=512, dv=512, dtype=torch.float16),
    "tile_straddles_3_segs": dict(seqs=[20, 9, 50, 3, 300], d=512, dv=512),
    # The cluster of two blocks above D512: an odd box count (rank 0 five
    # of D576's nine boxes), a rank without a box of the narrow dim, fp16.
    "d576_cluster": dict(seqs=[300, 17, 500], d=576, dv=576),
    "d1024_cluster": dict(seqs=[300, 17, 500], d=1024, dv=1024),
    "d1024_cluster_fp16": dict(seqs=[300, 17, 500], d=1024, dv=1024, dtype=torch.float16),
    "d64_dv1024": dict(seqs=[300, 17, 500], d=64, dv=1024),
    "d1024_dv64": dict(seqs=[300, 17, 500], d=1024, dv=64),
    "d1024_straddles_3_segs": dict(seqs=[20, 9, 50, 3, 300], d=1024, dv=1024),
}


@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_varlen_dkdv_kernel_matches_plain_on_card(cuda, name):  # noqa: F811
    """The dK/dV kernel alone, on the plain forward's (o, lse), against
    ``_varlen_dkdv_plain`` per row; the schedule at the plan's tiles."""
    case = CARD_CASES[name]
    dtype = case.get("dtype", torch.bfloat16)
    d, dv, hq, hkv = case["d"], case["dv"], 8, 4
    t = sum(case["seqs"])
    gen = torch.Generator(device=cuda).manual_seed(13)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    q, k, v, do = randn(t, hq, d), randn(t, hkv, d), randn(t, hkv, dv), randn(t, hq, dv)
    cu = torch.tensor(np.cumsum([0] + case["seqs"]), dtype=torch.int32, device=cuda)
    kw = dict(scale=d ** -0.5, causal=True, softcap=0.0, window=(-1, -1))
    meta = tvar._call_metadata(cu, cu, t, t, cuda)
    o, lse = tvar._varlen_forward_plain(q, k, v, meta, scale=kw["scale"], causal=True)
    delta = tvar._varlen_delta(do, o)
    cfg = pick_varlen_backward_config(d=d, dv=dv, dtype=dtype)
    plan = varlen_dkdv_plan(d, dv)
    sched, _ = tvar._backward_schedules(meta, t, plan, varlen_dq_plan(d, dv), True, (-1, -1))
    ops = tvar._BwdOperands(q, k, v, do, lse, delta, None)
    n0 = tvar._varlen_backward.dkdv_launches
    got = tvar._varlen_dkdv_kernel(ops, meta, sched, cfg, **kw)
    torch.cuda.synchronize()
    assert tvar._varlen_backward.dkdv_launches == n0 + 1
    want = tvar._varlen_dkdv_plain(q, k, v, do, lse, delta, meta, **kw)
    for g, w, n in zip(got, want, ("dk", "dv")):
        assert g.shape == w.shape and g.dtype == w.dtype, n
        assert bool(torch.isfinite(g).all()), n
        assert grad_row_rel_err(g, w) < GRAD_TOL[dtype], (name, n)
