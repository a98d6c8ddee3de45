"""The route and tiling of the packed varlen forward (``ops/config.py``
``varlen_fwd_plan``, the mirror of ``csrc/varlen_fwd.cu`` ``tma::make_plan``),
the row tiles the dispatch accepts, the schedule at the route's tiles and
the wgmma consumer's full-block test.

The plan is the dense forward's (``fwd_plan``) at every width: D and Dv up
to 512 take one TMA + wgmma block, wider heads up to 1024 a cluster of two
such blocks splitting D and Dv ("wgmma_cluster"). Both walk 64 Q rows
whatever ``block_q`` asks, only the KV tiles ``_tile_needed`` marks needed
(``_needed_tiles``), the Q tiles most needed first. A consumer block of 64
Q rows x 32 KV columns that ``varlen._full_blocks`` marks full skips the
keep-mask on the card, so every pair in it must be kept
(``varlen._varlen_mask``). On a card the mirror is held equal to the plan the
library launches with, neither route spills in either dtype, and the kernel
matches ``_varlen_forward_plain`` per row at bf16 2e-2 / fp16 1e-2
(tests/test_features.py:127), lse at 1e-4 of max|lse| over the rows that keep
a key (fp32 math on identical inputs), at D != Dv and above D512 (D576's odd
box count, a rank without a D box at D64 / Dv1024 and without a Dv box at
D1024 / Dv64).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from _torch_parity import cuda, row_rel_err  # noqa: F401
from ffpa_attn_tpu_torch.ops import varlen as tvar
from ffpa_attn_tpu_torch.ops.config import (
    D_CHUNK,
    FWD_ROW_TILES,
    SMEM_LIMIT_BYTES,
    BlockConfig,
    cdiv,
    fwd_plan,
    varlen_fits,
    varlen_fwd_plan,
)
from ffpa_attn_tpu_torch.ops.dispatch import pick_varlen_config
from ffpa_attn_tpu_torch.ops.reference import DEFAULT_MASK_VALUE

WGMMA_MAX_D = 512
# D, Dv over 64..1024 in 64-column boxes, odd box counts, D != Dv both ways
# and widths that pad.
HEAD_DIMS = [(d, d) for d in range(64, 1025, 64)] + [
    (512, 320), (320, 512), (512, 64), (64, 512), (448, 64), (512, 1024), (1024, 320),
    (400, 400),
]
TOL = {torch.bfloat16: 2e-2, torch.float16: 1e-2}
LSE_TOL = 1e-4


@pytest.mark.parametrize("d,dv", HEAD_DIMS)
def test_varlen_fwd_plan_routes_by_head_dims(d, dv):
    """The dense forward's plan at every width (its metadata and lists cost
    no shared memory): one block of 8 stages at D, Dv <= 512, the cluster
    of 7 above, rank r holding its half of D's and Dv's boxes (rank 0 the
    larger), each rank's consumers half of its Dv boxes."""
    plan = varlen_fwd_plan(d, dv)
    d_pad, dv_pad = cdiv(d, D_CHUNK) * D_CHUNK, cdiv(dv, D_CHUNK) * D_CHUNK
    wide = max(d_pad, dv_pad) > WGMMA_MAX_D
    assert plan == fwd_plan(d, dv)
    assert plan.route == ("wgmma_cluster" if wide else "wgmma")
    assert (plan.q_rows, plan.kv_rows, plan.stages) == (64, 64, 7 if wide else 8)
    assert plan.smem_bytes <= SMEM_LIMIT_BYTES
    start = 0
    for c0, w in plan.o_blocks:  # the O column blocks cover [0, Dv) in order
        assert c0 == start and w % D_CHUNK == 0
        start += w
    assert start == dv_pad
    if wide:
        (d0, dw0), (v0, vw0) = plan.rank_blocks[0]
        (d1, dw1), (v1, vw1) = plan.rank_blocks[1]
        assert (d0, v0, d1, v1) == (0, 0, dw0, vw0)
        assert dw0 + dw1 == d_pad and vw0 + vw1 == dv_pad
        assert 0 <= dw0 - dw1 <= D_CHUNK and 0 <= vw0 - vw1 <= D_CHUNK
        halves = [(v0, vw0), (v1, vw1)]
    else:
        assert plan.rank_blocks == ()
        halves = [(0, dv_pad)]
    want = []
    for v0, vw in halves:
        nv = vw // D_CHUNK
        want += [(v0, cdiv(nv, 2) * D_CHUNK), (v0 + cdiv(nv, 2) * D_CHUNK, nv // 2 * D_CHUNK)]
    assert list(plan.o_blocks) == want
    assert varlen_fwd_plan(d_pad, dv_pad) == plan


@pytest.mark.parametrize("d,dv", HEAD_DIMS)
@pytest.mark.parametrize("bq", FWD_ROW_TILES)
def test_varlen_fits_takes_the_routes_block(d, dv, bq):
    """Every row tile is accepted at every width (both routes take their own
    64 rows), the plan's block fitting shared memory; the dispatch picks
    the taller tile."""
    d_pad, dv_pad = cdiv(d, D_CHUNK) * D_CHUNK, cdiv(dv, D_CHUNK) * D_CHUNK
    cfg = BlockConfig(block_q=bq)
    assert varlen_fits(cfg, d_pad, dv_pad)
    assert varlen_fwd_plan(d, dv).smem_bytes <= SMEM_LIMIT_BYTES
    picked = pick_varlen_config(d=d_pad, dv=dv_pad, tq=8192, dtype=torch.bfloat16)
    assert varlen_fits(picked, d_pad, dv_pad) and picked.block_q == FWD_ROW_TILES[0]


def test_explicit_block_q_on_each_route():
    """The JAX API's explicit block_q is accepted on both routes (each walks
    64-row tiles anyway), 64 at D1024 too; head dims above 1024 fit no
    row tile."""
    assert tvar._varlen_block_config(32, None, 512, 512, 4096, torch.bfloat16).block_q == 32
    assert tvar._varlen_block_config(32, None, 1024, 1024, 4096, torch.bfloat16).block_q == 32
    assert tvar._varlen_block_config(64, None, 1024, 1024, 4096, torch.bfloat16).block_q == 64
    with pytest.raises(ValueError, match="does not fit"):
        tvar._varlen_block_config(64, None, 1088, 1088, 4096, torch.bfloat16)


SERVE_LENS = [589, 698, 763, 886]


def _meta(seqs, seqs_k=None, pad=0):
    seqs_k = seqs_k or seqs
    cu_q = torch.from_numpy(np.cumsum([0] + list(seqs)).astype(np.int32))
    cu_k = torch.from_numpy(np.cumsum([0] + list(seqs_k)).astype(np.int32))
    return tvar._call_metadata(cu_q, cu_k, sum(seqs) + pad, sum(seqs_k) + pad, "cpu")


@pytest.mark.parametrize("bq", FWD_ROW_TILES)
@pytest.mark.parametrize("d", [512, 320, 1024])
def test_schedule_at_the_routes_rows(bq, d):
    """The schedule is computed at 64-row Q tiles with their needed KV
    tiles on both routes (the cluster at D1024) whatever block_q asks: the
    call's one walk (``_call_walk``), which the forward saves."""
    tq = sum(SERVE_LENS)
    meta = _meta(SERVE_LENS)
    plan, rows, cut, sched = tvar._varlen_fwd_tiles(meta, tq, d, d, BlockConfig(block_q=bq),
                                                    True, (-1, -1))
    tiles, count, order = sched
    assert plan.route == ("wgmma" if d <= WGMMA_MAX_D else "wgmma_cluster") and rows == 64
    assert tiles.shape == (cdiv(tq, 64), cdiv(tq, 64)) and count.shape == order.shape
    assert all(t.dtype == torch.int32 for t in sched)
    walk = tvar._call_walk(meta, tq, True, (-1, -1))
    assert all(torch.equal(a, b) for a, b in zip(sched, walk[1:]))
    given = tvar._varlen_fwd_tiles(meta, tq, d, d, BlockConfig(block_q=bq), True, (-1, -1),
                                   walk)[3]
    assert all(a is b for a, b in zip(given, walk[1:]))
    assert cut[0].shape[0] == cdiv(tq, rows) * rows and cut[2].shape[0] == cdiv(tq, 64) * 64


def test_serving_packing_walks_only_needed_tiles():
    """At the serving packing the wgmma route walks the 389 tiles
    ``_tile_needed`` marks, where the [jmin, jmax] intervals hold 526."""
    tq = sum(SERVE_LENS)
    meta = tvar._q_tiles(_meta(SERVE_LENS), tq, 64)
    needed = tvar._tile_needed(*meta, 64, 64, True)
    lo, hi = tvar._interval_schedule(needed)
    _, count, _ = tvar._needed_tiles(needed)
    assert int((hi - lo + 1).sum()) == 526 and int(count.sum()) == 389


# Packings that exercise the schedule's and the full-block test's edges: a
# tile straddling three segments, length-0 segments, a padded tail (the
# pseudo-segment), tail-aligned cross keys and queries with no key.
PACKINGS = {
    "straddle_three": dict(seqs=[20, 9, 50, 3, 300]),
    "empty_and_tail": dict(seqs=[70, 0, 130, 1, 99], pad=30),
    "cross_keys": dict(seqs=[100, 60, 200], seqs_k=[300, 60, 260]),
    "rows_without_keys": dict(seqs=[150, 40, 90], seqs_k=[30, 40, 200]),
    "long_segments": dict(seqs=[256, 512, 128]),
}
WINDOWS = [(True, (-1, -1)), (False, (-1, -1)), (True, (32, -1)), (False, (-1, 40)),
           (False, (24, 24))]


@pytest.mark.parametrize("name", sorted(PACKINGS))
@pytest.mark.parametrize("causal,window", WINDOWS)
def test_needed_tiles_list_and_order(name, causal, window):
    """Each Q tile's list holds, rising, exactly the KV tiles inside its
    [jmin, jmax] interval that ``_tile_needed`` marks, padded past its count
    with the tile count; the order is a permutation of the Q tiles by count,
    largest first, ties in index order."""
    pk = PACKINGS[name]
    tq = sum(pk["seqs"]) + pk.get("pad", 0)
    wnorm = (window[0], -1 if causal else window[1])
    meta = tvar._q_tiles(_meta(**pk), tq, 64)
    needed = tvar._tile_needed(*meta, 64, 64, causal, *wnorm)
    lo, hi = tvar._interval_schedule(needed)
    tiles, count, order = tvar._needed_tiles(needed)
    nqb, nkb = needed.shape
    assert tiles.shape == (nqb, nkb)
    for i in range(nqb):
        n = int(count[i])
        inside = [j for j in range(int(lo[i]), int(hi[i]) + 1) if bool(needed[i, j])]
        assert tiles[i, :n].tolist() == inside
        assert bool((tiles[i, n:] == nkb).all())
    assert sorted(order.tolist()) == list(range(nqb))
    ranked = [(-int(count[i]), i) for i in order.tolist()]
    assert ranked == sorted(ranked)
    if name == "rows_without_keys" and causal:
        assert int(count.min()) == 0  # a Q tile that walks nothing


@pytest.mark.parametrize("name", sorted(PACKINGS))
@pytest.mark.parametrize("causal,window", WINDOWS)
def test_full_blocks_keep_every_pair(name, causal, window):
    """Every 64 x 32 block the full-block test marks full has every pair
    kept by the keep-mask; without a left window, causal packings with long
    segments have full blocks, and a left window has none."""
    meta = _meta(**PACKINGS[name])
    wnorm = (window[0], -1 if causal else window[1])
    full = tvar._full_blocks(meta, 64, 32, causal, wnorm)
    q_seg, q_rank, k_seg, k_pos = meta
    keep = tvar._varlen_mask(q_seg[:, None], q_rank[:, None], k_seg[None, :], k_pos[None, :],
                             causal, *wnorm)  # [q, kv]
    nqb, nkc = full.shape
    assert nqb == q_seg.shape[0] // 64 and nkc == k_seg.shape[0] // 32
    blocks_kept = keep[:nqb * 64].reshape(nqb, 64, nkc, 32).all(dim=3).all(dim=1)
    assert not bool((full & ~blocks_kept).any())
    if wnorm[0] >= 0:
        assert not bool(full.any())
    elif name == "long_segments":
        assert int(full.sum()) > 0


def test_full_blocks_off_under_features():
    meta = _meta(**PACKINGS["long_segments"])
    assert int(tvar._full_blocks(meta, 64, 32, True).sum()) > 0
    assert not bool(tvar._full_blocks(meta, 64, 32, True, softcap=30.0).any())
    assert not bool(tvar._full_blocks(meta, 64, 32, True, alibi=True).any())


# -- on the card ---------------------------------------------------------------


@pytest.mark.parametrize("d,dv", HEAD_DIMS)
def test_varlen_fwd_plan_matches_library_on_card(cuda, d, dv):  # noqa: F811
    assert tvar.varlen_fwd_kernel_plan(d, dv) == varlen_fwd_plan(d, dv)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_wgmma_kernel_spills_nothing_on_card(cuda, dtype):  # noqa: F811
    a = tvar.varlen_fwd_kernel_attrs("wgmma", dtype)
    assert a["local_bytes"] == 0 and a["registers"] > 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cluster_kernel_spills_nothing_on_card(cuda, dtype):  # noqa: F811
    a = tvar.varlen_fwd_kernel_attrs("wgmma_cluster", dtype)
    assert a["local_bytes"] == 0 and a["registers"] > 0


CARD_CASES = {
    "d512_dv320": dict(seqs=[300, 17, 500], d=512, dv=320),
    "d320_dv512": dict(seqs=[300, 17, 500], d=320, dv=512),
    "d448_dv64_window": dict(seqs=[300, 17, 500], d=448, dv=64, window=(100, -1)),
    "d640": dict(seqs=[300, 17, 500], d=640, dv=640),
    "d512_rows_without_keys": dict(seqs=[150, 40, 90], seqs_k=[30, 40, 200], d=512, dv=512),
    "d1024": dict(seqs=[300, 17, 500], d=1024, dv=1024),
    "d576": dict(seqs=[300, 17, 500], d=576, dv=576),
    "d64_dv1024": dict(seqs=[300, 17, 500], d=64, dv=1024),
    "d1024_dv64": dict(seqs=[300, 17, 500], d=1024, dv=64),
}


@pytest.mark.parametrize("name", sorted(CARD_CASES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_varlen_fwd_kernel_matches_plain_on_card(cuda, name, dtype):  # noqa: F811
    """The kernel of the plan's route (one block at D, Dv <= 512, the
    cluster above) against ``_varlen_forward_plain`` on the same inputs: o per row,
    lse over the rows that keep a key, and the rows that keep none at
    exactly the plain version's MASK_VALUE + log(1e-38)."""
    case = CARD_CASES[name]
    d, dv, hq, hkv = case["d"], case["dv"], 8, 4
    seqs, seqs_k = case["seqs"], case.get("seqs_k", case["seqs"])
    tq, tk = sum(seqs), sum(seqs_k)
    gen = torch.Generator(device=cuda).manual_seed(17)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    q, k, v = randn(tq, hq, d), randn(tk, hkv, d), randn(tk, hkv, dv)
    cu_q = torch.tensor(np.cumsum([0] + seqs), dtype=torch.int32, device=cuda)
    cu_k = torch.tensor(np.cumsum([0] + seqs_k), dtype=torch.int32, device=cuda)
    kw = dict(scale=1.0 / math.sqrt(d), causal=True, window=case.get("window", (-1, -1)))
    n0 = tvar._varlen_forward.launches
    o, lse = tvar._varlen_forward(q, k, v, cu_q, cu_k, **kw)
    torch.cuda.synchronize()
    assert tvar._varlen_forward.launches == n0 + 1
    meta = tvar._call_metadata(cu_q, cu_k, tq, tk, cuda)
    po, plse = tvar._varlen_forward_plain(q, k, v, meta, **kw)
    assert o.shape == po.shape and o.dtype == dtype
    assert row_rel_err(o, po) < TOL[dtype], name
    live = plse > DEFAULT_MASK_VALUE / 2
    lerr = float((lse[live] - plse[live]).abs().max() / plse[live].abs().max())
    assert lerr < LSE_TOL, name
    assert bool((lse[~live] == plse[~live]).all()), name
