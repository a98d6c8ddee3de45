"""The route and tiling of the dense forward (``ops/config.py`` ``fwd_plan``,
the mirror of ``csrc/flash_fwd.cu`` ``fwd::make_plan``) and the S
residual's slab shape, which both routes keep.

D and Dv up to 512 take the TMA + wgmma block: 64 Q rows, two consumer
warpgroups splitting O's columns in whole 64-column boxes, a ring of
two-box stages in the card's shared memory; wider heads, up to 1024, take a
cluster of two such blocks, each rank holding half of D's boxes and half of
Dv's and exchanging partial scores with the other. On a card the mirror is
held equal to the plan the library launches with.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_parity import cuda, randn, rel_err, row_rel_err, to_torch  # noqa: F401
from ffpa_attn_tpu_torch.ops import flash_fwd as tfwd
from ffpa_attn_tpu_torch.ops.config import (
    D_CHUNK,
    FWD_MAX_HEAD_DIM,
    KV_TILE,
    SMEM_LIMIT_BYTES,
    cdiv,
    fwd_plan,
)

WGMMA_MAX_D = 512  # the reference's Hopper forward covers D, Dv <= 512
CONSUMER_MAX_COLS = 256  # 64 rows x 256 fp32 columns: 128 registers a consumer thread
BOX = 64 * D_CHUNK * 2  # a 64 x 64 box of 16-bit elements
EXCHANGE_BYTES = 2 * 2 * 64 * 32 * 4  # two slots of both consumers' 64 x 32 fp32 partials
# D = Dv over 64..1024 in 64-column boxes, and D != Dv (some not 64-multiples).
HEAD_DIMS = [(d, d) for d in range(64, 1025, 64)] + [
    (128, 512), (512, 128), (320, 512), (448, 64), (512, 64), (512, 1024), (1024, 320),
    (64, 1024), (1024, 64), (400, 400), (100, 200),
]


def _pad(x: int) -> int:
    return cdiv(x, D_CHUNK) * D_CHUNK


@pytest.mark.parametrize("d,dv", HEAD_DIMS)
def test_fwd_plan_routes_by_head_dims(d, dv):
    plan = fwd_plan(d, dv)
    d_pad, dv_pad = _pad(d), _pad(dv)
    wide = max(d_pad, dv_pad) > WGMMA_MAX_D
    assert plan.route == ("wgmma_cluster" if wide else "wgmma")
    assert plan.kv_rows == KV_TILE and plan.q_rows == 64
    assert plan.smem_bytes <= SMEM_LIMIT_BYTES
    # The O column blocks tile [0, Dv) in order, in whole 64-column boxes,
    # each at most one consumer's registers' worth.
    start = 0
    for c0, width in plan.o_blocks:
        assert c0 == start and width % D_CHUNK == 0 and width <= CONSUMER_MAX_COLS
        start += width
    assert start == dv_pad
    # Two consumers a block; the first of each pair the wider.
    assert len(plan.o_blocks) == (4 if wide else 2)
    for (_, w0), (_, w1) in zip(plan.o_blocks[::2], plan.o_blocks[1::2]):
        assert 0 <= w0 - w1 <= D_CHUNK
    if plan.route == "wgmma":
        assert plan.stages == 8 and plan.rank_blocks == ()
        # Q, the P box, the stages of two boxes each and their barriers fit.
        assert plan.smem_bytes >= (d_pad // D_CHUNK + 1 + 2 * plan.stages) * BOX
    else:
        assert plan.stages == 7 and len(plan.rank_blocks) == 2
    assert fwd_plan(d_pad, dv_pad) == plan


def test_fwd_plan_d512_holds_a_tile_in_the_ring():
    """At D512 a KV tile is 16 boxes, 8 stages of two: the ring holds a whole
    tile of K and V beside 64 KB of resident Q."""
    plan = fwd_plan(512, 512)
    assert plan.route == "wgmma" and plan.stages == 8
    assert plan.o_blocks == ((0, 256), (256, 256))
    assert plan.smem_bytes == (8 + 1) * 8192 + 1024 + 8 + 512 + 8 * (2 * 8192 + 16)


def test_fwd_plan_odd_box_counts_split_consumer0_wider():
    assert fwd_plan(448, 448).o_blocks == ((0, 256), (256, 192))
    assert fwd_plan(320, 320).o_blocks == ((0, 192), (192, 128))
    assert fwd_plan(64, 64).o_blocks == ((0, 64), (64, 0))


@pytest.mark.parametrize("d,dv", HEAD_DIMS)
def test_fwd_cluster_ranks_split_both_head_dims(d, dv):
    """On the cluster route the two ranks' D boxes tile [0, D) and their Dv
    boxes tile [0, Dv), in order, rank 0 holding the larger half of each;
    each rank's two consumers split its Dv boxes, at most 4 boxes each; a
    rank's block (rank 0's Q boxes, the P box, the ring and the two 16 KB
    slots of the partial-score exchange) fits the card."""
    plan = fwd_plan(d, dv)
    d_pad, dv_pad = _pad(d), _pad(dv)
    if plan.route != "wgmma_cluster":
        assert max(d_pad, dv_pad) <= WGMMA_MAX_D and plan.rank_blocks == ()
        return
    for dim, full in ((0, d_pad), (1, dv_pad)):
        (a0, w0), (a1, w1) = (r[dim] for r in plan.rank_blocks)
        assert a0 == 0 and a1 == w0 and w0 + w1 == full
        assert 0 <= w0 - w1 <= D_CHUNK and w0 <= WGMMA_MAX_D
    for rank, (_, (v0, vw)) in enumerate(plan.rank_blocks):
        (c0, cw0), (c1, cw1) = plan.o_blocks[2 * rank:2 * rank + 2]
        assert c0 == v0 and c1 == v0 + cw0 and cw0 + cw1 == vw
        assert max(cw0, cw1) <= 4 * D_CHUNK
    q_boxes = plan.rank_blocks[0][0][1] // D_CHUNK
    assert plan.smem_bytes >= (q_boxes + 1 + 2 * plan.stages) * BOX + EXCHANGE_BYTES
    assert plan.smem_bytes <= SMEM_LIMIT_BYTES
    # The ring is the deepest that fits beside the widest rank's block.
    assert fwd_plan(1024, 1024).smem_bytes + 2 * BOX + 16 > SMEM_LIMIT_BYTES


@pytest.mark.parametrize("d,dv", [(1088, 64), (64, 1088), (2048, 2048)])
def test_fwd_plan_refuses_heads_above_1024(d, dv):
    with pytest.raises(ValueError, match=str(FWD_MAX_HEAD_DIM)):
        fwd_plan(d, dv)


def test_fwd_plan_d1024_splits_each_head_dim_in_half():
    plan = fwd_plan(1024, 1024)
    assert plan.route == "wgmma_cluster" and plan.stages == 7
    assert plan.rank_blocks == (((0, 512), (0, 512)), ((512, 512), (512, 512)))
    assert plan.o_blocks == ((0, 256), (256, 256), (512, 256), (768, 256))
    assert plan.smem_bytes == (8 + 1) * 8192 + 1024 + 8 + 512 + EXCHANGE_BYTES + 32 + 7 * (
        2 * 8192 + 16)
    # D640: 5 boxes a rank; D320 / Dv1024: the D boxes 3 + 2.
    assert fwd_plan(640, 640).rank_blocks == (((0, 320), (0, 320)), ((320, 320), (320, 320)))
    assert fwd_plan(320, 1024).rank_blocks == (((0, 192), (0, 512)), ((192, 128), (512, 512)))


@pytest.mark.parametrize("d,dv", HEAD_DIMS)
def test_fwd_plan_matches_library_on_card(cuda, d, dv):  # noqa: F811
    assert tfwd.fwd_kernel_plan(d, dv) == fwd_plan(d, dv)


@pytest.mark.parametrize("route", ["wgmma", "wgmma_cluster"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_fwd_kernels_spill_nothing_on_card(cuda, dtype, route):  # noqa: F811
    attrs = tfwd.fwd_kernel_attrs(route, dtype)
    assert attrs["local_bytes"] == 0 and attrs["registers"] > 0


# D != Dv on the wgmma route: K and V stream different box counts, the
# consumers' O halves differ, and at Dv 64 consumer 1 owns no columns.
@pytest.mark.parametrize("d,dv", [(512, 128), (128, 512), (512, 64), (64, 512), (448, 320)])
@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float16", 1e-2)])
def test_mixed_head_dims_match_plain_on_card(cuda, d, dv, dtype, tol):  # noqa: F811
    assert tfwd.fwd_kernel_plan(d, dv).route == "wgmma"
    rng = np.random.default_rng(d + dv)
    nq, nkv = 200, 300
    q = to_torch(randn(rng, (1, 4, nq, d)), dtype, cuda)
    k = to_torch(randn(rng, (1, 2, nkv, d)), dtype, cuda)
    v = to_torch(randn(rng, (1, 2, nkv, dv)), dtype, cuda)
    bias = to_torch(randn(rng, (1, 1, nq, nkv)), device=cuda)
    kw = dict(scale=d ** -0.5, is_causal=True)
    before = tfwd.flash_attention_forward.launches
    ko, kl = tfwd.flash_attention_forward(q, k, v, bias, **kw)
    torch.cuda.synchronize()
    assert tfwd.flash_attention_forward.launches == before + 1
    po, pl = tfwd.flash_attention_forward_plain(q, k, v, bias, **kw)
    assert ko.shape == (1, 4, nq, dv)
    assert row_rel_err(ko, po) < tol
    assert rel_err(kl, pl) < 1e-4


# The cluster route: D and Dv split across the pair (rank 1 without D boxes
# at D64, without Dv boxes at Dv64), a window whose first blocks visit no
# tile, dropout from both ranks' identical P, GQA, bias, ALiBi and softcap.
CLUSTER_CASES = {
    "d1024": dict(d=1024),
    "d640_window": dict(d=640, window=(100, -1)),
    "d1024_dv320": dict(d=1024, dv=320),
    "d320_dv1024": dict(d=320, dv=1024),
    "d64_dv1024": dict(d=64, dv=1024),
    "d1024_dv64": dict(d=1024, dv=64),
    "d640_features": dict(d=640, causal=False, bias=True, softcap=30.0, alibi=True),
    "d1024_dropout": dict(d=1024, dropout=0.1),
    "d640_window_no_tile": dict(d=640, nq=100, nkv=300, causal=False, window=(0, 0)),
}


@pytest.mark.parametrize("name", sorted(CLUSTER_CASES))
@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float16", 1e-2)])
def test_cluster_route_matches_plain_on_card(cuda, name, dtype, tol):  # noqa: F811
    c = CLUSTER_CASES[name]
    d, dv = c["d"], c.get("dv", c["d"])
    assert tfwd.fwd_kernel_plan(d, dv).route == "wgmma_cluster"
    rng = np.random.default_rng(len(name))
    nq, nkv = c.get("nq", 200), c.get("nkv", 300)
    q = to_torch(randn(rng, (1, 4, nq, d)), dtype, cuda)
    k = to_torch(randn(rng, (1, 2, nkv, d)), dtype, cuda)
    v = to_torch(randn(rng, (1, 2, nkv, dv)), dtype, cuda)
    bias = to_torch(randn(rng, (1, 1, nq, nkv)), device=cuda) if c.get("bias") else None
    kw = dict(scale=d ** -0.5, is_causal=c.get("causal", True), window=c.get("window", (-1, -1)),
              softcap=c.get("softcap", 0.0), dropout_p=c.get("dropout", 0.0), dropout_seed=7)
    if c.get("alibi"):
        kw["alibi_slopes"] = to_torch(rng.uniform(0.01, 0.3, (1, 4)).astype(np.float32),
                                      device=cuda)
    before = tfwd.flash_attention_forward.launches
    ko, kl = tfwd.flash_attention_forward(q, k, v, bias, **kw)
    torch.cuda.synchronize()
    assert tfwd.flash_attention_forward.launches == before + 1
    po, pl = tfwd.flash_attention_forward_plain(q, k, v, bias, **kw)
    assert ko.shape == (1, 4, nq, dv)
    assert row_rel_err(ko, po) < tol
    assert rel_err(kl, pl) < 1e-4


# ---------------------------------------------------------------------------
# The S residual's slab: rows padded to the config's row tile, columns to 64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nq,nkv,rows", [(20, 300, 32), (40, 1100, 64), (1000, 1100, 1024)])
def test_scores_slab_shape_is_route_independent(nq, nkv, rows):
    """The 64-row wgmma tile does not change the slab's shape: rows pad to
    the config's block_q (32 when Nq <= 32, as banded dQ reads it) and
    columns to the 64-column KV tile."""
    d = 512
    assert fwd_plan(d, d).route == "wgmma"
    assert tfwd.scores_padding(nq, nkv, d, d, torch.bfloat16) == (rows, cdiv(nkv, KV_TILE) * KV_TILE)
    rng = np.random.default_rng(nq)
    q = to_torch(randn(rng, (1, 2, nq, d)), "bfloat16")
    k = to_torch(randn(rng, (1, 1, nkv, d)), "bfloat16")
    o, lse, s = tfwd.flash_attention_forward(q, k, k, None, scale=d ** -0.5, is_causal=True,
                                             return_scores=True)
    assert s.shape == (1, 2, rows, cdiv(nkv, KV_TILE) * KV_TILE) and s.dtype == torch.bfloat16
    assert o.shape == (1, 2, nq, d) and lse.shape == (1, 2, nq)


@pytest.mark.parametrize("nq,nkv,rows", [(20, 300, 32), (40, 1100, 64), (1000, 1100, 1024)])
def test_scores_slab_shape_on_the_cluster_route(nq, nkv, rows):
    """At D1024 the slab's rows pad to the config's 32-row tile, as they
    did on the retired mma.sync block; the cluster's 64-row blocks write
    only the rows below the slab's end."""
    d = 1024
    assert fwd_plan(d, d).route == "wgmma_cluster"
    assert tfwd.scores_padding(nq, nkv, d, d, torch.bfloat16) == (rows, cdiv(nkv, KV_TILE) * KV_TILE)
    rng = np.random.default_rng(nq)
    q = to_torch(randn(rng, (1, 2, nq, d)), "bfloat16")
    k = to_torch(randn(rng, (1, 1, nkv, d)), "bfloat16")
    o, lse, s = tfwd.flash_attention_forward(q, k, k, None, scale=d ** -0.5, is_causal=True,
                                             return_scores=True)
    assert s.shape == (1, 2, rows, cdiv(nkv, KV_TILE) * KV_TILE) and s.dtype == torch.bfloat16
    assert o.shape == (1, 2, nq, d) and lse.shape == (1, 2, nq)
