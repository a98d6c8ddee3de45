"""The route and tiling of the dense forward (``ops/config.py`` ``fwd_plan``,
the mirror of ``csrc/flash_fwd.cu`` ``fwd::make_plan``) and the S
residual's slab shape, which both routes keep.

D and Dv up to 512 take the TMA + wgmma block: 64 Q rows, two consumer
warpgroups splitting O's columns in whole 64-column boxes, a ring of
two-box stages in the card's shared memory; wider heads take the mma.sync
block. On a card the mirror is held equal to the plan the library launches
with.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_parity import cuda, randn, rel_err, row_rel_err, to_torch  # noqa: F401
from ffpa_attn_tpu_torch.ops import flash_fwd as tfwd
from ffpa_attn_tpu_torch.ops.config import (
    D_CHUNK,
    FWD_ACC_ELEMS,
    KV_TILE,
    SMEM_LIMIT_BYTES,
    BlockConfig,
    cdiv,
    fwd_plan,
    fwd_smem_bytes,
)

WGMMA_MAX_D = 512  # the reference's Hopper forward covers D, Dv <= 512
CONSUMER_MAX_COLS = 256  # 64 rows x 256 fp32 columns: 128 registers a consumer thread
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
    assert plan.route == ("mma_sync" if wide else "wgmma")
    assert plan.kv_rows == KV_TILE
    assert plan.smem_bytes <= SMEM_LIMIT_BYTES
    # The O column blocks tile [0, Dv) in order, in whole 64-column boxes.
    start = 0
    for c0, width in plan.o_blocks:
        assert c0 == start and width % D_CHUNK == 0
        start += width
    assert start == dv_pad
    if plan.route == "wgmma":
        assert plan.q_rows == 64 and plan.stages == 8
        assert len(plan.o_blocks) == 2
        (_, w0), (_, w1) = plan.o_blocks
        assert w0 <= CONSUMER_MAX_COLS and 0 <= w0 - w1 <= D_CHUNK  # consumer 0 the wider
        # Q, the P box, the stages of two boxes each and their barriers fit.
        box = 64 * D_CHUNK * 2
        assert plan.smem_bytes >= (d_pad // D_CHUNK + 1 + 2 * plan.stages) * box
    else:
        assert plan.o_blocks == ((0, dv_pad),)
        assert plan.q_rows * dv_pad <= FWD_ACC_ELEMS
        assert plan.q_rows == (64 if 64 * dv_pad <= FWD_ACC_ELEMS else 32)
        assert plan.smem_bytes == fwd_smem_bytes(BlockConfig(block_q=plan.q_rows), d_pad, dv_pad)
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
def test_fwd_plan_matches_library_on_card(cuda, d, dv):  # noqa: F811
    assert tfwd.fwd_kernel_plan(d, dv) == fwd_plan(d, dv)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_fwd_kernels_spill_nothing_on_card(cuda, dtype):  # noqa: F811
    attrs = tfwd.fwd_kernel_attrs("wgmma", dtype)
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
