"""The route and tiling of the dense dK/dV kernel (``ops/config.py``
``dkdv_plan``, the mirror of ``csrc/flash_bwd.cu`` ``dkdv::make_plan``) and
the dS slab's padding that both routes share.

D and Dv up to 512 take the TMA + wgmma block: column passes of at most
256 columns of dK and of dV in whole 64-column boxes, in the card's shared
memory; wider heads, up to 1024, a cluster of two such blocks whose ranks
each hold half of D's and half of Dv's boxes (rank 0 the larger half), the
same passes over a rank's half. The packed varlen dK/dV takes the same
plan at every width. On a card the mirror is held equal to the plan the
library launches with. On the CPU the slab, padded to
DKDV_Q_TILE rows and DKDV_SLAB_COLS columns, trims to the JAX package's
slab, whole and cut into KV stripes; its padding holds zeros.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from _torch_parity import cuda, jax_modules, randn, rel_err, to_jax, to_torch  # noqa: F401
from ffpa_attn_tpu_torch.ops import flash_bwd as tbwd
from ffpa_attn_tpu_torch.ops.config import (
    D_CHUNK,
    DKDV_Q_TILE,
    DKDV_SLAB_COLS,
    SMEM_LIMIT_BYTES,
    cdiv,
    dkdv_plan,
    varlen_dkdv_plan,
)
from ffpa_attn_tpu_torch.ops.dispatch import pick_backward_config

WGMMA_MAX_D = 512  # the reference's Hopper dK/dV block covers D, Dv <= 512
PASS_MAX_COLS = 256  # 64 rows x 256 columns x 2 fp32 tiles: 128 registers a thread
# D = Dv over 320..1024 in 64-column boxes, and D != Dv.
HEAD_DIMS = [(d, d) for d in range(320, 1025, 64)] + [
    (64, 64), (128, 512), (320, 512), (448, 64), (512, 128), (512, 1024), (1024, 320),
    (400, 400),
]
# Pairs where one rank of the cluster holds no box of a head dim, and an
# uneven one: with HEAD_DIMS, where a plan must fit the card.
EDGE_DIMS = [(64, 1024), (1024, 64), (640, 1024)]


def _tiles(blocks, width):
    """The (first column, width) blocks cover [0, width) in order."""
    start = 0
    for c0, w in blocks:
        assert c0 == start and w % D_CHUNK == 0
        start += w
    return start == width


@pytest.mark.parametrize("d,dv", HEAD_DIMS)
def test_dkdv_plan_routes_by_head_dims(d, dv):
    plan = dkdv_plan(d, dv)
    d_pad, dv_pad = cdiv(d, D_CHUNK) * D_CHUNK, cdiv(dv, D_CHUNK) * D_CHUNK
    wide = max(d_pad, dv_pad) > WGMMA_MAX_D
    assert plan.route == ("wgmma_cluster" if wide else "wgmma")
    ranks = 2 if wide else 1
    assert len(plan.rank_blocks) == (2 if wide else 0)
    assert len(plan.d_blocks) == len(plan.dv_blocks) == ranks * plan.passes
    assert _tiles(plan.d_blocks, d_pad) and _tiles(plan.dv_blocks, dv_pad)
    assert plan.smem_bytes <= SMEM_LIMIT_BYTES
    assert plan.kv_rows == 64 and plan.q_rows == 64 and plan.stages >= 3
    # A block's passes: its boxes (a rank's half on the cluster) in passes
    # of at most 256 columns, rank 0's count for both ranks.
    widest = (max(plan.rank_blocks[0][0][1], plan.rank_blocks[0][1][1]) if wide
              else max(d_pad, dv_pad))
    assert plan.passes == cdiv(widest, PASS_MAX_COLS)
    for r in range(ranks):
        for blocks in (plan.d_blocks, plan.dv_blocks):
            widths = [w for _, w in blocks[r * plan.passes:(r + 1) * plan.passes]]
            assert max(widths) <= PASS_MAX_COLS
            assert max(widths) - min(widths) <= D_CHUNK  # as even as boxes allow
            assert widths == sorted(widths, reverse=True)  # the first pass is the widest
    assert dkdv_plan(d_pad, dv_pad) == plan


@pytest.mark.parametrize("d,dv", [hd for hd in HEAD_DIMS + EDGE_DIMS
                                  if max(hd) > WGMMA_MAX_D])
def test_cluster_ranks_cover_their_halves_in_order(d, dv):
    """Each rank's D and Dv boxes are its half of the head dims, the two
    halves in order; each rank's passes cover its own half in order."""
    plan = dkdv_plan(d, dv)
    d_pad, dv_pad = cdiv(d, D_CHUNK) * D_CHUNK, cdiv(dv, D_CHUNK) * D_CHUNK
    (d0, v0), (d1, v1) = plan.rank_blocks
    assert _tiles((d0, d1), d_pad) and _tiles((v0, v1), dv_pad)
    for r, (dr, vr) in enumerate(plan.rank_blocks):
        own = slice(r * plan.passes, (r + 1) * plan.passes)  # rank r's passes
        for (c0, width), blocks in ((dr, plan.d_blocks[own]), (vr, plan.dv_blocks[own])):
            start = c0
            for b0, w in blocks:
                assert b0 == start
                start += w
            assert start == c0 + width


@pytest.mark.parametrize("d,dv", [hd for hd in HEAD_DIMS + EDGE_DIMS
                                  if max(hd) > WGMMA_MAX_D])
def test_cluster_rank0_takes_the_larger_half(d, dv):
    plan = dkdv_plan(d, dv)
    (d0, v0), (d1, v1) = plan.rank_blocks
    for first, second in ((d0, d1), (v0, v1)):
        assert 0 <= first[1] - second[1] <= D_CHUNK
    # A pair of 64 / 1024 leaves rank 1 without a box of the narrow dim.
    if min(d, dv) == 64:
        assert min(d1[1], v1[1]) == 0


@pytest.mark.parametrize("d,dv", HEAD_DIMS + EDGE_DIMS)
def test_dkdv_plan_fits_the_card(d, dv):
    """Every plan fits the card's shared memory with a ring of at least 3
    stages and passes of at most 256 columns."""
    plan = dkdv_plan(d, dv)
    assert plan.stages >= 3 and plan.smem_bytes <= SMEM_LIMIT_BYTES
    assert max(w for _, w in plan.d_blocks + plan.dv_blocks) <= PASS_MAX_COLS


def test_cluster_plan_at_d1024_is_three_stages_in_one_slot():
    """The arithmetic beside make_plan: a rank's K and V halves (16 boxes),
    the P and dS boxes, one 32 KB exchange slot and 3 stages of 16,400 B."""
    plan = dkdv_plan(1024, 1024)
    assert plan.route == "wgmma_cluster" and plan.passes == 2 and plan.stages == 3
    assert plan.smem_bytes == 181_288 + 3 * 16_400
    assert plan.smem_bytes + 32 * 1024 > SMEM_LIMIT_BYTES  # no second slot beside 3 stages
    assert plan.rank_blocks == (((0, 512), (0, 512)), ((512, 512), (512, 512)))
    assert plan.d_blocks == ((0, 256), (256, 256), (512, 256), (768, 256))


@pytest.mark.parametrize("d,dv", [(1024, 1024), (640, 640), (576, 576), (1024, 320)])
def test_varlen_dkdv_plan_keeps_its_mma_sync_plan_above_d512(d, dv):
    """The packed varlen dK/dV's wider heads (once an mma.sync block of its
    own) take this cluster's plan: 64 KV rows, 64-row Q tiles, each rank's
    half of the head dims in passes of at most 256 columns."""
    plan = varlen_dkdv_plan(d, dv)
    assert plan == dkdv_plan(d, dv)
    assert plan.route == "wgmma_cluster" and len(plan.rank_blocks) == 2
    assert (plan.kv_rows, plan.q_rows) == (64, 64) and plan.q_rows < DKDV_Q_TILE
    assert plan.passes == cdiv(max(plan.rank_blocks[0][0][1], plan.rank_blocks[0][1][1]),
                               PASS_MAX_COLS)
    assert _tiles(plan.d_blocks, cdiv(d, D_CHUNK) * D_CHUNK)
    assert _tiles(plan.dv_blocks, cdiv(dv, D_CHUNK) * D_CHUNK)
    assert varlen_dkdv_plan(512, 512) == dkdv_plan(512, 512)


def test_dkdv_plan_refuses_heads_above_1024():
    with pytest.raises(ValueError):
        dkdv_plan(1088, 64)


def test_dkdv_plan_d448_takes_passes_of_256_and_192():
    plan = dkdv_plan(448, 448)
    assert plan.route == "wgmma"
    assert plan.d_blocks == plan.dv_blocks == ((0, 256), (256, 192))


@pytest.mark.parametrize("d,dv", HEAD_DIMS + EDGE_DIMS)
def test_dkdv_plan_matches_library_on_card(cuda, d, dv):  # noqa: F811
    assert tbwd.dkdv_kernel_plan(d, dv) == dkdv_plan(d, dv)


# ---------------------------------------------------------------------------
# The dS slab: padding, trim and stripes against the JAX package
# ---------------------------------------------------------------------------

B, HQ, HKV, D = 1, 2, 1, 320
KW = dict(is_causal=True, dropout_p=0.1)
SEED = 3


def _inputs(nq, nkv):
    rng = np.random.default_rng(7)
    return {"q": randn(rng, (B, HQ, nq, D)), "k": randn(rng, (B, HKV, nkv, D)),
            "v": randn(rng, (B, HKV, nkv, D)), "do": randn(rng, (B, HQ, nq, D))}


def _jax_slab(x):
    """The JAX forward's (lse, delta) and the JAX dK/dV launcher's dS slab
    (interpret mode), as numpy."""
    import jax.numpy as jnp
    from ffpa_attn_tpu.ops import flash_bwd as jbwd
    from ffpa_attn_tpu.ops import flash_fwd as jfwd
    from ffpa_attn_tpu.ops.config import BlockConfig

    q, k, v, do = (to_jax(x[n], "bfloat16") for n in ("q", "k", "v", "do"))
    nq, nkv = q.shape[2], k.shape[2]
    scale = 1.0 / math.sqrt(D)
    o, lse = jfwd.flash_attention_forward(q, k, v, None, scale=scale, dropout_seed=SEED, **KW)
    delta = jnp.sum(do.astype(jnp.float32) * o.astype(jnp.float32), axis=-1)
    _, _, ds = jbwd._dkdv_launch(
        q, k, v, None, do, lse, delta, jnp.asarray(SEED, jnp.int32).reshape(1, 1),
        BlockConfig().clamp(nq, nkv), grad_kv_storage_dtype=None, emit_ds=True, scale=scale,
        causal_offset=nkv - nq, group=HQ // HKV, interpret=True, **KW)
    return (np.asarray(lse, np.float32), np.asarray(o, np.float32), np.asarray(delta),
            np.asarray(ds, np.float32)[:, :, :nq, :nkv])


@pytest.fixture(scope="module")
def jax_ready():
    jax_modules("jax", "ffpa_attn_tpu.ops.flash_bwd")


def test_slab_padding_trims_to_the_jax_slab(jax_ready):
    nq, nkv = 130, 150  # neither a multiple of 64
    x = _inputs(nq, nkv)
    lse, _, delta, want = _jax_slab(x)
    t = {n: to_torch(x[n], "bfloat16") for n in x}
    cfg = pick_backward_config(d=D, dv=D, nq=nq, nkv=nkv, dtype=torch.bfloat16)
    _, _, ds = tbwd._dkdv_launch(
        t["q"], t["k"], t["v"], None, t["do"], to_torch(lse), to_torch(delta), SEED, cfg,
        grad_kv_storage_dtype=None, emit_ds=True, scale=1.0 / math.sqrt(D),
        causal_offset=nkv - nq, group=HQ // HKV, **KW)
    assert ds.shape == (B, HQ, cdiv(nq, DKDV_Q_TILE) * DKDV_Q_TILE,
                        cdiv(nkv, DKDV_SLAB_COLS) * DKDV_SLAB_COLS)
    assert ds.shape[3] % 64 == 0  # the wgmma block's KV rows
    assert rel_err(ds[:, :, :nq, :nkv], want) < 5e-2
    assert not ds[:, :, nq:].any() and not ds[:, :, :, nkv:].any()


def test_striped_slabs_trim_to_the_jax_slab(jax_ready, monkeypatch):
    """Three KV stripes (a slab limit of a third): each stripe's slab, cut
    to its rows and columns, is the JAX slab's block there (dropout on the
    global ids), its padding zeros; under causal the later stripes drop the
    Q rows that cannot see them."""
    n = 300
    x = _inputs(n, n)
    lse, o, _, want = _jax_slab(x)
    monkeypatch.setenv("FFPA_TORCH_DS_HANDOFF_LIMIT_BYTES",
                       str(B * HQ * cdiv(n, DKDV_Q_TILE) * DKDV_Q_TILE * n * 2 // 3))
    stripes = []
    banded = tbwd._banded_dq_from_ds

    def record(ds_s, k_s, config, *, nq, nkv, causal_offset, **kw):
        stripes.append((ds_s.clone(), nq, nkv, causal_offset))
        return banded(ds_s, k_s, config, nq=nq, nkv=nkv, causal_offset=causal_offset, **kw)

    monkeypatch.setattr(tbwd, "_banded_dq_from_ds", record)
    t = {name: to_torch(x[name], "bfloat16") for name in x}
    tbwd.flash_attention_backward(
        t["q"], t["k"], t["v"], None, to_torch(o, "bfloat16"), to_torch(lse), t["do"],
        scale=1.0 / math.sqrt(D), dropout_seed=SEED, ds_handoff=True, **KW)
    assert len(stripes) == 3
    lo = 0
    for ds_s, nq_loc, width, local_off in stripes:
        row_start = n - nq_loc
        assert local_off == -lo + row_start  # the call's causal offset is 0
        assert ds_s.shape[3] == cdiv(width, DKDV_SLAB_COLS) * DKDV_SLAB_COLS
        assert rel_err(ds_s[:, :, :nq_loc, :width],
                       want[:, :, row_start:, lo:lo + width]) < 5e-2
        assert not ds_s[:, :, nq_loc:].any() and not ds_s[:, :, :, width:].any()
        lo += width
    assert lo == n
    assert [n - s[1] for s in stripes] == [0, 128, 256]
