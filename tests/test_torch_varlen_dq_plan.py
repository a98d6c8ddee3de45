"""The route and tiling of the packed varlen dQ kernel (``ops/config.py``
``varlen_dq_plan``, the mirror of ``csrc/varlen_bwd.cu``
``tma::make_dq_plan``) and the schedule it reads.

The plan is the dense recompute dQ's (``dq_plan``) at every width: D and
Dv up to 512 take one TMA + wgmma block, 64 Q rows whatever
``block_q_dq`` asks, consumer 0 owning the first ceil(nd / 2) of D's boxes
of dQ and consumer 1 the rest, as many two-box ring stages as the card's
shared memory holds beside Q, dO and the dS box; wider heads, up to 1024,
a cluster of two such blocks, each rank holding half of D's and of Dv's
boxes. Both routes walk one 64 x 64 walk's needed-tile lists
(``varlen._backward_schedules``). On a card the mirror is held equal to
the plan the library launches with, neither route's kernel spills in
either dtype, and the kernel is held against ``_varlen_dq_plain`` per row
at bf16 5e-2 / fp16 1e-2 (``tests/test_ffpa_bwd.py:19``) on both routes.
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
    BlockConfig,
    cdiv,
    dq_plan,
    varlen_dkdv_plan,
    varlen_dq_plan,
)
from ffpa_attn_tpu_torch.ops.dispatch import pick_varlen_backward_config

WGMMA_MAX_D = 512
# D, Dv over 64..1024 in 64-column boxes, odd and unequal box counts, wider
# heads on either side, a rank of the cluster without a box of the narrow
# dim, and a width that pads.
HEAD_DIMS = [(d, d) for d in range(64, 1025, 64)] + [
    (512, 320), (320, 512), (512, 64), (64, 512), (448, 64), (192, 448), (512, 1024),
    (1024, 320), (400, 400), (64, 1024), (1024, 64), (640, 1024), (576, 576),
]
GRAD_TOL = {torch.bfloat16: 5e-2, torch.float16: 1e-2}


@pytest.mark.parametrize("d,dv", HEAD_DIMS)
def test_varlen_dq_plan_routes_by_head_dims(d, dv):
    plan = varlen_dq_plan(d, dv)
    d_pad, dv_pad = cdiv(d, D_CHUNK) * D_CHUNK, cdiv(dv, D_CHUNK) * D_CHUNK
    wide = max(d_pad, dv_pad) > WGMMA_MAX_D
    assert plan.route == ("wgmma_cluster" if wide else "wgmma")
    assert plan.q_rows == 64 and plan.kv_rows == 64 and plan.stages >= 3
    assert plan.smem_bytes <= SMEM_LIMIT_BYTES
    assert plan == dq_plan(d, dv)  # the dense block's tiling at every width
    # Each rank's share (one block: all of D) split over the two consumers.
    ranks = [r[0] for r in plan.rank_blocks] if wide else [(0, d_pad)]
    assert len(plan.dq_blocks) == 2 * len(ranks)
    for (c0, width), blocks in zip(ranks, (plan.dq_blocks[:2], plan.dq_blocks[2:])):
        nd = width // D_CHUNK
        assert blocks == ((c0, cdiv(nd, 2) * D_CHUNK),
                          (c0 + cdiv(nd, 2) * D_CHUNK, nd // 2 * D_CHUNK))
    if wide:
        (d0, v0), (d1, v1) = plan.rank_blocks
        for (a0, w0), (a1, w1), width in ((d0, d1, d_pad), (v0, v1, dv_pad)):
            assert a0 == 0 and a1 == w0 and w0 + w1 == width and w0 - w1 in (0, D_CHUNK)
    assert varlen_dq_plan(d_pad, dv_pad) == plan


def test_varlen_dq_plan_d512_holds_five_stages_and_routes_with_dkdv():
    plan = varlen_dq_plan(512, 512)
    assert plan.stages == 5
    assert plan.smem_bytes == 17 * 8192 + 1024 + 8 + 5 * (2 * 8192 + 16)
    wide = varlen_dq_plan(1024, 1024)
    assert wide.stages == 3 and wide.smem_bytes == 223288  # 174,088 fixed + 3 x 16,400
    for d, dv in HEAD_DIMS:
        # Both kernels route by head dims alone, and both walk 64 x 64
        # tiles: one block at D, Dv <= 512, the cluster above.
        wide = max(cdiv(d, D_CHUNK), cdiv(dv, D_CHUNK)) * D_CHUNK > WGMMA_MAX_D
        assert (varlen_dkdv_plan(d, dv).route, varlen_dq_plan(d, dv).route) == (
            ("wgmma_cluster", "wgmma_cluster") if wide else ("wgmma", "wgmma"))


def _meta(seqs, tq=None):
    cu = torch.from_numpy(np.cumsum([0] + seqs).astype(np.int32))
    t = sum(seqs) if tq is None else tq
    return tvar._call_metadata(cu, cu, t, t, "cpu"), t


@pytest.mark.parametrize("seqs", [[20, 9], [7], [30]])
def test_dq_schedule_takes_the_routes_rows_when_block_q_dq_clamps(seqs):
    """A packing of at most 32 query rows, where a config's ``block_q_dq``
    may be 32: the backward's config keeps the default (the launcher reads
    no row tile), and both routes (one block at D512, the cluster at
    D1024) walk 64-row Q tiles, their lists."""
    meta, t = _meta(seqs)
    assert BlockConfig(block_q_dq=32).block_q_dq == 32  # a config may name it
    for d in (512, 1024):
        cfg = pick_varlen_backward_config(d=d, dv=d, dtype=torch.bfloat16)
        assert cfg.block_q_dq == 64
        _, sched = tvar._backward_schedules(meta, t, varlen_dkdv_plan(d, d),
                                            varlen_dq_plan(d, d), True, (-1, -1))
        tiles, count, order = sched
        assert tiles.shape == (cdiv(t, 64), meta[2].shape[0] // 64)
        assert int(count[0]) == 1 and order.tolist() == [0]


# -- on the card ---------------------------------------------------------------


@pytest.mark.parametrize("d,dv", HEAD_DIMS)
def test_varlen_dq_plan_matches_library_on_card(cuda, d, dv):  # noqa: F811
    assert tvar.varlen_dq_kernel_plan(d, dv) == varlen_dq_plan(d, dv)


@pytest.mark.parametrize("route", ["wgmma", "wgmma_cluster"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_wgmma_dq_kernel_spills_nothing_on_card(cuda, dtype, route):  # noqa: F811
    attrs = tvar.varlen_dq_kernel_attrs(route, dtype)
    assert attrs["local_bytes"] == 0 and attrs["registers"] > 0


CARD_CASES = {
    "d512": dict(seqs=[300, 17, 500], d=512, dv=512),
    "d512_dv320": dict(seqs=[300, 17, 500], d=512, dv=320),
    "d320_dv512": dict(seqs=[300, 17, 500], d=320, dv=512),
    "d448_dv64": dict(seqs=[300, 17, 500], d=448, dv=64),  # consumer halves 256 + 192
    "fp16": dict(seqs=[300, 17, 500], d=512, dv=512, dtype=torch.float16),
    "tile_straddles_3_segs": dict(seqs=[20, 9, 50, 3, 300], d=512, dv=512),
    "window": dict(seqs=[300, 17, 500], d=512, dv=512, window=(64, -1)),
    "rows_without_keys": dict(seqs=[150, 40], seqs_k=[30, 40], d=512, dv=512),
    "d1024_cluster": dict(seqs=[300, 17, 500], d=1024, dv=1024),
    "d1024_cluster_fp16": dict(seqs=[300, 17, 500], d=1024, dv=1024, dtype=torch.float16),
    "d640_cluster": dict(seqs=[300, 17, 500], d=640, dv=640),
    "d576_cluster_window": dict(seqs=[300, 17, 500], d=576, dv=576, window=(64, -1)),
    "d1024_dv320_cluster": dict(seqs=[300, 17, 500], d=1024, dv=320),
    "d512_dv1024_cluster": dict(seqs=[300, 17, 500], d=512, dv=1024),
    # A rank without a D box (it sends zero partial S and owns no dQ
    # columns), a rank without a Dv box (zero partial dP).
    "d64_dv1024_cluster": dict(seqs=[300, 17, 500], d=64, dv=1024),
    "d1024_dv64_cluster": dict(seqs=[300, 17, 500], d=1024, dv=64),
    "d1024_cluster_rows_without_keys": dict(seqs=[150, 40], seqs_k=[30, 40], d=1024, dv=1024),
    "d1024_cluster_straddles_3_segs": dict(seqs=[20, 9, 50, 3, 300], d=1024, dv=1024),
}


@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_varlen_dq_kernel_matches_plain_on_card(cuda, name):  # noqa: F811
    """The dQ kernel alone, on the plain forward's (o, lse), against
    ``_varlen_dq_plain`` per row; the schedule of the route the plan picks
    (``_backward_schedules``). Rows with no key give dQ = 0."""
    case = CARD_CASES[name]
    dtype = case.get("dtype", torch.bfloat16)
    d, dv, hq, hkv = case["d"], case["dv"], 8, 4
    seqs, seqs_k = case["seqs"], case.get("seqs_k", case["seqs"])
    tq, tk = sum(seqs), sum(seqs_k)
    gen = torch.Generator(device=cuda).manual_seed(17)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    q, k, v, do = randn(tq, hq, d), randn(tk, hkv, d), randn(tk, hkv, dv), randn(tq, hq, dv)
    cu_q = torch.tensor(np.cumsum([0] + seqs), dtype=torch.int32, device=cuda)
    cu_k = torch.tensor(np.cumsum([0] + seqs_k), dtype=torch.int32, device=cuda)
    window = case.get("window", (-1, -1))
    kw = dict(scale=d ** -0.5, causal=True, softcap=0.0, window=window)
    meta = tvar._call_metadata(cu_q, cu_k, tq, tk, cuda)
    o, lse = tvar._varlen_forward_plain(q, k, v, meta, scale=kw["scale"], causal=True,
                                        window=window)
    delta = tvar._varlen_delta(do, o)
    _, sched = tvar._backward_schedules(meta, tq, varlen_dkdv_plan(d, dv), varlen_dq_plan(d, dv),
                                        True, window)
    ops = tvar._BwdOperands(q, k, v, do, lse, delta, None)
    n0 = tvar._varlen_backward.dq_launches
    got = tvar._varlen_dq_kernel(ops, meta, sched, **kw)
    torch.cuda.synchronize()
    assert tvar._varlen_backward.dq_launches == n0 + 1
    want = tvar._varlen_dq_plain(q, k, v, do, lse, delta, meta, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert bool(torch.isfinite(got).all())
    assert grad_row_rel_err(got, want) < GRAD_TOL[dtype], name
    if name.endswith("rows_without_keys"):  # the first 120 rows keep no key
        assert bool((got[:120] == 0).all())
