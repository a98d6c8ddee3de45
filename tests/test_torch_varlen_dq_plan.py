"""The route and tiling of the packed varlen dQ kernel (``ops/config.py``
``varlen_dq_plan``, the mirror of ``csrc/varlen_bwd.cu``
``tma::make_dq_plan``) and the schedule each route reads.

D and Dv up to 512 take the TMA + wgmma block: 64 Q rows whatever
``block_q_dq`` asks, consumer 0 owning the first ceil(nd / 2) of D's boxes
of dQ and consumer 1 the rest, as many two-box ring stages as the card's
shared memory holds beside Q, dO and the dS box; the block walks the
forward's needed-tile lists at 64 x 64 (``varlen._backward_schedules``).
Wider heads take the mma.sync block at ``block_q_dq`` rows over each Q
tile's [jmin, jmax]. On a card the mirror is held equal to the plan the
library launches with, the wgmma kernel spills nothing, and the kernel is
held against ``_varlen_dq_plain`` per row at bf16 5e-2 / fp16 1e-2
(``tests/test_ffpa_bwd.py:19``) on both routes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_parity import cuda, grad_row_rel_err  # noqa: F401
from ffpa_attn_tpu_torch.ops import varlen as tvar
from ffpa_attn_tpu_torch.ops.config import (
    D_CHUNK,
    FWD_ACC_ELEMS,
    SMEM_LIMIT_BYTES,
    cdiv,
    dq_plan,
    varlen_dkdv_plan,
    varlen_dq_plan,
    varlen_dq_smem_bytes,
)
from ffpa_attn_tpu_torch.ops.dispatch import pick_varlen_backward_config

WGMMA_MAX_D = 512
# D, Dv over 64..1024 in 64-column boxes, odd and unequal box counts, wider
# heads on either side and a width that pads.
HEAD_DIMS = [(d, d) for d in range(64, 1025, 64)] + [
    (512, 320), (320, 512), (512, 64), (64, 512), (448, 64), (192, 448), (512, 1024),
    (1024, 320), (400, 400),
]
GRAD_TOL = {torch.bfloat16: 5e-2, torch.float16: 1e-2}


@pytest.mark.parametrize("d,dv", HEAD_DIMS)
def test_varlen_dq_plan_routes_by_head_dims(d, dv):
    plan = varlen_dq_plan(d, dv)
    d_pad, dv_pad = cdiv(d, D_CHUNK) * D_CHUNK, cdiv(dv, D_CHUNK) * D_CHUNK
    wide = max(d_pad, dv_pad) > WGMMA_MAX_D
    assert plan.route == ("mma_sync" if wide else "wgmma")
    assert plan.kv_rows == 64 and plan.smem_bytes <= SMEM_LIMIT_BYTES
    if plan.route == "wgmma":
        nd = d_pad // D_CHUNK
        assert plan.q_rows == 64 and plan.stages >= 3
        assert plan.dq_blocks == ((0, cdiv(nd, 2) * D_CHUNK),
                                  (cdiv(nd, 2) * D_CHUNK, nd // 2 * D_CHUNK))
        assert plan == dq_plan(d, dv)  # the dense block's tiling
    else:
        assert plan.q_rows in (64, 32) and plan.q_rows * d_pad <= FWD_ACC_ELEMS
        assert plan.dq_blocks == ((0, d_pad),)
        assert plan.smem_bytes == varlen_dq_smem_bytes(plan.q_rows, d_pad, dv_pad)
    assert varlen_dq_plan(d_pad, dv_pad) == plan


def test_varlen_dq_plan_d512_holds_five_stages_and_routes_with_dkdv():
    plan = varlen_dq_plan(512, 512)
    assert plan.stages == 5
    assert plan.smem_bytes == 17 * 8192 + 1024 + 8 + 5 * (2 * 8192 + 16)
    for d, dv in HEAD_DIMS:
        # D, Dv <= 512: both wgmma, one schedule (the forward's walk); above,
        # dK/dV is the cluster and dQ the mma.sync block, each at its tiles.
        wide = max(cdiv(d, D_CHUNK), cdiv(dv, D_CHUNK)) * D_CHUNK > WGMMA_MAX_D
        assert (varlen_dkdv_plan(d, dv).route, varlen_dq_plan(d, dv).route) == (
            ("wgmma_cluster", "mma_sync") if wide else ("wgmma", "wgmma"))


def _meta(seqs, tq=None):
    cu = torch.from_numpy(np.cumsum([0] + seqs).astype(np.int32))
    t = sum(seqs) if tq is None else tq
    return tvar._call_metadata(cu, cu, t, t, "cpu"), t


@pytest.mark.parametrize("seqs", [[20, 9], [7], [30]])
def test_dq_schedule_takes_the_routes_rows_when_block_q_dq_clamps(seqs):
    """A packing of at most 32 query rows clamps ``block_q_dq`` to 32; the
    wgmma route still walks 64-row Q tiles (its lists), the mma.sync route
    (D1024) 32-row ones (its intervals)."""
    meta, t = _meta(seqs)
    for d in (512, 1024):
        cfg = pick_varlen_backward_config(d=d, dv=d, tq=t, dtype=torch.bfloat16)
        assert cfg.block_q_dq == 32
        dkdv, sched = tvar._backward_schedules(meta, t, varlen_dkdv_plan(d, d),
                                               varlen_dq_plan(d, d), cfg.block_q_dq, True,
                                               (-1, -1))
        if d == 512:
            tiles, count, order = sched
            assert tiles.shape == (cdiv(t, 64), meta[2].shape[0] // 64)
            assert int(count[0]) == 1 and order.tolist() == [0]
        else:
            jmin, jmax = sched
            assert jmin.shape[0] == cdiv(t, 32)


# -- on the card ---------------------------------------------------------------


@pytest.mark.parametrize("d,dv", HEAD_DIMS)
def test_varlen_dq_plan_matches_library_on_card(cuda, d, dv):  # noqa: F811
    assert tvar.varlen_dq_kernel_plan(d, dv) == varlen_dq_plan(d, dv)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_wgmma_dq_kernel_spills_nothing_on_card(cuda, dtype):  # noqa: F811
    attrs = tvar.varlen_dq_kernel_attrs("wgmma", dtype)
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
    "d1024_mma_sync": dict(seqs=[300, 17, 500], d=1024, dv=1024),
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
    cfg = pick_varlen_backward_config(d=d, dv=dv, tq=tq, dtype=dtype)
    _, sched = tvar._backward_schedules(meta, tq, varlen_dkdv_plan(d, dv), varlen_dq_plan(d, dv),
                                        cfg.block_q_dq, True, window)
    ops = tvar._BwdOperands(q, k, v, do, lse, delta, None)
    n0 = tvar._varlen_backward.dq_launches
    got = tvar._varlen_dq_kernel(ops, meta, sched, cfg, **kw)
    torch.cuda.synchronize()
    assert tvar._varlen_backward.dq_launches == n0 + 1
    want = tvar._varlen_dq_plain(q, k, v, do, lse, delta, meta, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert bool(torch.isfinite(got).all())
    assert grad_row_rel_err(got, want) < GRAD_TOL[dtype], name
    if name == "rows_without_keys":  # the first 120 rows keep no key
        assert bool((got[:120] == 0).all())
