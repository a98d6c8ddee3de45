"""The route and tiling of the recompute dQ kernel (``ops/config.py``
``dq_plan``, the mirror of ``csrc/flash_bwd.cu`` ``dq::make_plan``) and the
dbias slab's padding.

D and Dv up to 512 take the TMA + wgmma block: 64 Q rows, the dQ columns
split over the two consumer warpgroups in whole 64-column boxes, a ring of
two-box stages in the card's shared memory; wider heads, up to 1024, take
a cluster of two such blocks, each rank holding half of D's and of Dv's
boxes; the packed varlen dQ takes the same plan at every width. On the
CPU the dbias slab, padded to 64 rows, trims to the JAX package's at D !=
Dv. On a card the mirror is held equal to the plan the library launches
with, neither route's kernel spills, and the kernel is held against its
plain version at mixed head dims.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401
    cuda, grad_row_rel_err, jax_modules, randn, rel_err, to_jax, to_torch,
)
from ffpa_attn_tpu_torch.ops import flash_bwd as tbwd
from ffpa_attn_tpu_torch.ops.config import (
    D_CHUNK,
    KV_TILE,
    SMEM_LIMIT_BYTES,
    BlockConfig,
    cdiv,
    dq_plan,
    varlen_dq_plan,
)
from ffpa_attn_tpu_torch.ops.dispatch import pick_backward_config

WGMMA_MAX_D = 512  # the reference's Hopper dQ block covers D, Dv <= 512
CONSUMER_MAX_COLS = 256  # 64 rows x 256 columns fp32: 128 registers a thread
# D = Dv over 320..1024 in 64-column boxes, and D != Dv.
HEAD_DIMS = [(d, d) for d in range(320, 1025, 64)] + [
    (64, 64), (128, 512), (320, 512), (448, 64), (512, 128), (512, 1024), (1024, 320),
    (400, 400), (64, 512), (512, 64),
]


def _tiles(blocks, width):
    """The (first column, width) blocks cover [0, width) in order."""
    start = 0
    for c0, w in blocks:
        assert c0 == start and w % D_CHUNK == 0
        start += w
    return start == width


@pytest.mark.parametrize("d,dv", HEAD_DIMS)
def test_dq_plan_routes_by_head_dims(d, dv):
    plan = dq_plan(d, dv)
    d_pad, dv_pad = cdiv(d, D_CHUNK) * D_CHUNK, cdiv(dv, D_CHUNK) * D_CHUNK
    wide = max(d_pad, dv_pad) > WGMMA_MAX_D
    assert plan.route == ("wgmma_cluster" if wide else "wgmma")
    assert _tiles(plan.dq_blocks, d_pad)
    assert plan.smem_bytes <= SMEM_LIMIT_BYTES
    assert plan.kv_rows == KV_TILE
    assert plan.q_rows == 64 and plan.stages >= 3
    widths = [w for _, w in plan.dq_blocks]
    assert len(widths) == (4 if wide else 2) and max(widths) <= CONSUMER_MAX_COLS
    for c0, c1 in zip(widths[::2], widths[1::2]):
        assert c0 - c1 in (0, D_CHUNK)  # the first consumer takes the odd box
    assert len(plan.rank_blocks) == (2 if wide else 0)
    assert dq_plan(d_pad, dv_pad) == plan


def test_dq_plan_d512_holds_five_stages_beside_q_and_do():
    plan = dq_plan(512, 512)
    assert plan.route == "wgmma" and plan.stages == 5
    assert plan.dq_blocks == ((0, 256), (256, 256))


WIDE_PAIRS = [(x, x) for x in range(576, 1025, 64)] + [
    (d, dv) for d, dv in HEAD_DIMS if max(d, dv) > WGMMA_MAX_D and d != dv]


@pytest.mark.parametrize("d,dv", WIDE_PAIRS)
def test_dq_cluster_plan_splits_d_and_dv_over_the_ranks(d, dv):
    """The cluster's ranks hold halves of D's and Dv's boxes (rank 0 the
    larger), their consumers' dQ blocks tile [0, D) in order, rank by rank,
    and a ring of at least 3 stages fits beside Q, dO, the dS box and the
    32 KB exchange slot."""
    plan = dq_plan(d, dv)
    d_pad, dv_pad = cdiv(d, D_CHUNK) * D_CHUNK, cdiv(dv, D_CHUNK) * D_CHUNK
    assert plan.route == "wgmma_cluster"
    assert plan.stages >= 3 and plan.smem_bytes <= SMEM_LIMIT_BYTES
    (d0, v0), (d1, v1) = plan.rank_blocks
    for (a0, w0), (a1, w1), width in ((d0, d1, d_pad), (v0, v1, dv_pad)):
        assert a0 == 0 and a1 == w0 and w0 + w1 == width and w0 - w1 in (0, D_CHUNK)
    assert _tiles(plan.dq_blocks[:2], d0[1]) and _tiles(plan.dq_blocks, d_pad)
    assert plan.dq_blocks[2][0] == d1[0]


@pytest.mark.parametrize("d,dv", [(576, 576), (1024, 1024), (640, 320), (64, 1024)])
def test_varlen_dq_plan_stays_mma_sync_above_512(d, dv):
    """Above 512 the packed varlen dQ takes the dense route's cluster: the
    same plan, its column blocks and each rank's share included (the name
    is the test's from when it kept a block of its own there)."""
    plan = varlen_dq_plan(d, dv)
    assert plan == dq_plan(d, dv) and plan.route == "wgmma_cluster"
    assert len(plan.rank_blocks) == 2 and len(plan.dq_blocks) == 4
    assert plan.q_rows == 64 and plan.smem_bytes <= SMEM_LIMIT_BYTES


@pytest.mark.parametrize("nq,block_q_dq", [(130, 64), (130, 32), (20, 32), (64, 64)])
def test_dbias_slab_rows_follow_the_route(nq, block_q_dq):
    """Both routes pad the slab's rows to their own 64 (the wgmma block at
    D512 / Dv320, the cluster at D1024), whatever ``block_q_dq`` a config
    asks: the padding covers every row tile a config may name."""
    rows = cdiv(nq, 64) * 64
    assert tbwd.dbias_slab_shape(nq, 150, 512, 320) == (rows, 192)
    assert tbwd.dbias_slab_shape(nq, 150, 1024, 1024) == (rows, 192)
    assert rows % BlockConfig(block_q_dq=block_q_dq).block_q_dq == 0


@pytest.mark.parametrize("d,dv", HEAD_DIMS)
def test_dq_plan_matches_library_on_card(cuda, d, dv):  # noqa: F811
    assert tbwd.dq_kernel_plan(d, dv) == dq_plan(d, dv)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_wgmma_dq_kernel_spills_nothing_on_card(cuda, dtype):  # noqa: F811
    assert tbwd.dq_kernel_attrs("wgmma", dtype)["local_bytes"] == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cluster_dq_kernel_spills_nothing_on_card(cuda, dtype):  # noqa: F811
    """Both dropout instantiations of the cluster route (the larger spill
    of the two)."""
    assert tbwd.dq_kernel_attrs("wgmma_cluster", dtype)["local_bytes"] == 0


# ---------------------------------------------------------------------------
# D != Dv: dQ and the dbias slab against the JAX package, and kernel vs plain
# ---------------------------------------------------------------------------

B, HQ, HKV = 1, 2, 1
SEED = 3
MIXED = {
    # At D 64 the kernel's consumer 1 owns no dQ columns.
    "d64_dv512_causal_bias": dict(d=64, dv=512, nq=130, nkv=150, causal=True, bias="full"),
    "d512_dv320_window_bias_key": dict(d=512, dv=320, nq=160, nkv=160, window=(40, 8),
                                      bias="key"),
    "d128_dv512_causal_bias_f16": dict(d=128, dv=512, nq=100, nkv=140, causal=True, bias="full",
                                       dtype="float16"),
}


def _inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    nq, nkv, d, dv = case["nq"], case["nkv"], case["d"], case["dv"]
    x = {"q": randn(rng, (B, HQ, nq, d)), "k": randn(rng, (B, HKV, nkv, d)),
         "v": randn(rng, (B, HKV, nkv, dv)), "do": randn(rng, (B, HQ, nq, dv))}
    x["bias"] = randn(rng, (B, 1, nq, nkv) if case["bias"] == "full" else (1, 1, 1, nkv))
    return x


def _static(case):
    return dict(scale=1.0 / math.sqrt(case["d"]), is_causal=case.get("causal", False),
                causal_offset=case["nkv"] - case["nq"], dropout_p=0.0, group=HQ // HKV,
                window=case.get("window", (-1, -1)))


@pytest.fixture(scope="module")
def jax_ready():
    jax_modules("jax", "ffpa_attn_tpu.ops.flash_bwd")


def _jax_dq(case, x):
    """The JAX forward's (lse, delta) and the JAX dQ launcher's dQ and
    dbias (interpret mode), as numpy."""
    import jax.numpy as jnp
    from ffpa_attn_tpu.ops import flash_bwd as jbwd
    from ffpa_attn_tpu.ops import flash_fwd as jfwd
    from ffpa_attn_tpu.ops.config import BlockConfig as JaxBlockConfig

    dt = case.get("dtype", "bfloat16")
    st = _static(case)
    q, k, v, do = (to_jax(x[n], dt) for n in ("q", "k", "v", "do"))
    bias = to_jax(x["bias"])
    o, lse = jfwd.flash_attention_forward(q, k, v, bias, scale=st["scale"],
                                          is_causal=st["is_causal"], window=st["window"])
    delta = jnp.sum(do.astype(jnp.float32) * o.astype(jnp.float32), axis=-1)
    dq, dbias = jbwd._dq_launch(
        q, k, v, bias, do, lse, delta, jnp.asarray(SEED, jnp.int32).reshape(1, 1),
        JaxBlockConfig().clamp(case["nq"], case["nkv"]), grad_q_storage_dtype=None,
        interpret=True, **st)
    return (np.asarray(lse, np.float32), np.asarray(delta, np.float32),
            np.asarray(dq, np.float32), np.asarray(dbias, np.float32))


def _port_dq(case, x, lse, delta, device="cpu", grad_q_storage_dtype=None):
    dt = case.get("dtype", "bfloat16")
    t = {n: to_torch(x[n], dt, device) for n in ("q", "k", "v", "do")}
    cfg = pick_backward_config(d=case["d"], dv=case["dv"], nq=case["nq"], nkv=case["nkv"],
                               dtype=t["q"].dtype)
    return tbwd._dq_launch(
        t["q"], t["k"], t["v"], to_torch(x["bias"], device=device), t["do"],
        to_torch(lse, device=device), to_torch(delta, device=device), SEED, cfg,
        grad_q_storage_dtype=grad_q_storage_dtype, **_static(case))


@pytest.mark.parametrize("name", sorted(MIXED))
def test_mixed_head_dims_dq_and_dbias_match_jax(jax_ready, name):
    """dQ [.., D] and the bias gradient, reduced from the slab trimmed to
    (Nq, Nkv), against the JAX launcher's at D != Dv."""
    case = MIXED[name]
    x = _inputs(case)
    lse, delta, want_dq, want_db = _jax_dq(case, x)
    tol = 1e-2 if case.get("dtype") == "float16" else 5e-2
    dq, dbias = _port_dq(case, x, lse, delta)
    assert tuple(dq.shape) == (B, HQ, case["nq"], case["d"])
    assert tuple(dbias.shape) == x["bias"].shape
    assert rel_err(dq, want_dq) < tol, "dq"
    assert rel_err(dbias, want_db) < tol, "dbias"


@pytest.mark.parametrize("name", sorted(MIXED))
def test_mixed_head_dims_match_plain_on_card(cuda, name):  # noqa: F811
    """The kernel (the wgmma route at every case here) against its plain
    version on the same inputs, dQ per row, dbias whole, and fp32 dQ
    storage."""
    case = MIXED[name]
    x = _inputs(case, seed=1)
    dt = case.get("dtype", "bfloat16")
    tol = 1e-2 if dt == "float16" else 5e-2
    from ffpa_attn_tpu_torch.ops.flash_fwd import flash_attention_forward_plain

    st = _static(case)
    q, k, v, do = (to_torch(x[n], dt) for n in ("q", "k", "v", "do"))
    o, lse = flash_attention_forward_plain(q, k, v, to_torch(x["bias"]), scale=st["scale"],
                                           is_causal=st["is_causal"], window=st["window"])
    delta = (do.float() * o.float()).sum(-1)
    lse, delta = lse.numpy(), delta.numpy()
    assert dq_plan(case["d"], case["dv"]).route == "wgmma"
    for storage in (None, "f32"):
        before = tbwd._dq_launch.launches
        kdq, kdb = _port_dq(case, x, lse, delta, cuda, storage)
        torch.cuda.synchronize()
        assert tbwd._dq_launch.launches == before + 1
        pdq, pdb = _port_dq(case, x, lse, delta, "cpu", storage)
        assert kdq.dtype == pdq.dtype
        assert grad_row_rel_err(kdq, pdq) < tol, f"dq {storage}"
        assert rel_err(kdb, pdb) < tol, f"dbias {storage}"
