"""Kernel block-shape configuration + Hopper shared-memory / register cost
model.

What limits a launch on an H100 is the shared memory one block asks for (at
most 227 KB, 232,448 bytes) and, for the forward, the registers that hold
its fp32 O tile. The plans below (``fwd_plan``, ``decode_plan``, ...) count
exactly what the kernels' launchers ask for (the same formulas as in
``csrc/``), so a config picked here is never refused by the card.

* Forward (``csrc/flash_fwd.cu``), one TMA + wgmma block on two routes by
  head dims alone (``fwd_plan`` mirrors the launcher's ``fwd::make_plan``):
  - D and Dv <= 512 (route "wgmma"): a block of 384 threads owns 64 Q rows
    with Q resident in 64 x 64 boxes (64 KB at D512); a producer warpgroup
    streams each KV tile's K and V boxes through a ring of 8 two-box
    stages; two consumer warpgroups each compute S for half of the tile's
    64 KV columns and own half of the fp32 O tile's columns (128
    registers a thread at Dv 512).
  - D or Dv in (512, 1024] (route "wgmma_cluster"): a cluster of two such
    blocks per 64 Q rows, rank r owning half of D's boxes and half of
    Dv's (rank 0 the larger half): each loads only its Q, K and V boxes,
    computes a partial S over its D boxes, exchanges it with the partner
    through distributed shared memory (two 16 KB slots) and accumulates
    P V into its own Dv boxes; a ring of 7 stages.
  The launcher picks this tiling itself; the config's row tile is only
  checked (``fwd_fits``: the retired mma.sync block's shared memory and
  register budget, kept so that the S residual's row padding stays
  what it was) and sets the S residual's row padding.
* Decode (``csrc/decode.cu``), one TMA block for every shape
  (``decode_plan`` mirrors the launcher's ``make_plan``): 16 packed rows, a
  ring of 8 KiB stages; D and Dv <= 512 one consumer warpgroup in a block's
  share of two an SM, wider heads (up to 1024) two that split Dv in one
  block an SM.
* Packed varlen forward (``csrc/varlen_fwd.cu``), two routes by head dims
  alone (``varlen_fwd_plan`` mirrors the launcher's ``tma::make_plan``):
  the dense wgmma forward block's tiling at every width (``fwd_plan``: 64
  Q rows whatever ``block_q`` says; one block at D and Dv <= 512, the
  cluster of two up to 1024), its segment metadata and tile lists read
  from device memory.
* Paged decode (``csrc/paged_decode.cu``), one TMA block for every shape
  (``paged_plan`` mirrors the launcher's ``make_plan``): 16 packed rows,
  boxes of the largest power of two rows dividing the page and 64, a ring
  of 8 KiB stages; D and Dv <= 512 one consumer warpgroup in a block's
  share of two an SM, wider heads (up to 1024) two that split Dv in one
  block an SM; two staging buffers a warpgroup for int8 pools.
* Packed varlen backward (``csrc/varlen_bwd.cu``). dK/dV has two routes by
  head dims alone (``varlen_dkdv_plan`` mirrors the launcher's
  ``tma::make_plan``), the dense wgmma dK/dV block's tiling below at every
  width (``dkdv_plan``: 64 KV rows, 64-row Q tiles, passes of at most 256
  columns; one block at D and Dv <= 512, the cluster of two up to 1024),
  its segment metadata read from device memory. dQ has two
  routes the same way (``varlen_dq_plan`` mirrors the launcher's
  ``tma::make_dq_plan``), the dense wgmma dQ block's tiling below at every
  width (``dq_plan``: 64 Q rows whatever ``block_q_dq`` asks; one block at
  D and Dv <= 512, the cluster of two up to 1024), its segment metadata
  and tile lists read from device memory.
* Dense dK/dV (``csrc/flash_bwd.cu`` namespace ``dkdv``, TMA + wgmma),
  two routes by head dims alone (``dkdv_plan`` mirrors the launcher's
  ``dkdv::make_plan``):
  - D and Dv <= 512 (route "wgmma"): a block of 384 threads owns 64 KV
    rows with K and V resident in shared memory (128 KB at D512) and one
    column pass of at most 256 columns of dK and of dV (128 fp32
    registers of each consumer thread), and streams 64-row Q and dO tiles
    in 64-column boxes through a ring of two-box stages, as deep as shared
    memory allows.
  - D or Dv in (512, 1024] (route "wgmma_cluster"): a cluster of two such
    blocks per 64 KV rows and pass, rank r holding half of D's K boxes
    and half of Dv's V boxes (rank 0 the larger half) and streaming only
    its Q and dO boxes; each rank's consumers compute partial S^T and
    dP^T over its boxes and add the partner's through distributed shared
    memory (one 32 KB slot), then accumulate the pass's share of the
    rank's dK and dV columns; a ring of 3 stages at D = Dv = 1024.
* Backward (``csrc/flash_bwd.cu``):
  - dQ (recompute), two routes by head dims alone (``dq_plan`` mirrors
    the launcher's ``dq::make_plan``). D and Dv <= 512 take a TMA + wgmma
    block (namespace ``dq``): 384 threads own 64 Q rows with Q and dO
    resident in 64 x 64 boxes (128 KB at D = Dv = 512), a producer
    warpgroup streams each KV tile's K, V and again K boxes through a ring
    of two-box stages (5 at D = Dv = 512), and two consumer warpgroups
    each compute S and dP for half of the tile's 64 KV columns and own
    half of the fp32 dQ tile's columns (128 registers a thread at D512).
    D or Dv in (512, 1024] (route "wgmma_cluster"): a cluster of two such
    blocks per 64 Q rows, rank r holding half of D's Q boxes and half of
    Dv's dO boxes (rank 0 the larger half) and streaming only its K and V
    boxes; each rank's consumers compute partial S and dP over its boxes
    and add the partner's through distributed shared memory (one 32 KB
    slot), then accumulate their share of the rank's dQ columns; a ring of
    3 stages at D = Dv = 1024.
  - S-resident tier (bf16): the forward's S residual costs no shared
    memory (it is stored from the softmax's registers). The from-S dK/dV
    pass has two routes, by Dv and ``dkdv_dk_in_kernel`` alone
    (``from_s_plan`` mirrors the launcher's ``from_s::make_plan``). dK
    out of the kernel at Dv <= 512 takes a TMA + wgmma block (namespace
    ``from_s``): 384 threads own 64 KV rows with V resident in 64 x 64
    boxes, a producer warpgroup streams each 64-row Q tile's S box and dO
    boxes through a ring of two-box stages, and two consumer warpgroups
    each compute dP^T for half of the tile's Q columns and own half of
    the fp32 dV tile's columns. Dv in (512, 1024] takes a cluster of two
    such blocks, each holding half of Dv's V boxes and adding the
    partner's partial dP^T to its own through distributed shared memory.
    dK in the kernel takes the mma.sync block: 32 KV rows with V resident,
    the S tile, dO and Q through the chunk ring; at most 512 columns of
    each, because a second column pass would read S after the first had
    overwritten it with dS.
* Banded dQ and banded dK (``csrc/flash_bwd.cu`` namespace ``band``, TMA +
  wgmma, ``csrc/sm90.cuh``): a block of 384 threads (a producer warpgroup,
  two consumer warpgroups) owns 128 output rows (Q rows for dQ, KV rows
  for dK) and one column block of at most 256 columns of D, the 64-column
  chunks split as evenly as possible over ceil(D / 256) blocks. Each stage
  of its 4-deep ring holds a dS tile (128 x 64 or 64 x 128, 16 KB) and the
  K or Q tile (64 rows x the block's columns). The launcher picks this
  tiling itself; ``banded_plan`` mirrors it for the tests and the logs.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import lru_cache
from typing import Optional

# Largest dynamic shared memory a block may opt into on an H100.
SMEM_LIMIT_BYTES = 232_448
# The kernels' KV tile and head-dim chunk width (compile-time in the .cu).
KV_TILE = 64
D_CHUNK = 64
# Stream slots of the cp.async rings (flash_fwd.cu / flash_bwd.cu NST).
FWD_STREAM_STAGES = 4
# fp32 O-tile elements the forward's 512 threads hold in registers (64 each).
FWD_ACC_ELEMS = 64 * 512
# Row tiles the kernels are instantiated for.
FWD_ROW_TILES = (64, 32)
ROW_TILES = (128, 64, 32, 16)  # the row tiles a BlockConfig takes
# Backward tiles of the mma.sync from-S kernel with dK in the kernel
# (flash_bwd.cu): owned KV rows and streamed Q rows (the wgmma routes take
# 64 and 64); DKDV_Q_TILE also pads the dense dS slab's rows and the varlen
# metadata's query side. The dQ kernels' row tiles are FWD_ROW_TILES.
DKDV_KV_TILE = 32
DKDV_Q_TILE = 128
# Columns of dK (and of dV) that block accumulates: 32 rows x 512 columns x
# 2 accumulators = 64 fp32 registers for each of 512 threads.
DKDV_MAX_COLS = 512
# Column padding of the dense dK/dV's dS slab: the KV rows of a wgmma
# dK/dV block, a multiple of the mma.sync block's DKDV_KV_TILE.
DKDV_SLAB_COLS = 64
# Compile-time constants of the wgmma dK/dV block (flash_bwd.cu namespace
# dkdv: ROWS, QROWS, MAX_BOXES * 64, MAX_HEAD_DIM, PASS_BOXES * 64,
# STAGE_BOXES, MAX_STAGES, and the cluster's PART_BUF_BYTES with its 4
# barriers), not settings: dkdv_plan mirrors the launcher with them.
_DKDV_WG_ROWS = 64
_DKDV_WG_Q_ROWS = 64
_DKDV_WG_MAX_D = 512
DKDV_MAX_HEAD_DIM = 1024
_DKDV_WG_PASS_COLS = 256
_DKDV_WG_STAGE_BOXES = 2
_DKDV_WG_MAX_STAGES = 6
_DKDV_CLUSTER_PART_BYTES = 2 * 2 * 64 * 32 * 4 + 4 * 8
# Compile-time constants of the wgmma forward block (flash_fwd.cu namespace
# fwd: ROWS, MAX_BOXES * 64, 2 * MAX_BOXES * 64, STAGE_BOXES, stages_of,
# XCH_BYTES, PART_BUF_BYTES and the exchange's 4 barriers), not settings:
# fwd_plan mirrors the launcher with them.
_FWD_WG_ROWS = 64
_FWD_WG_MAX_D = 512
FWD_MAX_HEAD_DIM = 1024
_FWD_WG_STAGE_BOXES = 2
_FWD_WG_STAGES = 8
_FWD_CLUSTER_STAGES = 7
_FWD_WG_XCH_BYTES = 2 * 64 * 4
_FWD_CLUSTER_PART_BYTES = 2 * 2 * 64 * 32 * 4 + 4 * 8
# Compile-time constants of the wgmma from-S block (flash_bwd.cu namespace
# from_s: ROWS, QROWS, MAX_BOXES * 64, MAX_STAGES, and the cluster's
# XCH_BYTES with the exchange's 4 barriers), not settings: from_s_plan
# mirrors the launcher with them.
_FROM_S_WG_ROWS = 64
_FROM_S_WG_Q_ROWS = 64
_FROM_S_WG_MAX_DV = 512
_FROM_S_WG_MAX_STAGES = 12
_FROM_S_CLUSTER_PART_BYTES = 2 * 2 * 64 * 32 * 4 + 4 * 8
# The from-S pass's widest dV with dK out of the kernel: 1024 columns, a
# cluster of two blocks each holding half.
FROM_S_MAX_DV = 1024
# Compile-time constants of the wgmma recompute dQ block (flash_bwd.cu
# namespace dq: ROWS, KV_ROWS, MAX_BOXES * 64, MAX_HEAD_DIM, MAX_STAGES, and
# the cluster's XCH_BYTES: the exchange's slot and its barriers in a 1 KB
# atom), not settings: dq_plan mirrors the launcher with them.
_DQ_WG_ROWS = 64
_DQ_WG_KV_ROWS = 64
_DQ_WG_MAX_D = 512
DQ_MAX_HEAD_DIM = 1024
_DQ_WG_MAX_STAGES = 8
_DQ_CLUSTER_XCH_BYTES = 2 * 2 * 64 * 32 * 4 + 1024
# Compile-time constants of the TMA paged decode block (paged_decode.cu
# namespace tma: ROWS, MAX_D, STAGE_BYTES, MAX_STAGES, BLOCK_SMEM,
# SPLIT_BLOCK_SMEM, Q_BOX_BYTES, STAGING_BYTES, XCH_FLOATS * 4; above 512 the
# block splits Dv over two consumer warpgroups), not settings: paged_plan
# mirrors the launcher with them.
_PAGED_TMA_ROWS = 16
_PAGED_TMA_MAX_D = 1024
_PAGED_TMA_SPLIT_D = 512
_PAGED_TMA_STAGE_BYTES = 64 * 128
_PAGED_TMA_MAX_STAGES = 12
_PAGED_TMA_BLOCK_SMEM = 115_712
_PAGED_TMA_SPLIT_BLOCK_SMEM = 232_448
_PAGED_TMA_Q_BOX_BYTES = 16 * 128
_PAGED_TMA_STAGING_BYTES = 2 * 64 * 64 * 2
_PAGED_TMA_XCH_BYTES = 2 * 4 * 16 * 4
# Compile-time constants of the TMA decode block (decode.cu namespace tma:
# ROWS, MAX_D, STAGE_BYTES, MAX_STAGES, BLOCK_SMEM, SPLIT_BLOCK_SMEM,
# Q_BOX_BYTES, XCH_FLOATS * 4; above 512 the block splits Dv over two
# consumer warpgroups), not settings: decode_plan mirrors the launcher with
# them.
_DECODE_TMA_ROWS = 16
_DECODE_TMA_MAX_D = 1024
_DECODE_TMA_SPLIT_D = 512
_DECODE_TMA_STAGE_BYTES = 64 * 128
_DECODE_TMA_MAX_STAGES = 12
_DECODE_TMA_BLOCK_SMEM = 115_712
_DECODE_TMA_SPLIT_BLOCK_SMEM = 232_448
_DECODE_TMA_Q_BOX_BYTES = 16 * 128
_DECODE_TMA_XCH_BYTES = 2 * 4 * 16 * 4
# Compile-time constants of the banded dQ / dK blocks (flash_bwd.cu
# namespace band: ROWS, KT, MAX_CHUNKS * COLS, STAGES), not settings:
# banded_plan mirrors the launcher with them.
_BANDED_ROWS = 128
_BANDED_K_TILE = 64
_BANDED_MAX_COLS = 256
_BANDED_STAGES = 4
# Shared-memory row padding, in elements, against bank conflicts.
_PAD_T = 8
_PAD_F = 4


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


# The fewest ring stages each backward walk needs (the C entry points
# refuse a cap below it; a shallower ring would deadlock): dK/dV's
# consumer 1 holds the last stage of its dV run while it frees the (up to
# 2) stages of consumer 0's dK run; a dQ consumer with one box fewer keeps
# the stage of its last product into the next tile's S walk; a from-S tile
# holds its S stage and ceil(nv / 2) dO stages (``from_s_min_stages``).
DKDV_MIN_STAGES = 3
DQ_MIN_STAGES = 3


def _capped(stages: int, ring_cap: int, least: int, what: str) -> int:
    """The ring depth of a launch capped at ``ring_cap`` (0: the plan's
    ``stages``); a cap below ``least`` raises, as the C entry points
    refuse it."""
    if ring_cap < 0 or 0 < ring_cap < least:
        raise ValueError(f"{what}: ring_cap must be 0 or >= {least}, got {ring_cap}")
    return min(stages, ring_cap) if ring_cap else stages


def ring_depth(stages: int, ring_cap: int, least: int) -> int:
    """The ring cap a launcher passes for a config's ``bwd_ring_cap`` on a
    plan of ``stages`` whose walk needs ``least``: 0 (the plan's depth)
    where the cap is 0 or at least the plan's, else the cap raised to
    ``least``. One cap then serves both kernels of the dK/dV and dQ pair,
    whose plans differ in depth."""
    if ring_cap <= 0 or ring_cap >= stages:
        return 0
    return max(ring_cap, least)


@dataclass(frozen=True)
class BlockConfig:
    """Block shapes for the forward, decode and backward kernels.

    A forward / decode block owns ``block_q`` rows of Q (query positions
    for the forward, packed GQA rows for decode) and streams
    ``block_kv``-row K/V tiles. ``dkdv_col_passes`` is the packed varlen
    dK/dV's column passes, its plan's (``varlen_dkdv_plan``): a block owns
    64 KV rows and ``1 / dkdv_col_passes`` of its dK and dV columns.
    ``block_q_dq`` is the JAX package's dQ row tile, kept for parity with
    its API: every dQ launcher of the port picks its own 64-row tile.
    ``dkdv_dk_in_kernel`` picks the from-S dK/dV variant: dK
    accumulated beside dV, or dK left to the banded dK kernel (causal) or
    one product (otherwise) over the dS slab. ``ds_store_bits`` is the
    storage width of the dS-handoff slab: 16 (the input type) or 8
    (float8_e4m3fn, written by the dK/dV kernel from its fp32 dS and
    widened by banded dQ and the non-causal product). 8 is honoured only
    with ``FFPA_TORCH_ALLOW_FP8_DS`` set, for bf16 inputs, a cotangent that
    is not fp16 and no bias; otherwise the backward stores 16 bits. The
    S-resident tier never stores fp8 (its dS is written over the bf16 S
    residual).

    For a forward with D and Dv <= 512 the wgmma launcher picks its own
    64-row tile (``fwd_plan``); there ``block_q`` sets only the row padding
    of the S residual's slab (``flash_fwd.scores_padding``). The recompute
    dQ launcher picks its own 64-row tile at every head dim (``dq_plan``):
    ``block_q_dq`` sets nothing there, and the dbias slab's rows pad to 64.
    So does the packed varlen dQ launcher (``varlen_dq_plan``).

    ``bwd_ring_cap`` is the Hopper kernels' own run-time knob that the
    tuned-config store (``autotune/``) can set: it caps the ring of every
    backward kernel that takes its depth at run time (dense and varlen
    dK/dV, recompute dQ and varlen dQ, the from-S pass's wgmma routes). A
    launch takes ``min(plan's depth, cap)``, and never fewer stages than its
    walk holds at once (``ring_depth``); 0, the default, is the plan's
    depth."""

    block_q: int = 64
    block_kv: int = KV_TILE
    block_q_dq: int = 64
    dkdv_col_passes: int = 1
    dkdv_dk_in_kernel: bool = True
    ds_store_bits: int = 16
    bwd_ring_cap: int = 0

    def __post_init__(self):
        if self.ds_store_bits not in (8, 16):
            raise ValueError(f"ds_store_bits must be 8 or 16, got {self.ds_store_bits}")
        if self.block_q not in ROW_TILES:
            raise ValueError(
                f"block_q must be one of {ROW_TILES}, got {self.block_q}"
            )
        if self.block_q_dq not in FWD_ROW_TILES:
            raise ValueError(
                f"block_q_dq must be one of {FWD_ROW_TILES}, got {self.block_q_dq}"
            )
        if self.block_kv != KV_TILE:
            raise ValueError(
                f"block_kv must be {KV_TILE} (the tile the kernels are compiled "
                f"for), got {self.block_kv}"
            )
        if self.dkdv_col_passes < 1:
            raise ValueError(f"dkdv_col_passes must be >= 1, got {self.dkdv_col_passes}")
        if self.bwd_ring_cap < 0:
            raise ValueError(f"bwd_ring_cap must be >= 0, got {self.bwd_ring_cap}")

    def clamp(self, nq: int, nkv: int, tiles=ROW_TILES) -> "BlockConfig":
        """Shrink the row tile to the smallest of ``tiles`` that covers the
        problem's rows (never below the smallest of ``tiles``)."""
        fit = min((t for t in tiles if t >= nq), default=max(tiles))
        return replace(self, block_q=min(self.block_q, max(fit, min(tiles))))


def fwd_smem_bytes(cfg: BlockConfig, d: int, dv: int, itemsize: int = 2) -> int:
    """Shared memory of one mma.sync forward block (retired; ``fwd_fits``
    keeps its budget for the S residual's row padding): resident Q [bq, D]
    + the K/V chunk ring + fp32 S [bq, bkv] + P [bq, bkv] + per-row m, l,
    alpha. Dv costs registers, not shared memory; so does the S residual of
    ``return_scores``, stored from the softmax's registers."""
    del dv
    bq, bkv = cfg.block_q, cfg.block_kv
    q_res = bq * (_round_up(d, D_CHUNK) + _PAD_T) * itemsize
    ring = FWD_STREAM_STAGES * bkv * (D_CHUNK + _PAD_T) * itemsize
    s_tile = bq * (bkv + _PAD_F) * 4
    p_tile = bq * (D_CHUNK + _PAD_T) * itemsize
    return q_res + ring + s_tile + p_tile + 3 * bq * 4


def fwd_fits(cfg: BlockConfig, d: int, dv: int, itemsize: int = 2) -> bool:
    """Whether the forward takes this row tile at (D, Dv): the mma.sync
    block's budget (``fwd_smem_bytes``, block_q * Dv <= FWD_ACC_ELEMS). The
    dense forward's wgmma routes pick their own 64-row tile; there the row
    tile only sets the S residual's row padding, so keeping this gate keeps
    the slab's shape (and its consumers') as it was on every route."""
    return (
        cfg.block_q in FWD_ROW_TILES
        and cfg.block_q * _round_up(dv, D_CHUNK) <= FWD_ACC_ELEMS
        and fwd_smem_bytes(cfg, d, dv, itemsize) <= SMEM_LIMIT_BYTES
    )


@dataclass(frozen=True)
class FwdPlan:
    """The route and tiling of one forward launch, as ``csrc/flash_fwd.cu``
    ``fwd::make_plan`` computes it (the library hands its own out through
    ``flash_fwd.fwd_kernel_plan``; the card test holds the two equal). The
    packed varlen forward's plan (``varlen_fwd_plan``) has the same fields.

    ``route`` is "wgmma" (D and Dv <= 512) or "wgmma_cluster" (up to
    1024); ``q_rows`` a block's Q rows, ``kv_rows`` a KV tile's rows,
    ``stages`` the ring's depth, ``smem_bytes`` the dynamic shared memory a
    block asks for and ``o_blocks`` the (first column, width) of O that
    each consumer warpgroup accumulates, rank by rank on the cluster.
    ``rank_blocks`` holds, for each rank of the cluster, its ((first D
    column, D width), (first Dv column, Dv width)); it is empty where one
    block holds all of D and Dv.
    """

    route: str
    q_rows: int
    kv_rows: int
    stages: int
    smem_bytes: int
    o_blocks: tuple
    rank_blocks: tuple = ()


def fwd_plan(d: int, dv: int) -> FwdPlan:
    """The forward route by head dims alone (padded to 64-column chunks, at
    most 1024; 16-bit inputs). D and Dv <= 512 take one wgmma block, with a
    ring of 8 stages (two 64 x 64 boxes each) beside Q, the P box and the
    row exchange. Wider heads take a cluster of two such blocks, rank r
    holding its half of D's boxes and of Dv's (``_even_blocks``: rank 0 the
    larger), with a ring of 7 stages beside rank 0's Q boxes and the
    partial-score exchange. In each block consumer 0 owns the first
    ceil(nv / 2) of the block's nv Dv boxes and consumer 1 the rest."""
    nd, nv = cdiv(d, D_CHUNK), cdiv(dv, D_CHUNK)
    if max(nd, nv) * D_CHUNK > FWD_MAX_HEAD_DIM:
        raise ValueError(f"the forward kernel takes D, Dv <= {FWD_MAX_HEAD_DIM}, got D={d}, "
                         f"Dv={dv}")
    split = max(nd, nv) * D_CHUNK > _FWD_WG_MAX_D
    ranks = 2 if split else 1
    d_blocks, v_blocks = _even_blocks(nd, ranks), _even_blocks(nv, ranks)
    o_blocks = []
    for v0, width in v_blocks:
        boxes = width // D_CHUNK
        nv0 = cdiv(boxes, 2)
        o_blocks += [(v0, nv0 * D_CHUNK), (v0 + nv0 * D_CHUNK, (boxes - nv0) * D_CHUNK)]
    stages = _FWD_CLUSTER_STAGES if split else _FWD_WG_STAGES
    box = _FWD_WG_ROWS * D_CHUNK * 2
    smem = ((d_blocks[0][1] // D_CHUNK + 1) * box + 1024 + 8 + _FWD_WG_XCH_BYTES
            + (_FWD_CLUSTER_PART_BYTES if split else 0)
            + stages * (_FWD_WG_STAGE_BOXES * box + 16))
    return FwdPlan("wgmma_cluster" if split else "wgmma", _FWD_WG_ROWS, KV_TILE, stages, smem,
                   tuple(o_blocks), tuple(zip(d_blocks, v_blocks)) if split else ())


@dataclass(frozen=True)
class DecodePlan:
    """The tiling of one decode launch, as ``csrc/decode.cu`` ``make_plan``
    computes it (the library hands its own out through
    ``decode.decode_kernel_plan``; the card test holds the two equal).

    ``route`` is "tma", the only one; ``rows`` the packed rows of a block (a
    taller packing takes ``cdiv(R, rows)`` row blocks), ``stages`` the
    ring's depth, ``smem_bytes`` the dynamic shared memory a block asks
    for, ``consumers`` its consumer warpgroups (2 above D512: they split
    Dv) and ``blocks_per_sm`` the blocks an SM holds at once.
    """

    route: str
    rows: int
    stages: int
    smem_bytes: int
    consumers: int
    blocks_per_sm: int


@lru_cache(maxsize=None)
def decode_plan(d: int, dv: int, rows: int) -> DecodePlan:
    """The decode tiling at head dims (d, dv) (padded to 64-column chunks,
    at most 1024) and ``rows`` packed rows (group * nq; the plan does not
    depend on them): 16 packed rows; D and Dv <= 512 one consumer warpgroup
    in a block's share of two an SM, wider heads two (each holding half of
    Dv's boxes) in one block an SM; as many 8 KiB stages (at most 12) as
    fit beside Q's boxes and, per warpgroup, the P box and the exchange."""
    del rows
    d_pad, dv_pad = _round_up(d, D_CHUNK), _round_up(dv, D_CHUNK)
    if min(d_pad, dv_pad) < D_CHUNK or max(d_pad, dv_pad) > _DECODE_TMA_MAX_D:
        raise ValueError(f"decode takes head dims in 1..{_DECODE_TMA_MAX_D}, got D={d}, Dv={dv}")
    split = max(d_pad, dv_pad) > _DECODE_TMA_SPLIT_D
    wgs = 2 if split else 1
    fixed = (1024 + (d_pad // D_CHUNK) * _DECODE_TMA_Q_BOX_BYTES
             + wgs * (_DECODE_TMA_Q_BOX_BYTES + _DECODE_TMA_XCH_BYTES))
    stage = _DECODE_TMA_STAGE_BYTES + 16
    budget = _DECODE_TMA_SPLIT_BLOCK_SMEM if split else _DECODE_TMA_BLOCK_SMEM
    stages = min(_DECODE_TMA_MAX_STAGES, (budget - fixed) // stage)
    return DecodePlan("tma", _DECODE_TMA_ROWS, stages, fixed + stages * stage, wgs,
                      1 if split else 2)


def varlen_fwd_plan(d: int, dv: int) -> FwdPlan:
    """The packed varlen forward's route by head dims alone (padded to
    64-column chunks, at most 1024), as ``csrc/varlen_fwd.cu``
    ``tma::make_plan`` computes it (the library hands its own out through
    ``varlen.varlen_fwd_kernel_plan``; the card test holds the two equal):
    the dense ``fwd_plan`` at every width. Its block reads the segment
    metadata and the tile lists from device memory, so they cost no shared
    memory."""
    return fwd_plan(d, dv)


def varlen_fits(cfg: BlockConfig, d: int, dv: int, itemsize: int = 2) -> bool:
    """Whether the varlen forward takes this row tile at (D, Dv). Both
    routes take their own 64-row tile whatever ``block_q`` says, so any of
    FWD_ROW_TILES is accepted where the plan's block fits shared memory
    and the head dims are at most 1024."""
    del itemsize
    if cfg.block_q not in FWD_ROW_TILES or max(_round_up(d, D_CHUNK),
                                               _round_up(dv, D_CHUNK)) > FWD_MAX_HEAD_DIM:
        return False
    return varlen_fwd_plan(d, dv).smem_bytes <= SMEM_LIMIT_BYTES


@dataclass(frozen=True)
class PagedPlan:
    """The tiling of one paged decode launch, as ``csrc/paged_decode.cu``
    ``make_plan`` computes it (the library hands its own out through
    ``paged.paged_kernel_plan``; the card test holds the two equal).

    ``route`` is "tma", the only one; ``rows`` the packed rows of a block
    (a taller packing takes ``cdiv(R, rows)`` row blocks), ``box_rows`` the
    rows of a TMA box, ``stages`` the ring's depth, ``smem_bytes`` the
    dynamic shared memory a block asks for, ``consumers`` its consumer
    warpgroups (2 above D512: they split Dv) and ``blocks_per_sm`` the
    blocks an SM holds at once.
    """

    route: str
    rows: int
    box_rows: int
    stages: int
    smem_bytes: int
    consumers: int
    blocks_per_sm: int


def paged_plan(d: int, dv: int, page: int, quantized: bool = False) -> PagedPlan:
    """The paged decode tiling at head dims (d, dv) (padded to 64-column
    chunks, at most 1024) over pages of ``page`` rows: 16 packed rows; TMA
    boxes of the largest power of two rows dividing the page and 64 (so a
    box never crosses a page); D and Dv <= 512 one consumer warpgroup in a
    block's share of two an SM, wider heads two (each holding half of Dv's
    stages) in one block an SM; as many 8 KiB stages (at most 12) as fit
    beside Q's boxes and, per warpgroup, the P box, the exchange and (int8)
    the two staging buffers."""
    d_pad, dv_pad = _round_up(d, D_CHUNK), _round_up(dv, D_CHUNK)
    if min(d_pad, dv_pad) < D_CHUNK or max(d_pad, dv_pad) > _PAGED_TMA_MAX_D:
        raise ValueError(f"paged decode takes head dims in 1..{_PAGED_TMA_MAX_D}, got D={d}, "
                         f"Dv={dv}")
    if page < 1:
        raise ValueError(f"paged decode takes pages of 1 row or more, got {page}")
    box_rows = KV_TILE
    while page % box_rows:
        box_rows //= 2
    split = max(d_pad, dv_pad) > _PAGED_TMA_SPLIT_D
    wgs = 2 if split else 1
    fixed = (1024 + (d_pad // D_CHUNK) * _PAGED_TMA_Q_BOX_BYTES
             + wgs * ((2 * _PAGED_TMA_STAGING_BYTES if quantized else 0)
                      + _PAGED_TMA_Q_BOX_BYTES + _PAGED_TMA_XCH_BYTES))
    stage = _PAGED_TMA_STAGE_BYTES + 16
    budget = _PAGED_TMA_SPLIT_BLOCK_SMEM if split else _PAGED_TMA_BLOCK_SMEM
    stages = min(_PAGED_TMA_MAX_STAGES, (budget - fixed) // stage)
    return PagedPlan("tma", _PAGED_TMA_ROWS, box_rows, stages, fixed + stages * stage, wgs,
                     1 if split else 2)


@dataclass(frozen=True)
class FromSPlan:
    """The route and tiling of one from-S dK/dV launch, as
    ``csrc/flash_bwd.cu`` ``from_s::make_plan`` computes it (the library
    hands its own out through ``flash_bwd.from_s_kernel_plan``; the card
    test holds the two equal).

    ``route`` is "wgmma" (dK out of the kernel, Dv <= 512),
    "wgmma_cluster" (dK out, Dv in (512, 1024]) or "mma_sync" (dK in the
    kernel); ``kv_rows`` a block's KV rows (the slab's column tile),
    ``q_rows`` the streamed Q rows, ``stages`` the ring's depth,
    ``smem_bytes`` the dynamic shared memory a block asks for and
    ``dv_blocks`` the (first column, width) of dV each consumer owns, rank
    by rank on the cluster (one block on mma.sync; a width may be 0).
    ``rank_blocks`` holds the (first column, width) of Dv each rank of the
    cluster holds; it is empty where one block holds all of Dv.
    """

    route: str
    kv_rows: int
    q_rows: int
    stages: int
    smem_bytes: int
    dv_blocks: tuple
    rank_blocks: tuple = ()


def from_s_min_stages(dv: int) -> int:
    """The fewest ring stages a wgmma from-S tile holds at once at value
    head dim ``dv``: its S stage and ceil(nv / 2) dO stages of a block's
    (rank 0's, the larger) Dv boxes."""
    nv = cdiv(dv, D_CHUNK)
    return 1 + cdiv(_even_blocks(nv, 2 if nv * D_CHUNK > _FROM_S_WG_MAX_DV else 1)[0][1]
                    // D_CHUNK, 2)


def from_s_plan(dv: int, dk_in_kernel: bool, itemsize: int = 2,
                ring_cap: int = 0) -> FromSPlan:
    """The from-S route by Dv (padded to 64-column chunks) and
    ``dk_in_kernel`` alone. dK out of the kernel takes the wgmma block at
    Dv <= 512 and a cluster of two such blocks up to 1024, rank r holding
    its half of Dv's boxes (``_even_blocks``: rank 0 the larger); within a
    block consumer 0 owns the first ceil(n / 2) of its n boxes, with as
    many ring stages (two 64 x 64 boxes each, at most 12) as fit beside V,
    the P and dS boxes and, on the cluster, the partial exchange's two
    slots (both ranks lay out rank 0's share). dK in the kernel takes the
    mma.sync block: 32 KV rows, resident V [32, Dv], the ring of 128-row
    slots (S tile, dO and Q chunks), P and dS [32, 128] and the Q tile's
    lse and delta (no K tile: S is read, not recomputed; D costs registers
    only). ``ring_cap`` caps the wgmma routes' ring (``_capped``, at least
    ``from_s_min_stages``; the mma.sync route takes none) and
    ``smem_bytes`` follows."""
    nv = cdiv(dv, D_CHUNK)
    if not dk_in_kernel and nv * D_CHUNK <= FROM_S_MAX_DV:
        split = nv * D_CHUNK > _FROM_S_WG_MAX_DV
        ranks = _even_blocks(nv, 2 if split else 1)
        box = _FROM_S_WG_Q_ROWS * D_CHUNK * itemsize
        fixed = ((ranks[0][1] // D_CHUNK + 2) * box + 1024 + 8
                 + (_FROM_S_CLUSTER_PART_BYTES if split else 0))
        stage = 2 * box + 16
        stages = _capped(min(_FROM_S_WG_MAX_STAGES, (SMEM_LIMIT_BYTES - fixed) // stage),
                         ring_cap, from_s_min_stages(dv), "from_s_plan")
        dv_blocks = tuple((c0 + x0, w) for c0, width in ranks
                          for x0, w in _even_blocks(width // D_CHUNK, 2))
        return FromSPlan("wgmma_cluster" if split else "wgmma", _FROM_S_WG_ROWS,
                         _FROM_S_WG_Q_ROWS, stages, fixed + stages * stage, dv_blocks,
                         ranks if split else ())
    if ring_cap:
        raise ValueError("from_s_plan: the mma.sync route (dK in the kernel) takes no ring_cap")
    v_res = DKDV_KV_TILE * (nv * D_CHUNK + _PAD_T)
    ring = FWD_STREAM_STAGES * DKDV_Q_TILE * (D_CHUNK + _PAD_T)
    p_ds = 2 * DKDV_KV_TILE * (DKDV_Q_TILE + _PAD_T)
    smem = (v_res + ring + p_ds) * itemsize + 2 * DKDV_Q_TILE * 4
    return FromSPlan("mma_sync", DKDV_KV_TILE, DKDV_Q_TILE, FWD_STREAM_STAGES, smem,
                     ((0, nv * D_CHUNK),))


def from_s_fits(d: int, dv: int, dk_in_kernel: bool, itemsize: int = 2) -> bool:
    """Whether the from-S kernel takes (D, Dv): dK in kernel only in one
    column pass (at most 512 columns of each); dV alone up to 1024 (the
    cluster above 512); and the planned block in shared memory."""
    dp, dvp = _round_up(d, D_CHUNK), _round_up(dv, D_CHUNK)
    cols_ok = (dp <= DKDV_MAX_COLS and dvp <= DKDV_MAX_COLS) if dk_in_kernel else \
        dvp <= FROM_S_MAX_DV
    return cols_ok and from_s_plan(dv, dk_in_kernel, itemsize).smem_bytes <= SMEM_LIMIT_BYTES


@dataclass(frozen=True)
class BandedPlan:
    """The tiling of one banded-dQ or banded-dK launch, as
    ``csrc/flash_bwd.cu`` ``band::make_plan`` computes it (the library
    hands its own out through ``flash_bwd.banded_kernel_plan``; the card
    test holds the two equal).

    ``col_blocks`` are the (first column, width) pairs that tile the padded
    D, one per grid column; ``rows`` the output rows of a block, ``k_tile``
    the k-step of a stage, ``stages`` the ring's depth and ``smem_bytes``
    the dynamic shared memory a block asks for (stages, their mbarriers and
    the 1024 B alignment of the swizzled stages).
    """

    col_blocks: tuple
    rows: int
    k_tile: int
    stages: int
    smem_bytes: int


def banded_plan(d: int, itemsize: int = 2, ds_itemsize: Optional[int] = None) -> BandedPlan:
    """Column blocks of D (padded to 64-column chunks): ceil(D / 256) of
    them, the chunks split as evenly as possible, the first blocks one
    chunk wider; a stage holds the dS tile the consumers read (``itemsize``
    bytes an element) and the widest block's K / Q tile. A dS slab of
    ``ds_itemsize`` 1 (e4m3, banded dQ only) adds the 1-byte tile TMA
    loads beside the 16-bit tile it is widened into."""
    chunks = cdiv(d, D_CHUNK)
    nb = cdiv(chunks, _BANDED_MAX_COLS // D_CHUNK)
    blocks = _even_blocks(chunks, nb)
    widest = blocks[0][1]
    stage = (_BANDED_ROWS + widest) * _BANDED_K_TILE * itemsize
    if ds_itemsize is not None and ds_itemsize < itemsize:
        stage += _BANDED_ROWS * _BANDED_K_TILE * ds_itemsize
    smem = _BANDED_STAGES * stage + 2 * _BANDED_STAGES * 8 + 1024
    return BandedPlan(blocks, _BANDED_ROWS, _BANDED_K_TILE, _BANDED_STAGES, smem)


@dataclass(frozen=True)
class DkdvPlan:
    """The route and tiling of one dense dK/dV launch, as
    ``csrc/flash_bwd.cu`` ``dkdv::make_plan`` computes it (the library
    hands its own out through ``flash_bwd.dkdv_kernel_plan``; the card test
    holds the two equal), or of one packed varlen dK/dV launch
    (``varlen_dkdv_plan``: the same tiling).

    ``route`` is "wgmma" (D and Dv <= 512) or "wgmma_cluster" (up to
    1024); ``passes`` the column passes, ``d_blocks`` / ``dv_blocks`` the
    (first column, width) of dK / dV each block of a KV tile owns, pass by
    pass (rank by rank, then pass by pass, on the cluster; a width may be
    0);
    ``kv_rows`` a block's KV rows, ``q_rows`` the streamed Q rows,
    ``stages`` the ring's depth and ``smem_bytes`` the dynamic shared
    memory a block asks for. ``rank_blocks`` holds, for each rank of the
    cluster, its ((first D column, D width), (first Dv column, Dv width));
    it is empty where one block holds all of D and Dv.
    """

    route: str
    passes: int
    kv_rows: int
    q_rows: int
    stages: int
    smem_bytes: int
    d_blocks: tuple
    dv_blocks: tuple
    rank_blocks: tuple = ()


def _even_blocks(chunks: int, nb: int) -> tuple:
    """``chunks`` 64-column chunks over ``nb`` blocks as evenly as
    possible, the first blocks one chunk wider (``sm90.cuh`` ``col_block``)."""
    base, extra = divmod(chunks, nb)
    blocks, c0 = [], 0
    for i in range(nb):
        width = (base + (1 if i < extra else 0)) * D_CHUNK
        blocks.append((c0, width))
        c0 += width
    return tuple(blocks)


def dkdv_plan(d: int, dv: int, itemsize: int = 2, ring_cap: int = 0) -> DkdvPlan:
    """The dense dK/dV route by head dims alone (padded to 64-column
    chunks, at most 1024; 16-bit inputs). D and Dv <= 512 take one wgmma
    block; wider heads a cluster of two such blocks, rank r holding its
    half of D's boxes and of Dv's (``_even_blocks``: rank 0 the larger).
    A block takes ceil(max(its D boxes, its Dv boxes) / 4) passes (rank
    0's on the cluster, for both ranks), each of its dK and dV boxes split
    evenly over them, and as many ring stages (two 64 x 64 boxes each, at
    most 6) as fit beside K, V, the P / dS boxes and, on the cluster, the
    partial exchange's slot (both ranks lay out rank 0's share).
    ``ring_cap`` caps the ring (``_capped``, at least DKDV_MIN_STAGES) and
    ``smem_bytes`` follows."""
    nd, nv = cdiv(d, D_CHUNK), cdiv(dv, D_CHUNK)
    if max(nd, nv) * D_CHUNK > DKDV_MAX_HEAD_DIM:
        raise ValueError(f"the dK/dV kernel takes D, Dv <= {DKDV_MAX_HEAD_DIM}, got D={d}, "
                         f"Dv={dv}")
    split = max(nd, nv) * D_CHUNK > _DKDV_WG_MAX_D
    ranks = 2 if split else 1
    d_ranks, v_ranks = _even_blocks(nd, ranks), _even_blocks(nv, ranks)
    lay_nd, lay_nv = d_ranks[0][1] // D_CHUNK, v_ranks[0][1] // D_CHUNK
    per = _DKDV_WG_PASS_COLS // D_CHUNK
    passes = max(cdiv(lay_nd, per), cdiv(lay_nv, per))
    box = _DKDV_WG_Q_ROWS * D_CHUNK * itemsize
    fixed = ((lay_nd + lay_nv + 2) * box + 1024 + 8
             + (_DKDV_CLUSTER_PART_BYTES if split else 0))
    stage = _DKDV_WG_STAGE_BOXES * box + 16
    stages = _capped(min(_DKDV_WG_MAX_STAGES, (SMEM_LIMIT_BYTES - fixed) // stage), ring_cap,
                     DKDV_MIN_STAGES, "dkdv_plan")

    def pass_blocks(rank_blocks):
        return tuple((c0 + x0, w) for c0, width in rank_blocks
                     for x0, w in _even_blocks(width // D_CHUNK, passes))

    return DkdvPlan("wgmma_cluster" if split else "wgmma", passes, _DKDV_WG_ROWS,
                    _DKDV_WG_Q_ROWS, stages, fixed + stages * stage, pass_blocks(d_ranks),
                    pass_blocks(v_ranks), tuple(zip(d_ranks, v_ranks)) if split else ())


def varlen_dkdv_plan(d: int, dv: int, itemsize: int = 2, ring_cap: int = 0) -> DkdvPlan:
    """The packed varlen dK/dV route by head dims alone (padded to
    64-column chunks, at most 1024), as ``csrc/varlen_bwd.cu``
    ``tma::make_plan`` computes it (the library hands its own out through
    ``varlen.varlen_dkdv_kernel_plan``; the card test holds the two equal):
    the dense ``dkdv_plan`` at every width, one wgmma block at D and Dv <=
    512 and the cluster of two up to 1024 (the block reads its segment
    metadata and schedule from device memory, so they cost no shared
    memory), ``ring_cap`` as there."""
    return dkdv_plan(d, dv, itemsize, ring_cap)


@dataclass(frozen=True)
class DqPlan:
    """The route and tiling of one recompute dQ launch, as
    ``csrc/flash_bwd.cu`` ``dq::make_plan`` computes it (the library hands
    its own out through ``flash_bwd.dq_kernel_plan``; the card test holds
    the two equal), or of one packed varlen dQ launch (``varlen_dq_plan``:
    the same tiling).

    ``route`` is "wgmma" (D and Dv <= 512) or "wgmma_cluster" (up to
    1024); ``q_rows`` a block's Q rows, ``kv_rows`` a KV tile's rows,
    ``stages`` the ring's depth, ``smem_bytes`` the dynamic shared memory a
    block asks for and ``dq_blocks`` the (first column, width) of dQ each
    consumer warpgroup accumulates (rank by rank on the cluster; a width
    may be 0). ``rank_blocks`` holds, for each rank of the cluster, its
    ((first D column, D width), (first Dv column, Dv width)); it is empty
    where one block holds all of D and Dv.
    """

    route: str
    q_rows: int
    kv_rows: int
    stages: int
    smem_bytes: int
    dq_blocks: tuple
    rank_blocks: tuple = ()


def dq_plan(d: int, dv: int, itemsize: int = 2, ring_cap: int = 0) -> DqPlan:
    """The recompute dQ route by head dims alone (padded to 64-column
    chunks, at most 1024; 16-bit inputs): D and Dv <= 512 take one wgmma
    block, wider heads a cluster of two such blocks, rank r holding its
    half of D's boxes and of Dv's (``_even_blocks``: rank 0 the larger).
    Within a block (a rank) consumer 0 owns the first ceil(nd / 2) of its
    nd D boxes of dQ and consumer 1 the rest, with as many ring stages (two
    64 x 64 boxes each, at most 8) as fit beside Q, dO, the dS box and, on
    the cluster, the partial exchange's slot (both ranks lay out rank 0's
    share). ``ring_cap`` caps the ring (``_capped``, at least
    DQ_MIN_STAGES) and ``smem_bytes`` follows."""
    nd, nv = cdiv(d, D_CHUNK), cdiv(dv, D_CHUNK)
    if max(nd, nv) * D_CHUNK > DQ_MAX_HEAD_DIM:
        raise ValueError(f"the dQ kernel takes D, Dv <= {DQ_MAX_HEAD_DIM}, got D={d}, Dv={dv}")
    split = max(nd, nv) * D_CHUNK > _DQ_WG_MAX_D
    ranks = 2 if split else 1
    d_ranks, v_ranks = _even_blocks(nd, ranks), _even_blocks(nv, ranks)
    lay_nd, lay_nv = d_ranks[0][1] // D_CHUNK, v_ranks[0][1] // D_CHUNK
    box = _DQ_WG_ROWS * D_CHUNK * itemsize
    fixed = (lay_nd + lay_nv + 1) * box + 1024 + 8 + (_DQ_CLUSTER_XCH_BYTES if split else 0)
    stage = 2 * box + 16
    stages = _capped(min(_DQ_WG_MAX_STAGES, (SMEM_LIMIT_BYTES - fixed) // stage), ring_cap,
                     DQ_MIN_STAGES, "dq_plan")
    blocks = tuple((c0 + x0, w) for c0, width in d_ranks
                   for x0, w in _even_blocks(width // D_CHUNK, 2))
    return DqPlan("wgmma_cluster" if split else "wgmma", _DQ_WG_ROWS, _DQ_WG_KV_ROWS, stages,
                  fixed + stages * stage, blocks, tuple(zip(d_ranks, v_ranks)) if split else ())


def varlen_dq_plan(d: int, dv: int, itemsize: int = 2, ring_cap: int = 0) -> DqPlan:
    """The packed varlen dQ route by head dims alone (padded to 64-column
    chunks, at most 1024), as ``csrc/varlen_bwd.cu`` ``tma::make_dq_plan``
    computes it (the library hands its own out through
    ``varlen.varlen_dq_kernel_plan``; the card test holds the two equal):
    the dense ``dq_plan`` at every width, one wgmma block at D and Dv <=
    512 and the cluster of two up to 1024, 64 Q rows whatever
    ``block_q_dq`` asks (the block reads its segment metadata and tile
    lists from device memory, so they cost no shared memory), ``ring_cap``
    as there."""
    return dq_plan(d, dv, itemsize, ring_cap)


def default_config(
    d: int,
    dv: int,
    nq: int,
    nkv: int,
    itemsize: int = 2,
) -> BlockConfig:
    """Forward row tile: 64 where ``fwd_fits`` (Dv <= 512), else 32; shrunk
    to 32 for short queries. The dense forward's kernels take their own
    64-row tile, so this sets the S residual's row padding there and the
    packed varlen forward's row tile on its mma.sync route."""
    for bq in FWD_ROW_TILES:
        cfg = BlockConfig(block_q=bq).clamp(nq, nkv, FWD_ROW_TILES)
        if fwd_fits(cfg, d, dv, itemsize):
            return cfg
    raise ValueError(f"no forward row tile fits D={d}, Dv={dv}")


__all__ = [
    "BlockConfig",
    "SMEM_LIMIT_BYTES",
    "KV_TILE",
    "D_CHUNK",
    "FWD_ROW_TILES",
    "FWD_MAX_HEAD_DIM",
    "ROW_TILES",
    "cdiv",
    "fwd_smem_bytes",
    "fwd_fits",
    "FwdPlan",
    "fwd_plan",
    "DecodePlan",
    "decode_plan",
    "varlen_fwd_plan",
    "varlen_fits",
    "PagedPlan",
    "paged_plan",
    "default_config",
    "DKDV_KV_TILE",
    "DKDV_Q_TILE",
    "DKDV_MAX_COLS",
    "DKDV_SLAB_COLS",
    "DKDV_MAX_HEAD_DIM",
    "DkdvPlan",
    "dkdv_plan",
    "DQ_MAX_HEAD_DIM",
    "DqPlan",
    "dq_plan",
    "varlen_dkdv_plan",
    "varlen_dq_plan",
    "FROM_S_MAX_DV",
    "FromSPlan",
    "from_s_plan",
    "from_s_fits",
    "from_s_min_stages",
    "DKDV_MIN_STAGES",
    "DQ_MIN_STAGES",
    "ring_depth",
    "BandedPlan",
    "banded_plan",
]
