"""Kernel block-shape configuration + Hopper shared-memory / register cost
model.

What limits a launch on an H100 is the shared memory one block asks for (at
most 227 KB, 232,448 bytes) and, for the forward, the registers that hold
its fp32 O tile. ``fwd_smem_bytes`` and ``decode_smem_bytes`` count exactly
what the kernels' launchers ask for (the same formulas as in
``csrc/flash_fwd.cu`` and ``csrc/decode.cu``), so a config picked here is
never refused by the card.

* Forward (``csrc/flash_fwd.cu``): Q stays resident in shared memory, K and V
  stream through a ring of 64 x 64 chunks, and the fp32 O tile lives in
  the registers of the block's 16 warps, 64 per thread: block_q * Dv
  <= 64 * 512. Row tiles 64 (Dv <= 512) and 32 (Dv <= 1024).
* Decode (``csrc/decode.cu``): the fp32 O tile of the PackGQA rows lives in
  shared memory; Q/K and V chunks stream through two slots.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

# Largest dynamic shared memory a block may opt into on an H100.
SMEM_LIMIT_BYTES = 232_448
# The kernels' KV tile and head-dim chunk width (compile-time in the .cu).
KV_TILE = 64
D_CHUNK = 64
# Stream slots of the cp.async rings (flash_fwd.cu NST, decode.cu NSTAGES).
FWD_STREAM_STAGES = 4
DECODE_STREAM_STAGES = 2
# fp32 O-tile elements the forward's 512 threads hold in registers (64 each).
FWD_ACC_ELEMS = 64 * 512
# Row tiles the kernels are instantiated for.
FWD_ROW_TILES = (64, 32)
ROW_TILES = (128, 64, 32, 16)  # decode (wmma fragments are 16 rows)
# Shared-memory row padding, in elements, against bank conflicts.
_PAD_T = 8
_PAD_F = 4


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


@dataclass(frozen=True)
class BlockConfig:
    """Block shapes for the forward and decode kernels.

    A block owns ``block_q`` rows of Q (query positions for the forward,
    packed GQA rows for decode) and streams ``block_kv``-row K/V tiles.
    """

    block_q: int = 64
    block_kv: int = KV_TILE

    def __post_init__(self):
        if self.block_q not in ROW_TILES:
            raise ValueError(
                f"block_q must be one of {ROW_TILES}, got {self.block_q}"
            )
        if self.block_kv != KV_TILE:
            raise ValueError(
                f"block_kv must be {KV_TILE} (the kernels' compiled KV tile), "
                f"got {self.block_kv}"
            )

    def clamp(self, nq: int, nkv: int, tiles=ROW_TILES) -> "BlockConfig":
        """Shrink the row tile to the smallest of ``tiles`` that covers the
        problem's rows (never below the smallest of ``tiles``)."""
        fit = min((t for t in tiles if t >= nq), default=max(tiles))
        return replace(self, block_q=min(self.block_q, max(fit, min(tiles))))


def fwd_smem_bytes(cfg: BlockConfig, d: int, dv: int, itemsize: int = 2) -> int:
    """Shared memory of one forward block: resident Q [bq, D] + the K/V
    chunk ring + fp32 S [bq, bkv] + P [bq, bkv] + per-row m, l, alpha.
    Dv costs registers, not shared memory."""
    del dv
    bq, bkv = cfg.block_q, cfg.block_kv
    q_res = bq * (_round_up(d, D_CHUNK) + _PAD_T) * itemsize
    ring = FWD_STREAM_STAGES * bkv * (D_CHUNK + _PAD_T) * itemsize
    s_tile = bq * (bkv + _PAD_F) * 4
    p_tile = bq * (D_CHUNK + _PAD_T) * itemsize
    return q_res + ring + s_tile + p_tile + 3 * bq * 4


def fwd_fits(cfg: BlockConfig, d: int, dv: int, itemsize: int = 2) -> bool:
    """Whether the forward kernel takes this row tile at (D, Dv)."""
    return (
        cfg.block_q in FWD_ROW_TILES
        and cfg.block_q * _round_up(dv, D_CHUNK) <= FWD_ACC_ELEMS
        and fwd_smem_bytes(cfg, d, dv, itemsize) <= SMEM_LIMIT_BYTES
    )


def decode_smem_bytes(cfg: BlockConfig, dv: int, itemsize: int = 2) -> int:
    """Shared memory of one decode block: fp32 O tile [bq, Dv] + fp32 S
    [bq, bkv] + P [bq, bkv] + DECODE_STREAM_STAGES slots, each a Q chunk and
    a K chunk (or a V chunk) of 64 head-dim columns + per-row m, l, alpha.
    Q and K are chunked over D, so D costs nothing here."""
    bq, bkv = cfg.block_q, cfg.block_kv
    o_tile = bq * (_round_up(dv, D_CHUNK) + _PAD_F) * 4
    s_tile = bq * (bkv + _PAD_F) * 4
    p_tile = bq * (bkv + _PAD_T) * itemsize
    slots = DECODE_STREAM_STAGES * (bq + bkv) * (D_CHUNK + _PAD_T) * itemsize
    return o_tile + s_tile + p_tile + slots + 3 * bq * 4


def default_config(
    d: int,
    dv: int,
    nq: int,
    nkv: int,
    itemsize: int = 2,
) -> BlockConfig:
    """Forward row tile: 64 where its O tile fits the registers (Dv <= 512),
    else 32; shrunk to 32 for short queries. A taller tile divides the K/V
    re-reads (Nq / block_q passes over K/V)."""
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
    "ROW_TILES",
    "cdiv",
    "fwd_smem_bytes",
    "fwd_fits",
    "decode_smem_bytes",
    "default_config",
]
