"""Block-config selection: heuristic defaults from the shared-memory cost
model. (There is no tuned-config store in the port yet.)"""

from __future__ import annotations

import torch

from ..env import ENV
from .config import (
    FWD_ROW_TILES,
    BlockConfig,
    default_config,
    from_s_fits,
    varlen_dkdv_plan,
    varlen_fits,
)


def pick_forward_config(
    *,
    d: int,
    dv: int,
    nq: int,
    nkv: int,
    dtype: torch.dtype,
) -> BlockConfig:
    """Heuristic forward config: the taller row tile where it fits."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return default_config(d, dv, nq, nkv, itemsize=itemsize)


def pick_varlen_config(*, d: int, dv: int, tq: int, dtype: torch.dtype) -> BlockConfig:
    """Packed varlen forward row tile: the taller of FWD_ROW_TILES that
    fits (D, Dv) on the route ``varlen_fwd_plan`` picks (``varlen_fits``),
    shrunk to 32 for a packing of at most 32 query rows. Both routes walk
    64-row tiles whatever the row tile says."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    for bq in FWD_ROW_TILES:
        cfg = BlockConfig(block_q=bq).clamp(tq, 0, FWD_ROW_TILES)
        if varlen_fits(cfg, d, dv, itemsize):
            return cfg
    raise ValueError(f"no varlen row tile fits D={d}, Dv={dv}")


def pick_varlen_backward_config(*, d: int, dv: int, dtype: torch.dtype) -> BlockConfig:
    """Packed varlen backward tiles, by head dims alone: the dK/dV column
    passes of the plan ``varlen_dkdv_plan`` picks (at most 256 columns a
    pass of a block's share: all of D and Dv at D, Dv <= 512, a rank's half
    on the cluster above). The dQ launcher picks its own 64-row tile
    (``varlen_dq_plan``), so ``block_q_dq`` keeps its default."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return BlockConfig(dkdv_col_passes=varlen_dkdv_plan(d, dv, itemsize).passes)


# The from-S dK/dV pass keeps dK in the kernel up to this many keys and
# leaves it to banded dK (causal) or one product (otherwise) beyond. Set by
# tools/torch_from_s_probe.py on an H100 80GB HBM3 at 700 W (B1 H8/4 causal
# bf16, device ms): dK out of the kernel (the wgmma route) plus banded dK
# beat dK in the kernel (mma.sync) at every Nkv from 256 to 8192, at D320
# (0.0365 against 0.0581 at N256, 1.7015 against 6.7622 at N8192) and at
# D512 (0.0444 against 0.0797, 2.1640 against 9.6914). So dK stays in the
# kernel only when a config asks for it.
FROM_S_DK_IN_MAX_NKV = 0


# fp8 (e4m3) dS storage is proposed only where the slab stream is large
# enough to matter: Nq * Nkv at least this (the JAX package's rule, shared
# with its autotune's candidates). Below it the slab fits unstriped and
# fp8 buys no bandwidth, only dQ's quantization noise.
FP8_DS_MIN_PAIRS = 4096 * 4096


def pick_backward_config(
    *, d: int, dv: int, nq: int, nkv: int, dtype: torch.dtype, has_bias: bool = False,
    f16: bool = False,
) -> BlockConfig:
    """Heuristic backward config. The dK/dV and recompute dQ launchers pick
    their tiles and column passes themselves (``dkdv_plan``, ``dq_plan``).
    The from-S pass keeps dK in the kernel for key ranges up to
    ``FROM_S_DK_IN_MAX_NKV`` (none since the wgmma route) where one column
    pass holds it. The dS-handoff slab is proposed in e4m3
    (``ds_store_bits = 8``) only when all hold: ``FFPA_TORCH_ALLOW_FP8_DS``
    is set, the inputs are bf16, neither they nor the cotangent are fp16
    (``f16``), there is no bias, and Nq * Nkv >= ``FP8_DS_MIN_PAIRS`` (the
    JAX package's ``propose_fp8``)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    fp8 = (ENV.allow_fp8_ds() and dtype == torch.bfloat16 and not f16 and not has_bias
           and nq * nkv >= FP8_DS_MIN_PAIRS)
    return BlockConfig(dkdv_dk_in_kernel=nkv <= FROM_S_DK_IN_MAX_NKV
                       and from_s_fits(d, dv, True, itemsize),
                       ds_store_bits=8 if fp8 else 16)


__all__ = ["pick_forward_config", "pick_varlen_config",
           "pick_varlen_backward_config", "pick_backward_config",
           "FROM_S_DK_IN_MAX_NKV", "FP8_DS_MIN_PAIRS"]
