"""Block-config selection: heuristic defaults from the shared-memory cost
model, and the tuned-config store's entry (``autotune/store.py``) where a
Hopper kernel has a run-time knob to set.

The counterpart of the JAX package's ``ops/dispatch.py`` and of its varlen
lookup (``_varlen_tuned_blocks``). The lookup sits at every site whose
kernels take a knob, with the JAX package's queries:

* ``pick_forward_config`` (direction 'fwd'): the forward's ring cap,
  ``BlockConfig.fwd_ring_cap``;
* ``pick_backward_config`` ('bwd'): the backward rings' cap,
  ``bwd_ring_cap``, and the dS storage width, ``ds_store_bits``;
* ``pick_varlen_config`` and ``pick_varlen_backward_config`` ('varlen',
  keyed by the packed totals): one entry's ``fwd_ring_cap`` for the
  packed forward and ``bwd_ring_cap`` for the packed backward pair;
* ``pick_decode_config`` ('decode'): the decode launch's split count,
  ``decode_splits``, memoised per query for the decode step
  (``stored_decode_splits``).

A pick takes an entry only at its own head dims: a ring cap or a split
count belongs to one plan. With no store file every pick returns the
default below, field for field.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import functools

import torch

from ..autotune.store import lookup_generation, lookup_tuned_config
from ..env import ENV
from .config import (
    FWD_ROW_TILES,
    BlockConfig,
    default_config,
    from_s_fits,
    varlen_dkdv_plan,
    varlen_fits,
)


def dtype_key(dtype: torch.dtype) -> str:
    """The store's name of a dtype ("bfloat16", "float16")."""
    return str(dtype).rpartition(".")[2]


def head_layout(hq: int, hkv: int) -> dict:
    """The store's head-layout fields of a call: gqa, and the group Hq // Hkv
    (0 for MHA)."""
    return dict(gqa=hq != hkv, group=hq // hkv if hq != hkv else 0)


def pick_forward_config(
    *,
    d: int,
    dv: int,
    nq: int,
    nkv: int,
    dtype: torch.dtype,
    causal: bool = False,
    has_bias: bool = False,
    dropout: bool = False,
    gqa: bool = False,
    group: int = 0,
    f16: bool = False,
) -> BlockConfig:
    """Forward config: the taller row tile where it fits, and a tuned
    entry's ring cap (direction 'fwd', queried float16 under ``f16`` or
    fp16 inputs, with the call's flags and head layout, as the JAX
    package's ``pick_forward_config``) at these head dims. The entry sets
    only ``fwd_ring_cap``: the row tile, which pads the S residual's rows,
    stays the default's."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    cfg = default_config(d, dv, nq, nkv, itemsize=itemsize)
    tuned = lookup_tuned_config(direction="fwd", d=d, dv=dv, nq=nq, nkv=nkv,
                                dtype="float16" if f16 else dtype_key(dtype), causal=causal,
                                has_bias=has_bias, dropout=dropout, gqa=gqa, group=group,
                                same_head_dims=True)
    return cfg if tuned is None else replace(cfg, fwd_ring_cap=tuned.fwd_ring_cap)


def _varlen_tuned(d: int, dv: int, tq: int, tk: int, dtype: torch.dtype) -> Optional[BlockConfig]:
    """The tuned entry of a packed call (direction 'varlen', keyed by the
    packed totals as the JAX package's ``_varlen_tuned_blocks``) at these
    head dims, or None."""
    return lookup_tuned_config(direction="varlen", d=d, dv=dv, nq=tq, nkv=tk,
                               dtype=dtype_key(dtype), causal=False, has_bias=False,
                               dropout=False, gqa=False, same_head_dims=True)


def pick_varlen_config(*, d: int, dv: int, tq: int, dtype: torch.dtype,
                       tk: Optional[int] = None) -> BlockConfig:
    """Packed varlen forward row tile: the taller of FWD_ROW_TILES that
    fits (D, Dv) on the route ``varlen_fwd_plan`` picks (``varlen_fits``),
    shrunk to 32 for a packing of at most 32 query rows. Both routes walk
    64-row tiles whatever the row tile says. Given the packed key total
    ``tk``, the entry ``pick_varlen_backward_config`` reads sets the
    forward's ring cap."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    for bq in FWD_ROW_TILES:
        cfg = BlockConfig(block_q=bq).clamp(tq, 0, FWD_ROW_TILES)
        if varlen_fits(cfg, d, dv, itemsize):
            tuned = None if tk is None else _varlen_tuned(d, dv, tq, tk, dtype)
            return cfg if tuned is None else replace(cfg, fwd_ring_cap=tuned.fwd_ring_cap)
    raise ValueError(f"no varlen row tile fits D={d}, Dv={dv}")


def pick_varlen_backward_config(*, d: int, dv: int, dtype: torch.dtype,
                                tq: Optional[int] = None,
                                tk: Optional[int] = None) -> BlockConfig:
    """Packed varlen backward tiles, by head dims alone: the dK/dV column
    passes of the plan ``varlen_dkdv_plan`` picks (at most 256 columns a
    pass of a block's share: all of D and Dv at D, Dv <= 512, a rank's half
    on the cluster above). The dQ launcher picks its own 64-row tile
    (``varlen_dq_plan``), so ``block_q_dq`` keeps its default. Given the
    packed totals ``tq`` / ``tk``, a tuned entry at these head dims
    (direction 'varlen', keyed by the totals as the JAX package's
    ``_varlen_tuned_blocks``) sets the pair's ring cap."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    cfg = BlockConfig(dkdv_col_passes=varlen_dkdv_plan(d, dv, itemsize).passes)
    if tq is None or tk is None:
        return cfg
    tuned = _varlen_tuned(d, dv, tq, tk, dtype)
    return cfg if tuned is None else replace(cfg, bwd_ring_cap=tuned.bwd_ring_cap)


def pick_decode_config(*, d: int, dv: int, nkv: int, dtype: torch.dtype, gqa: bool = False,
                       group: int = 0) -> Optional[BlockConfig]:
    """The decode kernel's tuned entry (direction 'decode', the JAX
    package's ``pick_decode_config`` query: one query row, no flags) at
    these head dims, or None where there is none (the launch then takes
    ``decode._tma_splits``'s rule). Its knob is ``decode_splits``."""
    return lookup_tuned_config(direction="decode", d=d, dv=dv, nq=1, nkv=nkv,
                               dtype=dtype_key(dtype), causal=False, has_bias=False,
                               dropout=False, gqa=gqa, group=group, same_head_dims=True)


@functools.lru_cache(maxsize=1024)
def _stored_decode_splits(d: int, dv: int, nkv: int, dtype: torch.dtype, group: int,
                          generation: int) -> int:
    del generation  # part of the memo's key only
    cfg = pick_decode_config(d=d, dv=dv, nkv=nkv, dtype=dtype, gqa=group > 1,
                             group=group if group > 1 else 0)
    return 0 if cfg is None else cfg.decode_splits


def stored_decode_splits(*, d: int, dv: int, nkv: int, dtype: torch.dtype, group: int) -> int:
    """``pick_decode_config``'s ``decode_splits`` (0: none stored, the
    rule's count), read once per query until the store's caches are cleared
    (``store.clear_lookup_cache``, which every write calls). A decode step
    reads it at every launch, so a hit reads no environment variable (each
    read costs the host about a microsecond): the kill-switch
    ``FFPA_TORCH_SKIP_TUNED_CONFIG`` and ``FFPA_TORCH_TUNED_CONFIG_DIR`` reach
    the decode launch at the next clear (``chip_smoke.py``
    ``phase_autotune`` times a hit against a lookup)."""
    return _stored_decode_splits(d, dv, nkv, dtype, group, lookup_generation())


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


def fp8_ds_allowed(*, nq: int, nkv: int, dtype: torch.dtype, has_bias: bool,
                   f16: bool) -> bool:
    """The JAX package's ``propose_fp8`` rule: ``FFPA_TORCH_ALLOW_FP8_DS``
    set, bf16 inputs, neither they nor the cotangent fp16 (``f16``), no
    bias, and Nq * Nkv >= ``FP8_DS_MIN_PAIRS``."""
    return (ENV.allow_fp8_ds() and dtype == torch.bfloat16 and not f16 and not has_bias
            and nq * nkv >= FP8_DS_MIN_PAIRS)


def pick_backward_config(
    *, d: int, dv: int, nq: int, nkv: int, dtype: torch.dtype, has_bias: bool = False,
    f16: bool = False, causal: bool = False, dropout: bool = False, gqa: bool = False,
    group: int = 0,
) -> BlockConfig:
    """Backward config. The dK/dV and recompute dQ launchers pick their
    tiles and column passes themselves (``dkdv_plan``, ``dq_plan``). The
    from-S pass keeps dK in the kernel for key ranges up to
    ``FROM_S_DK_IN_MAX_NKV`` (none since the wgmma route) where one column
    pass holds it. A tuned entry at these head dims (direction 'bwd',
    queried float16 under ``f16``) sets the rings' cap and the dS storage
    width, the knobs the search tunes. Then, as the JAX package's ``propose_fp8`` does to a
    tuned entry and to the default alike, a 16-bit slab becomes e4m3
    (``ds_store_bits = 8``) where ``fp8_ds_allowed``."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    f16 = f16 or dtype == torch.float16
    cfg = BlockConfig(dkdv_dk_in_kernel=nkv <= FROM_S_DK_IN_MAX_NKV
                      and from_s_fits(d, dv, True, itemsize))
    tuned = lookup_tuned_config(direction="bwd", d=d, dv=dv, nq=nq, nkv=nkv,
                                dtype="float16" if f16 else dtype_key(dtype), causal=causal,
                                has_bias=has_bias, dropout=dropout, gqa=gqa, group=group,
                                same_head_dims=True)
    if tuned is not None:
        cfg = replace(cfg, bwd_ring_cap=tuned.bwd_ring_cap, ds_store_bits=tuned.ds_store_bits)
    if cfg.ds_store_bits == 16 and fp8_ds_allowed(nq=nq, nkv=nkv, dtype=dtype,
                                                  has_bias=has_bias, f16=f16):
        cfg = replace(cfg, ds_store_bits=8)
    return cfg


__all__ = ["pick_forward_config", "pick_varlen_config",
           "pick_varlen_backward_config", "pick_backward_config", "pick_decode_config",
           "stored_decode_splits", "fp8_ds_allowed",
           "dtype_key", "head_layout", "FROM_S_DK_IN_MAX_NKV", "FP8_DS_MIN_PAIRS"]
