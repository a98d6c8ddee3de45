"""The tiling plan of the banded dQ / dK kernels (``ops/config.py``
``banded_plan``, the mirror of ``csrc/flash_bwd.cu`` ``band::make_plan``):
for every head dim the port takes, the column blocks tile the padded D
exactly within wgmma's widths, and a block fits the card's shared memory.
On a card the mirror is held equal to the plan the library launches with."""

from __future__ import annotations

import pytest

from _torch_parity import cuda  # noqa: F401  (fixture)
from ffpa_attn_tpu_torch.ops.config import (
    D_CHUNK,
    SMEM_LIMIT_BYTES,
    banded_plan,
    cdiv,
)

# D 320..1024 in 64-column chunks, and a D that the wrappers pad (400 -> 448).
HEAD_DIMS = list(range(320, 1025, 64)) + [400]
WGMMA_MAX_N = 256  # the widest wgmma.m64nNk16


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_banded_plan_tiles_head_dim(d):
    plan = banded_plan(d)
    d_pad = cdiv(d, D_CHUNK) * D_CHUNK
    start = 0
    for c0, width in plan.col_blocks:
        assert c0 == start
        assert width % 8 == 0 and 0 < width <= WGMMA_MAX_N
        start += width
    assert start == d_pad
    assert len(plan.col_blocks) == cdiv(d_pad, WGMMA_MAX_N)
    widths = [w for _, w in plan.col_blocks]
    assert max(widths) - min(widths) <= D_CHUNK  # as even as 64-column chunks allow
    assert plan.rows % 64 == 0 and plan.k_tile % 16 == 0
    assert plan.smem_bytes <= SMEM_LIMIT_BYTES
    assert banded_plan(d_pad) == plan


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_banded_plan_matches_library_on_card(cuda, d):  # noqa: F811
    from ffpa_attn_tpu_torch.ops.flash_bwd import banded_kernel_plan

    assert banded_kernel_plan(d) == banded_plan(d)
