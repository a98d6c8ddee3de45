"""The route and tiling of the paged decode kernel (``ops/config.py``
``paged_plan``, the mirror of ``csrc/paged_decode.cu`` ``make_plan``) and
the TMA route's device-side split rule (``ops/paged.py``
``paged_split_ranges``, the mirror of ``tma::range_of``).

D and Dv up to 512 with pages of a multiple of 16 rows take the TMA block:
16 packed rows, boxes of 64, 32 or 16 rows that never cross a page, a ring
of 8 KiB stages in the share of shared memory that leaves two blocks an SM.
Other shapes take the cp.async block. Each TMA block cuts its split of the
live range [first, lens[b]) from the sequence's length: on the CPU the rule
must cover the live range exactly once in whole 64-row tiles, and the splits'
partials merged by LSE must equal the unsplit attention and the JAX
package's paged decode. On a card the mirror is held equal to the library's
plan, the TMA kernel spills nothing, and the kernel is held against its plain
version per row (bf16 2e-2, fp16 1e-2) on pages of 32 and 64 rows, 64 packed
rows (nq 8, group 8), a window starting mid-box, lengths on tile edges, and
large stale values in the pool rows past lens[b].
"""

import math

import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401
    cuda, jax_modules, randn, rel_err, row_rel_err, to_jax, to_torch,
)
from ffpa_attn_tpu_torch.ops import paged as tpg
from ffpa_attn_tpu_torch.ops.config import KV_TILE, SMEM_LIMIT_BYTES, paged_plan

SM_SMEM_BYTES = 233_472  # an H100 SM's shared memory; each block also reserves 1 KiB
CARD_TOL = {"bfloat16": 2e-2, "float16": 1e-2}
BF16_TOL = 5e-2  # against the JAX package (tests/test_paged.py:72)

# (D, Dv, packed rows, page, int8): the serving path's shapes and the edges.
SHAPES = [
    (d, d, rows, page, q8)
    for d in (512,) for rows in (1, 2, 8, 16, 32, 64) for page in (32, 64, 128, 256)
    for q8 in (False, True)
] + [
    (64, 64, 2, 16, False), (320, 320, 4, 48, True), (512, 128, 2, 64, False),
    (128, 512, 8, 80, True), (576, 576, 2, 256, False), (1024, 1024, 16, 64, True),
    (512, 512, 2, 24, False), (512, 512, 64, 8, True), (320, 512, 4, 100, False),
]


@pytest.mark.parametrize("d,dv,rows,page,q8", SHAPES)
def test_paged_plan_routes_by_shape(d, dv, rows, page, q8):
    plan = paged_plan(d, dv, rows, page, 2, q8)
    tma = max(d, dv) <= 512 and page % 16 == 0
    assert plan.route == ("tma" if tma else "cp_async")
    assert plan.smem_bytes <= SMEM_LIMIT_BYTES
    assert plan.stages >= 2
    if tma:
        assert plan.rows == 16
        assert page % plan.box_rows == 0 and KV_TILE % plan.box_rows == 0
        assert plan.box_rows >= 16
        assert 2 * (plan.smem_bytes + 1024) <= SM_SMEM_BYTES  # two blocks an SM
    else:
        assert plan.box_rows == 0
        assert plan.rows in (16, 32, 64)
        assert plan.rows >= min(rows, 64) or plan.rows == 16


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_serving_path_takes_the_tma_route(dtype):
    """Every shape of the serving path: D = Dv = 512, pages 32..256, bf16 /
    f16 queries over their own pools or int8 ones, nq <= 8, group <= 8."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    for page in (32, 64, 128, 256):
        for q8 in (False, True):
            for nq in range(1, 9):
                for group in (1, 2, 4, 8):
                    plan = paged_plan(512, 512, nq * group, page, itemsize, q8)
                    assert plan.route == "tma" and plan == paged_plan(512, 512, 2, page, 2, q8)


def test_paged_plan_d512_serving_step():
    bf16, int8 = paged_plan(512, 512, 2, 256, 2, False), paged_plan(512, 512, 2, 256, 2, True)
    assert (bf16.box_rows, bf16.stages) == (64, 11)
    assert (int8.box_rows, int8.stages) == (64, 7)  # two staging buffers of 16 KiB


# ---------------------------------------------------------------------------
# The device-side split rule
# ---------------------------------------------------------------------------


def _first(n, nq, window_left):
    return 0 if window_left < 0 else (max(0, n - nq - window_left) // KV_TILE) * KV_TILE


SPLIT_CASES = [
    dict(page=page, nq=nq, window_left=w)
    for page in (32, 64, 128, 256) for nq in (1, 4, 8) for w in (-1, 40, 100, 300)
]


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=[f"p{c['page']}_nq{c['nq']}_w{c['window_left']}" for c in SPLIT_CASES])
def test_split_ranges_cover_the_live_range_once_in_whole_tiles(case):
    page, nq, wl = case["page"], case["nq"], case["window_left"]
    capacity = 5 * page if page >= 128 else 20 * page
    rng = np.random.default_rng(page * 100 + nq * 10 + wl)
    lens = [0, 1, 63, 64, 65, capacity] + rng.integers(0, capacity + 1, 10).tolist()
    for splits in (1, 3, 10, 17, 40):
        ranges = tpg.paged_split_ranges(lens, splits, nq=nq, window_left=wl, capacity=capacity)
        assert len(ranges) == len(lens)
        for n, row in zip(lens, ranges):
            first = _first(n, nq, wl)
            assert len(row) == splits
            covered = []
            for lo, hi in row:
                assert lo <= hi <= n  # none past lens
                if hi > lo:
                    assert (lo - first) % KV_TILE == 0
                    assert hi == n or (hi - lo) % KV_TILE == 0  # whole tiles, the last cut at n
                covered.extend(range(lo, hi))
            want = list(range(first, n))
            assert covered == want  # in order, each position once
            live = [hi - lo for lo, hi in row if hi > lo]
            if live:
                tiles = [math.ceil(x / KV_TILE) for x in live]
                assert max(tiles) - min(tiles) <= 1  # near-equal runs


def test_window_first_position_is_attended_by_no_earlier_row():
    """The rounded first position never drops a position any row attends:
    row t of nq attends [lens - nq + t - window_left, lens - nq + 1 + t)."""
    for n in range(0, 700, 37):
        for nq in (1, 4, 8):
            for wl in (0, 1, 40, 255):
                first = _first(n, nq, wl)
                earliest = max(0, n - nq - wl)
                assert first <= earliest and earliest - first < KV_TILE


def _split_merged(qp, cache, splits, *, nq, scale, softcap, window_left):
    """The plain version over each split's [lo, hi) alone (other positions
    masked), merged by LSE as the kernel's merge launch does."""
    lens = cache.lens.tolist()
    ranges = tpg.paged_split_ranges(lens, splits, nq=nq, window_left=window_left)
    outs, lses = [], []
    for s in range(splits):
        o, lse = _plain_in_range(qp, cache, [r[s] for r in ranges], nq=nq, scale=scale,
                                 softcap=softcap, window_left=window_left)
        outs.append(o.float())
        lses.append(lse)
    lse = torch.stack(lses)  # [splits, B, Hkv, R]
    tot = torch.logsumexp(lse, dim=0)
    w = torch.where(torch.isinf(tot), 0.0, torch.exp(lse - tot))
    return sum(w_[..., None] * o for w_, o in zip(w, outs))


def _plain_in_range(qp, cache, ranges, *, nq, scale, softcap, window_left):
    """``_paged_decode_plain`` with positions outside [lo, hi) of each
    sequence masked."""
    k = tpg._dense_rows(cache.k_pages, cache.page_table).float()
    v = tpg._dense_rows(cache.v_pages, cache.page_table).float()
    s = torch.einsum("bhrd,bhkd->bhrk", qp.float(), k) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    cols = torch.arange(k.shape[2])
    qpos = torch.arange(qp.shape[2]) % nq
    limit = cache.lens.long()[:, None, None, None] - (nq - 1) + qpos[None, None, :, None]
    lo = torch.tensor([r[0] for r in ranges])[:, None, None, None]
    hi = torch.tensor([r[1] for r in ranges])[:, None, None, None]
    keep = (cols < limit) & (cols >= lo) & (cols < hi)
    if window_left >= 0:
        keep = keep & (cols >= limit - 1 - window_left)
    s = torch.where(keep, s, -1e30)
    m = s.amax(-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhrk,bhkd->bhrd", p, v) / torch.where(l == 0, 1.0, l)
    lse = torch.where(l == 0, float("-inf"), m + torch.log(l.clamp_min(1e-38)))[..., 0]
    return o, lse


MERGE_CASES = {
    "page32_nq1": dict(page=32, nq=1, group=2, lens=[150, 67, 0, 320]),
    "page64_window_mid_box": dict(page=64, nq=1, group=2, lens=[300, 190, 64, 5], window=40),
    "page16_nq8_group8": dict(page=16, nq=8, group=8, lens=[200, 129, 64, 8]),
    "page128_softcap_nq4": dict(page=128, nq=4, group=2, lens=[256, 300, 130, 4], softcap=5.0),
}


def _pools(case, seed, dtype="bfloat16", device="cpu", stale=0.0):
    """A pool (int8 where the case says so) filled from dense K/V over each
    sequence's lens, its table rows shuffled; with ``stale`` every pool row
    past lens[b] in the sequence's pages holds that large value instead."""
    hkv, d = 2, case.get("d", 64)
    dv = case.get("dv", d)
    lens, page = case["lens"], case["page"]
    b, max_len = len(lens), 320
    rng = np.random.default_rng(seed)
    n = max(lens)
    kd, vd = randn(rng, (b, hkv, n, d)), randn(rng, (b, hkv, n, dv))
    if stale:
        for i, m in enumerate(lens):
            kd[i, :, m:], vd[i, :, m:] = stale, -stale
    q = randn(rng, (b, hkv * case["group"], case["nq"], d))
    cache = tpg.PagedKVCache.alloc(b, max_len, hkv, d, page_size=page, device=device,
                                   dtype=getattr(torch, dtype),
                                   quantized=case.get("quantized", False))
    if dv != d:  # the pool API allocates one head dim; V's pool gets its own
        cache.v_pages = torch.zeros((*cache.v_pages.shape[:3], dv), dtype=cache.v_pages.dtype,
                                    device=device)
    mp = cache.page_table.shape[1]
    perm = (1 + np.random.default_rng(seed + 1).permutation(b * mp)).reshape(b, mp)
    for slot in range(b):
        tpg.assign_sequence(cache, slot, perm[slot].tolist())
    k_t, v_t = to_torch(kd, dtype, device), to_torch(vd, dtype, device)
    if dv == d:
        tpg.fill_from_prefill(cache, k_t, v_t, lens)
    else:  # fill_from_prefill pages K and V at one head dim: fill each pool alone
        for pool, scales, x in ((cache.k_pages, cache.k_scales, k_t),
                                (cache.v_pages, cache.v_scales, v_t)):
            one = tpg.PagedKVCache(pool, pool, cache.page_table, cache.lens, scales, scales)
            tpg.fill_from_prefill(one, x, x, lens)
    if stale:
        # The rows past lens[b] up to the end of each sequence's pages.
        for i, m in enumerate(lens):
            pos = torch.arange(m, mp * page)
            ids = cache.page_table[i].long()[pos // page]
            cache.k_pages[ids, :, pos % page] = stale
            cache.v_pages[ids, :, pos % page] = -stale
    return cache, q, kd, vd


@pytest.mark.parametrize("name", sorted(MERGE_CASES))
@pytest.mark.parametrize("splits", [3, 10])
def test_split_partials_merge_to_the_whole(name, splits):
    """The rule's partials, merged by LSE, equal the unsplit plain version
    (fp32 math on both sides)."""
    case = MERGE_CASES[name]
    cache, q, _, _ = _pools(case, seed=3)
    nq, group = case["nq"], case["group"]
    qp = to_torch(q, "bfloat16").reshape(q.shape[0], 2, group * nq, q.shape[-1])
    kw = dict(nq=nq, scale=0.125, softcap=case.get("softcap", 0.0),
              window_left=case.get("window", -1))
    want, _ = tpg._paged_decode_plain(qp.float(), cache, **kw)
    got = _split_merged(qp, cache, splits, **kw)
    assert rel_err(got, want) < 1e-5, name


@pytest.fixture(scope="module")
def jp():
    """jax, jax.numpy and the JAX package's ops.paged."""
    return jax_modules("jax", "jax.numpy", "ffpa_attn_tpu.ops.paged")


@pytest.mark.parametrize("name", sorted(MERGE_CASES))
def test_plan_shapes_match_jax(jp, name):
    """The port's paged decode (the plain version on the CPU) against the
    JAX package's (Pallas in interpret mode) at the new route's edge shapes:
    pages of 16..128 rows, 64 packed rows, a window starting mid-box."""
    _, jnp, jpg = jp
    case = MERGE_CASES[name]
    cache, q, kd, vd = _pools(case, seed=4)
    lens = case["lens"]
    jc = jpg.PagedKVCache.alloc(len(lens), 320, 2, 64, page_size=case["page"])
    for slot in range(len(lens)):
        jc = jpg.assign_sequence(jc, slot, cache.page_table[slot].tolist())
    jc = jpg.fill_from_prefill(jc, to_jax(kd, "bfloat16"), to_jax(vd, "bfloat16"),
                               jnp.asarray(lens, jnp.int32))
    kw = dict(softcap=case.get("softcap", 0.0), window_left=case.get("window", -1))
    want = jpg.paged_decode_attention(to_jax(q, "bfloat16"), jc, **kw)
    got = tpg.paged_decode_attention(to_torch(q, "bfloat16"), cache, **kw)
    assert tuple(got.shape) == tuple(want.shape)
    assert rel_err(got, want) < BF16_TOL, name


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,dv,rows,page,q8", SHAPES)
def test_paged_plan_matches_library_on_card(cuda, d, dv, rows, page, q8):  # noqa: F811
    assert tpg.paged_kernel_plan(d, dv, rows, page, q8) == paged_plan(d, dv, rows, page, 2, q8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("q8", [False, True])
def test_tma_paged_kernel_spills_nothing_on_card(cuda, dtype, q8):  # noqa: F811
    assert tpg.paged_kernel_attrs("tma", dtype, q8)["local_bytes"] == 0


CARD_CASES = {
    **MERGE_CASES,
    "tile_edges": dict(page=64, nq=1, group=2, lens=[64, 128, 192, 320]),
    "stale_past_lens": dict(page=32, nq=1, group=2, lens=[150, 67, 1, 250], stale=3e4),
    "stale_window_nq4": dict(page=64, nq=4, group=4, lens=[200, 129, 70, 8], window=50,
                             stale=3e4),
    "page24_cp_async": dict(page=24, nq=2, group=2, lens=[150, 67, 0, 300]),
    "page32_int8_d320": dict(page=32, nq=1, group=2, lens=[150, 67, 1, 250], d=320,
                             quantized=True),
    "page16_int8_nq8_group8": dict(page=16, nq=8, group=8, lens=[200, 129, 64, 8],
                                   quantized=True),
    "d128_dv512": dict(page=64, nq=1, group=2, lens=[150, 67, 1, 250], d=128, dv=512),
    "d512_dv64_int8_window": dict(page=32, nq=2, group=4, lens=[300, 190, 64, 5], d=512, dv=64,
                                  quantized=True, window=70),
}


@pytest.mark.parametrize("name", sorted(CARD_CASES))
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_paged_plan_cases_match_plain_on_card(cuda, name, dtype):  # noqa: F811
    case = CARD_CASES[name]
    cache, q, _, _ = _pools(case, seed=5, dtype=dtype, device=cuda, stale=case.get("stale", 0.0))
    rows, d = case["nq"] * case["group"], case.get("d", 64)
    route = paged_plan(d, case.get("dv", d), rows, case["page"], 2,
                       case.get("quantized", False)).route
    assert route == ("cp_async" if case["page"] % 16 else "tma")
    kw = dict(softcap=case.get("softcap", 0.0), window_left=case.get("window", -1))
    qt = to_torch(q, dtype, cuda)
    f0 = tpg.paged_decode_attention.launches
    got = tpg.paged_decode_attention(qt, cache, **kw)
    torch.cuda.synchronize()
    assert tpg.paged_decode_attention.launches == f0 + 1
    qp = qt.reshape(qt.shape[0], 2, rows, qt.shape[-1])
    want, _ = tpg._paged_decode_plain(qp, cache, nq=case["nq"], scale=qt.shape[-1] ** -0.5, **kw)
    assert bool(torch.isfinite(got.float()).all())
    assert got.shape[-1] == case.get("dv", d)
    assert row_rel_err(got.cpu(), want.reshape(got.shape).cpu()) < CARD_TOL[dtype], name
