"""The tiling of the paged decode kernel (``ops/config.py`` ``paged_plan``,
the mirror of ``csrc/paged_decode.cu`` ``make_plan``), the producer's box
walk and the device-side split rule (``ops/paged.py``
``paged_split_ranges``, the mirror of ``tma::range_of``).

Every shape takes the one TMA block: 16 packed rows, boxes of the largest
power of two rows dividing the page and 64 (so a box never crosses a page),
a ring of 8 KiB stages; D, Dv <= 512 one consumer warpgroup in the share of
shared memory that leaves two blocks an SM, wider heads (up to 1024) two
warpgroups splitting Dv in one block an SM. Each block cuts its split of the
live range [first, lens[b]) from the sequence's length: on the CPU the rule
must cover the live range exactly once in whole 64-row tiles, the
producer's boxes must land each live row of a split once at its stage row,
and the splits' partials merged by LSE must equal the unsplit attention and
the JAX package's paged decode. On a card the mirror is held equal to the
library's plan, neither instance spills, and the kernel is held against its
plain version per row (bf16 2e-2, fp16 1e-2) on pages of 8..64 rows and of
odd sizes, head dims up to 1024, 64 packed rows (nq 8, group 8), a window
starting mid-box, lengths on tile edges, and large stale values in the pool
rows past lens[b].
"""

import math

import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401
    cuda, jax_modules, randn, rel_err, row_rel_err, to_jax, to_torch,
)
from ffpa_attn_tpu_torch.ops import paged as tpg
from ffpa_attn_tpu_torch.ops.config import KV_TILE, SMEM_LIMIT_BYTES, cdiv, paged_plan

SM_SMEM_BYTES = 233_472  # an H100 SM's shared memory; each block also reserves 1 KiB
NUM_SMS = 132
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
] + [
    (d, d, 2, page, q8)
    for d in (640, 1024) for page in (8, 17, 20, 24, 100) for q8 in (False, True)
]


@pytest.mark.parametrize("d,dv,rows,page,q8", SHAPES)
def test_paged_plan_routes_by_shape(d, dv, rows, page, q8):
    plan = paged_plan(d, dv, page, q8)
    assert plan.route == "tma" and plan.rows == 16
    assert plan.smem_bytes <= SMEM_LIMIT_BYTES
    assert plan.stages >= 2
    box = plan.box_rows
    assert box & (box - 1) == 0 and box == math.gcd(page, KV_TILE)  # the largest that divides both
    assert page % box == 0 and KV_TILE % box == 0
    wide = max(cdiv(d, 64), cdiv(dv, 64)) * 64 > 512
    assert (plan.consumers, plan.blocks_per_sm) == ((2, 1) if wide else (1, 2))
    assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= SM_SMEM_BYTES
    # A B4 Hkv 4 launch over 18 tiles of capacity keeps every block resident.
    row_blocks = cdiv(rows, plan.rows)
    splits = tpg._tma_splits(16 * row_blocks, 18, NUM_SMS, plan, q8)
    assert 1 <= splits <= 18
    assert splits * 16 * row_blocks <= (plan.blocks_per_sm if q8 else 1) * NUM_SMS


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_serving_path_takes_the_tma_route(dtype):
    """Every shape of the serving paths, D = Dv = 512 and 1024, pages
    24..256, bf16 / f16 queries over their own pools or int8 ones, nq <= 8,
    group <= 8: the TMA block, and a launch (B4, Hkv 4, max_len 1152) whose
    blocks are all resident at once. A 128 B stage slab holds 64 columns of
    the query type."""
    assert 64 * torch.empty((), dtype=dtype).element_size() == 128
    for d in (512, 1024):
        for page in (24, 32, 64, 128, 256):
            for q8 in (False, True):
                plan = paged_plan(d, d, page, q8)
                assert plan.route == "tma" and plan.rows == 16
                for nq in range(1, 9):
                    for group in (1, 2, 4, 8):
                        row_blocks = cdiv(nq * group, plan.rows)
                        tiles = cdiv(cdiv(1152, page) * page, KV_TILE)
                        splits = tpg._tma_splits(16 * row_blocks, tiles, NUM_SMS, plan, q8)
                        assert 1 <= splits <= tiles
                        assert splits * 16 * row_blocks <= plan.blocks_per_sm * NUM_SMS


def test_paged_plan_d512_serving_step():
    bf16, int8 = paged_plan(512, 512, 256, False), paged_plan(512, 512, 256, True)
    assert (bf16.box_rows, bf16.stages, bf16.consumers) == (64, 11, 1)
    assert (int8.box_rows, int8.stages, int8.consumers) == (64, 7, 1)  # two staging buffers


def test_paged_plan_d1024_serving_step():
    """Two consumer warpgroups (each holding 8 of Dv's 16 boxes), one block
    an SM, the ring at its cap; int8's four staging buffers fit beside it."""
    bf16, int8 = paged_plan(1024, 1024, 256, False), paged_plan(1024, 1024, 256, True)
    assert (bf16.box_rows, bf16.stages, bf16.consumers, bf16.blocks_per_sm) == (64, 12, 2, 1)
    assert (int8.box_rows, int8.stages, int8.consumers, int8.blocks_per_sm) == (64, 12, 2, 1)
    assert bf16.smem_bytes == 1024 + 16 * 2048 + 2 * (2048 + 512) + 12 * (8192 + 16)
    assert int8.smem_bytes == bf16.smem_bytes + 2 * 2 * 16384
    assert paged_plan(1024, 1024, 24, False).box_rows == 8
    assert paged_plan(640, 640, 17, True).box_rows == 1


@pytest.mark.parametrize("bad", [dict(d=1088, dv=64, page=64), dict(d=64, dv=1088, page=64),
                                 dict(d=512, dv=512, page=0)])
def test_paged_plan_refuses_what_the_block_does_not_take(bad):
    with pytest.raises(ValueError):
        paged_plan(bad["d"], bad["dv"], bad["page"])


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


# ---------------------------------------------------------------------------
# The producer's box walk
# ---------------------------------------------------------------------------

WALK_CASES = [dict(page=page, window_left=w) for page in (17, 20, 24, 256) for w in (-1, 30)]


@pytest.mark.parametrize("case", WALK_CASES,
                         ids=[f"p{c['page']}_w{c['window_left']}" for c in WALK_CASES])
def test_producer_boxes_load_each_live_row_once(case):
    """``tma::produce`` emulated over ``tma::range_of``'s splits: per tile,
    lanes l and l + 32 of the producer warp issue boxes l and l + 32 (64 /
    box_rows boxes a stage), box i from the page holding cache position kv0
    + i * box_rows (the null page past the table) into stage rows i *
    box_rows... Each box stays inside one page; every stage row the consumer
    keeps (position < the split's end) holds that position's pool row; over
    the splits each live cache row is kept exactly once, in order, and none
    at or past lens."""
    page, wl = case["page"], case["window_left"]
    box_rows = paged_plan(512, 512, page).box_rows
    nb = KV_TILE // box_rows
    max_pages = cdiv(700, page)
    capacity = max_pages * page
    rng = np.random.default_rng(page + wl)
    lens = [0, 1, 63, 64, 65, capacity, capacity - 1] + rng.integers(0, capacity, 5).tolist()
    table = (1 + rng.permutation(len(lens) * max_pages)).reshape(len(lens), max_pages)
    holder = {}  # (pool page, row) -> (sequence, cache position)
    for b in range(len(lens)):
        for pi in range(max_pages):
            for row in range(page):
                holder[(int(table[b, pi]), row)] = (b, pi * page + row)
    for splits in (1, 3, 7):
        ranges = tpg.paged_split_ranges(lens, splits, window_left=wl, capacity=capacity)
        for b, n in enumerate(lens):
            first = _first(n, 1, wl)
            live = cdiv(n - first, KV_TILE) if n > first else 0
            kept = []
            for s in range(splits):
                t0, t1 = s * live // splits, (s + 1) * live // splits
                kv_lo, kv_hi = first + t0 * KV_TILE, min(first + t1 * KV_TILE, n)
                if t1 > t0:
                    assert (kv_lo, kv_hi) == ranges[b][s]
                for t in range(t1 - t0):
                    kv0 = kv_lo + t * KV_TILE
                    issued = sorted(lane + 32 * i for lane in range(32) for i in range(2)
                                    if lane + 32 * i < nb)
                    assert issued == list(range(nb))
                    for bx in issued:
                        pos = kv0 + bx * box_rows
                        pi = pos // page
                        pid = int(table[b, pi]) if pi < max_pages else 0
                        off = pos - pi * page
                        assert 0 <= off and off + box_rows <= page  # never crosses a page
                        for k in range(box_rows):
                            want = kv0 + bx * box_rows + k
                            if want < kv_hi:  # the consumer's mask keeps the row
                                assert holder.get((pid, off + k)) == (b, want)
                                kept.append(want)
            assert kept == list(range(first, n)), (splits, b, n)


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
    assert tpg.paged_kernel_plan(d, dv, page, q8) == paged_plan(d, dv, page, q8)


@pytest.mark.parametrize("consumers", [1, 2])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("q8", [False, True])
def test_tma_paged_kernel_spills_nothing_on_card(cuda, dtype, q8, consumers):  # noqa: F811
    assert tpg.paged_kernel_attrs(dtype, q8, consumers)["local_bytes"] == 0


CARD_CASES = {
    **MERGE_CASES,
    "tile_edges": dict(page=64, nq=1, group=2, lens=[64, 128, 192, 320]),
    "stale_past_lens": dict(page=32, nq=1, group=2, lens=[150, 67, 1, 250], stale=3e4),
    "stale_window_nq4": dict(page=64, nq=4, group=4, lens=[200, 129, 70, 8], window=50,
                             stale=3e4),
    "page24": dict(page=24, nq=2, group=2, lens=[150, 67, 0, 300]),
    "page20_int8": dict(page=20, nq=1, group=2, lens=[150, 67, 0, 300], quantized=True),
    "page17_nq4_window": dict(page=17, nq=4, group=2, lens=[150, 67, 5, 300], window=50),
    "d1024": dict(page=64, nq=1, group=2, lens=[150, 67, 1, 250], d=1024),
    "d1024_int8_page20": dict(page=20, nq=1, group=2, lens=[150, 67, 1, 250], d=1024,
                              quantized=True),
    "d640_int8_page17_group4": dict(page=17, nq=2, group=4, lens=[300, 190, 64, 5], d=640,
                                    quantized=True),
    "d1024_dv320": dict(page=32, nq=1, group=2, lens=[150, 67, 1, 250], d=1024, dv=320),
    "d64_dv1024_int8": dict(page=24, nq=1, group=2, lens=[150, 67, 1, 250], d=64, dv=1024,
                            quantized=True),
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
    plan = paged_plan(d, case.get("dv", d), case["page"], case.get("quantized", False))
    assert plan.route == "tma"
    assert plan.consumers == (2 if max(d, case.get("dv", d)) > 512 else 1)
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
