"""The route and tiling of the dense decode kernel (``ops/config.py``
``decode_plan``, the mirror of ``csrc/decode.cu`` ``make_plan``) and the TMA
route's split rule (``ops/decode.py`` ``_tma_splits`` and
``decode_split_ranges``, the mirror of ``tma::range_of``).

Every width takes the TMA block: 16 packed rows (a taller packing takes
``cdiv(R, 16)`` row blocks) and a ring of 8 KiB stages. D and Dv up to 512
take one consumer warpgroup in the share of shared memory that leaves two
blocks an SM; wider heads (up to 1024) two warpgroups that split Dv, in one
block an SM. On the CPU the split rule must cover the band [kv_start, kv_end)
exactly once in whole 64-row tiles and near-equal runs, and the splits'
partials, each computed as the kernel computes it (a split that saw only
masked scores normalised by the band's width), merged by LSE as
``split_merge.cuh`` merges them, must equal the plain version over the
whole band (fp32 algebra: 1e-5 on lse, 1e-5 relative to max|o|). On a card
the mirror is held equal to the library's plan, neither instance spills,
and the kernel is held against ``_decode_plain`` per row (bf16
2e-2, fp16 1e-2, ``row_rel_err``), lse at 1e-4 of max|lse|, and its score
residual at 1e-2 on the attended columns.
"""

import math

import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401
    cuda, jax_modules, randn, rel_err, row_rel_err, to_jax, to_torch,
)
from ffpa_attn_tpu_torch.ops import decode as tdec
from ffpa_attn_tpu_torch.ops.config import KV_TILE, SMEM_LIMIT_BYTES, cdiv, decode_plan
from ffpa_attn_tpu_torch.models.serving import shared_row_bias
from ffpa_attn_tpu_torch.ops.reference import DEFAULT_MASK_VALUE

SM_SMEM_BYTES = 233_472  # an H100 SM's shared memory; each block also reserves 1 KiB
NUM_SMS = 132
# Blocks an SM holds (the plan's blocks_per_sm): D, Dv <= 512 and above.
NARROW, WIDE = decode_plan(512, 512, 2).blocks_per_sm, decode_plan(1024, 1024, 2).blocks_per_sm
CARD_TOL = {"bfloat16": 2e-2, "float16": 1e-2}
LSE_TOL = 1e-4
MERGE_TOL = 1e-5
BF16_TOL = 2e-2  # against the JAX package (tests/test_features.py:127)

# (D, Dv, packed rows): the main path's shapes and the edges.
SHAPES = [(512, 512, r) for r in (1, 2, 4, 8, 16, 17, 32, 64)] + [
    (64, 64, 2), (128, 512, 8), (512, 128, 2), (320, 512, 4), (512, 320, 4), (448, 64, 32),
    (640, 640, 2), (512, 640, 8), (640, 512, 16), (1024, 1024, 2), (1024, 1024, 64),
    (576, 576, 33), (768, 1024, 128),
]


@pytest.mark.parametrize("d,dv,rows", SHAPES)
def test_decode_plan_routes_by_shape(d, dv, rows):
    plan = decode_plan(d, dv, rows)
    assert plan.route == "tma"
    assert plan.smem_bytes <= SMEM_LIMIT_BYTES
    assert plan.stages >= 2
    assert plan.rows == 16
    assert cdiv(rows, plan.rows) == -(-rows // 16)  # row blocks of the launch
    assert plan == decode_plan(d, dv, 1)  # the packed rows do not change the tiling
    if max(d, dv) <= 512:
        assert (plan.consumers, plan.blocks_per_sm) == (1, 2)
        assert 2 * (plan.smem_bytes + 1024) <= SM_SMEM_BYTES  # two blocks an SM
    else:
        assert (plan.consumers, plan.blocks_per_sm) == (2, 1)
        assert plan.smem_bytes + 1024 <= SM_SMEM_BYTES  # one block an SM
        assert plan.stages == 12  # the full ring beside Q's boxes at every wide shape


def test_decode_plan_d1024_main_path():
    """The Dh1024 model's decode step (D = Dv = 1024, group 2, Nq 1): two
    consumer warpgroups, 12 stages beside Q's 16 boxes, the two P boxes and
    the two exchanges, one block an SM, as the paged block at D1024."""
    plan = decode_plan(1024, 1024, 2)
    assert (plan.route, plan.rows, plan.stages, plan.smem_bytes, plan.consumers,
            plan.blocks_per_sm) == ("tma", 16, 12, 137_408, 2, 1)
    for nq in range(1, 9):
        for group in (1, 2, 4, 8):
            assert decode_plan(1024, 1024, nq * group) == plan
    with pytest.raises(ValueError):
        decode_plan(1088, 1024, 2)


def test_decode_plan_d512_main_path():
    """The decode step's shape (D = Dv = 512, group 2, Nq 1): 11 stages,
    the same ring as the TMA paged decode block."""
    plan = decode_plan(512, 512, 2)
    assert (plan.route, plan.rows, plan.stages, plan.smem_bytes) == ("tma", 16, 11, 110_256)
    for nq in range(1, 9):
        for group in (1, 2, 4, 8):
            assert decode_plan(512, 512, nq * group) == plan


# ---------------------------------------------------------------------------
# The split rule
# ---------------------------------------------------------------------------


def test_tma_splits_keep_every_block_resident():
    """B1 H8/4 Nkv 4224 (the generate step, 66 tiles) and B4 at max_len
    1152 (the serving step, 18 tiles): 33 and 9 splits of two tiles, one
    block for every SM. B1 Nkv 4096 (64 tiles): 32 splits of two, not 64
    of one. A launch too small to fill the card (one KV head, 136 cache
    rows: 3 tiles) walks one tile a split. Every launch fits two blocks an
    SM, and one split fewer would walk a longer run."""
    assert tdec._tma_splits(4, 66, NUM_SMS, NARROW) == 33
    assert tdec._tma_splits(16, 18, NUM_SMS, NARROW) == 9
    assert tdec._tma_splits(4, 64, NUM_SMS, NARROW) == 32
    assert tdec._tma_splits(1, 3, NUM_SMS, NARROW) == 3
    for bps in (1, 2, 4, 8, 16, 32, 64, 300):
        for tiles in (0, 1, 3, 4, 18, 64, 66, 200):
            s = tdec._tma_splits(bps, tiles, NUM_SMS, NARROW)
            assert s >= 1 and (tiles == 0 or s <= tiles)
            if bps <= NUM_SMS:
                assert s * bps <= 2 * NUM_SMS
            # One block an SM where the band has the tiles; the fewest splits
            # with that longest run.
            cap = max(1, min(tiles, cdiv(NUM_SMS, bps)))
            assert cdiv(max(tiles, 1), s) == cdiv(max(tiles, 1), cap)
            assert s == 1 or cdiv(max(tiles, 1), s - 1) > cdiv(max(tiles, 1), s)


def test_wide_splits_keep_one_block_an_sm():
    """Above D512 the block holds an SM alone, so a launch has at most
    blocks_per_sm x 132 blocks and every block is resident at once. The
    Dh1024 serving step (B4 H8/4, max_len 1152: 18 tiles, 16 blocks a
    split) takes 6 splits of three tiles, 96 blocks (the two-an-SM rule's 9
    splits would make 144, 12 of them a second wave); the Dh1024 generate
    step (B1, 66 tiles, 4 blocks a split) 33 splits, 132 blocks."""
    assert tdec._tma_splits(16, 18, NUM_SMS, WIDE) == 6
    assert tdec._tma_splits(4, 66, NUM_SMS, WIDE) == 33
    for bps in (1, 2, 4, 8, 16, 32, 64, 132):
        for tiles in (0, 1, 3, 4, 18, 64, 66, 200):
            s = tdec._tma_splits(bps, tiles, NUM_SMS, WIDE)
            assert s >= 1 and (tiles == 0 or s <= tiles)
            assert s * bps <= WIDE * NUM_SMS
            cap = max(1, min(tiles, NUM_SMS // bps))
            assert cdiv(max(tiles, 1), s) == cdiv(max(tiles, 1), cap)
            assert s == 1 or cdiv(max(tiles, 1), s - 1) > cdiv(max(tiles, 1), s)


BANDS = {
    # name: (nq, nkv, is_causal, window_left, window_right)
    "nkv200": (1, 200, False, -1, -1),
    "nkv4224": (1, 4224, False, -1, -1),
    "causal_nq4": (4, 4224, True, -1, -1),
    "left_window": (1, 4224, True, 1000, -1),
    "window_nkv200": (4, 200, False, 90, 0),
}


@pytest.mark.parametrize("name", sorted(BANDS))
def test_split_ranges_cover_the_band_once_in_whole_tiles(name):
    nq, nkv, causal, wl, wr = BANDS[name]
    start, end = tdec._kv_band(nq, nkv, causal, wl, wr)
    assert start % KV_TILE == 0
    tiles = cdiv(end - start, KV_TILE)
    for splits in sorted({1, 2, 3, 7, 16, tiles, tdec._tma_splits(4, tiles, NUM_SMS, NARROW),
                          tdec._tma_splits(4, tiles, NUM_SMS, WIDE)}):
        ranges = tdec.decode_split_ranges(start, end, splits)
        assert len(ranges) == splits
        covered = []
        for lo, hi in ranges:
            assert start <= lo <= hi <= end
            if hi > lo:
                assert (lo - start) % KV_TILE == 0
                assert hi == end or (hi - lo) % KV_TILE == 0  # whole tiles, the last cut at end
            covered.extend(range(lo, hi))
        assert covered == list(range(start, end))  # in order, each row once
        runs = [cdiv(hi - lo, KV_TILE) for lo, hi in ranges if hi > lo]
        assert max(runs) - min(runs) <= 1  # near-equal runs


def _split_partial(qp, k, v, bias, lo, hi, width, **kw):
    """One split's partial as the kernel writes it: ``_decode_plain`` with
    the columns outside [lo, hi) at -inf; a row whose max is at or below
    MASK_VALUE (only masked scores) normalised by the band's ``width``."""
    nkv = k.shape[2]
    _, _, s = tdec._decode_plain(qp, k, v, bias, return_scores=True, **kw)
    s = s[..., :nkv].clone()
    s[..., :lo] = float("-inf")
    s[..., hi:] = float("-inf")  # past the split: -inf, not MASK_VALUE
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(m == float("-inf"), 0.0, m))
    l = p.sum(-1, keepdim=True)
    norm = torch.where(m <= DEFAULT_MASK_VALUE, torch.full_like(l, float(width)), l)
    o = torch.einsum("bhrk,bhkd->bhrd", p, v.float()) / torch.where(l == 0, 1.0, norm)
    lse = torch.where(l == 0, float("-inf"), m + torch.log(l))[..., 0]
    return o, lse


def _merge(parts):
    """``split_merge.cuh``: lse = log sum exp(lse_s), o = sum e^(lse_s - lse) o_s."""
    lses = torch.stack([p[1] for p in parts])
    mx = lses.amax(0)
    tot = torch.where(mx == float("-inf"), mx,
                      mx + torch.log(torch.exp(lses - torch.where(
                          mx == float("-inf"), 0.0, mx)).sum(0)))
    w = torch.where(mx == float("-inf"), 0.0, torch.exp(lses - tot))
    return sum(w_[..., None] * p[0] for w_, p in zip(w, parts)), tot


MERGE_CASES = {
    # name: (nq, group, nkv, valid, is_causal, window, splits)
    "valid_nkv200": (1, 2, 200, 150, False, (-1, -1), 3),
    "valid1_nkv4224": (1, 2, 4224, 1, False, (-1, -1), 66),
    "main_path_step": (1, 2, 4224, 4097, False, (-1, -1), 33),
    "causal_nq4": (4, 2, 4224, None, True, (-1, -1), 17),
    "left_window": (1, 2, 4224, None, True, (1000, -1), 9),
    "masked_everywhere": (1, 2, 1000, 0, False, (-1, -1), 5),
}


@pytest.mark.parametrize("name", sorted(MERGE_CASES))
def test_split_partials_merge_to_the_whole(name):
    """The rule's partials (fp32), merged by LSE, equal one pass of the
    plain version; a row masked everywhere gives the mean of V."""
    nq, group, nkv, valid, causal, window, splits = MERGE_CASES[name]
    hkv, d = 2, 64
    rng = np.random.default_rng(7)
    qp = to_torch(randn(rng, (1, hkv, group * nq, d)))
    k, v = to_torch(randn(rng, (1, hkv, nkv, d))), to_torch(randn(rng, (1, hkv, nkv, d)))
    bias = None
    if valid is not None:
        bias = torch.where(torch.arange(nkv) < valid, 0.0, DEFAULT_MASK_VALUE)
    kw = dict(nq=nq, scale=1.0 / math.sqrt(d), is_causal=causal, softcap=0.0,
              window_left=window[0], window_right=window[1])
    start, end = tdec._kv_band(nq, nkv, causal, *window)
    parts = [_split_partial(qp, k, v, bias, lo, hi, end - start, **kw)
             for lo, hi in tdec.decode_split_ranges(start, end, splits)]
    o, lse = _merge(parts)
    want_o, want_lse = tdec._decode_plain(qp, k, v, bias, **kw)
    assert rel_err(lse, want_lse) < MERGE_TOL, name
    assert rel_err(o, want_o.float()) < MERGE_TOL, name
    if valid == 0:
        assert torch.allclose(o, v.float().mean(2, keepdim=True).expand_as(o), atol=1e-5)


@pytest.mark.parametrize("name", ["d512_dv320", "d320_dv512", "rows32"])
def test_plan_edge_shapes_match_jax(name):
    """The port's decode (the plain version on the CPU) against the JAX
    package's (Pallas in interpret mode) at the TMA route's edges: D != Dv
    and 32 packed rows (two row blocks)."""
    (jdec,) = jax_modules("ffpa_attn_tpu.ops.decode")
    d, dv, nq, group = {"d512_dv320": (512, 320, 1, 2), "d320_dv512": (320, 512, 1, 2),
                        "rows32": (128, 128, 8, 4)}[name]
    hkv, nkv = 2, 200
    rng = np.random.default_rng(11)
    q, k = randn(rng, (1, hkv * group, nq, d)), randn(rng, (1, hkv, nkv, d))
    v = randn(rng, (1, hkv, nkv, dv))
    bias = np.where(np.arange(nkv) < 170, 0.0, DEFAULT_MASK_VALUE).astype(np.float32)[
        None, None, None]
    kw = dict(scale=1.0 / math.sqrt(d), is_causal=nq > 1)
    jo, jl = jdec._decode_forward(to_jax(q, "bfloat16"), to_jax(k, "bfloat16"),
                                  to_jax(v, "bfloat16"), to_jax(bias), **kw)
    to, tl = tdec._decode_forward(to_torch(q, "bfloat16"), to_torch(k, "bfloat16"),
                                  to_torch(v, "bfloat16"), to_torch(bias), **kw)
    assert tuple(to.shape) == tuple(jo.shape) == (1, hkv * group, nq, dv)
    assert rel_err(to, jo) < BF16_TOL, name
    assert rel_err(tl, jl) < LSE_TOL, name


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,dv,rows", SHAPES)
def test_decode_plan_matches_library_on_card(cuda, d, dv, rows):  # noqa: F811
    assert tdec.decode_kernel_plan(d, dv, rows) == decode_plan(d, dv, rows)


@pytest.mark.parametrize("consumers", [1, 2])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_tma_decode_kernel_spills_nothing_on_card(cuda, dtype, consumers):  # noqa: F811
    assert tdec.decode_kernel_attrs(consumers, dtype)["local_bytes"] == 0


def _serve_gap_bias(nkv, lens, t):
    """The serving step's shared-row bias [B, 1, 1, Nkv] at step ``t``
    (``models/serving.py`` ``shared_row_bias``, base the longest prompt)."""
    return shared_row_bias(torch.tensor(lens), t, max(lens), nkv).numpy()


CARD_CASES = {
    # The generate step: one valid column (every split but one masked), and
    # the main path's partly masked last splits.
    "valid1_nkv4224": dict(nkv=4224, valid=1),
    "main_path_nkv4224": dict(nkv=4224, valid=4097),
    "serve_b4_gap": dict(b=4, nkv=1152, serve_lens=[589, 698, 763, 886], t=64),
    "rows32": dict(group=4, nq=8, nkv=600, causal=True),
    "d512_dv320": dict(dv=320, nkv=900, valid=800),
    "d320_dv512": dict(d=320, dv=512, nkv=900, valid=800),
    "nkv200": dict(nkv=200, valid=150),
    "softcap": dict(nkv=1000, valid=700, softcap=30.0),
    "window": dict(nkv=4224, causal=True, window=(1000, -1)),
    "window_right_nq4": dict(nq=4, group=4, nkv=700, window=(90, 0)),
    "head_bias_nq2": dict(nq=2, nkv=300, head_bias=True),
    "masked_everywhere": dict(nkv=1000, valid=0),
    "d640_split": dict(d=640, dv=640, nkv=500, valid=400),
    "d640_masked_everywhere": dict(d=640, dv=640, nkv=500, valid=0),
    # Two consumer warpgroups: the Dh1024 steps, D != Dv (the second
    # warpgroup owns 2 of Dv320's 5 boxes, none of Dv64's), 33 packed rows
    # (three row blocks), a split masked throughout, softcap, a window.
    "d1024_main_path": dict(d=1024, dv=1024, nkv=4224, valid=4097),
    "d1024_serve_b4_gap": dict(d=1024, dv=1024, b=4, nkv=1152, serve_lens=[589, 698, 763, 886],
                               t=64),
    "d1024_dv320": dict(d=1024, dv=320, nkv=900, valid=800),
    "d1024_dv64": dict(d=1024, dv=64, nkv=700, valid=650),
    "d320_dv1024": dict(d=320, dv=1024, nkv=700, valid=650),
    "d576_rows33": dict(d=576, dv=576, nq=3, group=11, nkv=600, causal=True),
    "d1024_valid1": dict(d=1024, dv=1024, nkv=1000, valid=1),
    "d1024_softcap_window": dict(d=1024, dv=1024, nkv=1000, causal=True, window=(300, -1),
                                 softcap=30.0),
}


def _card_inputs(case, seed):
    rng = np.random.default_rng(seed)
    b, nq, group = case.get("b", 1), case.get("nq", 1), case.get("group", 2)
    hkv, d = 4, case.get("d", 512)
    dv, nkv = case.get("dv", d), case["nkv"]
    x = dict(q=randn(rng, (b, hkv * group, nq, d)), k=randn(rng, (b, hkv, nkv, d)),
             v=randn(rng, (b, hkv, nkv, dv)), bias=None)
    if "valid" in case:
        x["bias"] = np.where(np.arange(nkv) < case["valid"], 0.0, DEFAULT_MASK_VALUE).astype(
            np.float32)[None, None, None]
    if "serve_lens" in case:
        x["bias"] = _serve_gap_bias(nkv, case["serve_lens"], case["t"])
    if case.get("head_bias"):
        x["bias"] = randn(rng, (b, hkv * group, nq, nkv))
    return x


def _card_kwargs(case, d):
    return dict(scale=1.0 / math.sqrt(d), is_causal=case.get("causal", False),
                softcap=case.get("softcap", 0.0), window=case.get("window", (-1, -1)))


@pytest.mark.parametrize("name", sorted(CARD_CASES))
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_decode_plan_cases_match_plain_on_card(cuda, name, dtype):  # noqa: F811
    case = CARD_CASES[name]
    x = _card_inputs(case, seed=3)
    d, dv = x["q"].shape[-1], x["v"].shape[-1]
    nq, group = case.get("nq", 1), case.get("group", 2)
    assert decode_plan(d, dv, nq * group).consumers == (1 if max(d, dv) <= 512 else 2)
    kw = _card_kwargs(case, d)
    q, k, v = (to_torch(x[n], dtype, cuda) for n in ("q", "k", "v"))
    bias = to_torch(x["bias"], device=cuda)
    before = tdec._decode_forward.launches
    o, lse = tdec._decode_forward(q, k, v, bias, **kw)
    torch.cuda.synchronize()
    assert tdec._decode_forward.launches == before + 1
    po, plse = tdec._decode_forward(q.cpu(), k.cpu(), v.cpu(), to_torch(x["bias"]), **kw)
    assert bool(torch.isfinite(o.float()).all()) and o.shape[-1] == dv
    assert row_rel_err(o.cpu(), po) < CARD_TOL[dtype], name
    assert rel_err(lse.cpu(), plse) < LSE_TOL, name


@pytest.mark.parametrize("name", ["main_path_nkv4224", "serve_b4_gap", "nkv200", "rows32",
                                  "d1024_main_path", "d576_rows33"])
def test_decode_plan_scores_match_plain_on_card(cuda, name):  # noqa: F811
    """``return_scores``: the fp32 residual against the plain one on the
    attended columns (1e-2 relative), MASK_VALUE on the same columns, and
    (o, lse) as without it."""
    case = CARD_CASES[name]
    x = _card_inputs(case, seed=4)
    kw = _card_kwargs(case, x["q"].shape[-1])
    q, k, v = (to_torch(x[n], "bfloat16", cuda) for n in ("q", "k", "v"))
    bias = to_torch(x["bias"], device=cuda)
    o, lse, s = tdec._decode_forward(q, k, v, bias, return_scores=True, **kw)
    o0, lse0 = tdec._decode_forward(q, k, v, bias, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, o0) and torch.equal(lse, lse0)
    _, _, ps = tdec._decode_forward(q.cpu(), k.cpu(), v.cpu(), to_torch(x["bias"]),
                                    return_scores=True, **kw)
    live = ps > DEFAULT_MASK_VALUE / 2
    assert torch.equal(live, s.cpu() > DEFAULT_MASK_VALUE / 2)
    assert row_rel_err(torch.where(live, s.cpu(), 0.0), torch.where(live, ps, 0.0)) < 1e-2
