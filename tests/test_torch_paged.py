"""The port's paged KV pools and paged decode against the JAX package's.

Pool management (``append_token``, ``fill_from_prefill``, ``fill_slot``,
``assign_sequence``, ``PageAllocator``, ``releasable_lead_pages``) must be
bit-equal to the JAX package's, int8 pools and their scales included (both
round half to even). The JAX functions run op by op, as they are written:
under ``jax.jit`` XLA turns the scale's division into a product with a
reciprocal, which moves a few scales by one ulp and, at exact halves, a
value by one int8 step (2 of 21,760 values of 34 appended
tokens at D320). ``paged_decode_attention``: the same numpy inputs,
rounded to bf16 once, fill both packages' pools; on the CPU the port runs
the kernel's plain version, JAX its Pallas kernel in interpret mode.

Tolerances (tests/test_paged.py:72,361): bf16 5e-2 and int8 6e-2 relative
to max|o| against the JAX package; on the card, kernel vs plain per row
(``row_rel_err``) at bf16 2e-2, fp16 1e-2 and int8 (against the plain
version of the same int8 pool) 2e-2.
"""

import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401
    cuda, jax_modules, randn, rel_err, row_rel_err, to_jax, to_torch,
)
from ffpa_attn_tpu_torch.ops import paged as tpg

BF16_TOL = 5e-2
INT8_TOL = 6e-2
CARD_TOL = {"bfloat16": 2e-2, "float16": 1e-2}


@pytest.fixture(scope="module")
def jp():
    """jax, jax.numpy and the JAX package's ops.paged."""
    return jax_modules("jax", "jax.numpy", "ffpa_attn_tpu.ops.paged")


def _pools_equal(tc, jc):
    """Every field of the two caches bit-equal."""
    for name in ("k_pages", "v_pages", "page_table", "lens", "k_scales", "v_scales"):
        t, j = getattr(tc, name), getattr(jc, name)
        assert (t is None) == (j is None), name
        if t is not None:
            np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32),
                                          err_msg=name)


def _alloc(jp, b, max_len, hkv, d, page, quantized=False, dtype="bfloat16"):
    _, jnp, jpg = jp
    jc = jpg.PagedKVCache.alloc(b, max_len, hkv, d, page_size=page, quantized=quantized,
                                dtype=getattr(jnp, dtype))
    tc = tpg.PagedKVCache.alloc(b, max_len, hkv, d, page_size=page, quantized=quantized,
                                dtype=getattr(torch, dtype), device="cpu")
    return jc, tc


def _appends(jp, jc, tc, tokens):
    """Append tokens [steps, B, Hkv, 1, D] (numpy) one by one to both; the
    JAX side op by op for an int8 pool (see the module docstring), jitted
    for a bf16 one (a copy, the same under jit; each eager call compiles
    its loop anew)."""
    jax, _, jpg = jp
    append = jpg.append_token if jc.quantized else jax.jit(jpg.append_token)
    for x in tokens:
        jc = append(jc, to_jax(x, "bfloat16"), to_jax(x, "bfloat16"))
        tc = tpg.append_token(tc, to_torch(x, "bfloat16"), to_torch(x, "bfloat16"))
    return jc, tc


@pytest.mark.parametrize("quantized", [False, True])
def test_append_crosses_page_boundary(jp, quantized):
    """Tokens land in the right page and row, the first row of a new page
    included; lens advances; the null page stays zero; bit-equal to JAX."""
    b, hkv, d, page = 2, 1, 320, 8  # few appends: each eager JAX append compiles its loop
    jc, tc = _alloc(jp, b, 16, hkv, d, page, quantized)
    toks = randn(np.random.default_rng(1), (page + 2, b, hkv, 1, d))
    jc, tc = _appends(jp, jc, tc, toks)
    assert tc.lens.tolist() == [page + 2] * b
    t0 = tc.page_table.numpy()
    if not quantized:
        want = to_torch(toks[page, 0, 0, 0], "bfloat16")
        assert torch.equal(tc.k_pages[t0[0, 1], 0, 0], want)
    assert set(t0[0]).isdisjoint(set(t0[1]))
    assert float(tc.k_pages[0].float().abs().max()) == 0.0
    _pools_equal(tc, jc)


def test_append_overflow_is_inert(jp):
    """Past capacity the write goes to the null page and lens freezes."""
    b, hkv, d, page = 1, 1, 320, 8
    jc, tc = _alloc(jp, b, page, hkv, d, page)
    toks = randn(np.random.default_rng(2), (page + 3, b, hkv, 1, d))
    jc, tc = _appends(jp, jc, tc, toks)
    assert tc.lens.tolist() == [page]
    t0 = int(tc.page_table[0, 0])
    assert torch.equal(tc.k_pages[t0, 0, 0], to_torch(toks[0, 0, 0, 0], "bfloat16"))
    assert torch.equal(tc.k_pages[t0, 0, page - 1], to_torch(toks[page - 1, 0, 0, 0], "bfloat16"))
    np.testing.assert_array_equal(tc.k_pages[1:].float().numpy(),
                                  np.asarray(jc.k_pages, np.float32)[1:])


@pytest.mark.parametrize("quantized", [False, True])
def test_fill_from_prefill_equals_appends_and_jax(jp, quantized):
    """The bulk load agrees with token-by-token appends on every reachable
    row, and with the JAX package's bulk load bit for bit."""
    _, jnp, jpg = jp
    b, hkv, d, page = 2, 2, 320, 32
    lens = [70, 41]
    rng = np.random.default_rng(3)
    kd, vd = randn(rng, (b, hkv, max(lens), d)), randn(rng, (b, hkv, max(lens), d))
    jc, tc = _alloc(jp, b, 128, hkv, d, page, quantized)
    jc = jpg.fill_from_prefill(jc, to_jax(kd, "bfloat16"), to_jax(vd, "bfloat16"),
                               jnp.asarray(lens, jnp.int32))
    tc = tpg.fill_from_prefill(tc, to_torch(kd, "bfloat16"), to_torch(vd, "bfloat16"), lens)
    _pools_equal(tc, jc)
    _, slow = _alloc(jp, b, 128, hkv, d, page, quantized)
    for t in range(max(lens)):
        tok = to_torch(kd[:, :, t:t + 1], "bfloat16")
        slow = tpg.append_token(slow, tok, to_torch(vd[:, :, t:t + 1], "bfloat16"))
    slow.lens.copy_(torch.tensor(lens, dtype=torch.int32))
    table = tc.page_table.numpy()
    for i, n in enumerate(lens):
        for tok in range(n):
            pg, row = table[i, tok // page], tok % page
            assert torch.equal(tc.k_pages[pg, :, row], slow.k_pages[pg, :, row]), (i, tok)
            assert torch.equal(tc.v_pages[pg, :, row], slow.v_pages[pg, :, row]), (i, tok)


@pytest.mark.parametrize("quantized", [False, True])
def test_allocator_assign_fill_slot_equal_jax(jp, quantized):
    """Admission and eviction on both packages: allocator pages, a shuffled
    (non-contiguous) table row, fill_slot, release and re-acquire; pools,
    tables, lens and scales bit-equal; a double free raises."""
    _, jnp, jpg = jp
    b, hkv, d, page, max_len = 2, 2, 320, 32, 96
    jc, tc = _alloc(jp, b, max_len, hkv, d, page, quantized)
    ja, ta = jpg.PageAllocator(num_pages=1 + 6, reserved=1), tpg.PageAllocator(1 + 6, 1)
    first, second = ta.acquire(3), ta.acquire(2)
    assert (first, second) == (ja.acquire(3), ja.acquire(2))
    assert ta.acquire(2) is None and ja.acquire(2) is None and ta.free_pages == 1
    rng = np.random.default_rng(4)
    for slot, pages, n in ((0, list(reversed(first)), 70), (1, second, 33)):
        kd, vd = randn(rng, (hkv, n, d)), randn(rng, (hkv, n, d))
        jc = jpg.fill_slot(jpg.assign_sequence(jc, slot, pages), slot, to_jax(kd, "bfloat16"),
                           to_jax(vd, "bfloat16"), n)
        tc = tpg.fill_slot(tpg.assign_sequence(tc, slot, pages), slot, to_torch(kd, "bfloat16"),
                           to_torch(vd, "bfloat16"), n)
    _pools_equal(tc, jc)
    assert tc.page_table[0].tolist() == list(reversed(first))
    ta.release(second)
    ja.release(second)
    with pytest.raises(ValueError, match="double free"):
        ta.release(second)
    assert ta.acquire(2) == ja.acquire(2)
    assert ta.free_pages == ja.free_pages
    tc = tpg.assign_sequence(tc, 1, [])
    jc = jpg.assign_sequence(jc, 1, [])
    _pools_equal(tc, jc)


def test_releasable_lead_pages_equal_jax(jp):
    lens = [450, 200, 3, 0]
    for w, page, nq in ((128, 64, 1), (32, 32, 4), (0, 16, 2)):
        got = tpg.releasable_lead_pages(lens, w, page, nq=nq)
        want = jp[2].releasable_lead_pages(lens, w, page, nq=nq)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert got.dtype == np.int32


DECODE_CASES = {
    "g1_nq1": dict(group=1, nq=1),
    "g2_nq1": dict(group=2, nq=1),
    "g2_nq4": dict(group=2, nq=4),
    "g1_nq4": dict(group=1, nq=4),
    "g2_nq1_int8": dict(group=2, nq=1, quantized=True),
    "g2_nq4_int8": dict(group=2, nq=4, quantized=True),
    "window_softcap_sinks": dict(group=2, nq=1, window=40, softcap=5.0, sinks=True, page=32),
    "shuffled_table": dict(group=2, nq=1, shuffle=True),
    "shuffled_table_int8_page32": dict(group=2, nq=4, shuffle=True, quantized=True, page=32),
    "page24": dict(group=2, nq=1, page=24),
    "d1024": dict(group=2, nq=1, d=1024),
}


def _decode_pair(jp, case, seed=0, dtype="bfloat16", device="cpu"):
    """(JAX cache or None, port cache, q, lens) filled from the same dense
    K/V; the port's cache on ``device``."""
    _, jnp, jpg = jp if jp is not None else (None, None, None)
    hkv, d = 2, case.get("d", 320)
    page, quantized = case.get("page", 64), case.get("quantized", False)
    nq, hq = case["nq"], hkv * case["group"]
    lens = case.get("lens", [150, 67 + nq])
    b, max_len = len(lens), case.get("max_len", 192)
    rng = np.random.default_rng(seed)
    kd, vd = randn(rng, (b, hkv, max(lens), d)), randn(rng, (b, hkv, max(lens), d))
    q = randn(rng, (b, hq, nq, d))
    tc = tpg.PagedKVCache.alloc(b, max_len, hkv, d, page_size=page, quantized=quantized,
                                dtype=getattr(torch, dtype), device=device)
    jc = None
    if jp is not None:
        jc = jpg.PagedKVCache.alloc(b, max_len, hkv, d, page_size=page, quantized=quantized)
    if case.get("shuffle"):
        mp = tc.page_table.shape[1]
        perm = (1 + np.random.default_rng(seed + 1).permutation(b * mp)).reshape(b, mp)
        for slot in range(b):
            tc = tpg.assign_sequence(tc, slot, perm[slot].tolist())
            if jc is not None:
                jc = jpg.assign_sequence(jc, slot, perm[slot].tolist())
    tc = tpg.fill_from_prefill(tc, to_torch(kd, dtype, device), to_torch(vd, dtype, device), lens)
    if jc is not None:
        jc = jpg.fill_from_prefill(jc, to_jax(kd, dtype), to_jax(vd, dtype),
                                   jnp.asarray(lens, jnp.int32))
    sinks = randn(rng, (hq,)) * 0.5 if case.get("sinks") else None
    return jc, tc, q, sinks


def _decode_kwargs(case):
    return dict(softcap=case.get("softcap", 0.0), window_left=case.get("window", -1))


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_paged_decode_matches_jax(jp, name):
    case = DECODE_CASES[name]
    jc, tc, q, sinks = _decode_pair(jp, case)
    kw = _decode_kwargs(case)
    want = jp[2].paged_decode_attention(to_jax(q, "bfloat16"), jc, sinks=to_jax(sinks), **kw)
    f0 = tpg.paged_decode_attention.launches
    got = tpg.paged_decode_attention(to_torch(q, "bfloat16"), tc, sinks=to_torch(sinks), **kw)
    assert tpg.paged_decode_attention.launches == f0  # CPU: the plain version
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == tuple(want.shape)
    tol = INT8_TOL if case.get("quantized") else BF16_TOL
    assert rel_err(got, want) < tol, name


def test_paged_decode_matches_dense_oracle():
    """Each sequence's rows against the fp32 oracle over its true rows,
    the speculative tail (nq 4) included: row t attends [0, lens - 3 + t)."""
    from ffpa_attn_tpu_torch.ops.reference import expand_kv_heads, reference_attention

    case = dict(group=2, nq=4, shuffle=True, lens=[150, 71])
    _, tc, q, _ = _decode_pair(None, case, seed=9)
    got = tpg.paged_decode_attention(to_torch(q, "bfloat16"), tc)
    table, page = tc.page_table.long(), tc.page_size
    for i, n in enumerate(case["lens"]):
        pos = torch.arange(n)
        k = tc.k_pages[table[i, pos // page], :, pos % page].transpose(0, 1)[None]
        v = tc.v_pages[table[i, pos // page], :, pos % page].transpose(0, 1)[None]
        want = reference_attention(to_torch(q[i:i + 1], "bfloat16"), expand_kv_heads(k, 4),
                                   expand_kv_heads(v, 4), is_causal=True)
        assert rel_err(got[i:i + 1], want) < BF16_TOL, i


def test_paged_empty_sequence_is_finite():
    """lens = 0 (a fresh slot) gives a finite output, not NaN."""
    cache = tpg.PagedKVCache.alloc(2, 64, 1, 320, page_size=32, device="cpu")
    q = torch.randn(2, 2, 1, 320, generator=torch.Generator().manual_seed(0)).bfloat16()
    assert bool(torch.isfinite(tpg.paged_decode_attention(q, cache).float()).all())


def test_pool_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert tpg.PagedKVCache.alloc(1, 64, 1, 64).k_pages.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpg.PagedKVCache.alloc(1, 64, 1, 64)


# -- on the card: the kernel against its plain version ----------------------

CARD_CASES = {
    **DECODE_CASES,
    "page128": dict(group=2, nq=1, page=128, lens=[600, 129, 0], max_len=768),
    "page256_int8": dict(group=2, nq=1, page=256, quantized=True, lens=[700, 255, 1],
                         max_len=768),
    "group4_nq4_page256": dict(group=4, nq=4, page=256, lens=[500, 260], max_len=768),
    "idle_slot_at_capacity": dict(group=2, nq=1, page=64, lens=[192, 80], max_len=192),
}


@pytest.mark.parametrize("name", sorted(CARD_CASES))
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_paged_kernel_matches_plain_on_card(cuda, name, dtype):
    case = CARD_CASES[name]
    _, tc, q, sinks = _decode_pair(None, case, seed=5, dtype=dtype, device=cuda)
    if name == "idle_slot_at_capacity":
        tc = tpg.assign_sequence(tc, 0, [])
        tc.lens[0] = 192  # an idle engine slot: the null page, lens at capacity
    kw = dict(_decode_kwargs(case), sinks=to_torch(sinks, device=cuda))
    qt = to_torch(q, dtype, cuda)
    f0 = tpg.paged_decode_attention.launches
    got = tpg.paged_decode_attention(qt, tc, **kw)
    torch.cuda.synchronize()
    assert tpg.paged_decode_attention.launches == f0 + 1
    # The plain version on a CPU copy of the same pools.
    want = tpg.paged_decode_attention(qt.cpu(), _to_cpu(tc), **dict(kw, sinks=to_torch(sinks)))
    assert bool(torch.isfinite(got.float()).all())
    assert row_rel_err(got.cpu(), want) < CARD_TOL[dtype], name


def _to_cpu(cache):
    return tpg.PagedKVCache(*(None if t is None else t.cpu() for t in (
        cache.k_pages, cache.v_pages, cache.page_table, cache.lens, cache.k_scales,
        cache.v_scales)))
