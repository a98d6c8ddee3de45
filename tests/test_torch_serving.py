"""The port's continuous-batching serving path against the JAX package's.

Weights come from the JAX package's ``init_params`` and cross over as numpy
through ``params_from_jax``. Tiny model (vocab 128, dm 64, L2, H2/1, Dh 320)
and prompts of 60, 40 and 25 tokens: the packed prefill runs one varlen call
per layer (the port's plain version; JAX its Pallas kernel in interpret
mode), the decode steps the split-KV decode (dense shared-row cache) or the
paged decode (page pools).

Tolerances: logits 2e-2 relative to max|logit| against the JAX package
(tests/test_features.py:127; both models round their matmuls to bf16 at
different points); paged against dense step logits 5e-2
(tests/test_models.py:262), int8 against bf16 pools 6e-2
(tests/test_paged.py:361). Greedy tokens are compared only where the JAX
suite compares them (the engine's streams, tests/test_models.py:460-540):
token chains across kernels flip on argmax near-ties, so logits are the
check elsewhere.
"""

import numpy as np
import pytest
import torch

from _torch_parity import cuda, jax_modules, rel_err  # noqa: F401
from ffpa_attn_tpu_torch.models import (
    ModelConfig,
    ServingEngine,
    generate,
    init_kv_cache,
    pack_prompts,
    params_from_jax,
    prefill,
    prefill_packed,
    random_params,
    serve_batch,
    serve_batch_paged,
)
from ffpa_attn_tpu_torch.models import serving as tserving
from ffpa_attn_tpu_torch.ops import paged as tpg
from ffpa_attn_tpu_torch.ops import varlen as tvar

BF16_TOL = 2e-2
PAGED_TOL = 5e-2
INT8_TOL = 6e-2
SIZE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=2, n_kv_heads=1, head_dim=320,
            max_seq_len=512)
LENS = (60, 40, 25)
PAD_TO = sum(LENS) + 11  # a padded tail: the varlen pseudo-segment
ENGINE_SIZE = dict(vocab_size=64, d_model=64, n_layers=1, n_heads=2, n_kv_heads=2,
                   head_dim=320, max_seq_len=256)


@pytest.fixture(scope="module")
def jm():
    """jax, jax.numpy, the JAX package's models and its serving module."""
    return jax_modules("jax", "jax.numpy", "ffpa_attn_tpu.models",
                       "ffpa_attn_tpu.models.serving")


@pytest.fixture(scope="module")
def tiny(jm):
    jax, jnp, jmodels, _ = jm
    jcfg, tcfg = jmodels.ModelConfig(**SIZE), ModelConfig(**SIZE)
    params = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, SIZE["vocab_size"], (n,)).astype(np.int32) for n in LENS]
    return jcfg, params, model, prompts


def _packed(jm, prompts, pad_to):
    jnp, jserv = jm[1], jm[3]
    jp, jcu = jserv.pack_prompts([jnp.asarray(p) for p in prompts], pad_to)
    tp, tcu = pack_prompts([torch.from_numpy(p) for p in prompts], pad_to)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tcu.numpy(), np.asarray(jcu))
    assert tp.dtype == torch.int32 and tcu.dtype == torch.int32
    return (jp, jcu), (tp, tcu)


_JAX_PREFILLS = {}


def _prefills(jm, tiny, pad_to=PAD_TO, max_len=128):
    """(JAX logits, JAX cache, port logits, port cache) of the packed
    prefill; the JAX side's (immutable) result is computed once per
    padding, the port's cache anew (the decode steps write it in place)."""
    jcfg, params, model, prompts = tiny
    jmodels, jserv = jm[2], jm[3]
    (jp, jcu), (tp, tcu) = _packed(jm, prompts, pad_to)
    if pad_to not in _JAX_PREFILLS:
        _JAX_PREFILLS[pad_to] = jserv.prefill_packed(
            params, jp, jcu, max(LENS), jcfg, jmodels.init_kv_cache(jcfg, len(LENS), max_len))
    jl, jc = _JAX_PREFILLS[pad_to]
    tc = init_kv_cache(model.cfg, len(LENS), max_len, device="cpu")
    tl, tc = prefill_packed(model, tp, tcu, max(LENS), tc)
    return jl, list(jc), tl, tc


def test_prefill_packed_matches_jax(jm, tiny):
    """Last-token logits of each prompt and the cache rows, with a padded
    tail (the pseudo-segment) that must not reach the cache."""
    f0 = tvar._varlen_forward.launches
    jl, jc, tl, tc = _prefills(jm, tiny)
    assert tvar._varlen_forward.launches == f0  # CPU tensors: the plain version
    assert tuple(tl.shape) == (len(LENS), SIZE["vocab_size"])
    assert rel_err(tl, jl) < BF16_TOL
    for li in range(SIZE["n_layers"]):
        for i, n in enumerate(LENS):
            assert rel_err(tc[li]["k"][i, :, :n], jc[li]["k"][i, :, :n]) < BF16_TOL, (li, i)
            assert float(tc[li]["k"][i, :, n:].abs().max()) == 0.0  # padding rows dropped


def test_prefill_packed_matches_per_prompt_prefill(tiny):
    """The packed prefill's logits equal each prompt's own dense prefill."""
    _, _, model, prompts = tiny
    _, tcu = pack_prompts([torch.from_numpy(p) for p in prompts], sum(LENS))
    tp = torch.cat([torch.from_numpy(p) for p in prompts])
    logits, _ = prefill_packed(model, tp, tcu, max(LENS),
                               init_kv_cache(model.cfg, len(LENS), 64, device="cpu"))
    for i, p in enumerate(prompts):
        want, _ = prefill(model, torch.from_numpy(p)[None].long(),
                          init_kv_cache(model.cfg, 1, 64, device="cpu"))
        assert rel_err(logits[i], want[0]) < BF16_TOL, i


def test_batched_decode_step_matches_jax(jm, tiny):
    """A teacher-forced shared-row decode step: both sides get the same
    token at shared step t = 2 (the rows base and base + 1 before it hold
    zeros on both sides), which writes row base + 2."""
    jnp, jserv = jm[1], jm[3]
    jcfg, params, model, _ = tiny
    _, jc, _, tc = _prefills(jm, tiny)
    lens, t, base = np.asarray(LENS, np.int32), 2, max(LENS)
    tok = np.random.default_rng(2).integers(0, SIZE["vocab_size"], (len(LENS),))
    jl, jc = jserv._batched_decode_step(params, jc, jnp.asarray(lens), jnp.int32(t),
                                        jnp.asarray(tok, jnp.int32), jcfg, base)
    tl, tc = tserving._batched_decode_step(model, tc, torch.from_numpy(lens), t,
                                           torch.from_numpy(tok), base)
    assert rel_err(tl, jl) < BF16_TOL
    assert rel_err(tc[0]["k"][:, :, base + t], jc[0]["k"][:, :, base + t]) < BF16_TOL
    assert float(tc[0]["k"][:, :, base:base + t].abs().max()) == 0.0


def _paged_caches(model, dense, page, quantized=False):
    return [
        tpg.fill_from_prefill(
            tpg.PagedKVCache.alloc(len(LENS), 128, model.cfg.n_kv_heads, model.cfg.head_dim,
                                   page, quantized=quantized, device="cpu"),
            dense[li]["k"][:, :, :max(LENS)], dense[li]["v"][:, :, :max(LENS)], list(LENS))
        for li in range(model.cfg.n_layers)
    ]


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_decode_step_matches_jax_and_dense(jm, tiny, quantized):
    """A teacher-forced paged step against the JAX package's (bf16 pools)
    and against the dense shared-row step (5e-2, tests/test_models.py:262);
    over int8 pools against the bf16 pools' step (6e-2,
    tests/test_paged.py:361; the int8 pools themselves are held bit for bit
    against the JAX package's in test_torch_paged.py)."""
    jnp, jserv = jm[1], jm[3]
    jcfg, params, model, _ = tiny
    from ffpa_attn_tpu.ops.paged import PagedKVCache, fill_from_prefill

    _, jd, _, td = _prefills(jm, tiny)
    page = 32
    tok = np.random.default_rng(3).integers(0, SIZE["vocab_size"], (len(LENS),))
    tcaches = _paged_caches(model, td, page, quantized)
    tl, tcaches = tserving._paged_decode_step(model, tcaches, torch.from_numpy(tok))
    for li in range(SIZE["n_layers"]):  # every layer appended once, at its true position
        assert tcaches[li].lens.tolist() == [n + 1 for n in LENS]
    if quantized:
        bf16, _ = tserving._paged_decode_step(model, _paged_caches(model, td, page),
                                              torch.from_numpy(tok))
        assert rel_err(tl, bf16) < INT8_TOL
        return
    dense, _ = tserving._batched_decode_step(model, td, torch.tensor(LENS), 0,
                                             torch.from_numpy(tok), max(LENS))
    jcaches = [
        fill_from_prefill(
            PagedKVCache.alloc(len(LENS), 128, jcfg.n_kv_heads, jcfg.head_dim, page),
            jd[li]["k"][:, :, :max(LENS)], jd[li]["v"][:, :, :max(LENS)],
            jnp.asarray(LENS, jnp.int32))
        for li in range(jcfg.n_layers)
    ]
    jl, _ = jserv._paged_decode_step(params, jcaches, jnp.asarray(tok, jnp.int32), jcfg)
    assert rel_err(tl, jl) < BF16_TOL
    assert rel_err(tl, dense) < PAGED_TOL


def test_serve_batch_bound_and_paths(tiny):
    """serve_batch runs at the exact shared-row bound max_len = base + steps
    - 1 and asserts below it; serve_batch_paged at its own bound; both give
    in-vocab tokens whose first is the packed prefill's argmax, with no
    kernel launch on the CPU."""
    _, _, model, prompts = tiny
    prompts = [torch.from_numpy(p) for p in prompts]
    steps, base = 4, max(LENS)
    counts = (tvar._varlen_forward.launches, tpg.paged_decode_attention.launches)
    dense = serve_batch(model, prompts, steps, max_len=base + steps - 1)
    with pytest.raises(AssertionError):
        serve_batch(model, prompts, steps, max_len=base + steps - 2)
    paged = serve_batch_paged(model, prompts, steps, max_len=base + steps - 1, page_size=32)
    with pytest.raises(AssertionError):
        serve_batch_paged(model, prompts, steps, max_len=base + steps - 2)
    assert (tvar._varlen_forward.launches, tpg.paged_decode_attention.launches) == counts
    for toks in (dense, paged):
        assert tuple(toks.shape) == (len(LENS), steps)
        assert bool(((toks >= 0) & (toks < SIZE["vocab_size"])).all())
    tp, tcu = pack_prompts(prompts, sum(LENS))
    logits, _ = prefill_packed(model, tp, tcu, base,
                               init_kv_cache(model.cfg, len(LENS), base, device="cpu"))
    assert torch.equal(dense[:, 0], logits.argmax(-1))
    assert torch.equal(paged[:, 0], logits.argmax(-1))


@pytest.fixture(scope="module")
def engine_models(jm):
    jax, _, jmodels, _ = jm
    jcfg, tcfg = jmodels.ModelConfig(**ENGINE_SIZE), ModelConfig(**ENGINE_SIZE)
    params = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return jcfg, params, model


def _drain(eng, limit=50):
    done, steps = {}, 0
    while not eng.done():
        done.update(eng.step())
        steps += 1
        assert steps < limit
    return done


def test_engine_streams_equal_jax(jm, engine_models):
    """3 requests through 2 slots: the third queues, is admitted into a
    freed slot, every request completes, every page comes back, and the
    greedy streams equal the JAX engine's."""
    jnp = jm[1]
    from ffpa_attn_tpu.models.engine import ServingEngine as JaxEngine

    jcfg, params, model = engine_models
    kw = dict(batch_slots=2, max_len=128, page_size=32)
    jeng, teng = JaxEngine(params, jcfg, **kw), ServingEngine(model, **kw)
    rng = np.random.default_rng(0)
    # One prompt length: each new length recompiles the JAX prefill's ops.
    for mx in (5, 4, 3):
        p = rng.integers(0, 64, (24,)).astype(np.int32)
        assert jeng.submit(jnp.asarray(p), max_new_tokens=mx) == teng.submit(
            torch.from_numpy(p), max_new_tokens=mx)
    assert sum(s.active for s in teng.slots) == 2 and len(teng.queue) == 1
    counts = tpg.paged_decode_attention.launches
    want, got = _drain(jeng), _drain(teng)
    assert tpg.paged_decode_attention.launches == counts  # CPU: the plain version
    assert set(got) == {0, 1, 2}
    assert got == want
    assert [len(got[r]) for r in range(3)] == [5, 4, 3]
    assert teng.alloc.free_pages == 2 * (128 // 32)
    assert teng.caches[0].page_table.abs().sum() == 0  # every slot idle on the null page
    assert teng.caches[0].lens.tolist() == [128, 128]


def test_engine_first_token_equals_generate(engine_models):
    """Each request's tokens equal the port's own single-sequence generate."""
    _, _, model = engine_models
    eng = ServingEngine(model, batch_slots=2, max_len=128, page_size=32)
    rng = np.random.default_rng(5)
    prompts = {}
    for ln, mx in ((30, 3), (22, 2)):
        p = torch.from_numpy(rng.integers(0, 64, (ln,)))
        prompts[eng.submit(p, max_new_tokens=mx)] = (p, mx)
    done = _drain(eng)
    for rid, (p, mx) in prompts.items():
        assert done[rid] == generate(model, p[None], mx, max_len=128)[0].tolist(), rid


def test_engine_queues_when_the_pool_is_full(engine_models):
    """A free slot but too few free pages: the request waits in the queue
    while another decodes, and is admitted once pages come back; with an
    idle batch and too few pages the engine raises."""
    _, _, model = engine_models
    eng = ServingEngine(model, batch_slots=2, max_len=128, page_size=32)
    first = eng.submit(torch.arange(10) % 64, max_new_tokens=4)  # one page
    held = eng.alloc.acquire(eng.alloc.free_pages - 1)  # leave one page
    second = eng.submit(torch.arange(40) % 64, max_new_tokens=30)  # needs three
    assert len(eng.queue) == 1 and sum(s.active for s in eng.slots) == 1
    eng.step()
    assert len(eng.queue) == 1
    eng.alloc.release(held)
    done = _drain(eng)
    assert len(done[first]) == 4 and len(done[second]) == 30
    assert eng.alloc.free_pages == 2 * (128 // 32)

    idle = ServingEngine(model, batch_slots=1, max_len=128, page_size=32)
    idle.alloc.acquire(idle.alloc.free_pages - 1)
    with pytest.raises(RuntimeError, match="pool too small"):
        idle.submit(torch.arange(40) % 64, max_new_tokens=30)


def test_engine_edge_budgets(jm, engine_models):
    """max_new_tokens=1 emits exactly one token, finished at admission; EOS
    on the prefill token stops at once; a zero budget or an oversized
    prompt raises (tests/test_models.py:498)."""
    jax, jnp, jmodels, _ = jm
    jcfg, params, model = engine_models
    p = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (24,), 0, 64), np.int32)
    first = int(np.asarray(jmodels.generate(params, jnp.asarray(p)[None], 1, jcfg,
                                            max_len=128))[0, 0])
    eng = ServingEngine(model, batch_slots=1, max_len=128, page_size=32)
    rid = eng.submit(torch.from_numpy(p.copy()), max_new_tokens=1)
    assert _drain(eng, limit=5)[rid] == [first]
    assert eng.alloc.free_pages == 128 // 32

    eng2 = ServingEngine(model, batch_slots=1, max_len=128, page_size=32, eos_id=first)
    rid2 = eng2.submit(torch.from_numpy(p.copy()), max_new_tokens=8)
    assert _drain(eng2, limit=5)[rid2] == [first]
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(torch.from_numpy(p.copy()), max_new_tokens=0)
    with pytest.raises(ValueError, match="cannot fit"):
        eng.submit(torch.zeros(128, dtype=torch.int64), max_new_tokens=4)


def test_engine_sampling_uses_a_seeded_generator(engine_models):
    """Sampled streams repeat for the same seed (the draws are the
    generator's, not the JAX package's)."""
    _, _, model = engine_models
    outs = []
    for _ in range(2):
        eng = ServingEngine(model, batch_slots=1, max_len=128, page_size=32,
                            temperature=1.0, top_k=8, seed=7)
        rid = eng.submit(torch.arange(20) % 64, max_new_tokens=6)
        outs.append(_drain(eng)[rid])
    assert outs[0] == outs[1] and len(outs[0]) == 6


# -- on the card -------------------------------------------------------------


def test_serving_on_card_matches_cpu_and_counts_launches(cuda):
    """The packed prefill's logits on the card against the CPU's (the same
    random weights), one varlen launch per layer, one paged launch per
    layer and decode step."""
    cfg = ModelConfig(**SIZE)
    params = random_params(cfg, seed=0)
    model, model_cpu = params_from_jax(params, cfg), params_from_jax(params, cfg, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [torch.from_numpy(rng.integers(0, SIZE["vocab_size"], (n,))) for n in LENS]
    tp, tcu = pack_prompts(prompts, sum(LENS))
    v0, p0 = tvar._varlen_forward.launches, tpg.paged_decode_attention.launches
    got, _ = prefill_packed(model, tp.to(cuda), tcu.to(cuda), max(LENS),
                            init_kv_cache(cfg, len(LENS), 64))
    torch.cuda.synchronize()
    assert tvar._varlen_forward.launches == v0 + SIZE["n_layers"]
    want, _ = prefill_packed(model_cpu, tp, tcu, max(LENS),
                             init_kv_cache(cfg, len(LENS), 64, device="cpu"))
    assert rel_err(got.cpu(), want) < BF16_TOL
    serve_batch_paged(model, prompts, 3, max_len=64, page_size=32)
    torch.cuda.synchronize()
    assert tpg.paged_decode_attention.launches == p0 + 2 * SIZE["n_layers"]
