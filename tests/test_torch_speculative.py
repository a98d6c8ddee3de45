"""The port's speculative decoding against the JAX package's, at a tiny size.

The model is ``tests/test_torch_generate.py``'s (vocab 64, dm 64, L1, H2/1,
Dh320) with weights from the JAX package's ``init_params``: the target from
``PRNGKey(0)``, an unrelated draft from ``PRNGKey(7)``, crossing over as
numpy through ``params_from_jax``. The prompt is 128 tokens, so the
prefills take the forward-kernel route, each draft step the decode route at
Nq 1 and each verify block the decode route at Nq = k_spec + 1 (GQA group
2): JAX runs its Pallas kernels in interpret mode, the port their plain
versions.

Greedy tokens and the stats must be equal (the stats are the JAX package's:
``emitted`` = count + 1, ``target_calls`` = iterations). Sampled streams
draw from a ``torch.Generator``, so they are held to the target
distribution (``speculative_accept`` within 2 % at 40 000 trials, the JAX
suite's bound, tests/test_models.py:595-623), to determinism per seed and
to the vocabulary's range, not to JAX's draws.
"""

import numpy as np
import pytest
import torch

from _torch_parity import cuda, jax_modules  # noqa: F401
from ffpa_attn_tpu_torch.models import (
    ModelConfig,
    generate,
    params_from_jax,
    speculative_accept,
    speculative_generate,
)
from ffpa_attn_tpu_torch.models.generate import validity_bias
from ffpa_attn_tpu_torch.ops import decode as tdec
from ffpa_attn_tpu_torch.ops import flash_fwd as tfwd
from ffpa_attn_tpu_torch.ops.reference import DEFAULT_MASK_VALUE

SIZE = dict(vocab_size=64, d_model=64, n_layers=1, n_heads=2, n_kv_heads=1,
            head_dim=320, max_seq_len=256)
PROMPT, STEPS, K_SPEC = 128, 8, 3
MAX_LEN = PROMPT + STEPS + K_SPEC + 1


@pytest.fixture(scope="module")
def jm():
    return jax_modules("jax", "jax.numpy", "ffpa_attn_tpu.models")


@pytest.fixture(scope="module")
def setup(jm):
    """JAX params (target PRNGKey(0), draft PRNGKey(7)), the port's models
    on the CPU, the prompt and JAX's greedy runs with their stats."""
    jax, jnp, jmodels = jm
    jcfg, tcfg = jmodels.ModelConfig(**SIZE), ModelConfig(**SIZE)
    pt = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
    pd = jmodels.init_params(jax.random.PRNGKey(7), jcfg)
    target = params_from_jax(jax.tree.map(np.asarray, pt), tcfg, device="cpu")
    draft = params_from_jax(jax.tree.map(np.asarray, pd), tcfg, device="cpu")
    prompt = np.random.default_rng(1).integers(0, SIZE["vocab_size"], (1, PROMPT))
    jprompt = jnp.asarray(prompt, jnp.int32)
    want = {}
    for name, jdraft in (("self", pt), ("random", pd)):
        toks, stats = jmodels.speculative_generate(pt, jdraft, jprompt, STEPS, jcfg, jcfg,
                                                   MAX_LEN, k_spec=K_SPEC, return_stats=True)
        want[name] = (np.asarray(toks), stats)
    models = {"self": target, "random": draft}
    return target, models, torch.from_numpy(prompt), want


@pytest.mark.parametrize("draft", ["self", "random"])
def test_greedy_tokens_and_stats_equal_jax(setup, draft):
    target, models, prompt, want = setup
    f0, d0 = tfwd.flash_attention_forward.launches, tdec._decode_forward.launches
    got, stats = speculative_generate(target, models[draft], prompt, STEPS, MAX_LEN,
                                      k_spec=K_SPEC, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), want[draft][0])
    np.testing.assert_array_equal(got.numpy(), generate(target, prompt, STEPS).numpy())
    assert stats == want[draft][1]
    # CPU tensors take the plain versions: no kernel launch is counted.
    assert (tfwd.flash_attention_forward.launches, tdec._decode_forward.launches) == (f0, d0)


def test_acceptance_follows_the_draft(setup):
    """Self-speculation accepts (nearly) everything, an unrelated draft
    (nearly) nothing: the mechanism, not luck."""
    target, models, prompt, _ = setup
    _, st_self = speculative_generate(target, target, prompt, STEPS, MAX_LEN, k_spec=K_SPEC,
                                      return_stats=True)
    _, st_rand = speculative_generate(target, models["random"], prompt, STEPS, MAX_LEN,
                                      k_spec=K_SPEC, return_stats=True)
    assert st_self["draft_accepted"] >= st_self["proposals"] - 2, st_self
    assert st_rand["draft_accepted"] <= 2, st_rand
    for st in (st_self, st_rand):
        assert st["emitted"] >= STEPS + 1
        assert st["proposals"] == K_SPEC * st["target_calls"]
        assert st["emitted"] == st["target_calls"] + st["draft_accepted"] + 1


def test_accept_reproduces_the_target_distribution():
    """Drafts drawn from p_d, then accepted or resampled: the first emitted
    token is distributed as p_t (within 2 % at 40 000 trials)."""
    vocab, k, trials = 4, 2, 40000
    p_t = torch.tensor([[0.5, 0.2, 0.2, 0.1], [0.25, 0.25, 0.25, 0.25]])
    p_d = torch.tensor([[0.1, 0.4, 0.3, 0.2], [0.7, 0.1, 0.1, 0.1]])
    gen = torch.Generator().manual_seed(0)
    drafts = torch.multinomial(p_d, trials, replacement=True, generator=gen).T  # [trials, k]
    n_acc, nxt = speculative_accept(p_t.expand(trials, k, vocab), p_d.expand(trials, k, vocab),
                                    drafts, gen)
    assert n_acc.shape == nxt.shape == (trials,)
    assert bool(((n_acc >= 0) & (n_acc <= k)).all())
    first = torch.where(n_acc > 0, drafts[:, 0], nxt)
    emp = torch.bincount(first, minlength=vocab).float() / trials
    assert float((emp - p_t[0]).abs().max()) < 0.02, emp


def test_accept_rejects_where_the_target_gives_no_mass():
    """A draft the target gives probability 0 is always rejected, and the
    residual never draws it."""
    p_t = torch.tensor([[0.0, 1.0, 0.0]])
    p_d = torch.tensor([[1.0, 0.0, 0.0]])
    n_acc, nxt = speculative_accept(p_t, p_d, torch.tensor([0]), torch.Generator().manual_seed(1))
    assert int(n_acc) == 0 and int(nxt) == 1


def test_sampled_runs_are_deterministic_per_seed(setup):
    target, _, prompt, _ = setup
    kw = dict(k_spec=K_SPEC, temperature=0.8, top_k=8)
    runs = [speculative_generate(target, target, prompt, 6, MAX_LEN,
                                 generator=torch.Generator().manual_seed(s), **kw)
            for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1])
    for r in runs:
        assert r.shape == (1, 6)
        assert bool(((r >= 0) & (r < SIZE["vocab_size"])).all())


@pytest.mark.parametrize("k_spec,max_len", [(0, MAX_LEN), (8, 200), (K_SPEC, MAX_LEN - 1)])
def test_arguments_are_checked(setup, k_spec, max_len):
    target, _, prompt, _ = setup
    with pytest.raises(ValueError):
        speculative_generate(target, target, prompt, STEPS, max_len, k_spec=k_spec)


def test_windowed_model_stream_equals_generate():
    """A mistral_like model (window 32 < the prompt): the verify block's
    bias applies the window, and the greedy stream is generate's."""
    from ffpa_attn_tpu_torch.models import random_params

    cfg = ModelConfig.mistral_like(sliding_window=32, **SIZE)
    model = params_from_jax(random_params(cfg, 3), cfg, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(4).integers(0, 64, (1, PROMPT)))
    got = speculative_generate(model, model, prompt, STEPS, MAX_LEN, k_spec=K_SPEC)
    assert torch.equal(got, generate(model, prompt, STEPS))


def test_validity_bias_rows():
    """The verify block's bias: row t sees pos + t - W .. pos + t."""
    b = validity_bias(10, 3, 16, sliding_window=4)
    assert b.shape == (1, 1, 3, 16) and b.dtype == torch.float32
    for t in range(3):
        live = (b[0, 0, t] == 0).nonzero()[:, 0].tolist()
        assert live == list(range(10 + t - 4, 10 + t + 1))
        assert bool((b[0, 0, t][b[0, 0, t] != 0] == DEFAULT_MASK_VALUE).all())


def test_speculative_on_card_counts_launches(cuda):
    """On the card: the prefills launch the forward kernel once a layer, each
    draft step and each verify block (Nq = k_spec + 1) the decode kernel
    once a layer, and the greedy stream is generate's."""
    from ffpa_attn_tpu_torch.models import random_params

    cfg = ModelConfig(**SIZE)
    model = params_from_jax(random_params(cfg, 0), cfg, device=cuda)
    prompt = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (1, PROMPT))).to(cuda)
    f0, d0 = tfwd.flash_attention_forward.launches, tdec._decode_forward.launches
    toks, stats = speculative_generate(model, model, prompt, STEPS, MAX_LEN, k_spec=K_SPEC,
                                       return_stats=True)
    torch.cuda.synchronize()
    layers = cfg.n_layers
    assert tfwd.flash_attention_forward.launches - f0 == 2 * layers
    assert tdec._decode_forward.launches - d0 == stats["target_calls"] * (K_SPEC + 2) * layers
    assert toks.shape == (1, STEPS)
