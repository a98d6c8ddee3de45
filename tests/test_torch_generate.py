"""The port's serving path against the JAX package's, at a tiny size.

Weights come from the JAX package's ``init_params`` and cross over as numpy
through ``params_from_jax``. The prompt is 128 tokens so the prefill takes
the forward-kernel route and each decode step (Nkv = 132, GQA group 2) the
decode-kernel route: JAX runs its Pallas kernels in interpret mode, the port
their plain versions.

Tolerances: logits 2e-2 relative to max|logit| (the bf16 forward tolerance,
tests/test_features.py:127; both models run their matmuls in bf16, rounded
at different points). Greedy tokens must be equal.
"""

import numpy as np
import pytest
import torch

from _torch_parity import jax_modules, rel_err
from ffpa_attn_tpu_torch.models import (
    ModelConfig,
    Transformer,
    decode_step,
    generate,
    init_kv_cache,
    params_from_jax,
    prefill,
    random_params,
    sample_logits,
)
from ffpa_attn_tpu_torch.ops import decode as tdec
from ffpa_attn_tpu_torch.ops import flash_fwd as tfwd

BF16_TOL = 2e-2
SIZE = dict(vocab_size=64, d_model=64, n_layers=1, n_heads=2, n_kv_heads=1,
            head_dim=320, max_seq_len=256)
PROMPT, STEPS = 128, 4


@pytest.fixture(scope="module")
def jm():
    """JAX and the JAX package's models module."""
    return jax_modules("jax", "jax.numpy", "ffpa_attn_tpu.models")


@pytest.fixture(scope="module")
def models(jm):
    jax, _, jmodels = jm
    jcfg, tcfg = jmodels.ModelConfig(**SIZE), ModelConfig(**SIZE)
    params = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
    params_np = jax.tree.map(np.asarray, params)
    model = params_from_jax(params_np, tcfg, device="cpu")
    prompt = np.random.default_rng(1).integers(0, SIZE["vocab_size"], (1, PROMPT))
    return jcfg, params, tcfg, model, prompt


def test_params_from_jax_layout(models):
    _, params, _, model, _ = models
    layer = params["layers"][0]
    # JAX computes x @ wq with wq [in, out]; nn.Linear stores [out, in].
    assert tuple(model.layers[0].wq.weight.shape) == tuple(layer["wq"].shape[::-1])
    np.testing.assert_array_equal(
        model.layers[0].w_down.weight.detach().float().numpy().T,
        np.asarray(layer["w_down"], np.float32),
    )
    np.testing.assert_array_equal(
        model.embed.detach().float().numpy(), np.asarray(params["embed"], np.float32))


def test_prefill_and_decode_logits_match_jax(jm, models):
    _, jnp, jmodels = jm
    jcfg, params, tcfg, model, prompt = models
    max_len = PROMPT + STEPS
    jl, jcache = jmodels.prefill(params, jnp.asarray(prompt, jnp.int32), jcfg,
                                 jmodels.init_kv_cache(jcfg, 1, max_len))
    tcache = init_kv_cache(tcfg, 1, max_len, device="cpu")
    tl, tcache = prefill(model, torch.from_numpy(prompt), tcache)
    assert rel_err(tl, jl) < BF16_TOL, "prefill logits"
    # Teacher-forced decode: both sides get the same token each step.
    tokens = np.random.default_rng(2).integers(0, SIZE["vocab_size"], (3,))
    for i, tok in enumerate(tokens):
        pos = PROMPT + i
        jl, jcache = jmodels.decode_step(params, jcache, jnp.int32(pos),
                                         jnp.asarray([tok], jnp.int32), jcfg)
        tl, tcache = decode_step(model, tcache, pos, torch.tensor([int(tok)]))
        assert rel_err(tl, jl) < BF16_TOL, f"decode step {i}"
    assert rel_err(tcache[0]["k"][:, :, : PROMPT + 3],
                   jcache[0]["k"][:, :, : PROMPT + 3]) < BF16_TOL


def test_greedy_generate_tokens_equal_jax(jm, models):
    _, jnp, jmodels = jm
    jcfg, params, _, model, prompt = models
    want = np.asarray(jmodels.generate(params, jnp.asarray(prompt, jnp.int32), STEPS, jcfg))
    f0, d0 = tfwd.flash_attention_forward.launches, tdec._decode_forward.launches
    got = generate(model, torch.from_numpy(prompt), STEPS)
    assert got.shape == (1, STEPS)
    np.testing.assert_array_equal(got.numpy(), want)
    # CPU tensors take the plain versions: no kernel launch is counted.
    assert (tfwd.flash_attention_forward.launches, tdec._decode_forward.launches) == (f0, d0)


def test_sampling_uses_the_generator():
    """Sampling draws from a torch.Generator (not JAX's draws): the same
    seed repeats, top-k 1 is greedy, filtered tokens never appear."""
    logits = torch.randn(4, 64, generator=torch.Generator().manual_seed(0))
    kw = dict(temperature=0.8, top_k=5, top_p=0.9)
    a = sample_logits(logits, torch.Generator().manual_seed(3), **kw)
    b = sample_logits(logits, torch.Generator().manual_seed(3), **kw)
    assert torch.equal(a, b)
    top5 = logits.topk(5, dim=-1).indices
    assert bool((top5 == a[:, None]).any(dim=-1).all())
    g = sample_logits(logits, torch.Generator().manual_seed(3), temperature=1.0, top_k=1)
    assert torch.equal(g, logits.argmax(-1))


def test_model_entry_points_default_to_cuda():
    cfg = ModelConfig(**SIZE)
    if torch.cuda.is_available():
        assert Transformer(cfg).embed.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Transformer(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax(random_params(cfg, 0), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_kv_cache(cfg, 1, 8)


def test_random_params_match_init_params_layout(jm):
    jax, _, jmodels = jm
    cfg = ModelConfig(**SIZE)
    want = jmodels.init_params(jax.random.PRNGKey(0), jmodels.ModelConfig(**SIZE))
    got = random_params(cfg, 0)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert [x.shape for x in jax.tree.leaves(got)] == [x.shape for x in jax.tree.leaves(want)]


def test_generate_on_card_counts_launches(cuda_model):
    model, prompt = cuda_model
    f0, d0 = tfwd.flash_attention_forward.launches, tdec._decode_forward.launches
    toks = generate(model, prompt, STEPS)
    torch.cuda.synchronize()
    assert toks.shape == (1, STEPS)
    assert tfwd.flash_attention_forward.launches - f0 == SIZE["n_layers"]
    assert tdec._decode_forward.launches - d0 == SIZE["n_layers"] * STEPS


@pytest.fixture
def cuda_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    cfg = ModelConfig(**SIZE)
    model = params_from_jax(random_params(cfg, 0), cfg, device="cuda")
    prompt = np.random.default_rng(1).integers(0, SIZE["vocab_size"], (1, PROMPT))
    return model, torch.from_numpy(prompt).cuda()
