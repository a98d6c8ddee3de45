"""The port's end-to-end legs (``ffpa_attn_tpu_torch/cli/_e2e.py``) against
the JAX package's ``cli/_e2e.py``, on the CPU.

The ``smoke`` leg runs through the real subprocess path (``python -m
ffpa_attn_tpu_torch.bench --e2e --device cpu``); every other leg runs in
process at a tiny size (vocab 128, dm 64, H2/1, Dh320) and reports the JAX
leg's metric; each leg's keyword defaults are the JAX leg's. The windowed
paged leg's model (sliding window) serves the same logits over paged pools
as over the dense shared-row cache, step by step, teacher-forced. Importing
the CLI leaves JAX out of ``sys.modules``.
"""

import functools
import inspect
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import cuda, jax_modules, rel_err  # noqa: F401
from ffpa_attn_tpu_torch.cli import _e2e

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(d_model=64, n_layers=1, n_heads=2, n_kv_heads=1, head_dim=320, vocab=128)
LEGS = {
    "train": (dict(n=256, steps=1), "train_tokens_per_s"),
    "decode": (dict(prompt_len=128, gen_len=4), "decode_tokens_per_s"),
    "serve": (dict(batch=2, prompt_len=200, gen_len=4), "serve_tokens_per_s"),
    "serve_paged": (dict(batch=2, prompt_len=200, gen_len=4, page_size=16),
                    "serve_paged_tokens_per_s"),
    "serve_paged_int8": (dict(batch=2, prompt_len=200, gen_len=4, page_size=16),
                         "serve_paged_int8_tokens_per_s"),
    "serve_paged_window": (dict(batch=2, prompt_len=200, gen_len=4, window=32, page_size=16),
                           "serve_paged_window_tokens_per_s"),
    "speculative": (dict(prompt_len=128, gen_len=6), "speculative_tokens_per_s"),
    "speculative_draft": (dict(prompt_len=128, gen_len=6, n_layers=2),
                          "speculative_draft_tokens_per_s"),
}


@pytest.fixture(scope="module")
def je2e():
    return jax_modules("ffpa_attn_tpu.cli._e2e")[0]


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT), **kw)
    env.pop("FFPA_TORCH_E2E_INPROC", None)
    return env


def test_smoke_leg_through_the_subprocess_path():
    res = subprocess.run(
        [sys.executable, "-m", "ffpa_attn_tpu_torch.bench", "--e2e", "--device", "cpu"],
        capture_output=True, text=True, cwd=str(ROOT), timeout=300,
        env=_env(FFPA_TORCH_E2E_ONLY="smoke"),
    )
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(ln) for ln in res.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, res.stdout
    assert lines[0]["metric"] == "decode_tokens_per_s" and lines[0]["value"] > 0
    assert lines[0]["config"] == "L1 dm64 H2/1 Dh64 prompt64 gen8 B1"


def test_unknown_leg_raises():
    with pytest.raises(SystemExit, match="unknown e2e bench"):
        _e2e.main(only="nope", device="cpu")
    with pytest.raises(SystemExit, match="unknown e2e bench"):
        _e2e.main(only=["smoke", "scaling"], device="cpu")


def test_inproc_runs_in_this_process(monkeypatch, capsys):
    monkeypatch.setenv("FFPA_TORCH_E2E_INPROC", "1")
    assert _e2e.main(only="smoke", device="cpu") == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["metric"] for ln in lines] == ["decode_tokens_per_s"]


def test_a_failing_leg_reports_its_error(monkeypatch, capsys):
    monkeypatch.setenv("FFPA_TORCH_E2E_INPROC", "1")
    monkeypatch.setitem(_e2e.E2E_BENCHES, "smoke", lambda device=None: 1 / 0)
    assert _e2e.main(only="smoke", device="cpu") == 1
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(out) == {"metric": "bench_smoke", "error": "division by zero"}


def _defaults(fn):
    if isinstance(fn, functools.partial):
        return dict(_defaults(fn.func), **fn.keywords)
    return {n: p.default for n, p in inspect.signature(fn).parameters.items()
            if p.kind is not inspect.Parameter.VAR_KEYWORD}


@pytest.mark.parametrize("name", list(_e2e.E2E_BENCHES))
def test_leg_defaults_match_jax(je2e, name):
    """Each leg's keyword defaults are the JAX leg's; the port's adds only
    ``device`` (a leg taking ``**kw`` passes it on). The two packages have
    the same legs, ``scaling_projection`` included."""
    got, want = _defaults(_e2e.E2E_BENCHES[name]), _defaults(je2e.E2E_BENCHES[name])
    assert got.pop("device", None) is None
    assert got == want
    assert set(je2e.E2E_BENCHES) == set(_e2e.E2E_BENCHES)


@pytest.mark.parametrize("name", list(LEGS))
def test_leg_runs_on_cpu(name):
    kw, metric = LEGS[name]
    out = _e2e.E2E_BENCHES[name](device="cpu", **dict(TINY, **kw))
    assert out["metric"] == metric and out["value"] > 0 and out["unit"] == "tokens/s"
    assert out["launches"] == {}  # the plain versions count no launch
    if name.startswith("speculative"):
        assert 0.0 <= out["accept_rate"] <= 1.0
    if name == "speculative":
        assert out["accept_rate"] == 1.0  # self-spec accepts every proposal


def test_serve_prompts_are_the_jax_workload():
    """At the serving legs' defaults the prompt lengths are those the JAX
    package's ``_bench_serve_impl`` draws (numpy seed 0)."""
    prompts = _e2e.serve_prompts(4, 1024, 32000, "cpu")
    assert [int(p.shape[0]) for p in prompts] == [589, 698, 763, 886]
    rng = np.random.default_rng(0)
    [rng.integers(0, 512) for _ in range(4)]
    assert torch.equal(prompts[0], torch.from_numpy(rng.integers(0, 32000, (589,))))


def test_speculative_workload():
    from ffpa_attn_tpu_torch.models import ModelConfig, params_from_jax, random_params

    cfg = ModelConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=2, n_kv_heads=1,
                      head_dim=320, max_seq_len=256)
    model = params_from_jax(random_params(cfg, 0), cfg, device="cpu")
    prompt, draft, max_len, label = _e2e.speculative_workload(model, prompt_len=64, gen_len=8,
                                                              k_spec=3, draft_layers=1)
    assert prompt.shape == (1, 64) and max_len == 64 + 8 + 3 + 2
    assert label == "shallow-draft L1/2" and draft.cfg.n_layers == 1
    assert draft.layers[0] is model.layers[0] and draft.embed is model.embed
    assert torch.equal(prompt[0], torch.from_numpy(
        np.random.default_rng(0).integers(0, 128, (1, 64)))[0])
    assert _e2e.speculative_workload(model, prompt_len=64)[1] is model
    r = _e2e.run_speculative(model, draft, prompt, 8, max_len, 3)
    assert r["toks"].shape == (1, 8) and r["stats"]["emitted"] >= 8 and r["seconds"] > 0


@torch.inference_mode()
def test_windowed_paged_steps_match_dense():
    """The windowed leg's model (sliding window 32, page 16): every decode
    step's logits over paged pools, teacher-forced on serve_batch_paged's
    stream, against the dense shared-row step's, within the paged-vs-dense
    tolerance (5e-2 of max|logit|); the paged steps replay the stream."""
    from ffpa_attn_tpu_torch.models import (
        ModelConfig, init_kv_cache, pack_prompts, params_from_jax, prefill_packed,
        random_params, serve_batch_paged,
    )
    from ffpa_attn_tpu_torch.models.serving import _batched_decode_step, _paged_decode_step
    from ffpa_attn_tpu_torch.ops.paged import PagedKVCache, fill_from_prefill

    cfg = ModelConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=2, n_kv_heads=1,
                      head_dim=320, max_seq_len=256, sliding_window=32)
    model = params_from_jax(random_params(cfg, 0), cfg, device="cpu")
    prompts = _e2e.serve_prompts(3, 160, 128, "cpu")
    gen, max_len, page = 12, 172, 16
    toks = serve_batch_paged(model, prompts, gen, max_len, page_size=page)
    lens = [int(p.shape[0]) for p in prompts]
    base = max(lens)
    packed, cu = pack_prompts(prompts, sum(lens))
    cache = init_kv_cache(cfg, 3, max_len, device="cpu")
    _, cache = prefill_packed(model, packed, cu, base, cache)
    pools = [fill_from_prefill(PagedKVCache.alloc(3, max_len, 1, 320, page, dtype=torch.bfloat16,
                                                  device="cpu"),
                               c["k"][:, :, :base], c["v"][:, :, :base], lens) for c in cache]
    lens_t = torch.tensor(lens, dtype=torch.int32)
    for t in range(gen - 1):
        lp, pools = _paged_decode_step(model, pools, toks[:, t])
        ld, cache = _batched_decode_step(model, cache, lens_t, t, toks[:, t], base)
        assert rel_err(lp, ld) < 5e-2, t
        assert torch.equal(lp.argmax(-1), toks[:, t + 1]), t


def test_cli_never_imports_jax():
    code = (
        "import sys, ffpa_attn_tpu_torch.cli._bench, ffpa_attn_tpu_torch.cli._e2e, "
        "ffpa_attn_tpu_torch.cli._headline, ffpa_attn_tpu_torch.cli._flops, "
        "ffpa_attn_tpu_torch.bench\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'ffpa_attn_tpu' or m.startswith('ffpa_attn_tpu.'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), cwd=str(ROOT), timeout=120)
    assert res.returncode == 0, res.stderr


def test_serve_paged_window_leg_on_card(cuda):
    """On the card the windowed leg's prefill launches the varlen forward
    once a layer and each decode step the paged kernel once a layer."""
    out = _e2e.bench_serve_paged_window(device=cuda, **dict(
        TINY, n_layers=2, batch=2, prompt_len=300, gen_len=6, window=64, page_size=16))
    assert out["launches"] == {"varlen_fwd": 2, "paged_decode": 2 * 5}
    assert out["value"] > 0
