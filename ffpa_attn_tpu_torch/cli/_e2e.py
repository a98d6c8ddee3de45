"""End-to-end tokens/s benchmarks on the port's large-head-dim transformer.

The JAX package's ``cli/_e2e.py`` legs on ``ffpa_attn_tpu_torch.models``,
with the same defaults and metric names; weights from
``random_params(cfg, seed=0)`` through ``params_from_jax``, tokens and
prompts from numpy seeds:

* ``train``: ``make_train_step`` with ``adamw(1e-4)``; tokens/s = B * N /
  step time over the timed steps after one warm-up step.
* ``decode``: ``generate`` after a prefill; tokens/s = generated tokens /
  the second call's time.
* ``serve*``: continuous batching, one packed varlen prefill then batched
  decode over the dense shared-row cache or paged pools (bf16, int8, a
  sliding-window model); tokens/s = B * gen / the second call's time.
* ``speculative*``: ``speculative_generate`` with the target itself or its
  first layer as the draft.
* ``scaling_projection``: the flagship forward's measured rate fed to the
  two-host ring-scaling model (``parallel/analysis.py``).

Each leg times its second call on the host clock after
``torch.cuda.synchronize()`` and reports the kernels that call launched.
``main`` runs each leg in a subprocess of its own: a sticky CUDA error (an
illegal address) poisons its process's context for every later leg.
"""

from __future__ import annotations

import functools
import json
import time
from dataclasses import replace

import numpy as np
import torch

from ._bench import _sync

# bench_speculative's workload, which chip_smoke.py also drives.
SPEC_PROMPT, SPEC_GEN, SPEC_K = 1024, 128, 4


def timed_call(fn, device: torch.device, warmup: bool = True) -> tuple:
    """(output, seconds, launches) of one call of ``fn`` after a warm-up
    call: the host clock to a synchronize, and the port's kernel launches
    of that call, counted from zero just before it."""
    from ..utils.profiling import launch_counts

    if warmup:
        fn()
        _sync(device)
    launch_counts(zero=True)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    dt = time.perf_counter() - t0
    return out, dt, {n: c for n, c in launch_counts().items() if c}


def _model(*, vocab, d_model, n_layers, n_heads, n_kv_heads, head_dim, max_seq_len, device,
           **overrides):
    from ..models import ModelConfig, params_from_jax, random_params

    cfg = ModelConfig(
        vocab_size=vocab, d_model=d_model, n_layers=n_layers,
        n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim,
        max_seq_len=max_seq_len, **overrides,
    )
    return params_from_jax(random_params(cfg, seed=0), cfg, device=device)


def shared_model(model, **cfg_changes):
    """A ``Transformer`` with ``model``'s weights (the same tensors) under a
    changed config; ``n_layers=m`` keeps the first m layers (the
    shallow-layer draft)."""
    from torch import nn

    from ..models import Transformer

    cfg = replace(model.cfg, **cfg_changes)
    other = Transformer(cfg, device="meta")
    other.embed, other.final_norm = model.embed, model.final_norm
    other.layers = nn.ModuleList(list(model.layers)[:cfg.n_layers])
    return other


def bench_train(
    *, b=1, n=8192, d_model=1024, n_layers=4, n_heads=8, n_kv_heads=4,
    head_dim=512, vocab=32000, steps=3, device=None,
) -> dict:
    from ..models import adamw, make_train_step

    model = _model(vocab=vocab, d_model=d_model, n_layers=n_layers, n_heads=n_heads,
                   n_kv_heads=n_kv_heads, head_dim=head_dim, max_seq_len=n, device=device)
    dev = model.embed.device
    opt = adamw(1e-4)
    state = {"opt": opt.init(list(model.parameters()))}
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, vocab, (b, n + 1))).to(dev)
    step = make_train_step(model.cfg, opt, device=dev)

    def one_step():
        state["opt"], state["loss"] = step(model, state["opt"], tokens)

    def timed_steps():
        for _ in range(steps):
            one_step()

    one_step()  # warm-up
    _, dt, launches = timed_call(timed_steps, dev, warmup=False)
    dt /= steps
    return {
        "metric": "train_tokens_per_s",
        "value": round(b * n / dt, 1),
        "unit": "tokens/s",
        "config": f"L{n_layers} dm{d_model} H{n_heads}/{n_kv_heads} Dh{head_dim} N{n} B{b}",
        "step_ms": round(dt * 1e3, 2),
        "loss": float(state["loss"]),
        "launches": launches,
    }


def bench_decode(
    *, b=1, prompt_len=4096, gen_len=128, d_model=1024, n_layers=4,
    n_heads=8, n_kv_heads=4, head_dim=512, vocab=32000, device=None,
) -> dict:
    from ..models import generate

    model = _model(vocab=vocab, d_model=d_model, n_layers=n_layers, n_heads=n_heads,
                   n_kv_heads=n_kv_heads, head_dim=head_dim,
                   max_seq_len=prompt_len + gen_len, device=device)
    dev = model.embed.device
    prompt = torch.from_numpy(
        np.random.default_rng(1).integers(0, vocab, (b, prompt_len))).to(dev)
    _, dt, launches = timed_call(lambda: generate(model, prompt, gen_len), dev)
    return {
        "metric": "decode_tokens_per_s",
        "value": round(b * gen_len / dt, 1),
        "unit": "tokens/s",
        "config": f"L{n_layers} dm{d_model} H{n_heads}/{n_kv_heads} Dh{head_dim} "
        f"prompt{prompt_len} gen{gen_len} B{b}",
        "total_s": round(dt, 3),
        "launches": launches,
    }


def serve_prompts(batch: int, prompt_len: int, vocab: int, device) -> list:
    """The serving legs' prompts: lengths prompt_len - rng.integers(0,
    prompt_len // 2), then the tokens, from numpy seed 0."""
    rng = np.random.default_rng(0)
    lens = [prompt_len - int(rng.integers(0, prompt_len // 2)) for _ in range(batch)]
    return [torch.from_numpy(rng.integers(0, vocab, (ln,))).to(device) for ln in lens]


def _bench_serve_impl(
    serve_fn, metric: str, *, batch, prompt_len, gen_len, d_model, n_layers,
    n_heads, n_kv_heads, head_dim, vocab, extra_cfg: str = "",
    cfg_overrides: dict | None = None, device=None,
    **serve_kwargs,
) -> dict:
    """Shared continuous-batching bench: the same workload for every serving
    flavor (the dense-vs-paged comparison stays like-for-like)."""
    max_len = prompt_len + gen_len
    model = _model(vocab=vocab, d_model=d_model, n_layers=n_layers, n_heads=n_heads,
                   n_kv_heads=n_kv_heads, head_dim=head_dim, max_seq_len=max_len,
                   device=device, **(cfg_overrides or {}))
    dev = model.embed.device
    prompts = serve_prompts(batch, prompt_len, vocab, dev)
    _, dt, launches = timed_call(
        lambda: serve_fn(model, prompts, gen_len, max_len, **serve_kwargs), dev)
    return {
        "metric": metric,
        "value": round(batch * gen_len / dt, 1),
        "unit": "tokens/s",
        "config": f"B{batch} mixed-prompts<= {prompt_len} gen{gen_len} "
        f"{extra_cfg}L{n_layers} dm{d_model} H{n_heads}/{n_kv_heads} "
        f"Dh{head_dim}",
        "total_s": round(dt, 3),
        "launches": launches,
    }


def bench_serve(
    *, batch=4, prompt_len=1024, gen_len=128, d_model=1024, n_layers=4,
    n_heads=8, n_kv_heads=4, head_dim=512, vocab=32000, device=None,
) -> dict:
    """Continuous batching: packed mixed-length varlen prefill + batched
    ragged decode over the dense shared-row cache (models/serving.py)."""
    from ..models import serve_batch

    return _bench_serve_impl(
        serve_batch, "serve_tokens_per_s", batch=batch,
        prompt_len=prompt_len, gen_len=gen_len, d_model=d_model,
        n_layers=n_layers, n_heads=n_heads, n_kv_heads=n_kv_heads,
        head_dim=head_dim, vocab=vocab, device=device,
    )


def bench_serve_paged(
    *, batch=4, prompt_len=1024, gen_len=128, d_model=1024, n_layers=4,
    n_heads=8, n_kv_heads=4, head_dim=512, vocab=32000, page_size=256, device=None,
) -> dict:
    """Paged continuous batching (ops/paged.py pools): the bench_serve
    workload with KV in per-layer page pools, so a ragged batch streams
    bytes in proportion to its true lengths."""
    from ..models import serve_batch_paged

    return _bench_serve_impl(
        serve_batch_paged, "serve_paged_tokens_per_s", batch=batch,
        prompt_len=prompt_len, gen_len=gen_len, d_model=d_model,
        n_layers=n_layers, n_heads=n_heads, n_kv_heads=n_kv_heads,
        head_dim=head_dim, vocab=vocab, extra_cfg=f"page{page_size} ",
        page_size=page_size, device=device,
    )


def bench_serve_paged_int8(**kw) -> dict:
    """int8 KV pools: half the decode stream on the bandwidth-bound step."""
    from ..models import serve_batch_paged

    kw.setdefault("page_size", 256)
    return _bench_serve_impl(
        serve_batch_paged, "serve_paged_int8_tokens_per_s",
        batch=kw.pop("batch", 4), prompt_len=kw.pop("prompt_len", 1024),
        gen_len=kw.pop("gen_len", 128), d_model=kw.pop("d_model", 1024),
        n_layers=kw.pop("n_layers", 4), n_heads=kw.pop("n_heads", 8),
        n_kv_heads=kw.pop("n_kv_heads", 4), head_dim=kw.pop("head_dim", 512),
        vocab=kw.pop("vocab", 32000),
        extra_cfg=f"page{kw['page_size']} int8 ",
        quantized=True, **kw,
    )


def bench_serve_paged_window(
    *, batch=4, prompt_len=1024, gen_len=128, window=256, **kw
) -> dict:
    """Sliding-window model serving over paged pools: the page walk reads
    only the window's pages, O(W) bytes per step whatever the cache length
    (the Mistral / gpt-oss serving shape); compare against
    serve_paged_tokens_per_s, whose per-step stream grows with the cache."""
    from ..models import serve_batch_paged

    page_size = kw.pop("page_size", 128)
    return _bench_serve_impl(
        serve_batch_paged, "serve_paged_window_tokens_per_s", batch=batch,
        prompt_len=prompt_len, gen_len=gen_len,
        d_model=kw.pop("d_model", 1024), n_layers=kw.pop("n_layers", 4),
        n_heads=kw.pop("n_heads", 8), n_kv_heads=kw.pop("n_kv_heads", 4),
        head_dim=kw.pop("head_dim", 512), vocab=kw.pop("vocab", 32000),
        extra_cfg=f"page{page_size} W{window} ",
        cfg_overrides={"sliding_window": window},
        page_size=page_size, **kw,
    )


def speculative_workload(model, *, prompt_len=SPEC_PROMPT, gen_len=SPEC_GEN, k_spec=SPEC_K,
                         draft_layers=0) -> tuple:
    """bench_speculative's workload on ``model``: (prompt [1, prompt_len]
    from numpy seed 0, the draft, max_len = prompt + gen + k_spec + 2, its
    label). ``draft_layers=0`` drafts with the target itself; ``m > 0``
    with the target's first m layers (shared weights, a cache of its
    own)."""
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, (1, prompt_len))).to(model.embed.device)
    if draft_layers > 0:
        draft = shared_model(model, n_layers=draft_layers)
        label = f"shallow-draft L{draft_layers}/{model.cfg.n_layers}"
    else:
        draft, label = model, "self-spec"
    return prompt, draft, prompt_len + gen_len + k_spec + 2, label


def run_speculative(model, draft, prompt, gen_len, max_len, k_spec, warmup=True) -> dict:
    """One ``speculative_generate`` call timed by ``timed_call``:
    {"toks", "stats", "seconds", "launches"}."""
    from ..models import speculative_generate

    (toks, stats), dt, launches = timed_call(
        lambda: speculative_generate(model, draft, prompt, gen_len, max_len, k_spec=k_spec,
                                     return_stats=True),
        model.embed.device, warmup=warmup)
    return dict(toks=toks, stats=stats, seconds=dt, launches=launches)


def bench_speculative(
    *, prompt_len=SPEC_PROMPT, gen_len=SPEC_GEN, k_spec=SPEC_K, d_model=1024, n_layers=4,
    n_heads=8, n_kv_heads=4, head_dim=512, vocab=32000, draft_layers=0, device=None,
) -> dict:
    """Speculative decoding tokens/s.

    ``draft_layers=0`` (self-spec, draft == target): the acceptance-rate
    ceiling; it cannot beat plain decode (the draft costs as much as the
    target) and checks the verify-block plumbing. ``draft_layers=m > 0``:
    the target's first m layers as the draft; per accepted token it costs
    m/L of a target step."""
    model = _model(vocab=vocab, d_model=d_model, n_layers=n_layers, n_heads=n_heads,
                   n_kv_heads=n_kv_heads, head_dim=head_dim,
                   max_seq_len=prompt_len + gen_len + k_spec + 2, device=device)
    prompt, draft, max_len, label = speculative_workload(
        model, prompt_len=prompt_len, gen_len=gen_len, k_spec=k_spec, draft_layers=draft_layers)
    r = run_speculative(model, draft, prompt, gen_len, max_len, k_spec)
    stats = r["stats"]
    return {
        "metric": "speculative_tokens_per_s"
        if draft_layers == 0
        else "speculative_draft_tokens_per_s",
        "value": round(gen_len / r["seconds"], 1),
        "unit": "tokens/s",
        "config": f"{label} k{k_spec} prompt{prompt_len} gen{gen_len} "
        f"L{n_layers} dm{d_model} H{n_heads}/{n_kv_heads} Dh{head_dim}",
        "accept_rate": round(
            stats["draft_accepted"] / max(stats["proposals"], 1), 3
        ),
        "total_s": round(r["seconds"], 3),
        "launches": r["launches"],
    }


def bench_scaling_projection(*, device=None) -> dict:
    """The two-host ring-scaling projection anchored to a rate measured on
    this card now: the flagship forward case (B1 H32 N8192 D512 bf16) is
    timed with ``run_case`` and its FLOP rate feeds the analytic model's
    compute leg (``parallel/analysis.py``). The link bandwidths and the
    step latency stay the labelled spec and model constants, printed under
    names that say so: the result is a projection, not a measurement."""
    from ..parallel.analysis import (
        NETWORK_BW_BYTES, NVLINK_BW_BYTES, STEP_LATENCY_S, two_host_report,
    )
    from ._bench import make_case, run_case

    row = run_case(make_case("self-attn", 1, 32, 8192, 512), torch.bfloat16, "fwd", iters=5,
                   verify=False, device=device)
    measured = row["ffpa_tflops"] * 1e12
    return {
        "metric": "ring_scaling_projection",
        "measured_tflops": round(measured / 1e12, 1),
        "measured_on": "B1 H32 N8192 D512 bf16 fwd",
        "nvlink_gbytes_per_s_SPEC": NVLINK_BW_BYTES / 1e9,
        "network_gbytes_per_s_SPEC": NETWORK_BW_BYTES / 1e9,
        "step_latency_us_MODEL_CONSTANT": STEP_LATENCY_S * 1e6,
        "projections": [
            {
                "chips": p.chips,
                "step_ms": round(p.t_step_ms, 3),
                "hop_ms": round(p.t_hop_ms, 3),
                "efficiency_pct": round(p.efficiency * 100, 1),
            }
            for p in two_host_report(flops_rate=measured)
        ],
    }


#: name -> bench callable (keyword ``device``). Ordered; ``main`` runs each
#: in a process of its own.
E2E_BENCHES = {
    "smoke": functools.partial(
        bench_decode, b=1, prompt_len=64, gen_len=8, d_model=64, n_layers=1,
        n_heads=2, n_kv_heads=1, head_dim=64, vocab=256,
    ),
    "train": bench_train,
    "decode": bench_decode,
    "serve": bench_serve,
    "serve_paged": bench_serve_paged,
    "serve_paged_int8": bench_serve_paged_int8,
    "serve_paged_window": bench_serve_paged_window,
    "speculative": bench_speculative,
    "speculative_draft": functools.partial(bench_speculative, draft_layers=1),
    "scaling_projection": bench_scaling_projection,
}


def run_one(name: str, device=None) -> int:
    """Run a single e2e bench in THIS process; full traceback on stderr."""
    import traceback

    fn = E2E_BENCHES[name]
    try:
        print(json.dumps(fn(device=device)), flush=True)
        return 0
    except Exception as exc:
        traceback.print_exc()
        print(
            json.dumps({"metric": f"bench_{name}", "error": str(exc)[:300]}),
            flush=True,
        )
        return 1


def main(argv=None, only=None, device=None) -> int:
    """Run each bench in a fresh subprocess on ``device`` (passed down as
    ``--device``).

    ``only`` (or FFPA_TORCH_E2E_ONLY, comma-separated names) restricts the
    set; FFPA_TORCH_E2E_INPROC=1 runs in this process instead (the
    subprocess leg itself, and handy under debuggers);
    FFPA_TORCH_E2E_LEG_TIMEOUT_S caps each leg's wall time (default 1200).
    """
    import os
    import subprocess
    import sys

    del argv
    # "smoke" is a plumbing leg (tiny shapes, Dh64 below FFPA's head dims:
    # the fp32 reference takes it), selectable but not in the default sweep.
    names = [n for n in E2E_BENCHES if n != "smoke"]
    sel = only or os.environ.get("FFPA_TORCH_E2E_ONLY")
    if sel:
        sel = [s.strip() for s in (sel.split(",") if isinstance(sel, str) else sel)]
        unknown = [s for s in sel if s not in E2E_BENCHES]
        if unknown:
            raise SystemExit(
                f"unknown e2e bench(es) {unknown}; have {list(E2E_BENCHES)}"
            )
        names = sel

    if os.environ.get("FFPA_TORCH_E2E_INPROC") == "1":
        rc = 0
        for name in names:
            rc |= run_one(name, device)
        return rc

    leg_timeout = int(os.environ.get("FFPA_TORCH_E2E_LEG_TIMEOUT_S") or 1200)
    cmd = [sys.executable, "-m", "ffpa_attn_tpu_torch.bench", "--e2e"]
    if device is not None:
        cmd += ["--device", str(device)]
    rc = 0
    for name in names:
        env = dict(os.environ, FFPA_TORCH_E2E_INPROC="1", FFPA_TORCH_E2E_ONLY=name)
        try:
            proc = subprocess.run(
                cmd, env=env, capture_output=True, text=True, timeout=leg_timeout,
            )
        except subprocess.TimeoutExpired:
            rc = 1
            print(
                json.dumps({
                    "metric": f"bench_{name}",
                    "error": f"timeout after {leg_timeout}s",
                }),
                flush=True,
            )
            continue
        emitted = [
            ln for ln in proc.stdout.splitlines()
            if ln.startswith("{") and '"metric"' in ln
        ]
        for ln in emitted:
            print(ln, flush=True)
        if proc.returncode != 0 or not emitted:
            rc = 1
            sys.stderr.write(proc.stderr[-4000:] + "\n")
            if not emitted:
                print(
                    json.dumps({
                        "metric": f"bench_{name}",
                        "error": f"subprocess rc={proc.returncode}",
                    }),
                    flush=True,
                )
    return rc
