"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It imports only ``ffpa_attn_tpu_torch``, torch and numpy, and runs, in order:

1. environment: torch / CUDA / nvcc versions and the card's name and power
   limit;
2. build: every kernel of the serving path from ``ffpa_attn_tpu_torch/csrc``
   (one nvcc per source, all started together);
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, at the serving shapes and at feature cases, with stated tolerances;
4. main path: greedy ``generate`` of the L4 dm1024 H8/4 Dh512 vocab-32000
   bf16 model (random weights from numpy seed 0) on a 4096-token prompt, 32
   tokens, with the kernel launch counts read around that run; first-step
   logits against the same weights run with the fp32 oracle's attention; a
   tiny model's greedy tokens on the card against the CPU;
5. times: device time by kernel and the device's busy share over one
   prefill and over decode steps, then each kernel at its serving shape
   beside its bound, its plain version and one PyTorch library call
   computing the same function (device time per call from torch.profiler,
   CUDA-event time beside it);
6. the ``kernels`` line.

Every phase raises on failure; the script exits 0 only when all passed. The
last three lines are the ``kernels`` JSON line, the nvidia-smi line and the
``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# Output tolerances (tests/test_features.py:127, tests/test_ffpa_bwd.py:19),
# held per row: see row_rel.
BF16_TOL, F16_TOL = 2e-2, 1e-2
LSE_TOL = 1e-4  # relative to max|lse|: fp32 math on identical inputs

SLICE = dict(vocab_size=32000, d_model=1024, n_layers=4, n_heads=8, n_kv_heads=4,
             head_dim=512, max_seq_len=4224, dtype="bfloat16")
PROMPT, STEPS, MAX_LEN = 4096, 32, 4224


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def rel(got, want) -> float:
    """max|got - want| over max|want| of the whole tensor."""
    g, w = got.float(), want.float()
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-12))


def row_rel(got, want) -> float:
    """The largest, over rows (the last dim), of a row's max|got - want| over
    that row's max|want|. A causal row averages over as many V rows as it
    sees, so late rows are far smaller than row 0 (which is V's row 0); a
    whole-tensor measure would let an error in their P.V pass. A row that is
    0 in the plain version must be 0 in the kernel's too."""
    g, w = got.float(), want.float()
    err, ref = (g - w).abs().amax(-1), w.abs().amax(-1)
    return float(torch.where(err == 0, 0.0, err / ref.clamp_min(1e-30)).max())


def max_abs(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if out else ""


def phase_environment() -> str:
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    from ffpa_attn_tpu_torch.ops._build import _nvcc

    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[-1]
    log(f"nvcc: {nvcc}")
    smi = smi_line()
    log(f"card: {smi} ({torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs)")
    return smi


def phase_build() -> None:
    from ffpa_attn_tpu_torch.ops import _build

    t0 = time.perf_counter()
    times = _build.build()
    log(f"build: {json.dumps({k: round(v, 1) for k, v in times.items()})} "
        f"wall {time.perf_counter() - t0:.1f} s -> {_build.BUILD_DIR}")


def _randn(shape, dtype, gen, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def _fwd_case(name, *, b=1, hq=8, hkv=4, nq, nkv, d=512, dtype=torch.bfloat16,
              causal=True, bias=False, softcap=0.0, window=(-1, -1), alibi=False, seed=0):
    from ffpa_attn_tpu_torch.ops import flash_fwd

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = _randn((b, hq, nq, d), dtype, gen)
    k = _randn((b, hkv, nkv, d), dtype, gen)
    v = _randn((b, hkv, nkv, d), dtype, gen)
    kw = dict(scale=1.0 / math.sqrt(d), is_causal=causal, softcap=softcap, window=window)
    bias_t = _randn((b, 1, nq, nkv), torch.float32, gen) if bias else None
    if alibi:
        kw["alibi_slopes"] = torch.rand((b, hq), generator=gen, device="cuda") * 0.1
    o, lse = flash_fwd.flash_attention_forward(q, k, v, bias_t, **kw)
    torch.cuda.synchronize()
    po, plse = flash_fwd.flash_attention_forward_plain(q, k, v, bias_t, **kw)
    tol = F16_TOL if dtype == torch.float16 else BF16_TOL
    err, lerr = row_rel(o, po), rel(lse, plse)
    ok = err < tol and lerr < LSE_TOL and bool(torch.isfinite(o).all())
    log(f"  fwd {name:<22} row_rel_err {err:.2e} (tol {tol:g}) rel_err {rel(o, po):.2e} "
        f"lse_rel_err {lerr:.2e} (tol {LSE_TOL:g}) max_abs_err {max_abs(o, po):.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"forward kernel disagrees with its plain version: {name}")
    return max_abs(o, po)


def _decode_case(name, *, b=1, hkv=4, group=2, nq=1, nkv=MAX_LEN, d=512, dtype=torch.bfloat16,
                 valid=PROMPT + 1, causal=False, softcap=0.0, window=(-1, -1), seed=0):
    from ffpa_attn_tpu_torch.ops import decode
    from ffpa_attn_tpu_torch.ops.reference import DEFAULT_MASK_VALUE

    gen = torch.Generator(device="cuda").manual_seed(seed)
    hq = hkv * group
    q = _randn((b, hq, nq, d), dtype, gen)
    k = _randn((b, hkv, nkv, d), dtype, gen)
    v = _randn((b, hkv, nkv, d), dtype, gen)
    bias = None
    if valid is not None:
        cols = torch.arange(nkv, device="cuda")
        bias = torch.where(cols < valid, 0.0, DEFAULT_MASK_VALUE).float()[None, None, None]
    kw = dict(scale=1.0 / math.sqrt(d), is_causal=causal, softcap=softcap, window=window)
    o, lse = decode._decode_forward(q, k, v, bias, **kw)
    torch.cuda.synchronize()
    qp = q.reshape(b, hkv, group * nq, d)
    po, plse = decode._decode_plain(qp, k, v, bias, nq=nq, scale=kw["scale"], is_causal=causal,
                                    softcap=softcap, window_left=window[0],
                                    window_right=window[1])
    po, plse = po.reshape(o.shape), plse.reshape(lse.shape)
    tol = F16_TOL if dtype == torch.float16 else BF16_TOL
    err, lerr = row_rel(o, po), rel(lse, plse)
    ok = err < tol and lerr < LSE_TOL and bool(torch.isfinite(o).all())
    log(f"  decode {name:<19} row_rel_err {err:.2e} (tol {tol:g}) rel_err {rel(o, po):.2e} "
        f"lse_rel_err {lerr:.2e} (tol {LSE_TOL:g}) max_abs_err {max_abs(o, po):.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"decode kernel disagrees with its plain version: {name}")
    return max_abs(o, po)


def phase_kernels_vs_plain() -> dict:
    log("kernel vs plain (the plain version in fp32 math on the card; TF32 off):")
    errs = {}
    errs["flash_fwd"] = _fwd_case("slice_N4096_D512", nq=PROMPT, nkv=PROMPT)
    _fwd_case("bias", nq=1024, nkv=1024, causal=False, bias=True, seed=1)
    _fwd_case("softcap", nq=1024, nkv=1024, softcap=30.0, seed=2)
    _fwd_case("window", nq=1024, nkv=1024, window=(256, -1), seed=3)
    _fwd_case("alibi", nq=1024, nkv=1024, alibi=True, seed=4)
    _fwd_case("nkv4100", nq=1024, nkv=4100, seed=5)
    _fwd_case("d320", nq=1024, nkv=1024, d=320, seed=6)
    _fwd_case("d1024", nq=1024, nkv=1024, d=1024, seed=7)
    _fwd_case("fp16", nq=2048, nkv=2048, dtype=torch.float16, seed=8)
    _fwd_case("batch2_bias_alibi", b=2, nq=1024, nkv=1100, bias=True, alibi=True, seed=9)
    errs["decode"] = _decode_case("slice_Nkv4224_g2")
    _decode_case("group1", group=1, seed=1)
    _decode_case("group4", group=4, seed=2)
    _decode_case("softcap", softcap=30.0, seed=3)
    _decode_case("window", window=(1024, -1), causal=True, valid=None, seed=4)
    _decode_case("nq4_causal", nq=4, causal=True, valid=None, seed=5)
    _decode_case("fp16", dtype=torch.float16, seed=6)
    _decode_case("batch2", b=2, nkv=1024, valid=900, seed=7)
    return errs


@torch.inference_mode()
def oracle_logits(model, prompt, first):
    """Prefill logits and the first decode step's logits of ``model`` with
    every attention computed by the fp32 oracle (``reference_attention``)
    over the prompt's K/V, written out here so that no kernel and no kernel
    wrapper runs. The slice's model has no window, softcap or sinks."""
    from ffpa_attn_tpu_torch.models.generate import _project_qkv
    from ffpa_attn_tpu_torch.models.transformer import _mlp, _rmsnorm
    from ffpa_attn_tpu_torch.ops.reference import expand_kv_heads, reference_attention

    cfg = model.cfg
    b, n = prompt.shape

    def layer_attention(layer, x, positions, kv, is_causal):
        q, k, v = _project_qkv(layer, _rmsnorm(x, layer.attn_norm), cfg, positions)
        if kv:  # the decode step: the prompt's K/V and this token's
            k, v = torch.cat([kv[0], k], dim=2), torch.cat([kv[1], v], dim=2)
        o = reference_attention(q, expand_kv_heads(k, cfg.n_heads),
                                expand_kv_heads(v, cfg.n_heads), is_causal=is_causal)
        x = x + layer.wo(o.transpose(1, 2).reshape(b, q.shape[2], -1))
        return x + _mlp(layer, _rmsnorm(x, layer.mlp_norm)), (k, v)

    def head(x):
        return _rmsnorm(x[:, -1], model.final_norm) @ model.embed.T

    x, kvs = model.embed[prompt], []
    for layer in model.layers:
        x, kv = layer_attention(layer, x, torch.arange(n, device=prompt.device), None, True)
        kvs.append(kv)
    logits0 = head(x)
    x = model.embed[first][:, None]
    pos = torch.full((1,), n, dtype=torch.int64, device=prompt.device)
    for layer, kv in zip(model.layers, kvs):
        x, _ = layer_attention(layer, x, pos, kv, False)
    return logits0, head(x)


def phase_main_path() -> dict:
    from ffpa_attn_tpu_torch.models import (
        ModelConfig, decode_step, generate, init_kv_cache, params_from_jax, prefill,
        random_params,
    )
    from ffpa_attn_tpu_torch.ops import decode, flash_fwd

    cfg = ModelConfig(**SLICE)
    t0 = time.perf_counter()
    model = params_from_jax(random_params(cfg, seed=0), cfg)  # on cuda by default
    log(f"main path: model L{cfg.n_layers} dm{cfg.d_model} H{cfg.n_heads}/{cfg.n_kv_heads} "
        f"Dh{cfg.head_dim} vocab {cfg.vocab_size} {cfg.dtype}, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, "
        f"built in {time.perf_counter() - t0:.1f} s")
    prompt = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (1, PROMPT))).cuda()

    generate(model, prompt, 2, max_len=MAX_LEN)  # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()

    flash_fwd.flash_attention_forward.launches = 0
    decode._decode_forward.launches = 0
    t0 = time.perf_counter()
    toks = generate(model, prompt, STEPS, max_len=MAX_LEN)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {"flash_fwd": flash_fwd.flash_attention_forward.launches,
                "decode": decode._decode_forward.launches}
    log(f"  generate: {STEPS} tokens in {gen_s * 1e3:.1f} ms, launches {launches}")
    want = {"flash_fwd": cfg.n_layers, "decode": cfg.n_layers * STEPS}
    if launches != want:
        fail(f"launch counts {launches} != expected {want}")
    if tuple(toks.shape) != (1, STEPS) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail(f"bad generated tokens {toks}")
    log(f"  tokens: {toks[0].tolist()}")

    # Prefill time and decode rate, through the same entry points.
    def run_prefill():
        return prefill(model, prompt, init_kv_cache(cfg, 1, MAX_LEN))

    prefill_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits0, cache = run_prefill()
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    tok = logits0.argmax(-1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(STEPS):
        logits, cache = decode_step(model, cache, PROMPT + i, tok)
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    prefill_med = sorted(prefill_ms)[1]
    tok_s = STEPS / decode_s
    log(f"  prefill {prefill_med:.2f} ms (median of 3: {[round(x, 2) for x in prefill_ms]}); "
        f"decode {tok_s:.1f} tokens/s ({decode_s / STEPS * 1e3:.3f} ms/token, B1)")

    # First-step logits: the main path vs the same weights with the oracle's
    # attention.
    k_logits0, k_cache = run_prefill()
    first = k_logits0.argmax(-1)
    k_logits1, _ = decode_step(model, k_cache, PROMPT, first)
    p_logits0, p_logits1 = oracle_logits(model, prompt, first)
    e0, e1 = row_rel(k_logits0, p_logits0), row_rel(k_logits1, p_logits1)
    same = bool(k_logits0.argmax(-1) == p_logits0.argmax(-1)) and bool(
        k_logits1.argmax(-1) == p_logits1.argmax(-1))
    ok = e0 < BF16_TOL and e1 < BF16_TOL and bool(torch.isfinite(k_logits1).all())
    log(f"  first-step logits vs the oracle's attention: prefill rel_err {e0:.2e}, decode "
        f"rel_err {e1:.2e} (tol {BF16_TOL:g}, of max|logit|), same argmax {same} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("main-path logits disagree with the oracle's attention")

    # Tiny model: greedy tokens on the card equal the CPU's plain path.
    tiny = ModelConfig(vocab_size=64, d_model=64, n_layers=1, n_heads=2, n_kv_heads=1,
                       head_dim=320, max_seq_len=256)
    params = random_params(tiny, seed=2)
    tprompt = torch.from_numpy(np.random.default_rng(3).integers(0, 64, (1, 128)))
    on_card = generate(params_from_jax(params, tiny), tprompt, 8).cpu()
    on_cpu = generate(params_from_jax(params, tiny, device="cpu"), tprompt, 8)
    log(f"  tiny model greedy tokens card {on_card[0].tolist()} cpu {on_cpu[0].tolist()}")
    if not torch.equal(on_card, on_cpu):
        fail("tiny model: greedy tokens on the card differ from the CPU")
    return dict(launches=launches, prefill_ms=prefill_med, decode_tok_s=tok_s,
                generate_ms=gen_s * 1e3, model=model, prompt=prompt)


def where_the_time_goes(model, prompt) -> None:
    """Device time by kernel and the device's busy share over one prefill
    and over 8 decode steps of the main path (torch.profiler)."""
    from ffpa_attn_tpu_torch.models import decode_step, init_kv_cache, prefill
    from ffpa_attn_tpu_torch.utils.profiling import device_window

    cfg = model.cfg
    state = {}

    def run_prefill():
        state["logits"], state["cache"] = prefill(model, prompt, init_kv_cache(cfg, 1, MAX_LEN))

    def run_decode():
        tok = state["logits"].argmax(-1)
        for i in range(8):
            logits, state["cache"] = decode_step(model, state["cache"], PROMPT + i, tok)
            tok = logits.argmax(-1)

    log("where the time goes (torch.profiler, device time by kernel):")
    for name, fn, reps in (("prefill", run_prefill, 1), ("decode x8", run_decode, 1)):
        w = device_window(fn, reps=reps, warmup=1)
        top = sorted(w["by_kernel"].items(), key=lambda kv: -kv[1])[:6]
        log(f"  {name}: wall {w['wall_ms']:.2f} ms, device {w['device_ms']:.2f} ms, "
            f"busy {w['busy'] * 100:.1f}% (idle {(1 - w['busy']) * 100:.1f}%)")
        for kname, ms in top:
            log(f"    {ms:9.3f} ms  {kname[:100]}")


def _timed(fn, reps: int, warmup: int = 3) -> tuple:
    """(device ms per call from the profiler, CUDA-event ms per call); the
    first is the kernel time, the second adds whatever host gaps there are.
    Raises when the profiler saw no device time."""
    from ffpa_attn_tpu_torch.utils.profiling import cuda_ms, device_ms

    return device_ms(fn, reps=reps, warmup=1), cuda_ms(fn, reps=reps, warmup=warmup)


def phase_times(errs: dict, main_path: dict) -> list:
    import torch.nn.functional as F

    from ffpa_attn_tpu_torch.ops import decode, flash_fwd
    from ffpa_attn_tpu_torch.ops.reference import DEFAULT_MASK_VALUE
    from ffpa_attn_tpu_torch.utils.profiling import bound_ms

    where_the_time_goes(main_path["model"], main_path["prompt"])
    launches = main_path["launches"]
    gen = torch.Generator(device="cuda").manual_seed(11)
    bf = torch.bfloat16
    b, hq, hkv, d = 1, SLICE["n_heads"], SLICE["n_kv_heads"], SLICE["head_dim"]
    scale = 1.0 / math.sqrt(d)
    rows = []

    # Forward at the prefill shape.
    q = _randn((b, hq, PROMPT, d), bf, gen)
    k = _randn((b, hkv, PROMPT, d), bf, gen)
    v = _randn((b, hkv, PROMPT, d), bf, gen)
    pairs = sum(min(PROMPT, i + 1) for i in range(PROMPT))  # causal (row, col) pairs
    flops = 2 * b * hq * pairs * (d + d)
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel()) + 4 * b * hq * PROMPT
    kw = dict(scale=scale, is_causal=True)
    kms = _timed(lambda: flash_fwd.flash_attention_forward(q, k, v, None, **kw), 20)
    pms = _timed(lambda: flash_fwd.flash_attention_forward_plain(q, k, v, None, **kw), 5)
    lms = _timed(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                        enable_gqa=True), 10)
    bms, bby = bound_ms(flops, nbytes)
    rows.append(dict(
        name="flash_fwd", route="cuda", source="ffpa_attn_tpu_torch/csrc/flash_fwd.cu",
        replaces="ffpa_attn_tpu/ops/flash_fwd.py:77", launches=launches["flash_fwd"],
        max_abs_err=errs["flash_fwd"], ms=kms[0], plain_ms=pms[0], bound_ms=bms,
        bound_by=bby, library_ms=lms[0],
    ))
    events = {"flash_fwd": (kms[1], pms[1], lms[1])}

    # Decode at the serving step: Nkv = max_len, GQA group 2, validity bias.
    # Four caches, one per layer, so K/V (34.6 MB each) do not sit in L2.
    caches = [(_randn((b, hkv, MAX_LEN, d), bf, gen), _randn((b, hkv, MAX_LEN, d), bf, gen))
              for _ in range(SLICE["n_layers"])]
    qd = _randn((b, hq, 1, d), bf, gen)
    cols = torch.arange(MAX_LEN, device="cuda")
    bias = torch.where(cols <= PROMPT, 0.0, DEFAULT_MASK_VALUE).float()[None, None, None]
    bias_bf = bias.to(bf)
    it = iter(range(1 << 30))

    def pick():
        return caches[next(it) % len(caches)]

    def run_kernel():
        kc, vc = pick()
        return decode._decode_forward(qd, kc, vc, bias, scale=scale, is_causal=False)

    def run_plain():
        kc, vc = pick()
        return decode._decode_plain(qd.reshape(b, hkv, 2, d), kc, vc, bias, nq=1, scale=scale,
                                    is_causal=False, softcap=0.0, window_left=-1,
                                    window_right=-1)

    def run_library():
        kc, vc = pick()
        return F.scaled_dot_product_attention(qd, kc, vc, attn_mask=bias_bf, enable_gqa=True)

    nbytes = 2 * (2 * qd.numel() + 2 * b * hkv * MAX_LEN * d) + 4 * MAX_LEN + 4 * b * hq
    flops = 2 * b * hq * MAX_LEN * (d + d)
    kms = _timed(run_kernel, 100, warmup=8)
    pms = _timed(run_plain, 40)
    lms = _timed(run_library, 100, warmup=8)
    bms, bby = bound_ms(flops, nbytes)
    rows.append(dict(
        name="decode", route="cuda", source="ffpa_attn_tpu_torch/csrc/decode.cu",
        replaces="ffpa_attn_tpu/ops/decode.py:52", launches=launches["decode"],
        max_abs_err=errs["decode"], ms=kms[0], plain_ms=pms[0], bound_ms=bms,
        bound_by=bby, library_ms=lms[0],
    ))
    events["decode"] = (kms[1], pms[1], lms[1])
    log("times (device ms per call from torch.profiler; CUDA-event ms per call in brackets):")
    for r in rows:
        ev = events[r["name"]]
        log(f"  {r['name']:<10} kernel_ms {r['ms']:.4f} [{ev[0]:.4f}] bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_by']}) plain_ms {r['plain_ms']:.4f} [{ev[1]:.4f}] "
            f"library_ms {r['library_ms']:.4f} [{ev[2]:.4f}] launches {r['launches']}")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    import ffpa_attn_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions stay fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = phase_environment()
    phase_build()
    errs = phase_kernels_vs_plain()
    main_path = phase_main_path()
    rows = phase_times(errs, main_path)
    log(f"summary: prefill_ms {main_path['prefill_ms']:.3f} decode_tokens_per_s "
        f"{main_path['decode_tok_s']:.2f} generate_ms {main_path['generate_ms']:.1f} "
        f"total {time.perf_counter() - t_start:.1f} s on {smi}")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
