"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It imports only ``ffpa_attn_tpu_torch``, torch and numpy, and runs, in order:

1. environment: torch / CUDA / nvcc versions and the card's name and power
   limit;
2. build: every kernel of the serving and training paths from
   ``ffpa_attn_tpu_torch/csrc`` (one nvcc per source, all started together);
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, at the serving and training shapes and at feature cases, with
   stated tolerances: the forward on both of its routes (one wgmma block
   at D, Dv <= 512, a cluster of two splitting D and Dv above: D640 and
   D1024 over bias, ALiBi, softcap, windows, dropout, fp16, GQA, a ragged
   edge and D != Dv) and its S residual, a causal D1024 backward through
   the S-resident tier (``ffpa_attn_func`` + ``.backward``), a windowed
   D1024 backward through the recompute tier (its forward, dK/dV and dQ
   launches all on cluster routes), decode on both instances of its TMA
   block (one consumer warpgroup at D, Dv <= 512, two splitting Dv above:
   one valid column, the serving step's gap, 32 packed rows, D != Dv, the
   speculative verify block at Nq 5 with its per-row bias; D640, D1024,
   D1024 / Dv320, D576 at 33 packed rows, fp16 and a split masked
   throughout on the second; and its score residual at D512 and D1024),
   dkdv (both routes: one wgmma block at D, Dv <= 512, a cluster of two
   splitting D and Dv above: D640, D1024, fp16, D != Dv down to a rank
   without a box of one dim, bias + ALiBi + dropout, and a dS handoff cut
   into three KV stripes), dq (both routes: one wgmma block at D, Dv <=
   512, a cluster of two splitting D and Dv above: D576, D640, D1024, a
   window, softcap with a bias, D != Dv, fp16, fp32 dQ storage), banded
   dQ, the from-S dK/dV pass in both
   variants and banded dK (a slab NaN outside the band among them), the
   packed varlen forward, the varlen dK/dV and dQ kernels (bf16 and fp16
   feature cases, both routes of each) and paged decode (bf16, fp16 and
   int8 pools on its one TMA block: pages of 8..256 rows and of 17, 20 and
   24, 64 packed rows, windows, lengths on tile edges; D640 and D1024 on
   its two-warpgroup instance); a row
   that a bias masks everywhere under a window, for the forward and for
   decode, is logged against the mean of V over the columns each side
   visits (the plain version every column, the kernels the window's
   tiles), not held;
4. serving path: greedy ``generate`` of the L4 dm1024 H8/4 Dh512 vocab-32000
   bf16 model (random weights from numpy seed 0) on a 4096-token prompt, 32
   tokens, with the kernel launch counts read around that run; first-step
   logits against the same weights run with the fp32 oracle's attention; a
   tiny model's logits on the card at each of the CPU's 8 greedy steps,
   teacher-forced with the CPU's tokens, within 2e-2 of max|logit|, with
   the same argmax wherever the CPU's top two are more than twice that
   apart; then continuous
   batching, the JAX package's serving bench (B4, prompts of 589..886
   tokens, 128 generated, page 256): ``serve_batch``, ``serve_batch_paged``
   over bf16 and int8 pools and a ``ServingEngine`` serving 8 requests over
   4 slots, each with its launch counts, tokens/s and logit gates; the
   same model at Dh1024 (depth cut to L2): ``generate`` (the 4096-token
   prompt, 32 tokens) and ``serve_batch`` (the serving workload), their
   decode launches on the two-warpgroup decode block, the first-step
   logits and every teacher-forced ``serve_batch`` step against the fp32
   oracle's attention; then its paged serving over pages of 256 bf16 and
   int8 rows and of 24 rows, each step teacher-forced against the dense
   step; the monkey-patch: ``scaled_dot_product_attention`` patched at the prefill
   shape (one forward launch, bit-equal to ``ffpa_attn_func``), a D64, a
   dropout and a causal Nq 1024 / Nkv 4096 call on the stock function (no
   launch, equal to the pristine function), then unpatched; speculative
   decoding, the bench's ``bench_speculative`` (``cli/_e2e.py``: prompt
   1024, 128 tokens, k_spec 4), self-spec and a one-layer draft, each with
   its launch counts, accept rate and tokens/s, the stream and every verify
   block held to the target teacher-forced, plain ``generate`` beside them;
5. training path: ``make_train_step`` (AdamW 1e-4) of the same model at
   N8192 B1, one warm-up step and 3 timed steps with the launch counts of
   each, in the dS-handoff tier (the model's default), with
   ``attn_save_scores=True`` (the S-resident tier) and under a 768 MiB S
   budget (partial residency, 4 of 8 heads); each first step's loss and
   gradients against the same weights with the fp32 oracle's attention
   under autograd; the op-level headline backward (``ffpa_attn_func``
   causal B1 H32 N8192 D512, auto residency) held in head slices and timed
   against the handoff; a GQA decode call's gradients; the windowed model
   (``mistral_like``, depth cut to L2), which takes the recompute backward;
   a tiny model's two steps on the card against the CPU; a checkpoint of
   the tiny model saved, restored into a fresh model and stepped on both,
   bit-equal; packed training at
   op level: ``ffpa_attn_varlen_func`` under autograd over 8 documents
   packed into 8192 tokens (H8/4 D512 causal, bf16 and fp16; then the
   gpt_oss_like window and sinks), 1 varlen-forward, 1 varlen-dK/dV and 1
   varlen-dQ launch per call (the backward on the forward's saved tile
   schedule), its gradients against the plain chain and the per-segment
   dense path, and its forward + backward times; then one bf16 call at
   D1024, all three launches on their clusters and one 64 x 64 walk
   built;
6. times: device time by kernel and the device's busy share over one
   prefill, decode steps, one packed prefill, paged decode steps, one
   training step of each tier and one packed forward + backward, then each
   kernel at its main-path shape beside its bound, its plain version and
   one PyTorch library call computing the same function, or for the from-S
   pass the yardstick of its two dense products (device time per call from
   torch.profiler, CUDA-event time beside it); the forward's time a launch
   at the training shape from the handoff step's profile, and timed alone
   there without and with the S residual beside its bound and SDPA; the
   forward's, the dK/dV route's, the dQ route's, decode's, paged decode's
   and the varlen kernels' plans held equal to their mirrors, their
   registers and spill bytes, and ptxas's log of flash_fwd.cu,
   flash_bwd.cu, decode.cu, paged_decode.cu, varlen_fwd.cu and
   varlen_bwd.cu free of wgmma serialization notes; the packed call's
   device and CUDA-event ms; the three varlen clusters timed at D1024;
   decode's walk and merge timed apart beside the wrapper's total, at the
   generate step and at the serving step, at D512 and at D1024 (the
   two-warpgroup instance); paged decode's likewise, over
   bf16 and int8 pools, over pages of 24 rows and at D1024; each backward
   kernel's, decode's and paged decode's device ms logged beside its
   CUDA-event ms and its bound, and timed again once where it reads below
   the bound (the phase fails if it stays below);
   banded dQ, banded dK and dK/dV also at the op-level shape (H32 MHA)
   with their TFLOP/s; the dK/dV cluster route at B1 H8 N8192 D1024
   causal fp16 and the dQ cluster route at B1 H8/4 N8192 D1024 causal
   bf16 beside their bounds, their plain versions and the autograd of
   SDPA;
7. bench CLI: the windowed paged leg (window 256, page 128) in process,
   its paged steps teacher-forced against the dense steps and the paged
   kernel timed with and without the window; MHA decode on the decode
   kernel beside the fp32 composite; then, each in a subprocess, ``python
   -m ffpa_attn_tpu_torch.bench`` over its ten cases, fwd and bwd, at H8
   N4096 (cut from H32 N8192 for run time), every row gated with the
   port's launches and the SDPA backend torch took; the headline line
   (``cli._headline``, B1 H32 N8192 D512 bf16); the ``serve_paged_window``
   and ``speculative`` legs of ``--e2e``;
8. autotune (``phase_autotune``): in a temporary tuned-config directory,
   the search of one backward task (B1 H8/4 N4096 D512 causal bf16), one
   packed task and two decode tasks (D512 and D1024 at Nkv 4224, the
   rule's split count alone), every reading logged, the plan's between
   the others'; tuned and untuned calls held to each other and to the
   plain versions; the picks equal to the stored entries, and an entry of
   other head dims not taken; every backward kernel at each ring cap
   bit-equal to the plan's and timed; one ``python -m
   ffpa_attn_tpu_torch.autotune --isolate-tasks`` task read back;
   ``verify`` on one backward case; the lookup's host µs;
9. the ``kernels`` line, the backward rows with their ms at each ring
   cap.

Every phase raises on failure; the script exits 0 only when all passed. The
last three lines are the ``kernels`` JSON line, the nvidia-smi line and the
``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch

# Output tolerances (tests/test_features.py:127, tests/test_ffpa_bwd.py:19),
# held per row: see row_rel.
BF16_TOL, F16_TOL = 2e-2, 1e-2
LSE_TOL = 1e-4  # relative to max|lse|: fp32 math on identical inputs
# Gradient tolerances (tests/test_ffpa_bwd.py:19), per row for kernel vs
# plain (grad_row_rel) and per leaf of the model's gradients.
GRAD_TOL = {torch.bfloat16: 5e-2, torch.float16: 1e-2}
# banded dQ over an e4m3 slab against its plain version on the same slab,
# per row (floored): identical inputs, so the summation order alone
# differs.
FP8_READER_TOL = 2e-2
# Losses, relative, set from readings on an H100: the first step's loss
# against the oracle attention's read 2.34e-6 at N8192, the tiny model's
# two losses on the card against the CPU 1.35e-5. With random weights the
# loss is near ln(vocab) whatever attention computes, so the gradients
# (GRAD_TOL, per leaf) are the check that tests the backward.
LOSS_TOL = 1e-4

SLICE = dict(vocab_size=32000, d_model=1024, n_layers=4, n_heads=8, n_kv_heads=4,
             head_dim=512, max_seq_len=4224, dtype="bfloat16")
PROMPT, STEPS, MAX_LEN = 4096, 32, 4224
# Training: the JAX package's bench_train (ffpa_attn_tpu/cli/_e2e.py:27-44)
# at full width and depth, N8192 B1; the windowed model at depth L2.
TRAIN = dict(SLICE, max_seq_len=8192)
TRAIN_N, TRAIN_STEPS = 8192, 3
# The op-level main path: the repo's headline backward (bench.py: causal
# B1 H32 N8192 D512 bf16, MHA); the partial-residency budget (768 MiB).
OP_HEADS, PARTIAL_LIMIT = 32, 805306368
WINDOW, WINDOW_LAYERS, WINDOW_STEPS = 4096, 2, 2
# Continuous batching: the JAX package's serving bench (cli/_e2e.py:96-213)
# at its defaults, B4, prompt lengths 1024 - rng.integers(0, 512) from
# numpy seed 0, 128 generated tokens, max_len 1152, page 256; the engine
# serves 8 more requests from the same rng over 4 slots.
SERVE_B, SERVE_PROMPT, SERVE_GEN, SERVE_PAGE = 4, 1024, 128, 256
SERVE_MAX_LEN = SERVE_PROMPT + SERVE_GEN
SERVE_LENS = [589, 698, 763, 886]
# Packed training: the bench_train token budget (N8192) packed as 8
# documents; the forward's 64 x 64 schedule walks 1.49x its band's pairs
# (tools/torch_varlen_schedule.py), so segment edges straddle tiles.
PACK_LENS = [2048, 1536, 1200, 1024, 900, 700, 500, 284]
ENGINE_REQUESTS, ENGINE_SLOTS = 8, 4
# The Dh1024 paged leg: the serving model at head dim 1024 (dm1024 H8/4
# Dh1024 vocab 32000 bf16), depth cut to L2 for run time, on the serving
# workload above over pools of 256 bf16 rows, 256 int8 rows and 24 bf16 rows
# a page (the two-warpgroup paged block; boxes of 64 and 8 rows).
WIDE = dict(SLICE, head_dim=1024, n_layers=2)
WIDE_POOLS = (("page256", 256, False), ("page256_int8", 256, True), ("page24", 24, False))
# Speculative decoding: the bench's bench_speculative workload
# (ffpa_attn_tpu_torch/cli/_e2e.py, held equal in phase_speculative), prompt
# 1024 from numpy seed 0, 128 generated, k_spec 4, max_len prompt + gen +
# k_spec + 2; self-spec and a draft of the target's first layer.
SPEC_PROMPT, SPEC_GEN, SPEC_K, SPEC_DRAFT_LAYERS = 1024, 128, 4, 1
SPEC_MAX_LEN = SPEC_PROMPT + SPEC_GEN + SPEC_K + 2
PAGED_TOL, INT8_TOL = 5e-2, 6e-2  # tests/test_models.py:262, tests/test_paged.py:361
# The bench CLI (ffpa_attn_tpu_torch/cli/_bench.py): its ten cases, cut from
# H32 N8192 to H8 N4096 for run time; the windowed paged serving leg
# (cli/_e2e.py bench_serve_paged_window) at its defaults: window 256, page
# 128, the serving workload above.
BENCH_H, BENCH_N, SERVE_WINDOW, WINDOW_PAGE = 8, 4096, 256, 128
# Head-dim pairs at which the forward's and the dK/dV launcher's plans are
# held equal to their mirrors (tests/test_torch_fwd_plan.py, both routes of
# each: D, Dv 64..1024, D != Dv, a rank without a box of one dim).
PLAN_PAIRS = [(x, x) for x in range(64, 1025, 64)] + [
    (128, 512), (512, 128), (320, 512), (448, 64), (512, 64), (512, 1024), (1024, 320),
    (64, 1024), (1024, 64), (400, 400), (100, 200), (320, 1024), (640, 1024)]


def capped_plans_equal(name: str, read, mirror, stages: int, least: int) -> int:
    """Fail unless the launcher's plan at one ring cap below the plan's
    depth (``read(cap)``) equals its mirror's (``mirror(cap)``), where the
    walk takes that cap (``least``, ``ops/config.py``); returns the pairs
    held (0 or 1)."""
    cap = stages - 1
    if cap < least:
        return 0
    got, want = read(cap), mirror(cap)
    if got != want or got.stages != cap:
        fail(f"{name} plan at ring cap {cap}: the launcher's {got} differs from ops/config.py's "
             f"{want}")
    return 1


@contextlib.contextmanager
def _env(key: str, value: str):
    """``os.environ[key] = value`` inside the block, the old state after."""
    before = os.environ.get(key)
    os.environ[key] = value
    try:
        yield
    finally:
        if before is None:
            del os.environ[key]
        else:
            os.environ[key] = before


FP8_FLAG = "FFPA_TORCH_ALLOW_FP8_DS"


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


def grad_row_rel(got, want, floor: float = 1e-3) -> float:
    """row_rel for gradients: each row's error over the larger of its own
    max|want| and ``floor`` times the tensor's. A gradient row can be zero
    by cancellation (causal row 0 sees one key, so dP equals delta and dS
    is 0 up to fp32 rounding on both sides); without the floor its rounding
    noise would be divided by ~0."""
    g, w = got.float(), want.float()
    err, ref = (g - w).abs().amax(-1), w.abs().amax(-1)
    ref = torch.maximum(ref, floor * w.abs().max())
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


def _masked_row(label: str, o, po, v, spans: dict) -> dict:
    """A row masked everywhere (o, po [B, Hq, Dv] of the kernel and the
    plain version; v [B, Hkv, Nkv, Dv]): every score of it is MASK_VALUE,
    so its softmax is uniform over the columns a pass visits. The plain
    version visits all (the mean of V over every column); a kernel that
    walks only the window's tiles gives the mean over those. Logs the
    kernel's per-row error against the plain version and against the mean
    over each column span of ``spans`` (name -> [lo, hi)) and returns them;
    the outcome is recorded, not held (ROADMAP.md, deliberate numerics
    differences)."""
    group = o.shape[1] // v.shape[1]
    errs = {"plain": row_rel(o, po)}
    for span, (lo, hi) in spans.items():
        mean = v[:, :, lo:hi].float().mean(dim=2).repeat_interleave(group, dim=1)
        errs[span] = row_rel(o, mean)
    closest = min(errs, key=errs.get)
    log(f"    {label}: masked everywhere, finite {bool(torch.isfinite(o).all())}; kernel's row "
        f"against the mean of V over " + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
        + f" (closest: {closest})")
    return errs


def _fwd_case(name, *, b=1, hq=8, hkv=4, nq, nkv, d=512, dv=None, dtype=torch.bfloat16,
              causal=True, bias=False, softcap=0.0, window=(-1, -1), alibi=False, dropout=0.0,
              masked_row=None, seed=0):
    """The forward kernel against its plain version per row. ``masked_row``:
    a bias of MASK_VALUE over every column of that row (0 elsewhere), whose
    outcome is logged (``_masked_row``) and every other row held."""
    from ffpa_attn_tpu_torch.ops import flash_fwd
    from ffpa_attn_tpu_torch.ops.reference import DEFAULT_MASK_VALUE

    dv = d if dv is None else dv
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = _randn((b, hq, nq, d), dtype, gen)
    k = _randn((b, hkv, nkv, d), dtype, gen)
    v = _randn((b, hkv, nkv, dv), dtype, gen)
    kw = dict(scale=1.0 / math.sqrt(d), is_causal=causal, softcap=softcap, window=window,
              dropout_p=dropout, dropout_seed=seed)
    bias_t = _randn((b, 1, nq, nkv), torch.float32, gen) if bias else None
    if masked_row is not None:
        bias_t = torch.zeros((b, 1, nq, nkv), device="cuda")
        bias_t[..., masked_row, :] = DEFAULT_MASK_VALUE
    if alibi:
        kw["alibi_slopes"] = torch.rand((b, hq), generator=gen, device="cuda") * 0.1
    o, lse = flash_fwd.flash_attention_forward(q, k, v, bias_t, **kw)
    torch.cuda.synchronize()
    po, plse = flash_fwd.flash_attention_forward_plain(q, k, v, bias_t, **kw)
    rows = torch.ones(nq, dtype=torch.bool, device="cuda")
    if masked_row is not None:
        rows[masked_row] = False
    tol = F16_TOL if dtype == torch.float16 else BF16_TOL
    err, lerr = row_rel(o[:, :, rows], po[:, :, rows]), rel(lse[:, :, rows], plse[:, :, rows])
    ok = err < tol and lerr < LSE_TOL and bool(torch.isfinite(o).all())
    log(f"  fwd {name:<24} {flash_fwd.fwd_kernel_plan(d, dv).route:<13} row_rel_err {err:.2e} (tol {tol:g}) "
        f"rel_err {rel(o[:, :, rows], po[:, :, rows]):.2e} "
        f"lse_rel_err {lerr:.2e} (tol {LSE_TOL:g}) max_abs_err {max_abs(o, po):.3e} "
        f"{'ok' if ok else 'FAIL'}"
        + (f" (rows but {masked_row})" if masked_row is not None else ""))
    if not ok:
        fail(f"forward kernel disagrees with its plain version: {name}")
    if masked_row is not None:
        # The row's own window, and the 64-column tiles the band of its
        # 64-row block touches (the wgmma route's walk).
        off, wl = nkv - nq, window[0]
        wr = 0 if causal else window[1]
        r0 = masked_row // 64 * 64
        lo = max(0, masked_row + off - wl) if wl >= 0 else 0
        hi = min(nkv, masked_row + off + wr + 1) if wr >= 0 else nkv
        t_lo = max(0, r0 + off - wl) // 64 * 64 if wl >= 0 else 0
        t_hi = min(nkv, (r0 + 63 + off + wr) // 64 * 64 + 64) if wr >= 0 else nkv
        _masked_row(f"fwd {name} row {masked_row}", o[:, :, masked_row], po[:, :, masked_row],
                    v, {"the row's window": (lo, hi), "its block's band tiles": (t_lo, t_hi)})
    return max_abs(o, po)


def _serve_gap_bias(nkv: int, lens, t: int):
    """The serving step's shared-row validity bias [B, 1, 1, Nkv] at step
    ``t`` (``models/serving.py`` ``shared_row_bias``, base the longest
    prompt), on the card."""
    from ffpa_attn_tpu_torch.models.serving import shared_row_bias

    return shared_row_bias(torch.tensor(lens, device="cuda"), t, max(lens), nkv)


def _decode_case(name, *, b=1, hkv=4, group=2, nq=1, nkv=MAX_LEN, d=512, dv=None,
                 dtype=torch.bfloat16, valid=PROMPT + 1, bias=None, causal=False, softcap=0.0,
                 window=(-1, -1), masked_batch=None, seed=0):
    """The decode kernel against its plain version per row.
    ``masked_batch``: a bias of MASK_VALUE over every column of that batch
    element's rows (0 elsewhere), whose outcome is logged (``_masked_row``)
    and every other row held."""
    from ffpa_attn_tpu_torch.ops import decode
    from ffpa_attn_tpu_torch.ops.config import decode_plan
    from ffpa_attn_tpu_torch.ops.reference import DEFAULT_MASK_VALUE

    dv = d if dv is None else dv
    gen = torch.Generator(device="cuda").manual_seed(seed)
    hq = hkv * group
    q = _randn((b, hq, nq, d), dtype, gen)
    k = _randn((b, hkv, nkv, d), dtype, gen)
    v = _randn((b, hkv, nkv, dv), dtype, gen)
    if masked_batch is not None:
        bias = torch.zeros((b, 1, 1, nkv), device="cuda")
        bias[masked_batch] = DEFAULT_MASK_VALUE
    elif bias is None and valid is not None:
        cols = torch.arange(nkv, device="cuda")
        bias = torch.where(cols < valid, 0.0, DEFAULT_MASK_VALUE).float()[None, None, None]
    kw = dict(scale=1.0 / math.sqrt(d), is_causal=causal, softcap=softcap, window=window)
    o, lse = decode._decode_forward(q, k, v, bias, **kw)
    torch.cuda.synchronize()
    qp = q.reshape(b, hkv, group * nq, d)
    pbias = bias
    if bias is not None and (bias.shape[1] != 1 or (bias.shape[2] != 1 and group > 1)):
        # A head- or row-varying bias packed like Q, as the wrapper packs it.
        pbias = bias.expand(bias.shape[0], hq, nq, nkv).reshape(bias.shape[0], hkv, group * nq,
                                                                 nkv)
    po, plse = decode._decode_plain(qp, k, v, pbias, nq=nq, scale=kw["scale"], is_causal=causal,
                                    softcap=softcap, window_left=window[0],
                                    window_right=window[1])
    po, plse = po.reshape(o.shape), plse.reshape(lse.shape)
    held = torch.ones(b, dtype=torch.bool, device="cuda")
    if masked_batch is not None:
        held[masked_batch] = False
    tol = F16_TOL if dtype == torch.float16 else BF16_TOL
    err, lerr = row_rel(o[held], po[held]), rel(lse[held], plse[held])
    ok = err < tol and lerr < LSE_TOL and bool(torch.isfinite(o).all())
    wgs = f"{decode_plan(d, dv, group * nq).consumers} wg"
    log(f"  decode {name:<19} {wgs:<4} row_rel_err {err:.2e} (tol {tol:g}) rel_err "
        f"{rel(o[held], po[held]):.2e} "
        f"lse_rel_err {lerr:.2e} (tol {LSE_TOL:g}) max_abs_err {max_abs(o, po):.3e} "
        f"{'ok' if ok else 'FAIL'}"
        + (f" (batch elements but {masked_batch})" if masked_batch is not None else ""))
    if not ok:
        fail(f"decode kernel disagrees with its plain version: {name}")
    if masked_batch is not None:
        # The last query row's window (causal, tail-aligned), and the
        # 64-row tiles that window touches (the TMA route's band).
        wl = window[0]
        lo = max(0, nkv - 1 - wl) if wl >= 0 else 0
        _masked_row(f"decode {name} batch {masked_batch}", o[masked_batch, :, -1][None],
                    po[masked_batch, :, -1][None], v[masked_batch][None],
                    {"the window": (lo, nkv), "its 64-row tiles": (lo // 64 * 64, nkv)})
    return max_abs(o, po)


def _bwd_case(name, *, b=1, hq=8, hkv=4, nq, nkv, d=512, dv=None, dtype=torch.bfloat16,
              causal=True, bias=None, softcap=0.0, window=(-1, -1), alibi=False, dropout=0.0,
              grad_q=None, seed=0):
    """The three backward kernels against their plain versions on the same
    inputs: dkdv without and with the dS slab, dq (with dbias for a bias;
    stored in ``grad_q``'s type, "f32" or the input type) and, under
    causal, banded dQ from the kernel's slab. (o, lse) come from the
    forward kernel."""
    from ffpa_attn_tpu_torch.ops import flash_bwd, flash_fwd
    from ffpa_attn_tpu_torch.ops.config import (
        DKDV_Q_TILE, DKDV_SLAB_COLS, cdiv, dkdv_plan, dq_plan,
    )
    from ffpa_attn_tpu_torch.ops.dispatch import pick_backward_config

    dv = d if dv is None else dv
    gen = torch.Generator(device="cuda").manual_seed(100 + seed)
    q = _randn((b, hq, nq, d), dtype, gen)
    k = _randn((b, hkv, nkv, d), dtype, gen)
    v = _randn((b, hkv, nkv, dv), dtype, gen)
    do = _randn((b, hq, nq, dv), dtype, gen)
    bias_t = None
    if bias == "full":
        bias_t = _randn((b, 1, nq, nkv), torch.float32, gen)
    elif bias == "key":
        bias_t = _randn((1, 1, 1, nkv), torch.float32, gen)
    al = torch.rand((b, hq), generator=gen, device="cuda") * 0.1 if alibi else None
    scale = 1.0 / math.sqrt(d)
    o, lse = flash_fwd.flash_attention_forward(
        q, k, v, bias_t, scale=scale, is_causal=causal, dropout_p=dropout, dropout_seed=seed,
        softcap=softcap, window=window, alibi_slopes=al)
    delta = (do.float() * o.float()).sum(-1)
    cfg = pick_backward_config(d=d, dv=dv, nq=nq, nkv=nkv, dtype=dtype)
    plain_kw = dict(is_causal=causal, causal_offset=nkv - nq, dropout_p=dropout, seed=seed,
                    softcap=softcap, window=window, alibi=al)
    kern_kw = dict(scale=scale, is_causal=causal, causal_offset=nkv - nq, dropout_p=dropout,
                   group=hq // hkv, softcap=softcap, window=window, alibi=al)
    tol = GRAD_TOL[dtype]
    errs = {}
    for emit in (False, True):
        kdk, kdv, kds = flash_bwd._dkdv_launch(q, k, v, bias_t, do, lse, delta, seed, cfg,
                                               grad_kv_storage_dtype=None, emit_ds=emit,
                                               **kern_kw)
        torch.cuda.synchronize()
        pdk, pdv, pds = flash_bwd._dkdv_plain(
            q, k, v, bias_t, do, lse, delta, scale=scale, emit_ds=emit,
            nq_pad=cdiv(nq, DKDV_Q_TILE) * DKDV_Q_TILE,
            nkv_pad=cdiv(nkv, DKDV_SLAB_COLS) * DKDV_SLAB_COLS, **plain_kw)
        errs[f"dk{int(emit)}"], errs[f"dv{int(emit)}"] = grad_row_rel(kdk, pdk), grad_row_rel(kdv, pdv)
        del pdk, pdv
        if emit:
            errs["ds"] = grad_row_rel(kds, pds)
            del pds
    if causal:
        kbq = flash_bwd._banded_dq_from_ds(kds, k, cfg, scale=scale, group=hq // hkv, nq=nq,
                                           nkv=nkv, causal_offset=nkv - nq, dq_dtype=dtype)
        torch.cuda.synchronize()
        pbq = flash_bwd._banded_dq_plain(kds, k, scale=scale, nq=nq, nkv=nkv)
        errs["banded_dq"] = grad_row_rel(kbq, pbq)
        del pbq
    del kds
    kdq, kdb = flash_bwd._dq_launch(q, k, v, bias_t, do, lse, delta, seed, cfg,
                                    grad_q_storage_dtype=grad_q, **kern_kw)
    torch.cuda.synchronize()
    pdq, pdb = flash_bwd._dq_plain(q, k, v, bias_t, do, lse, delta, scale=scale,
                                   emit_dbias=bias_t is not None, **plain_kw)
    errs["dq"] = grad_row_rel(kdq, pdq)
    if bias_t is not None:
        errs["dbias"] = rel(kdb, flash_bwd._dbias_from_ds(pdb, bias_t))
    want_dt = torch.float32 if grad_q == "f32" else dtype
    ok = (all(e < tol for e in errs.values()) and bool(torch.isfinite(kdq).all())
          and kdq.dtype == want_dt)
    log(f"  bwd {name:<22} dkdv route {dkdv_plan(d, dv).route}, dq route "
        f"{dq_plan(d, dv).route} ({kdq.dtype}) "
        + " ".join(f"{n} {e:.2e}" for n, e in errs.items())
        + f" (tol {tol:g}, per row) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"backward kernels disagree with their plain versions: {name}")


def _striped_bwd_case(name, *, b=1, hq=8, hkv=4, n, d, dtype=torch.bfloat16, dropout=0.0,
                      stripes=3, seed=0):
    """The causal dS-handoff backward through ``flash_attention_backward``
    with a slab limit of 1 / ``stripes`` of the slab, so it is cut into
    that many KV stripes: one dkdv launch a stripe at its row / column
    offsets (dropout replayed on global ids), banded dQ summed over them;
    dQ, dK and dV against the plain versions over the whole call."""
    import os

    from ffpa_attn_tpu_torch.ops import flash_bwd, flash_fwd
    from ffpa_attn_tpu_torch.ops.config import DKDV_Q_TILE, DKDV_SLAB_COLS, cdiv

    gen = torch.Generator(device="cuda").manual_seed(100 + seed)
    q, do = _randn((b, hq, n, d), dtype, gen), _randn((b, hq, n, d), dtype, gen)
    k, v = _randn((b, hkv, n, d), dtype, gen), _randn((b, hkv, n, d), dtype, gen)
    scale = 1.0 / math.sqrt(d)
    kw = dict(scale=scale, is_causal=True, dropout_p=dropout, dropout_seed=seed)
    o, lse = flash_fwd.flash_attention_forward(q, k, v, None, **kw)
    slab = (b * hq * cdiv(n, DKDV_Q_TILE) * DKDV_Q_TILE * cdiv(n, DKDV_SLAB_COLS)
            * DKDV_SLAB_COLS * q.element_size())
    key, launches = "FFPA_TORCH_DS_HANDOFF_LIMIT_BYTES", flash_bwd._dkdv_launch.launches
    before = os.environ.get(key)
    os.environ[key] = str(cdiv(slab, stripes))
    try:
        dq, dk, dv, _ = flash_bwd.flash_attention_backward(q, k, v, None, o, lse, do,
                                                           ds_handoff=True, **kw)
        torch.cuda.synchronize()
    finally:
        if before is None:
            del os.environ[key]
        else:
            os.environ[key] = before
    launched = flash_bwd._dkdv_launch.launches - launches
    delta = (do.float() * o.float()).sum(-1)
    plain_kw = dict(is_causal=True, causal_offset=0, dropout_p=dropout, seed=seed, softcap=0.0,
                    window=(-1, -1), alibi=None)
    pdk, pdv, _ = flash_bwd._dkdv_plain(q, k, v, None, do, lse, delta, scale=scale,
                                        emit_ds=False, nq_pad=n, nkv_pad=n, **plain_kw)
    pdq, _ = flash_bwd._dq_plain(q, k, v, None, do, lse, delta, scale=scale, emit_dbias=False,
                                 **plain_kw)
    errs = {"dq": grad_row_rel(dq, pdq), "dk": grad_row_rel(dk, pdk), "dv": grad_row_rel(dv, pdv)}
    tol = GRAD_TOL[dtype]
    ok = launched == stripes and all(e < tol for e in errs.values())
    log(f"  bwd {name:<22} {launched} dkdv launches (stripes) "
        + " ".join(f"{nm} {e:.2e}" for nm, e in errs.items())
        + f" (tol {tol:g}, per row) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"the striped dS handoff disagrees with the plain versions: {name}")


def _fp8_ds_case(name, *, b=1, hq=8, hkv=4, nq, nkv, d=512, causal=True, softcap=0.0,
                 dropout=0.0, seed=0) -> None:
    """The e4m3 dS slab (``ds_store_bits = 8``, bf16): the dK/dV kernel's
    e4m3 writer against the same kernel's 16-bit-slab launch (dK and dV
    bit-equal: both take the 16-bit dS) and against the plain version's
    slab (within one e4m3 step on every element: the two fp32 dS differ in
    summation order only); under causal, banded dQ's e4m3 reader over the
    kernel's own slab against the plain version on that slab, per row at
    2e-2."""
    from ffpa_attn_tpu_torch.ops import flash_bwd, flash_fwd
    from ffpa_attn_tpu_torch.ops.config import BlockConfig, dkdv_plan

    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(300 + seed)
    q, do = _randn((b, hq, nq, d), bf, gen), _randn((b, hq, nq, d), bf, gen)
    k, v = _randn((b, hkv, nkv, d), bf, gen), _randn((b, hkv, nkv, d), bf, gen)
    scale = 1.0 / math.sqrt(d)
    o, lse = flash_fwd.flash_attention_forward(q, k, v, None, scale=scale, is_causal=causal,
                                               dropout_p=dropout, dropout_seed=seed,
                                               softcap=softcap)
    delta = (do.float() * o.float()).sum(-1)
    del o
    kern_kw = dict(scale=scale, is_causal=causal, causal_offset=nkv - nq, dropout_p=dropout,
                   group=hq // hkv, softcap=softcap)
    args = (q, k, v, None, do, lse, delta, seed)
    dk16, dv16, _ = flash_bwd._dkdv_launch(*args, BlockConfig(), grad_kv_storage_dtype=None,
                                           emit_ds=True, **kern_kw)
    dk8, dv8, ds8 = flash_bwd._dkdv_launch(*args, BlockConfig(ds_store_bits=8),
                                           grad_kv_storage_dtype=None, emit_ds=True, **kern_kw)
    torch.cuda.synchronize()
    equal = bool(torch.equal(dk8, dk16) and torch.equal(dv8, dv16))
    del dk16, dv16, dk8, dv8
    _, _, pds = flash_bwd._dkdv_plain(
        q, k, v, None, do, lse, delta, scale=scale, emit_ds=True, nq_pad=ds8.shape[2],
        nkv_pad=ds8.shape[3], ds_fp8=True, is_causal=causal, causal_offset=nkv - nq,
        dropout_p=dropout, seed=seed, softcap=softcap, window=(-1, -1), alibi=None)
    steps = flash_bwd.e4m3_steps(ds8, pds)
    max_steps, off = int(steps.max()), int((steps > 0).sum())
    del pds, steps
    errs = {}
    if causal:
        kbq = flash_bwd._banded_dq_from_ds(ds8, k, None, scale=scale, group=hq // hkv, nq=nq,
                                           nkv=nkv, causal_offset=nkv - nq, dq_dtype=bf)
        torch.cuda.synchronize()
        pbq = flash_bwd._banded_dq_plain(ds8, k, scale=scale, nq=nq, nkv=nkv)
        errs["banded_dq"] = grad_row_rel(kbq, pbq)
        del kbq, pbq
    ok = (equal and max_steps <= 1 and ds8.dtype == torch.float8_e4m3fn
          and all(e < FP8_READER_TOL for e in errs.values()))
    log(f"  fp8 dS {name:<24} dkdv route {dkdv_plan(d, d).route}: dK, dV "
        f"{'bit-equal' if equal else 'DIFFER'} to the 16-bit-slab launch; slab within "
        f"{max_steps} e4m3 step(s) of the plain version's ({off} of {ds8.numel()} elements "
        f"one step off)" + "".join(f"; {n} {e:.2e} (tol {FP8_READER_TOL:g}, per row)"
                                   for n, e in errs.items()) + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"the e4m3 dS kernels disagree with the 16-bit launch or their plain versions: "
             f"{name}")


def _band(nq, nkv, causal, device="cuda"):
    """[nq, nkv] bool: the (row, col) pairs a tail-aligned causal (or full)
    call attends."""
    rows = torch.arange(nq, device=device)[:, None]
    cols = torch.arange(nkv, device=device)[None, :]
    return cols <= rows + nkv - nq if causal else torch.ones((nq, nkv), dtype=torch.bool,
                                                              device=device)


def _fwd_scores_case(name, *, b=1, hq=8, hkv=4, nq, nkv, d=512, causal=True, bias=False,
                     softcap=0.0, alibi=False, seed=0):
    """The forward's S residual against the plain S on the band (per row,
    within 1e-2 of the row's max|S|), and (o, lse) bit-equal to the same
    call without it."""
    from ffpa_attn_tpu_torch.ops import flash_fwd

    gen = torch.Generator(device="cuda").manual_seed(200 + seed)
    bf = torch.bfloat16
    q, k, v = _randn((b, hq, nq, d), bf, gen), _randn((b, hkv, nkv, d), bf, gen), _randn(
        (b, hkv, nkv, d), bf, gen)
    kw = dict(scale=1.0 / math.sqrt(d), is_causal=causal, softcap=softcap)
    bias_t = _randn((b, 1, nq, nkv), torch.float32, gen) if bias else None
    if alibi:
        kw["alibi_slopes"] = torch.rand((b, hq), generator=gen, device="cuda") * 0.1
    o, lse = flash_fwd.flash_attention_forward(q, k, v, bias_t, **kw)
    o2, lse2, s = flash_fwd.flash_attention_forward(q, k, v, bias_t, return_scores=True, **kw)
    torch.cuda.synchronize()
    ps = flash_fwd.scores_plain(q, k, bias_t, nq_pad=s.shape[2], nkv_pad=s.shape[3], **kw)
    band = _band(nq, nkv, causal)
    got, want = s[:, :, :nq, :nkv].float(), ps[:, :, :nq, :nkv].float()
    err = torch.where(band, (got - want).abs(), 0.0).amax(-1)
    ref = torch.where(band, want.abs(), 0.0).amax(-1).clamp_min(1e-30)
    serr = float((err / ref).max())
    same = torch.equal(o, o2) and torch.equal(lse, lse2)
    ok = serr < 1e-2 and same and bool(torch.isfinite(torch.where(band, got, 0.0)).all())
    log(f"  fwd S {name:<20} S row_rel_err {serr:.2e} (tol 0.01, on the band) slab "
        f"{tuple(s.shape)} (o, lse) unchanged {same} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"forward S residual disagrees with its plain version: {name}")
    return max_abs(torch.where(band, got, 0.0), torch.where(band, want, 0.0))


def _s_resident_bwd_case(name, *, b=1, h=8, n, d, seed=0) -> dict:
    """``ffpa_attn_func(..., is_causal=True)`` and ``.backward`` through the
    S-resident tier (``save_scores=True``) at head dim ``d``: its launches
    (the counts set to 0 just before, read just after, and returned), the
    from-S route the launch took, then the gradients per row against the
    plain backward chain fed the forward kernel's (o, lse, S) and, as whole
    tensors, against the fp32 oracle's autograd."""
    from ffpa_attn_tpu_torch import CudaBackend, ffpa_attn_func
    from ffpa_attn_tpu_torch.ops import flash_bwd, flash_fwd
    from ffpa_attn_tpu_torch.ops.config import from_s_plan
    from ffpa_attn_tpu_torch.ops.dispatch import pick_backward_config
    from ffpa_attn_tpu_torch.ops.reference import reference_attention

    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(400 + seed)
    q, k, v, do = (_randn((b, h, n, d), bf, gen) for _ in range(4))
    scale = d ** -0.5
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    launch_counts(zero=True)
    o = ffpa_attn_func(*leaves, is_causal=True, backward_backend=CudaBackend(save_scores=True))
    o.backward(do)
    torch.cuda.synchronize()
    counts = {n_: c for n_, c in _counts(TRAIN_KERNELS).items() if c}
    cfg = flash_bwd._fit_blocks_to_scores(pick_backward_config(d=d, dv=d, nq=n, nkv=n, dtype=bf),
                                          n, n, d, d, bf)
    route = from_s_plan(d, cfg.dkdv_dk_in_kernel).route
    want = {"flash_fwd": 1, "dkdv_from_s": 1, "banded_dq": 1}
    if not cfg.dkdv_dk_in_kernel:
        want["banded_dk"] = 1
    po, plse, ps = flash_fwd.flash_attention_forward(q, k, v, None, scale=scale, is_causal=True,
                                                     return_scores=True)
    pdk, pdv, pds = flash_bwd._dkdv_from_s_plain(
        q, v, ps, do, plse, (do.float() * po.float()).sum(-1), scale=scale, is_causal=True,
        causal_offset=0, dropout_p=0.0, seed=0, softcap=0.0, dk_in_kernel=cfg.dkdv_dk_in_kernel)
    if pdk is None:
        pdk = flash_bwd._banded_dk_plain(pds, q, scale=scale, nq=n, nkv=n, hkv=h)
    pdq = flash_bwd._banded_dq_plain(pds, k, scale=scale, nq=n, nkv=n)
    sl = [t.float().requires_grad_() for t in (q, k, v)]
    oracle = torch.autograd.grad(reference_attention(*sl, is_causal=True), sl, do.float())
    errs = {}
    for nm, g, w, wo in zip(("dq", "dk", "dv"), (t.grad for t in leaves), (pdq, pdk, pdv),
                            oracle):
        errs[f"{nm}_plain"] = grad_row_rel(g, w)
        errs[f"{nm}_oracle"] = rel(g, wo)
    tol = GRAD_TOL[bf]
    ok = counts == want and all(e < tol for e in errs.values()) and all(
        bool(torch.isfinite(t.grad).all()) for t in leaves)
    log(f"  S-resident bwd {name:<13} ffpa_attn_func B{b} H{h} N{n} D{d} causal, forward route "
        f"{flash_fwd.fwd_kernel_plan(d, d).route}, from-S route {route}, launches {counts}: "
        + " ".join(f"{nm} {e:.2e}" for nm, e in errs.items())
        + f" (tol {tol:g}; per row vs plain, whole vs oracle) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"S-resident backward at D{d}: launches {counts} (want {want}) or gradients off")
    if d > 512 and route != "wgmma_cluster":
        fail(f"the S-resident backward at D{d} took the from-S route {route}, not the cluster")
    return counts


def _recompute_bwd_case(name, *, b=1, hq=8, hkv=4, n, d, window, seed=0) -> dict:
    """``ffpa_attn_func(..., is_causal=True, window_size=window)`` and
    ``.backward`` (a window takes the recompute tier) at head dim ``d``: its
    launches (the counts set to 0 just before, read just after, and
    returned; one forward, one dK/dV, one dQ), the routes they took (the
    clusters above D512), the gradients per row against the plain backward
    chain fed the forward kernel's (o, lse), and the call's device ms."""
    from ffpa_attn_tpu_torch import CudaBackend, ffpa_attn_func
    from ffpa_attn_tpu_torch.ops import flash_bwd, flash_fwd
    from ffpa_attn_tpu_torch.ops.config import dkdv_plan, dq_plan, fwd_plan

    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(450 + seed)
    q, do = _randn((b, hq, n, d), bf, gen), _randn((b, hq, n, d), bf, gen)
    k, v = _randn((b, hkv, n, d), bf, gen), _randn((b, hkv, n, d), bf, gen)
    scale = d ** -0.5
    backend = CudaBackend(ds_handoff=False, save_scores=False)

    def fwd_bwd():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        ffpa_attn_func(*leaves, is_causal=True, window_size=window, enable_gqa=True,
                       backward_backend=backend).backward(do)
        return leaves

    launch_counts(zero=True)
    leaves = fwd_bwd()
    torch.cuda.synchronize()
    counts = {n_: c for n_, c in _counts(TRAIN_KERNELS).items() if c}
    want = {"flash_fwd": 1, "dkdv": 1, "dq": 1}
    routes = {"flash_fwd": fwd_plan(d, d).route, "dkdv": dkdv_plan(d, d).route,
              "dq": dq_plan(d, d).route}
    o, lse = flash_fwd.flash_attention_forward(q, k, v, None, scale=scale, is_causal=True,
                                               window=window)
    delta = (do.float() * o.float()).sum(-1)
    plain_kw = dict(scale=scale, is_causal=True, causal_offset=0, dropout_p=0.0, seed=0,
                    softcap=0.0, window=window, alibi=None)
    pdk, pdv, _ = flash_bwd._dkdv_plain(q, k, v, None, do, lse, delta, emit_ds=False, nq_pad=n,
                                        nkv_pad=n, **plain_kw)
    pdq, _ = flash_bwd._dq_plain(q, k, v, None, do, lse, delta, emit_dbias=False, **plain_kw)
    errs = {nm: grad_row_rel(g.grad, w) for nm, g, w in zip(("dq", "dk", "dv"), leaves,
                                                             (pdq, pdk, pdv))}
    del o, lse, delta, pdk, pdv, pdq
    tol = GRAD_TOL[bf]
    ok = (counts == want and all(e < tol for e in errs.values())
          and all(bool(torch.isfinite(t.grad).all()) for t in leaves)
          and (d <= 512 or set(routes.values()) == {"wgmma_cluster"}))
    del leaves
    torch.cuda.empty_cache()
    # Device ms from CUDA events with the host's enqueue off the clock, not
    # the profiler: a profiler window this early in the process made the
    # later phases' windows lose device events (their readings fell to
    # 0.4-0.7x their CUDA-event times).
    from ffpa_attn_tpu_torch.utils.profiling import cuda_ms, queued_ms

    dev_ms = queued_ms(lambda: [fwd_bwd() for _ in range(3)]) / 3
    ev_ms = cuda_ms(fwd_bwd, reps=3, warmup=1)
    log(f"  recompute bwd {name:<16} ffpa_attn_func B{b} H{hq}/{hkv} N{n} D{d} causal window "
        f"{window}, routes {routes}, launches {counts}: "
        + " ".join(f"{nm} {e:.2e}" for nm, e in errs.items())
        + f" (tol {tol:g}, per row vs plain); forward + backward device {dev_ms:.4f} ms, CUDA "
        f"events {ev_ms:.4f} ms {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"recompute backward at D{d}: launches {counts} (want {want}), routes {routes} or "
             "gradients off")
    return counts


def _from_s_case(name, *, b=1, hq=8, hkv=4, nq, nkv, d=512, dv=None, causal=True, bias=None,
                 softcap=0.0, dropout=0.0, sinks=False, nan_fill=False, banded_out=None,
                 seed=0):
    """The from-S dK/dV kernel in each variant it takes at head dims (d,
    dv) (dv defaults to d; dK out of the kernel runs the wgmma block at Dv
    <= 512 and its cluster above), banded dK (causal) and banded dQ from
    its slab, against their plain versions on the same inputs. The S
    residual comes from the forward kernel; with ``nan_fill`` everything
    of the slab outside the band (the tiles the forward never writes,
    padding) is NaN before the backward reads it; ``banded_out`` is the
    dtype banded dK and banded dQ write (fp32: the kernels' out_f32
    stores)."""
    from ffpa_attn_tpu_torch.ops import flash_bwd, flash_fwd
    from ffpa_attn_tpu_torch.ops.attention import apply_sinks
    from ffpa_attn_tpu_torch.ops.config import from_s_fits, from_s_plan
    from ffpa_attn_tpu_torch.ops.dispatch import pick_backward_config

    dv = dv or d
    gen = torch.Generator(device="cuda").manual_seed(300 + seed)
    bf = torch.bfloat16
    q, k, v = _randn((b, hq, nq, d), bf, gen), _randn((b, hkv, nkv, d), bf, gen), _randn(
        (b, hkv, nkv, dv), bf, gen)
    do = _randn((b, hq, nq, dv), bf, gen)
    bias_t = _randn((b, 1, nq, nkv), torch.float32, gen) if bias == "full" else None
    scale, group = 1.0 / math.sqrt(d), hq // hkv
    o, lse, s = flash_fwd.flash_attention_forward(
        q, k, v, bias_t, scale=scale, is_causal=causal, softcap=softcap, dropout_p=dropout,
        dropout_seed=seed, return_scores=True)
    if sinks:
        o, lse = apply_sinks(o, lse, torch.randn(hq, generator=gen, device="cuda"))
    if nan_fill:
        rows = torch.arange(s.shape[2], device="cuda")[:, None]
        cols = torch.arange(s.shape[3], device="cuda")[None, :]
        band = (rows < nq) & (cols < nkv)
        if causal:
            band &= cols <= rows + nkv - nq
        s.masked_fill_(~band, float("nan"))
    delta = (do.float() * o.float()).sum(-1)
    cfg = pick_backward_config(d=d, dv=dv, nq=nq, nkv=nkv, dtype=bf)
    kw = dict(scale=scale, is_causal=causal, causal_offset=nkv - nq, dropout_p=dropout,
              softcap=softcap)
    tol = GRAD_TOL[bf]
    errs, slab, routes = {}, None, []
    for dk_in in (True, False):
        if dk_in and not from_s_fits(d, dv, True):
            continue
        routes.append(from_s_plan(dv, dk_in).route)
        c = "in" if dk_in else "out"
        ks = s.clone()
        kdk, kdv, kds = flash_bwd._dkdv_from_s_launch(
            q, v, ks, do, lse, delta, seed, replace(cfg, dkdv_dk_in_kernel=dk_in), group=group,
            grad_kv_storage_dtype=None, **kw)
        torch.cuda.synchronize()
        pdk, pdv, pds = flash_bwd._dkdv_from_s_plain(q, v, s, do, lse, delta, seed=seed,
                                                     dk_in_kernel=dk_in, **kw)
        errs[f"dv_{c}"] = grad_row_rel(kdv, pdv)
        errs[f"ds_{c}"] = grad_row_rel(kds, pds)
        if dk_in:
            errs["dk_in"] = grad_row_rel(kdk, pdk)
        if not bool(torch.isfinite(kds).all()):
            fail(f"from-S dS slab not finite: {name} ({c})")
        slab = kds
        if bias_t is not None:
            pdb = flash_bwd._dbias_from_ds(pds[:, :, :nq, :nkv], bias_t)
        del pdk, pdv, pds
    kwd = dict(scale=scale, group=group, nq=nq, nkv=nkv)
    if causal:
        out = banded_out or bf
        kdk = flash_bwd._banded_dk_from_ds(slab, q, cfg, causal_offset=nkv - nq, dk_dtype=out,
                                           **kwd)
        torch.cuda.synchronize()
        errs["banded_dk"] = grad_row_rel(kdk, flash_bwd._banded_dk_plain(
            slab, q, scale=scale, nq=nq, nkv=nkv, hkv=hkv))
        kdq = flash_bwd._banded_dq_from_ds(slab, k, cfg, causal_offset=nkv - nq, dq_dtype=out,
                                           **kwd)
        torch.cuda.synchronize()
        if kdk.dtype != out or kdq.dtype != out:
            fail(f"banded kernels wrote {kdk.dtype} / {kdq.dtype}, asked for {out}: {name}")
        errs["banded_dq"] = grad_row_rel(kdq, flash_bwd._banded_dq_plain(slab, k, scale=scale,
                                                                           nq=nq, nkv=nkv))
    if bias_t is not None:
        errs["dbias"] = rel(flash_bwd._dbias_from_ds(slab[:, :, :nq, :nkv], bias_t), pdb)
    ok = all(e < tol for e in errs.values())
    log(f"  from-S {name:<19} {'/'.join(routes)} slab {tuple(s.shape)} " + " ".join(
        f"{n} {e:.2e}" for n, e in errs.items()) + f" (tol {tol:g}, per row) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"S-resident kernels disagree with their plain versions: {name}")


def _decode_scores_case(name, *, hkv=4, group=2, nq=1, nkv=MAX_LEN, d=512, valid=PROMPT + 1,
                        causal=False, softcap=0.0, seed=0):
    """The decode kernel's fp32 score residual against the plain one on the
    band, per row within 1e-2 of its max|S|, and (o, lse) unchanged."""
    from ffpa_attn_tpu_torch.ops import decode
    from ffpa_attn_tpu_torch.ops.reference import DEFAULT_MASK_VALUE

    gen = torch.Generator(device="cuda").manual_seed(400 + seed)
    bf = torch.bfloat16
    q = _randn((1, hkv * group, nq, d), bf, gen)
    k, v = _randn((1, hkv, nkv, d), bf, gen), _randn((1, hkv, nkv, d), bf, gen)
    cols = torch.arange(nkv, device="cuda")
    bias = None if valid is None else torch.where(cols < valid, 0.0, DEFAULT_MASK_VALUE).float()[
        None, None, None]
    kw = dict(scale=1.0 / math.sqrt(d), is_causal=causal, softcap=softcap)
    o, lse = decode._decode_forward(q, k, v, bias, **kw)
    o2, lse2, s = decode._decode_forward(q, k, v, bias, return_scores=True, **kw)
    torch.cuda.synchronize()
    _, _, ps = decode._decode_plain(q.reshape(1, hkv, group * nq, d), k, v, bias, nq=nq,
                                    window_left=-1, window_right=-1, return_scores=True, **kw)
    keep = ps[..., :nkv] > DEFAULT_MASK_VALUE / 2  # the attended columns
    got, want = s[..., :nkv], ps[..., :nkv]
    err = torch.where(keep, (got - want).abs(), 0.0).amax(-1)
    ref = torch.where(keep, want.abs(), 0.0).amax(-1).clamp_min(1e-30)
    serr = float((err / ref).max())
    same = torch.equal(o, o2) and torch.equal(lse, lse2)
    ok = serr < 1e-2 and same and bool((got[~keep] <= DEFAULT_MASK_VALUE / 2).all())
    log(f"  decode S {name:<17} S row_rel_err {serr:.2e} (tol 0.01, attended columns) "
        f"residual {tuple(s.shape)} {s.numel() * 4} B (o, lse) unchanged {same} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"decode score residual disagrees with its plain version: {name}")


def _varlen_inputs(seqs, *, seqs_k=None, hq=8, hkv=4, d=512, dv=None, dtype=torch.bfloat16,
                   pad=0, gen=None):
    """Packed q [Tq, Hq, D], k [Tk, Hkv, D], v [Tk, Hkv, Dv] (Dv = D unless
    given) and int32 cu_seqlens on the card; ``pad`` tokens of tail padding
    on both sides (the pseudo-segment)."""
    seqs_k = seqs_k or seqs
    tq, tk = sum(seqs) + pad, sum(seqs_k) + pad
    q = _randn((tq, hq, d), dtype, gen)
    k, v = _randn((tk, hkv, d), dtype, gen), _randn((tk, hkv, dv or d), dtype, gen)
    cu_q = torch.tensor(np.cumsum([0] + list(seqs)), dtype=torch.int32, device="cuda")
    cu_k = torch.tensor(np.cumsum([0] + list(seqs_k)), dtype=torch.int32, device="cuda")
    return q, k, v, cu_q, cu_k


def _varlen_case(name, *, seqs, seqs_k=None, hq=8, hkv=4, d=512, dv=None, dtype=torch.bfloat16,
                 causal=True, window=(-1, -1), softcap=0.0, alibi=False, pad=0, seed=0):
    """The varlen forward kernel against its plain version on the same
    inputs and metadata: o per row, lse relative on the rows that attend
    something, and a row that attends nothing at exactly the plain
    version's MASK_VALUE + log(1e-38)."""
    from ffpa_attn_tpu_torch.ops import varlen
    from ffpa_attn_tpu_torch.ops.reference import DEFAULT_MASK_VALUE

    gen = torch.Generator(device="cuda").manual_seed(500 + seed)
    q, k, v, cu_q, cu_k = _varlen_inputs(seqs, seqs_k=seqs_k, hq=hq, hkv=hkv, d=d, dv=dv,
                                         dtype=dtype, pad=pad, gen=gen)
    al = torch.rand((hq,), generator=gen, device="cuda") * 0.1 if alibi else None
    kw = dict(scale=1.0 / math.sqrt(d), causal=causal, softcap=softcap, window=window, alibi=al)
    o, lse = varlen._varlen_forward(q, k, v, cu_q, cu_k, **kw)
    torch.cuda.synchronize()
    meta = varlen._segment_metadata(cu_q, cu_k, q.shape[0], k.shape[0], q.shape[0], k.shape[0])
    po, plse = varlen._varlen_forward_plain(
        q, k, v, meta, **dict(kw, window=(window[0], -1 if causal else window[1])))
    tol = F16_TOL if dtype == torch.float16 else BF16_TOL
    live = plse > DEFAULT_MASK_VALUE / 2
    err = row_rel(o, po)
    lerr = rel(lse[live], plse[live])
    same_empty = bool((lse[~live] == plse[~live]).all())
    ok = err < tol and lerr < LSE_TOL and same_empty and bool(torch.isfinite(o).all())
    log(f"  varlen {name:<19} T{q.shape[0]} row_rel_err {err:.2e} (tol {tol:g}) lse_rel_err "
        f"{lerr:.2e} (tol {LSE_TOL:g}, {int((~live).sum())} empty rows) max_abs_err "
        f"{max_abs(o, po):.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"varlen forward kernel disagrees with its plain version: {name}")
    return max_abs(o, po)


def _varlen_bwd_case(name, *, seqs, seqs_k=None, hq=8, hkv=4, d=512, dv=None,
                     dtype=torch.bfloat16, causal=True, window=(-1, -1), softcap=0.0, alibi=False,
                     sinks=False, pad=0, seed=0):
    """The varlen dK/dV and dQ kernels (one ``_varlen_backward`` call)
    against their plain versions on the same inputs: (o, lse) from the
    forward kernel, sink-inclusive with ``sinks``; dq, dk, dv per row."""
    from ffpa_attn_tpu_torch.ops import varlen

    gen = torch.Generator(device="cuda").manual_seed(700 + seed)
    q, k, v, cu_q, cu_k = _varlen_inputs(seqs, seqs_k=seqs_k, hq=hq, hkv=hkv, d=d, dv=dv,
                                         dtype=dtype, pad=pad, gen=gen)
    do = _randn(q.shape[:2] + v.shape[2:], dtype, gen)
    al = torch.rand((hq,), generator=gen, device="cuda") * 0.1 if alibi else None
    kw = dict(scale=1.0 / math.sqrt(d), causal=causal, softcap=softcap, window=window)
    meta = varlen._call_metadata(cu_q, cu_k, q.shape[0], k.shape[0], "cuda")
    o, lse = varlen._varlen_forward(q, k, v, cu_q, cu_k, alibi=al, meta=meta, **kw)
    if sinks:
        o, lse = varlen._varlen_apply_sinks(o, lse, torch.randn(hq, generator=gen, device="cuda"))
    got = varlen._varlen_backward(q, k, v, o, lse, do, meta, alibi=al, **kw)
    torch.cuda.synchronize()
    want = varlen._varlen_backward_plain(q, k, v, o, lse, do, meta, alibi=al, **kw)
    tol = GRAD_TOL[dtype]
    errs = {n: grad_row_rel(g, w) for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    ok = all(e < tol for e in errs.values()) and all(bool(torch.isfinite(g).all()) for g in got)
    log(f"  varlen bwd {name:<26} T{q.shape[0]}/{k.shape[0]} "
        + " ".join(f"{n} {e:.2e}" for n, e in errs.items())
        + f" (tol {tol:g}, per row) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"varlen backward kernels disagree with their plain versions: {name}")
    return max(max_abs(g, w) for g, w in zip(got, want))


def _paged_pools(lens, *, page, max_len, hkv=4, d=512, dtype=torch.bfloat16, quantized=False,
                 shuffle=False, gen=None):
    """A PagedKVCache on the card holding random K/V for sequences of
    ``lens`` tokens; with ``shuffle`` every table row is a random run of
    pool pages (not contiguous, not in order)."""
    from ffpa_attn_tpu_torch.ops import paged

    b = len(lens)
    cache = paged.PagedKVCache.alloc(b, max_len, hkv, d, page_size=page, dtype=dtype,
                                     quantized=quantized)
    if shuffle:
        mp = cache.page_table.shape[1]
        perm = 1 + torch.randperm(b * mp, generator=torch.Generator().manual_seed(len(lens)))
        for slot in range(b):
            paged.assign_sequence(cache, slot, perm[slot * mp:(slot + 1) * mp].tolist())
    n = max(max(lens), 1)
    kd, vd = _randn((b, hkv, n, d), dtype, gen), _randn((b, hkv, n, d), dtype, gen)
    return paged.fill_from_prefill(cache, kd, vd, list(lens))


def _paged_case(name, *, lens, page=256, max_len=1152, group=2, nq=1, hkv=4, d=512,
                dtype=torch.bfloat16, quantized=False, window=-1, softcap=0.0, idle=False,
                shuffle=False, seed=0):
    """The paged decode kernel against its plain version on the same pools
    (an int8 pool against the plain version of the same int8 pool); with
    ``idle`` slot 0 is an idle engine slot (null table row, lens at
    max_len), whose output must be finite. Logs the plan's box rows and
    consumer warpgroups; fails unless the call launched the kernel once."""
    from ffpa_attn_tpu_torch.ops import paged
    from ffpa_attn_tpu_torch.ops.config import paged_plan

    gen = torch.Generator(device="cuda").manual_seed(600 + seed)
    cache = _paged_pools(lens, page=page, max_len=max_len, hkv=hkv, d=d, dtype=dtype,
                         quantized=quantized, shuffle=shuffle, gen=gen)
    if idle:
        paged.assign_sequence(cache, 0, [])
        cache.lens[0] = max_len
    q = _randn((len(lens), hkv * group, nq, d), dtype, gen)
    kw = dict(nq=nq, scale=1.0 / math.sqrt(d), softcap=softcap, window_left=window)
    plan = paged_plan(d, d, page, quantized)
    before = paged.paged_decode_attention.launches
    o = paged.paged_decode_attention(q, cache, scale=kw["scale"], softcap=softcap,
                                     window_left=window)
    torch.cuda.synchronize()
    if paged.paged_decode_attention.launches != before + 1:
        fail(f"paged decode case {name} did not launch the kernel once")
    po, _ = paged._paged_decode_plain(q.reshape(len(lens), hkv, group * nq, d), cache, **kw)
    po = po.reshape(o.shape)
    tol = F16_TOL if dtype == torch.float16 else BF16_TOL
    err = row_rel(o, po)
    ok = err < tol and bool(torch.isfinite(o).all())
    log(f"  paged {name:<24} D{d} lens {list(lens)} page {page} (boxes of {plan.box_rows} rows, "
        f"{plan.consumers} consumer warpgroup{'s' if plan.consumers > 1 else ''}) row_rel_err "
        f"{err:.2e} (tol {tol:g}) max_abs_err {max_abs(o, po):.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"paged decode kernel disagrees with its plain version: {name}")
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
    _fwd_case("dropout", nq=1024, nkv=1024, dropout=0.1, seed=10)
    _fwd_case("d448", nq=1024, nkv=1024, d=448, seed=14)  # O split 256 + 192, odd K stage
    _fwd_case("d384", nq=1024, nkv=1024, d=384, seed=15)
    _fwd_case("gqa_group1", hq=8, hkv=8, nq=1024, nkv=1024, seed=16)
    _fwd_case("nq40_nkv1100", nq=40, nkv=1100, seed=17)  # a part-filled tile, ragged KV edge
    # D != Dv: K and V stream different box counts; at Dv 64 consumer 1 owns no O columns.
    _fwd_case("d512_dv128", nq=1024, nkv=1100, d=512, dv=128, seed=18)
    _fwd_case("d128_dv512", nq=1024, nkv=1100, d=128, dv=512, seed=19)
    _fwd_case("d512_dv64", nq=1024, nkv=1100, d=512, dv=64, seed=20)
    _fwd_case("d512_dv64_fp16_bias", nq=1000, nkv=1100, d=512, dv=64, dtype=torch.float16,
              bias=True, seed=21)
    _fwd_case(f"train_N{TRAIN_N}", nq=TRAIN_N, nkv=TRAIN_N, seed=22)  # the training shape
    _fwd_case("window_masked_row", nq=1024, nkv=1024, window=(256, -1), masked_row=700, seed=23)
    # D or Dv above 512: the cluster of two blocks, each rank holding half of
    # D's boxes and half of Dv's (rank 1 with 2 of D320's 5 D boxes, with 2
    # of Dv320's 5 Dv boxes).
    for hd in (640, 1024):
        _fwd_case(f"d{hd}_bias_alibi_softcap", nq=1024, nkv=1100, d=hd, causal=False, bias=True,
                  alibi=True, softcap=30.0, seed=hd + 1)
        _fwd_case(f"d{hd}_window", nq=1024, nkv=1024, d=hd, window=(256, -1), seed=hd + 2)
        _fwd_case(f"d{hd}_dropout", nq=1024, nkv=1024, d=hd, dropout=0.1, seed=hd + 3)
        _fwd_case(f"d{hd}_fp16", nq=1024, nkv=1024, d=hd, dtype=torch.float16, seed=hd + 4)
        _fwd_case(f"d{hd}_gqa_group1", hq=8, hkv=8, nq=1024, nkv=1024, d=hd, seed=hd + 5)
        _fwd_case(f"d{hd}_nq40_nkv1100", nq=40, nkv=1100, d=hd, seed=hd + 6)
    _fwd_case("d1024_dv320", nq=1024, nkv=1100, d=1024, dv=320, seed=1031)
    _fwd_case("d320_dv1024", nq=1024, nkv=1100, d=320, dv=1024, seed=1032)
    errs["decode"] = _decode_case("slice_Nkv4224_g2")
    _decode_case("group1", group=1, seed=1)
    _decode_case("group4", group=4, seed=2)
    _decode_case("softcap", softcap=30.0, seed=3)
    _decode_case("window", window=(1024, -1), causal=True, valid=None, seed=4)
    _decode_case("nq4_causal", nq=4, causal=True, valid=None, seed=5)
    _decode_case("fp16", dtype=torch.float16, seed=6)
    _decode_case("batch2", b=2, nkv=1024, valid=900, seed=7)
    _decode_case("valid1", valid=1, seed=8)  # every split but the first masked throughout
    _decode_case("serve_b4_gap", b=SERVE_B, nkv=SERVE_MAX_LEN,
                 bias=_serve_gap_bias(SERVE_MAX_LEN, SERVE_LENS, 64), seed=9)
    _decode_case("rows32", group=4, nq=8, causal=True, valid=None, seed=10)  # two row blocks
    _decode_case("d512_dv320", dv=320, seed=11)
    # Above D512, the two-warpgroup instance: Dh1024's steps, D != Dv (the
    # second warpgroup holds 2 of Dv320's 5 boxes), 33 packed rows (three
    # row blocks), a split masked throughout, fp16, softcap with a window.
    _decode_case("d640_split", d=640, nkv=1000, valid=900, seed=12)
    errs["decode_wide"] = _decode_case("d1024_Nkv4224_g2", d=1024, seed=15)
    _decode_case("d1024_serve_b4_gap", b=SERVE_B, nkv=SERVE_MAX_LEN, d=1024,
                 bias=_serve_gap_bias(SERVE_MAX_LEN, SERVE_LENS, 64), seed=16)
    _decode_case("d1024_dv320", d=1024, dv=320, nkv=1000, valid=900, seed=17)
    _decode_case("d576_rows33", group=11, nq=3, d=576, nkv=1000, causal=True, valid=None,
                 seed=18)
    _decode_case("d1024_valid1", d=1024, valid=1, seed=19)  # every split but the first masked
    _decode_case("d1024_fp16", d=1024, dtype=torch.float16, seed=20)
    _decode_case("d1024_softcap_window", d=1024, softcap=30.0, window=(1024, -1), causal=True,
                 valid=None, seed=21)
    # A row masked everywhere under a window (the bias masks every column
    # of batch element 1): the plain version gives the mean of V over every
    # column, the kernels walk only the window's tiles; logged, not held.
    _decode_case("window_masked_row", b=2, nkv=1024, window=(256, -1), causal=True, valid=None,
                 masked_batch=1, seed=13)
    # The speculative verify block: Nq = k_spec + 1 = 5 (10 packed rows) under
    # its per-row validity bias at pos 1100 (models/generate.py decode_block).
    from ffpa_attn_tpu_torch.models.generate import validity_bias

    _decode_case("spec_verify_nq5", nq=SPEC_K + 1, nkv=SPEC_MAX_LEN,
                 bias=validity_bias(1100, SPEC_K + 1, SPEC_MAX_LEN, device="cuda"), seed=14)
    # The backward at N4096 and feature cases at N1024; the training
    # shapes (N8192) are held in training_times, beside their times.
    _bwd_case("slice_N4096_D512", nq=PROMPT, nkv=PROMPT)
    _bwd_case("bias_full", nq=1024, nkv=1024, causal=False, bias="full", seed=1)
    _bwd_case("bias_key", nq=1024, nkv=1024, bias="key", seed=2)
    _bwd_case("softcap", nq=1024, nkv=1024, softcap=30.0, seed=3)
    _bwd_case("window", nq=1024, nkv=1024, window=(256, -1), seed=4)
    _bwd_case("alibi", nq=1024, nkv=1024, alibi=True, seed=5)
    _bwd_case("dropout", nq=1024, nkv=1024, dropout=0.1, seed=6)
    _bwd_case("nkv1100", nq=1024, nkv=1100, seed=7)
    _bwd_case("d320", nq=1024, nkv=1024, d=320, seed=8)
    _bwd_case("d448", nq=1024, nkv=1024, d=448, seed=12)  # dK/dV passes of 256 + 192
    _bwd_case("gqa_group1", hq=8, hkv=8, nq=1024, nkv=1024, seed=13)
    _bwd_case("d1024_cluster", nq=1024, nkv=1024, d=1024, seed=9)  # the dK/dV cluster route
    _bwd_case("fp16", nq=1024, nkv=1024, dtype=torch.float16, seed=10)
    _bwd_case("batch2_bias_alibi", b=2, nq=1024, nkv=1100, bias="full", alibi=True, seed=11)
    # D != Dv on the wgmma routes: K, V and Q, dO stream different box
    # counts; at D 64 dq's consumer 1 owns no dQ columns. fp16 with a bias,
    # and dQ stored in fp32.
    _bwd_case("d512_dv128", nq=1024, nkv=1100, d=512, dv=128, seed=14)
    _bwd_case("d128_dv512", nq=1024, nkv=1100, d=128, dv=512, seed=15)
    _bwd_case("d512_dv64", nq=1000, nkv=1100, d=512, dv=64, seed=16)
    _bwd_case("d64_dv512", nq=1000, nkv=1100, d=64, dv=512, seed=17)
    _bwd_case("d512_dv64_fp16_bias", nq=1000, nkv=1100, d=512, dv=64, dtype=torch.float16,
              bias="full", seed=18)
    _bwd_case("dq_f32_window_dropout", nq=1024, nkv=1024, window=(256, -1), dropout=0.1,
              grad_q="f32", seed=19)
    # D or Dv above 512: the dK/dV cluster of two blocks, each rank holding
    # half of D's and of Dv's boxes (at D64 / Dv1024 rank 1 holds no D box,
    # at D1024 / Dv64 no Dv box); fp16, a feature case, and the dS handoff
    # cut into KV stripes, each a launch at its row / column offsets.
    _bwd_case("d640_cluster", nq=1024, nkv=1024, d=640, seed=30)
    _bwd_case("d1024_fp16", nq=1024, nkv=1024, d=1024, dtype=torch.float16, seed=31)
    _bwd_case("d512_dv1024", nq=1000, nkv=1100, d=512, dv=1024, seed=32)
    _bwd_case("d1024_dv320", nq=1000, nkv=1100, d=1024, dv=320, seed=33)
    _bwd_case("d64_dv1024", nq=1000, nkv=1100, d=64, dv=1024, seed=34)
    _bwd_case("d1024_dv64", nq=1000, nkv=1100, d=1024, dv=64, seed=35)
    _bwd_case("d1024_bias_alibi_dropout", nq=1024, nkv=1100, d=1024, causal=False, bias="full",
              alibi=True, dropout=0.1, seed=36)
    # The dQ cluster's own cases: a window (the windowed model's band), an
    # odd box count (rank 0 five D boxes, rank 1 four) and softcap with a
    # bias (the recompute tier's other takers).
    _bwd_case("d1024_window", nq=1024, nkv=1024, d=1024, window=(256, -1), seed=38)
    _bwd_case("d576", nq=1000, nkv=1100, d=576, seed=39)
    _bwd_case("d1024_softcap_bias", nq=1024, nkv=1024, d=1024, softcap=30.0, bias="full",
              seed=40)
    _striped_bwd_case("d1024_striped_dropout", n=1024, d=1024, dropout=0.1, seed=37)
    # The e4m3 dS slab (ds_store_bits 8): the writer on both routes at the
    # training shape and on the cluster, the reader on the writer's slab;
    # and feature cases (a ragged edge, softcap with dropout, no causal).
    _fp8_ds_case(f"train_N{TRAIN_N}", nq=TRAIN_N, nkv=TRAIN_N)
    _fp8_ds_case("cluster_N4096_D1024", nq=PROMPT, nkv=PROMPT, d=1024, seed=1)
    _fp8_ds_case("ragged_nq1000_nkv1100", nq=1000, nkv=1100, seed=2)
    _fp8_ds_case("softcap_dropout", nq=1024, nkv=1024, softcap=30.0, dropout=0.1, seed=3)
    _fp8_ds_case("noncausal_d640_cluster", nq=1000, nkv=1100, d=640, causal=False, seed=4)
    # The S-resident tier: the forward's S residual, the from-S dK/dV kernel
    # in both variants, banded dK and banded dQ from its slab; the training
    # shape (N8192) is held in s_resident_times, beside its times.
    _fwd_scores_case("slice_N4096", nq=PROMPT, nkv=PROMPT)
    _fwd_scores_case("bias", nq=1024, nkv=1024, causal=False, bias=True, seed=1)
    _fwd_scores_case("softcap", nq=1024, nkv=1024, softcap=30.0, seed=2)
    _fwd_scores_case("alibi", nq=1024, nkv=1024, alibi=True, seed=3)
    _fwd_scores_case("nq1000_nkv1100", nq=1000, nkv=1100, seed=4)
    _fwd_scores_case("nq20_rows_pad32", nq=20, nkv=300, seed=5)
    _fwd_scores_case("d320", nq=1024, nkv=1024, d=320, seed=6)
    _fwd_scores_case("d1024", nq=1024, nkv=1024, d=1024, seed=7)
    _fwd_scores_case("nq24_rows_pad32", nq=24, nkv=1100, seed=8)  # a 32-row slab, 64-row tile
    _fwd_scores_case("alibi_bias_nkv1100", nq=1000, nkv=1100, alibi=True, bias=True, seed=9)
    _fwd_scores_case(f"train_N{TRAIN_N}", nq=TRAIN_N, nkv=TRAIN_N, seed=10)
    # The cluster route's S residual: each rank stores half of a block's rows.
    _fwd_scores_case("d1024_alibi_bias_nkv1100", nq=1000, nkv=1100, d=1024, alibi=True,
                     bias=True, seed=11)
    _fwd_scores_case("d640_softcap", nq=1024, nkv=1024, d=640, softcap=30.0, seed=12)
    _fwd_scores_case("d1024_nq20_rows_pad32", nq=20, nkv=300, d=1024, seed=13)
    # The from-S cluster's path: an S-resident backward above D512 through
    # the entry point, one from-S launch on the cluster route each.
    errs["from_s_cluster_launches"] = sum(
        _s_resident_bwd_case(nm, n=1024, d=dh)["dkdv_from_s"]
        for nm, dh in (("d1024_causal", 1024), ("d640_causal", 640)))
    # The dQ cluster's path: a windowed backward above D512 through the
    # entry point, the recompute tier.
    errs["dq_cluster_launches"] = _recompute_bwd_case("d1024_window1024", n=4096, d=1024,
                                                      window=(1024, -1))["dq"]
    _from_s_case("gqa_N1024", nq=1024, nkv=1024)
    _from_s_case("bias_full_noncausal", nq=1024, nkv=1024, causal=False, bias="full", seed=1)
    _from_s_case("dropout", nq=1024, nkv=1024, dropout=0.1, seed=2)
    _from_s_case("softcap", nq=1024, nkv=1024, softcap=30.0, seed=3)
    _from_s_case("sinks", nq=1024, nkv=1024, sinks=True, seed=4)
    _from_s_case("nq1000_nkv1100", nq=1000, nkv=1100, seed=5)
    _from_s_case("nq20_rows_pad32", nq=20, nkv=300, seed=6)
    _from_s_case("d320", nq=1024, nkv=1024, d=320, seed=7)
    # The cluster route (dK out of the kernel, Dv > 512): odd box counts
    # (rank 0 five boxes, rank 1 four at Dv 576), D != Dv, the features it
    # replays, a NaN-filled slab, and many Q tiles a block (a race between
    # rank 0's dS stores and rank 1's read of an S tile shows in dV's upper
    # columns).
    _from_s_case("d1024_cluster", nq=1024, nkv=1024, d=1024, seed=8)
    _from_s_case("dv576_odd_boxes", nq=1000, nkv=1100, d=576, seed=13)
    _from_s_case("d640", nq=1024, nkv=1024, d=640, seed=14)
    _from_s_case("d64_dv1024", nq=1024, nkv=1024, d=64, dv=1024, seed=15)
    _from_s_case("d512_dv1024_noncausal", nq=1024, nkv=1100, d=512, dv=1024, causal=False,
                 seed=16)
    _from_s_case("d1024_dropout_group4", hq=8, hkv=2, nq=1024, nkv=1024, d=1024, dropout=0.1,
                 seed=17)
    _from_s_case("d1024_softcap", nq=1024, nkv=1024, d=1024, softcap=30.0, seed=18)
    _from_s_case("d640_nan_filled_slab", nq=1000, nkv=1100, d=640, nan_fill=True, seed=19)
    _from_s_case("d1024_nq20_rows_pad32", nq=20, nkv=300, d=1024, seed=20)
    _from_s_case("d1024_many_q_tiles", hq=8, hkv=2, nq=4096, nkv=4096, d=1024, seed=21)
    _from_s_case("nan_filled_slab", nq=1000, nkv=1100, nan_fill=True, seed=9)
    _from_s_case("mha_batch2", b=2, hq=4, hkv=4, nq=512, nkv=640, seed=10)
    _from_s_case("gqa_group4_dropout", hq=8, hkv=2, nq=1024, nkv=1024, dropout=0.1, seed=11)
    _from_s_case("banded_out_f32", nq=1000, nkv=1100, banded_out=torch.float32, seed=12)
    _decode_scores_case("slice_Nkv4224_g2")
    _decode_scores_case("nq4_causal", nq=4, causal=True, valid=None, seed=1)
    _decode_scores_case("softcap", softcap=30.0, valid=None, seed=2)
    _decode_scores_case("d1024", d=1024, seed=3)
    _decode_scores_case("d576_rows33", group=11, nq=3, d=576, causal=True, valid=None, seed=4)
    # Continuous batching: the varlen forward at the serving packing and
    # feature cases; paged decode at the serving step (page 256) and cases.
    errs["varlen_fwd"] = _varlen_case("serving_packing", seqs=SERVE_LENS)
    _varlen_case("cross_varlen", seqs=[300, 200], seqs_k=[900, 700], seed=1)
    _varlen_case("noncausal", seqs=[300, 17, 500], causal=False, seed=2)
    _varlen_case("window", seqs=SERVE_LENS, window=(256, -1), seed=3)
    _varlen_case("softcap", seqs=[300, 17, 500], softcap=30.0, seed=4)
    _varlen_case("alibi", seqs=[300, 17, 500], alibi=True, seed=5)
    _varlen_case("fp16", seqs=SERVE_LENS, dtype=torch.float16, seed=6)
    _varlen_case("d320", seqs=[300, 17, 500], d=320, seed=7)
    _varlen_case("d1024", seqs=[300, 17, 500], d=1024, seed=8)
    _varlen_case("mha", seqs=[300, 17, 500], hq=8, hkv=8, seed=9)
    _varlen_case("padded_tail", seqs=[300, 17, 500], pad=45, seed=10)
    _varlen_case("empty_segment", seqs=[300, 0, 500], seed=11)
    _varlen_case("d512_dv320", seqs=[300, 17, 500], dv=320, seed=12)
    _varlen_case("d320_dv512_fp16", seqs=[300, 17, 500], d=320, dv=512, dtype=torch.float16,
                 seed=13)
    _varlen_case("rows_without_keys", seqs=[150, 40, 90], seqs_k=[30, 40, 200], seed=14)
    _varlen_case("straddle_three", seqs=[20, 9, 50, 3, 300], seed=15)
    # D or Dv above 512: the forward's cluster of two blocks, each rank
    # holding half of D's and of Dv's boxes (rank 0 five of D576's nine,
    # rank 1 no D box at D64 / Dv1024 and no Dv box at D1024 / Dv64), over
    # the features, packings and groups of the cases above.
    for i_, (name, kw) in enumerate((
            ("d640", dict(d=640)), ("d576", dict(d=576)),
            ("d1024_window", dict(d=1024, window=(256, -1))),
            ("d1024_softcap", dict(d=1024, softcap=30.0)),
            ("d1024_alibi", dict(d=1024, alibi=True)),
            ("d1024_fp16", dict(d=1024, dtype=torch.float16)),
            ("d1024_mha", dict(d=1024, hq=8, hkv=8)),
            ("d1024_gqa_group4", dict(d=1024, hq=8, hkv=2)),
            ("d1024_rows_without_keys", dict(d=1024, seqs=[150, 40, 90], seqs_k=[30, 40, 200])),
            ("d1024_straddle_three", dict(d=1024, seqs=[20, 9, 50, 3, 300])),
            ("d512_dv1024", dict(d=512, dv=1024)), ("d1024_dv320", dict(d=1024, dv=320)),
            ("d64_dv1024", dict(d=64, dv=1024)), ("d1024_dv64", dict(d=1024, dv=64)))):
        _varlen_case(f"cluster_{name}", **dict(dict(seqs=[300, 17, 500]), **kw), seed=20 + i_)
    # Packed training: the varlen backward kernels over feature cases, each
    # in bf16 and fp16; the 8192-token packing is held in
    # packed_training_times, beside its times.
    for i, dt in enumerate((torch.bfloat16, torch.float16)):
        tag, s = ("bf16", "fp16")[i], 20 * i
        _varlen_bwd_case(f"{tag}_self", seqs=[300, 17, 500], causal=False, dtype=dt, seed=s)
        _varlen_bwd_case(f"{tag}_cross_causal", seqs=[300, 200], seqs_k=[900, 700], dtype=dt,
                         seed=s + 1)
        _varlen_bwd_case(f"{tag}_cross", seqs=[300, 200], seqs_k=[900, 700], causal=False,
                         dtype=dt, seed=s + 2)
        _varlen_bwd_case(f"{tag}_gqa_causal", seqs=SERVE_LENS, dtype=dt, seed=s + 3)
        _varlen_bwd_case(f"{tag}_mha", seqs=[300, 17, 500], hq=8, hkv=8, dtype=dt, seed=s + 4)
        _varlen_bwd_case(f"{tag}_window_causal", seqs=[300, 17, 500], window=(64, -1), dtype=dt,
                         seed=s + 5)
        _varlen_bwd_case(f"{tag}_window_two_sided", seqs=[300, 17, 500], causal=False,
                         window=(64, 32), dtype=dt, seed=s + 6)
        _varlen_bwd_case(f"{tag}_softcap", seqs=[300, 17, 500], softcap=30.0, dtype=dt,
                         seed=s + 7)
        _varlen_bwd_case(f"{tag}_alibi", seqs=[300, 17, 500], alibi=True, dtype=dt, seed=s + 8)
        _varlen_bwd_case(f"{tag}_sinks_window", seqs=[300, 17, 500], window=(128, -1),
                         sinks=True, dtype=dt, seed=s + 9)
        _varlen_bwd_case(f"{tag}_d320", seqs=[300, 17, 500], d=320, dtype=dt, seed=s + 10)
        _varlen_bwd_case(f"{tag}_d1024_cluster", seqs=[300, 17, 500], d=1024, dtype=dt,
                         seed=s + 11)
        _varlen_bwd_case(f"{tag}_padded_tail_empty_seg", seqs=[300, 0, 500], pad=45, dtype=dt,
                         seed=s + 12)
        _varlen_bwd_case(f"{tag}_tile_straddles_3_segs", seqs=[20, 9, 50, 3, 300], dtype=dt,
                         seed=s + 13)
        # D != Dv on the wgmma dK/dV route: passes split D and Dv's boxes
        # differently (256 + 256 of D, 192 + 128 of Dv).
        _varlen_bwd_case(f"{tag}_d512_dv320", seqs=[300, 17, 500], d=512, dv=320, dtype=dt,
                         seed=s + 14)
        _varlen_bwd_case(f"{tag}_d320_dv512", seqs=[300, 17, 500], d=320, dv=512, dtype=dt,
                         seed=s + 15)
        # Keys fewer than queries, tail-aligned: the first 120 rows keep no
        # key, so dQ's first 64-row Q tile walks no KV tile.
        _varlen_bwd_case(f"{tag}_rows_without_keys", seqs=[150, 40, 90], seqs_k=[30, 40, 200],
                         dtype=dt, seed=s + 16)
        # D or Dv above 512: the dK/dV cluster of two blocks, each rank
        # holding half of D's and of Dv's boxes (rank 0 five of D576's nine,
        # rank 1 no D box at D64 / Dv1024 and no Dv box at D1024 / Dv64),
        # over the features, packings and groups of the cases above.
        for i_, (name, kw) in enumerate((
                ("d640", dict(d=640)), ("d576", dict(d=576)),
                ("d1024_window_causal", dict(d=1024, window=(64, -1))),
                ("d1024_softcap", dict(d=1024, softcap=30.0)),
                ("d1024_alibi", dict(d=1024, alibi=True)),
                ("d1024_sinks_window", dict(d=1024, window=(128, -1), sinks=True)),
                ("d512_dv1024", dict(d=512, dv=1024)), ("d1024_dv320", dict(d=1024, dv=320)),
                ("d64_dv1024", dict(d=64, dv=1024)), ("d1024_dv64", dict(d=1024, dv=64)),
                ("d1024_straddles_3_segs", dict(d=1024, seqs=[20, 9, 50, 3, 300])),
                ("d1024_rows_without_keys", dict(d=1024, seqs=[150, 40, 90],
                                                 seqs_k=[30, 40, 200])),
                ("d1024_gqa_group4", dict(d=1024, hq=8, hkv=2)),
                ("d1024_mha", dict(d=1024, hq=8, hkv=8)))):
            kw = dict(dict(seqs=[300, 17, 500]), **kw)
            _varlen_bwd_case(f"{tag}_cluster_{name}", dtype=dt, seed=s + 40 + i_, **kw)
    serve_lens = [n + 1 for n in SERVE_LENS]  # the first decode step's cache
    errs["paged_decode"] = _paged_case("serving_page256", lens=serve_lens)
    _paged_case("int8_page256", lens=serve_lens, quantized=True, seed=1)
    _paged_case("page128", lens=serve_lens, page=128, seed=2)
    _paged_case("int8_page128", lens=serve_lens, page=128, quantized=True, seed=3)
    _paged_case("nq4", lens=[n + 4 for n in SERVE_LENS], nq=4, seed=4)
    _paged_case("int8_nq4_group4", lens=[n + 4 for n in SERVE_LENS], nq=4, group=4, hkv=2,
                quantized=True, seed=5)
    _paged_case("window_softcap", lens=serve_lens, window=256, softcap=30.0, seed=6)
    _paged_case("ragged_with_zero", lens=[0, 1, 257, 1000], seed=7)
    _paged_case("idle_slot", lens=serve_lens, idle=True, seed=8)
    _paged_case("shuffled_table", lens=serve_lens, shuffle=True, seed=9)
    _paged_case("int8_shuffled_page128", lens=serve_lens, page=128, shuffle=True,
                quantized=True, seed=10)
    _paged_case("fp16", lens=serve_lens, dtype=torch.float16, seed=11)
    # The block's edges: smaller pages (boxes of 32 / 16 rows), 64 packed
    # rows (four row blocks), a window starting mid-box, lengths on tile
    # edges, an f16 int8 pool, D 320 int8 (a half-empty last slab); pages of
    # 24, 8, 20 and 17 rows (boxes of 8, 8, 4 and 1 rows, up to 64 a stage);
    # and the two-warpgroup instance above D512 (D640, D1024, 64 packed
    # rows, a window with softcap, fp16, int8, small pages).
    _paged_case("page64", lens=serve_lens, page=64, seed=12)
    _paged_case("page32_int8", lens=serve_lens, page=32, quantized=True, seed=13)
    _paged_case("page16_nq8_group8", lens=[n + 8 for n in SERVE_LENS], page=16, nq=8, group=8,
                hkv=1, seed=14)
    _paged_case("window_mid_box_page32", lens=serve_lens, page=32, window=100, seed=15)
    _paged_case("tile_edges", lens=[64, 128, 640, 1152], seed=16)
    _paged_case("fp16_int8", lens=serve_lens, dtype=torch.float16, quantized=True, seed=17)
    _paged_case("d320_int8_page32", lens=[150, 71, 300, 5], page=32, d=320, quantized=True,
                max_len=320, seed=18)
    _paged_case("page24", lens=[150, 71, 300, 5], page=24, max_len=336, seed=19)
    for i, page in enumerate((24, 8, 20, 17)):
        _paged_case(f"page{page}_serving", lens=serve_lens, page=page, seed=20 + i)
        _paged_case(f"page{page}_int8", lens=serve_lens, page=page, quantized=True, seed=24 + i)
    _paged_case("page17_fp16_nq4", lens=[n + 4 for n in SERVE_LENS], page=17, nq=4,
                dtype=torch.float16, seed=28)
    errs["paged_decode_wide"] = _paged_case("d1024_serving", lens=serve_lens, d=1024, seed=30)
    _paged_case("d1024_int8", lens=serve_lens, d=1024, quantized=True, seed=31)
    _paged_case("d640", lens=serve_lens, d=640, seed=32)
    _paged_case("d640_int8_page24", lens=serve_lens, d=640, page=24, quantized=True, seed=33)
    _paged_case("d1024_nq8_group8", lens=[n + 8 for n in SERVE_LENS], d=1024, nq=8, group=8,
                hkv=1, seed=34)
    _paged_case("d1024_window_softcap", lens=serve_lens, d=1024, window=256, softcap=30.0,
                seed=35)
    _paged_case("d1024_fp16", lens=serve_lens, d=1024, dtype=torch.float16, seed=36)
    _paged_case("d1024_fp16_int8_page20", lens=serve_lens, d=1024, page=20,
                dtype=torch.float16, quantized=True, seed=37)
    for i, page in enumerate((24, 8, 17)):
        _paged_case(f"d1024_page{page}", lens=serve_lens, d=1024, page=page, seed=38 + i)
        _paged_case(f"d1024_page{page}_int8", lens=serve_lens, d=1024, page=page,
                    quantized=True, seed=41 + i)
    _paged_case("d512_page24_serving_step", lens=[n + 64 for n in SERVE_LENS], page=24, seed=44)
    return errs


@torch.inference_mode()
def oracle_logits(model, prompt, first):
    """Prefill logits and the first decode step's logits of ``model`` with
    every attention computed by the fp32 oracle (``reference_attention``)
    over the prompt's K/V, written out here so that no kernel and no kernel
    wrapper runs. The slice's model has no window, softcap or sinks."""
    from ffpa_attn_tpu_torch.models.transformer import _mlp, _project_qkv, _rmsnorm
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


@torch.inference_mode()
def _teacher_forced_logits(model, prompt, tokens):
    """fp32 logits [steps, vocab] on the CPU of ``prefill`` on ``prompt``
    and of a ``decode_step`` on each of ``tokens`` [1, steps] but the last,
    on the model's device and with ``generate``'s cache length: the logits
    whose argmax is each greedy token of ``generate``, with the tokens
    forced from another run."""
    from ffpa_attn_tpu_torch.models import decode_step, init_kv_cache, prefill

    dev = model.embed.device
    prompt, tokens = prompt.to(dev), tokens.to(dev)
    n, steps = prompt.shape[1], tokens.shape[1]
    logits, cache = prefill(model, prompt, init_kv_cache(model.cfg, 1, n + steps, device=dev))
    out = [logits]
    for i in range(steps - 1):
        logits, cache = decode_step(model, cache, n + i, tokens[:, i])
        out.append(logits)
    return torch.cat(out).float().cpu()


def hold_greedy_steps(card, cpu, tokens) -> None:
    """The tiny model's gate: at every step the card's logits lie within
    BF16_TOL of max|logit| of the CPU's, element by element, and the card's
    argmax equals the CPU's greedy token wherever the CPU's top two logits
    are more than 2 BF16_TOL max|logit| apart (within that bound no argmax
    can flip at a wider gap; a nearer tie is logged, not held). Fails on a
    miss."""
    if not torch.equal(cpu.argmax(-1), tokens[0].cpu()):
        fail("tiny model: the CPU's teacher-forced logits do not give its greedy tokens")
    ok = True
    for i, (c, w) in enumerate(zip(card, cpu)):
        scale = float(w.abs().max())
        err = float((c - w).abs().max()) / scale
        top = w.topk(2).values
        gap, margin = float(top[0] - top[1]), 2 * BF16_TOL * scale
        same = int(c.argmax()) == int(w.argmax())
        held = err < BF16_TOL and (same or gap <= margin)
        ok = ok and held
        log(f"  tiny model step {i}: token {int(tokens[0, i])}, logits rel_err {err:.2e} (tol "
            f"{BF16_TOL:g} of max|logit| {scale:.3f}), top-two gap {gap:.4f} "
            f"{'>' if gap > margin else '<='} {margin:.4f}: argmax "
            f"{'held' if gap > margin else 'not held (near tie)'}, same {same} "
            f"{'ok' if held else 'FAIL'}")
    if not ok:
        fail("tiny model: the card's teacher-forced logits disagree with the CPU's")


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

    # Tiny model: the card's logits at every greedy step of the CPU's plain
    # path, teacher-forced with the CPU's tokens.
    tiny = ModelConfig(vocab_size=64, d_model=64, n_layers=1, n_heads=2, n_kv_heads=1,
                       head_dim=320, max_seq_len=256)
    params = random_params(tiny, seed=2)
    tprompt = torch.from_numpy(np.random.default_rng(3).integers(0, 64, (1, 128)))
    cpu_model = params_from_jax(params, tiny, device="cpu")
    on_cpu = generate(cpu_model, tprompt, 8)
    hold_greedy_steps(_teacher_forced_logits(params_from_jax(params, tiny), tprompt, on_cpu),
                      _teacher_forced_logits(cpu_model, tprompt, on_cpu), on_cpu)
    return dict(launches=launches, prefill_ms=prefill_med, decode_tok_s=tok_s,
                generate_ms=gen_s * 1e3, model=model, prompt=prompt)


TRAIN_KERNELS = ("flash_fwd", "dkdv", "dq", "banded_dq", "dkdv_from_s", "banded_dk")
SERVE_KERNELS = ("flash_fwd", "decode", "varlen_fwd", "paged_decode")


def launch_counts(zero: bool = False) -> dict:
    """Every kernel wrapper's launch count (``utils.profiling.launch_counts``;
    set to 0 first with ``zero``)."""
    from ffpa_attn_tpu_torch.utils.profiling import launch_counts as counts

    return counts(zero)


def _counts(names) -> dict:
    """The launch counts of the kernels ``names``."""
    counts = launch_counts()
    return {n: counts[n] for n in names}


def _launched() -> dict:
    """The kernels launched since the counts were set to 0, with their counts."""
    return {n: c for n, c in launch_counts().items() if c}


def serve_prompts():
    """The JAX serving bench's workload (cli/_e2e.py:_bench_serve_impl): B
    prompt lengths 1024 - rng.integers(0, 512), then the prompts, from
    numpy seed 0; the engine's requests continue from the same rng."""
    rng = np.random.default_rng(0)
    lens = [SERVE_PROMPT - int(rng.integers(0, SERVE_PROMPT // 2)) for _ in range(SERVE_B)]
    if lens != SERVE_LENS:
        fail(f"serving prompt lengths {lens} != {SERVE_LENS}")
    prompts = [torch.from_numpy(rng.integers(0, SLICE["vocab_size"], (n,))).cuda() for n in lens]
    return prompts, rng


def _timed_serve(label, fn, want) -> float:
    """One warm-up call, then one timed call with the launch counts set to 0
    just before it and read just after; tokens/s = B * gen over the timed
    call (cli/_e2e.py:124-132)."""
    fn()
    torch.cuda.synchronize()
    launch_counts(zero=True)
    t0 = time.perf_counter()
    toks = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _counts(SERVE_KERNELS)
    tok_s = SERVE_B * SERVE_GEN / dt
    log(f"  {label}: {SERVE_B * SERVE_GEN} tokens in {dt * 1e3:.1f} ms = {tok_s:.1f} tokens/s, "
        f"launches {counts}")
    if counts != want:
        fail(f"{label}: launch counts {counts} != expected {want}")
    if tuple(toks.shape) != (SERVE_B, SERVE_GEN) or not bool(
            ((toks >= 0) & (toks < SLICE["vocab_size"])).all()):
        fail(f"{label}: bad tokens of shape {tuple(toks.shape)}")
    return tok_s


@torch.inference_mode()
def _step_logits(model, prompts):
    """The packed prefill's last logits, then the first decode step's logits
    of the same greedy token over the dense shared-row cache, over bf16
    pools and over int8 pools (teacher-forced: all three get that token)."""
    from ffpa_attn_tpu_torch.models import init_kv_cache, pack_prompts, prefill_packed
    from ffpa_attn_tpu_torch.models.serving import _batched_decode_step, _paged_decode_step
    from ffpa_attn_tpu_torch.ops.paged import PagedKVCache, fill_from_prefill

    cfg = model.cfg
    lens = [int(p.shape[0]) for p in prompts]
    base, dev = max(lens), prompts[0].device
    packed, cu = pack_prompts(prompts, sum(lens))
    cache = init_kv_cache(cfg, len(prompts), SERVE_MAX_LEN, device=dev)
    logits, cache = prefill_packed(model, packed, cu, base, cache)
    tok = logits.argmax(-1)
    out = {"prefill": logits}
    for quantized in (False, True):
        pools = [fill_from_prefill(
            PagedKVCache.alloc(len(lens), SERVE_MAX_LEN, cfg.n_kv_heads, cfg.head_dim,
                               SERVE_PAGE, dtype=cfg.torch_dtype, quantized=quantized,
                               device=dev),
            c["k"][:, :, :base], c["v"][:, :, :base], lens) for c in cache]
        out["int8" if quantized else "paged"], _ = _paged_decode_step(model, pools, tok)
    out["dense"], _ = _batched_decode_step(
        model, cache, torch.tensor(lens, dtype=torch.int32, device=dev), 0, tok, base)
    return out


def phase_serving(model) -> dict:
    """Continuous batching at full width: ``serve_batch`` (packed varlen
    prefill + shared-row decode), ``serve_batch_paged`` over bf16 and int8
    pools, and a ``ServingEngine`` serving 8 requests over 4 slots, each
    with its launch counts; the prefill's logits against the fp32 oracle's
    per-segment attention, the paged step against the dense step, int8
    against bf16, the engine's first tokens against ``prefill`` alone, and a
    tiny model's serving logits on the card against the CPU's."""
    from ffpa_attn_tpu_torch.models import (
        ModelConfig, ServingEngine, init_kv_cache, params_from_jax, prefill, random_params,
        serve_batch, serve_batch_paged,
    )
    from ffpa_attn_tpu_torch.ops.config import cdiv

    cfg = model.cfg
    prompts, rng = serve_prompts()
    log(f"serving path: B{SERVE_B} prompts {SERVE_LENS} ({sum(SERVE_LENS)} packed tokens), gen "
        f"{SERVE_GEN}, max_len {SERVE_MAX_LEN}, page {SERVE_PAGE}; model L{cfg.n_layers} "
        f"dm{cfg.d_model} H{cfg.n_heads}/{cfg.n_kv_heads} Dh{cfg.head_dim} vocab "
        f"{cfg.vocab_size}")
    n_dec = cfg.n_layers * (SERVE_GEN - 1)
    want = {"flash_fwd": 0, "decode": n_dec, "varlen_fwd": cfg.n_layers, "paged_decode": 0}
    rates = {"serve_tokens_per_s": _timed_serve(
        "serve_batch", lambda: serve_batch(model, prompts, SERVE_GEN, SERVE_MAX_LEN), want)}
    want = dict(want, decode=0, paged_decode=n_dec)
    for quantized, key in ((False, "serve_paged_tokens_per_s"),
                           (True, "serve_paged_int8_tokens_per_s")):
        rates[key] = _timed_serve(
            f"serve_batch_paged{' int8' if quantized else ''}",
            lambda q=quantized: serve_batch_paged(model, prompts, SERVE_GEN, SERVE_MAX_LEN,
                                                  page_size=SERVE_PAGE, quantized=q), want)

    # Logit gates: the prefill against the oracle's attention per segment,
    # paged against dense, int8 against bf16 (first step, teacher-forced).
    logits = _step_logits(model, prompts)
    oracle = torch.cat([oracle_logits(model, p[None], logits["prefill"][i:i + 1].argmax(-1))[0]
                        for i, p in enumerate(prompts)])
    errs = {"prefill_vs_oracle": row_rel(logits["prefill"], oracle),
            "paged_vs_dense": row_rel(logits["paged"], logits["dense"]),
            "int8_vs_bf16": row_rel(logits["int8"], logits["paged"])}
    tols = {"prefill_vs_oracle": BF16_TOL, "paged_vs_dense": PAGED_TOL, "int8_vs_bf16": INT8_TOL}
    ok = all(errs[k] < tols[k] for k in errs) and all(
        bool(torch.isfinite(t).all()) for t in logits.values())
    log("  logits per sequence (of its max|logit|): " + " ".join(
        f"{k} {v:.2e} (tol {tols[k]:g})" for k, v in errs.items()) + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("serving logits disagree (oracle, paged vs dense, or int8 vs bf16)")

    # The engine: 8 requests from the same rng over 4 slots.
    requests = []
    for _ in range(ENGINE_REQUESTS):
        n = SERVE_PROMPT - int(rng.integers(0, SERVE_PROMPT // 2))
        requests.append((torch.from_numpy(rng.integers(0, cfg.vocab_size, (n,))).cuda(),
                         int(rng.integers(16, 65))))
    eng = ServingEngine(model, batch_slots=ENGINE_SLOTS, max_len=SERVE_MAX_LEN,
                        page_size=SERVE_PAGE)
    full = eng.alloc.free_pages
    t0 = time.perf_counter()
    rids = {eng.submit(p, max_new_tokens=mx): (p, mx) for p, mx in requests}
    done, steps = {}, 0
    while not eng.done():
        launch_counts(zero=True)
        ran = eng.steps_run
        done.update(eng.step())
        counts = _counts(SERVE_KERNELS)
        if eng.steps_run > ran and counts["paged_decode"] != cfg.n_layers:
            fail(f"engine step {steps}: {counts['paged_decode']} paged launches, expected "
                 f"{cfg.n_layers}")
        steps += 1
        if steps > 10 * SERVE_GEN:
            fail("the engine did not finish")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    tokens = sum(len(t) for t in done.values())
    firsts_ok = True
    for rid, (p, mx) in rids.items():
        pad = cdiv(p.shape[0], SERVE_PAGE) * SERVE_PAGE
        lg, _ = prefill(model, p[None], init_kv_cache(cfg, 1, pad))
        firsts_ok &= len(done.get(rid, [])) == mx and done[rid][0] == int(lg.argmax(-1)[0])
    ok = firsts_ok and set(done) == set(rids) and eng.alloc.free_pages == full
    log(f"  ServingEngine: {ENGINE_REQUESTS} requests (prompts "
        f"{[int(p.shape[0]) for p, _ in requests]}, max_new {[mx for _, mx in requests]}) over "
        f"{ENGINE_SLOTS} slots in {steps} steps ({eng.steps_run} decode steps), {tokens} tokens in "
        f"{dt * 1e3:.1f} ms = {tokens / dt:.1f} tokens/s, {cfg.n_layers} paged launches per "
        f"step; every request complete with its first token = prefill alone "
        f"{firsts_ok}; free pages {eng.alloc.free_pages} of {full} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the serving engine lost a request, a page, or its first tokens")
    del eng

    # Tiny model: serving logits on the card against the CPU's.
    tiny = ModelConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=2, n_kv_heads=1,
                       head_dim=320, max_seq_len=512)
    params = random_params(tiny, seed=2)
    trng = np.random.default_rng(3)
    tprompts = [torch.from_numpy(trng.integers(0, 128, (n,))) for n in (60, 40, 25)]
    card = _step_logits(params_from_jax(params, tiny), [p.cuda() for p in tprompts])
    cpu = _step_logits(params_from_jax(params, tiny, device="cpu"), tprompts)
    terrs = {k: row_rel(card[k].cpu(), cpu[k]) for k in cpu}
    ok = all(e < BF16_TOL for e in terrs.values())
    log("  tiny model serving logits card vs cpu: " + " ".join(
        f"{k} {e:.2e}" for k, e in terrs.items()) + f" (tol {BF16_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("tiny model: serving logits on the card differ from the CPU")
    return dict(rates=rates, errs=errs, prompts=prompts,
                launches={"varlen_fwd": cfg.n_layers, "paged_decode": n_dec})


@torch.inference_mode()
def _oracle_batched_step(model, cache, lens, t: int, token, base: int):
    """``models/serving.py`` ``_batched_decode_step`` with its attention
    computed by the fp32 oracle (``reference_attention``, K/V heads
    expanded) under the same shared-row bias, over its own ``cache``
    (written in place): no kernel and no kernel wrapper runs."""
    from ffpa_attn_tpu_torch.models.serving import _token_block, shared_row_bias
    from ffpa_attn_tpu_torch.ops.reference import expand_kv_heads, reference_attention

    cfg = model.cfg
    row = base + t
    bias = shared_row_bias(lens, t, base, cache[0]["k"].shape[2])

    def attend(li, q, k, v):
        cache[li]["k"][:, :, row:row + 1] = k
        cache[li]["v"][:, :, row:row + 1] = v
        return reference_attention(q, expand_kv_heads(cache[li]["k"], cfg.n_heads),
                                   expand_kv_heads(cache[li]["v"], cfg.n_heads), bias)

    return _token_block(model, token, lens + t, attend)


@torch.inference_mode()
def _serve_stream_vs_oracle(model, prompts, toks) -> list:
    """Teacher-forced on ``serve_batch``'s token stream ``toks`` [B, gen]:
    per decode step, (the kernel step's logits, the oracle step's logits),
    each on its own copy of one packed prefill's dense shared-row cache."""
    from ffpa_attn_tpu_torch.models import init_kv_cache, pack_prompts, prefill_packed
    from ffpa_attn_tpu_torch.models.serving import _batched_decode_step

    cfg, dev = model.cfg, prompts[0].device
    lens = [int(p.shape[0]) for p in prompts]
    base = max(lens)
    packed, cu = pack_prompts(prompts, sum(lens))
    cache = init_kv_cache(cfg, len(prompts), SERVE_MAX_LEN, device=dev)
    _, cache = prefill_packed(model, packed, cu, base, cache)
    oracle = [{k: x.clone() for k, x in c.items()} for c in cache]
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    steps = []
    for t in range(toks.shape[1] - 1):
        got, cache = _batched_decode_step(model, cache, lens_t, t, toks[:, t], base)
        want = _oracle_batched_step(model, oracle, lens_t, t, toks[:, t], base)
        steps.append((got.float(), want.float()))
    return steps


def phase_wide_dense(smi: str) -> dict:
    """The dense serving paths above D512, on the two-warpgroup decode
    block: the serving model at head dim 1024 (``WIDE``: dm1024 H8/4 Dh1024
    vocab 32000 bf16, random weights from numpy seed 0, depth cut to L2 for
    run time). ``generate`` on phase 4's 4096-token prompt, 32 greedy tokens
    (one warm-up call, then one with the launch counts set to 0 just before
    and read just after: L forward and L x 32 decode launches) with its
    tokens/s, and the first step's logits (prefill and one decode step)
    against the oracle's attention (BF16_TOL of max|logit|); then
    ``serve_batch`` on the serving workload (B4 prompts ``SERVE_LENS``, 128
    generated, max_len 1152; L varlen forward and L x 127 decode launches)
    with its tokens/s, and every decode step, teacher-forced on its stream,
    against the oracle's attention step (BF16_TOL of max|logit|, per
    sequence). Returns the model for the paged leg."""
    from ffpa_attn_tpu_torch.models import (
        ModelConfig, decode_step, generate, init_kv_cache, params_from_jax, prefill,
        random_params, serve_batch,
    )
    from ffpa_attn_tpu_torch.ops.config import decode_plan

    cfg = ModelConfig(**WIDE)
    model = params_from_jax(random_params(cfg, seed=0), cfg)
    group = cfg.n_heads // cfg.n_kv_heads
    plan = decode_plan(cfg.head_dim, cfg.head_dim, group)
    log(f"Dh1024 dense serving: model L{cfg.n_layers} (depth cut from L4 for run time) "
        f"dm{cfg.d_model} H{cfg.n_heads}/{cfg.n_kv_heads} Dh{cfg.head_dim} vocab "
        f"{cfg.vocab_size} {cfg.dtype}; decode plan {plan}")
    if plan.consumers != 2:
        fail(f"Dh1024 dense serving: the decode plan {plan} is not the two-warpgroup block")
    out = {"rates": {}, "launches": {}, "errs": {}}

    # generate: B1, the 4096-token prompt, 32 tokens.
    prompt = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (1, PROMPT))).cuda()
    generate(model, prompt, 2, max_len=MAX_LEN)  # warm-up
    torch.cuda.synchronize()
    launch_counts(zero=True)
    t0 = time.perf_counter()
    toks = generate(model, prompt, STEPS, max_len=MAX_LEN)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _counts(SERVE_KERNELS)
    want = {"flash_fwd": cfg.n_layers, "decode": cfg.n_layers * STEPS, "varlen_fwd": 0,
            "paged_decode": 0}
    if counts != want:
        fail(f"Dh1024 generate: launch counts {counts} != expected {want}")
    if tuple(toks.shape) != (1, STEPS) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail(f"Dh1024 generate: bad tokens {toks}")
    logits0, cache = prefill(model, prompt, init_kv_cache(cfg, 1, MAX_LEN))
    first = logits0.argmax(-1)
    logits1, _ = decode_step(model, cache, PROMPT, first)
    o0, o1 = oracle_logits(model, prompt, first)
    e0, e1 = row_rel(logits0, o0), row_rel(logits1, o1)
    ok = e0 < BF16_TOL and e1 < BF16_TOL and bool(torch.isfinite(logits1).all())
    out["rates"]["generate"], out["launches"]["generate"] = STEPS / dt, counts["decode"]
    out["errs"]["generate"] = e1
    log(f"  generate: {STEPS} tokens in {dt * 1e3:.1f} ms = {STEPS / dt:.1f} tokens/s (B1, "
        f"prefill included), launches {counts}; first-step logits vs the oracle's attention: "
        f"prefill rel_err {e0:.2e}, decode rel_err {e1:.2e} (tol {BF16_TOL:g}, of max|logit|) "
        f"on {smi} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("Dh1024 generate: logits disagree with the oracle's attention")
    del cache

    # serve_batch: the serving workload over the dense shared-row cache.
    prompts, _ = serve_prompts()
    n_dec = cfg.n_layers * (SERVE_GEN - 1)
    want = {"flash_fwd": 0, "decode": n_dec, "varlen_fwd": cfg.n_layers, "paged_decode": 0}
    rate = _timed_serve("Dh1024 serve_batch",
                        lambda: serve_batch(model, prompts, SERVE_GEN, SERVE_MAX_LEN), want)
    toks = serve_batch(model, prompts, SERVE_GEN, SERVE_MAX_LEN)
    steps = _serve_stream_vs_oracle(model, prompts, toks)
    worst, ties = 0.0, 0
    for got, want_l in steps:
        worst = max(worst, row_rel(got, want_l))
        top = want_l.topk(2, dim=-1).values
        ties += int(((top[:, 0] - top[:, 1]) <= 2 * BF16_TOL * want_l.abs().amax(-1)).sum())
    ok = worst < BF16_TOL and all(bool(torch.isfinite(g).all()) for g, _ in steps)
    out["rates"]["serve_batch"], out["launches"]["serve_batch"] = rate, n_dec
    out["errs"]["serve_batch"] = worst
    log(f"  serve_batch: {len(steps)} steps teacher-forced on its stream, worst per-row logits "
        f"vs the oracle's attention step {worst:.2e} (tol {BF16_TOL:g} of max|logit|), {ties} "
        f"near ties (logged) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("Dh1024 serve_batch: the decode steps disagree with the oracle's attention")
    del steps
    torch.cuda.empty_cache()
    out["model"] = model
    return out


def phase_paged_wide(smi: str, model) -> dict:
    """Paged serving above D512, on the two-warpgroup paged block: the
    serving model at head dim 1024 (``WIDE``, ``phase_wide_dense``'s model)
    on the serving workload (B4 prompts ``SERVE_LENS``, 128 generated,
    max_len 1152). For each of ``WIDE_POOLS`` (pages of 256 bf16 and int8
    rows, of 24 bf16 rows): ``serve_batch_paged`` once to warm up, then
    once with the launch counts set to 0 just before and read just after
    (L varlen forward and L x 127 paged launches) and its tokens/s;
    every decode step's logits, teacher-forced on that paged stream, held
    to the dense shared-row step's (PAGED_TOL of max|logit| over bf16
    pools, INT8_TOL over int8); and the paged wrapper's device ms a step
    (walk and merge, one layer, CUDA events with the host's enqueue taken
    out) at the last step's pools."""
    from ffpa_attn_tpu_torch.models import serve_batch_paged
    from ffpa_attn_tpu_torch.ops import paged
    from ffpa_attn_tpu_torch.ops.config import paged_plan
    from ffpa_attn_tpu_torch.utils.profiling import bound_ms, paged_decode_counts, queued_ms

    cfg = model.cfg
    prompts, _ = serve_prompts()
    log(f"Dh1024 paged serving: model L{cfg.n_layers} (depth cut from L4 for run time) "
        f"dm{cfg.d_model} H{cfg.n_heads}/{cfg.n_kv_heads} Dh{cfg.head_dim} vocab "
        f"{cfg.vocab_size} {cfg.dtype}, B{SERVE_B} prompts {SERVE_LENS}, gen {SERVE_GEN}, "
        f"max_len {SERVE_MAX_LEN}")
    n_dec = cfg.n_layers * (SERVE_GEN - 1)
    want = {"flash_fwd": 0, "decode": 0, "varlen_fwd": cfg.n_layers, "paged_decode": n_dec}
    out = {"rates": {}, "errs": {}, "step_ms": {}, "launches": {}}
    for label, page, quantized in WIDE_POOLS:
        plan = paged_plan(cfg.head_dim, cfg.head_dim, page, quantized)
        if plan.consumers != 2:
            fail(f"Dh1024 paged serving {label}: the plan {plan} is not the two-warpgroup block")

        def run(page=page, quantized=quantized):
            return serve_batch_paged(model, prompts, SERVE_GEN, SERVE_MAX_LEN, page_size=page,
                                     quantized=quantized)

        run()
        torch.cuda.synchronize()
        launch_counts(zero=True)
        t0 = time.perf_counter()
        toks = run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = _counts(SERVE_KERNELS)
        tok_s = SERVE_B * SERVE_GEN / dt
        if counts != want:
            fail(f"Dh1024 serve_batch_paged {label}: launch counts {counts} != expected {want}")
        if tuple(toks.shape) != (SERVE_B, SERVE_GEN) or not bool(
                ((toks >= 0) & (toks < cfg.vocab_size)).all()):
            fail(f"Dh1024 serve_batch_paged {label}: bad tokens of shape {tuple(toks.shape)}")
        steps, pools = _window_stream_logits(model, prompts, toks, page=page, quantized=quantized)
        worst, ties = 0.0, 0
        tol = INT8_TOL if quantized else PAGED_TOL
        for lp, ld in steps:
            worst = max(worst, row_rel(lp, ld))
            top = ld.topk(2, dim=-1).values
            ties += int(((top[:, 0] - top[:, 1]) <= 2 * tol * ld.abs().amax(-1)).sum())
        finite = all(bool(torch.isfinite(lp).all()) for lp, _ in steps)
        gen = torch.Generator(device="cuda").manual_seed(40)
        q = _randn((SERVE_B, cfg.n_heads, 1, cfg.head_dim), torch.bfloat16, gen)
        step_lens = pools[0].lens.tolist()
        with torch.inference_mode():  # the pools are inference tensors
            step_ms = queued_ms(lambda: [paged.paged_decode_attention(
                q, pools[i % len(pools)], scale=cfg.head_dim ** -0.5) for i in range(50)]) / 50
        bms, bby = bound_ms(*paged_decode_counts(step_lens, hq=cfg.n_heads, hkv=cfg.n_kv_heads,
                                                 d=cfg.head_dim, dv=cfg.head_dim,
                                                 quantized=quantized))
        ok = worst < tol and finite
        log(f"  {label}: {SERVE_B * SERVE_GEN} tokens in {dt * 1e3:.1f} ms = {tok_s:.1f} tokens/s, "
            f"launches {counts} (boxes of {plan.box_rows} rows, {plan.stages} stages); "
            f"{len(steps)} steps teacher-forced on the paged stream, worst per-row logits vs the "
            f"dense step {worst:.2e} (tol {tol:g} of max|logit|), {ties} near ties (logged); "
            f"paged decode at the last step (lens {step_lens}) {step_ms:.4f} device ms a layer, "
            f"bound {bms:.4f} ms ({bby}), on {smi} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"Dh1024 paged serving {label}: the paged steps disagree with the dense steps")
        out["rates"][label], out["errs"][label] = tok_s, worst
        out["step_ms"][label], out["launches"][label] = step_ms, counts["paged_decode"]
        del steps, pools
        torch.cuda.empty_cache()
    return out


def phase_monkey_patch() -> None:
    """``patch_dot_product_attention`` on the card, inside try / finally
    unpatch (phase 6 times the stock function as a yardstick): the patched
    call at the prefill shape launches the forward kernel once and equals
    ``ffpa_attn_func`` bit for bit; a D64 call, a dropout call and a causal
    Nq 1024 / Nkv 4096 call launch no kernel of the port and equal the
    pristine function (dropout from the same seed); after unpatch the
    function is the pristine object again."""
    import torch.nn.functional as F

    import ffpa_attn_tpu_torch as ffpa
    from ffpa_attn_tpu_torch import interface

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(40)
    hq, hkv, d = SLICE["n_heads"], SLICE["n_kv_heads"], SLICE["head_dim"]
    q, k, v = (_randn((1, h, PROMPT, d), torch.bfloat16, gen) for h in (hq, hkv, hkv))
    kw = dict(is_causal=True, enable_gqa=True)
    stock = {
        "d64": ((q[..., :64].contiguous(), k[..., :64].contiguous(),
                 v[..., :64].contiguous()), kw),
        "dropout_p0.1": ((q, k, v), dict(kw, dropout_p=0.1)),
        "causal_nq1024_nkv4096": ((q[:, :, :1024].contiguous(), k, v), kw),
    }
    try:
        ffpa.patch_dot_product_attention()
        ffpa.patch_dot_product_attention()  # idempotent
        launch_counts(zero=True)
        out = F.scaled_dot_product_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        counts = _launched()
        same = torch.equal(out, ffpa.ffpa_attn_func(q, k, v, **kw))
        ok = counts == {"flash_fwd": 1} and same
        log(f"monkey-patch: B1 H{hq}/{hkv} N{PROMPT} D{d} causal bf16 through the patched "
            f"scaled_dot_product_attention: launches {counts}, bit-equal to ffpa_attn_func "
            f"{same} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("the patched call did not run the forward kernel as ffpa_attn_func does")
        for name, (args, call_kw) in stock.items():
            launch_counts(zero=True)
            torch.manual_seed(41)
            got = F.scaled_dot_product_attention(*args, **call_kw)
            torch.cuda.synchronize()
            counts = _launched()
            torch.manual_seed(41)
            same = torch.equal(got, interface._IMPORT_TIME_SDPA(*args, **call_kw))
            ok = not counts and same
            log(f"  {name}: routed to the stock function, port launches {counts or 0}, "
                f"equal to the pristine function {same} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"monkey-patch: {name} did not go to the stock function")
    finally:
        ffpa.unpatch_dot_product_attention()
    if F.scaled_dot_product_attention is not interface._IMPORT_TIME_SDPA:
        fail("unpatch did not restore the pristine scaled_dot_product_attention")
    log(f"  unpatched: the pristine object is back; phase {time.perf_counter() - t0:.1f} s")


def hold_speculative(label: str, forced, toks, blocks) -> dict:
    """The speculative stream against the target teacher-forced on it
    (``forced``: ``_teacher_forced_logits``, one single-row ``decode_step``
    a token): each emitted token is the argmax wherever the top two logits
    are more than 2 BF16_TOL max|logit| apart (a nearer tie is logged, not
    held), and each verify block's rows whose inputs are the stream's lie
    within BF16_TOL of max|logit| of the forced logits at the same position.
    ``blocks``: (pos, block tokens, logits [m, vocab]) of each verify call."""
    stream = toks[0].tolist()
    ties, missed, tie_same = [], [], 0
    for j, w in enumerate(forced):
        top = w.topk(2).values
        gap, margin = float(top[0] - top[1]), 2 * BF16_TOL * float(w.abs().max())
        if gap <= margin:
            ties.append(j)
            tie_same += int(w.argmax()) == stream[j]
        elif int(w.argmax()) != stream[j]:
            missed.append(j)
    worst, rows = 0.0, 0
    for pos, block, logits in blocks:
        c = pos - SPEC_PROMPT
        for t in range(len(block)):
            j = c + t + 1
            if j >= len(stream) or block[t] != stream[c + t]:
                break
            w = forced[j]
            worst = max(worst, float((logits[t] - w).abs().max() / w.abs().max()))
            rows += 1
    ok = not missed and worst < BF16_TOL and rows > 0
    log(f"  {label}: stream vs the target teacher-forced: argmax held at "
        f"{len(stream) - len(ties)} of {len(stream)} tokens, missed {missed}; {len(ties)} near "
        f"ties (logged, the argmax equal at {tie_same}) at {ties}; {len(blocks)} verify "
        f"blocks, {rows} rows on the stream, worst logits rel_err {worst:.2e} (tol {BF16_TOL:g} of max|logit|) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"speculative {label}: the stream or a verify block disagrees with the target")
    return dict(near_ties=len(ties), verify_rows=rows, verify_err=worst)


def phase_speculative(model) -> dict:
    """The bench's ``bench_speculative`` (``cli/_e2e.py``) on the full-width
    model, its workload (``speculative_workload``) and its timed call
    (``run_speculative``): self-spec, then a draft of the target's first
    layer (a ``Transformer`` sharing its parameters, with its own cache).
    Each: one recorded call (every verify block's logits kept), then the
    bench's timed call with the launch counts set to 0 just before it and
    read just after (forward: the two prefills; decode: iterations x
    ((k_spec + 1) L_draft + L_target)); the stream and the blocks held to
    the target teacher-forced (``hold_speculative``); tokens/s = gen over the
    timed call. Plain ``generate`` at the same prompt and length beside
    them."""
    from ffpa_attn_tpu_torch.cli import _e2e
    from ffpa_attn_tpu_torch.models import generate, speculative_generate
    from ffpa_attn_tpu_torch.models import speculative as spec

    t_phase = time.perf_counter()
    cfg = model.cfg
    if (SPEC_PROMPT, SPEC_GEN, SPEC_K) != (_e2e.SPEC_PROMPT, _e2e.SPEC_GEN, _e2e.SPEC_K):
        fail(f"SPEC_* {(SPEC_PROMPT, SPEC_GEN, SPEC_K)} != bench_speculative's "
             f"{(_e2e.SPEC_PROMPT, _e2e.SPEC_GEN, _e2e.SPEC_K)}")
    log(f"speculative decoding (bench_speculative): prompt {SPEC_PROMPT}, {SPEC_GEN} tokens, "
        f"k_spec {SPEC_K}, max_len {SPEC_MAX_LEN}, target L{cfg.n_layers}:")

    blocks, verify = [], spec.decode_block

    def recording(m, cache, pos, toks):
        logits, cache = verify(m, cache, pos, toks)
        blocks.append((pos, toks[0].tolist(), logits[0].float().cpu()))
        return logits, cache

    out = {"rates": {}, "accept": {}, "launches": {}}
    forced = None
    for draft_layers in (0, SPEC_DRAFT_LAYERS):
        prompt, dmodel, max_len, _ = _e2e.speculative_workload(model, draft_layers=draft_layers)
        if max_len != SPEC_MAX_LEN:
            fail(f"bench_speculative's max_len {max_len} != {SPEC_MAX_LEN}")
        label = f"draft_L{draft_layers}" if draft_layers else "self_spec"
        blocks.clear()
        spec.decode_block = recording  # the verify blocks, not the draft's steps
        try:
            toks, stats = speculative_generate(model, dmodel, prompt, SPEC_GEN, max_len,
                                               k_spec=SPEC_K, return_stats=True)
        finally:
            spec.decode_block = verify
        torch.cuda.synchronize()
        timed = _e2e.run_speculative(model, dmodel, prompt, SPEC_GEN, max_len, SPEC_K,
                                     warmup=False)
        toks2, stats2, dt, counts = (timed[k_] for k_ in ("toks", "stats", "seconds", "launches"))
        ld, lt = dmodel.cfg.n_layers, cfg.n_layers
        want = {"flash_fwd": lt + ld, "decode": stats2["target_calls"] * ((SPEC_K + 1) * ld + lt)}
        rate, accept = SPEC_GEN / dt, stats2["draft_accepted"] / stats2["proposals"]
        log(f"  {label}: {SPEC_GEN} tokens in {dt * 1e3:.1f} ms = {rate:.1f} tokens/s, accept "
            f"rate {accept:.3f}, stats {stats2}, launches {counts} (expected {want})")
        if counts != want:
            fail(f"speculative {label}: launch counts {counts} != expected {want}")
        if not torch.equal(toks, toks2) or stats != stats2:
            fail(f"speculative {label}: two calls on the same inputs differ")
        if tuple(toks.shape) != (1, SPEC_GEN) or not bool(
                ((toks >= 0) & (toks < cfg.vocab_size)).all()):
            fail(f"speculative {label}: bad tokens of shape {tuple(toks.shape)}")
        if label == "self_spec" and stats2["draft_accepted"] < stats2["proposals"] - 2:
            fail(f"speculative self_spec accepted {stats2['draft_accepted']} of "
                 f"{stats2['proposals']} proposals (gate: all but 2)")
        if forced is None or not torch.equal(toks, stream):
            forced, stream = _teacher_forced_logits(model, prompt, toks), toks
        out[label] = hold_speculative(label, forced, toks, blocks)
        out["rates"][label], out["accept"][label] = rate, accept
        out["launches"][label] = counts

    def plain():
        return generate(model, prompt, SPEC_GEN, max_len=SPEC_MAX_LEN)

    def run(dmodel):
        return speculative_generate(model, dmodel, prompt, SPEC_GEN, SPEC_MAX_LEN,
                                    k_spec=SPEC_K, return_stats=True)

    def rate(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return SPEC_GEN / (time.perf_counter() - t0)

    toks = plain()  # warm-up at this cache length
    out["rates"]["generate"] = rate(plain)
    agree = int((toks == stream).cumprod(dim=1).sum())
    # Self-spec against plain decode in one call, in turns.
    turns = [rate(fn) for fn in (plain, lambda: run(model), lambda: run(model), plain)]
    log(f"  plain generate at the same prompt and length: {out['rates']['generate']:.1f} "
        f"tokens/s; its greedy stream agrees with the speculative one for the first {agree} of "
        f"{SPEC_GEN} tokens (informational: near ties round either way); in turns generate, "
        f"self-spec, self-spec, generate: {', '.join(f'{r:.1f}' for r in turns)} tokens/s; "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    out["turns"] = turns
    return out


def _s_resident_launches(layers: int, heads_split: bool = False) -> dict:
    """Launches of one S-resident backward step per layer: the forward, the
    from-S pass, banded dK where dK is out of the kernel (the dispatch
    rule at the training shape), banded dQ; with a partial residency split
    also the other heads' forward, dkdv (with the slab) and banded dQ."""
    from ffpa_attn_tpu_torch.ops.dispatch import pick_backward_config

    cfg = pick_backward_config(d=TRAIN["head_dim"], dv=TRAIN["head_dim"], nq=TRAIN_N,
                               nkv=TRAIN_N, dtype=torch.bfloat16)
    extra = 1 if heads_split else 0
    return {"flash_fwd": layers * (1 + extra), "dkdv": layers * extra, "dq": 0,
            "banded_dq": layers * (1 + extra), "dkdv_from_s": layers,
            "banded_dk": 0 if cfg.dkdv_dk_in_kernel else layers}


def _train_steps(model, state, step, tokens, n, want, label) -> tuple:
    """n steps, each driven with the counts set to 0 just before it and
    read just after, held to ``want`` (the counts of the kernels it names).
    Returns (state, losses, step ms, summed counts)."""
    losses, times, total = [], [], dict.fromkeys(want, 0)
    for i in range(n):
        torch.cuda.synchronize()
        launch_counts(zero=True)
        t0 = time.perf_counter()
        state, loss = step(model, state, tokens)
        loss = float(loss)  # synchronizes
        times.append((time.perf_counter() - t0) * 1e3)
        counts = _counts(want)
        if counts != want:
            fail(f"{label} step {i}: launch counts {counts} != expected {want}")
        for name in total:
            total[name] += counts[name]
        losses.append(loss)
    return state, losses, times, total


def oracle_loss_and_grads(cfg, params, tokens) -> tuple:
    """The first step's loss and gradients of the same weights with every
    attention computed by the fp32 oracle (``reference_attention``) under
    autograd, written out here so that no kernel and no kernel wrapper
    runs; each layer's attention is recomputed in the backward
    (``torch.utils.checkpoint``) so that one layer's N^2 fp32 scores are
    live at a time."""
    from torch.utils.checkpoint import checkpoint

    from ffpa_attn_tpu_torch.models import params_from_jax
    from ffpa_attn_tpu_torch.models.transformer import _mlp, _project_qkv, _rmsnorm
    from ffpa_attn_tpu_torch.ops.reference import expand_kv_heads, reference_attention

    model = params_from_jax(params, cfg)
    x_tok, targets = tokens[:, :-1], tokens[:, 1:]
    b, n = x_tok.shape
    positions = torch.arange(n, device=tokens.device)

    def attend(q, k, v):
        return reference_attention(q, expand_kv_heads(k, cfg.n_heads),
                                   expand_kv_heads(v, cfg.n_heads), is_causal=True)

    x = model.embed[x_tok]
    for layer in model.layers:
        q, k, v = _project_qkv(layer, _rmsnorm(x, layer.attn_norm), cfg, positions)
        o = checkpoint(attend, q, k, v, use_reentrant=False)
        x = x + layer.wo(o.transpose(1, 2).reshape(b, n, -1))
        x = x + _mlp(layer, _rmsnorm(x, layer.mlp_norm))
    logits = _rmsnorm(x, model.final_norm) @ model.embed.T
    logp = torch.log_softmax(logits.float(), dim=-1)
    loss = -logp.gather(-1, targets[..., None])[..., 0].mean()
    loss.backward()
    return float(loss.detach()), [(name, p.grad) for name, p in model.named_parameters()]


def _train_and_hold(cfg, label: str, per_step: dict, timed_steps: int, oracle=None) -> dict:
    """``make_train_step`` (AdamW 1e-4) of ``cfg`` with random weights from
    numpy seed 0 on tokens from seed 1: one warm-up step and ``timed_steps``
    timed steps, each with its launch counts held to ``per_step``; losses
    finite and falling; the first step's loss and every gradient leaf
    against the same weights with the fp32 oracle's attention (``oracle``,
    computed here when not given; attention's residency does not change the
    weights)."""
    from ffpa_attn_tpu_torch.models import adamw, make_train_step, params_from_jax, random_params

    params = random_params(cfg, seed=0)
    model = params_from_jax(params, cfg)  # on cuda by default
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (1, TRAIN_N + 1))).cuda()
    opt = adamw(1e-4)
    state = opt.init(list(model.parameters()))
    step = make_train_step(cfg, opt)  # on cuda by default
    log(f"{label}: model L{cfg.n_layers} dm{cfg.d_model} H{cfg.n_heads}/{cfg.n_kv_heads} "
        f"Dh{cfg.head_dim} vocab {cfg.vocab_size} {cfg.dtype}, N{TRAIN_N} B1, AdamW 1e-4, "
        f"attn_save_scores={cfg.attn_save_scores}")
    # The warm-up is the first step: its gradients are those of the
    # initial weights.
    state, losses, warm_ms, _ = _train_steps(model, state, step, tokens, 1, per_step,
                                             f"{label} warm-up")
    grads = [(name, p.grad.detach().clone()) for name, p in model.named_parameters()]
    state, timed, times, launches = _train_steps(model, state, step, tokens, timed_steps,
                                                 per_step, label)
    losses += timed
    step_ms = sorted(times)[len(times) // 2]
    tok_s = TRAIN_N / (step_ms / 1e3)
    log(f"  steps: warm-up {warm_ms[0]:.1f} ms, timed {[round(t, 2) for t in times]} ms; "
        f"median {step_ms:.2f} ms = {tok_s:.1f} train tokens/s; losses "
        f"{[round(x, 5) for x in losses]}; launches per step {per_step}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"{label}: training losses must be finite and fall: {losses}")

    if oracle is None:
        oracle = oracle_loss_and_grads(cfg, params, tokens)
    o_loss, o_grads = oracle
    worst, worst_name = 0.0, ""
    for (name, g), (oname, og) in zip(grads, o_grads):
        assert name == oname
        e = rel(g, og)
        if not math.isfinite(e) or e > worst:
            worst, worst_name = e, name
    loss_err = abs(losses[0] - o_loss) / abs(o_loss)
    ok = worst < GRAD_TOL[torch.bfloat16] and loss_err < LOSS_TOL
    log(f"  first step vs the oracle's attention (fp32, N{TRAIN_N}): loss {losses[0]:.5f} vs "
        f"{o_loss:.5f} (rel {loss_err:.2e}, tol {LOSS_TOL:g}); gradients worst leaf {worst_name} "
        f"rel_err {worst:.2e} of its max|g| (tol {GRAD_TOL[torch.bfloat16]:g}) "
        f"{'ok' if ok else 'FAIL'}")
    del grads
    torch.cuda.empty_cache()
    if not ok:
        fail(f"{label}: training gradients disagree with the oracle's attention")
    return dict(model=model, state=state, step=step, tokens=tokens, launches=launches,
                step_ms=step_ms, tok_s=tok_s, losses=losses, loss_err=loss_err, grad_err=worst,
                oracle=oracle)


def phase_training() -> dict:
    """The dS-handoff tier (the model's default, as in the JAX model)."""
    from ffpa_attn_tpu_torch.models import ModelConfig

    cfg = ModelConfig(**TRAIN)
    per_step = {"flash_fwd": cfg.n_layers, "dkdv": cfg.n_layers, "dq": 0,
                "banded_dq": cfg.n_layers, "dkdv_from_s": 0, "banded_dk": 0}
    return _train_and_hold(cfg, "training path", per_step, TRAIN_STEPS)


def phase_fp8_training(oracle) -> dict:
    """The dS-handoff tier with its slab in e4m3 (``FFPA_TORCH_ALLOW_FP8_DS=1``;
    the dispatcher proposes it for bf16, no bias, Nq * Nkv >= 4096^2) on the
    training path's model and tokens: one warm-up step with the flag, then
    three steps with it and three without in turns (e4m3, 16-bit, ...),
    each held to its launch counts (with the flag the e4m3 writer and reader
    once a layer and no 16-bit dK/dV or banded dQ; without, the reverse).
    Losses finite and falling. Logged, not held: the warm-up step's slabs
    (max |dS| and the share of zeros on the causal band, with the flag and
    in the first 16-bit step) and its gradients against the fp32 oracle's,
    the wq leaves (through dQ, the slab's reader) apart from the others:
    the JAX design stores dS unscaled, and at this shape it sits below
    e4m3's range (the flag stays off by default)."""
    from ffpa_attn_tpu_torch.models import (
        ModelConfig, adamw, make_train_step, params_from_jax, random_params,
    )
    from ffpa_attn_tpu_torch.ops import flash_bwd

    cfg = ModelConfig(**TRAIN)
    zero = {"flash_fwd": cfg.n_layers, "dkdv": 0, "dq": 0, "banded_dq": 0, "dkdv_from_s": 0,
            "banded_dk": 0, "dkdv_fp8_ds": 0, "banded_dq_fp8_ds": 0}
    want = {"1": dict(zero, dkdv_fp8_ds=cfg.n_layers, banded_dq_fp8_ds=cfg.n_layers),
            "0": dict(zero, dkdv=cfg.n_layers, banded_dq=cfg.n_layers)}
    model = params_from_jax(random_params(cfg, seed=0), cfg)
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (1, TRAIN_N + 1))).cuda()
    opt = adamw(1e-4)
    state = opt.init(list(model.parameters()))
    step = make_train_step(cfg, opt)
    log(f"e4m3 dS training path ({FP8_FLAG}=1): the training path's model and tokens")
    band = TRAIN_N * (TRAIN_N + 1) // 2 * cfg.n_heads
    slabs, launch = [], flash_bwd._dkdv_launch

    def recording(*a, **kw):  # the slab each layer's dK/dV launch writes
        out = launch(*a, **kw)
        ds = out[2].float()
        slabs.append((str(out[2].dtype)[6:], float(ds.abs().max()),
                      1.0 - int(torch.count_nonzero(ds)) / band))
        return out

    flash_bwd._dkdv_launch = recording
    try:
        with _env(FP8_FLAG, "1"):
            state, losses, warm_ms, _ = _train_steps(model, state, step, tokens, 1, want["1"],
                                                     "e4m3 dS warm-up")
        grads = [(name, p.grad.detach().clone()) for name, p in model.named_parameters()]
        with _env(FP8_FLAG, "0"):
            state, more, first16, _ = _train_steps(model, state, step, tokens, 1, want["0"],
                                                   "16-bit step on the e4m3 path's model")
    finally:
        flash_bwd._dkdv_launch = launch
    losses += more
    times = {"1": [], "0": first16}
    launches = dict.fromkeys(want["1"], 0)
    for flag in ("1", "1", "0", "1", "0"):  # with the step above: e4m3, 16, 16, e4m3, ...
        with _env(FP8_FLAG, flag):
            state, more, ms, counts = _train_steps(model, state, step, tokens, 1, want[flag],
                                                   f"{FP8_FLAG}={flag} step")
        losses += more
        times[flag] += ms
        if flag == "1":
            launches = {n: launches[n] + c for n, c in counts.items()}
    worst = {"wq": (0.0, ""), "other": (0.0, "")}
    for (name, g), (oname, og) in zip(grads, oracle[1]):
        assert name == oname
        e, key = rel(g, og), "wq" if ".wq." in name else "other"
        if not math.isfinite(e) or e > worst[key][0]:
            worst[key] = (e, name)
    del grads
    step_ms = {f: sorted(t)[len(t) // 2] for f, t in times.items()}
    log(f"  steps: warm-up {warm_ms[0]:.1f} ms; in turns, {FP8_FLAG}=1 "
        f"{[round(t, 2) for t in times['1']]} ms (median {step_ms['1']:.2f}), =0 "
        f"{[round(t, 2) for t in times['0']]} ms (median {step_ms['0']:.2f}); losses "
        f"{[round(x, 5) for x in losses]}; launches per e4m3 step {want['1']}")
    log("  the warm-up step's slabs (e4m3) and the first 16-bit step's, layer by layer: "
        + "; ".join(f"{dt} max|dS| {mx:.3e}, {z * 100:.2f}% of the band zero"
                    for dt, mx, z in slabs))
    log(f"  warm-up gradients vs the oracle's attention (logged, not held): wq leaves worst "
        f"{worst['wq'][1]} rel_err {worst['wq'][0]:.2e}; the other leaves worst "
        f"{worst['other'][1]} rel_err {worst['other'][0]:.2e}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"e4m3 dS training path: losses must be finite and fall: {losses}")
    torch.cuda.empty_cache()
    return dict(model=model, state=state, step=step, tokens=tokens, launches=launches,
                step_ms=step_ms["1"], step_ms_16=step_ms["0"], losses=losses,
                grad_err_wq=worst["wq"][0], grad_err_other=worst["other"][0], slabs=slabs)


def phase_resident_training(oracle) -> dict:
    """The S-resident tier: the same model with ``attn_save_scores=True``
    (every head keeps its 1 GiB-per-layer S residual)."""
    from ffpa_attn_tpu_torch.models import ModelConfig

    cfg = ModelConfig(**TRAIN, attn_save_scores=True)
    return _train_and_hold(cfg, "S-resident training path", _s_resident_launches(cfg.n_layers),
                           TRAIN_STEPS, oracle)


def phase_partial_residency(oracle) -> dict:
    """Auto residency under a 768 MiB S budget: by the JAX package's formula
    (128 MiB per head, 192 MiB kept for the other heads' handoff slabs,
    whole GQA groups) 4 of the 8 heads keep their S residual."""
    import os

    from ffpa_attn_tpu_torch.models import ModelConfig
    from ffpa_attn_tpu_torch.ops.attention import StaticArgs, _resident_head_count

    cfg = ModelConfig(**TRAIN, attn_save_scores=None)
    os.environ["FFPA_TORCH_SCORES_RESIDUAL_LIMIT_BYTES"] = str(PARTIAL_LIMIT)
    try:
        b, hq, hkv, d = 1, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = torch.empty((b, hq, TRAIN_N, d), dtype=torch.bfloat16, device="meta")
        kv = torch.empty((b, hkv, TRAIN_N, d), dtype=torch.bfloat16, device="meta")
        m = _resident_head_count(StaticArgs(scale=d ** -0.5, is_causal=True, dropout_p=0.0,
                                            fwd_config=None), q, kv, kv, None)
        log(f"partial residency: FFPA_TORCH_SCORES_RESIDUAL_LIMIT_BYTES={PARTIAL_LIMIT}: "
            f"{m} of {hq} heads resident")
        if m != 4:
            fail(f"partial residency picked m = {m}, expected 4")
        return _train_and_hold(cfg, "partial-residency training path",
                               _s_resident_launches(cfg.n_layers, heads_split=True), 1, oracle)
    finally:
        del os.environ["FFPA_TORCH_SCORES_RESIDUAL_LIMIT_BYTES"]


def phase_op_level() -> dict:
    """The repo's headline backward through the entry point a user calls:
    ``ffpa_attn_func(q, k, v, is_causal=True)`` with the default backend,
    bf16 B1 H32 N8192 D512, then ``.backward()``. The auto policy keeps
    every head's S residual (4 GiB); the launches are the S-resident
    tier's. Gradients are held in head slices of 8 (fp32 [8, N, N]
    intermediates are 2.1 GB each) against the plain versions and the fp32
    oracle's autograd; the
    backward is timed beside the same call with ``save_scores=False`` (the
    dS handoff) on the same inputs."""
    from ffpa_attn_tpu_torch import CudaBackend, ffpa_attn_func
    from ffpa_attn_tpu_torch.ops import flash_bwd, flash_fwd
    from ffpa_attn_tpu_torch.ops.attention import StaticArgs, _resident_head_count
    from ffpa_attn_tpu_torch.ops.dispatch import pick_backward_config
    from ffpa_attn_tpu_torch.ops.reference import reference_attention
    from ffpa_attn_tpu_torch.utils.profiling import band_pairs

    b, h, n, d = 1, OP_HEADS, TRAIN_N, TRAIN["head_dim"]
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(21)
    q, k, v, do = (_randn((b, h, n, d), bf, gen) for _ in range(4))
    m = _resident_head_count(StaticArgs(scale=d ** -0.5, is_causal=True, dropout_p=0.0,
                                        fwd_config=None), q, k, v, None)
    log(f"op-level main path: ffpa_attn_func causal B{b} H{h} N{n} D{d} bf16 + backward; "
        f"auto residency m = {m} of {h}")
    if m != h:
        fail(f"auto residency picked m = {m}, expected {h}")

    def fwd_bwd(save_scores=None):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = ffpa_attn_func(*leaves, is_causal=True,
                           backward_backend=CudaBackend(save_scores=save_scores))
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        o.backward(do)
        end.record()
        end.synchronize()
        return [t.grad for t in leaves], start.elapsed_time(end)

    fwd_bwd()  # warm-up
    torch.cuda.synchronize()
    launch_counts(zero=True)
    grads, _ = fwd_bwd()
    torch.cuda.synchronize()
    counts = _counts(TRAIN_KERNELS)
    want = dict(_s_resident_launches(1), dkdv=0, dq=0)
    log(f"  launches {counts}")
    if counts != want:
        fail(f"op-level launch counts {counts} != expected {want}")
    # Per row against the plain versions of the backward chain, fed the
    # forward kernel's (o, lse, S) of the same heads (a head's forward does
    # not depend on the others, so these are the op's own): an S rounded
    # to bf16 apart from the op's would flip single ulps, and at |S| ~ 8 an
    # ulp moves P by ~3 %. As a whole tensor against the fp32 oracle.
    cfg = pick_backward_config(d=d, dv=d, nq=n, nkv=n, dtype=bf)
    errs = {f"{nm}_{ref}": 0.0 for ref in ("plain", "oracle") for nm in ("dq", "dk", "dv")}
    for lo in range(0, h, 8):
        qs, ks, vs, dos = (t[:, lo:lo + 8] for t in (q, k, v, do))
        po, plse, ps = flash_fwd.flash_attention_forward(qs, ks, vs, None, scale=d ** -0.5,
                                                         is_causal=True, return_scores=True)
        pdk, pdv, pds = flash_bwd._dkdv_from_s_plain(
            qs, vs, ps, dos, plse, (dos.float() * po.float()).sum(-1), scale=d ** -0.5,
            is_causal=True, causal_offset=0, dropout_p=0.0, seed=0, softcap=0.0,
            dk_in_kernel=cfg.dkdv_dk_in_kernel)
        if pdk is None:
            pdk = flash_bwd._banded_dk_plain(pds, qs, scale=d ** -0.5, nq=n, nkv=n, hkv=8)
        pdq = flash_bwd._banded_dq_plain(pds, ks, scale=d ** -0.5, nq=n, nkv=n)
        del po, plse, ps, pds
        for nm, g, w in zip(("dq", "dk", "dv"), grads, (pdq, pdk, pdv)):
            errs[f"{nm}_plain"] = max(errs[f"{nm}_plain"], grad_row_rel(g[:, lo:lo + 8], w))
        del pdq, pdk, pdv
        sl = [t.float().requires_grad_() for t in (qs, ks, vs)]
        out = reference_attention(*sl, is_causal=True)
        want_g = torch.autograd.grad(out, sl, dos.float())
        for nm, g, w in zip(("dq", "dk", "dv"), grads, want_g):
            errs[f"{nm}_oracle"] = max(errs[f"{nm}_oracle"], rel(g[:, lo:lo + 8], w))
        del sl, out, want_g
        torch.cuda.empty_cache()
    ok = all(e < GRAD_TOL[bf] for e in errs.values()) and all(
        bool(torch.isfinite(g).all()) for g in grads)
    log("  gradients in head slices of 8, per row vs the plain versions and whole-tensor vs "
        "the fp32 oracle: " + " ".join(f"{nm} {e:.2e}" for nm, e in errs.items())
        + f" (tol {GRAD_TOL[bf]:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("op-level S-resident gradients disagree with the plain versions or the oracle")
    del grads
    flops = 2.5 * 2 * b * h * band_pairs(n, n, causal=True) * (d + d)
    times = {"resident": [], "handoff": []}
    for mode in ("resident", "handoff", "handoff", "resident", "resident", "handoff"):
        _, ms = fwd_bwd(None if mode == "resident" else False)
        times[mode].append(ms)
    med = {k_: sorted(v_)[1] for k_, v_ in times.items()}
    log(f"  backward ms (CUDA events, median of 3, interleaved): S-resident {med['resident']:.3f} "
        f"({flops / med['resident'] / 1e9:.1f} TFLOP/s) vs dS handoff (save_scores=False) "
        f"{med['handoff']:.3f} ({flops / med['handoff'] / 1e9:.1f} TFLOP/s); bwd flop = 2.5 x "
        f"the forward's over the causal band ({flops:.4g}); all "
        f"{ {k_: [round(x, 3) for x in v_] for k_, v_ in times.items()} }")
    # The S-resident backward's kernels' device time beside its wall time,
    # one profiled backward at a time: where the event times spread and
    # these do not, the spread is off the device.
    from ffpa_attn_tpu_torch.utils.profiling import device_window

    windows = []
    for _ in range(3):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = ffpa_attn_func(*leaves, is_causal=True, backward_backend=CudaBackend())
        torch.cuda.synchronize()
        w = device_window(lambda o=o: o.backward(do), reps=1, warmup=0)
        windows.append((w["device_ms"], w["wall_ms"]))
        del leaves, o
    log("  S-resident backward under the profiler (device ms of its kernels, wall ms of the "
        "window), 3 backwards: " + ", ".join(f"{dv:.3f} / {wl:.3f}" for dv, wl in windows))
    torch.cuda.empty_cache()
    return dict(ms=med, tflops={k_: flops / v_ / 1e9 for k_, v_ in med.items()})


def phase_decode_grad() -> None:
    """One GQA decode call under autograd at the serving shape (Hq8/Hkv4,
    Nq1, Nkv 4224, D512, the validity bias): the forward keeps its fp32
    score residual, and dq / dk / dv hold against the fp32 oracle's
    autograd."""
    from ffpa_attn_tpu_torch import ffpa_attn_func
    from ffpa_attn_tpu_torch.ops import decode
    from ffpa_attn_tpu_torch.ops.reference import (
        DEFAULT_MASK_VALUE, expand_kv_heads, reference_attention,
    )

    b, hq, hkv, d = 1, SLICE["n_heads"], SLICE["n_kv_heads"], SLICE["head_dim"]
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(31)
    q, do = _randn((b, hq, 1, d), bf, gen), _randn((b, hq, 1, d), bf, gen)
    k, v = _randn((b, hkv, MAX_LEN, d), bf, gen), _randn((b, hkv, MAX_LEN, d), bf, gen)
    cols = torch.arange(MAX_LEN, device="cuda")
    bias = torch.where(cols <= PROMPT, 0.0, DEFAULT_MASK_VALUE).float()[None, None, None]
    emits = decode._decode_emits_scores(q, k, bias, 0.0, (-1, -1))
    if not emits:
        fail("the decode call under autograd does not keep its score residual")
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    decode._decode_forward.launches = 0
    o = ffpa_attn_func(*leaves, attn_mask=bias, enable_gqa=True)
    o.backward(do)
    torch.cuda.synchronize()
    launches = decode._decode_forward.launches
    sl = [t.float().requires_grad_() for t in (q, k, v)]
    out = reference_attention(sl[0], expand_kv_heads(sl[1], hq), expand_kv_heads(sl[2], hq), bias)
    want = torch.autograd.grad(out, sl, do.float())
    errs = {nm: grad_row_rel(t.grad, w) for nm, t, w in zip(("dq", "dk", "dv"), leaves, want)}
    nbytes = b * hkv * hq // hkv * MAX_LEN * 4
    ok = launches == 1 and all(e < GRAD_TOL[bf] for e in errs.values())
    log(f"decode gradients (GQA Hq{hq}/Hkv{hkv} Nq1 Nkv{MAX_LEN} D{d}, validity bias): score "
        f"residual kept ({nbytes} B), decode launches {launches}; vs the fp32 oracle "
        + " ".join(f"{nm} {e:.2e}" for nm, e in errs.items())
        + f" (tol {GRAD_TOL[bf]:g}, per row) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("decode gradients disagree with the oracle")


def phase_windowed() -> dict:
    """The recompute tier: the windowed model, depth cut to L2 for time."""
    from ffpa_attn_tpu_torch.models import (
        ModelConfig, adamw, make_train_step, params_from_jax, random_params,
    )

    cfg = ModelConfig.mistral_like(sliding_window=WINDOW, **dict(TRAIN, n_layers=WINDOW_LAYERS))
    model = params_from_jax(random_params(cfg, seed=0), cfg)
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (1, TRAIN_N + 1))).cuda()
    opt = adamw(1e-4)
    step = make_train_step(cfg, opt)
    per_step = {"flash_fwd": cfg.n_layers, "dkdv": cfg.n_layers, "dq": cfg.n_layers,
                "banded_dq": 0, "dkdv_from_s": 0, "banded_dk": 0}
    _, losses, times, launches = _train_steps(model, opt.init(list(model.parameters())), step,
                                              tokens, WINDOW_STEPS, per_step, "windowed")
    log(f"windowed path (mistral_like window {WINDOW}, L{cfg.n_layers}, N{TRAIN_N}): step ms "
        f"{[round(t, 2) for t in times]}, losses {[round(x, 5) for x in losses]}, launches per "
        f"step {per_step}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"windowed losses must be finite: {losses}")
    return dict(launches=launches, step_ms=times[-1])


def phase_tiny_training() -> None:
    """Two train steps of a tiny model on the card and on the CPU from the
    same weights: the first step's gradients agree leaf by leaf within the
    bf16 gradient tolerance and both losses within LOSS_TOL."""
    from ffpa_attn_tpu_torch.models import (
        ModelConfig, adamw, make_train_step, params_from_jax, random_params,
    )

    tiny = ModelConfig(vocab_size=64, d_model=64, n_layers=1, n_heads=2, n_kv_heads=1,
                       head_dim=320, max_seq_len=256)
    params = random_params(tiny, seed=2)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 64, (1, 129)))
    losses, grads = {}, {}
    for dev in ("cuda", "cpu"):
        model = params_from_jax(params, tiny, device=dev)
        opt = adamw(1e-3)
        state, step = opt.init(list(model.parameters())), make_train_step(tiny, opt, device=dev)
        losses[dev] = []
        for i in range(2):
            state, loss = step(model, state, tokens)
            losses[dev].append(float(loss))
            if i == 0:
                grads[dev] = [(name, p.grad.detach().cpu()) for name, p in
                              model.named_parameters()]
    err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    gerr, gname = max(((rel(g, og), name) for (name, g), (_, og) in
                       zip(grads["cuda"], grads["cpu"])),
                      key=lambda e: e[0] if math.isfinite(e[0]) else math.inf)
    ok = err < LOSS_TOL and gerr < GRAD_TOL[torch.bfloat16]
    log(f"  tiny model two steps: card {losses['cuda']} cpu {losses['cpu']} (rel {err:.2e}, "
        f"tol {LOSS_TOL:g}); first-step gradients worst leaf {gname} rel_err {gerr:.2e} of its "
        f"max|g| (tol {GRAD_TOL[torch.bfloat16]:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("tiny model: training on the card differs from the CPU")


def phase_checkpoint() -> None:
    """Train-state checkpoints on the card: the tiny model of
    ``phase_tiny_training`` takes one step, is saved, and is restored into a
    fresh model (other weights) and optimizer state; one more step on each
    gives bit-equal losses and parameters."""
    import tempfile

    from ffpa_attn_tpu_torch.models import (
        ModelConfig, adamw, make_train_step, params_from_jax, random_params,
        restore_train_state, save_train_state,
    )

    t0 = time.perf_counter()
    tiny = ModelConfig(vocab_size=64, d_model=64, n_layers=1, n_heads=2, n_kv_heads=1,
                       head_dim=320, max_seq_len=256)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 64, (1, 129)))
    opt = adamw(1e-3)
    step = make_train_step(tiny, opt)
    model = params_from_jax(random_params(tiny, seed=2), tiny)
    state, _ = step(model, opt.init(list(model.parameters())), tokens)
    fresh = params_from_jax(random_params(tiny, seed=5), tiny)
    with tempfile.TemporaryDirectory() as d:
        save_train_state(d, 1, model, state)
        fresh, fstate, fstep = restore_train_state(d, fresh, opt.init(list(fresh.parameters())))
    state, la = step(model, state, tokens)
    fstate, lb = step(fresh, fstate, tokens)
    same = [torch.equal(a, b) for a, b in zip(model.parameters(), fresh.parameters())]
    ok = fstep == 1 and torch.equal(la, lb) and all(same)
    log(f"  checkpoint: step 1 saved and restored into a fresh model; the next step's loss "
        f"{float(la):.6f} / {float(lb):.6f}, bit-equal {torch.equal(la, lb)}, parameters "
        f"bit-equal {sum(same)} of {len(same)}; {time.perf_counter() - t0:.1f} s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("checkpoint: the restored run does not continue the saved one bit for bit")


def packed_inputs(dtype, d: int = TRAIN["head_dim"]) -> dict:
    """The packed-training inputs: the bench_train token budget packed as
    PACK_LENS documents, q, k, v and dO of head dim ``d`` from numpy seed 0,
    on the card."""
    rng = np.random.default_rng(0)
    t = sum(PACK_LENS)
    hq, hkv = TRAIN["n_heads"], TRAIN["n_kv_heads"]
    q, k, v, do = (torch.from_numpy(rng.standard_normal((t, h, d), dtype=np.float32)).to(
        "cuda", dtype) for h in (hq, hkv, hkv, hq))
    cu = torch.tensor(np.cumsum([0] + PACK_LENS), dtype=torch.int32, device="cuda")
    return dict(q=q, k=k, v=v, do=do, cu=cu)


def _packed_call(x, sinks=None, **kw) -> dict:
    """``ffpa_attn_varlen_func`` over the packing under autograd, then
    ``.backward(dO)``: o, lse and the gradients of q, k, v (and sinks)."""
    from ffpa_attn_tpu_torch import ffpa_attn_varlen_func

    leaves = [x[n].detach().requires_grad_() for n in ("q", "k", "v")]
    if sinks is not None:
        sinks = sinks.detach().requires_grad_()
    n = max(PACK_LENS)
    o, lse = ffpa_attn_varlen_func(*leaves, x["cu"], x["cu"], n, n, causal=True,
                                   enable_gqa=True, return_lse=True, sinks=sinks, **kw)
    o.backward(x["do"])
    return dict(o=o.detach(), lse=lse, grads=[t.grad for t in leaves],
                dsinks=None if sinks is None else sinks.grad)


def _dense_path_grads(x) -> list:
    """The per-segment dense path: ``ffpa_attn_func`` over each document
    ([1, H, L, D], causal, GQA) followed by ``.backward()`` (the ported
    dense kernels), the gradients packed back to [T, H, D]."""
    from ffpa_attn_tpu_torch import ffpa_attn_func

    cu = [0] + np.cumsum(PACK_LENS).tolist()
    parts = [[], [], []]
    for s0, s1 in zip(cu[:-1], cu[1:]):
        leaves = [x[n][s0:s1].transpose(0, 1)[None].contiguous().requires_grad_()
                  for n in ("q", "k", "v")]
        o = ffpa_attn_func(*leaves, is_causal=True, enable_gqa=True)
        o.backward(x["do"][s0:s1].transpose(0, 1)[None])
        for part, t in zip(parts, leaves):
            part.append(t.grad[0].transpose(0, 1))
    return [torch.cat(p) for p in parts]


def phase_packed_training() -> dict:
    """Packed training at op level, the main path of the varlen backward:
    ``ffpa_attn_varlen_func`` under autograd then ``.backward(dO)`` over 8
    documents packed into 8192 tokens (H8/4 D512 causal), in bf16 and fp16:
    1 varlen-forward, 1 varlen-dK/dV and 1 varlen-dQ launch and no other per
    call; dq, dk, dv per row against the plain chain on the same (o, lse)
    and against the per-segment dense path. Then the gpt_oss_like features
    (window (128, -1), sinks) with dsinks against the plain chain, the bf16
    call's forward + backward times, and one bf16 call at D1024 (the
    forward, dK/dV and dQ on their cluster routes, one 64 x 64 walk built by
    the forward and read by the backward) with its launches counted alone
    and its gradients against the plain chain."""
    from ffpa_attn_tpu_torch.ops import varlen
    from ffpa_attn_tpu_torch.ops.attention import sink_grad
    from ffpa_attn_tpu_torch.utils.profiling import varlen_counts

    t, n = sum(PACK_LENS), max(PACK_LENS)
    hq, hkv, d = TRAIN["n_heads"], TRAIN["n_kv_heads"], TRAIN["head_dim"]
    want = dict.fromkeys(launch_counts(), 0)
    want.update(varlen_fwd=1, varlen_dkdv=1, varlen_dq=1)
    log(f"packed training (op level): ffpa_attn_varlen_func + backward over {len(PACK_LENS)} "
        f"documents {PACK_LENS} = T{t}, H{hq}/{hkv} D{d} causal")
    out = {}
    for dtype in (torch.bfloat16, torch.float16):
        x = packed_inputs(dtype)
        meta = varlen._call_metadata(x["cu"], x["cu"], t, t, "cuda")
        for sinks, kw in ((None, {}), (torch.from_numpy(
                np.random.default_rng(1).standard_normal(hq).astype(np.float32)).cuda(),
                dict(window_size=(128, -1)))):
            label = f"{str(dtype)[6:]}{' gpt_oss_like' if sinks is not None else ''}"
            torch.cuda.synchronize()
            launch_counts(zero=True)
            r = _packed_call(x, sinks=sinks, **kw)
            torch.cuda.synchronize()
            counts = launch_counts()
            if counts != want:
                fail(f"packed training {label}: launch counts {counts} != expected {want}")
            window = kw.get("window_size", (-1, -1))
            plain = varlen._varlen_backward_plain(x["q"], x["k"], x["v"], r["o"], r["lse"],
                                                  x["do"], meta, scale=d ** -0.5, causal=True,
                                                  window=window)
            errs = {f"{nm}_plain": grad_row_rel(g, w)
                    for nm, g, w in zip(("dq", "dk", "dv"), r["grads"], plain)}
            del plain
            if sinks is None:
                dense = _dense_path_grads(x)
                errs.update({f"{nm}_dense": grad_row_rel(g, w)
                             for nm, g, w in zip(("dq", "dk", "dv"), r["grads"], dense)})
                del dense
            else:
                po, plse = varlen._varlen_forward_plain(x["q"], x["k"], x["v"], meta,
                                                        scale=d ** -0.5, causal=True,
                                                        window=window)
                po, plse = varlen._varlen_apply_sinks(po, plse, sinks)
                want_ds = sink_grad(x["do"].transpose(0, 1), po.transpose(0, 1), plse, sinks,
                                    head_axis=0)
                errs["dsinks"] = rel(r["dsinks"], want_ds)
                del po, plse
            tol = GRAD_TOL[dtype]
            ok = all(e < tol for e in errs.values()) and all(
                bool(torch.isfinite(g).all()) for g in r["grads"])
            log(f"  {label}: launches {counts}; " + " ".join(f"{k_} {e:.2e}"
                                                             for k_, e in errs.items())
                + f" (tol {tol:g}, per row; dsinks of its max) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"packed training {label}: gradients disagree")
            out.setdefault("errs", {})[label] = errs
            del r
            torch.cuda.empty_cache()
        if dtype == torch.bfloat16:
            out["x"] = x
        del x, meta

    # Forward + backward times of the bf16 call (CUDA events, median of 3).
    x = out["x"]
    fwd_flops = varlen_counts(PACK_LENS, PACK_LENS, hq=hq, hkv=hkv, d=d, dv=d, causal=True)[0]

    def fwd_bwd(x_):
        from ffpa_attn_tpu_torch import ffpa_attn_varlen_func

        leaves = [x_[nm].detach().requires_grad_() for nm in ("q", "k", "v")]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        o = ffpa_attn_varlen_func(*leaves, x_["cu"], x_["cu"], n, n, causal=True,
                                  enable_gqa=True)
        ev[1].record()
        o.backward(x_["do"])
        ev[2].record()
        ev[2].synchronize()
        return ev[0].elapsed_time(ev[2]), ev[1].elapsed_time(ev[2])

    fwd_bwd(x)  # warm-up
    runs = [fwd_bwd(x) for _ in range(3)]
    total = sorted(r_[0] for r_ in runs)[1]
    bwd = sorted(r_[1] for r_ in runs)[1]
    out.update(fwd_bwd_ms=total, bwd_ms=bwd, bwd_tflops=2.5 * fwd_flops / bwd / 1e9,
               fwd_bwd_tflops=3.5 * fwd_flops / total / 1e9,
               launches={"varlen_dkdv": 1, "varlen_dq": 1})
    log(f"  times (CUDA events, median of 3): forward + backward {total:.3f} ms "
        f"({out['fwd_bwd_tflops']:.1f} TFLOP/s at 3.5 x the forward's flop), backward "
        f"{bwd:.3f} ms ({out['bwd_tflops']:.1f} TFLOP/s at 2.5 x; forward flop over the band "
        f"{fwd_flops:.4g}); all {[[round(a, 3), round(b, 3)] for a, b in runs]}")

    # Above D512: the same packing at D1024, where the forward, dK/dV and
    # dQ take their clusters and the call builds one 64 x 64 walk.
    from ffpa_attn_tpu_torch.ops.config import varlen_dkdv_plan, varlen_dq_plan, varlen_fwd_plan

    wd = 1024
    routes = (varlen_fwd_plan(wd, wd).route, varlen_dkdv_plan(wd, wd).route,
              varlen_dq_plan(wd, wd).route)
    if routes != ("wgmma_cluster",) * 3:
        fail(f"the varlen forward, dK/dV or dQ at D{wd} does not take the cluster route: "
             f"{routes}")
    x = packed_inputs(torch.bfloat16, d=wd)
    meta = varlen._call_metadata(x["cu"], x["cu"], t, t, "cuda")
    torch.cuda.synchronize()
    walks, walk = [], varlen._walk_schedule

    def counted_walk(*args, **kwargs):
        walks.append(args[2])
        return walk(*args, **kwargs)

    varlen._walk_schedule = counted_walk
    try:
        launch_counts(zero=True)
        r = _packed_call(x)
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        varlen._walk_schedule = walk
    if counts != want:
        fail(f"packed training D{wd}: launch counts {counts} != expected {want}")
    if walks != [64]:
        fail(f"packed training D{wd}: the call built {len(walks)} walks (rows {walks}), not "
             f"one 64 x 64 walk")
    plain = varlen._varlen_backward_plain(x["q"], x["k"], x["v"], r["o"], r["lse"], x["do"],
                                          meta, scale=wd ** -0.5, causal=True)
    errs = {nm: grad_row_rel(g, w) for nm, g, w in zip(("dq", "dk", "dv"), r["grads"], plain)}
    del plain, r
    tol = GRAD_TOL[torch.bfloat16]
    ok = all(e < tol for e in errs.values())
    log(f"  bf16 D{wd} (forward, dK/dV and dQ on their clusters; one walk of 64 x 64 "
        f"tiles): launches {counts}; "
        + " ".join(f"{k_}_plain {e:.2e}" for k_, e in errs.items())
        + f" (tol {tol:g}, per row) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"packed training D{wd}: gradients disagree")
    fwd_bwd(x)  # warm-up
    runs = [fwd_bwd(x) for _ in range(3)]
    log(f"  bf16 D{wd} times (CUDA events, median of 3): forward + backward "
        f"{sorted(r_[0] for r_ in runs)[1]:.3f} ms, backward {sorted(r_[1] for r_ in runs)[1]:.3f}"
        f" ms; all {[[round(a, 3), round(b, 3)] for a, b in runs]}")
    out["wide"] = dict(x=x, launches={n_: counts[n_] for n_ in
                                      ("varlen_fwd", "varlen_dkdv", "varlen_dq")},
                       errs=errs)
    torch.cuda.empty_cache()
    return out


def _json_lines(stdout: str) -> list:
    return [json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")]


def _run(cmd, label: str, timeout: int, env=None) -> tuple:
    """``cmd`` in a subprocess (killed at ``timeout``): (its JSON lines, its
    wall seconds); fails on a non-zero exit code with its stderr's tail."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{label}: rc {proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return _json_lines(proc.stdout), dt


@torch.inference_mode()
def _window_stream_logits(model, prompts, toks, page=WINDOW_PAGE, quantized=False) -> tuple:
    """Teacher-forced on the token stream ``toks`` [B, gen]: per decode step,
    (the paged step's logits, the dense shared-row step's logits), both
    after one packed prefill, over pools of ``page`` rows a page (int8 with
    ``quantized``); and the paged pools at the end."""
    from ffpa_attn_tpu_torch.models import init_kv_cache, pack_prompts, prefill_packed
    from ffpa_attn_tpu_torch.models.serving import _batched_decode_step, _paged_decode_step
    from ffpa_attn_tpu_torch.ops.paged import PagedKVCache, fill_from_prefill

    cfg, dev = model.cfg, prompts[0].device
    lens = [int(p.shape[0]) for p in prompts]
    base = max(lens)
    packed, cu = pack_prompts(prompts, sum(lens))
    cache = init_kv_cache(cfg, len(prompts), SERVE_MAX_LEN, device=dev)
    _, cache = prefill_packed(model, packed, cu, base, cache)
    pools = [fill_from_prefill(
        PagedKVCache.alloc(len(lens), SERVE_MAX_LEN, cfg.n_kv_heads, cfg.head_dim, page,
                           dtype=cfg.torch_dtype, quantized=quantized, device=dev),
        c["k"][:, :, :base], c["v"][:, :, :base], lens) for c in cache]
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    steps = []
    for t in range(toks.shape[1] - 1):
        paged, pools = _paged_decode_step(model, pools, toks[:, t])
        dense, cache = _batched_decode_step(model, cache, lens_t, t, toks[:, t], base)
        steps.append((paged.float(), dense.float()))
    return steps, pools


def phase_bench_cli(model) -> dict:
    """The bench CLI. First, in this process on the main path's weights, the
    windowed paged leg (window 256, page 128, the serving workload):
    ``serve_batch_paged`` (4 varlen forward and 4 x 127 paged decode
    launches) beside ``serve_batch``, every step's logits teacher-forced on
    the paged stream held to the dense step's (PAGED_TOL of max|logit|, the
    same argmax wherever the top two are more than twice that apart), and
    the paged kernel's device ms at the last step with and without the
    window; MHA decode at the bench's default shape, the kernel beside the
    fp32 composite the JAX package's route would take. Then the commands a
    user runs, each in a subprocess, after this process's last profiled
    window (in an H100 run with the subprocesses first, this process's
    profiler then recorded only part of its device events): ``python -m
    ffpa_attn_tpu_torch.bench`` over its ten cases, fwd and bwd (H8 N4096,
    cut from H32 N8192 for run time), each row gated, with port launches and
    its SDPA backend; the headline line (``cli._headline``, B1 H32 N8192
    D512 bf16); the ``serve_paged_window`` and ``speculative`` legs
    (``--e2e``, one subprocess each)."""
    import os

    from ffpa_attn_tpu_torch import ffpa_attn_func
    from ffpa_attn_tpu_torch.cli import _e2e
    from ffpa_attn_tpu_torch.cli._bench import CASES
    from ffpa_attn_tpu_torch.models import serve_batch, serve_batch_paged
    from ffpa_attn_tpu_torch.ops import paged
    from ffpa_attn_tpu_torch.ops.reference import reference_attention
    from ffpa_attn_tpu_torch.utils.profiling import bound_ms, paged_decode_counts

    t_phase = time.perf_counter()
    # The windowed paged leg in this process, on the main path's weights.
    cfg, dev = model.cfg, torch.device("cuda")
    wmodel = _e2e.shared_model(model, sliding_window=SERVE_WINDOW, max_seq_len=SERVE_MAX_LEN)
    prompts = _e2e.serve_prompts(SERVE_B, SERVE_PROMPT, cfg.vocab_size, dev)
    lens = [int(p.shape[0]) for p in prompts]
    if lens != SERVE_LENS:
        fail(f"serving prompt lengths {lens} != {SERVE_LENS}")
    toks, dt_window, counts = _e2e.timed_call(
        lambda: serve_batch_paged(wmodel, prompts, SERVE_GEN, SERVE_MAX_LEN,
                                  page_size=WINDOW_PAGE), dev)
    want = {"varlen_fwd": cfg.n_layers, "paged_decode": cfg.n_layers * (SERVE_GEN - 1)}
    window_tok_s = SERVE_B * SERVE_GEN / dt_window
    log(f"windowed paged serving (W{SERVE_WINDOW}, page {WINDOW_PAGE}, B{SERVE_B} prompts "
        f"{SERVE_LENS}, {SERVE_GEN} tokens): {window_tok_s:.1f} tokens/s, launches {counts}")
    if counts != want:
        fail(f"windowed paged serving: launch counts {counts} != expected {want}")
    dense_toks = serve_batch(wmodel, prompts, SERVE_GEN, SERVE_MAX_LEN)
    steps, pools = _window_stream_logits(wmodel, prompts, toks)
    worst, ties, missed, replayed = 0.0, 0, [], 0
    for t, (lp, ld) in enumerate(steps):
        worst = max(worst, row_rel(lp, ld))
        replayed += int(torch.equal(lp.argmax(-1), toks[:, t + 1]))
        top = ld.topk(2, dim=-1).values
        tie = (top[:, 0] - top[:, 1]) <= 2 * PAGED_TOL * ld.abs().amax(-1)
        ties += int(tie.sum())
        bad = (lp.argmax(-1) != ld.argmax(-1)) & ~tie
        missed += [(t, int(b_)) for b_ in bad.nonzero()[:, 0].tolist()]
    same = int((toks == dense_toks).all(dim=0).cumprod(0).sum())
    ok = worst < PAGED_TOL and not missed
    log(f"  paged vs dense steps, teacher-forced on the paged stream: {len(steps)} steps x "
        f"B{SERVE_B}, worst per-row logits {worst:.2e} (tol {PAGED_TOL:g} of max|logit|), argmax "
        f"missed at {missed}, {ties} near ties (logged); the paged steps give the paged stream's "
        f"next token at {replayed} of {len(steps)} steps; free-running serve_batch and "
        f"serve_batch_paged agree for {same} of {SERVE_GEN} tokens {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("windowed serving: the paged steps disagree with the dense steps")

    # The paged kernel at the last step, with and without the window.
    gen = torch.Generator(device="cuda").manual_seed(30)
    q = _randn((SERVE_B, cfg.n_heads, 1, cfg.head_dim), torch.bfloat16, gen)
    names = ("paged_tma_kernel", "split_merge_kernel")
    step_lens = pools[0].lens.tolist()
    walk = {}
    for label, wl in (("windowed", SERVE_WINDOW), ("unwindowed", -1)):
        def call(wl=wl):
            return paged.paged_decode_attention(q, pools[0], scale=cfg.head_dim ** -0.5,
                                                window_left=wl)
        live = [min(n, wl + 1) if wl >= 0 else n for n in step_lens]
        bms = bound_ms(*paged_decode_counts(live, hq=cfg.n_heads, hkv=cfg.n_kv_heads,
                                            d=cfg.head_dim, dv=cfg.head_dim))[0]
        with torch.inference_mode():  # the pools are inference tensors
            kms = _above_bound(f"paged decode ({label})", _kernel_timed(call, names, 100), bms,
                               lambda call=call: _kernel_timed(call, names, 100))
        walk[label] = (*kms, bms)
    log(f"  paged decode at the last step (lens {step_lens}): windowed {walk['windowed'][0]:.4f} "
        f"ms [{walk['windowed'][1]:.4f}] (bound {walk['windowed'][2]:.4f}) vs unwindowed "
        f"{walk['unwindowed'][0]:.4f} ms [{walk['unwindowed'][1]:.4f}] (bound "
        f"{walk['unwindowed'][2]:.4f}); device ms of the kernels [CUDA-event ms a call]")
    del pools, steps, wmodel

    # MHA decode at the bench's default shape: the kernel (ffpa_attn_func)
    # and the fp32 composite.
    qd = _randn((1, 32, 1, 512), torch.bfloat16, gen)
    kd, vd = (_randn((1, 32, 8192, 512), torch.bfloat16, gen) for _ in range(2))
    launch_counts(zero=True)
    got = ffpa_attn_func(qd, kd, vd)
    torch.cuda.synchronize()
    routed = _launched()
    want_o = reference_attention(qd, kd, vd)
    err = row_rel(got, want_o)
    mha = {name: _timed(fn, 20) for name, fn in (
        ("kernel", lambda: ffpa_attn_func(qd, kd, vd)),
        ("composite", lambda: reference_attention(qd, kd, vd)))}
    mha_bound = bound_ms(*paged_decode_counts([8192], hq=32, hkv=32, d=512, dv=512))[0]
    mha["kernel"] = _above_bound("MHA decode", mha["kernel"], mha_bound,
                                 lambda: _timed(lambda: ffpa_attn_func(qd, kd, vd), 20))
    log(f"  MHA decode B1 H32 Nkv8192 D512: ffpa_attn_func launches {routed}, per-row error vs "
        f"the fp32 composite {err:.2e} (tol {BF16_TOL:g}); device ms [CUDA-event ms]: kernel "
        f"{mha['kernel'][0]:.4f} [{mha['kernel'][1]:.4f}], composite {mha['composite'][0]:.4f} "
        f"[{mha['composite'][1]:.4f}]; bound {mha_bound:.4f}")
    if routed != {"decode": 1} or err >= BF16_TOL:
        fail("MHA decode did not take the decode kernel, or disagrees with the composite")
    del qd, kd, vd

    # The commands a user runs, each in a subprocess of its own.
    torch.cuda.empty_cache()  # the subprocesses share the card
    cmd = [sys.executable, "-m", "ffpa_attn_tpu_torch.bench", "--cases", *CASES,
           "--directions", "fwd", "bwd", "--B", "1", "--H", str(BENCH_H), "--N", str(BENCH_N),
           "--D", "512", "--json"]
    log(f"bench CLI: python {' '.join(cmd[1:])} (H{BENCH_H} N{BENCH_N}: cut from the default "
        f"H32 N8192 for run time)")
    rows, dt = _run(cmd, "bench CLI", 900)
    if len(rows) != 2 * len(CASES):
        fail(f"bench CLI: {len(rows)} rows, expected {2 * len(CASES)}")
    for r in rows:
        ok = r["verified"] and bool(r["launches"]) and bool(r["sdpa_backend"])
        route = r["launches"] if r["direction"] == "fwd" else (
            f"{r['launches']} (backward {r['backward_launches']})")
        dev = f"device {r['ffpa_device_ms']:.4f}, outside the port's kernels " + (
            "not measured" if r["non_port_device_ms"] is None else
            f"{r['non_port_device_ms']:.4f}")
        log(f"  {r['case']:>14} {r['direction']}: FFPA {r['ffpa_ms']:.4f} ms ({dev}) "
            f"vs SDPA {r['sdpa_ms']:.4f} ms ({r['baseline']}; torch backend {r['sdpa_backend']}; "
            f"{ {k: round(v, 4) for k, v in r['baseline_ms'].items()} }) {r['speedup']:.2f}x, "
            f"bound {r['bound_ms']:.4f} ({r['bound_by']}); route {route}; gate "
            f"{'on' if r['verified'] else 'OFF'} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"bench CLI row {r['case']} {r['direction']}: gate off, no port launch or no "
                 f"SDPA backend")
    log(f"  {len(rows)} rows in {dt:.1f} s")

    lines, dt = _run([sys.executable, "-m", "ffpa_attn_tpu_torch.cli._headline"], "headline", 600)
    head = lines[-1] if lines else {}
    log(f"headline ({dt:.1f} s): {json.dumps(head)}")
    if not (head.get("value", 0) > 0 and head.get("vs_baseline", 0) > 0
            and head.get("bwd_causal_tflops", 0) > 0):
        fail(f"the headline line lacks a forward or a causal backward number: {head}")

    legs = "serve_paged_window,speculative"
    lines, dt = _run([sys.executable, "-m", "ffpa_attn_tpu_torch.bench", "--e2e"], "e2e legs",
                     900, env=dict(os.environ, FFPA_TORCH_E2E_ONLY=legs))
    for ln in lines:
        log(f"  e2e: {json.dumps(ln)}")
    metrics = [ln.get("metric") for ln in lines]
    if metrics != ["serve_paged_window_tokens_per_s", "speculative_tokens_per_s"] or any(
            "error" in ln or not ln.get("value", 0) > 0 for ln in lines):
        fail(f"--e2e {legs}: {lines}")
    log(f"  e2e legs {legs} in {dt:.1f} s")

    torch.cuda.empty_cache()
    log(f"  phase {time.perf_counter() - t_phase:.1f} s")
    return dict(rows=rows, headline=head, e2e=lines, window_tok_s=window_tok_s, paged_walk=walk,
                mha_decode=mha)


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


def _hold(label: str, pairs: dict, dtype=torch.bfloat16) -> float:
    """Each kernel output against its plain version per row (grad_row_rel)
    at GRAD_TOL; fails on a miss. Returns the largest max|err|."""
    tol = GRAD_TOL[dtype]
    errs = {n: grad_row_rel(g, w) for n, (g, w) in pairs.items()}
    ok = all(e < tol for e in errs.values()) and all(
        bool(torch.isfinite(g).all()) for g, _ in pairs.values())
    log(f"  bwd {label:<22} " + " ".join(f"{n} {e:.2e}" for n, e in errs.items())
        + f" (tol {tol:g}, per row) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"backward kernel disagrees with its plain version: {label}")
    return max(max_abs(g, w) for g, w in pairs.values())


def _kernel_timed(fn, names: tuple, reps: int, setup=None) -> tuple:
    """(device ms per call of the kernels whose name holds one of
    ``names``, from the profiler; CUDA-event ms per call of ``fn`` less that
    of ``setup``, the part of ``fn`` that only prepares the kernel's
    inputs). Fails where no kernel of ``names`` ran."""
    from ffpa_attn_tpu_torch.utils.profiling import cuda_ms, device_window

    w = device_window(fn, reps=reps, warmup=1)
    if isinstance(names, str):
        raise TypeError("names is a tuple of kernel-name substrings")
    dev = sum(ms for name, ms in w["by_kernel"].items() if any(n in name for n in names)) / reps
    if dev <= 0.0:
        fail(f"the profiler saw no kernel named like {names}; it saw {sorted(w['by_kernel'])}")
    ev = cuda_ms(fn, reps=reps) - (cuda_ms(setup, reps=reps) if setup is not None else 0.0)
    return dev, ev


def _hold_parts(tag: str, total: tuple, retime, time_parts) -> tuple:
    """(total, parts) of a split-KV call: ``total`` its (device, CUDA-event)
    ms and ``time_parts()`` its launches' device ms (walk, merge), each from
    its own profiler window. A total below 0.95 of its launches' sum means
    a window lost events or ran at another clock: the total is timed again
    once (``retime``), and the run fails if it still reads below. The
    launches are read a second time on every run and both sums logged; the
    gate reads the first alone (``tools/torch_split_parts_probe.py``
    repeats these readings on any tree)."""
    parts, again = time_parts(), time_parts()
    log(f"  {tag}: walk + merge read {sum(parts):.4f} ms (gated), again {sum(again):.4f} ms")
    if total[0] < 0.95 * sum(parts):
        first, total = total, retime()
        log(f"  {tag}: total {first[0]:.4f} ms below walk + merge {sum(parts):.4f} ms, "
            f"timed again: {total[0]:.4f} ms")
        if total[0] < 0.95 * sum(parts):
            fail(f"{tag} reads below its own launches twice: {first[0]:.4f} and "
                 f"{total[0]:.4f} ms against {sum(parts):.4f} ms")
    return total, parts


def _above_bound(name: str, kms: tuple, bms: float, retime) -> tuple:
    """``kms`` (device ms from the profiler, CUDA-event ms) of ``name``. A
    device reading below the bound ``bms`` means the profiler lost events:
    time again once with ``retime`` and fail, with both readings, if it
    stays below. Returns the reading kept."""
    if kms[0] >= bms:
        return kms
    first, kms = kms, retime()
    log(f"  {name}: device reading below the bound, timed again: device {kms[0]:.4f} ms, "
        f"CUDA events {kms[1]:.4f} ms")
    if kms[0] < bms:
        fail(f"{name} reads below its bound {bms:.4f} ms twice: device {first[0]:.4f} and "
             f"{kms[0]:.4f} ms, CUDA events {first[1]:.4f} and {kms[1]:.4f} ms")
    return kms


def _profile_step(label: str, run: dict) -> dict:
    """One training step of ``run`` under the profiler; frees the model.
    Returns the step's device ms by kernel name."""
    from ffpa_attn_tpu_torch.utils.profiling import device_window

    hold = {"state": run["state"]}

    def one_step():
        hold["state"], _ = run["step"](run["model"], hold["state"], run["tokens"])

    w = device_window(one_step, reps=1, warmup=1)
    top = sorted(w["by_kernel"].items(), key=lambda kv: -kv[1])[:8]
    log(f"  {label}: wall {w['wall_ms']:.2f} ms, device {w['device_ms']:.2f} ms, "
        f"busy {w['busy'] * 100:.1f}% (idle {(1 - w['busy']) * 100:.1f}%)")
    for kname, ms in top:
        log(f"    {ms:9.3f} ms  {kname[:100]}")
    del run["model"], run["state"], hold
    torch.cuda.empty_cache()
    return w["by_kernel"]


def training_times(training: dict, windowed: dict, resident: dict,
                   from_s_cluster_launches: int, dq_cluster_launches: int,
                   fp8_training: dict) -> tuple:
    """One step of the handoff and of the S-resident model under the
    profiler, then the backward kernels at their main-path shapes, each held
    against its plain version on the same inputs and timed beside it: dkdv
    (with the dS slab) and banded dQ at the training step's shape, dq at
    the windowed model's, the S-resident tier's from-S pass (both
    variants), its cluster route above Dv 512 (``from_s_cluster_times``;
    ``from_s_cluster_launches`` its launches in the S-resident backwards
    above D512 through ``ffpa_attn_func``), banded dK and the dQ cluster
    route above D512 (``dq_cluster_times``; ``dq_cluster_launches`` its
    launches in the windowed D1024 backward through ``ffpa_attn_func``),
    and the e4m3 dS slab's writer and reader beside the 16-bit ones
    (``fp8_ds_times``, on the e4m3 training step ``fp8_training``)."""
    import torch.nn.functional as F

    from ffpa_attn_tpu_torch.cli._bench import sdpa_backend
    from ffpa_attn_tpu_torch.ops import flash_bwd, flash_fwd
    from ffpa_attn_tpu_torch.ops.dispatch import pick_backward_config
    from ffpa_attn_tpu_torch.ops.reference import expand_kv_heads
    from ffpa_attn_tpu_torch.utils.profiling import backward_counts, bound_ms

    by_kernel = _profile_step("training step (dS handoff)", training)
    with _env(FP8_FLAG, "1"):
        fp8_by_kernel = _profile_step("training step (dS handoff, e4m3 slab)", fp8_training)
    _profile_step("training step (S-resident)", resident)

    n, b, hq, hkv, d = TRAIN_N, 1, TRAIN["n_heads"], TRAIN["n_kv_heads"], TRAIN["head_dim"]
    # The forward at the training shape: its launches in the profiled step.
    fwd_ms = sum(ms for kname, ms in by_kernel.items()
                 if any(nm in kname for nm in flash_fwd.FWD_KERNELS))
    fwd_flops = 2 * b * hq * (n * (n + 1) // 2) * (d + d)
    fwd_bytes = 2 * (2 * b * hq * n * d + 2 * b * hkv * n * d) + 4 * b * hq * n
    fb_ms, fb_by = bound_ms(fwd_flops, fwd_bytes)
    log(f"  flash_fwd at the training shape (B{b} H{hq}/{hkv} N{n} D{d} causal bf16): "
        f"{fwd_ms / TRAIN['n_layers']:.4f} ms a launch (the profiled handoff step's "
        f"{TRAIN['n_layers']} launches), bound {fb_ms:.4f} ms ({fb_by})")
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(12)
    q, do = _randn((b, hq, n, d), bf, gen), _randn((b, hq, n, d), bf, gen)
    k, v = _randn((b, hkv, n, d), bf, gen), _randn((b, hkv, n, d), bf, gen)
    scale = 1.0 / math.sqrt(d)
    cfg = pick_backward_config(d=d, dv=d, nq=n, nkv=n, dtype=bf)
    ql = q.detach().requires_grad_()
    ke = expand_kv_heads(k, hq).detach().requires_grad_()
    ve = expand_kv_heads(v, hq).detach().requires_grad_()
    rows, events = [], {}

    def row(name, replaces, launches, err, kms, pms, lms, flops, nbytes, retime):
        # kms: (device ms from the profiler, CUDA-event ms), held above the
        # bound by _above_bound.
        bms, bby = bound_ms(flops, nbytes)
        log(f"  {name}: device {kms[0]:.4f} ms, CUDA events {kms[1]:.4f} ms, bound {bms:.4f} ms "
            f"({bby})")
        kms = _above_bound(name, kms, bms, retime)
        rows.append(dict(
            name=name, route="cuda", source="ffpa_attn_tpu_torch/csrc/flash_bwd.cu",
            replaces=replaces, launches=launches, max_abs_err=err, ms=kms[0],
            plain_ms=pms[0], bound_ms=bms, bound_by=bby, library_ms=lms[0],
        ))
        events[name] = (kms[1], pms[1], lms[1])

    log("backward kernels at the training shapes (N8192), kernel vs plain and times:")
    # dkdv and banded dQ: the dS-handoff tier of the training step.
    for window, names in (((-1, -1), ("dkdv", "banded_dq")), ((WINDOW, -1), ("dq",))):
        o, lse = flash_fwd.flash_attention_forward(q, k, v, None, scale=scale, is_causal=True,
                                                   window=window)
        delta = (do.float() * o.float()).sum(-1)
        kern_kw = dict(scale=scale, is_causal=True, causal_offset=0, dropout_p=0.0, group=hq // hkv,
                       window=window)
        plain_kw = dict(is_causal=True, causal_offset=0, dropout_p=0.0, seed=0, softcap=0.0,
                        window=window, alibi=None)
        if window[0] < 0:
            sdpa_kw = dict(is_causal=True)
        else:
            r = torch.arange(n, device="cuda")
            band = (r[None, :] <= r[:, None]) & (r[None, :] >= r[:, None] - window[0])
            sdpa_kw = dict(attn_mask=band)
        out = F.scaled_dot_product_attention(ql, ke, ve, **sdpa_kw)

        def library():
            return torch.autograd.grad(out, (ql, ke, ve), do, retain_graph=True)

        backend = sdpa_backend(ql, ke, ve, **sdpa_kw)
        lib = _timed(library, 5)
        log(f"  library for {'/'.join(names)}: torch.autograd.grad through "
            f"scaled_dot_product_attention ({backend} backend, K/V heads expanded, "
            f"{'causal' if window[0] < 0 else f'band mask {window}'})")
        if "dkdv" in names:
            def run_dkdv():
                return flash_bwd._dkdv_launch(q, k, v, None, do, lse, delta, 0, cfg,
                                              grad_kv_storage_dtype=None, emit_ds=True, **kern_kw)

            def run_dkdv_plain():
                return flash_bwd._dkdv_plain(q, k, v, None, do, lse, delta, scale=scale,
                                             emit_ds=True, nq_pad=n, nkv_pad=n, **plain_kw)

            kdk, kdv, ds = run_dkdv()
            torch.cuda.synchronize()
            pdk, pdv, pds = run_dkdv_plain()
            err = _hold("dkdv_N8192_causal", {"dk": (kdk, pdk), "dv": (kdv, pdv),
                                              "ds": (ds, pds)})
            del kdk, kdv, pdk, pdv, pds
            kms = _timed(run_dkdv, 10)
            pms = _timed(run_dkdv_plain, 3, warmup=1)
            flops, nbytes = backward_counts("dkdv", b=b, hq=hq, hkv=hkv, nq=n, nkv=n, d=d, dv=d,
                                            causal=True, slab_bytes=b * hq * n * n * 2)
            row("dkdv", "ffpa_attn_tpu/ops/flash_bwd.py:194", training["launches"]["dkdv"],
                err, kms, pms, lib, flops, nbytes, lambda: _timed(run_dkdv, 10))
            rows[-1].update(dkdv_kernel_row_extras(d))
            rows[-1].update(dkdv_cluster_times())

            def run_banded():
                return flash_bwd._banded_dq_from_ds(ds, k, cfg, scale=scale, group=hq // hkv,
                                                    nq=n, nkv=n, causal_offset=0, dq_dtype=bf)

            def run_banded_plain():
                return flash_bwd._banded_dq_plain(ds, k, scale=scale, nq=n, nkv=n)

            kbq = run_banded()
            torch.cuda.synchronize()
            err = _hold("banded_dq_N8192_causal", {"dq": (kbq, run_banded_plain())})
            del kbq
            kd = ke.detach()
            kms = _timed(run_banded, 10)
            pms = _timed(run_banded_plain, 3, warmup=1)
            lms = _timed(lambda: torch.matmul(ds, kd), 10)
            log("  library for banded_dq: one dense torch.matmul of the dS slab and K")
            flops, nbytes = backward_counts("banded_dq", b=b, hq=hq, hkv=hkv, nq=n, nkv=n, d=d,
                                            dv=d, causal=True)
            log(f"  banded_dq at N{n} H{hq}/{hkv}: {kms[0]:.4f} ms, {flops / kms[0] / 1e9:.1f} "
                f"TFLOP/s (library {lms[0]:.4f} ms)")
            row("banded_dq", "ffpa_attn_tpu/ops/flash_bwd.py:1186",
                training["launches"]["banded_dq"], err, kms, pms, lms, flops, nbytes,
                lambda: _timed(run_banded, 10))
            del ds
            fp8_ds_times(row, rows, fp8_training, fp8_by_kernel, lib, dict(
                q=q, k=k, v=v, do=do, o=o, lse=lse, delta=delta, kd=ke.detach(),
                kern_kw=kern_kw, plain_kw=plain_kw))
        else:
            def run_dq():
                return flash_bwd._dq_launch(q, k, v, None, do, lse, delta, 0, cfg,
                                            grad_q_storage_dtype=None, **kern_kw)[0]

            def run_dq_plain():
                return flash_bwd._dq_plain(q, k, v, None, do, lse, delta, scale=scale,
                                           emit_dbias=False, **plain_kw)[0]

            kdq = run_dq()
            torch.cuda.synchronize()
            err = _hold(f"dq_N8192_window{window[0]}", {"dq": (kdq, run_dq_plain())})
            del kdq
            kms = _timed(run_dq, 10)
            pms = _timed(run_dq_plain, 3, warmup=1)
            flops, nbytes = backward_counts("dq", b=b, hq=hq, hkv=hkv, nq=n, nkv=n, d=d, dv=d,
                                            causal=True, window=window)
            row("dq", "ffpa_attn_tpu/ops/flash_bwd.py:647", windowed["launches"]["dq"], err, kms,
                pms, lib, flops, nbytes, lambda: _timed(run_dq, 10))
            rows[-1].update(dq_kernel_row_extras(d))
        del out
        torch.cuda.empty_cache()

    # The S-resident tier of the training step.
    fkw = dict(scale=scale, is_causal=True)
    fwd_ms = _above_bound(
        "flash_fwd (training shape)",
        _timed(lambda: flash_fwd.flash_attention_forward(q, k, v, None, **fkw), 5), fb_ms,
        lambda: _timed(lambda: flash_fwd.flash_attention_forward(q, k, v, None, **fkw), 5))
    fwd_s_ms = _timed(lambda: flash_fwd.flash_attention_forward(q, k, v, None, return_scores=True,
                                                                **fkw), 5)
    log(f"  flash_fwd at N{n} (one training layer): {fwd_ms[0]:.4f} ms [{fwd_ms[1]:.4f}] without "
        f"the S residual, {fwd_s_ms[0]:.4f} ms [{fwd_s_ms[1]:.4f}] with it")

    def fwd_library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

    fwd_lib = _timed(fwd_library, 3, warmup=1)
    log(f"  library for flash_fwd at N{n}: scaled_dot_product_attention "
        f"({sdpa_backend(q, k, v, is_causal=True, enable_gqa=True)} backend, causal, GQA) "
        f"{fwd_lib[0]:.4f} ms "
        f"[{fwd_lib[1]:.4f}]; bound {fb_ms:.4f} ms")
    fwd_train = dict(training_ms=fwd_ms[0], training_ms_with_scores=fwd_s_ms[0],
                     training_bound_ms=fb_ms, training_library_ms=fwd_lib[0])
    o, lse, s = flash_fwd.flash_attention_forward(q, k, v, None, return_scores=True, **fkw)
    delta = (do.float() * o.float()).sum(-1)
    skw = dict(scale=scale, is_causal=True, causal_offset=0, dropout_p=0.0)
    variants, slab = {}, None
    for dk_in in (cfg.dkdv_dk_in_kernel, not cfg.dkdv_dk_in_kernel):  # the rule's pick first
        c = replace(cfg, dkdv_dk_in_kernel=dk_in)
        tag = "dk_in" if dk_in else "dk_out"

        def run_from_s(c=c):
            return flash_bwd._dkdv_from_s_launch(q, v, s.clone(), do, lse, delta, 0, c,
                                                 group=hq // hkv, grad_kv_storage_dtype=None,
                                                 **skw)

        kdk, kdv, kds = run_from_s()
        torch.cuda.synchronize()
        pdk, pdv, pds = flash_bwd._dkdv_from_s_plain(q, v, s, do, lse, delta, seed=0, softcap=0.0,
                                                     dk_in_kernel=dk_in, **skw)
        pairs = {"dv": (kdv, pdv), "ds": (kds, pds)}
        if dk_in:
            pairs["dk"] = (kdk, pdk)
        err = _hold(f"from_s_{tag}_N{n}_causal", pairs)
        del pairs, pdk, pdv, pds, kdk, kdv
        if slab is None:
            slab = kds
        del kds
        kms = _kernel_timed(run_from_s, flash_bwd.FROM_S_KERNELS, 10, setup=lambda: s.clone())
        variants[dk_in] = (kms, err, run_from_s)
    log(f"  from-S variants at N{n}: dK out of kernel {variants[False][0][0]:.4f} ms "
        f"[{variants[False][0][1]:.4f}], dK in kernel {variants[True][0][0]:.4f} ms "
        f"[{variants[True][0][1]:.4f}]; the dispatch rule picks dK "
        f"{'in' if cfg.dkdv_dk_in_kernel else 'out of'} the kernel")
    kms, err, run_picked = variants[cfg.dkdv_dk_in_kernel]
    pms = _timed(lambda: flash_bwd._dkdv_from_s_plain(
        q, v, s, do, lse, delta, seed=0, softcap=0.0, dk_in_kernel=cfg.dkdv_dk_in_kernel, **skw),
        3, warmup=1)
    # No single PyTorch call computes the from-S pass; its yardstick is the
    # two dense products it contains, dO V^T and P^T dO, on the same shapes.
    p_bf = torch.exp(s.float() - lse[..., None]).to(bf)
    vd = ve.detach()
    lms = _timed(lambda: (torch.matmul(do, vd.transpose(-1, -2)),
                          torch.matmul(p_bf.transpose(-1, -2), do)), 10)
    del p_bf
    log("  yardstick for dkdv_from_s (not one library call): two dense torch.matmul, "
        "dO V^T and P^T dO")
    flops, nbytes = backward_counts("dkdv_from_s", b=b, hq=hq, hkv=hkv, nq=n, nkv=n, d=d, dv=d,
                                    causal=True, slab_bytes=s.numel() * 2,
                                    dk_in_kernel=cfg.dkdv_dk_in_kernel)
    row("dkdv_from_s", "ffpa_attn_tpu/ops/flash_bwd.py:344", resident["launches"]["dkdv_from_s"],
        err, kms, pms, lms, flops, nbytes,
        lambda: _kernel_timed(run_picked, flash_bwd.FROM_S_KERNELS, 10, setup=lambda: s.clone()))
    rows[-1].update(from_s_kernel_row_extras(d, cfg.dkdv_dk_in_kernel))
    del s, o, lse, delta
    torch.cuda.empty_cache()
    fc = from_s_cluster_times()
    row("dkdv_from_s_cluster", "ffpa_attn_tpu/ops/flash_bwd.py:344", from_s_cluster_launches,
        fc["err"], fc["kms"], fc["pms"], fc["lms"], fc["flops"], fc["nbytes"], fc["retime"])
    rows[-1].update(shape=fc["shape"], from_s_route="wgmma_cluster", registers=fc["registers"],
                    spill_bytes=fc["spill_bytes"])
    dc = dq_cluster_times()
    row("dq_cluster", "ffpa_attn_tpu/ops/flash_bwd.py:647", dq_cluster_launches, dc["err"],
        dc["kms"], dc["pms"], dc["lms"], dc["flops"], dc["nbytes"], dc["retime"])
    rows[-1].update(shape=dc["shape"], dq_route="wgmma_cluster", registers=dc["registers"],
                    spill_bytes=dc["spill_bytes"])

    def run_banded_dk():
        return flash_bwd._banded_dk_from_ds(slab, q, cfg, scale=scale, group=hq // hkv, nq=n,
                                            nkv=n, causal_offset=0, dk_dtype=bf)

    def run_banded_dk_plain():
        return flash_bwd._banded_dk_plain(slab, q, scale=scale, nq=n, nkv=n, hkv=hkv)

    kbk = run_banded_dk()
    torch.cuda.synchronize()
    err = _hold(f"banded_dk_N{n}_causal", {"dk": (kbk, run_banded_dk_plain())})
    del kbk
    kms = _timed(run_banded_dk, 10)
    pms = _timed(run_banded_dk_plain, 3, warmup=1)
    lms = _timed(lambda: torch.matmul(slab.transpose(-1, -2), q), 10)
    log("  library for banded_dk: one dense torch.matmul of the dS slab (transposed) and Q")
    flops, nbytes = backward_counts("banded_dk", b=b, hq=hq, hkv=hkv, nq=n, nkv=n, d=d, dv=d,
                                    causal=True)
    log(f"  banded_dk at N{n} H{hq}/{hkv}: {kms[0]:.4f} ms, {flops / kms[0] / 1e9:.1f} TFLOP/s "
        f"(library {lms[0]:.4f} ms)")
    row("banded_dk", "ffpa_attn_tpu/ops/flash_bwd.py:1323", resident["launches"]["banded_dk"],
        err, kms, pms, lms, flops, nbytes, lambda: _timed(run_banded_dk, 10))
    del slab
    torch.cuda.empty_cache()
    banded_op_level_times()
    dkdv_op_level_times()
    return rows, events, fwd_train


def fp8_ds_times(row, rows: list, fp8_training: dict, by_kernel: dict, lib: tuple,
                 x: dict) -> None:
    """The e4m3 dS slab's kernels. First the e4m3 instances' registers and
    spill bytes (fail on a spill) and banded dQ's plan over an e4m3 slab
    against its mirror at every D. Then, at the training shape (B1 H8/4
    N8192 D512 causal bf16), the dK/dV kernel writing the slab (dK, dV
    bit-equal to the 16-bit-slab launch, the slab within one e4m3 step of
    the plain version's) and banded dQ reading it (per row at 2e-2 against
    the plain version on the same slab), each timed beside its plain
    version and its bound (operations as the 16-bit rows; the slab at 1 B
    an element) into a ``kernels`` row through ``row``, which appends to
    ``rows``. The dK/dV row's library call is the 16-bit row's (autograd of
    SDPA, ``lib``); banded dQ's yardstick is one ``torch.matmul`` of the
    slab widened to bf16 and K, the widening copy included and timed alone
    beside it. Last, one line of four numbers: the e4m3 training step's ms,
    the device ms of the two e4m3 kernels in its profiled step
    (``by_kernel``), the slab's bytes, and dQ's RMS and worst-element error
    of a whole handoff backward with the flag set against it unset."""
    from ffpa_attn_tpu_torch.ops import flash_bwd
    from ffpa_attn_tpu_torch.ops.config import BlockConfig, banded_plan
    from ffpa_attn_tpu_torch.utils.profiling import backward_counts

    for route in ("wgmma", "wgmma_cluster"):
        a = flash_bwd.dkdv_kernel_attrs(route, torch.bfloat16, ds_bits=8)
        log(f"  dkdv {route} bf16, e4m3 slab: {a['registers']} registers a thread at launch, "
            f"{a['local_bytes']} local (spill) bytes")
        if a["local_bytes"] != 0:
            fail(f"the {route} dK/dV kernel writing an e4m3 slab spills {a['local_bytes']} bytes")
    a = flash_bwd.banded_kernel_attrs(False, torch.bfloat16, ds_bits=8)
    log(f"  banded_dq bf16, e4m3 slab: {a['registers']} registers a thread at launch, "
        f"{a['local_bytes']} local (spill) bytes")
    if a["local_bytes"] != 0:
        fail(f"banded dQ over an e4m3 slab spills {a['local_bytes']} bytes")
    for hd in range(64, 1025, 64):
        if flash_bwd.banded_kernel_plan(hd, 8) != banded_plan(hd, ds_itemsize=1):
            fail(f"banded launcher's plan over an e4m3 slab at D{hd} "
                 f"{flash_bwd.banded_kernel_plan(hd, 8)} differs from ops/config.py "
                 f"banded_plan {banded_plan(hd, ds_itemsize=1)}")
    log(f"  banded plan over an e4m3 slab at D512: {flash_bwd.banded_kernel_plan(512, 8)} (the "
        f"launcher's, equal to ops/config.py banded_plan(ds_itemsize=1) at D 64..1024)")

    q, k, v, do, lse, delta = (x[n] for n in ("q", "k", "v", "do", "lse", "delta"))
    b, hq, n, d = q.shape
    hkv, bf = k.shape[1], torch.bfloat16
    scale = x["kern_kw"]["scale"]
    cfg8 = BlockConfig(ds_store_bits=8)

    def run_dkdv(cfg=cfg8):
        return flash_bwd._dkdv_launch(q, k, v, None, do, lse, delta, 0, cfg,
                                      grad_kv_storage_dtype=None, emit_ds=True, **x["kern_kw"])

    def run_dkdv_plain():
        return flash_bwd._dkdv_plain(q, k, v, None, do, lse, delta, scale=scale, emit_ds=True,
                                     nq_pad=n, nkv_pad=n, ds_fp8=True, **x["plain_kw"])

    dk16, dv16, _ = run_dkdv(BlockConfig())
    dk8, dv8, ds8 = run_dkdv()
    torch.cuda.synchronize()
    equal = bool(torch.equal(dk8, dk16) and torch.equal(dv8, dv16))
    del dk16, dv16
    pdk, pdv, pds = run_dkdv_plain()
    steps = int(flash_bwd.e4m3_steps(ds8, pds).max())
    _hold("dkdv_fp8_ds_N8192", {"dk": (dk8, pdk), "dv": (dv8, pdv)})
    err = max(max_abs(dk8, pdk), max_abs(dv8, pdv), max_abs(ds8.float(), pds.float()))
    log(f"  dkdv_fp8_ds_N{n}: dK, dV {'bit-equal' if equal else 'DIFFER'} to the 16-bit-slab "
        f"launch; slab within {steps} e4m3 step(s) of the plain version's")
    if not equal or steps > 1:
        fail("the e4m3 dS writer disagrees with the 16-bit launch or its plain version")
    del dk8, dv8, pdk, pdv, pds
    kms = _timed(run_dkdv, 10)
    pms = _timed(run_dkdv_plain, 3, warmup=1)
    slab_bytes = ds8.numel()
    flops, nbytes = backward_counts("dkdv", b=b, hq=hq, hkv=hkv, nq=n, nkv=n, d=d, dv=d,
                                    causal=True, slab_bytes=slab_bytes)
    row("dkdv_fp8_ds", "ffpa_attn_tpu/ops/flash_bwd.py:194",
        fp8_training["launches"]["dkdv_fp8_ds"], err, kms, pms, lib, flops, nbytes,
        lambda: _timed(run_dkdv, 10))

    def run_banded():
        return flash_bwd._banded_dq_from_ds(ds8, k, None, scale=scale, group=hq // hkv, nq=n,
                                            nkv=n, causal_offset=0, dq_dtype=bf)

    def run_banded_plain():
        return flash_bwd._banded_dq_plain(ds8, k, scale=scale, nq=n, nkv=n)

    kbq = run_banded()
    torch.cuda.synchronize()
    pbq = run_banded_plain()
    rr = grad_row_rel(kbq, pbq)
    err = max_abs(kbq, pbq)
    log(f"  bwd banded_dq_fp8_ds_N{n}   dq {rr:.2e} (tol {FP8_READER_TOL:g}, per row) "
        f"{'ok' if rr < FP8_READER_TOL else 'FAIL'}")
    if not rr < FP8_READER_TOL or not bool(torch.isfinite(kbq).all()):
        fail("banded dQ over an e4m3 slab disagrees with its plain version")
    del kbq, pbq
    kms = _timed(run_banded, 10)
    pms = _timed(run_banded_plain, 3, warmup=1)
    kd = x["kd"]
    lms = _timed(lambda: torch.matmul(ds8.to(bf), kd), 10)
    widen = _timed(lambda: ds8.to(bf), 10)
    log(f"  yardstick for banded_dq_fp8_ds: the slab widened to bf16, then one dense "
        f"torch.matmul with K: {lms[0]:.4f} ms [{lms[1]:.4f}], of which the widening copy "
        f"alone {widen[0]:.4f} ms [{widen[1]:.4f}]")
    flops, nbytes = backward_counts("banded_dq", b=b, hq=hq, hkv=hkv, nq=n, nkv=n, d=d, dv=d,
                                    causal=True, ds_itemsize=1)
    row("banded_dq_fp8_ds", "ffpa_attn_tpu/ops/flash_bwd.py:1186",
        fp8_training["launches"]["banded_dq_fp8_ds"], err, kms, pms, lms, flops, nbytes,
        lambda: _timed(run_banded, 10))
    del ds8
    torch.cuda.empty_cache()

    # dQ of a whole handoff backward with the flag set against it unset.
    dq = {}
    for flag in ("0", "1"):
        with _env(FP8_FLAG, flag):
            dq[flag] = flash_bwd.flash_attention_backward(
                q, k, v, None, x["o"], lse, do, scale=scale, is_causal=True,
                ds_handoff=True)[0].float()
    diff = dq["1"] - dq["0"]
    dq_rms = float(diff.pow(2).mean().sqrt() / dq["0"].pow(2).mean().sqrt())
    dq_worst = float(diff.abs().max() / dq["0"].abs().max())
    del dq, diff
    names = {"dkdv": "dkdv::kernel<__nv_bfloat16, false, true>",
             "banded_dq": "banded_kernel<__nv_bfloat16, false, true>"}
    dev = {k_: sum(ms for kname, ms in by_kernel.items() if nm in kname) / TRAIN["n_layers"]
           for k_, nm in names.items()}
    log(f"  e4m3 dS handoff at N{n}: step_ms {fp8_training['step_ms']:.2f} (the 16-bit step "
        f"in turns on the same model {fp8_training['step_ms_16']:.2f}); e4m3 kernels' device "
        f"ms a launch in the profiled step: dkdv {dev['dkdv']:.4f}, banded_dq "
        f"{dev['banded_dq']:.4f}; slab_bytes {slab_bytes} a layer (16-bit: {2 * slab_bytes}); "
        f"dQ vs the 16-bit run: rms {dq_rms:.3e} worst {dq_worst:.3e} (of RMS and max|dQ|; "
        f"the JAX test's bounds 4e-2, 8e-2 at N <= 512)")
    if min(dev.values()) <= 0.0:
        fail(f"the profiled e4m3 step shows no e4m3 kernel: {sorted(by_kernel)[:8]}")
    by_name = {r["name"]: r for r in rows}
    by_name["dkdv_fp8_ds"].update(table_row="2 (fp8 dS)", slab_bytes=slab_bytes,
                                  step_device_ms=dev["dkdv"])
    by_name["banded_dq_fp8_ds"].update(table_row="5 (fp8 dS)", slab_bytes=slab_bytes,
                        step_device_ms=dev["banded_dq"], widen_copy_ms=widen[0],
                        handoff_dq_rms_rel=dq_rms, handoff_dq_worst_rel=dq_worst,
                        train_step_ms=fp8_training["step_ms"],
                        train_step_ms_16=fp8_training["step_ms_16"])


def fwd_kernel_row_extras(d: int) -> dict:
    """The forward's route at head dim ``d`` and both routes' kernels'
    registers and spill bytes, for the ``kernels`` line; fails unless the
    launcher's plan equals its mirror (``ops/config.py`` ``fwd_plan``) at
    every head-dim pair of ``tests/test_torch_fwd_plan.py`` (D, Dv 64..1024,
    both routes), neither route's kernel spills, and ptxas kept the wgmma
    pipeline of every kernel of flash_fwd.cu, flash_bwd.cu, decode.cu,
    paged_decode.cu, varlen_fwd.cu and varlen_bwd.cu (no C7515 / C7520 note
    in any of their builds' logs)."""
    from ffpa_attn_tpu_torch.ops import _build, flash_fwd
    from ffpa_attn_tpu_torch.ops.config import fwd_plan

    pairs = PLAN_PAIRS
    for hd, hdv in pairs:
        if flash_fwd.fwd_kernel_plan(hd, hdv) != fwd_plan(hd, hdv):
            fail(f"forward launcher's plan at D{hd}/Dv{hdv} {flash_fwd.fwd_kernel_plan(hd, hdv)} "
                 f"differs from ops/config.py fwd_plan {fwd_plan(hd, hdv)}")
    log(f"  flash_fwd plan at D{d}: {flash_fwd.fwd_kernel_plan(d, d)}; at D1024: "
        f"{flash_fwd.fwd_kernel_plan(1024, 1024)} (the launcher's, equal to ops/config.py "
        f"fwd_plan at {len(pairs)} head-dim pairs)")
    attrs = {}
    for route in ("wgmma", "wgmma_cluster"):
        for dt in (torch.bfloat16, torch.float16):
            a = attrs[route, dt] = flash_fwd.fwd_kernel_attrs(route, dt)
            log(f"  flash_fwd {route} {str(dt)[6:]}: {a['registers']} registers a thread at "
                f"launch, {a['local_bytes']} local (spill) bytes")
            if a["local_bytes"] != 0:
                fail(f"the {route} forward kernel ({dt}) spills {a['local_bytes']} bytes")
    for name in ("flash_fwd", "flash_bwd", "decode", "paged_decode", "varlen_fwd", "varlen_bwd"):
        build_log = _build.build_log(name)
        if "ptxas info" not in build_log:
            # Without ptxas's report the count below would read nothing.
            log(f"  no ptxas report beside the {name} library ({len(build_log)} bytes of log)")
            fail(f"the ptxas report of {name}.cu is missing: the wgmma serialization gate "
                 "cannot read it")
        notes = [ln for ln in build_log.splitlines() if "C7515" in ln or "C7520" in ln]
        log(f"  ptxas wgmma serialization notes (C7515 / C7520) in {name}.cu: {len(notes)} "
            f"(of {build_log.count('ptxas info')} ptxas info lines)")
        for ln in notes[:4]:
            log(f"    {ln[:200]}")
        if notes:
            fail(f"ptxas serialized a wgmma kernel of {name}.cu")
    route = flash_fwd.fwd_kernel_plan(d, d).route
    a, c = attrs[route, torch.bfloat16], attrs["wgmma_cluster", torch.bfloat16]
    return {"fwd_route": route, "registers": a["registers"], "spill_bytes": a["local_bytes"],
            "cluster_registers": c["registers"], "cluster_spill_bytes": c["local_bytes"]}


def fwd_cluster_times() -> dict:
    """The forward's cluster route at the bench's D sweep's causal D1024
    shape cut to H8 (B1 N8192 bf16): the kernel held against its plain
    version per row, then timed (device ms of the forward kernel by name,
    CUDA-event ms) beside its bound, its plain version and
    ``scaled_dot_product_attention``; for the ``kernels`` line."""
    import torch.nn.functional as F

    from ffpa_attn_tpu_torch.cli._bench import sdpa_backend
    from ffpa_attn_tpu_torch.ops import flash_fwd
    from ffpa_attn_tpu_torch.utils.profiling import band_pairs, bound_ms

    b, h, n, d = 1, 8, TRAIN_N, 1024
    gen = torch.Generator(device="cuda").manual_seed(40)
    q, k, v = (_randn((b, h, n, d), torch.bfloat16, gen) for _ in range(3))
    kw = dict(scale=d ** -0.5, is_causal=True)

    def run():
        return flash_fwd.flash_attention_forward(q, k, v, None, **kw)

    def plain():
        return flash_fwd.flash_attention_forward_plain(q, k, v, None, **kw)

    o, _ = run()
    torch.cuda.synchronize()
    po, _ = plain()
    err = row_rel(o, po)
    if not err < BF16_TOL:
        fail(f"the cluster forward at D{d} N{n} disagrees with its plain version: {err:.2e}")
    mae = max_abs(o, po)
    del o, po
    flops = 2 * b * h * band_pairs(n, n, causal=True) * (d + d)
    bms, bby = bound_ms(flops, 2 * 4 * b * h * n * d + 4 * b * h * n)
    kms = _above_bound("flash_fwd cluster (D1024)", _kernel_timed(run, flash_fwd.FWD_KERNELS, 5),
                       bms, lambda: _kernel_timed(run, flash_fwd.FWD_KERNELS, 5))
    pms = _timed(plain, 2, warmup=1)
    lms = _timed(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 3, warmup=1)
    log(f"  flash_fwd cluster route (B{b} H{h} N{n} D{d} causal bf16): {kms[0]:.4f} ms "
        f"[{kms[1]:.4f}], {flops / kms[0] / 1e9:.1f} TFLOP/s, bound {bms:.4f} ms ({bby}); plain "
        f"{pms[0]:.4f} ms; scaled_dot_product_attention ({sdpa_backend(q, k, v, is_causal=True)} "
        f"backend) {lms[0]:.4f} ms; per-row error vs plain {err:.2e}")
    return {"d1024_shape": f"B{b} H{h} N{n} D{d} causal bf16", "d1024_ms": kms[0],
            "d1024_event_ms": kms[1], "d1024_bound_ms": bms, "d1024_plain_ms": pms[0],
            "d1024_library_ms": lms[0], "d1024_max_abs_err": mae}


@functools.lru_cache(maxsize=None)
def _decode_checks() -> dict:
    """Fails unless decode's launcher plan equals its mirror
    (``ops/config.py`` ``decode_plan``) over the main path's packings,
    both instances' edges and the serving step's packing (group 2 of B4's
    rows), and unless neither instance (one consumer warpgroup at D, Dv <=
    512, two above) spills in either dtype. Returns {(consumers, dtype):
    registers and spill bytes}; runs once."""
    from ffpa_attn_tpu_torch.ops import decode
    from ffpa_attn_tpu_torch.ops.config import decode_plan

    shapes = [(d, d, rows) for d in (512, 1024) for rows in (1, 2, 8, 16, 32, 64)]
    shapes += [(320, 512, 4), (512, 320, 4), (64, 64, 2), (640, 640, 2), (512, 640, 16),
               (768, 1024, 128), (1024, 320, 2), (576, 576, 33), (1024, 64, 2), (64, 1024, 2)]
    for hd, hdv, rows in shapes:
        got, want = decode.decode_kernel_plan(hd, hdv, rows), decode_plan(hd, hdv, rows)
        if got != want:
            fail(f"decode launcher's plan at D{hd}/Dv{hdv} R{rows} {got} differs from "
                 f"ops/config.py decode_plan {want}")
    log(f"  decode plans: the launcher's equal to ops/config.py decode_plan at {len(shapes)} "
        f"shapes")
    attrs = {}
    for consumers in (1, 2):
        for dt in (torch.bfloat16, torch.float16):
            a = attrs[(consumers, dt)] = decode.decode_kernel_attrs(consumers, dt)
            log(f"  decode ({consumers} consumer warpgroup{'s' if consumers > 1 else ''}) "
                f"{str(dt)[6:]}: {a['registers']} registers a thread, {a['local_bytes']} local "
                f"(spill) bytes")
            if a["local_bytes"] != 0:
                fail(f"the decode kernel ({consumers} consumer warpgroups, {dt}) spills "
                     f"{a['local_bytes']} bytes")
    return attrs


def decode_kernel_row_extras(d: int) -> dict:
    """Decode's tiling at head dim ``d`` at the generate step and its
    instance's registers and spill bytes, for the ``kernels`` line, after
    ``_decode_checks``."""
    from ffpa_attn_tpu_torch.ops import decode

    attrs = _decode_checks()
    plan = decode.decode_kernel_plan(d, d, 2)
    log(f"  decode plan at D{d}, the generate step: {plan}")
    a = attrs[(plan.consumers, torch.bfloat16)]
    return {"decode_route": plan.route, "consumers": plan.consumers, "stages": plan.stages,
            "kernel": f"tma::decode_tma_kernel<T, {'true' if plan.consumers == 2 else 'false'}>",
            "registers": a["registers"], "spill_bytes": a["local_bytes"]}


def paged_kernel_row_extras(d: int) -> dict:
    """Paged decode's tiling at head dim ``d`` over the serving pages and
    both instances' registers and spill bytes (one consumer warpgroup
    at D, Dv <= 512, two above), for the ``kernels`` line; fails unless the
    launcher's plan equals its mirror (``ops/config.py`` ``paged_plan``)
    over head dims 64..1024 (D != Dv among them), pages of 1..256 rows and
    int8 pools, and neither instance spills in either dtype."""
    from ffpa_attn_tpu_torch.ops import paged
    from ffpa_attn_tpu_torch.ops.config import paged_plan

    pages = (1, 2, 8, 16, 17, 20, 24, 32, 48, 64, 100, 128, 256)
    shapes = [(hd, hd, pg, q8) for hd in (64, 320, 512, 576, 640, 1024) for pg in pages
              for q8 in (False, True)]
    shapes += [(64, 1024, 24, True), (1024, 64, 17, False), (512, 640, 20, True),
               (1024, 320, 256, False), (128, 512, 80, True)]
    for hd, hdv, pg, q8 in shapes:
        got, want = paged.paged_kernel_plan(hd, hdv, pg, q8), paged_plan(hd, hdv, pg, q8)
        if got != want:
            fail(f"paged launcher's plan at D{hd}/Dv{hdv} page {pg} int8 {q8} {got} differs "
                 f"from ops/config.py paged_plan {want}")
    plan = paged.paged_kernel_plan(d, d, SERVE_PAGE)
    log(f"  paged_decode plan at D{d} over pages of {SERVE_PAGE} rows: {plan} (the launcher's, "
        f"equal to ops/config.py paged_plan at {len(shapes)} shapes)")
    attrs = {}
    for consumers in (1, 2):
        for dt in (torch.bfloat16, torch.float16):
            for q8 in (False, True):
                a = paged.paged_kernel_attrs(dt, q8, consumers)
                attrs[(consumers, dt, q8)] = a
                wgs = f"{consumers} consumer warpgroup{'s' if consumers > 1 else ''}"
                log(f"  paged_decode ({wgs}) {str(dt)[6:]}{' int8' if q8 else ''}: "
                    f"{a['registers']} registers a thread, {a['local_bytes']} local (spill) bytes")
                if a["local_bytes"] != 0:
                    fail(f"the paged decode kernel ({consumers} consumer warpgroups, {dt}, int8 "
                         f"{q8}) spills {a['local_bytes']} bytes")
    a = attrs[(plan.consumers, torch.bfloat16, False)]
    return {"paged_route": plan.route, "consumers": plan.consumers, "box_rows": plan.box_rows,
            "kernel": f"tma::paged_tma_kernel<T, Q8, {'true' if plan.consumers == 2 else 'false'}>",
            "registers": a["registers"], "spill_bytes": a["local_bytes"]}


def dkdv_kernel_row_extras(d: int) -> dict:
    """The dK/dV route at head dim ``d`` and both routes' kernels' registers
    and spill bytes, for the ``kernels`` line; fails unless the launcher's
    plan equals its mirror (``ops/config.py`` ``dkdv_plan``) at every pair
    of ``PLAN_PAIRS`` and neither route's kernel spills in either dtype."""
    from ffpa_attn_tpu_torch.ops import flash_bwd
    from ffpa_attn_tpu_torch.ops.config import DKDV_MIN_STAGES, dkdv_plan

    capped = 0
    for hd, hdv in PLAN_PAIRS:
        if flash_bwd.dkdv_kernel_plan(hd, hdv) != dkdv_plan(hd, hdv):
            fail(f"dK/dV launcher's plan at D{hd}/Dv{hdv} {flash_bwd.dkdv_kernel_plan(hd, hdv)} "
                 f"differs from ops/config.py dkdv_plan {dkdv_plan(hd, hdv)}")
        capped += capped_plans_equal(
            f"dK/dV D{hd}/Dv{hdv}", lambda c: flash_bwd.dkdv_kernel_plan(hd, hdv, c),
            lambda c: dkdv_plan(hd, hdv, ring_cap=c), dkdv_plan(hd, hdv).stages, DKDV_MIN_STAGES)
    log(f"  dkdv plan at D{d}: {flash_bwd.dkdv_kernel_plan(d, d)}; at D1024: "
        f"{flash_bwd.dkdv_kernel_plan(1024, 1024)} (the launcher's, equal to ops/config.py "
        f"dkdv_plan at {len(PLAN_PAIRS)} head-dim pairs, and at one ring cap below the plan's "
        f"at {capped} of them)")
    attrs = {}
    for route in ("wgmma", "wgmma_cluster"):
        for dt in (torch.bfloat16, torch.float16):
            a = attrs[route, dt] = flash_bwd.dkdv_kernel_attrs(route, dt)
            log(f"  dkdv {route} {str(dt)[6:]}: {a['registers']} registers a thread at launch, "
                f"{a['local_bytes']} local (spill) bytes")
            if a["local_bytes"] != 0:
                fail(f"the {route} dK/dV kernel ({dt}) spills {a['local_bytes']} bytes")
    route = dkdv_plan(d, d).route
    a, c = attrs[route, torch.bfloat16], attrs["wgmma_cluster", torch.bfloat16]
    return {"dkdv_route": route, "registers": a["registers"], "spill_bytes": a["local_bytes"],
            "cluster_registers": c["registers"], "cluster_spill_bytes": c["local_bytes"]}


def dkdv_cluster_times() -> dict:
    """The dK/dV cluster route at the bench's D sweep's causal D1024 shape
    cut to H8 (B1 N8192 fp16, with the dS slab: the handoff tier fp16
    takes): the kernel held against its plain version per row, then timed
    (device ms of the dK/dV kernel by name, CUDA-event ms) beside its
    bound, its plain version and ``torch.autograd.grad`` through
    ``scaled_dot_product_attention`` (dQ, dK and dV); for the ``kernels``
    line."""
    import torch.nn.functional as F

    from ffpa_attn_tpu_torch.cli._bench import sdpa_backend
    from ffpa_attn_tpu_torch.ops import flash_bwd, flash_fwd
    from ffpa_attn_tpu_torch.ops.dispatch import pick_backward_config
    from ffpa_attn_tpu_torch.utils.profiling import backward_counts, bound_ms

    b, h, n, d, dt = 1, 8, TRAIN_N, 1024, torch.float16
    gen = torch.Generator(device="cuda").manual_seed(41)
    q, k, v, do = (_randn((b, h, n, d), dt, gen) for _ in range(4))
    scale = d ** -0.5
    o, lse = flash_fwd.flash_attention_forward(q, k, v, None, scale=scale, is_causal=True)
    delta = (do.float() * o.float()).sum(-1)
    del o
    cfg = pick_backward_config(d=d, dv=d, nq=n, nkv=n, dtype=dt)
    kw = dict(scale=scale, is_causal=True, causal_offset=0, dropout_p=0.0, group=1)

    def run():
        return flash_bwd._dkdv_launch(q, k, v, None, do, lse, delta, 0, cfg,
                                      grad_kv_storage_dtype=None, emit_ds=True, **kw)

    def plain():
        return flash_bwd._dkdv_plain(q, k, v, None, do, lse, delta, scale=scale, emit_ds=True,
                                     nq_pad=n, nkv_pad=n, is_causal=True, causal_offset=0,
                                     dropout_p=0.0, seed=0, softcap=0.0, window=(-1, -1),
                                     alibi=None)

    before = flash_bwd._dkdv_launch.launches
    kdk, kdv, kds = run()
    torch.cuda.synchronize()
    if flash_bwd._dkdv_launch.launches != before + 1:
        fail("the dK/dV cluster call at D1024 launched no kernel")
    pdk, pdv, pds = plain()
    err = _hold(f"dkdv_cluster_N{n}_D{d}", {"dk": (kdk, pdk), "dv": (kdv, pdv), "ds": (kds, pds)},
                dt)
    del kdk, kdv, kds, pdk, pdv, pds
    torch.cuda.empty_cache()
    flops, nbytes = backward_counts("dkdv", b=b, hq=h, hkv=h, nq=n, nkv=n, d=d, dv=d, causal=True,
                                    slab_bytes=b * h * n * n * 2)
    bms, bby = bound_ms(flops, nbytes)
    kms = _above_bound("dkdv cluster (D1024)", _kernel_timed(run, flash_bwd.DKDV_KERNELS, 5),
                       bms, lambda: _kernel_timed(run, flash_bwd.DKDV_KERNELS, 5))
    pms = _timed(plain, 2, warmup=1)
    torch.cuda.empty_cache()
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    lms = _timed(lambda: torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True), 3,
                 warmup=1)
    log(f"  dkdv cluster route (B{b} H{h} N{n} D{d} causal fp16, with the slab): "
        f"{kms[0]:.4f} ms [{kms[1]:.4f}], {flops / kms[0] / 1e9:.1f} TFLOP/s, bound "
        f"{bms:.4f} ms ({bby}); plain {pms[0]:.4f} ms; torch.autograd.grad through "
        f"scaled_dot_product_attention ({sdpa_backend(ql, kl, vl, is_causal=True)} backend, dQ "
        f"dK dV) {lms[0]:.4f} ms; max|err| vs plain {err:.3e}")
    del out
    torch.cuda.empty_cache()
    return {"d1024_shape": f"B{b} H{h} N{n} D{d} causal fp16", "d1024_ms": kms[0],
            "d1024_event_ms": kms[1], "d1024_bound_ms": bms, "d1024_plain_ms": pms[0],
            "d1024_library_ms": lms[0], "d1024_max_abs_err": err}


def varlen_fwd_kernel_row_extras(d: int) -> dict:
    """The varlen forward's route at head dim ``d`` and both routes'
    kernels' registers and spill bytes, for the ``kernels`` line; fails
    unless the launcher's plan equals its mirror (``ops/config.py``
    ``varlen_fwd_plan``, the dense ``fwd_plan``) at D, Dv 64..1024 and D !=
    Dv, and neither route spills in either dtype. The C7515 / C7520 notes of
    ``varlen_fwd.cu`` are checked with the build's."""
    from ffpa_attn_tpu_torch.ops import varlen
    from ffpa_attn_tpu_torch.ops.config import fwd_plan, varlen_fwd_plan

    pairs = [(x, x) for x in range(64, 1025, 64)] + [(512, 320), (320, 512), (512, 64),
                                                     (64, 512), (448, 64), (512, 1024),
                                                     (1024, 320), (400, 400), (64, 1024),
                                                     (1024, 64)]
    for hd, hdv in pairs:
        got, want = varlen.varlen_fwd_kernel_plan(hd, hdv), varlen_fwd_plan(hd, hdv)
        if got != want or want != fwd_plan(hd, hdv):
            fail(f"varlen forward launcher's plan at D{hd}/Dv{hdv} {got} differs from "
                 f"ops/config.py varlen_fwd_plan {want}")
    log(f"  varlen_fwd plan at D{d}: {varlen.varlen_fwd_kernel_plan(d, d)}; at D1024: "
        f"{varlen.varlen_fwd_kernel_plan(1024, 1024)} (the launcher's, equal to ops/config.py "
        f"varlen_fwd_plan at {len(pairs)} head-dim pairs)")
    attrs = {}
    for route in ("wgmma", "wgmma_cluster"):
        for dt in (torch.bfloat16, torch.float16):
            a = attrs[route, dt] = varlen.varlen_fwd_kernel_attrs(route, dt)
            log(f"  varlen_fwd {route} {str(dt)[6:]}: {a['registers']} registers a thread at "
                f"launch, {a['local_bytes']} local (spill) bytes")
            if a["local_bytes"] != 0:
                fail(f"the {route} varlen forward kernel ({dt}) spills {a['local_bytes']} bytes")
    route = varlen_fwd_plan(d, d).route
    a = attrs[route, torch.bfloat16]
    return {"varlen_fwd_route": route, "kernel": f"tma::varlen_fwd_wgmma_kernel<T, "
            f"{'true' if route == 'wgmma_cluster' else 'false'}>", "registers": a["registers"],
            "spill_bytes": a["local_bytes"]}


def varlen_dkdv_kernel_row_extras(d: int) -> dict:
    """The varlen dK/dV route at head dim ``d`` and both routes' kernels'
    registers and spill bytes, for the ``kernels`` line; fails unless the
    launcher's plan equals its mirror (``ops/config.py`` ``varlen_dkdv_plan``,
    the dense ``dkdv_plan``) at D, Dv 64..1024, D != Dv and a rank without a
    box of one dim, and neither route's kernel (one block, the cluster)
    spills in either dtype. ``fwd_kernel_row_extras`` fails on a C7515 /
    C7520 note in ``varlen_bwd.cu``."""
    from ffpa_attn_tpu_torch.ops import varlen
    from ffpa_attn_tpu_torch.ops.config import DKDV_MIN_STAGES, dkdv_plan, varlen_dkdv_plan

    pairs = [(x, x) for x in range(64, 1025, 64)] + [(512, 320), (320, 512), (512, 64),
                                                     (64, 512), (448, 64), (512, 1024),
                                                     (1024, 320), (400, 400), (64, 1024),
                                                     (1024, 64), (640, 1024), (576, 576)]
    capped = 0
    for hd, hdv in pairs:
        got, want = varlen.varlen_dkdv_kernel_plan(hd, hdv), varlen_dkdv_plan(hd, hdv)
        if got != want or want != dkdv_plan(hd, hdv):
            fail(f"varlen dK/dV launcher's plan at D{hd}/Dv{hdv} {got} differs from "
                 f"ops/config.py varlen_dkdv_plan {want}")
        capped += capped_plans_equal(
            f"varlen dK/dV D{hd}/Dv{hdv}", lambda c: varlen.varlen_dkdv_kernel_plan(hd, hdv, c),
            lambda c: varlen_dkdv_plan(hd, hdv, ring_cap=c), want.stages, DKDV_MIN_STAGES)
    log(f"  varlen_dkdv plan at D{d}: {varlen.varlen_dkdv_kernel_plan(d, d)}; at D1024: "
        f"{varlen.varlen_dkdv_kernel_plan(1024, 1024)} (the launcher's, equal to ops/config.py "
        f"varlen_dkdv_plan at {len(pairs)} head-dim pairs, and at one ring cap below the plan's "
        f"at {capped} of them)")
    attrs = {}
    for route in ("wgmma", "wgmma_cluster"):
        for dt in (torch.bfloat16, torch.float16):
            a = attrs[route, dt] = varlen.varlen_dkdv_kernel_attrs(route, dt)
            log(f"  varlen_dkdv {route} {str(dt)[6:]}: {a['registers']} registers a thread at "
                f"launch, {a['local_bytes']} local (spill) bytes")
            if a["local_bytes"] != 0:
                fail(f"the {route} varlen dK/dV kernel ({dt}) spills {a['local_bytes']} bytes")
    route = varlen_dkdv_plan(d, d).route
    a, c = attrs[route, torch.bfloat16], attrs["wgmma_cluster", torch.bfloat16]
    return {"varlen_dkdv_route": route, "registers": a["registers"],
            "spill_bytes": a["local_bytes"], "cluster_registers": c["registers"],
            "cluster_spill_bytes": c["local_bytes"]}


def varlen_dq_kernel_row_extras(d: int) -> dict:
    """The varlen dQ route at head dim ``d`` and both routes' kernels'
    registers and spill bytes, for the ``kernels`` line; fails unless the
    launcher's plan equals its mirror (``ops/config.py`` ``varlen_dq_plan``,
    which is ``dq_plan``) at D, Dv 64..1024 and D != Dv, rank blocks
    included, and neither route's kernel spills in either dtype."""
    from ffpa_attn_tpu_torch.ops import varlen
    from ffpa_attn_tpu_torch.ops.config import DQ_MIN_STAGES, dq_plan, varlen_dq_plan

    pairs = [(x, x) for x in range(64, 1025, 64)] + [(512, 320), (320, 512), (512, 64),
                                                     (64, 512), (448, 64), (512, 1024),
                                                     (1024, 320), (400, 400), (64, 1024),
                                                     (1024, 64), (640, 1024), (576, 576)]
    capped = 0
    for hd, hdv in pairs:
        got, want = varlen.varlen_dq_kernel_plan(hd, hdv), varlen_dq_plan(hd, hdv)
        if got != want or want != dq_plan(hd, hdv):
            fail(f"varlen dQ launcher's plan at D{hd}/Dv{hdv} {got} differs from "
                 f"ops/config.py varlen_dq_plan {want}")
        capped += capped_plans_equal(
            f"varlen dQ D{hd}/Dv{hdv}", lambda c: varlen.varlen_dq_kernel_plan(hd, hdv, c),
            lambda c: varlen_dq_plan(hd, hdv, ring_cap=c), want.stages, DQ_MIN_STAGES)
    log(f"  varlen_dq plan at D{d}: {varlen.varlen_dq_kernel_plan(d, d)}; at D1024: "
        f"{varlen.varlen_dq_kernel_plan(1024, 1024)} (the launcher's, equal to ops/config.py "
        f"varlen_dq_plan at {len(pairs)} head-dim pairs, and at one ring cap below the plan's at "
        f"{capped} of them)")
    attrs = {}
    for route in ("wgmma", "wgmma_cluster"):
        for dt in (torch.bfloat16, torch.float16):
            a = attrs[route, dt] = varlen.varlen_dq_kernel_attrs(route, dt)
            log(f"  varlen_dq {route} {str(dt)[6:]}: {a['registers']} registers a thread at "
                f"launch, {a['local_bytes']} local (spill) bytes")
            if a["local_bytes"] != 0:
                fail(f"the {route} varlen dQ kernel ({dt}) spills {a['local_bytes']} bytes")
    route = varlen_dq_plan(d, d).route
    a, c = attrs[route, torch.bfloat16], attrs["wgmma_cluster", torch.bfloat16]
    return {"varlen_dq_route": route, "kernel": "tma::varlen_dq_wgmma_kernel<T, false>",
            "registers": a["registers"], "spill_bytes": a["local_bytes"],
            "cluster_registers": c["registers"], "cluster_spill_bytes": c["local_bytes"]}


def dq_kernel_row_extras(d: int) -> dict:
    """The recompute dQ route at head dim ``d`` and both routes' kernels'
    registers and spill bytes, for the ``kernels`` line; fails unless the
    launcher's plan equals its mirror (``ops/config.py`` ``dq_plan``) at
    every pair of ``PLAN_PAIRS`` and neither route's kernel spills in
    either dtype (with dropout or without)."""
    from ffpa_attn_tpu_torch.ops import flash_bwd
    from ffpa_attn_tpu_torch.ops.config import DQ_MIN_STAGES, dq_plan

    capped = 0
    for hd, hdv in PLAN_PAIRS:
        if flash_bwd.dq_kernel_plan(hd, hdv) != dq_plan(hd, hdv):
            fail(f"dQ launcher's plan at D{hd}/Dv{hdv} {flash_bwd.dq_kernel_plan(hd, hdv)} "
                 f"differs from ops/config.py dq_plan {dq_plan(hd, hdv)}")
        capped += capped_plans_equal(
            f"dQ D{hd}/Dv{hdv}", lambda c: flash_bwd.dq_kernel_plan(hd, hdv, c),
            lambda c: dq_plan(hd, hdv, ring_cap=c), dq_plan(hd, hdv).stages, DQ_MIN_STAGES)
    log(f"  dq plan at D{d}: {flash_bwd.dq_kernel_plan(d, d)}; at D1024: "
        f"{flash_bwd.dq_kernel_plan(1024, 1024)} (the launcher's, equal to ops/config.py "
        f"dq_plan at {len(PLAN_PAIRS)} head-dim pairs, and at one ring cap below the plan's at "
        f"{capped} of them)")
    attrs = {}
    for route in ("wgmma", "wgmma_cluster"):
        for dt in (torch.bfloat16, torch.float16):
            a = attrs[route, dt] = flash_bwd.dq_kernel_attrs(route, dt)
            log(f"  dq {route} {str(dt)[6:]}: {a['registers']} registers a thread at launch, "
                f"{a['local_bytes']} local (spill) bytes")
            if a["local_bytes"] != 0:
                fail(f"the {route} dQ kernel ({dt}) spills {a['local_bytes']} bytes")
    route = dq_plan(d, d).route
    a, c = attrs[route, torch.bfloat16], attrs["wgmma_cluster", torch.bfloat16]
    return {"dq_route": route, "registers": a["registers"], "spill_bytes": a["local_bytes"],
            "cluster_registers": c["registers"], "cluster_spill_bytes": c["local_bytes"]}


def from_s_kernel_row_extras(d: int, dk_in: bool) -> dict:
    """The from-S route a launch at head dim ``d`` takes (with the dispatch
    rule's ``dk_in``) and its kernel's registers and spill bytes, for the
    ``kernels`` line; fails unless the launcher's plan equals its mirror
    (``ops/config.py`` ``from_s_plan``) at Dv 64..1024 with dK in and out
    of the kernel, and neither wgmma route (the block, the cluster)
    spills."""
    from ffpa_attn_tpu_torch.ops import flash_bwd
    from ffpa_attn_tpu_torch.ops.config import from_s_min_stages, from_s_plan

    cases = [(dv, dk) for dv in range(64, 1025, 64) for dk in (False, True)]
    capped = 0
    for dv, dk in cases:
        if flash_bwd.from_s_kernel_plan(dv, dk) != from_s_plan(dv, dk):
            fail(f"from-S launcher's plan at Dv{dv} dk_in={dk} "
                 f"{flash_bwd.from_s_kernel_plan(dv, dk)} differs from ops/config.py "
                 f"from_s_plan {from_s_plan(dv, dk)}")
        if not dk:
            capped += capped_plans_equal(
                f"from-S Dv{dv}", lambda c: flash_bwd.from_s_kernel_plan(dv, False, c),
                lambda c: from_s_plan(dv, False, ring_cap=c), from_s_plan(dv, False).stages,
                from_s_min_stages(dv))
    attrs = {route: flash_bwd.from_s_kernel_attrs(route)
             for route in ("wgmma", "wgmma_cluster", "mma_sync")}
    log(f"  from-S plan at Dv{d}: dK out {flash_bwd.from_s_kernel_plan(d, False)}, dK in "
        f"{flash_bwd.from_s_kernel_plan(d, True)}; at Dv1024 dK out "
        f"{flash_bwd.from_s_kernel_plan(1024, False)} (the launcher's, equal to "
        f"ops/config.py from_s_plan at {len(cases)} (Dv, dK in / out) pairs, and at one ring "
        f"cap below the plan's at {capped} dK-out ones)")
    for route, a in attrs.items():
        log(f"  from-S {route} dK {'in' if route == 'mma_sync' else 'out of'} the kernel: "
            f"{a['registers']} registers a thread at launch, {a['local_bytes']} local "
            f"(spill) bytes")
    for route in ("wgmma", "wgmma_cluster"):
        if attrs[route]["local_bytes"] != 0:
            fail(f"the {route} from-S kernel spills {attrs[route]['local_bytes']} bytes")
    route = from_s_plan(d, dk_in).route
    return {"from_s_route": route, "registers": attrs[route]["registers"],
            "spill_bytes": attrs[route]["local_bytes"]}


def from_s_cluster_times() -> dict:
    """The from-S cluster route (dK out of the kernel, Dv > 512) at the
    bench's D sweep's causal D1024 shape cut to H8 (B1 N8192 bf16, the
    S-resident tier bf16 takes): the kernel held against its plain version
    per row (dV and the dS written over the slab), then timed (device ms of
    the from-S kernel by name, CUDA-event ms less the copy of S each call
    needs) beside its bound, its plain version and, as its yardstick (no
    single PyTorch call computes the pass), the two dense ``torch.matmul``
    it contains, dO V^T and P^T dO, on the same shapes; the pieces of the
    ``kernels`` line's row ``dkdv_from_s_cluster``, with the kernel's
    registers and spill bytes."""
    from ffpa_attn_tpu_torch.ops import flash_bwd, flash_fwd
    from ffpa_attn_tpu_torch.ops.config import from_s_plan
    from ffpa_attn_tpu_torch.ops.dispatch import pick_backward_config
    from ffpa_attn_tpu_torch.utils.profiling import backward_counts

    b, h, n, d, bf = 1, 8, TRAIN_N, 1024, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(42)
    q, k, v, do = (_randn((b, h, n, d), bf, gen) for _ in range(4))
    scale = d ** -0.5
    o, lse, s = flash_fwd.flash_attention_forward(q, k, v, None, scale=scale, is_causal=True,
                                                  return_scores=True)
    delta = (do.float() * o.float()).sum(-1)
    del o, k
    cfg = flash_bwd._fit_blocks_to_scores(pick_backward_config(d=d, dv=d, nq=n, nkv=n, dtype=bf),
                                          n, n, d, d, bf)
    if from_s_plan(d, cfg.dkdv_dk_in_kernel).route != "wgmma_cluster":
        fail(f"from-S at D{d} does not take the cluster route")
    kw = dict(scale=scale, is_causal=True, causal_offset=0, dropout_p=0.0)

    def run():
        return flash_bwd._dkdv_from_s_launch(q, v, s.clone(), do, lse, delta, 0, cfg, group=1,
                                             grad_kv_storage_dtype=None, **kw)

    def plain():
        return flash_bwd._dkdv_from_s_plain(q, v, s, do, lse, delta, seed=0, softcap=0.0,
                                            dk_in_kernel=False, **kw)

    before = flash_bwd._dkdv_from_s_launch.launches
    _, kdv, kds = run()
    torch.cuda.synchronize()
    if flash_bwd._dkdv_from_s_launch.launches != before + 1:
        fail("the from-S cluster call at D1024 launched no kernel")
    _, pdv, pds = plain()
    err = _hold(f"from_s_cluster_N{n}_D{d}", {"dv": (kdv, pdv), "ds": (kds, pds)})
    del kdv, kds, pdv, pds
    torch.cuda.empty_cache()
    flops, nbytes = backward_counts("dkdv_from_s", b=b, hq=h, hkv=h, nq=n, nkv=n, d=d, dv=d,
                                    causal=True, slab_bytes=s.numel() * 2)

    def timed():
        return _kernel_timed(run, flash_bwd.FROM_S_KERNELS, 10, setup=lambda: s.clone())

    kms = timed()
    pms = _timed(plain, 2, warmup=1)
    torch.cuda.empty_cache()
    p_bf = torch.exp(s.float() - lse[..., None]).to(bf)
    lms = _timed(lambda: (torch.matmul(do, v.transpose(-1, -2)),
                          torch.matmul(p_bf.transpose(-1, -2), do)), 5)
    del p_bf
    log(f"  from-S cluster route (B{b} H{h} N{n} D{d} causal bf16, dK out of the kernel): "
        f"{kms[0]:.4f} ms [{kms[1]:.4f}], {flops / kms[0] / 1e9:.1f} TFLOP/s; plain "
        f"{pms[0]:.4f} ms; yardstick (two dense torch.matmul, dO V^T and P^T dO) {lms[0]:.4f} ms; "
        f"max|err| vs plain {err:.3e}")
    a = flash_bwd.from_s_kernel_attrs("wgmma_cluster")
    return dict(shape=f"B{b} H{h} N{n} D{d} causal bf16", err=err, kms=kms, pms=pms, lms=lms,
                flops=flops, nbytes=nbytes, retime=timed, registers=a["registers"],
                spill_bytes=a["local_bytes"])


def dq_cluster_times() -> dict:
    """The recompute dQ cluster route at the bench's D sweep's causal D1024
    shape cut to H8/4 (B1 N8192 bf16, the recompute tier): the kernel held
    against its plain version per row, then timed (device ms of the dQ
    kernel by name, CUDA-event ms) beside its bound, its plain version and
    ``torch.autograd.grad`` through ``scaled_dot_product_attention`` (dQ, dK
    and dV; K/V heads expanded); the pieces of the ``kernels`` line's row
    ``dq_cluster``, with the kernel's registers and spill bytes."""
    import torch.nn.functional as F

    from ffpa_attn_tpu_torch.cli._bench import sdpa_backend
    from ffpa_attn_tpu_torch.ops import flash_bwd, flash_fwd
    from ffpa_attn_tpu_torch.ops.config import dq_plan
    from ffpa_attn_tpu_torch.ops.dispatch import pick_backward_config
    from ffpa_attn_tpu_torch.ops.reference import expand_kv_heads
    from ffpa_attn_tpu_torch.utils.profiling import backward_counts

    b, hq, hkv, n, d, bf = 1, 8, 4, TRAIN_N, 1024, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(43)
    q, do = _randn((b, hq, n, d), bf, gen), _randn((b, hq, n, d), bf, gen)
    k, v = _randn((b, hkv, n, d), bf, gen), _randn((b, hkv, n, d), bf, gen)
    scale = d ** -0.5
    o, lse = flash_fwd.flash_attention_forward(q, k, v, None, scale=scale, is_causal=True)
    delta = (do.float() * o.float()).sum(-1)
    del o
    if dq_plan(d, d).route != "wgmma_cluster":
        fail(f"dQ at D{d} does not take the cluster route")
    cfg = pick_backward_config(d=d, dv=d, nq=n, nkv=n, dtype=bf)
    kw = dict(scale=scale, is_causal=True, causal_offset=0, dropout_p=0.0, group=hq // hkv)

    def run():
        return flash_bwd._dq_launch(q, k, v, None, do, lse, delta, 0, cfg,
                                    grad_q_storage_dtype=None, **kw)[0]

    def plain():
        return flash_bwd._dq_plain(q, k, v, None, do, lse, delta, scale=scale, emit_dbias=False,
                                   is_causal=True, causal_offset=0, dropout_p=0.0, seed=0,
                                   softcap=0.0, window=(-1, -1), alibi=None)[0]

    before = flash_bwd._dq_launch.launches
    kdq = run()
    torch.cuda.synchronize()
    if flash_bwd._dq_launch.launches != before + 1:
        fail("the dQ cluster call at D1024 launched no kernel")
    err = _hold(f"dq_cluster_N{n}_D{d}", {"dq": (kdq, plain())})
    del kdq
    torch.cuda.empty_cache()
    flops, nbytes = backward_counts("dq", b=b, hq=hq, hkv=hkv, nq=n, nkv=n, d=d, dv=d,
                                    causal=True)

    def timed():
        return _kernel_timed(run, flash_bwd.DQ_KERNELS, 10)

    kms = timed()
    pms = _timed(plain, 2, warmup=1)
    torch.cuda.empty_cache()
    ql, ke, ve = (t.detach().requires_grad_() for t in
                  (q, expand_kv_heads(k, hq), expand_kv_heads(v, hq)))
    out = F.scaled_dot_product_attention(ql, ke, ve, is_causal=True)
    lms = _timed(lambda: torch.autograd.grad(out, (ql, ke, ve), do, retain_graph=True), 3,
                 warmup=1)
    log(f"  dq cluster route (B{b} H{hq}/{hkv} N{n} D{d} causal bf16, recompute): "
        f"{kms[0]:.4f} ms [{kms[1]:.4f}], {flops / kms[0] / 1e9:.1f} TFLOP/s; plain "
        f"{pms[0]:.4f} ms; torch.autograd.grad through scaled_dot_product_attention "
        f"({sdpa_backend(ql, ke, ve, is_causal=True)} backend, K/V heads expanded, dQ dK dV) "
        f"{lms[0]:.4f} ms; max|err| vs plain {err:.3e}")
    del out, ql, ke, ve
    torch.cuda.empty_cache()
    a = flash_bwd.dq_kernel_attrs("wgmma_cluster")
    return dict(shape=f"B{b} H{hq}/{hkv} N{n} D{d} causal bf16", err=err, kms=kms, pms=pms,
                lms=lms, flops=flops, nbytes=nbytes, retime=timed, registers=a["registers"],
                spill_bytes=a["local_bytes"])


def dkdv_op_level_times() -> None:
    """dK/dV (with the dS slab, the handoff tier's launch) at the op-level
    headline's shape, B1 H32 MHA N8192 D512 causal bf16: held against its
    plain version on the first 8 heads (heads are independent), timed
    beside its bound and autograd of scaled_dot_product_attention (the
    dK/dV + dQ pair, as in the training row)."""
    import torch.nn.functional as F

    from ffpa_attn_tpu_torch.ops import flash_bwd, flash_fwd
    from ffpa_attn_tpu_torch.ops.config import dkdv_plan
    from ffpa_attn_tpu_torch.ops.dispatch import pick_backward_config
    from ffpa_attn_tpu_torch.utils.profiling import backward_counts, bound_ms

    b, h, n, d = 1, OP_HEADS, TRAIN_N, TRAIN["head_dim"]
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(14)
    q, k, v, do = (_randn((b, h, n, d), bf, gen) for _ in range(4))
    scale = d ** -0.5
    o, lse = flash_fwd.flash_attention_forward(q, k, v, None, scale=scale, is_causal=True)
    delta = (do.float() * o.float()).sum(-1)
    del o
    cfg = pick_backward_config(d=d, dv=d, nq=n, nkv=n, dtype=bf)
    kw = dict(scale=scale, is_causal=True, causal_offset=0, dropout_p=0.0, group=1)

    def run(heads=slice(None)):
        return flash_bwd._dkdv_launch(q[:, heads], k[:, heads], v[:, heads], None, do[:, heads],
                                      lse[:, heads], delta[:, heads], 0, cfg,
                                      grad_kv_storage_dtype=None, emit_ds=True, **kw)

    kdk, kdv, kds = run()
    torch.cuda.synchronize()
    h8 = slice(0, 8)
    pdk, pdv, pds = flash_bwd._dkdv_plain(
        q[:, h8], k[:, h8], v[:, h8], None, do[:, h8], lse[:, h8], delta[:, h8], scale=scale,
        emit_ds=True, nq_pad=n, nkv_pad=n, is_causal=True, causal_offset=0, dropout_p=0.0,
        seed=0, softcap=0.0, window=(-1, -1), alibi=None)
    _hold(f"dkdv_N{n}_H{h}", {"dk_h0-7": (kdk[:, h8], pdk), "dv_h0-7": (kdv[:, h8], pdv),
                              "ds_h0-7": (kds[:, h8], pds)})
    del kdk, kdv, kds, pdk, pdv, pds
    torch.cuda.empty_cache()
    kms = _timed(run, 5)
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    lms = _timed(lambda: torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True), 3)
    flops, nbytes = backward_counts("dkdv", b=b, hq=h, hkv=h, nq=n, nkv=n, d=d, dv=d,
                                    causal=True, slab_bytes=b * h * n * n * 2)
    bms, bby = bound_ms(flops, nbytes)
    log(f"  dkdv at the op-level shape (B{b} H{h} N{n} D{d} MHA, with the slab, route "
        f"{dkdv_plan(d, d).route}): {kms[0]:.4f} ms [{kms[1]:.4f}], {flops / kms[0] / 1e9:.1f} "
        f"TFLOP/s; bound {bms:.4f} ms ({bby}); library (autograd of "
        f"scaled_dot_product_attention, the pair) {lms[0]:.4f} ms [{lms[1]:.4f}]")
    del out, ql, kl, vl, q, k, v, do, lse, delta
    torch.cuda.empty_cache()


def banded_op_level_times() -> None:
    """Banded dQ and banded dK at the op-level headline's shape (B1 H32 MHA
    N8192 D512 causal bf16; one launch of each per backward), and each
    kernel's registers and local (spill) bytes. The slab holds random
    values on the band and zeros above it (the times do not depend on the
    values); each kernel is held against its plain version on the first 8
    heads (heads are independent) and timed beside one dense torch.matmul
    of the same operands. The launcher's tiling is held equal to its
    mirror, ``ops/config.py`` ``banded_plan``, at D 320..1024."""
    from ffpa_attn_tpu_torch.ops import flash_bwd
    from ffpa_attn_tpu_torch.utils.profiling import backward_counts

    for label, dk, dt in (("banded_dq bf16", False, torch.bfloat16),
                          ("banded_dq fp16", False, torch.float16),
                          ("banded_dk bf16", True, torch.bfloat16)):
        a = flash_bwd.banded_kernel_attrs(dk, dt)
        log(f"  {label}: {a['registers']} registers a thread at launch (cudaFuncGetAttributes; "
            f"setmaxnreg moves them to the consumer warpgroups), {a['local_bytes']} local "
            f"(spill) bytes")
    from ffpa_attn_tpu_torch.ops.config import banded_plan

    for hd in list(range(320, 1025, 64)) + [400]:
        if flash_bwd.banded_kernel_plan(hd) != banded_plan(hd):
            fail(f"banded launcher's plan at D{hd} {flash_bwd.banded_kernel_plan(hd)} differs "
                 f"from ops/config.py banded_plan {banded_plan(hd)}")
    log(f"  banded plan at D512: {flash_bwd.banded_kernel_plan(512)} (the launcher's, equal to "
        f"ops/config.py banded_plan at D 320..1024)")
    b, h, n, d = 1, OP_HEADS, TRAIN_N, TRAIN["head_dim"]
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(13)
    q, k = _randn((b, h, n, d), bf, gen), _randn((b, h, n, d), bf, gen)
    band = _band(n, n, True)
    slab = torch.empty((b, h, n, n), dtype=bf, device="cuda")
    for i in range(h):
        slab[:, i] = _randn((b, n, n), bf, gen).masked_fill_(~band, 0.0)
    del band
    kw = dict(scale=d ** -0.5, group=1, nq=n, nkv=n, causal_offset=0)

    def run_dq():
        return flash_bwd._banded_dq_from_ds(slab, k, None, dq_dtype=bf, **kw)

    def run_dk():
        return flash_bwd._banded_dk_from_ds(slab, q, None, dk_dtype=bf, **kw)

    s8 = slab[:, :8]
    _hold(f"banded_dq_N{n}_H{h}", {"dq_h0-7": (run_dq()[:, :8], flash_bwd._banded_dq_plain(
        s8, k[:, :8], scale=kw["scale"], nq=n, nkv=n))})
    _hold(f"banded_dk_N{n}_H{h}", {"dk_h0-7": (run_dk()[:, :8], flash_bwd._banded_dk_plain(
        s8, q[:, :8], scale=kw["scale"], nq=n, nkv=n, hkv=8))})
    del s8
    flops = backward_counts("banded_dq", b=b, hq=h, hkv=h, nq=n, nkv=n, d=d, dv=d,
                            causal=True)[0]
    for name, fn, lib in (("banded_dq", run_dq, lambda: torch.matmul(slab, k)),
                          ("banded_dk", run_dk, lambda: torch.matmul(slab.transpose(-1, -2), q))):
        kms, lms = _timed(fn, 10), _timed(lib, 10)
        log(f"  {name} at the op-level shape (B{b} H{h} N{n} D{d} MHA): {kms[0]:.4f} ms "
            f"[{kms[1]:.4f}], {flops / kms[0] / 1e9:.1f} TFLOP/s; library (dense "
            f"torch.matmul, twice the flop) {lms[0]:.4f} ms [{lms[1]:.4f}]")
    del slab, q, k
    torch.cuda.empty_cache()


def serving_times(errs: dict, serving: dict, wide: dict, model) -> tuple:
    """The serving path under the profiler (one packed prefill, 8 paged
    decode steps), then the varlen forward at the serving packing and paged
    decode at the serving step (page 256, each sequence 64 tokens into its
    generation), each beside its bound, its plain version and one PyTorch
    call: SDPA over the packed T with a block-diagonal causal bool mask, and
    for paged decode SDPA over the cache gathered dense with a length mask
    (a yardstick: the gather is not timed)."""
    import torch.nn.functional as F

    from ffpa_attn_tpu_torch.cli._bench import sdpa_backend
    from ffpa_attn_tpu_torch.models import init_kv_cache, pack_prompts, prefill_packed
    from ffpa_attn_tpu_torch.models.serving import _paged_decode_step
    from ffpa_attn_tpu_torch.ops import paged, varlen
    from ffpa_attn_tpu_torch.ops.config import KV_TILE, BlockConfig
    from ffpa_attn_tpu_torch.ops.paged import PagedKVCache, fill_from_prefill
    from ffpa_attn_tpu_torch.utils.profiling import (
        band_pairs, bound_ms, device_window, paged_decode_counts, varlen_counts,
    )

    cfg = model.cfg
    prompts = serving["prompts"]
    lens = [int(p.shape[0]) for p in prompts]
    packed, cu = pack_prompts(prompts, sum(lens))
    state = {}

    def run_prefill():
        cache = init_kv_cache(cfg, len(lens), max(lens))
        state["logits"], state["cache"] = prefill_packed(model, packed, cu, max(lens), cache)

    def run_steps():
        pools = [fill_from_prefill(
            PagedKVCache.alloc(len(lens), SERVE_MAX_LEN, cfg.n_kv_heads, cfg.head_dim,
                               SERVE_PAGE, dtype=cfg.torch_dtype), c["k"], c["v"], lens)
            for c in state["cache"]]
        tok = state["logits"].argmax(-1)
        for _ in range(8):
            logits, pools = _paged_decode_step(model, pools, tok)
            tok = logits.argmax(-1)

    log("where the time goes, continuous batching (torch.profiler, device time by kernel):")
    run_prefill()
    for name, fn in (("packed prefill", run_prefill), ("fill pools + paged decode x8", run_steps)):
        w = device_window(fn, reps=1, warmup=1)
        top = sorted(w["by_kernel"].items(), key=lambda kv: -kv[1])[:6]
        log(f"  {name}: wall {w['wall_ms']:.2f} ms, device {w['device_ms']:.2f} ms, "
            f"busy {w['busy'] * 100:.1f}% (idle {(1 - w['busy']) * 100:.1f}%)")
        for kname, ms in top:
            log(f"    {ms:9.3f} ms  {kname[:100]}")
    del state

    gen = torch.Generator(device="cuda").manual_seed(13)
    bf, hq, hkv, d = torch.bfloat16, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale = 1.0 / math.sqrt(d)
    rows, events = [], {}

    # Varlen forward at the serving packing (one prefill layer).
    q, k, v, cu_q, _ = _varlen_inputs(SERVE_LENS, hq=hq, hkv=hkv, d=d, gen=gen)
    t = q.shape[0]
    kw = dict(scale=scale, causal=True)

    def run_varlen():
        return varlen._varlen_forward(q, k, v, cu_q, cu_q, **kw)

    # The kernel alone; the wrapper also computes the metadata and the tile
    # schedule on the device (a few dozen small kernels) before it.
    flops, nbytes = varlen_counts(SERVE_LENS, SERVE_LENS, hq=hq, hkv=hkv, d=d, dv=d,
                                  causal=True)
    bms, bby = bound_ms(flops, nbytes)
    kms = _kernel_timed(run_varlen, varlen.FWD_KERNELS, 20)
    log(f"  varlen_fwd at the serving packing: device {kms[0]:.4f} ms, bound {bms:.4f} ms "
        f"({bby})")
    kms = _above_bound("varlen_fwd", kms, bms,
                       lambda: _kernel_timed(run_varlen, varlen.FWD_KERNELS, 20))
    wms = _timed(run_varlen, 20)
    log(f"  varlen_fwd at the serving packing: kernel {kms[0]:.4f} ms; the wrapper's device "
        f"time with its metadata and schedule {wms[0]:.4f} ms, CUDA events {wms[1]:.4f} ms")
    meta = varlen._call_metadata(cu_q, cu_q, t, t, "cuda")
    plan, rows_q, _, sched = varlen._varlen_fwd_tiles(meta, t, d, d, BlockConfig(), True,
                                                      (-1, -1))
    tiles_walked = int(sched[1].sum())
    band = sum(band_pairs(n, n, causal=True) for n in SERVE_LENS)
    log(f"  varlen_fwd walks {tiles_walked} tiles of {rows_q} x {KV_TILE} a head on its "
        f"{plan.route} route: {tiles_walked * rows_q * KV_TILE / band:.3f} x the band's pairs")
    meta = varlen._segment_metadata(cu_q, cu_q, t, t, t, t)
    pms = _timed(lambda: varlen._varlen_forward_plain(q, k, v, meta, **kw), 5)
    seg = torch.repeat_interleave(torch.arange(len(SERVE_LENS), device="cuda"),
                                  torch.tensor(SERVE_LENS, device="cuda"))
    r = torch.arange(t, device="cuda")
    block_causal = (seg[:, None] == seg[None, :]) & (r[None, :] <= r[:, None])
    qh, kh, vh = (x.transpose(0, 1)[None] for x in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=block_causal,
                                              enable_gqa=True)

    lms = _timed(library, 10)
    log(f"  library for varlen_fwd: scaled_dot_product_attention over the packed T{t} with a "
        f"block-diagonal causal bool mask "
        f"({sdpa_backend(qh, kh, vh, attn_mask=block_causal, enable_gqa=True)} backend)")
    rows.append(dict(
        name="varlen_fwd", route="cuda", source="ffpa_attn_tpu_torch/csrc/varlen_fwd.cu",
        replaces="ffpa_attn_tpu/ops/varlen.py:214", launches=serving["launches"]["varlen_fwd"],
        max_abs_err=errs["varlen_fwd"], ms=kms[0], plain_ms=pms[0], bound_ms=bms,
        bound_by=bby, library_ms=lms[0], wrapper_ms=wms[0], wrapper_event_ms=wms[1],
        kv_tiles_walked=tiles_walked,
    ))
    rows[-1].update(varlen_fwd_kernel_row_extras(d))
    events["varlen_fwd"] = (kms[1], pms[1], lms[1])
    del q, k, v, qh, kh, vh, block_causal
    torch.cuda.empty_cache()

    # Paged decode at the serving step (page 256), the same step over pages
    # of 24 rows, and at Dh1024 on the two-warpgroup block.
    serve = _paged_step_times(gen, d=d, page=SERVE_PAGE, hq=hq, hkv=hkv, label="paged_decode")
    p24 = _paged_step_times(gen, d=d, page=24, hq=hq, hkv=hkv, label="paged_decode page 24",
                            int8=False)
    wd = WIDE["head_dim"]
    wide_t = _paged_step_times(gen, d=wd, page=SERVE_PAGE, hq=hq, hkv=hkv,
                               label="paged_decode D1024")
    w24 = _paged_step_times(gen, d=wd, page=24, hq=hq, hkv=hkv, label="paged_decode D1024 page 24",
                            int8=False, plain=False, library=False)
    log("  yardstick for paged_decode (not one library call on the pools): "
        "scaled_dot_product_attention over the cache gathered dense, with a length mask")
    rows.append(dict(
        name="paged_decode", route="cuda", source="ffpa_attn_tpu_torch/csrc/paged_decode.cu",
        replaces="ffpa_attn_tpu/ops/paged.py:297",
        launches=serving["launches"]["paged_decode"], max_abs_err=errs["paged_decode"],
        ms=serve["ms"], plain_ms=serve["plain_ms"], bound_ms=serve["bound_ms"],
        bound_by=serve["bound_by"], library_ms=serve["library_ms"], walk_ms=serve["walk_ms"],
        merge_ms=serve["merge_ms"], int8_ms=serve["int8_ms"], int8_walk_ms=serve["int8_walk_ms"],
        int8_merge_ms=serve["int8_merge_ms"], int8_bound_ms=serve["int8_bound_ms"],
        page24_ms=p24["ms"], page24_walk_ms=p24["walk_ms"], page24_merge_ms=p24["merge_ms"],
        page24_bound_ms=p24["bound_ms"], page24_plain_ms=p24["plain_ms"],
        page24_library_ms=p24["library_ms"],
    ))
    rows[-1].update(paged_kernel_row_extras(d))
    events["paged_decode"] = serve["events"]
    rows.append(dict(
        name="paged_decode_wide", route="cuda", source="ffpa_attn_tpu_torch/csrc/paged_decode.cu",
        replaces="ffpa_attn_tpu/ops/paged.py:297",
        launches=wide["launches"]["page256"], max_abs_err=errs["paged_decode_wide"],
        ms=wide_t["ms"], plain_ms=wide_t["plain_ms"], bound_ms=wide_t["bound_ms"],
        bound_by=wide_t["bound_by"], library_ms=wide_t["library_ms"], walk_ms=wide_t["walk_ms"],
        merge_ms=wide_t["merge_ms"], int8_ms=wide_t["int8_ms"],
        int8_walk_ms=wide_t["int8_walk_ms"], int8_merge_ms=wide_t["int8_merge_ms"],
        int8_bound_ms=wide_t["int8_bound_ms"], page24_ms=w24["ms"], page24_walk_ms=w24["walk_ms"],
        page24_merge_ms=w24["merge_ms"], page24_bound_ms=w24["bound_ms"],
        launches_by_pool=wide["launches"], serving_tokens_per_s=wide["rates"],
    ))
    rows[-1].update(paged_kernel_row_extras(wd))
    events["paged_decode_wide"] = wide_t["events"]
    torch.cuda.empty_cache()
    return rows, events


def _paged_step_times(gen, *, d: int, page: int, hq: int, hkv: int, label: str,
                      int8: bool = True, plain: bool = True, library: bool = True) -> dict:
    """Paged decode at the serving step (B4, max_len 1152, each sequence 64
    tokens into its generation) at head dim ``d`` over pages of ``page``
    rows: four layers' pools in turn, so the K/V pages do not sit in L2.
    The wrapper's device time (the walk and the merge), then each launch
    alone by kernel name, beside the bound; over bf16 pools (and over int8
    ones with ``int8``), the plain version's time and SDPA over the cache
    gathered dense with a length mask (a yardstick: the gather is not
    timed)."""
    import torch.nn.functional as F

    from ffpa_attn_tpu_torch.ops import paged
    from ffpa_attn_tpu_torch.utils.profiling import bound_ms, paged_decode_counts

    step_lens = [n + 64 for n in SERVE_LENS]
    scale = 1.0 / math.sqrt(d)
    out = {}
    for quantized in (False, True) if int8 else (False,):
        pools = [_paged_pools(step_lens, page=page, max_len=SERVE_MAX_LEN, hkv=hkv, d=d,
                              quantized=quantized, gen=gen) for _ in range(SLICE["n_layers"])]
        qd = _randn((SERVE_B, hq, 1, d), torch.bfloat16, gen)
        it = iter(range(1 << 30))

        def pick():
            return pools[next(it) % len(pools)]

        def run_paged():
            return paged.paged_decode_attention(qd, pick(), scale=scale)

        tag = f"{label} int8" if quantized else label
        bms, bby = bound_ms(*paged_decode_counts(step_lens, hq=hq, hkv=hkv, d=d, dv=d, nq=1,
                                                 quantized=quantized))
        times = _above_bound(tag, _timed(run_paged, 100, warmup=8), bms,
                             lambda: _timed(run_paged, 100, warmup=8))
        times, parts = _hold_parts(
            tag, times, lambda: _timed(run_paged, 100, warmup=8),
            lambda: (_kernel_timed(run_paged, ("paged_tma_kernel",), 100)[0],
                     _kernel_timed(run_paged, ("split_merge_kernel",), 100)[0]))
        log(f"  {tag} at the serving step (D{d}, lens {step_lens}, page {page}): {times[0]:.4f} "
            f"ms [{times[1]:.4f}] = walk {parts[0]:.4f} + merge {parts[1]:.4f} ms, bound "
            f"{bms:.4f} ms ({bby})")
        key = "int8_" if quantized else ""
        out.update({f"{key}ms": times[0], f"{key}walk_ms": parts[0], f"{key}merge_ms": parts[1],
                    f"{key}bound_ms": bms})
        if quantized:
            continue
        out["bound_by"] = bby
        pms = lms = (float("nan"), float("nan"))
        if plain:
            qp = qd.reshape(SERVE_B, hkv, hq // hkv, d)
            pms = _timed(lambda: paged._paged_decode_plain(qp, pick(), nq=1, scale=scale,
                                                           softcap=0.0, window_left=-1), 20)
        if library:
            dense = [(paged._dense_rows(c.k_pages, c.page_table),
                      paged._dense_rows(c.v_pages, c.page_table)) for c in pools]
            cols = torch.arange(dense[0][0].shape[2], device="cuda")
            valid = (cols[None, :] < torch.tensor(step_lens, device="cuda")[:, None])[:, None, None]

            def gathered_sdpa():
                kc, vc = dense[next(it) % len(dense)]
                return F.scaled_dot_product_attention(qd, kc, vc, attn_mask=valid,
                                                      enable_gqa=True)

            lms = _timed(gathered_sdpa, 100, warmup=8)
            del dense
        out.update(plain_ms=pms[0], library_ms=lms[0], events=(times[1], pms[1], lms[1]))
        if plain or library:
            log(f"  {label}: plain {pms[0]:.4f} ms [{pms[1]:.4f}], gathered SDPA {lms[0]:.4f} ms "
                f"[{lms[1]:.4f}]")
        del pools
        torch.cuda.empty_cache()
    return out


def packed_training_times(packed: dict) -> tuple:
    """One bf16 packed forward + backward under the profiler, then the
    varlen dK/dV and dQ kernels at the 8192-token packing, each held
    against its plain version on the same inputs and timed beside it, its
    bound and, for the pair, autograd of scaled_dot_product_attention with
    the block-diagonal causal bool mask (K/V heads expanded)."""
    import torch.nn.functional as F

    from ffpa_attn_tpu_torch.cli._bench import sdpa_backend
    from ffpa_attn_tpu_torch import ffpa_attn_varlen_func
    from ffpa_attn_tpu_torch.ops import varlen
    from ffpa_attn_tpu_torch.ops.config import varlen_dkdv_plan, varlen_dq_plan
    from ffpa_attn_tpu_torch.ops.dispatch import pick_varlen_backward_config
    from ffpa_attn_tpu_torch.ops.reference import expand_kv_heads
    from ffpa_attn_tpu_torch.utils.profiling import (
        bound_ms, device_window, varlen_backward_counts, varlen_counts,
    )

    x = packed.pop("x")
    q, k, v, do, cu = x["q"], x["k"], x["v"], x["do"], x["cu"]
    t, hq, d = q.shape
    hkv, bf = k.shape[1], torch.bfloat16

    def fwd_bwd():
        leaves = [x_.detach().requires_grad_() for x_ in (q, k, v)]
        o = ffpa_attn_varlen_func(*leaves, cu, cu, max(PACK_LENS), max(PACK_LENS), causal=True,
                                  enable_gqa=True)
        o.backward(do)

    w = device_window(fwd_bwd, reps=1, warmup=1)
    log("where the time goes, packed training (torch.profiler, device time by kernel):")
    log(f"  forward + backward: wall {w['wall_ms']:.2f} ms, device {w['device_ms']:.2f} ms, "
        f"busy {w['busy'] * 100:.1f}% (idle {(1 - w['busy']) * 100:.1f}%)")
    for kname, ms in sorted(w["by_kernel"].items(), key=lambda kv: -kv[1])[:6]:
        log(f"    {ms:9.3f} ms  {kname[:100]}")
    # The call as the user makes it: the backward reads the forward's saved
    # tile schedule (one ``_tile_needed`` a call).
    cms = _timed(fwd_bwd, 5, warmup=2)
    log(f"  forward + backward on the saved schedule: device {cms[0]:.4f} ms, CUDA events "
        f"{cms[1]:.4f} ms a call (mean of 5)")

    # The varlen forward at this packing, beside the serving packing's row.
    def run_fwd():
        return varlen._varlen_forward(q, k, v, cu, cu, scale=d ** -0.5, causal=True)

    fbms, fbby = bound_ms(*varlen_counts(PACK_LENS, PACK_LENS, hq=hq, hkv=hkv, d=d, dv=d,
                                         causal=True))
    fkms = _above_bound("varlen_fwd (packed training)",
                        _kernel_timed(run_fwd, varlen.FWD_KERNELS, 10), fbms,
                        lambda: _kernel_timed(run_fwd, varlen.FWD_KERNELS, 10))
    fwms = _timed(run_fwd, 10)
    log(f"  varlen_fwd at the packed-training packing (T{t}): kernel {fkms[0]:.4f} ms "
        f"[{fkms[1]:.4f}], bound {fbms:.4f} ms ({fbby}); the wrapper's device time "
        f"{fwms[0]:.4f} ms, CUDA events {fwms[1]:.4f} ms")
    fwd_packed = dict(packed_training_ms=fkms[0], packed_training_bound_ms=fbms,
                      packed_training_wrapper_ms=fwms[0],
                      packed_training_wrapper_event_ms=fwms[1])

    kw = dict(scale=d ** -0.5, causal=True, softcap=0.0, window=(-1, -1))
    meta = varlen._call_metadata(cu, cu, t, t, "cuda")
    o, lse = varlen._varlen_forward(q, k, v, cu, cu, meta=meta, **kw)
    delta = varlen._varlen_delta(do, o)
    cfg = pick_varlen_backward_config(d=d, dv=d, dtype=bf)
    ops = varlen._BwdOperands(q, k, v, do, lse, delta, None)
    dkdv_sched, dq_sched = varlen._backward_schedules(
        meta, t, varlen_dkdv_plan(d, d), varlen_dq_plan(d, d), True, (-1, -1),
        varlen._call_walk(meta, t, True, (-1, -1)))
    rows, events = [], {}

    # The library call for the pair: autograd of SDPA over the packed T.
    seg = torch.repeat_interleave(torch.arange(len(PACK_LENS), device="cuda"),
                                  torch.tensor(PACK_LENS, device="cuda"))
    r = torch.arange(t, device="cuda")
    block_causal = (seg[:, None] == seg[None, :]) & (r[None, :] <= r[:, None])
    qh = q.transpose(0, 1)[None].detach().requires_grad_()
    kh = expand_kv_heads(k.transpose(0, 1)[None], hq).detach().requires_grad_()
    vh = expand_kv_heads(v.transpose(0, 1)[None], hq).detach().requires_grad_()
    out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=block_causal)
    doh = do.transpose(0, 1)[None]

    def library():
        return torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True)

    backend = sdpa_backend(qh, kh, vh, attn_mask=block_causal)
    lms = _timed(library, 3, warmup=1)
    log(f"  library for varlen_dkdv/varlen_dq: torch.autograd.grad through "
        f"scaled_dot_product_attention over the packed T{t} with a block-diagonal causal bool "
        f"mask ({backend} backend, K/V heads expanded)")
    del out, qh, kh, vh, block_causal
    torch.cuda.empty_cache()

    log("varlen backward kernels at the packed-training shape (T8192), kernel vs plain and "
        "times:")
    for name, replaces in (("varlen_dkdv", "ffpa_attn_tpu/ops/varlen.py:433"),
                           ("varlen_dq", "ffpa_attn_tpu/ops/varlen.py:489")):
        if name == "varlen_dkdv":
            def run():
                return varlen._varlen_dkdv_kernel(ops, meta, dkdv_sched, cfg, **kw)

            def run_plain():
                return varlen._varlen_dkdv_plain(q, k, v, do, lse, delta, meta, **kw)

            outs, kernels = ("dk", "dv"), varlen.DKDV_KERNELS
        else:
            def run():
                return (varlen._varlen_dq_kernel(ops, meta, dq_sched, **kw),)

            def run_plain():
                return (varlen._varlen_dq_plain(q, k, v, do, lse, delta, meta, **kw),)

            outs, kernels = ("dq",), varlen.DQ_KERNELS
        got = run()
        torch.cuda.synchronize()
        err = _hold(f"{name}_T{t}_causal", dict(zip(outs, zip(got, run_plain()))))
        del got
        flops, nbytes = varlen_backward_counts(name, PACK_LENS, PACK_LENS, hq=hq, hkv=hkv, d=d,
                                               dv=d, causal=True)
        bms, bby = bound_ms(flops, nbytes)
        kms = _kernel_timed(run, kernels, 10)
        log(f"  {name}: device {kms[0]:.4f} ms, CUDA events {kms[1]:.4f} ms, bound {bms:.4f} ms "
            f"({bby})")
        kms = _above_bound(name, kms, bms, lambda: _kernel_timed(run, kernels, 10))
        pms = _timed(run_plain, 3, warmup=1)
        rows.append(dict(
            name=name, route="cuda", source="ffpa_attn_tpu_torch/csrc/varlen_bwd.cu",
            replaces=replaces, launches=packed["launches"][name], max_abs_err=err, ms=kms[0],
            plain_ms=pms[0], bound_ms=bms, bound_by=bby, library_ms=lms[0],
        ))
        rows[-1].update(varlen_dkdv_kernel_row_extras(d) if name == "varlen_dkdv"
                        else varlen_dq_kernel_row_extras(d))
        events[name] = (kms[1], pms[1], lms[1])
        torch.cuda.empty_cache()
    wide_rows, wide_events = varlen_cluster_times(packed.pop("wide"))
    rows += wide_rows
    events.update(wide_events)
    return rows, events, fwd_packed


def varlen_cluster_times(wide: dict) -> tuple:
    """The varlen kernels' cluster routes (``PERF.md``'s rows "8 (D >
    512)", the forward, "9 (D > 512)", dK/dV, and "10 (D > 512)", dQ) at the
    wide routes' packing (``tools/torch_wide_bounds.py`` ``PACKING``: 8
    documents in 8192 tokens, H8/4 D1024 causal bf16, the inputs of
    ``phase_packed_training``'s D1024 call): each kernel alone on the call's
    one 64 x 64 walk, held against its plain version per row, then timed
    (device ms of the kernel by name, CUDA-event ms) beside its bound, its
    plain version and, for the forward, ``scaled_dot_product_attention``
    with the block-diagonal causal bool mask, for the backward pair
    ``torch.autograd.grad`` through it (K/V heads expanded; timed once for
    both). Returns the ``kernels`` line's rows ``varlen_fwd_cluster``,
    ``varlen_dkdv_cluster`` and ``varlen_dq_cluster`` (their launches those
    of the D1024 packed call through ``ffpa_attn_varlen_func``) and each
    one's (CUDA-event ms of the kernel, the plain version, the library
    call)."""
    import torch.nn.functional as F

    from ffpa_attn_tpu_torch.cli._bench import sdpa_backend
    from ffpa_attn_tpu_torch.ops import varlen
    from ffpa_attn_tpu_torch.ops.config import varlen_dkdv_plan, varlen_dq_plan, varlen_fwd_plan
    from ffpa_attn_tpu_torch.ops.dispatch import pick_varlen_backward_config
    from ffpa_attn_tpu_torch.ops.reference import expand_kv_heads
    from ffpa_attn_tpu_torch.utils.profiling import (
        bound_ms, varlen_backward_counts, varlen_counts,
    )

    x = wide.pop("x")
    q, k, v, do, cu = x["q"], x["k"], x["v"], x["do"], x["cu"]
    t, hq, d = q.shape
    hkv, bf = k.shape[1], torch.bfloat16
    kw = dict(scale=d ** -0.5, causal=True, softcap=0.0, window=(-1, -1))
    meta = varlen._call_metadata(cu, cu, t, t, "cuda")
    walk = varlen._call_walk(meta, t, True, (-1, -1))

    def run_fwd():
        return varlen._varlen_forward(q, k, v, cu, cu, meta=meta, walk=walk, **kw)

    o, lse = run_fwd()
    delta = varlen._varlen_delta(do, o)
    cfg = pick_varlen_backward_config(d=d, dv=d, dtype=bf)
    plans = {"varlen_fwd": varlen_fwd_plan(d, d), "varlen_dkdv": varlen_dkdv_plan(d, d),
             "varlen_dq": varlen_dq_plan(d, d)}
    ops = varlen._BwdOperands(q, k, v, do, lse, delta, None)
    dkdv_sched, dq_sched = varlen._backward_schedules(meta, t, plans["varlen_dkdv"],
                                                      plans["varlen_dq"], True, (-1, -1), walk)
    seg = torch.repeat_interleave(torch.arange(len(PACK_LENS), device="cuda"),
                                  torch.tensor(PACK_LENS, device="cuda"))
    r = torch.arange(t, device="cuda")
    block_causal = (seg[:, None] == seg[None, :]) & (r[None, :] <= r[:, None])
    qh = q.transpose(0, 1)[None].detach().requires_grad_()
    kh = expand_kv_heads(k.transpose(0, 1)[None], hq).detach().requires_grad_()
    vh = expand_kv_heads(v.transpose(0, 1)[None], hq).detach().requires_grad_()
    with torch.no_grad():
        flms = _timed(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=block_causal),
                      3, warmup=1)
    out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=block_causal)
    doh = do.transpose(0, 1)[None]
    backend = sdpa_backend(qh, kh, vh, attn_mask=block_causal)
    lms = _timed(lambda: torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True), 3,
                 warmup=1)
    del out, qh, kh, vh, block_causal
    torch.cuda.empty_cache()
    shape = f"{len(PACK_LENS)} documents in {t} tokens, H{hq}/{hkv} D{d} causal bf16"
    rows, events = [], {}

    # The forward's cluster: o per row and lse against the plain version
    # (every row of a causal packing keeps a key), then its times.
    fkw = dict(scale=kw["scale"], causal=True)
    po, plse = varlen._varlen_forward_plain(q, k, v, meta, **fkw)
    ferr, flerr = row_rel(o, po), rel(lse, plse)
    fmax = max_abs(o, po)
    ok = ferr < BF16_TOL and flerr < LSE_TOL and bool(torch.isfinite(o).all())
    log(f"  varlen_fwd_cluster_T{t}_D{d} row_rel_err {ferr:.2e} (tol {BF16_TOL:g}) lse_rel_err "
        f"{flerr:.2e} (tol {LSE_TOL:g}) max_abs_err {fmax:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"the varlen forward's cluster disagrees with its plain version at D{d}")
    del o, po, plse
    fbms, fbby = bound_ms(*varlen_counts(PACK_LENS, PACK_LENS, hq=hq, hkv=hkv, d=d, dv=d,
                                         causal=True))

    def fwd_timed():
        return _kernel_timed(run_fwd, varlen.FWD_KERNELS, 10)

    fkms = _above_bound(f"varlen_fwd cluster (D{d})", fwd_timed(), fbms, fwd_timed)
    fpms = _timed(lambda: varlen._varlen_forward_plain(q, k, v, meta, **fkw), 2, warmup=1)
    torch.cuda.empty_cache()
    a = varlen.varlen_fwd_kernel_attrs("wgmma_cluster")
    log(f"  varlen_fwd cluster route ({shape}): device {fkms[0]:.4f} ms, CUDA events "
        f"{fkms[1]:.4f} ms, bound {fbms:.4f} ms ({fbby}); plain {fpms[0]:.4f} ms; "
        f"scaled_dot_product_attention ({backend} backend, block-diagonal causal bool mask, K/V "
        f"heads expanded) {flms[0]:.4f} ms; {a['registers']} registers, {a['local_bytes']} "
        f"spill bytes")
    rows.append(dict(
        name="varlen_fwd_cluster", row="8 (D > 512)", route="cuda",
        source="ffpa_attn_tpu_torch/csrc/varlen_fwd.cu", replaces="ffpa_attn_tpu/ops/varlen.py:214",
        launches=wide["launches"]["varlen_fwd"], max_abs_err=fmax, ms=fkms[0], plain_ms=fpms[0],
        bound_ms=fbms, bound_by=fbby, library_ms=flms[0], event_ms=fkms[1], shape=shape,
        varlen_fwd_route=plans["varlen_fwd"].route, kernel="tma::varlen_fwd_wgmma_kernel<T, true>",
        registers=a["registers"], spill_bytes=a["local_bytes"],
    ))
    events["varlen_fwd_cluster"] = (fkms[1], fpms[1], flms[1])

    for name, row_id, replaces in (
            ("varlen_dkdv", "9 (D > 512)", "ffpa_attn_tpu/ops/varlen.py:433"),
            ("varlen_dq", "10 (D > 512)", "ffpa_attn_tpu/ops/varlen.py:489")):
        if name == "varlen_dkdv":
            def run():
                return varlen._varlen_dkdv_kernel(ops, meta, dkdv_sched, cfg, **kw)

            def plain():
                return varlen._varlen_dkdv_plain(q, k, v, do, lse, delta, meta, **kw)

            outs, kernels = ("dk", "dv"), varlen.DKDV_KERNELS
            attrs = varlen.varlen_dkdv_kernel_attrs
        else:
            def run():
                return (varlen._varlen_dq_kernel(ops, meta, dq_sched, **kw),)

            def plain():
                return (varlen._varlen_dq_plain(q, k, v, do, lse, delta, meta, **kw),)

            outs, kernels, attrs = ("dq",), varlen.DQ_KERNELS, varlen.varlen_dq_kernel_attrs
        got = run()
        torch.cuda.synchronize()
        err = _hold(f"{name}_cluster_T{t}_D{d}", dict(zip(outs, zip(got, plain()))))
        del got
        torch.cuda.empty_cache()
        flops, nbytes = varlen_backward_counts(name, PACK_LENS, PACK_LENS, hq=hq, hkv=hkv,
                                               d=d, dv=d, causal=True)
        bms, bby = bound_ms(flops, nbytes)

        def timed():
            return _kernel_timed(run, kernels, 10)

        kms = _above_bound(f"{name} cluster (D{d})", timed(), bms, timed)
        pms = _timed(plain, 2, warmup=1)
        torch.cuda.empty_cache()
        a = attrs("wgmma_cluster")
        log(f"  {name} cluster route ({shape}): device {kms[0]:.4f} ms, CUDA events "
            f"{kms[1]:.4f} ms, {flops / kms[0] / 1e9:.1f} TFLOP/s, bound {bms:.4f} ms ({bby}); "
            f"plain {pms[0]:.4f} ms; torch.autograd.grad through scaled_dot_product_attention "
            f"({backend} backend, block-diagonal causal bool mask, K/V heads expanded, the "
            f"dK/dV + dQ pair) {lms[0]:.4f} ms; max|err| vs plain {err:.3e}; "
            f"{a['registers']} registers, {a['local_bytes']} spill bytes")
        rows.append(dict(
            name=f"{name}_cluster", row=row_id, route="cuda",
            source="ffpa_attn_tpu_torch/csrc/varlen_bwd.cu", replaces=replaces,
            launches=wide["launches"][name], max_abs_err=err, ms=kms[0], plain_ms=pms[0],
            bound_ms=bms, bound_by=bby, library_ms=lms[0], event_ms=kms[1], shape=shape,
            **{f"{name}_route": plans[name].route},
            kernel=f"tma::{name}_wgmma_kernel<T, true>", registers=a["registers"],
            spill_bytes=a["local_bytes"], packed_call_grad_errs=wide["errs"],
        ))
        events[f"{name}_cluster"] = (kms[1], pms[1], lms[1])
    return rows, events


def decode_step_times(gen, d: int) -> dict:
    """Decode at head dim ``d`` at the generate step (B1 H8/4 Nkv = max_len,
    GQA group 2, the validity bias up to the prompt's last row), then at the
    serving step (B4, max_len 1152, the shared-row bias with its gap, 64
    tokens into generation). Four caches, one per layer, so K/V (34.6 MB,
    37.7 MB a layer at D512) do not sit in L2. The wrapper's device time
    (the walk and the merge), then each launch alone by kernel name; the
    host's share of a call is its CUDA-event ms less its device ms. The
    bound counts the cache rows the output depends on, those the bias
    leaves live (the kernel also reads the masked tail of the generate step
    and the serving step's gap), plus the bias read and lse written. At the
    generate step also the call with the score residual, the plain version
    and SDPA with the bias. Returns {"generate" / "serving": (kms, (walk,
    merge), bound, bound_by), "scores", "plain", "library": (device ms,
    CUDA-event ms)}."""
    import torch.nn.functional as F

    from ffpa_attn_tpu_torch.ops import decode
    from ffpa_attn_tpu_torch.ops.reference import DEFAULT_MASK_VALUE
    from ffpa_attn_tpu_torch.utils.profiling import bound_ms, paged_decode_counts

    bf, hq, hkv = torch.bfloat16, SLICE["n_heads"], SLICE["n_kv_heads"]
    scale = 1.0 / math.sqrt(d)
    out = {}
    for label, db, nkv in (("generate", 1, MAX_LEN), ("serving", SERVE_B, SERVE_MAX_LEN)):
        caches = [(_randn((db, hkv, nkv, d), bf, gen), _randn((db, hkv, nkv, d), bf, gen))
                  for _ in range(SLICE["n_layers"])]
        qd = _randn((db, hq, 1, d), bf, gen)
        if label == "generate":
            cols = torch.arange(nkv, device="cuda")
            bias = torch.where(cols <= PROMPT, 0.0, DEFAULT_MASK_VALUE).float()[None, None, None]
        else:
            bias = _serve_gap_bias(nkv, SERVE_LENS, 64)
        it = iter(range(1 << 30))

        def pick(caches=caches, it=it):
            return caches[next(it) % len(caches)]

        def run_kernel(qd=qd, bias=bias, pick=pick):
            kc, vc = pick()
            return decode._decode_forward(qd, kc, vc, bias, scale=scale, is_causal=False)

        tag = f"decode D{d} ({label})"
        live = (bias > DEFAULT_MASK_VALUE / 2).sum(dim=-1).flatten().tolist()
        flop, nbytes = paged_decode_counts(live, hq=hq, hkv=hkv, d=d, dv=d)
        bms, bby = bound_ms(flop, nbytes + 4 * bias.numel() + 4 * db * hq)
        kms = _above_bound(tag, _timed(run_kernel, 100, warmup=8), bms,
                           lambda run_kernel=run_kernel: _timed(run_kernel, 100, warmup=8))
        kms, parts = _hold_parts(
            tag, kms, lambda run_kernel=run_kernel: _timed(run_kernel, 100, warmup=8),
            lambda run_kernel=run_kernel: (
                _kernel_timed(run_kernel, ("decode_tma_kernel",), 100)[0],
                _kernel_timed(run_kernel, ("split_merge_kernel",), 100)[0]))
        log(f"  decode D{d} at the {label} step (B{db} Nkv {nkv}): {kms[0]:.4f} ms [{kms[1]:.4f}] "
            f"= walk {parts[0]:.4f} + merge {parts[1]:.4f} ms, bound {bms:.4f} ms ({bby}), host "
            f"{kms[1] - kms[0]:.4f} ms a call (CUDA events less device)")
        out[label] = (kms, parts, bms, bby)
        if label == "serving":
            break
        bias_bf = bias.to(bf)

        def run_kernel_scores(qd=qd, bias=bias, pick=pick):
            kc, vc = pick()
            return decode._decode_forward(qd, kc, vc, bias, scale=scale, is_causal=False,
                                          return_scores=True)

        def run_plain(qd=qd, bias=bias, pick=pick):
            kc, vc = pick()
            return decode._decode_plain(qd.reshape(db, hkv, hq // hkv, d), kc, vc, bias, nq=1,
                                        scale=scale, is_causal=False, softcap=0.0,
                                        window_left=-1, window_right=-1)

        def run_library(qd=qd, bias_bf=bias_bf, pick=pick):
            kc, vc = pick()
            return F.scaled_dot_product_attention(qd, kc, vc, attn_mask=bias_bf,
                                                  enable_gqa=True)

        out["scores"] = _timed(run_kernel_scores, 100, warmup=8)
        log(f"  decode D{d} at the generate step with the score residual: "
            f"{out['scores'][0]:.4f} ms [{out['scores'][1]:.4f}]")
        out["plain"] = _timed(run_plain, 40)
        out["library"] = _timed(run_library, 100, warmup=8)
        del caches
    torch.cuda.empty_cache()
    return out


def phase_times(errs: dict, main_path: dict, training: dict, windowed: dict,
                resident: dict, serving: dict, packed: dict, fp8_training: dict,
                wide: dict, wide_dense: dict) -> list:
    import torch.nn.functional as F

    from ffpa_attn_tpu_torch.ops import flash_fwd
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
    bms, bby = bound_ms(flops, nbytes)
    kms = _above_bound("flash_fwd (prefill)",
                       _timed(lambda: flash_fwd.flash_attention_forward(q, k, v, None, **kw), 20),
                       bms,
                       lambda: _timed(lambda: flash_fwd.flash_attention_forward(q, k, v, None,
                                                                                 **kw), 20))
    pms = _timed(lambda: flash_fwd.flash_attention_forward_plain(q, k, v, None, **kw), 5)
    lms = _timed(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                        enable_gqa=True), 10)
    sms = _timed(lambda: flash_fwd.flash_attention_forward(q, k, v, None, return_scores=True,
                                                           **kw), 20)
    log(f"  flash_fwd at the prefill shape: {kms[0]:.4f} ms [{kms[1]:.4f}] without the S "
        f"residual, {sms[0]:.4f} ms [{sms[1]:.4f}] with it")
    rows.append(dict(
        name="flash_fwd", route="cuda", source="ffpa_attn_tpu_torch/csrc/flash_fwd.cu",
        replaces="ffpa_attn_tpu/ops/flash_fwd.py:77", launches=launches["flash_fwd"],
        max_abs_err=errs["flash_fwd"], ms=kms[0], plain_ms=pms[0], bound_ms=bms,
        bound_by=bby, library_ms=lms[0], ms_with_scores=sms[0],
    ))
    rows[-1].update(fwd_kernel_row_extras(d))
    rows[-1].update(fwd_cluster_times())
    events = {"flash_fwd": (kms[1], pms[1], lms[1])}

    dec = decode_step_times(gen, d)
    (kms, parts, bms, bby), serve = dec["generate"], dec["serving"]
    rows.append(dict(
        name="decode", route="cuda", source="ffpa_attn_tpu_torch/csrc/decode.cu",
        replaces="ffpa_attn_tpu/ops/decode.py:52", launches=launches["decode"],
        max_abs_err=errs["decode"], ms=kms[0], plain_ms=dec["plain"][0], bound_ms=bms,
        bound_by=bby, library_ms=dec["library"][0], walk_ms=parts[0], merge_ms=parts[1],
        ms_with_scores=dec["scores"][0], serving_ms=serve[0][0], serving_walk_ms=serve[1][0],
        serving_merge_ms=serve[1][1], serving_bound_ms=serve[2],
    ))
    rows[-1].update(decode_kernel_row_extras(d))
    events["decode"] = (kms[1], dec["plain"][1], dec["library"][1])
    # Row 7 (D > 512): the two-warpgroup instance at the Dh1024 model's steps.
    wd = WIDE["head_dim"]
    dec = decode_step_times(gen, wd)
    (kms, parts, bms, bby), serve = dec["generate"], dec["serving"]
    rows.append(dict(
        name="decode_wide", row="7 (D > 512)", route="cuda",
        source="ffpa_attn_tpu_torch/csrc/decode.cu", replaces="ffpa_attn_tpu/ops/decode.py:52",
        launches=wide_dense["launches"]["generate"],
        serving_launches=wide_dense["launches"]["serve_batch"],
        max_abs_err=errs["decode_wide"], ms=kms[0], plain_ms=dec["plain"][0], bound_ms=bms,
        bound_by=bby, library_ms=dec["library"][0], walk_ms=parts[0], merge_ms=parts[1],
        ms_with_scores=dec["scores"][0], serving_ms=serve[0][0], serving_walk_ms=serve[1][0],
        serving_merge_ms=serve[1][1], serving_bound_ms=serve[2],
        generate_tokens_per_s=wide_dense["rates"]["generate"],
        serving_tokens_per_s=wide_dense["rates"]["serve_batch"],
    ))
    rows[-1].update(decode_kernel_row_extras(wd))
    events["decode_wide"] = (kms[1], dec["plain"][1], dec["library"][1])
    torch.cuda.empty_cache()
    serve_rows, serve_events = serving_times(errs, serving, wide, main_path["model"])
    train_rows, train_events, fwd_train = training_times(training, windowed, resident,
                                                         errs["from_s_cluster_launches"],
                                                         errs["dq_cluster_launches"],
                                                         fp8_training)
    rows[0].update(fwd_train)  # the flash_fwd row: the training shape beside the prefill
    packed_rows, packed_events, fwd_packed = packed_training_times(packed)
    serve_rows[0].update(fwd_packed)  # the varlen_fwd row: the 8192 packing beside serving
    rows += train_rows + serve_rows + packed_rows
    for ev in (train_events, serve_events, packed_events):
        events.update(ev)
    log("times (device ms per call from torch.profiler; CUDA-event ms per call in brackets):")
    for r in rows:
        ev = events[r["name"]]
        log(f"  {r['name']:<10} kernel_ms {r['ms']:.4f} [{ev[0]:.4f}] bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_by']}) plain_ms {r['plain_ms']:.4f} [{ev[1]:.4f}] "
            f"library_ms {r['library_ms']:.4f} [{ev[2]:.4f}] launches {r['launches']}")
    return rows


# ---------------------------------------------------------------------------
# Autotune: the tuned-config store, its lookup and the search
# ---------------------------------------------------------------------------

# The searched tasks: the backward at B1 H8/4 N4096 D512 causal bf16 (the
# S-resident tier at that size), the packed forward + backward over 4
# documents of 2048 tokens (H8/4 D512), and decode at the generate step
# (B1 H8/4 Nkv 4224) at D512 and D1024.
TUNE_BWD = dict(b=1, hq=8, hkv=4, n=4096, d=512)
TUNE_VARLEN_T = 8192
TUNE_DECODE = ((512, 4224), (1024, 4224))


def _event_ms(run, reps: int = 10, before=lambda: None) -> float:
    """CUDA-event ms per call of ``run`` alone (``before`` runs ahead of
    each call, off the clock), the mean over ``reps`` after one warm-up."""
    before()
    run()
    total = 0.0
    for _ in range(reps):
        before()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def ring_cap_times() -> dict:
    """Each backward kernel that takes its ring depth at run time, at its
    main-path shape, at every cap from the plan's depth down to the fewest
    stages its walk holds: the outputs at every cap held bit-equal to the
    plan's (the device code is the same; only the ring's depth and the
    shared memory change), and each cap's CUDA-event ms. Returns
    {kernel row: {"plan_stages", "min_stages", "ms": {cap: ms}}} (cap 0 is
    the plan's depth)."""
    from ffpa_attn_tpu_torch.ops import flash_bwd, flash_fwd, varlen
    from ffpa_attn_tpu_torch.ops.config import (
        DKDV_MIN_STAGES, DQ_MIN_STAGES, BlockConfig, dkdv_plan, dq_plan, from_s_min_stages,
        from_s_plan, varlen_dkdv_plan, varlen_dq_plan,
    )

    bf = torch.bfloat16
    n, d, hq, hkv = TRAIN_N, TRAIN["head_dim"], TRAIN["n_heads"], TRAIN["n_kv_heads"]
    gen = torch.Generator(device="cuda").manual_seed(29)
    q = _randn((1, hq, n, d), bf, gen)
    k, v = (_randn((1, hkv, n, d), bf, gen) for _ in range(2))
    do = _randn((1, hq, n, d), bf, gen)
    scale = d ** -0.5
    out = {}

    def sweep(name, run, stages, least, before=lambda: None):
        before()
        ref = [t.clone() for t in run(0)]
        ms = {}
        for cap in [0] + list(range(stages - 1, least - 1, -1)):
            before()
            got = run(cap)
            for a, b in zip(got, ref):
                if not torch.equal(a, b):
                    fail(f"{name} at ring cap {cap}: outputs differ from the plan's depth "
                         f"({stages} stages)")
            ms[cap] = _event_ms(lambda: run(cap), before=before)
        out[name] = dict(plan_stages=stages, min_stages=least, ms=ms)
        log(f"  {name}: bit-equal at every ring cap; CUDA-event ms by cap (0 = the plan's "
            f"{stages} stages): " + " ".join(f"{c}:{m:.4f}" for c, m in ms.items()))

    kw = dict(scale=scale, is_causal=True, causal_offset=0, dropout_p=0.0, group=hq // hkv)
    o, lse = flash_fwd.flash_attention_forward(q, k, v, None, scale=scale, is_causal=True)
    delta = (do.float() * o.float()).sum(-1)
    sweep("dkdv", lambda c: flash_bwd._dkdv_launch(
        q, k, v, None, do, lse, delta, 0, BlockConfig(bwd_ring_cap=c),
        grad_kv_storage_dtype=None, emit_ds=True, **kw), dkdv_plan(d, d).stages, DKDV_MIN_STAGES)
    wo, wlse = flash_fwd.flash_attention_forward(q, k, v, None, scale=scale, is_causal=True,
                                                 window=(WINDOW, -1))
    wdelta = (do.float() * wo.float()).sum(-1)
    sweep("dq", lambda c: flash_bwd._dq_launch(
        q, k, v, None, do, wlse, wdelta, 0, BlockConfig(bwd_ring_cap=c),
        grad_q_storage_dtype=None, window=(WINDOW, -1), **kw)[:1], dq_plan(d, d).stages,
        DQ_MIN_STAGES)
    so, slse, s0 = flash_fwd.flash_attention_forward(q, k, v, None, scale=scale, is_causal=True,
                                                     return_scores=True)
    sdelta = (do.float() * so.float()).sum(-1)
    slab = s0.clone()
    dk_out = BlockConfig(dkdv_dk_in_kernel=False)

    def from_s(c):
        _, dv_, ds_ = flash_bwd._dkdv_from_s_launch(
            q, v, slab, do, slse, sdelta, 0, replace(dk_out, bwd_ring_cap=c),
            grad_kv_storage_dtype=None, **kw)
        return dv_, ds_

    sweep("dkdv_from_s", from_s, from_s_plan(d, False).stages, from_s_min_stages(d),
          before=lambda: slab.copy_(s0))
    del s0, slab
    x = packed_inputs(bf)
    t = sum(PACK_LENS)
    vkw = dict(scale=scale, causal=True, softcap=0.0, window=(-1, -1))
    meta = varlen._call_metadata(x["cu"], x["cu"], t, t, "cuda")
    vo, vlse = varlen._varlen_forward(x["q"], x["k"], x["v"], x["cu"], x["cu"], meta=meta, **vkw)
    ops = varlen._BwdOperands(x["q"], x["k"], x["v"], x["do"], vlse,
                              varlen._varlen_delta(x["do"], vo), None)
    dkdv_sched, dq_sched = varlen._backward_schedules(
        meta, t, varlen_dkdv_plan(d, d), varlen_dq_plan(d, d), True, (-1, -1),
        varlen._call_walk(meta, t, True, (-1, -1)))
    vcfg = BlockConfig(dkdv_col_passes=varlen_dkdv_plan(d, d).passes)
    sweep("varlen_dkdv", lambda c: varlen._varlen_dkdv_kernel(
        ops, meta, dkdv_sched, replace(vcfg, bwd_ring_cap=c), **vkw),
        varlen_dkdv_plan(d, d).stages, DKDV_MIN_STAGES)
    sweep("varlen_dq", lambda c: (varlen._varlen_dq_kernel(
        ops, meta, dq_sched, replace(vcfg, bwd_ring_cap=c), **vkw),),
        varlen_dq_plan(d, d).stages, DQ_MIN_STAGES)
    return out


def _lookup_us(fn, reps: int = 20000) -> float:
    """µs a call of ``fn`` on the host (the least of 5 runs of ``reps``)."""
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, (time.perf_counter() - t0) / reps * 1e6)
    return best


def phase_autotune(smi: str) -> dict:
    """``_autotune_in`` a temporary directory, removed after."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="ffpa_tuned_") as root:
        return _autotune_in(smi, root)


def _autotune_in(smi: str, root: str) -> dict:
    """The tuned-config store on the card, with ``FFPA_TORCH_TUNED_CONFIG_DIR``
    a new directory under ``root``:

    1. searches one ``bwd`` task (``TUNE_BWD``), one ``varlen`` task and two
       ``decode`` tasks (``TUNE_DECODE``: the rule's count alone) and writes
       their winners, logging every reading (the plan's between the
       others') and the plan's spread;
    2. runs each direction's call tuned and untuned
       (``FFPA_TORCH_SKIP_TUNED_CONFIG=1``): the backward and the packed
       backward bit-equal to each other (a ring cap changes no arithmetic)
       and to the fp32 oracle / the per-segment dense path at the gradient
       tolerances, decode per row against its plain version;
    3. checks that each pick equals the stored entry, that a stored entry at
       the shallowest ring reaches the launch (its call bit-equal) and one of
       other head dims does not, and times every backward kernel at each
       ring cap (``ring_cap_times``: bit-equal to the plan's);
    4. runs ``python -m ffpa_attn_tpu_torch.autotune --isolate-tasks`` on one
       decode task and reads its entry back through the lookup;
    5. runs ``verify`` on one backward case (its dQ gate must pass);
    6. times the lookup on the host: an empty store, a memoised hit, a
       query with no matching entry.

    Any miss fails the run. Returns the times for the ``kernels`` line and
    the log."""
    from ffpa_attn_tpu_torch import ffpa_attn_func
    from ffpa_attn_tpu_torch.autotune import search, store, verify
    from ffpa_attn_tpu_torch.ops import decode
    from ffpa_attn_tpu_torch.ops.config import from_s_min_stages
    from ffpa_attn_tpu_torch.ops.dispatch import (
        pick_backward_config, pick_varlen_backward_config,
    )
    from ffpa_attn_tpu_torch.ops.reference import (
        expand_kv_heads, reduce_q_heads, reference_attention,
    )

    t_start = time.perf_counter()
    bf = torch.bfloat16
    kind = torch.cuda.get_device_name(0)
    res: dict = {"device_kind": kind}
    tmp, out_dir, empty = (os.path.join(root, n) for n in ("store", "cli", "empty"))
    os.makedirs(empty)
    with _env("FFPA_TORCH_TUNED_CONFIG_DIR", tmp):
        store.clear_lookup_cache()
        # 1. The searches.
        cb = TUNE_BWD
        gen = torch.Generator(device="cuda").manual_seed(290)
        q = _randn((cb["b"], cb["hq"], cb["n"], cb["d"]), bf, gen)
        k, v = (_randn((cb["b"], cb["hkv"], cb["n"], cb["d"]), bf, gen) for _ in range(2))
        do = _randn(q.shape, bf, gen)
        scale = cb["d"] ** -0.5
        group = cb["hq"] // cb["hkv"]
        found = search.autotune_backward(q, k, v, None, scale=scale, is_causal=True)
        bwd_key = store.ConfigKey("bwd", "bfloat16", cb["d"], cb["d"], cb["n"], cb["n"], True,
                                  False, False, True, group)
        x = packed_inputs(bf)
        t = sum(PACK_LENS)
        cu4 = torch.tensor([0, t // 4, t // 2, 3 * t // 4, t], dtype=torch.int32, device="cuda")
        vfound = search.autotune_varlen(x["q"], x["k"], x["v"], cu4, t // 4, scale=scale)
        var_key = store.ConfigKey("varlen", "bfloat16", cb["d"], cb["d"], t, t, False, False,
                                  False, False, 0)
        dfound, dec_keys, dec_in = {}, {}, {}
        for d_, nkv in TUNE_DECODE:
            dq_ = _randn((1, 8, 1, d_), bf, gen)
            dk_, dv_ = (_randn((1, 4, nkv, d_), bf, gen) for _ in range(2))
            dec_in[d_] = (dq_, dk_, dv_)
            dfound[d_] = search.autotune_decode(dq_, dk_, dv_, scale=d_ ** -0.5)
            dec_keys[d_] = store.ConfigKey("decode", "bfloat16", d_, d_, 1, nkv, False, False,
                                           False, True, 2)
        entries = [store.make_entry(bwd_key, found.config, found.ms),
                   store.make_entry(var_key, vfound.config, vfound.ms)]
        entries += [store.make_entry(dec_keys[d_], dfound[d_].config, dfound[d_].ms)
                    for d_, _ in TUNE_DECODE]
        path = store.write_config_file(entries)
        if path.name != f"{store.sanitize_device_kind(kind)}.json":
            fail(f"the store wrote {path.name}, not the card's name {kind}")

        def label(c):
            return (f"cap {c.bwd_ring_cap}" if c.bwd_ring_cap else "plan") + (
                "" if c.ds_store_bits == 16 else " e4m3")

        founds = {"bwd": found, "varlen": vfound,
                  **{f"decode_d{d_}": dfound[d_] for d_, _ in TUNE_DECODE}}
        res["searched"] = {name: [[label(c), ms] for c, ms in f_.tried]
                           for name, f_ in founds.items()}
        res["winners"] = {name: label(f_.config) for name, f_ in founds.items()}
        for name, f_ in founds.items():
            log(f"  autotune search {name}: readings in order "
                + " ".join(f"{label(c)}:{ms:.4f}" for c, ms in f_.tried)
                + f"; plan median {f_.plan_ms:.4f} ms, spread {f_.plan_spread:.4f} ms; "
                f"stored {label(f_.config)} at {f_.ms:.4f} ms")

        # 2 and 3. Tuned and untuned calls, and the picks.
        def bwd_call():
            leaves = [x_.detach().requires_grad_() for x_ in (q, k, v)]
            launch_counts(zero=True)
            ffpa_attn_func(*leaves, is_causal=True, enable_gqa=True).backward(do)
            torch.cuda.synchronize()
            return [x_.grad for x_ in leaves], _launched()

        tuned_g, tuned_l = bwd_call()
        with _env("FFPA_TORCH_SKIP_TUNED_CONFIG", "1"):
            plain_g, plain_l = bwd_call()
        sl = [x_.float().requires_grad_() for x_ in (q, expand_kv_heads(k, cb["hq"]),
                                                     expand_kv_heads(v, cb["hq"]))]
        oracle = torch.autograd.grad(reference_attention(*sl, is_causal=True), sl, do.float())
        oracle = [oracle[0]] + [reduce_q_heads(g, cb["hkv"]) for g in oracle[1:]]
        errs = [rel(g, w) for g, w in zip(tuned_g, oracle)]
        if not all(torch.equal(a, b) for a, b in zip(tuned_g, plain_g)) or tuned_l != plain_l:
            fail(f"the tuned backward ({found.config}) is not bit-equal to the untuned one "
                 f"(launches {tuned_l} / {plain_l})")
        if max(errs) >= GRAD_TOL[bf]:
            fail(f"the tuned backward's gradients are off the fp32 oracle: {errs}")
        pick = pick_backward_config(d=cb["d"], dv=cb["d"], nq=cb["n"], nkv=cb["n"], dtype=bf,
                                    causal=True, gqa=True, group=group)
        if (pick.bwd_ring_cap, pick.ds_store_bits) != (found.config.bwd_ring_cap,
                                                       found.config.ds_store_bits):
            fail(f"pick_backward_config {pick} is not the stored {found.config}")
        # A stored entry at the shallowest ring of the tier reaches the launch.
        least = from_s_min_stages(cb["d"])
        store.write_config_file([store.make_entry(bwd_key, replace(found.config,
                                                                   bwd_ring_cap=least))],
                                overwrite=True)
        shallow_g, shallow_l = bwd_call()
        if pick_backward_config(d=cb["d"], dv=cb["d"], nq=cb["n"], nkv=cb["n"], dtype=bf,
                                causal=True, gqa=True, group=group).bwd_ring_cap != least:
            fail("a stored ring cap did not reach pick_backward_config")
        if pick_backward_config(d=640, dv=640, nq=cb["n"], nkv=cb["n"], dtype=bf, causal=True,
                                gqa=True, group=group).bwd_ring_cap != 0:
            fail("a ring cap stored at D512 reached a D640 backward")
        if not all(torch.equal(a, b) for a, b in zip(shallow_g, plain_g)):
            fail(f"the backward at a stored ring cap of {least} is not bit-equal to the plan's")
        log(f"  autotune bwd B1 H8/4 N{cb['n']} D{cb['d']} causal: tuned and untuned calls "
            f"bit-equal, launches {tuned_l}, gradients vs the fp32 oracle "
            + " ".join(f"{e:.2e}" for e in errs) + f" (tol {GRAD_TOL[bf]:g}); a stored cap of "
            f"{least} bit-equal too, not taken at D640; picks equal the stored entries")
        store.write_config_file([store.make_entry(bwd_key, found.config, found.ms)],
                                overwrite=True)

        tuned_p = _packed_call(x)
        with _env("FFPA_TORCH_SKIP_TUNED_CONFIG", "1"):
            plain_p = _packed_call(x)
        if not all(torch.equal(a, b) for a, b in zip(tuned_p["grads"], plain_p["grads"])):
            fail(f"the tuned packed backward ({vfound.config}) is not bit-equal to the untuned")
        dense = _dense_path_grads(x)
        verrs = [grad_row_rel(g, w) for g, w in zip(tuned_p["grads"], dense)]
        if max(verrs) >= GRAD_TOL[bf]:
            fail(f"the tuned packed backward is off the per-segment dense path: {verrs}")
        vpick = pick_varlen_backward_config(d=cb["d"], dv=cb["d"], dtype=bf, tq=t, tk=t)
        if vpick.bwd_ring_cap != vfound.config.bwd_ring_cap:
            fail(f"pick_varlen_backward_config {vpick} is not the stored {vfound.config}")
        log(f"  autotune varlen T{t} D{cb['d']}: tuned and untuned packed calls bit-equal, "
            "gradients vs the dense path per row " + " ".join(f"{e:.2e}" for e in verrs))

        for d_, nkv in TUNE_DECODE:
            dq_, dk_, dv_ = dec_in[d_]
            kw = dict(scale=d_ ** -0.5, is_causal=False)
            o_t, _ = decode._decode_forward(dq_, dk_, dv_, None, **kw)
            with _env("FFPA_TORCH_SKIP_TUNED_CONFIG", "1"):
                o_u, _ = decode._decode_forward(dq_, dk_, dv_, None, **kw)
            po, _ = decode._decode_plain(dq_.reshape(1, 4, 2, d_), dk_, dv_, None, nq=1,
                                         scale=kw["scale"], is_causal=False, softcap=0.0,
                                         window_left=-1, window_right=-1)
            po = po.reshape(o_t.shape)
            derrs = (row_rel(o_t, po), row_rel(o_u, po))
            if max(derrs) >= BF16_TOL:
                fail(f"decode D{d_} tuned / untuned off its plain version: {derrs}")
            log(f"  autotune decode D{d_} Nkv{nkv}: the rule's split count (no decode knob), "
                f"with the store and with the kill-switch row_rel_err "
                f"vs plain {derrs[0]:.2e} / {derrs[1]:.2e} (tol {BF16_TOL:g})")
        res["ring_caps"] = ring_cap_times()

        # 4. The CLI, one task in an isolated worker.
        _, cli_s = _run([sys.executable, "-m", "ffpa_attn_tpu_torch.autotune", "--isolate-tasks",
                         "--directions", "decode", "--headdims", "512", "--seqlens", "4224",
                         "--output-dir", out_dir], "autotune CLI", 300)
        cli_path = os.path.join(out_dir, f"{store.sanitize_device_kind(kind)}.json")
        if not os.path.exists(cli_path):
            fail(f"the autotune CLI wrote no {cli_path}")
        with open(cli_path) as f:
            cli_entries = json.load(f)["entries"]
        with _env("FFPA_TORCH_TUNED_CONFIG_DIR", out_dir):
            store.clear_lookup_cache()
            got = store.lookup_tuned_config(direction="decode", d=512, nq=1, nkv=4224,
                                            dtype="bfloat16", causal=False, has_bias=False,
                                            dropout=False, gqa=False)
        want = store._entry_config(cli_entries[0])
        if len(cli_entries) != 1 or got != want:
            fail(f"the CLI's entry {cli_entries} did not come back through the lookup ({got})")
        res["cli_decode_tried"] = cli_entries[0].get("tried")
        log(f"  autotune CLI --isolate-tasks (decode D512 Nkv4224, MHA H8, {cli_s:.1f} s): "
            f"wrote {cli_path}, "
            f"read back {want}; readings " + " ".join(f"{ms:.4f}"
                                                      for _, ms in cli_entries[0]["tried"]))
        store.clear_lookup_cache()

        # 5. verify on one backward case.
        vres = verify.verify_case(cb["d"], cb["n"], True, "bfloat16", direction="bwd")
        res["verify"] = {k_: vres[k_] for k_ in ("stored_ms", "plan_ms", "fresh_ms", "agree",
                                                  "numerics_rel")}
        log(f"  autotune verify bwd D{cb['d']} N{cb['n']} causal (MHA H8): {res['verify']}")

        # 6. The lookup's host cost.
        query = dict(direction="bwd", d=cb["d"], nq=cb["n"], nkv=cb["n"], dtype="bfloat16",
                     causal=True, has_bias=False, dropout=False, gqa=True, group=group)
        store.clear_lookup_cache()
        t0 = time.perf_counter()
        store.lookup_tuned_config(**query)
        first = (time.perf_counter() - t0) * 1e6
        us = {"hit_first_call": first,
              "hit": _lookup_us(lambda: store.lookup_tuned_config(**query)),
              "no_entry": _lookup_us(lambda: store.lookup_tuned_config(
                  **dict(query, direction="fwd")))}
    with _env("FFPA_TORCH_TUNED_CONFIG_DIR", empty):
        store.clear_lookup_cache()
        us["empty_store"] = _lookup_us(lambda: store.lookup_tuned_config(**query))
        us["pick_backward_empty_store"] = _lookup_us(lambda: pick_backward_config(
            d=cb["d"], dv=cb["d"], nq=cb["n"], nkv=cb["n"], dtype=bf, causal=True, gqa=True,
            group=group))
    store.clear_lookup_cache()
    res["lookup_us"] = us
    log(f"  tuned lookup on the host, µs a call on {smi}: " + " ".join(
        f"{k_} {v_:.3f}" for k_, v_ in us.items()))
    res["seconds"] = time.perf_counter() - t_start
    log(f"autotune phase: {res['seconds']:.1f} s")
    return res


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
    serving = phase_serving(main_path["model"])
    log(f"serving tokens/s on {smi}: " + " ".join(
        f"{k} {v:.1f}" for k, v in serving["rates"].items()))
    wide_dense = phase_wide_dense(smi)
    log(f"Dh1024 dense serving tokens/s on {smi}: " + " ".join(
        f"{k} {v:.1f}" for k, v in wide_dense["rates"].items()))
    wide = phase_paged_wide(smi, wide_dense.pop("model"))
    torch.cuda.empty_cache()
    log(f"Dh1024 paged serving tokens/s on {smi}: " + " ".join(
        f"{k} {v:.1f}" for k, v in wide["rates"].items()) + "; paged decode device ms a step: "
        + " ".join(f"{k} {v:.4f}" for k, v in wide["step_ms"].items()))
    phase_monkey_patch()
    spec = phase_speculative(main_path["model"])
    log(f"speculative tokens/s on {smi}: " + " ".join(
        f"{k} {v:.1f}" for k, v in spec["rates"].items()) + " accept rates " + " ".join(
        f"{k} {v:.3f}" for k, v in spec["accept"].items()))
    training = phase_training()
    fp8_training = phase_fp8_training(training["oracle"])
    resident = phase_resident_training(training["oracle"])
    partial = phase_partial_residency(training.pop("oracle"))
    del partial["model"], partial["state"], partial["oracle"], resident["oracle"]
    torch.cuda.empty_cache()
    op_level = phase_op_level()
    phase_decode_grad()
    windowed = phase_windowed()
    phase_tiny_training()
    phase_checkpoint()
    packed = phase_packed_training()
    rows = phase_times(errs, main_path, training, windowed, resident, serving, packed,
                       fp8_training, wide, wide_dense)
    bench = phase_bench_cli(main_path["model"])
    tuned = phase_autotune(smi)
    for r in rows:  # each ring cap's ms beside the plan's
        if r["name"] in tuned["ring_caps"]:
            r["ring_cap_ms"] = tuned["ring_caps"][r["name"]]["ms"]
    for r in rows:  # launches per speculative call beside the main path's
        if r["name"] in ("flash_fwd", "decode"):
            r["speculative_launches"] = {k: c.get(r["name"], 0)
                                         for k, c in spec["launches"].items()}
    log(f"summary: prefill_ms {main_path['prefill_ms']:.3f} decode_tokens_per_s "
        f"{main_path['decode_tok_s']:.2f} generate_ms {main_path['generate_ms']:.1f} "
        f"train_step_ms {training['step_ms']:.2f} train_tokens_per_s {training['tok_s']:.1f} "
        f"fp8_ds_train_step_ms {fp8_training['step_ms']:.2f} "
        f"s_resident_step_ms {resident['step_ms']:.2f} s_resident_tokens_per_s "
        f"{resident['tok_s']:.1f} partial_step_ms {partial['step_ms']:.2f} "
        f"windowed_step_ms {windowed['step_ms']:.2f} "
        f"op_bwd_ms_resident {op_level['ms']['resident']:.3f} op_bwd_ms_handoff "
        f"{op_level['ms']['handoff']:.3f} packed_fwd_bwd_ms {packed['fwd_bwd_ms']:.3f} "
        f"packed_bwd_ms {packed['bwd_ms']:.3f} packed_bwd_tflops {packed['bwd_tflops']:.1f} "
        + "".join(f"{k} {v:.1f} " for k, v in serving["rates"].items())
        + "".join(f"spec_{k} {v:.1f} " for k, v in spec["rates"].items())
        + f"headline_fwd_tflops {bench['headline']['value']} headline_vs_baseline "
        f"{bench['headline']['vs_baseline']} headline_bwd_causal_tflops "
        f"{bench['headline']['bwd_causal_tflops']} serve_paged_window_tokens_per_s "
        f"{bench['window_tok_s']:.1f} "
        + f"loss_rel_err {training['loss_err']:.2e} "
        f"grad_rel_err {training['grad_err']:.2e} s_resident_grad_rel_err "
        f"{resident['grad_err']:.2e} total {time.perf_counter() - t_start:.1f} s on {smi}")
    # "ms" is the kernel's time; "kernel_ms" repeats it under its longer name.
    print(json.dumps({"kernels": [dict(r, kernel_ms=r["ms"]) for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
