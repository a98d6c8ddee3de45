"""The port's bench CLI (``ffpa_attn_tpu_torch/cli/_bench.py``, ``_flops.py``,
``_headline.py``) against the JAX package's ``cli/_bench.py`` and
``cli/_flops.py``, on the CPU.

The flop model and the pair count are held equal to the JAX package's (and
to ``utils.profiling.band_pairs``' former loop) over a grid with the decode
tail; ``make_case`` gives the JAX package's fields for all ten cases and
``to_markdown`` its string. ``run_case(device="cpu")`` runs every case at
B1 H2 N256 D320 (the plain versions, host-clock times: plumbing only) with
the correctness gate on; the gate raises on a perturbed FFPA output; the
baselines are held to the fp32 oracle. Without a card the CLI and the
headline exit 1 and time nothing. The card test (``-k on_card``) holds that
every row launches the port's kernels.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from _torch_parity import cuda, jax_modules  # noqa: F401
from ffpa_attn_tpu_torch.cli import _bench, _flops, _headline
from ffpa_attn_tpu_torch.ops.reference import expand_kv_heads, reference_attention
from ffpa_attn_tpu_torch.utils import profiling

TINY = dict(b=1, h=2, n=256, d=320)
FAST = dict(warmup=0, iters=1)


@pytest.fixture(scope="module")
def jbench():
    return jax_modules("ffpa_attn_tpu.cli._bench")[0]


@pytest.fixture(scope="module")
def jflops():
    return jax_modules("ffpa_attn_tpu.cli._flops")[0]


def _old_band_pairs(nq, nkv, *, causal, window=(-1, -1)):
    """``utils/profiling.band_pairs`` as it was before it became
    ``_flops.attention_valid_pairs``."""
    off, wl = nkv - nq, int(window[0])
    wr = 0 if causal else int(window[1])
    total = 0
    for i in range(nq):
        lo = 0 if wl < 0 else max(0, i + off - wl)
        hi = nkv - 1 if wr < 0 else min(nkv - 1, i + off + wr)
        total += max(0, hi - lo + 1)
    return total


SHAPES = [(1, 1), (1, 257), (5, 300), (8, 8192), (128, 128), (200, 200), (100, 333), (255, 255),
          (1024, 8192)]
WINDOWS = [(-1, -1), (0, -1), (64, -1), (5, 7), (-1, 3), (600, 0), (3000, -1)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("window", WINDOWS)
def test_valid_pairs_match_jax(jflops, causal, window):
    for nq, nkv in SHAPES:
        want = jflops.attention_valid_pairs(nq, nkv, causal, window)
        assert _flops.attention_valid_pairs(nq, nkv, causal, window) == want, (nq, nkv)


@pytest.mark.parametrize("direction", ["fwd", "bwd", "fwd_bwd"])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_flops_match_jax(jflops, direction, causal):
    for nq, nkv in SHAPES:
        for window in WINDOWS:
            for dv in (None, 128):
                kw = dict(causal=causal, direction=direction, window=window)
                assert _flops.attention_flops(2, 8, nq, nkv, 512, dv, **kw) == \
                    jflops.attention_flops(2, 8, nq, nkv, 512, dv, **kw)


@pytest.mark.parametrize("causal", [False, True])
def test_band_pairs_is_the_pair_count(causal):
    """One function: ``profiling.band_pairs`` is ``attention_valid_pairs``
    and gives the former loop's counts, rows that see nothing included
    (causal with Nkv < Nq)."""
    assert profiling.band_pairs is _flops.attention_valid_pairs
    for nq, nkv in SHAPES + [(300, 100), (9, 4)]:
        for window in WINDOWS:
            assert profiling.band_pairs(nq, nkv, causal=causal, window=window) == \
                _old_band_pairs(nq, nkv, causal=causal, window=window), (nq, nkv, window)


def test_flops_helpers(jflops):
    with pytest.raises(ValueError, match="direction"):
        _flops.attention_flops(1, 1, 8, 8, 64, direction="sideways")
    for t in (0.5, 9.99, 10.0, 97.4, 1234.0):
        assert _flops.format_tflops(t) == jflops.format_tflops(t)
    assert _flops.tflops_from_ms(4e12, 2.0) == jflops.tflops_from_ms(4e12, 2.0) == 2000.0


def test_cases_match_jax(jbench):
    assert _bench.CASES == jbench.CASES
    for name in _bench.CASES:
        for b, h, n, d in ((1, 32, 8192, 512), (2, 8, 4096, 320), (1, 2, 256, 1024)):
            got = dataclasses.asdict(_bench.make_case(name, b, h, n, d))
            assert got == dataclasses.asdict(jbench.make_case(name, b, h, n, d)), name
            assert _bench.make_case(name, b, h, n, d).window_active == \
                jbench.make_case(name, b, h, n, d).window_active
    with pytest.raises(ValueError):
        _bench.make_case("nope", 1, 1, 8, 8)


def test_markdown_matches_jax(jbench):
    rows = [dict(case=c, direction=dr, dtype="bfloat16", shape=f"B1 Hq32 Hkv8 Nq{n} Nkv{n} D512",
                 ffpa_ms=ms, sdpa_ms=3.5 * ms, ffpa_tflops=tf, sdpa_tflops=tf / 3.5,
                 speedup=3.5)
            for c, dr, n, ms, tf in (("self-attn", "fwd", 8192, 14.2, 301.0),
                                     ("decode", "bwd", 1, 0.0123, 0.4),
                                     ("causal", "bwd", 8191, 12.9, 9.96))]
    assert _bench.to_markdown(rows) == jbench.to_markdown(rows)


@pytest.fixture(scope="module")
def cpu_rows():
    """Every case's fwd row, and bwd for self-attn and causal, on the CPU."""
    rows = {}
    for name in _bench.CASES:
        case = _bench.make_case(name, **TINY)
        for direction in ("fwd", "bwd") if name in ("self-attn", "causal") else ("fwd",):
            rows[name, direction] = (case, _bench.run_case(case, torch.bfloat16, direction,
                                                           device="cpu", **FAST))
    return rows


@pytest.mark.parametrize("name", _bench.CASES)
def test_run_case_on_cpu(jflops, cpu_rows, name):
    jax_keys = {"case", "direction", "dtype", "shape", "ffpa_ms", "sdpa_ms", "ffpa_tflops",
                "sdpa_tflops", "speedup"}
    for (n, direction), (case, row) in cpu_rows.items():
        if n != name:
            continue
        assert jax_keys | {"flops", "baseline", "baseline_ms", "sdpa_backend", "ffpa_device_ms",
                           "launches", "bound_ms", "bound_by", "verified"} <= set(row)
        assert row["verified"] and row["dtype"] == "bfloat16" and row["device"] == "cpu"
        want = jflops.attention_flops(case.b, case.hq, case.nq, case.nkv, case.d,
                                      causal=case.causal, direction=direction,
                                      window=case.window)
        assert row["flops"] == want
        assert row["ffpa_tflops"] == pytest.approx(want / row["ffpa_ms"] / 1e9)
        assert set(row["baseline_ms"]) == set(_bench.BASELINES)
        assert row["sdpa_ms"] == min(row["baseline_ms"].values()) > 0.0
        assert row["sdpa_backend"] in {"flash", "efficient", "cudnn", "math"}
        assert row["launches"] == {}  # CPU calls run the plain versions
        assert ("backward_launches" in row) == (direction == "bwd")
        assert row["ffpa_device_ms"] is None and row["bound_ms"] > 0.0


def test_launch_counts_reads_and_zeroes_every_counter(monkeypatch):
    from ffpa_attn_tpu_torch.ops import flash_bwd, varlen

    assert list(profiling.launch_counts()) == [
        "flash_fwd", "dkdv", "dq", "banded_dq", "dkdv_from_s", "banded_dk", "decode",
        "varlen_fwd", "paged_decode", "varlen_dkdv", "varlen_dq", "dkdv_fp8_ds",
        "banded_dq_fp8_ds"]
    monkeypatch.setattr(flash_bwd._dkdv_from_s_launch, "launches", 3)
    monkeypatch.setattr(varlen._varlen_backward, "dq_launches", 2)
    counts = profiling.launch_counts()
    assert counts["dkdv_from_s"] == 3 and counts["varlen_dq"] == 2
    assert set(profiling.launch_counts(zero=True).values()) == {0}
    assert flash_bwd._dkdv_from_s_launch.launches == varlen._varlen_backward.dq_launches == 0


def test_run_case_reads_the_launch_counters(monkeypatch):
    """``launches`` is what ``launch_counts`` reads around the counted call,
    zeroed just before it."""
    state = {"zeroed": 0}

    def fake(zero=False):
        if zero:
            state["zeroed"] += 1
            return {}
        return {"flash_fwd": 1, "decode": 0}

    monkeypatch.setattr(profiling, "launch_counts", fake)
    row = _bench.run_case(_bench.make_case("self-attn", **TINY), torch.bfloat16, "fwd",
                          device="cpu", verify=False, **FAST)
    assert row["launches"] == {"flash_fwd": 1} and state["zeroed"] == 1
    assert not row["verified"]


@pytest.mark.parametrize("name", ["self-attn", "attn-mask"])
def test_gate_raises_on_a_wrong_output(monkeypatch, name):
    real = _bench.ffpa_attn_func
    monkeypatch.setattr(_bench, "ffpa_attn_func", lambda *a, **k: real(*a, **k) + 1.0)
    with pytest.raises(RuntimeError, match="bench verify FAILED"):
        _bench.run_case(_bench.make_case(name, **TINY), torch.bfloat16, "fwd", device="cpu",
                        **FAST)


def test_gate_raises_on_a_wrong_gradient(monkeypatch):
    """A bwd row also holds dQ: an output scaled by a constant passes no
    forward check, and a wrong gradient alone must fail."""

    class Skewed(torch.autograd.Function):
        @staticmethod
        def forward(ctx, o):
            return o

        @staticmethod
        def backward(ctx, g):
            return 3.0 * g

    real = _bench.ffpa_attn_func
    monkeypatch.setattr(_bench, "ffpa_attn_func", lambda *a, **k: Skewed.apply(real(*a, **k)))
    with pytest.raises(RuntimeError, match="bench verify FAILED for self-attn bwd dq"):
        _bench.run_case(_bench.make_case("self-attn", **TINY), torch.bfloat16, "bwd",
                        device="cpu", **FAST)


@pytest.mark.parametrize("name", ["self-attn", "cross-attn", "decode-gqa", "gqa", "causal",
                                  "attn-mask", "non-aligned", "sliding-window"])
@pytest.mark.parametrize("variant", _bench.BASELINES)
def test_baselines_match_the_oracle(name, variant):
    """Both stock baselines compute the case's attention: held to the fp32
    oracle on fp32 inputs (the chunked one at a chunk that splits Nq)."""
    case = _bench.make_case(name, 1, 4, 1024, 64)
    q, k, v, mask, _ = _bench._inputs(case, torch.float32, torch.device("cpu"))
    if variant == "chunked":
        got = _bench.chunked_sdpa(q, expand_kv_heads(k, 4), expand_kv_heads(v, 4), mask,
                                  causal=case.causal, chunk=96, window=case.window)
    else:
        got = _bench._sdpa_fwd_fn(case, variant)(q, k, v, mask)
    want = reference_attention(q, expand_kv_heads(k, 4), expand_kv_heads(v, 4), mask,
                               is_causal=case.causal, window=case.window)
    assert float((got - want).abs().max()) < 1e-4


def test_chunked_backward_matches_the_oracle():
    case = _bench.make_case("causal", 1, 2, 200, 64)
    q, k, v, _, do = _bench._inputs(case, torch.float32, torch.device("cpu"))
    grads = []
    for fn in (lambda *t: _bench.chunked_sdpa(*t, None, causal=True, chunk=64),
               lambda *t: reference_attention(*t, is_causal=True)):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        fn(*leaves).backward(do)
        grads.append([t.grad for t in leaves])
    for g, w in zip(*grads):
        assert float((g - w).abs().max()) < 1e-4


def test_timers_on_cpu():
    dev = torch.device("cpu")
    calls = []
    ms = _bench.time_fwd(lambda: calls.append(1), device=dev, warmup=2, iters=3)
    assert ms >= 0.0 and len(calls) == 2 + 3 * _bench.WINDOWS
    ran = []
    ms = _bench.time_bwd(lambda: (ran.append("f"), lambda: ran.append("b"))[1], device=dev,
                         warmup=1, iters=2)
    assert ms >= 0.0 and ran == ["f", "b"] * (1 + 2 * _bench.WINDOWS)


def test_port_kernel_names():
    port = ["void (anonymous namespace)::fwd::wgmma_fwd_kernel<__nv_bfloat16>(Maps, Params)",
            "void (anonymous namespace)::dkdv::kernel<__nv_bfloat16, false>(Maps, Params)",
            "void (anonymous namespace)::fwd_kernel<64, 64>(FwdParams)",
            "void (anonymous namespace)::band::banded_kernel<__nv_bfloat16, true>(Params)",
            "void (anonymous namespace)::tma::paged_tma_kernel<true>(Maps, Params)",
            "void ffpa::split_merge_kernel<__nv_bfloat16>(float const*, float const*)"]
    other = ["void at::native::(anonymous namespace)::distribution_elementwise_grid_stride_kernel"
             "<float, 4>(int)", "sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x16",
             "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits>(Params)",
             "fmha_cutlassF_bf16_aligned_64x128_rf_sm80(PyTorchMemEffAttention::AttentionKernel)",
             "void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add<float>>(int)"]
    assert all(_bench.is_port_kernel(n) for n in port)
    assert not any(_bench.is_port_kernel(n) for n in other)


def test_cli_on_cpu_writes_the_table(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("FFPA_TORCH_SCORES_AUTO_ASSUMED_LAYERS", raising=False)  # main sets it
    out = tmp_path / "table.md"
    rc = _bench.main(["--cases", "self-attn", "decode", "--H", "2", "--N", "256", "--D", "320",
                      "--directions", "fwd", "--iters", "1", "--warmup", "0", "--device", "cpu",
                      "--output", str(out), "--json"])
    assert rc == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [r["case"] for r in rows] == ["self-attn", "decode"]
    text = out.read_text()
    assert "on cpu (host clock: plumbing only" in text and "correctness gate on" in text
    assert text.endswith(_bench.to_markdown(rows) + "\n")


def test_no_card_no_timing(capsys, monkeypatch):
    """Without a card and without --device cpu the CLI and the headline
    exit 1 with the error and time nothing on the CPU in the card's place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("FFPA_TORCH_SCORES_AUTO_ASSUMED_LAYERS", raising=False)  # main sets it
    assert _bench.main(["--cases", "self-attn"]) == 1
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err
    assert _headline.main() == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == _headline.METRIC and line["value"] == 0.0 and "error" in line
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        _bench.run_case(_bench.make_case("self-attn", **TINY), torch.bfloat16, "fwd")


def test_help_exits_zero(capsys):
    with pytest.raises(SystemExit) as exc:
        _bench.main(["--help"])
    assert exc.value.code == 0
    assert "--device" in capsys.readouterr().out


def test_queued_ms_on_card_takes_the_host_out(cuda):
    """queued_ms reads a long kernel as CUDA events do, and a host-bound
    stream of tiny kernels as less: the enqueue is off its clock."""
    x = torch.randn(4096, 4096, device=cuda, dtype=torch.bfloat16)
    queued = profiling.queued_ms(lambda: [x @ x for _ in range(10)]) / 10
    events = profiling.cuda_ms(lambda: x @ x, reps=10)
    assert 0.8 * events <= queued <= 1.2 * events
    y = torch.zeros(1, device=cuda)
    queued = profiling.queued_ms(lambda: [y.add_(1) for _ in range(200)]) / 200
    assert queued < profiling.cuda_ms(lambda: y.add_(1), reps=200)


@pytest.mark.parametrize("name", _bench.CASES)
def test_run_case_on_card_launches_port_kernels(cuda, name):
    """On the card every case's rows, fwd and bwd, run gated and launch the
    port's kernels (a decode bwd row its forward's: the decode backward is
    the grouped fp32 composite, as in the JAX package)."""
    case = _bench.make_case(name, 1, 4, 1024, 512)
    for direction in ("fwd", "bwd"):
        row = _bench.run_case(case, torch.bfloat16, direction, device=cuda, iters=2)
        assert row["verified"] and row["launches"], row
        assert row["ffpa_device_ms"] > 0.0
        if row["non_port_device_ms"] is not None:  # None: the profiler lost events
            assert row["ffpa_device_ms"] >= row["non_port_device_ms"] >= 0.0
        assert np.isfinite(row["ffpa_ms"]) and row["sdpa_backend"]
