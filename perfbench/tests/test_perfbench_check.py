"""The check that decides ``correct``, driven through the rest of a run at a
tiny size on the CPU (the port's plain paths): a sound run passes; the
control (the reference from float8 inputs, and the port's own int8 pools)
and each fault the cells can have fail it. The check keeps 4 layer calls
here, not 24."""

import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import faults, harness
from perfbench.drivers import paged_decode

from perfbench.tests.tiny import tiny_spec

CELLS = ["dsv3-mla.decode-b128", "kimi-k2-mla.decode-b128", "dsv3-mla.mtp2-b128"]
SEED = 2**31 + 77


@pytest.fixture(autouse=True)
def few_samples(monkeypatch):
    monkeypatch.setattr(paged_decode, "SAMPLES", 4)


def _run(cell, device="cpu", **kw):
    return harness.run_cell(tiny_spec(cell), seed=SEED, seconds=0.2, trace=False,
                            device=device, **kw)


def _over(readings, limits):
    return any(readings[k] > lim for k, lim in limits.items())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = _run(cell, controls=("fp8",))
    assert res["correct"] and res["samples"] == 4
    limits = harness.cell_spec(cell)["limits"]["limits"]
    assert list(res["checks"]) == list(limits)
    assert not _over({k: c["value"] for k, c in res["checks"].items()}, limits)
    # the control kept at a test's size: the reference from e4m3 inputs fails
    assert _over(res["control_readings"]["fp8"], limits)
    assert set(res["metrics"]) == {"decode_tokens_per_s", "step_ms_p95", "setup_s"}


def test_int8_pools_fail_the_check():
    assert not _run("dsv3-mla.decode-b128", pool="int8")["correct"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_faults_fail_the_check(cell, fault):
    real = paged_decode.append_token, paged_decode.paged_decode_attention
    with faults.planted(fault):
        assert not _run(cell)["correct"]
    assert (paged_decode.append_token, paged_decode.paged_decode_attention) == real


def test_result_line_keeps_checks_last():
    res = _run("dsv3-mla.decode-b128")
    line = harness.result_line(res, "cpu", 1)
    assert list(line)[-1] == "checks" and list(line)[:5] == ["correct", "attempted", "failed",
                                                              "metrics", "device"]
    assert line["attempted"] == res["window"].steps * 3


def test_run_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this test is of a machine without one")
    cmd = [sys.executable, "perfbench/run.py", "--workload", "dsv3-mla.decode-b128",
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, cwd=harness.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    # a checkout that holds only the benchmark lacks the program it drives
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bare = subprocess.run([sys.executable, "-c", "import perfbench.drivers.paged_decode"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert bare.returncode != 0 and "ffpa_attn_tpu_torch" in bare.stderr


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.parametrize("cell", CELLS)
def test_on_card_tiny_run(card, cell):
    assert _run(cell, device=card)["correct"]
    with faults.planted("stale_append"):
        assert not _run(cell, device=card)["correct"]
