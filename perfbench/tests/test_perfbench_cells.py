"""Every cell of BENCHMARK.json resolves by name to its files, the file keeps
to the benchmark's contract, and the bound's counts match hand arithmetic."""

import json
import math
import re

import pytest

from perfbench import harness, roofline, traffic_gen
from perfbench.drivers import paged_decode

BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_cells_in_order():
    assert CELLS == ["dsv3-mla.decode-b128", "kimi-k2-mla.decode-b128", "dsv3-mla.mtp2-b128"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    spec = harness.cell_spec(cell)
    assert spec["cell"]["chips"] == 1
    assert paged_decode.Driver is harness.driver_class(spec["mix"])
    assert set(spec["limits"]["limits"]) == {"max_abs_err", "rms_rel_err"}
    assert [m["name"] for m in spec["end_to_end"]] == ["decode_tokens_per_s", "step_ms_p95",
                                                       "setup_s"]
    assert len(spec["per_layer"]) == 5
    for m in spec["end_to_end"]:
        assert callable(harness.reader("e2e", m["name"]))
    for m in spec["per_layer"]:
        assert callable(harness.reader("metrics", m["name"]))


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
    for w in BENCH["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and NAME.match(w["traffic"])
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("config,hq,scale", [("dsv3-mla", 128, 0.135234),
                                             ("kimi-k2-mla", 64, 0.130861)])
def test_config_widths_and_scale(config, hq, scale):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    cfg = harness.load_json(harness.ROOT / entry["file"])
    shape = paged_decode.mla_shape(cfg)
    assert (shape["hq"], shape["d"], shape["dv"], shape["layers"]) == (hq, 576, 512, 61)
    assert round(shape["scale"], 6) == scale
    assert math.isclose(shape["scale"], cfg["softmax_scale"], rel_tol=1e-12)
    assert entry["reduced"] == cfg["reduced"] == []


def _hand_counts(lens, hq, nq):
    pairs = sum(n + 1 + t for n in lens for t in range(nq))
    rows = sum(n + nq for n in lens)
    return 2 * hq * (576 + 512) * pairs, rows * 576 * 2 + len(lens) * hq * nq * (576 + 512) * 2


@pytest.mark.parametrize("cell,step_ms,bound", [
    ("dsv3-mla.decode-b128", 14.0, "bytes"), ("kimi-k2-mla.decode-b128", 13.7, "bytes"),
    ("dsv3-mla.mtp2-b128", 21.9, "operations")])
def test_bound_counts_by_hand(cell, step_ms, bound):
    spec = harness.cell_spec(cell)
    shape = paged_decode.mla_shape(spec["config"])
    nq = spec["mix"]["nq"]
    lens = [int(n) for n in traffic_gen.lengths(spec["mix"])]
    flops, nbytes = roofline.latent_decode_counts(lens, hq=shape["hq"], nq=nq, d=576, dv=512)
    assert (flops, nbytes) == _hand_counts(lens, shape["hq"], nq)
    ms, which = roofline.bound_ms(flops, nbytes)
    assert which == bound
    assert round(ms * shape["layers"], 1) == step_ms
