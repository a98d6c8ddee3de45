"""The traffic generator: lengths that sum and clip as the mix says for
every seed, and page tables that hand out each pool page once."""

import numpy as np
import pytest

from perfbench import harness, traffic_gen

MIXES = ["decode-b128", "mtp2-b128"]
SEEDS = [0, 1, 12345, 2**31 + 11, 2**40 + 3, -7]


def _mix(name):
    return harness.load_json(harness.BENCH_DIR / "traffic" / f"{name}.json")


@pytest.mark.parametrize("mix", MIXES)
def test_lengths_sum_and_clip(mix):
    m = _mix(mix)
    lens = traffic_gen.lengths(m)
    spec = m["lengths"]
    assert lens.shape == (m["batch"],) and lens.dtype == np.int64
    assert int(lens.sum()) == spec["total"] == 128 * 4989
    assert lens.min() >= spec["min"] and lens.max() <= spec["max"]


@pytest.mark.parametrize("mix", MIXES)
def test_lengths_are_one_set_dealt_longest_first(mix):
    m = _mix(mix)
    a = traffic_gen.lengths(m)
    assert np.array_equal(a, traffic_gen.lengths(m))
    assert np.array_equal(a, np.sort(a)[::-1]) and a[0] > a[-1]


def test_lengths_refuse_an_impossible_sum():
    m = dict(_mix("decode-b128"), batch=2)
    with pytest.raises(ValueError):
        traffic_gen.lengths(m)


@pytest.mark.parametrize("nq,page", [(1, 64), (2, 64), (2, 16)])
def test_page_table_hands_out_each_page_once(nq, page):
    lens = np.array([5, 63, 64, 200, 1])
    table, pages = traffic_gen.page_table(lens, nq, page, seed=3)
    need = -(-(lens + nq) // page)
    assert pages == need.sum() + 1
    used = np.concatenate([table[b, :k] for b, k in enumerate(need)])
    assert sorted(used.tolist()) == list(range(1, pages))
    for b, k in enumerate(need):
        assert (table[b, k:] == 0).all()
    assert not np.array_equal(used, np.arange(1, pages))  # shuffled


def test_torch_seeds_differ_by_stream():
    a = traffic_gen.torch_seed(5, traffic_gen.STREAM_LATENTS, 0)
    assert a != traffic_gen.torch_seed(5, traffic_gen.STREAM_LATENTS, 1)
    assert a != traffic_gen.torch_seed(6, traffic_gen.STREAM_LATENTS, 0)
    assert 0 <= a < 2**63


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("seed", SEEDS)
def test_every_seed_pages_the_same_lengths(mix, seed):
    m = _mix(mix)
    lens = traffic_gen.lengths(m)
    table, pages = traffic_gen.page_table(lens, m["nq"], m["page_size"], seed)
    need = -(-(lens + m["nq"]) // m["page_size"])
    assert pages == need.sum() + 1 and table.shape == (m["batch"], need.max())
    assert (table[np.arange(m["batch"]), need - 1] > 0).all()
