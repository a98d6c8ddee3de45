"""The port's persistent autotune (``ffpa_attn_tpu_torch/autotune``) against
the JAX package's (``ffpa_attn_tpu/autotune``), on the CPU.

Bucketing equals the JAX package's for n in 0..20000 in both modes and in
the exact context. A seeded store of 40 keys, written once with each
package's ``make_entry``, answers 200 seeded queries with the same key in
both lookups (flags, the float16 -> bfloat16 fallback, the nearest head
dim, covering and largest buckets, the gqa / group soft rank). The store's
cases of ``tests/test_persistent_autotune_config.py`` are ported. The task
grid equals the JAX package's wherever the device-memory prune does not
bite. The search runs on the CPU's plain path with the timers stubbed: its
candidate lists, an fp16 task keyed float16 with no e4m3 candidate, e4m3
offered only under the flag's rule, a candidate displacing the plan only
beyond the plan's own spread, and every pick with no store returning the
config it returned before the store existed, field for field. The
forward's, the packed calls' and decode's picks select the entry the JAX
package's ``pick_forward_config``, ``_varlen_tuned_blocks`` and
``pick_decode_config`` select over the twin stores (at the query's own head
dims), the forward's and packed forward's ring caps and decode's split
counts are searched one knob at a time, and a stored count reaches the
launch's arguments (decode's clamped to the rule's). Plans capped at a
ring depth, and the dispatch reading a stored entry at its own head dims
alone, too; the ring-capped plans are held equal to the library's on a
card.
"""

from __future__ import annotations

import json
import statistics
from dataclasses import asdict, replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_parity import cuda  # noqa: F401
from ffpa_attn_tpu_torch.autotune import bucket as tbucket
from ffpa_attn_tpu_torch.autotune import cli as tcli
from ffpa_attn_tpu_torch.autotune import search as tsearch
from ffpa_attn_tpu_torch.autotune import store as tstore
from ffpa_attn_tpu_torch.ops import config as tcfg
from ffpa_attn_tpu_torch.ops.config import BlockConfig
from ffpa_attn_tpu_torch.ops import decode as tdec
from ffpa_attn_tpu_torch.ops import dispatch as tdisp
from ffpa_attn_tpu_torch.ops.dispatch import (
    pick_backward_config,
    pick_decode_config,
    pick_forward_config,
    pick_varlen_backward_config,
    pick_varlen_config,
)

KIND = "Fake GPU 80GB"
BF = torch.bfloat16


@pytest.fixture
def store_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("FFPA_TORCH_TUNED_CONFIG_DIR", str(tmp_path))
    monkeypatch.delenv("FFPA_TORCH_SKIP_TUNED_CONFIG", raising=False)
    tstore.clear_lookup_cache()
    yield tmp_path
    tstore.clear_lookup_cache()


def _key(**kw):
    base = dict(direction="bwd", dtype="bfloat16", headdim=512, headdim_v=512, seqlen_q=8192,
                seqlen_k=8192, causal=False, has_bias=False, dropout=False, gqa=False)
    base.update(kw)
    return tstore.ConfigKey(**base)


def _lookup(**kw):
    base = dict(direction="bwd", d=512, nq=8192, nkv=8192, dtype="bfloat16", causal=False,
                has_bias=False, dropout=False, gqa=False, device_kind=KIND)
    base.update(kw)
    return tstore.lookup_tuned_config(**base)


def _cap(c: int) -> BlockConfig:
    return BlockConfig(bwd_ring_cap=c)


# ---------------------------------------------------------------------------
# Bucketing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fast", "max"])
def test_bucketing_matches_jax(mode):
    from ffpa_attn_tpu.autotune import bucket as jbucket

    got = [tbucket.bucket_autotune_seqlen(n, mode) for n in range(20001)]
    want = [jbucket.bucket_autotune_seqlen(n, mode) for n in range(20001)]
    assert got == want
    with tbucket.exact_autotune_seqlen_keys(), jbucket.exact_autotune_seqlen_keys():
        assert [tbucket.bucket_autotune_seqlen(n, mode) for n in range(0, 20001, 7)] == [
            jbucket.bucket_autotune_seqlen(n, mode) for n in range(0, 20001, 7)]
    assert tbucket.bucket_autotune_seqlen(8191, mode) == jbucket.bucket_autotune_seqlen(8191, mode)


def test_bucketing_bad_mode_raises_as_jax():
    from ffpa_attn_tpu.autotune import bucket as jbucket

    for fn in (tbucket.bucket_autotune_seqlen, jbucket.bucket_autotune_seqlen):
        with pytest.raises(ValueError):
            fn(100, "turbo")


# ---------------------------------------------------------------------------
# Selection: the port's lookup picks the JAX lookup's key
# ---------------------------------------------------------------------------

_DIRS = ("fwd", "bwd", "decode", "varlen")
_HEADS = (320, 512, 640, 1024)
_SEQS = (1024, 2048, 4096, 8192, 16384)


def _seeded_keys(n: int = 40) -> list:
    rng = np.random.default_rng(0)
    keys = []
    while len(keys) < n:
        d = int(rng.choice(_HEADS))
        gqa = bool(rng.random() < 0.4)
        key = dict(direction=str(rng.choice(_DIRS)), dtype=str(rng.choice(["bfloat16", "float16"],
                                                                          p=[0.7, 0.3])),
                   headdim=d, headdim_v=d if rng.random() < 0.8 else int(rng.choice(_HEADS)),
                   seqlen_q=int(rng.choice(_SEQS)), seqlen_k=int(rng.choice(_SEQS)),
                   causal=bool(rng.random() < 0.5), has_bias=bool(rng.random() < 0.15),
                   dropout=bool(rng.random() < 0.15), gqa=gqa,
                   group=int(rng.choice([2, 4, 8])) if gqa else 0)
        if key not in keys:
            keys.append(key)
    return keys


def _seeded_queries(keys, n: int = 200) -> list:
    rng = np.random.default_rng(1)
    out = []
    for _ in range(n):
        k = keys[int(rng.integers(len(keys)))]
        q = dict(direction=k["direction"], dtype=k["dtype"], d=k["headdim"], dv=k["headdim_v"],
                 nq=k["seqlen_q"], nkv=k["seqlen_k"], causal=k["causal"],
                 has_bias=k["has_bias"], dropout=k["dropout"], gqa=k["gqa"], group=k["group"])
        # Perturb: another head dim, lengths between or past the buckets,
        # float16 against bfloat16 entries, flags and head layout changed.
        if rng.random() < 0.5:
            q["d"] = int(rng.choice([256, 320, 384, 448, 512, 576, 640, 768, 896, 1024]))
            q["dv"] = q["d"] if rng.random() < 0.7 else int(rng.choice(_HEADS))
        if rng.random() < 0.6:
            q["nq"] = int(rng.integers(100, 20000))
            q["nkv"] = q["nq"] if rng.random() < 0.7 else int(rng.integers(100, 20000))
        if rng.random() < 0.3:
            q["dtype"] = "float16"
        if rng.random() < 0.2:
            q["causal"] = not q["causal"]
        if rng.random() < 0.3:
            q["gqa"] = bool(rng.random() < 0.5)
            q["group"] = int(rng.choice([0, 2, 4, 8, 16, 32])) if q["gqa"] else 0
        out.append(q)
    return out


@pytest.fixture(scope="module")
def twin_stores(tmp_path_factory):
    """The seeded keys written once with each package's make_entry: the
    JAX entry of key i holds block_q 128 (i + 1), the port's bwd_ring_cap,
    fwd_ring_cap and decode_splits i + 1, so each lookup's answer names the
    key it picked."""
    from ffpa_attn_tpu.autotune import store as jstore
    from ffpa_attn_tpu.ops.config import BlockConfig as JBlockConfig

    keys = _seeded_keys()
    root = tmp_path_factory.mktemp("twin")
    jdir, tdir = root / "jax", root / "torch"
    jdir.mkdir()
    tdir.mkdir()
    jentries = [jstore.make_entry(jstore.ConfigKey(**k), JBlockConfig(block_q=128 * (i + 1)))
                for i, k in enumerate(keys)]
    tentries = [tstore.make_entry(tstore.ConfigKey(**k), BlockConfig(
        bwd_ring_cap=i + 1, fwd_ring_cap=i + 1, decode_splits=i + 1)) for i, k in enumerate(keys)]
    jstore.write_config_file(jentries, device_kind=KIND, directory=str(jdir))
    tstore.write_config_file(tentries, device_kind=KIND, directory=str(tdir))
    return keys, jdir, tdir


def test_seeded_store_files_hold_the_same_keys(twin_stores):
    keys, jdir, tdir = twin_stores
    name = f"{tstore.sanitize_device_kind(KIND)}.json"
    jkeys = [e["key"] for e in json.loads((jdir / name).read_text())["entries"]]
    tkeys = [e["key"] for e in json.loads((tdir / name).read_text())["entries"]]
    assert jkeys == tkeys and len(tkeys) == len(keys) == 40
    payload = json.loads((tdir / name).read_text())
    assert payload["torch_version"] == torch.__version__ and payload["device_kind"] == KIND
    assert set(payload["entries"][0]["config"]) == {f for f in asdict(BlockConfig())}


@pytest.mark.parametrize("part", range(4))
def test_port_lookup_picks_the_jax_key(twin_stores, monkeypatch, part):
    """50 of the 200 seeded queries a part; every one picks the same key in
    both packages (or none in both)."""
    from ffpa_attn_tpu.autotune import store as jstore

    keys, jdir, tdir = twin_stores
    monkeypatch.setenv("FFPA_TPU_TUNED_CONFIG_DIR", str(jdir))
    monkeypatch.setenv("FFPA_TORCH_TUNED_CONFIG_DIR", str(tdir))
    monkeypatch.delenv("FFPA_TPU_SKIP_TUNED_CONFIG", raising=False)
    monkeypatch.delenv("FFPA_TORCH_SKIP_TUNED_CONFIG", raising=False)
    jstore.clear_lookup_cache()
    tstore.clear_lookup_cache()
    queries = _seeded_queries(keys)[50 * part:50 * (part + 1)]
    hits = 0
    for q in queries:
        jc = jstore.lookup_tuned_config(device_kind=KIND, **q)
        tc = tstore.lookup_tuned_config(device_kind=KIND, **q)
        want = None if jc is None else jc.block_q // 128 - 1
        got = None if tc is None else tc.bwd_ring_cap - 1
        assert got == want, q
        hits += got is not None
    assert hits >= 40  # the queries reach the store, not only its misses
    jstore.clear_lookup_cache()
    tstore.clear_lookup_cache()


@pytest.mark.parametrize("direction", ["fwd", "decode", "varlen"])
def test_port_picks_select_the_jax_entry(twin_stores, monkeypatch, direction):
    """Every seeded query, asked as ``direction``: the port's dispatch pick
    takes the knob of the entry the JAX package's pick takes
    (``pick_forward_config``, ``pick_decode_config``, ``_varlen_tuned_blocks``)
    where that entry is at the query's head dims, and the default where it
    is at others (a cap or a split count belongs to one plan) or where the
    JAX pick finds none."""
    import jax.numpy as jnp

    from ffpa_attn_tpu.autotune import store as jstore
    from ffpa_attn_tpu.ops import dispatch as jdisp
    from ffpa_attn_tpu.ops import varlen as jvarlen

    keys, jdir, tdir = twin_stores
    monkeypatch.setenv("FFPA_TPU_TUNED_CONFIG_DIR", str(jdir))
    monkeypatch.setenv("FFPA_TORCH_TUNED_CONFIG_DIR", str(tdir))
    monkeypatch.delenv("FFPA_TPU_SKIP_TUNED_CONFIG", raising=False)
    monkeypatch.delenv("FFPA_TORCH_SKIP_TUNED_CONFIG", raising=False)
    monkeypatch.setattr(jstore, "current_device_kind", lambda: KIND)
    monkeypatch.setattr(tstore, "current_device_kind", lambda initialise=False: KIND)
    jstore.clear_lookup_cache()
    tstore.clear_lookup_cache()
    own_dims = taken = 0
    # The perturbed queries, then each key's own (its entry at its dims).
    exact = [dict(direction=k["direction"], dtype=k["dtype"], d=k["headdim"], dv=k["headdim_v"],
                  nq=k["seqlen_q"], nkv=k["seqlen_k"], causal=k["causal"],
                  has_bias=k["has_bias"], dropout=k["dropout"], gqa=k["gqa"], group=k["group"])
             for k in keys]
    for q in _seeded_queries(keys) + exact:
        jdt, tdt = getattr(jnp, q["dtype"]), getattr(torch, q["dtype"])
        flags = dict(causal=q["causal"], has_bias=q["has_bias"], dropout=q["dropout"],
                     gqa=q["gqa"], group=q["group"])
        if direction == "fwd":
            query = dict(q, direction="fwd")
            jpick = jdisp.pick_forward_config(d=q["d"], dv=q["dv"], nq=q["nq"], nkv=q["nkv"],
                                              dtype=jdt, **flags)
            got = pick_forward_config(d=q["d"], dv=q["dv"], nq=q["nq"], nkv=q["nkv"], dtype=tdt,
                                      **flags).fwd_ring_cap
        elif direction == "decode":
            query = dict(q, direction="decode", nq=1, causal=False, has_bias=False,
                         dropout=False)
            jpick = jdisp.pick_decode_config(d=q["d"], dv=q["dv"], nkv=q["nkv"], dtype=jdt,
                                             gqa=q["gqa"], group=q["group"])
            tpick = pick_decode_config(d=q["d"], dv=q["dv"], nkv=q["nkv"], dtype=tdt,
                                       gqa=q["gqa"], group=q["group"])
            got = 0 if tpick is None else tpick.decode_splits
        else:
            query = dict(q, direction="varlen", causal=False, has_bias=False, dropout=False,
                         gqa=False, group=0)
            jpick = jvarlen._varlen_tuned_blocks(q["d"], q["dv"], q["nq"], q["nkv"], jdt)
            got = pick_varlen_config(d=q["d"], dv=q["dv"], tq=q["nq"], tk=q["nkv"],
                                     dtype=tdt).fwd_ring_cap
            assert pick_varlen_backward_config(d=q["d"], dv=q["dv"], tq=q["nq"], tk=q["nkv"],
                                               dtype=tdt).bwd_ring_cap == got
        entry = jstore.lookup_tuned_config(device_kind=KIND, **query)
        if entry is None:
            assert got == 0, q
            continue
        i = entry.block_q // 128 - 1
        want_bq = jpick[0] if direction == "varlen" else jpick.block_q
        assert want_bq == entry.block_q, q  # the JAX pick takes the entry
        same = (keys[i]["headdim"], keys[i]["headdim_v"]) == (q["d"], q["dv"])
        assert got == (i + 1 if same else 0), q
        own_dims += same
        taken += 1
    # The store answers, at the query's own dims too (two of the seeded
    # varlen keys carry the flags a packed call asks with).
    assert taken >= 200 and own_dims >= (2 if direction == "varlen" else 80)
    jstore.clear_lookup_cache()
    tstore.clear_lookup_cache()


def test_seeded_queries_cover_the_selection_rules(twin_stores):
    """The 200 queries exercise each rule: a float16 query served by a
    bfloat16 entry, a head dim between entries, an uncovered length taking
    the largest bucket, and a gqa / group mismatch ranked, not filtered."""
    keys, _, tdir = twin_stores
    entries = json.loads((tdir / f"{tstore.sanitize_device_kind(KIND)}.json").read_text())[
        "entries"]
    seen = set()
    for q in _seeded_queries(keys):
        e = tstore.select_entry(entries, **q)
        if e is None:
            continue
        k = e["key"]
        if q["dtype"] == "float16" and k["dtype"] == "bfloat16":
            seen.add("fp16_fallback")
        if (k["headdim"], k["headdim_v"]) != (q["d"], q["dv"]):
            seen.add("nearest_headdim")
        if k["seqlen_q"] < q["nq"] or k["seqlen_k"] < q["nkv"]:
            seen.add("max_bucket")
        elif (k["seqlen_q"], k["seqlen_k"]) != (q["nq"], q["nkv"]):
            seen.add("covering_bucket")
        if k["gqa"] != q["gqa"] or k["group"] != q["group"]:
            seen.add("group_rank")
    assert seen == {"fp16_fallback", "nearest_headdim", "max_bucket", "covering_bucket",
                    "group_rank"}


# ---------------------------------------------------------------------------
# Store cases (tests/test_persistent_autotune_config.py)
# ---------------------------------------------------------------------------


def test_roundtrip_and_exact_hit(store_dir):
    tstore.write_config_file([tstore.make_entry(_key(), _cap(4), ms=1.0)], device_kind=KIND)
    assert _lookup() == _cap(4)
    assert (store_dir / "Fake_GPU_80GB.json").exists()


def test_flag_filtering(store_dir):
    tstore.write_config_file([tstore.make_entry(_key(causal=True), _cap(4))], device_kind=KIND)
    assert _lookup(causal=False) is None
    assert _lookup(causal=True) == _cap(4)


def test_bf16_entry_serves_fp16_queries(store_dir):
    tstore.write_config_file([tstore.make_entry(_key(dtype="bfloat16"), _cap(4))],
                             device_kind=KIND)
    assert _lookup(dtype="float16") == _cap(4)
    tstore.write_config_file([tstore.make_entry(_key(dtype="float16"), _cap(3))],
                             device_kind="Other GPU", overwrite=True)
    assert _lookup(dtype="bfloat16", device_kind="Other GPU") is None


def test_nearest_headdim(store_dir):
    tstore.write_config_file([
        tstore.make_entry(_key(headdim=320, headdim_v=320), _cap(6)),
        tstore.make_entry(_key(headdim=1024, headdim_v=1024), _cap(3)),
    ], device_kind=KIND)
    assert _lookup(d=384) == _cap(6)


def test_upper_seqlen_bucket_preferred(store_dir):
    tstore.write_config_file([
        tstore.make_entry(_key(seqlen_q=4096, seqlen_k=4096), _cap(3)),
        tstore.make_entry(_key(seqlen_q=16384, seqlen_k=16384), _cap(5)),
    ], device_kind=KIND)
    assert _lookup(nq=8192, nkv=8192) == _cap(5)
    assert _lookup(nq=20000, nkv=20000) == _cap(5)  # nothing covers: the nearest


def test_malformed_json_is_empty(store_dir):
    path = store_dir / f"{tstore.sanitize_device_kind(KIND)}.json"
    for text in ("{not json", json.dumps({"schema_version": 999, "entries": []}),
                 json.dumps([1, 2]), json.dumps({"schema_version": 1, "entries": "x"})):
        path.write_text(text)
        tstore.clear_lookup_cache()
        assert _lookup() is None
    path.write_bytes(b"\xff\xfe")
    tstore.clear_lookup_cache()
    assert _lookup() is None


def test_merge_dedup_by_key():
    merged = tstore.merge_entries([tstore.make_entry(_key(), _cap(3))],
                                  [tstore.make_entry(_key(), _cap(5))])
    assert len(merged) == 1 and merged[0]["config"]["bwd_ring_cap"] == 5


def test_merge_canonicalizes_pre_group_schema():
    old = tstore.make_entry(_key(), _cap(3))
    del old["key"]["group"]
    new = tstore.make_entry(_key(), _cap(5), ms=1.0)
    assert [e["config"]["bwd_ring_cap"] for e in tstore.merge_entries([old], [new])] == [5]
    assert [e["config"]["bwd_ring_cap"] for e in tstore.merge_entries([new], [old])] == [3]


def test_resweep_write_replaces_stale_entry(store_dir):
    other = tstore.make_entry(_key(headdim=320, headdim_v=320), _cap(6))
    stale = tstore.make_entry(_key(), _cap(3), ms=0.0)
    tstore.write_config_file([other, stale], device_kind=KIND)
    tstore.write_config_file([tstore.make_entry(_key(), _cap(5), ms=12.5)], device_kind=KIND,
                             overwrite=True)
    assert _lookup() == _cap(5)
    assert _lookup(d=320) == _cap(6)
    # Without overwrite a stored entry keeps its key.
    tstore.write_config_file([tstore.make_entry(_key(), _cap(4))], device_kind=KIND)
    assert _lookup() == _cap(5)


def test_kill_switch(store_dir, monkeypatch):
    tstore.write_config_file([tstore.make_entry(_key(), _cap(4))], device_kind=KIND)
    monkeypatch.setenv("FFPA_TORCH_SKIP_TUNED_CONFIG", "1")
    assert _lookup() is None


def test_group_soft_rank(store_dir):
    tstore.write_config_file([
        tstore.make_entry(_key(gqa=True, group=4), _cap(3)),
        tstore.make_entry(_key(gqa=True, group=8), _cap(5)),
    ], device_kind=KIND)
    assert _lookup(gqa=True, group=4) == _cap(3)
    assert _lookup(gqa=True, group=8) == _cap(5)
    assert _lookup(gqa=True, group=32) == _cap(5)
    tstore.write_config_file([tstore.make_entry(_key(gqa=True), _cap(6))],
                             device_kind="Other GPU")
    assert _lookup(gqa=True, group=4, device_kind="Other GPU") == _cap(6)


def test_gqa_is_soft_rank_not_filter(store_dir):
    tstore.write_config_file([tstore.make_entry(_key(direction="varlen"), _cap(6))],
                             device_kind=KIND)
    assert _lookup(direction="varlen", gqa=True, group=4) == _cap(6)
    tstore.write_config_file([tstore.make_entry(_key(direction="varlen", gqa=True, group=4),
                                                _cap(4))], device_kind=KIND)
    assert _lookup(direction="varlen", gqa=True, group=4) == _cap(4)
    assert _lookup(direction="varlen") == _cap(6)


@pytest.mark.parametrize("d,dv,hit", [(512, 512, True), (640, 640, False), (512, 1024, False),
                                      (448, 512, False)])
def test_same_head_dims_takes_only_an_entry_of_the_query_dims(store_dir, d, dv, hit):
    """``same_head_dims``: the nearest head dims' entry is taken only where
    they are the query's own (a ring cap belongs to one plan)."""
    tstore.write_config_file([tstore.make_entry(_key(), _cap(4))], device_kind=KIND)
    assert _lookup(d=d, dv=dv) == _cap(4)
    assert _lookup(d=d, dv=dv, same_head_dims=True) == (_cap(4) if hit else None)


def test_entry_with_foreign_fields_reads_as_none(store_dir):
    """A JAX-shaped entry (TPU block shapes the port's BlockConfig refuses)
    is a miss, not an error."""
    entry = tstore.make_entry(_key(), BlockConfig())
    entry["config"] = {"block_q": 512, "block_kv": 1024}
    tstore.write_config_file([entry], device_kind=KIND)
    assert _lookup() is None


def test_lookup_memoises_and_clears(store_dir):
    tstore.write_config_file([tstore.make_entry(_key(), _cap(4))], device_kind=KIND)
    assert _lookup() == _cap(4)
    before = tstore._lookup_cached.cache_info().hits
    assert _lookup() == _cap(4)
    assert tstore._lookup_cached.cache_info().hits == before + 1
    tstore.write_config_file([tstore.make_entry(_key(), _cap(3))], device_kind=KIND,
                             overwrite=True)  # clears the cache
    assert _lookup() == _cap(3)


def test_empty_store_answers_without_selecting(store_dir):
    misses = tstore._lookup_cached.cache_info().misses
    assert _lookup() is None and _lookup(direction="fwd") is None
    assert tstore._lookup_cached.cache_info().misses == misses


def test_device_kind_without_cuda_is_cpu():
    assert not torch.cuda.is_initialized()
    assert tstore.current_device_kind() == "cpu"
    assert tstore.sanitize_device_kind("NVIDIA H100 80GB HBM3") == "NVIDIA_H100_80GB_HBM3"


# ---------------------------------------------------------------------------
# Tasks
# ---------------------------------------------------------------------------


def _args(**kw):
    base = dict(directions=["fwd", "bwd"], dtypes=["bfloat16"], headdims=[512], seqlens=[8192],
                B=1, H=8, full_tasks=False, cross_tasks=False)
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(directions=["fwd", "bwd", "decode", "varlen"], dtypes=["bfloat16", "float16"],
         headdims=[320, 512, 640, 768, 1024], seqlens=[1024, 2048, 4096, 8192, 16384]),
    dict(directions=["fwd", "bwd", "decode"], H=32, full_tasks=True, cross_tasks=True),
    dict(directions=["bwd", "varlen", "decode"], headdims=[512, 1024], seqlens=[512, 4096],
         full_tasks=True, B=2, H=4),
], ids=["default", "grid", "full_cross", "mixed"])
def test_iter_tasks_matches_jax_grid(kw):
    from ffpa_attn_tpu.autotune import cli as jcli

    args = _args(**kw)
    assert [asdict(t) for t in tcli.iter_tasks(args)] == [asdict(t) for t in jcli.iter_tasks(args)]
    assert [tcli.task_key(t).to_json() for t in tcli.iter_tasks(args)] == [
        asdict(jcli.task_key(t)) for t in jcli.iter_tasks(args)]


def test_device_memory_prune_is_the_cards():
    """The JAX prune keeps 8 GiB of QKV for a 16 GB TPU; the port keeps
    half of ENV.hbm_bytes (80 GB): a 10.7 GB task stays, a 137 GB one goes."""
    from ffpa_attn_tpu.autotune import cli as jcli

    mid = _args(directions=["bwd"], H=32, headdims=[640], seqlens=[65536])
    assert len(tcli.iter_tasks(mid)) == 2 and jcli.iter_tasks(mid) == []
    assert tcli.iter_tasks(_args(directions=["bwd"], H=128, headdims=[1024],
                                 seqlens=[131072])) == []


def test_skip_stored_resume_filter(store_dir, monkeypatch):
    monkeypatch.setattr(tstore, "current_device_kind", lambda initialise=False: KIND)
    args = _args(directions=["fwd"], headdims=[320, 512], seqlens=[1024])
    tasks = tcli.iter_tasks(args)
    assert len(tasks) == 4
    stripped = tstore.make_entry(tcli.task_key(tasks[1]), BlockConfig(), ms=1.0)
    stripped["key"] = {k: v for k, v in stripped["key"].items() if k != "group"}
    payload = tstore.build_payload(
        [tstore.make_entry(tcli.task_key(tasks[0]), BlockConfig(), ms=1.0), stripped], KIND)
    (store_dir / f"{tstore.sanitize_device_kind(KIND)}.json").write_text(json.dumps(payload))
    tstore.clear_lookup_cache()
    captured = {}
    from ffpa_attn_tpu_torch.autotune import engine

    monkeypatch.setattr(engine, "run_isolated_autotune",
                        lambda tasks, args: captured.setdefault("tasks", tasks) and [])
    assert tcli.main(["--isolate-tasks", "--skip-stored", "--directions", "fwd", "--headdims",
                      "320", "512", "--seqlens", "1024", "--H", "8"]) == 0
    assert {(t.d, t.causal) for t in captured["tasks"]} == {
        (tasks[2].d, tasks[2].causal), (tasks[3].d, tasks[3].causal)}


def test_task_budget_override(monkeypatch):
    from ffpa_attn_tpu_torch.autotune.engine import _task_budget

    task = tcli.TuneTask("bwd", 512, 4096, 4096, "bfloat16", True)
    assert _task_budget(task, "fast") == 900 and _task_budget(task, "max") == 1800
    assert _task_budget(replace(task, nq=16384, nkv=16384), "fast") == 2400
    for raw, want in (("60", 60), ("0", 900), ("x", 900)):
        monkeypatch.setenv("FFPA_TORCH_AUTOTUNE_TASK_BUDGET_S", raw)
        assert _task_budget(task, "fast") == want


# ---------------------------------------------------------------------------
# Search (timers stubbed; the plain path on the CPU)
# ---------------------------------------------------------------------------


@pytest.fixture
def stub_timers(monkeypatch):
    """time_fwd / time_queued / time_bwd run the step once and return a
    stub ms; the backward's output dtypes are recorded."""
    from ffpa_attn_tpu_torch.cli import _bench

    seen = {"calls": 0}

    def time_fwd(fn, *, device, warmup=2, iters=10):
        seen["calls"] += 1
        fn()
        return 1.0 + 0.01 * seen["calls"]

    def time_bwd(prepare, *, device, warmup=2, iters=10):
        seen["calls"] += 1
        out = prepare()()
        seen.setdefault("dtypes", set()).update(str(t.dtype) for t in out if t is not None)
        return 2.0 - 0.01 * seen["calls"]

    monkeypatch.setattr(_bench, "time_fwd", time_fwd)
    monkeypatch.setattr(_bench, "time_queued", time_fwd)
    monkeypatch.setattr(_bench, "time_bwd", time_bwd)
    return seen


@pytest.mark.parametrize("case", [
    dict(d=512, scores=True, want=[0, 8, 7, 6, 5]),
    dict(d=512, scores=False, want=[0, 4, 3]),
    dict(d=320, scores=True, want=[0, 9, 8, 7, 6, 5, 4]),
    dict(d=640, scores=False, want=[0, 5, 4, 3]),
    dict(d=1024, scores=False, want=[0]),
    dict(d=1024, scores=True, want=[0, 6, 5]),
], ids=lambda c: f"d{c['d']}_{'from_s' if c['scores'] else 'pair'}")
def test_bwd_candidates_walk_the_ring_from_the_plan(case):
    got = tsearch.bwd_candidates(case["d"], case["d"], 4096, 4096, BF, False,
                                 from_scores=case["scores"])
    assert [c.bwd_ring_cap for c in got] == case["want"]
    assert all(c.ds_store_bits == 16 and not c.dkdv_dk_in_kernel for c in got)


@pytest.mark.parametrize("flag,dtype,bias,f16,n,offered", [
    (True, "bfloat16", False, False, 4096, True),
    (False, "bfloat16", False, False, 4096, False),
    (True, "float16", False, False, 4096, False),
    (True, "bfloat16", True, False, 4096, False),
    (True, "bfloat16", False, True, 4096, False),
    (True, "bfloat16", False, False, 2048, False),
])
def test_e4m3_offered_only_under_the_flags_rule(monkeypatch, flag, dtype, bias, f16, n, offered):
    if flag:
        monkeypatch.setenv("FFPA_TORCH_ALLOW_FP8_DS", "1")
    else:
        monkeypatch.delenv("FFPA_TORCH_ALLOW_FP8_DS", raising=False)
    cands = tsearch.bwd_candidates(512, 512, n, n, getattr(torch, dtype), bias,
                                   from_scores=False, f16=f16)
    assert ({c.ds_store_bits for c in cands} == {16, 8}) == offered
    # Never on the from-S tier (its dS is written over the bf16 S residual).
    assert {c.ds_store_bits for c in tsearch.bwd_candidates(
        512, 512, n, n, getattr(torch, dtype), bias, from_scores=True, f16=f16)} == {16}


def test_time_queued_falls_back_to_time_fwd_on_cpu():
    from ffpa_attn_tpu_torch.cli import _bench

    calls = []
    ms = _bench.time_queued(lambda: calls.append(1), device=torch.device("cpu"), warmup=1, iters=2)
    assert ms >= 0.0 and len(calls) == 1 + 2 * _bench.WINDOWS


def test_candidates_capped_by_env(monkeypatch):
    monkeypatch.setenv("FFPA_TORCH_AUTOTUNE_MAX_CONFIGS", "2")
    assert [c.bwd_ring_cap for c in tsearch.bwd_candidates(
        512, 512, 4096, 4096, BF, False, from_scores=True)] == [0, 8]
    # The packed call's forward caps come first, then the backward's.
    assert [(c.fwd_ring_cap, c.bwd_ring_cap)
            for c in tsearch.varlen_candidates(512, 512, BF)] == [(0, 0), (7, 0)]
    assert [c.fwd_ring_cap for c in tsearch.fwd_candidates(512, 512, 4096, 4096, BF,
                                                            False)] == [0, 7]
    assert [c.decode_splits for c in tsearch.decode_candidates(33)] == [0, 16]


def test_search_skips_failures_and_overruns(monkeypatch):
    import time

    monkeypatch.setenv("FFPA_TORCH_AUTOTUNE_CANDIDATE_TIMEOUT", "1")

    def timed(cfg):
        if cfg.bwd_ring_cap == 4:
            raise RuntimeError("refused")
        if cfg.bwd_ring_cap == 3:
            time.sleep(3)
        return 5.0 - cfg.bwd_ring_cap / 10

    found = tsearch.search(timed, [_cap(0), _cap(5), _cap(4), _cap(3)])
    assert found.config == _cap(5) and found.ms == pytest.approx(4.5)
    # The plan is timed again after each candidate, a failed one too.
    assert [c.bwd_ring_cap for c, _ in found.tried] == [0, 5, 0, 0, 0]
    assert found.plan_ms == 5.0 and found.plan_spread == 0.0
    assert tsearch.search(lambda c: 1 / 0, [_cap(0)]).config is None
    # A failing plan: the fastest candidate wins with no baseline.
    assert tsearch.search(lambda c: 1 / 0 if c == _cap(0) else 3.0 - c.bwd_ring_cap / 10,
                          [_cap(0), _cap(5), _cap(4)]).config == _cap(5)


@pytest.mark.parametrize("plan_ms,cand_ms,wins", [
    ((1.0,), 0.99, False),  # a 1 % win on a steady plan: under MIN_GAIN
    ((1.0,), 0.97, True),
    ((1.0, 1.06), 0.975, False),  # inside the plan's own spread
    ((1.0, 1.06), 0.96, True),
    ((1.0, 1.06, 0.98), 0.95, False),
], ids=["one_percent", "three_percent", "in_spread", "past_spread", "three_readings"])
def test_search_keeps_the_plan_unless_a_candidate_wins_beyond_noise(plan_ms, cand_ms, wins):
    """Stubbed timers: the plan's readings cycle through ``plan_ms``; one
    candidate (or two, for three readings) reads ``cand_ms``. The candidate
    wins only below the plan's median by more than its spread and by
    MIN_GAIN of it."""
    readings = iter(plan_ms * 3)

    def timed(cfg):
        return next(readings) if cfg == _cap(0) else cand_ms

    cands = [_cap(0)] + [_cap(5), _cap(4)][:len(plan_ms) - 1 or 1]
    found = tsearch.search(timed, cands)
    plan = sorted(ms for c, ms in found.tried if c == _cap(0))
    assert found.plan_spread == pytest.approx(plan[-1] - plan[0])
    if wins:
        assert found.config != _cap(0) and found.ms == cand_ms
    else:
        assert found.config == _cap(0) and found.ms == pytest.approx(found.plan_ms)


@pytest.mark.parametrize("direction", ["fwd", "bwd", "decode", "varlen"])
def test_run_task_on_the_plain_path(stub_timers, direction):
    task = tcli.TuneTask(direction, 320, 1 if direction == "decode" else 128, 128, "bfloat16",
                         direction != "decode", h=2)
    entry = tcli.run_task(task, "fast", device="cpu")
    assert entry["key"] == tcli.task_key(task).to_json()
    tried = [BlockConfig(**c) for c, _ in entry["tried"]]
    plan = tried[0]
    # The plan is read before and after each other candidate.
    assert tried[0::2] == [plan] * len(tried[0::2]) and len(tried) % 2 == 1
    if direction == "bwd":
        # D320 bf16 at 128 tokens keeps its S residual: the from-S ring.
        assert [c.bwd_ring_cap for c in tried[1::2]] == [9, 8, 7, 6, 5, 4]
    elif direction == "varlen":
        # The forward's 8 stages down to 3, then the pair's (its deepest plan
        # at D320 is dQ's 8 stages) down to 3, one knob at a time.
        assert [(c.fwd_ring_cap, c.bwd_ring_cap) for c in tried[1::2]] == [
            (7, 0), (6, 0), (5, 0), (4, 0), (3, 0),
            (0, 7), (0, 6), (0, 5), (0, 4), (0, 3)]
    elif direction == "fwd":
        assert [c.fwd_ring_cap for c in tried[1::2]] == [7, 6, 5, 4, 3]
    else:
        # Two KV tiles: the rule's 2 splits, then its halving.
        assert [c.decode_splits for c in tried[1::2]] == [1] and plan.decode_splits == 0
    assert plan == replace(plan, bwd_ring_cap=0, fwd_ring_cap=0, decode_splits=0)
    # The stubbed times drift by 0.01 ms a reading, inside the plan's spread:
    # the entry holds the plan at its median.
    plan_ms = sorted(ms for _, ms in entry["tried"][0::2])
    assert BlockConfig(**entry["config"]) == plan
    assert entry["ms"] == pytest.approx(statistics.median(plan_ms))
    assert entry.get("plan_spread", 0.0) == pytest.approx(plan_ms[-1] - plan_ms[0])


def test_fp16_task_keyed_float16_feeds_fp16_and_no_e4m3(stub_timers, monkeypatch):
    monkeypatch.setenv("FFPA_TORCH_ALLOW_FP8_DS", "1")
    task = tcli.TuneTask("bwd", 320, 128, 128, "float16", True, h=2)
    entry = tcli.run_task(task, "fast", device="cpu")
    assert entry["key"]["dtype"] == "float16"
    assert {c["ds_store_bits"] for c, _ in entry["tried"]} == {16}
    assert stub_timers["dtypes"] == {"torch.float16"}
    # fp16 keeps no S residual: the dK/dV and dQ pair's ring caps.
    assert [c["bwd_ring_cap"] for c, _ in entry["tried"][1::2]] == [7, 6, 5, 4, 3]


def test_cli_writes_the_device_file_on_cpu(stub_timers, tmp_path):
    out = tmp_path / "out"
    assert tcli.main(["--device", "cpu", "--directions", "decode", "fwd", "--headdims", "320",
                      "--seqlens", "128", "--H", "2", "--output-dir", str(out)]) == 0
    payload = json.loads((out / "cpu.json").read_text())
    assert [e["key"]["direction"] for e in payload["entries"]] == ["decode", "fwd", "fwd"]


# ---------------------------------------------------------------------------
# Dispatch: with no store every pick is today's; a stored entry is read
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,dv,nq,nkv,dtype,has_bias,f16,fp8", [
    (512, 512, 8192, 8192, BF, False, False, False),
    (512, 512, 8192, 8192, BF, False, False, True),
    (320, 512, 128, 256, torch.float16, False, True, True),
    (1024, 1024, 4096, 4096, BF, True, False, True),
    (512, 512, 1024, 1024, BF, False, False, True),
])
def test_backward_pick_without_store_is_unchanged(store_dir, monkeypatch, d, dv, nq, nkv, dtype,
                                                  has_bias, f16, fp8):
    if fp8:
        monkeypatch.setenv("FFPA_TORCH_ALLOW_FP8_DS", "1")
    else:
        monkeypatch.delenv("FFPA_TORCH_ALLOW_FP8_DS", raising=False)
    want_fp8 = (fp8 and dtype == BF and not f16 and not has_bias and nq * nkv >= 4096 * 4096)
    want = BlockConfig(dkdv_dk_in_kernel=False, ds_store_bits=8 if want_fp8 else 16)
    for causal in (False, True):
        assert pick_backward_config(d=d, dv=dv, nq=nq, nkv=nkv, dtype=dtype, has_bias=has_bias,
                                    f16=f16, causal=causal, gqa=True, group=2) == want


@pytest.mark.parametrize("d,dv,nq,want_bq", [(512, 512, 4096, 64), (1024, 1024, 4096, 32),
                                             (320, 320, 16, 32), (640, 320, 200, 64)])
def test_forward_and_varlen_picks_without_store_are_unchanged(store_dir, d, dv, nq, want_bq):
    assert pick_forward_config(d=d, dv=dv, nq=nq, nkv=nq, dtype=BF) == BlockConfig(
        block_q=want_bq)
    assert pick_varlen_config(d=d, dv=dv, tq=nq, dtype=BF) == BlockConfig(
        block_q=32 if nq <= 32 else 64)
    passes = tcfg.varlen_dkdv_plan(d, dv).passes
    for tq in (None, nq):
        assert pick_varlen_backward_config(d=d, dv=dv, dtype=BF, tq=tq, tk=tq) == BlockConfig(
            dkdv_col_passes=passes)


def test_picks_read_the_stored_entries(store_dir, monkeypatch):
    monkeypatch.setattr(tstore, "current_device_kind", lambda initialise=False: KIND)
    tstore.write_config_file([
        tstore.make_entry(_key(causal=True, gqa=True, group=2), BlockConfig(bwd_ring_cap=4)),
        tstore.make_entry(_key(direction="varlen"), BlockConfig(bwd_ring_cap=3, fwd_ring_cap=5)),
        tstore.make_entry(_key(direction="fwd"), BlockConfig(block_q=32, fwd_ring_cap=3)),
        tstore.make_entry(_key(direction="decode", seqlen_q=1, seqlen_k=4224, gqa=True, group=2),
                          BlockConfig(decode_splits=16)),
    ], device_kind=KIND)
    got = pick_backward_config(d=512, dv=512, nq=8192, nkv=8192, dtype=BF, causal=True, gqa=True,
                               group=2)
    assert got == BlockConfig(dkdv_dk_in_kernel=False, bwd_ring_cap=4)
    monkeypatch.setenv("FFPA_TORCH_ALLOW_FP8_DS", "1")  # propose_fp8 applies to an entry too
    assert pick_backward_config(d=512, dv=512, nq=8192, nkv=8192, dtype=BF, causal=True,
                                gqa=True, group=2).ds_store_bits == 8
    assert pick_varlen_backward_config(d=512, dv=512, dtype=BF, tq=8192,
                                       tk=8192).bwd_ring_cap == 3
    # An entry of other head dims sets no ring: a cap belongs to one plan.
    assert pick_backward_config(d=640, dv=640, nq=8192, nkv=8192, dtype=BF, causal=True,
                                gqa=True, group=2).bwd_ring_cap == 0
    assert pick_varlen_backward_config(d=1024, dv=1024, dtype=BF, tq=8192,
                                       tk=8192).bwd_ring_cap == 0
    # The forward takes the entry's ring cap and keeps its own row tile
    # (which pads the S residual's rows); the packed forward the varlen
    # entry's forward cap; decode the split count.
    assert pick_forward_config(d=512, dv=512, nq=8192, nkv=8192, dtype=BF) == BlockConfig(
        block_q=64, fwd_ring_cap=3)
    assert pick_forward_config(d=640, dv=640, nq=8192, nkv=8192, dtype=BF).fwd_ring_cap == 0
    assert pick_varlen_config(d=512, dv=512, dtype=BF, tq=8192, tk=8192) == BlockConfig(
        block_q=64, fwd_ring_cap=5)
    assert pick_varlen_config(d=512, dv=512, dtype=BF, tq=8192).fwd_ring_cap == 0
    assert pick_decode_config(d=512, dv=512, nkv=4224, dtype=BF, gqa=True,
                              group=2).decode_splits == 16
    assert tdisp.stored_decode_splits(d=512, dv=512, nkv=4224, dtype=BF, group=2) == 16
    assert pick_decode_config(d=1024, dv=1024, nkv=4224, dtype=BF, gqa=True, group=2) is None
    monkeypatch.setenv("FFPA_TORCH_SKIP_TUNED_CONFIG", "1")
    assert pick_varlen_backward_config(d=512, dv=512, dtype=BF, tq=8192,
                                       tk=8192).bwd_ring_cap == 0
    assert pick_forward_config(d=512, dv=512, nq=8192, nkv=8192, dtype=BF).fwd_ring_cap == 0
    # Decode's count is read once per query: the switch reaches it at the
    # next clear of the store's caches.
    assert tdisp.stored_decode_splits(d=512, dv=512, nkv=4224, dtype=BF, group=2) == 16
    tstore.clear_lookup_cache()
    assert tdisp.stored_decode_splits(d=512, dv=512, nkv=4224, dtype=BF, group=2) == 0


# ---------------------------------------------------------------------------
# Plans at a ring cap
# ---------------------------------------------------------------------------


# A stage's shared memory: two 64 x 64 boxes and, in the backward kernels,
# its two barriers (the forwards lay their barriers out for the plan's depth).
_STAGE = 2 * 64 * 64 * 2


@pytest.mark.parametrize("plan,least,stage", [
    (tcfg.dkdv_plan, tcfg.DKDV_MIN_STAGES, _STAGE + 16),
    (tcfg.dq_plan, tcfg.DQ_MIN_STAGES, _STAGE + 16),
    (tcfg.varlen_dkdv_plan, tcfg.DKDV_MIN_STAGES, _STAGE + 16),
    (tcfg.varlen_dq_plan, tcfg.DQ_MIN_STAGES, _STAGE + 16),
    (tcfg.fwd_plan, tcfg.FWD_MIN_STAGES, _STAGE),
    (tcfg.varlen_fwd_plan, tcfg.FWD_MIN_STAGES, _STAGE),
], ids=["dkdv", "dq", "varlen_dkdv", "varlen_dq", "fwd", "varlen_fwd"])
@pytest.mark.parametrize("d", [320, 512, 640, 1024])
def test_ring_cap_trims_stages_and_shared_memory(plan, least, stage, d):
    full = plan(d, d)
    for cap in range(least, full.stages + 3):
        got = plan(d, d, ring_cap=cap)
        assert got.stages == min(full.stages, cap)
        assert full.smem_bytes - got.smem_bytes == (full.stages - got.stages) * stage
        assert replace(got, stages=full.stages, smem_bytes=full.smem_bytes) == full
    with pytest.raises(ValueError):
        plan(d, d, ring_cap=least - 1)


@pytest.mark.parametrize("dv", [64, 320, 512, 640, 1024])
def test_from_s_ring_cap_keeps_a_tile_resident(dv):
    full = tcfg.from_s_plan(dv, False)
    least = tcfg.from_s_min_stages(dv)
    nv = full.rank_blocks[0][1] // 64 if full.rank_blocks else dv // 64
    assert least == 1 + -(-nv // 2)
    assert tcfg.from_s_plan(dv, False, ring_cap=least).stages == least <= full.stages
    with pytest.raises(ValueError):
        tcfg.from_s_plan(dv, False, ring_cap=least - 1)
    with pytest.raises(ValueError):  # dK in the kernel: the mma.sync route takes no cap
        tcfg.from_s_plan(dv, True, ring_cap=least)


@pytest.mark.parametrize("stages,cap,least,want", [(5, 0, 3, 0), (5, 4, 3, 4), (5, 5, 3, 0),
                                                   (5, 9, 3, 0), (5, 2, 3, 3), (3, 4, 3, 0),
                                                   (9, 3, 5, 5)])
def test_ring_depth(stages, cap, least, want):
    assert tcfg.ring_depth(stages, cap, least) == want


@pytest.mark.parametrize("d,dv,want", [(320, 320, [0, 7, 6, 5, 4, 3]),
                                       (512, 512, [0, 7, 6, 5, 4, 3]),
                                       (640, 640, [0, 6, 5, 4, 3]),
                                       (1024, 320, [0, 6, 5, 4, 3])])
def test_fwd_candidates_walk_the_ring_from_the_plan(d, dv, want):
    """The forward's space: the plan's depth, then each cap down to the
    walk's least; the row tile stays the default's."""
    for bias in (False, True):
        got = tsearch.fwd_candidates(d, dv, 4096, 4096, BF, bias)
        assert [c.fwd_ring_cap for c in got] == want
        assert {replace(c, fwd_ring_cap=0) for c in got} == {
            tcfg.default_config(d, dv, 4096, 4096, itemsize=2)}


@pytest.mark.parametrize("d", [320, 512, 1024])
def test_varlen_candidates_vary_one_knob_at_a_time(d):
    got = tsearch.varlen_candidates(d, d, BF)
    fwd = [c.fwd_ring_cap for c in got if c.fwd_ring_cap]
    bwd = [c.bwd_ring_cap for c in got if c.bwd_ring_cap]
    assert got[0] == pick_varlen_backward_config(d=d, dv=d, dtype=BF)
    assert all(not (c.fwd_ring_cap and c.bwd_ring_cap) for c in got)
    assert fwd == list(range(tcfg.varlen_fwd_plan(d, d).stages - 1, tcfg.FWD_MIN_STAGES - 1, -1))
    deepest = max(tcfg.varlen_dkdv_plan(d, d).stages, tcfg.varlen_dq_plan(d, d).stages)
    assert bwd == list(range(deepest - 1, tcfg.DKDV_MIN_STAGES - 1, -1))
    assert len(got) == 1 + len(fwd) + len(bwd)  # a sum, not a product
    assert [c for c in got if c.fwd_ring_cap] == [replace(got[0], fwd_ring_cap=c) for c in fwd]


@pytest.mark.parametrize("rule,want", [(1, [0]), (2, [0, 1]), (3, [0, 1]), (9, [0, 4, 2, 1]),
                                       (33, [0, 16, 8, 4, 2, 1]), (132, [0, 66, 33, 16, 8, 4,
                                                                         2, 1])])
def test_decode_candidates_are_the_rule_and_its_halvings(rule, want):
    assert [c.decode_splits for c in tsearch.decode_candidates(rule)] == want


@pytest.mark.parametrize("b,hkv,nkv,d", [(1, 4, 4224, 512), (4, 4, 1152, 512),
                                         (1, 4, 4224, 1024), (1, 1, 136, 320)])
def test_autotune_decode_offers_the_rule_and_its_halvings_only(stub_timers, b, hkv, nkv, d):
    q = torch.zeros(b, 2 * hkv, 1, d, dtype=BF)
    k = torch.zeros(b, hkv, nkv, d, dtype=BF)
    rule = tdec.rule_splits(q, k, k)
    plan = tdec.decode_plan(d, d, 2)
    assert rule == tdec._tma_splits(b * hkv, -(-nkv // 64), 132, plan.blocks_per_sm)
    found = tsearch.autotune_decode(q, k, k, scale=d ** -0.5)
    offered = [c.decode_splits for c, _ in found.tried]
    assert offered[0::2] == [0] * len(offered[0::2])
    assert offered[1::2] == [c.decode_splits for c in tsearch.decode_candidates(rule)][1:]


def test_decode_splits_obey_a_stored_count_up_to_the_rule():
    """A stored count below the rule's reaches the launch; above it, the
    rule's (every block of the launch stays resident)."""
    for d, bps, tiles in ((512, 4, 66), (1024, 4, 66), (512, 16, 18), (320, 2, 3)):
        plan = tcfg.decode_plan(d, d, 2)
        rule = tdec._tma_splits(bps, tiles, 132, plan.blocks_per_sm)
        assert tdec.decode_splits(plan, bps, tiles, 132, 0) == rule
        for stored in range(1, 3 * rule):
            assert tdec.decode_splits(plan, bps, tiles, 132, stored) == min(stored, rule)


def test_stored_caps_reach_the_launch_arguments(store_dir, monkeypatch):
    """The cap a launcher passes (``config.ring_depth`` of the pick's
    ``fwd_ring_cap`` on the plan) is the stored one, and 0 without a store;
    the decode count is memoised (no environment read on a hit) and
    forgotten with the store's caches."""
    monkeypatch.setattr(tstore, "current_device_kind", lambda initialise=False: KIND)
    tstore.write_config_file([
        tstore.make_entry(_key(direction="fwd", causal=True), BlockConfig(fwd_ring_cap=3)),
        tstore.make_entry(_key(direction="varlen"), BlockConfig(fwd_ring_cap=4, bwd_ring_cap=3)),
        tstore.make_entry(_key(direction="decode", seqlen_q=1, seqlen_k=4224),
                          BlockConfig(decode_splits=8)),
    ], device_kind=KIND)

    def ring(cfg, plan):
        return tcfg.ring_depth(plan.stages, cfg.fwd_ring_cap, tcfg.FWD_MIN_STAGES)

    fwd = pick_forward_config(d=512, dv=512, nq=8192, nkv=8192, dtype=BF, causal=True)
    assert ring(fwd, tcfg.fwd_plan(512, 512)) == 3
    assert tcfg.fwd_plan(512, 512, ring_cap=3).stages == 3
    var = pick_varlen_config(d=512, dv=512, tq=8192, tk=8192, dtype=BF)
    assert ring(var, tcfg.varlen_fwd_plan(512, 512)) == 4
    before = tdisp._stored_decode_splits.cache_info()
    for _ in range(3):
        assert tdisp.stored_decode_splits(d=512, dv=512, nkv=4224, dtype=BF, group=1) == 8
    after = tdisp._stored_decode_splits.cache_info()
    assert (after.misses - before.misses, after.hits - before.hits) == (1, 2)
    tstore.write_config_file([tstore.make_entry(_key(direction="decode", seqlen_q=1,
                                                     seqlen_k=4224),
                                                BlockConfig(decode_splits=4))],
                             device_kind=KIND, overwrite=True)
    assert tdisp.stored_decode_splits(d=512, dv=512, nkv=4224, dtype=BF, group=1) == 4
    monkeypatch.setenv("FFPA_TORCH_SKIP_TUNED_CONFIG", "1")
    assert tdisp.stored_decode_splits(d=512, dv=512, nkv=4224, dtype=BF, group=1) == 4
    tstore.clear_lookup_cache()
    assert tdisp.stored_decode_splits(d=512, dv=512, nkv=4224, dtype=BF, group=1) == 0
    assert ring(pick_forward_config(d=512, dv=512, nq=8192, nkv=8192, dtype=BF, causal=True),
                tcfg.fwd_plan(512, 512)) == 0


def test_entries_without_the_new_knobs_read_unchanged(store_dir, monkeypatch):
    """An entry written before the forward's cap and decode's count existed
    reads them as 0: the picks are the defaults' but for the fields it
    holds."""
    monkeypatch.setattr(tstore, "current_device_kind", lambda initialise=False: KIND)
    entries = [tstore.make_entry(_key(direction=dr), BlockConfig(bwd_ring_cap=4))
               for dr in ("fwd", "varlen", "bwd")]
    entries.append(tstore.make_entry(_key(direction="decode", seqlen_q=1), BlockConfig()))
    for e in entries:
        del e["config"]["fwd_ring_cap"], e["config"]["decode_splits"]
    payload = tstore.build_payload(entries, KIND)
    (store_dir / f"{tstore.sanitize_device_kind(KIND)}.json").write_text(json.dumps(payload))
    tstore.clear_lookup_cache()
    assert _lookup(direction="fwd") == BlockConfig(bwd_ring_cap=4)
    assert pick_forward_config(d=512, dv=512, nq=8192, nkv=8192, dtype=BF) == BlockConfig()
    assert pick_varlen_config(d=512, dv=512, tq=8192, tk=8192, dtype=BF) == BlockConfig()
    assert pick_varlen_backward_config(d=512, dv=512, tq=8192, tk=8192,
                                       dtype=BF).bwd_ring_cap == 4
    assert pick_decode_config(d=512, dv=512, nkv=8192, dtype=BF) == BlockConfig()


@pytest.mark.parametrize("knob", ["bwd_ring_cap", "fwd_ring_cap", "decode_splits"])
def test_block_config_refuses_negative_knobs(knob):
    with pytest.raises(ValueError):
        BlockConfig(**{knob: -1})


# ---------------------------------------------------------------------------
# On a card: the library's plans at every ring cap equal their mirrors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,dv", [(320, 320), (512, 512), (640, 640), (512, 1024), (1024, 320)])
def test_ring_capped_plans_match_library_on_card(cuda, d, dv):  # noqa: F811
    from ffpa_attn_tpu_torch.ops import flash_bwd, flash_fwd, varlen

    for read, mirror, least in (
            (flash_fwd.fwd_kernel_plan, tcfg.fwd_plan, tcfg.FWD_MIN_STAGES),
            (varlen.varlen_fwd_kernel_plan, tcfg.varlen_fwd_plan, tcfg.FWD_MIN_STAGES),
            (flash_bwd.dkdv_kernel_plan, tcfg.dkdv_plan, tcfg.DKDV_MIN_STAGES),
            (flash_bwd.dq_kernel_plan, tcfg.dq_plan, tcfg.DQ_MIN_STAGES),
            (varlen.varlen_dkdv_kernel_plan, tcfg.varlen_dkdv_plan, tcfg.DKDV_MIN_STAGES),
            (varlen.varlen_dq_kernel_plan, tcfg.varlen_dq_plan, tcfg.DQ_MIN_STAGES)):
        for cap in range(least, mirror(d, dv).stages + 1):
            assert read(d, dv, cap) == mirror(d, dv, ring_cap=cap)
        for refused in (least - 1, mirror(d, dv).stages + 1):
            with pytest.raises(RuntimeError):
                read(d, dv, refused)
    for cap in range(tcfg.from_s_min_stages(dv), tcfg.from_s_plan(dv, False).stages + 1):
        assert flash_bwd.from_s_kernel_plan(dv, False, cap) == tcfg.from_s_plan(dv, False,
                                                                                 ring_cap=cap)
