"""The port's locked store (``ffpa_attn_tpu_torch/utils/native.py``), on the
CPU: it reads and writes atomically, times out on a lock held elsewhere,
and writers merging into one file under its lock lose no entry, among them
JAX package writers (the same ``<path>.lock``).
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os

import pytest

from ffpa_attn_tpu_torch.utils.native import LockedStore


def test_roundtrip(tmp_path):
    path = tmp_path / "store.json"
    with LockedStore(path) as s:
        assert s.read_text() is None
        s.write_text_atomic('{"x": 1}')
        assert json.loads(s.read_text()) == {"x": 1}
    with LockedStore(path) as s:
        s.write_text_atomic('{"x": 2}')
        assert json.loads(s.read_text()) == {"x": 2}
    assert sorted(os.listdir(tmp_path)) == ["store.json", "store.json.lock"]


def _hold_lock(path, held, release):
    from ffpa_attn_tpu.utils.native import LockedStore as Store

    with Store(path):
        held.set()
        release.wait(30)


def test_lock_held_by_a_jax_writer_times_out(tmp_path):
    """A JAX package store holding ``<path>.lock`` in another process keeps
    the port's store out until ``timeout_ms``; released, it is taken."""
    path = str(tmp_path / "held.json")
    ctx = mp.get_context("spawn")
    held, release = ctx.Event(), ctx.Event()
    proc = ctx.Process(target=_hold_lock, args=(path, held, release))
    proc.start()
    try:
        assert held.wait(60)
        with pytest.raises(TimeoutError):
            with LockedStore(path, timeout_ms=100):
                pass
    finally:
        release.set()
        proc.join(60)
    with LockedStore(path, timeout_ms=100) as s:
        assert s.read_text() is None


def _append(args):
    """Read-merge-write one index under the lock, with the port's store or
    the JAX package's."""
    path, idx, kind = args
    if kind == "jax":
        from ffpa_attn_tpu.utils.native import LockedStore as Store
    else:
        Store = LockedStore
    with Store(path) as s:
        text = s.read_text()
        data = json.loads(text) if text else []
        data.append(idx)
        s.write_text_atomic(json.dumps(data))
    return idx


@pytest.mark.parametrize("kinds", [("port",), ("port", "jax")], ids="+".join)
def test_concurrent_merge_loses_nothing(tmp_path, kinds):
    """12 processes, writers of ``kinds`` in turn, merge into one file."""
    path = str(tmp_path / "concurrent.json")
    n = 12
    with mp.get_context("spawn").Pool(4) as pool:
        pool.map(_append, [(path, i, kinds[i % len(kinds)]) for i in range(n)])
    assert sorted(json.loads(open(path).read())) == list(range(n))


def _write_entry(args):
    """One tuned entry merge-written by the port's or the JAX package's
    ``write_config_file`` into ``directory``."""
    directory, i, kind = args
    key = dict(direction="bwd", dtype="bfloat16", headdim=64 * (i + 1), headdim_v=64 * (i + 1),
               seqlen_q=4096, seqlen_k=4096, causal=True, has_bias=False, dropout=False,
               gqa=False)
    if kind == "jax":
        from ffpa_attn_tpu.autotune import store
        from ffpa_attn_tpu.ops.config import BlockConfig
    else:
        from ffpa_attn_tpu_torch.autotune import store
        from ffpa_attn_tpu_torch.ops.config import BlockConfig
    store.write_config_file([store.make_entry(store.ConfigKey(**key), BlockConfig(), ms=1.0)],
                            device_kind="Shared GPU", directory=directory, overwrite=True)
    return i


def test_jax_and_port_store_writers_share_one_file(tmp_path):
    """The JAX package's and the port's write_config_file merge into one
    device file concurrently, every entry kept (both write schema 1)."""
    n = 8
    with mp.get_context("spawn").Pool(4) as pool:
        pool.map(_write_entry, [(str(tmp_path), i, ("jax", "torch")[i % 2]) for i in range(n)])
    payload = json.loads((tmp_path / "Shared_GPU.json").read_text())
    assert sorted(e["key"]["headdim"] for e in payload["entries"]) == [64 * (i + 1)
                                                                      for i in range(n)]
