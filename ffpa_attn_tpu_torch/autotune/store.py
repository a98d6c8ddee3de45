"""Persistent tuned-config store of the port.

The counterpart of the JAX package's ``autotune/store.py``: schema v1 files
named after the device (``{sanitized device name}.json``), each entry keyed
by (direction, dtype, head dims, sequence lengths, feature flags) and
holding a ``BlockConfig``. The selection order is the JAX package's:

* flag filter (direction, causal, bias, dropout), dtype exact, with
  bfloat16 entries serving float16 queries;
* nearest head dims;
* a covering sequence-length bucket before an uncovering one, then the
  nearest;
* gqa / group as a soft rank, never a filter; exact dtype last;
* malformed or mismatched-schema files read as empty, never an error.

What differs:

* the device name is the CUDA device's (``torch.cuda.get_device_name``,
  cached per device index; ``NVIDIA_H100_80GB_HBM3.json`` on an H100 SXM);
  a process that has not initialised CUDA looks up "cpu";
* the payload records ``torch_version``;
* the entries hold the port's ``BlockConfig`` fields (``_CONFIG_FIELDS``),
  among them the Hopper backward rings' knob ``bwd_ring_cap``;
* a dispatch site can ask for an entry at its own head dims alone
  (``same_head_dims``): a ring cap belongs to one plan;
* the bundled directory (``configs/``) ships no corpus;
* the lookup runs on the host at every call, so a result is memoised per
  query and an empty store answers from one cached check.
"""

from __future__ import annotations

import functools
import json
import re
from dataclasses import MISSING, asdict, dataclass, fields
from pathlib import Path
from typing import Any, Optional

import torch

from ..env import ENV
from ..logger import init_logger
from ..ops.config import BlockConfig

logger = init_logger(__name__)

SCHEMA_VERSION = 1

_BUNDLED_DIR = Path(__file__).parent / "configs"

# Config fields persisted per entry: every field of the port's BlockConfig.
_CONFIG_FIELDS = tuple(f.name for f in fields(BlockConfig))
_BOOL_CONFIG_FIELDS = ("dkdv_dk_in_kernel",)


def sanitize_device_kind(kind: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", kind.strip()) or "unknown"


@functools.lru_cache(maxsize=16)
def _cuda_device_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def current_device_kind(initialise: bool = False) -> str:
    """The current CUDA device's name (cached per device index), or "cpu"
    where this process has not initialised CUDA (a flag read, the lookup's
    path) or, with ``initialise`` (the writers' path), has no card."""
    if not torch.cuda.is_initialized() and not (initialise and torch.cuda.is_available()):
        return "cpu"
    return _cuda_device_name(torch.cuda.current_device())


@dataclass(frozen=True)
class ConfigKey:
    """Variant key of one tuned entry."""

    direction: str  # 'fwd' | 'bwd' | 'decode' | 'varlen'
    dtype: str  # 'float16' | 'bfloat16'
    headdim: int
    headdim_v: int
    seqlen_q: int
    seqlen_k: int
    causal: bool
    has_bias: bool
    dropout: bool
    gqa: bool
    # KV grouping factor (Hq // Hkv) of a gqa entry, 0 for MHA (and for
    # entries written before the field): a soft rank in the lookup.
    group: int = 0

    def to_json(self) -> dict[str, Any]:
        return asdict(self)


def _dirs_key() -> tuple[str, ...]:
    """The directories read, in order: ``FFPA_TORCH_TUNED_CONFIG_DIR``,
    then the bundled one."""
    override = ENV.tuned_config_dir()
    return (override, str(_BUNDLED_DIR)) if override else (str(_BUNDLED_DIR),)


def _config_path(dir_: Path, device_kind: str) -> Path:
    return dir_ / f"{sanitize_device_kind(device_kind)}.json"


def _load_file(path: Path) -> list[dict[str, Any]]:
    """Load entries; malformed or mismatched schema => empty (never raises)."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, UnicodeDecodeError, json.JSONDecodeError):
        return []
    if not isinstance(payload, dict):
        return []
    if payload.get("schema_version") != SCHEMA_VERSION:
        logger.debug_once("tuned-config file %s has schema %r != %d; ignoring", str(path),
                          payload.get("schema_version"), SCHEMA_VERSION)
        return []
    entries = payload.get("entries")
    return [e for e in entries if isinstance(e, dict)] if isinstance(entries, list) else []


@functools.lru_cache(maxsize=8)
def _any_store_file(dirs_key: tuple[str, ...]) -> bool:
    """Whether any of the directories holds a tuned-config file, for any
    device: the one cached check an empty store answers from."""
    return any(Path(d).is_dir() and next(Path(d).glob("*.json"), None) is not None
               for d in dirs_key)


@functools.lru_cache(maxsize=8)
def _load_entries_cached(device_kind: str, dirs_key: tuple[str, ...]) -> tuple[dict, ...]:
    entries: list[dict[str, Any]] = []
    for d in dirs_key:
        path = _config_path(Path(d), device_kind)
        if path.exists():
            entries.extend(_load_file(path))
    return tuple(entries)


def clear_lookup_cache() -> None:
    """Forget the loaded files and every memoised lookup."""
    _any_store_file.cache_clear()
    _load_entries_cached.cache_clear()
    _lookup_cached.cache_clear()


def _entries_for_device(device_kind: Optional[str] = None) -> tuple[dict, ...]:
    return _load_entries_cached(device_kind or current_device_kind(), _dirs_key())


def _entry_config(entry: dict[str, Any]) -> Optional[BlockConfig]:
    cfg = entry.get("config")
    if not isinstance(cfg, dict):
        return None
    try:
        kwargs = {k: (bool(cfg[k]) if k in _BOOL_CONFIG_FIELDS else int(cfg[k]))
                  for k in _CONFIG_FIELDS if k in cfg}
        return BlockConfig(**kwargs)
    except (TypeError, ValueError):
        return None


def select_entry(entries, *, direction: str, d: int, dv: int, nq: int, nkv: int, dtype: str,
                 causal: bool, has_bias: bool, dropout: bool, gqa: bool,
                 group: int = 0) -> Optional[dict[str, Any]]:
    """The entry a query picks, or None: flag filter (bfloat16 entries
    serve float16 queries), nearest head dims, then the rank below."""

    def flag_ok(e: dict[str, Any]) -> bool:
        k = e.get("key", {})
        if k.get("direction") != direction:
            return False
        if bool(k.get("causal")) != causal or bool(k.get("has_bias")) != has_bias:
            return False
        if bool(k.get("dropout")) != dropout:
            return False
        edt = k.get("dtype")
        return edt == dtype or (dtype == "float16" and edt == "bfloat16")

    candidates = [e for e in entries if flag_ok(e)]
    if not candidates:
        return None

    def hd_dist(e: dict[str, Any]) -> int:
        k = e.get("key", {})
        return abs(int(k.get("headdim", 0)) - d) + abs(
            int(k.get("headdim_v", k.get("headdim", 0))) - dv)

    best_hd = min(hd_dist(e) for e in candidates)
    candidates = [e for e in candidates if hd_dist(e) == best_hd]

    def seq_rank(e: dict[str, Any]) -> tuple:
        k = e.get("key", {})
        sq, sk = int(k.get("seqlen_q", 0)), int(k.get("seqlen_k", 0))
        return (
            not (sq >= nq and sk >= nkv),  # a covering bucket first
            abs(sq - nq) + abs(sk - nkv),
            bool(k.get("gqa", False)) != gqa,  # head layout: a rank, not a filter
            abs(int(k.get("group", 0) or 0) - group),
            k.get("dtype") != dtype,
        )

    return min(candidates, key=seq_rank)


@functools.lru_cache(maxsize=4096)
def _lookup_cached(device_kind: str, dirs_key: tuple[str, ...], query: tuple,
                   same_head_dims: bool) -> Optional[BlockConfig]:
    names = ("direction", "d", "dv", "nq", "nkv", "dtype", "causal", "has_bias", "dropout",
             "gqa", "group")
    best = select_entry(_load_entries_cached(device_kind, dirs_key), **dict(zip(names, query)))
    if best is None:
        return None
    k = best.get("key", {})
    if same_head_dims and (int(k.get("headdim", 0)),
                           int(k.get("headdim_v", k.get("headdim", 0)))) != query[1:3]:
        return None
    cfg = _entry_config(best)
    if cfg is not None:
        logger.debug_once("tuned-config hit: %s -> %s", query, cfg)
    return cfg


def lookup_tuned_config(
    *,
    direction: str,
    d: int,
    dv: Optional[int] = None,
    nq: int,
    nkv: int,
    dtype: str,
    causal: bool,
    has_bias: bool,
    dropout: bool,
    gqa: bool,
    group: int = 0,
    device_kind: Optional[str] = None,
    same_head_dims: bool = False,
) -> Optional[BlockConfig]:
    """The tuned config of a query (``select_entry``), or None where the
    store has no usable entry or ``FFPA_TORCH_SKIP_TUNED_CONFIG`` is set,
    or, with ``same_head_dims``, where the entry picked is of other head
    dims. Memoised per query; ``clear_lookup_cache`` forgets."""
    if ENV.skip_persistent_tuned_config():
        return None
    dirs = _dirs_key()
    if not _any_store_file(dirs):
        return None
    kind = device_kind or current_device_kind()
    if not _load_entries_cached(kind, dirs):
        return None
    query = (direction, int(d), int(d if dv is None else dv), int(nq), int(nkv), dtype,
             bool(causal), bool(has_bias), bool(dropout), bool(gqa), int(group))
    return _lookup_cached(kind, dirs, query, bool(same_head_dims))


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


def build_payload(entries: list[dict[str, Any]], device_kind: str) -> dict[str, Any]:
    return {
        "schema_version": SCHEMA_VERSION,
        "device_kind": device_kind,
        "torch_version": torch.__version__,
        "entries": entries,
    }


def make_entry(key: ConfigKey, config: BlockConfig, ms: Optional[float] = None,
               tried: Optional[list] = None) -> dict[str, Any]:
    """A store entry; ``tried`` lists each timed candidate as
    [config fields, ms] (the search's record, read by no lookup)."""
    entry: dict[str, Any] = {
        "key": key.to_json(),
        "config": {f: getattr(config, f) for f in _CONFIG_FIELDS},
    }
    if ms is not None:
        entry["ms"] = ms
    if tried is not None:
        entry["tried"] = tried
    return entry


def merge_entries(old: list[dict[str, Any]], new: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """Dedup by full variant key; later entries win. Keys are canonicalised
    through ConfigKey's defaults first, so an entry written before a key
    field existed dedups against a re-tune of the same variant."""
    defaults = {f.name: f.default for f in fields(ConfigKey) if f.default is not MISSING}

    def canon(k: dict[str, Any]) -> str:
        return json.dumps({**defaults, **k}, sort_keys=True)

    by_key: dict[str, dict[str, Any]] = {}
    for e in list(old) + list(new):
        by_key[canon(e.get("key", {}))] = e
    return list(by_key.values())


def write_config_file(
    entries: list[dict[str, Any]],
    device_kind: Optional[str] = None,
    directory: Optional[str] = None,
    overwrite: bool = False,
) -> Path:
    """Locked read-merge-write of the device's config file (the locked
    store, ``utils/native.py``). ``overwrite`` decides only who wins
    a duplicate key (True: ``entries``); other stored keys are kept."""
    from ..utils.native import LockedStore

    kind = device_kind or current_device_kind(initialise=True)
    if directory:
        dir_ = Path(directory)
    else:
        dir_ = Path(ENV.tuned_config_dir()) if ENV.tuned_config_dir() else _BUNDLED_DIR
    dir_.mkdir(parents=True, exist_ok=True)
    path = _config_path(dir_, kind)
    with LockedStore(path) as store:
        existing = store.read_text()
        if existing is not None:
            try:
                payload = json.loads(existing)
                if isinstance(payload, dict) and payload.get("schema_version") == SCHEMA_VERSION:
                    old = payload.get("entries", [])
                    entries = merge_entries(old, entries) if overwrite else merge_entries(
                        entries, old)
            except json.JSONDecodeError:
                pass
        store.write_text_atomic(json.dumps(build_payload(entries, kind), indent=1,
                                           sort_keys=True))
    clear_lookup_cache()
    return path


__all__ = ["ConfigKey", "SCHEMA_VERSION", "build_payload", "clear_lookup_cache",
           "current_device_kind", "lookup_tuned_config", "make_entry", "merge_entries",
           "sanitize_device_kind", "select_entry", "write_config_file"]
