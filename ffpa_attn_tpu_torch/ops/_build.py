"""Build and load the CUDA kernels at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``. The library
goes under ``build/ffpa_attn_tpu_torch/`` next to the package (git-ignored)
and is keyed by a hash of the sources and flags, so a fresh checkout builds
it once and an edited source builds anew. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "ffpa_attn_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
# ptxas's report (registers, spills, and the C7515 / C7520 notes when it
# serializes wgmma) is kept beside each library as <library>.log.
PTXAS_FLAGS = ("-Xptxas", "-v")
SOURCES = ("flash_fwd", "decode", "flash_bwd", "varlen_fwd", "varlen_bwd", "paged_decode")

_LIBS: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS + PTXAS_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _compile_cmd(name: str, out: Path) -> list:
    return [_nvcc(), *NVCC_FLAGS, *PTXAS_FLAGS, "-I", str(CSRC_DIR), "-o", str(out),
            str(CSRC_DIR / f"{name}.cu")]


def build(names=SOURCES) -> dict:
    """Compile every missing library of ``names``, all nvcc processes at
    once. Returns {name: seconds spent compiling it (0.0 if cached)}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    times = {}
    for name in names:
        out = _lib_path(name)
        times[name] = 0.0
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                _compile_cmd(name, tmp),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
            tmp, out, time.perf_counter(),
        )
    errors = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def build_log(name: str) -> str:
    """nvcc's and ptxas's output from building ``csrc/<name>.cu`` (empty
    when the library was not built by ``build``)."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.ffpa_error_string.argtypes = [ctypes.c_int]
            lib.ffpa_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.ffpa_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


__all__ = ["build", "build_log", "load", "check", "BUILD_DIR", "CSRC_DIR", "SOURCES"]
