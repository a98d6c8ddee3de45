"""What the TMA decode kernel's design choices buy, and where its host time
goes, on a card.

Run from the repository root on a machine with a card:

    python tools/torch_decode_probe.py

Four shapes, bf16, the validity bias of the main path, four caches in turn
so K/V are not L2-resident: the generate step (B1 H8/4 Nkv 4224 D512, bias
up to position 4096; 66 tiles), the serving step (B4 H8/4 max_len 1152
D512, the shared-row bias with its gap, 64 tokens into generation; 18
tiles), the tiny model's step of ``chip_smoke.py``'s greedy-token check (B1
H2/1 Nkv 136 D320, bias up to position 128; 3 tiles) and a generate step
whose band the rule cannot give every SM (B1 H8/4 Nkv 4096 D512, bias up
to position 4000; 64 tiles: 32 splits of two leave 4 SMs idle). Each
reading is the call's device ms from torch.profiler (the walk and the
merge), its CUDA-event ms, and the host's wall-clock µs a call spends
enqueueing (the wrapper, the tensor maps and both launches, without a
synchronize; the least of 40 runs of 20 calls, which the host's noise only
raises). Readings are taken in turns (v1 .. vn, vn .. v1), and each run is
held against ``_decode_plain`` per row (bf16 2e-2):

* ``as_built``: the kernel as built (the tensor maps encoded at every call,
  the plan's ring, the wrapper's split count), at every shape;
* ``map_cache``: ``csrc/decode.cu`` with ``encode_cache`` replaced by one
  that keeps the encoded maps of the last 16 calls, keyed by everything
  the encoding reads (base pointer, extents, type), under a mutex;
* ``maps_global``: the maps still encoded at every call, but handed to the
  kernel through device memory (a copy made once for each distinct pair of
  maps, found again by comparing their bytes) instead of as a 256-byte
  ``__grid_constant__`` parameter;
* ``attr_once``: the dynamic shared-memory attribute of the TMA kernel set
  at its first launch only, not at every call;
* ``stages4``, ``stages8``: the ring cut to 4 and 8 stages of 8 KiB;
* ``splits_<n>``: the as-built library with the wrapper's split count
  replaced (generate: the rule's 33 splits walk two tiles a block, 66 one,
  22 three; serving: the rule's 9, then 18 and 6; tiny: the rule's 3, then
  1 and 2; Nkv 4096: the rule's 32, then 64).

The library variants run at the generate and serving shapes. Then, at the
generate shape, the host time is taken apart: the wrapper alone (its
entry point replaced by one that returns at once), each library's entry
point called directly with the arguments the wrapper passed it (ctypes and
C only), and the wrapper's steps one by one, beside one it no longer takes:
the card's properties query for its SM count (now cached).

Prints the card's name and power limit, each library's ptxas registers and
spill bytes, then one JSON line; exits 1 if a run misses the tolerance.
"""

from __future__ import annotations

import ctypes
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from ffpa_attn_tpu_torch.env import ENV  # noqa: E402
from ffpa_attn_tpu_torch.models.serving import shared_row_bias  # noqa: E402
from ffpa_attn_tpu_torch.ops import _build, config, decode, flash_fwd  # noqa: E402
from ffpa_attn_tpu_torch.ops.reference import DEFAULT_MASK_VALUE  # noqa: E402
from ffpa_attn_tpu_torch.utils.profiling import cuda_ms, device_ms  # noqa: E402

REPS = 200
TOL = 2e-2
_STAGES = "constexpr int MAX_STAGES = 12;\n"
_ENCODE = ("  const uint64_t row_bytes = (uint64_t)cols * 2;\n"
           "  return encode_3d(map, f16, base, cols, nkv, slabs, row_bytes, row_bytes * nkv, 64, "
           "TILE);\n")
_ENCODE_CACHED = """  const uint64_t row_bytes = (uint64_t)cols * 2;
  struct Entry {
    const void* base;
    uint64_t cols, nkv, slabs;
    bool f16;
    CUtensorMap map;
  };
  constexpr int N = 16;
  static std::mutex mu;
  static Entry cache[N];
  static int used = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < std::min(used, N); ++i) {
    const Entry& e = cache[i];
    if (e.base == base && e.cols == (uint64_t)cols && e.nkv == (uint64_t)nkv &&
        e.slabs == slabs && e.f16 == f16) {
      *map = e.map;
      return cudaSuccess;
    }
  }
  const cudaError_t err = encode_3d(map, f16, base, cols, nkv, slabs, row_bytes,
                                    row_bytes * nkv, 64, TILE);
  if (err == cudaSuccess)
    cache[used++ % N] = {base, (uint64_t)cols, (uint64_t)nkv, slabs, f16, *map};
  return err;
"""
_KERNEL_SIG = "decode_tma_kernel(const __grid_constant__ Maps maps, const Params p) {\n"
_KERNEL_SIG_GLOBAL = ("decode_tma_kernel(const Maps* maps_g, const Params p) {\n"
                      "  const Maps& maps = *maps_g;\n")
_LAUNCH = "  kern<<<grid, threads(SPLIT), smem, st>>>(maps, p);\n"
_LAUNCH_GLOBAL = """  constexpr int N = 16;
  static Maps* dev[N];
  static Maps seen[N];
  static int used = 0;
  const Maps* dmaps = nullptr;
  for (int i = 0; i < std::min(used, N) && dmaps == nullptr; ++i)
    if (memcmp(&seen[i], &maps, sizeof(Maps)) == 0) dmaps = dev[i];
  if (dmaps == nullptr) {
    const int i = used++ % N;
    if (dev[i] == nullptr && cudaMalloc(&dev[i], sizeof(Maps)) != cudaSuccess)
      return cudaErrorMemoryAllocation;
    e = cudaMemcpy(dev[i], &maps, sizeof(Maps), cudaMemcpyHostToDevice);
    if (e != cudaSuccess) return e;
    seen[i] = maps;
    dmaps = dev[i];
  }
  kern<<<grid, threads(SPLIT), smem, st>>>(dmaps, p);
"""
_ATTR = ("  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, "
         "(int)smem);\n  if (e != cudaSuccess) return e;\n  const dim3 grid(")
_ATTR_ONCE = """  static size_t smem_set = 0;
  if (smem > smem_set) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  const dim3 grid("""
# library -> (text, replacement) pairs applied to csrc/decode.cu
LIBS = {
    "as_built": [],
    "map_cache": [("#include <algorithm>\n", "#include <algorithm>\n#include <mutex>\n"),
                  (_ENCODE, _ENCODE_CACHED)],
    "maps_global": [(_KERNEL_SIG, _KERNEL_SIG_GLOBAL), (_LAUNCH, _LAUNCH_GLOBAL)],
    "attr_once": [(_ATTR, _ATTR_ONCE)],
    "stages4": [(_STAGES, "constexpr int MAX_STAGES = 4;\n")],
    "stages8": [(_STAGES, "constexpr int MAX_STAGES = 8;\n")],
}
LIB_SHAPES = ("generate", "serving")
# shape -> split counts tried beside the wrapper's own
SPLITS = {"generate": (66, 22), "serving": (18, 6), "tiny": (1, 2), "nkv4096": (64,)}


def build(out: Path) -> dict:
    """Compile each library's source with the package's flags and ptxas's
    report, all at once; print the TMA kernel's registers and spills."""
    src = (_build.CSRC_DIR / "decode.cu").read_text()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in LIBS.items():
        text = src
        for a, b in edits:
            if a not in text:
                raise SystemExit(f"{name}: text not found in decode.cu: {a[:70]!r}")
            text = text.replace(a, b)
        path = out / f"decode_{name}.cu"
        path.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *_build.PTXAS_FLAGS, "-I", str(_build.CSRC_DIR),
             "-o", str(out / f"lib{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry" in ln and "decode_tma_kernel" in ln:
                after = "\n".join(lines[i + 1:i + 5])
                spill = re.search(r"(\d+) bytes spill stores", after)
                regs = re.search(r"Used (\d+) registers", after)
                print(f"{name} {'f16' if '__half' in ln else 'bf16'}: {regs.group(1)} registers, "
                      f"{spill.group(1)} bytes spill stores")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        lib.ffpa_error_string.argtypes = [ctypes.c_int]
        lib.ffpa_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def host_us(run, calls: int = 20, repeats: int = 40) -> float:
    """Wall-clock µs a call of ``run`` spends on the host, enqueueing only:
    the least of ``repeats`` runs of ``calls`` calls."""
    best = float("inf")
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            run()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return best


def python_us(fn, calls: int = 10000, repeats: int = 5) -> float:
    """Wall-clock µs a call of a host-only ``fn``: the least of ``repeats``
    runs of ``calls`` calls."""
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
    return best


def row_rel(got, want) -> float:
    got, want = got.float(), want.float()
    ref = want.abs().amax(-1).clamp_min(1e-30)
    return float(((got - want).abs().amax(-1) / ref).max())


def shapes(gen) -> dict:
    """{shape: (run, plain)}: ``run`` launches one call on the next cache in
    turn, ``plain`` is the plain version on the cache of the last run."""
    out = {}
    lens = [589, 698, 763, 886]
    # name: (B, Hq, Hkv, Nkv, D, last valid column or None for the gap bias)
    for name, b, hq, hkv, nkv, d, valid in (("generate", 1, 8, 4, 4224, 512, 4096),
                                            ("serving", 4, 8, 4, 1152, 512, None),
                                            ("tiny", 1, 2, 1, 136, 320, 128),
                                            ("nkv4096", 1, 8, 4, 4096, 512, 4000)):
        scale = 1.0 / math.sqrt(d)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

        caches = [(randn(b, hkv, nkv, d), randn(b, hkv, nkv, d)) for _ in range(4)]
        q = randn(b, hq, 1, d)
        if valid is None:
            bias = shared_row_bias(torch.tensor(lens, device="cuda"), 64, max(lens), nkv)
        else:
            cols = torch.arange(nkv, device="cuda")
            bias = torch.where(cols <= valid, 0.0, DEFAULT_MASK_VALUE).float()[None, None, None]
        turn, last = [0], {}

        def run(caches=caches, q=q, bias=bias, turn=turn, last=last, scale=scale):
            last["kv"] = caches[turn[0] % len(caches)]
            turn[0] += 1
            return decode._decode_forward(q, *last["kv"], bias, scale=scale, is_causal=False)[0]

        def plain(q=q, bias=bias, last=last, b=b, hq=hq, hkv=hkv, d=d, scale=scale):
            o, _ = decode._decode_plain(q.reshape(b, hkv, hq // hkv, d), *last["kv"], bias,
                                        nq=1, scale=scale, is_causal=False, softcap=0.0,
                                        window_left=-1, window_right=-1)
            return o.reshape(q.shape)

        out[name] = (run, plain)
    return out


def use_lib(lib) -> None:
    """Point the wrapper's library lookups at ``lib`` (None: the package's)."""
    decode._build = _build if lib is None else type(sys)("decode_probe_build")
    if lib is not None:
        decode._build.load = lambda s: lib if s == "decode" else _build.load(s)
        decode._build.check = _build.check


def entry_args(run) -> tuple:
    """The arguments one call of ``run`` hands ``ffpa_decode_fwd``. The
    wrapper's buffers go back to the caching allocator when it returns; the
    direct calls that reuse these pointers allocate nothing in between."""
    got, real = {}, decode._decode_fn

    def fake(name):
        fn = real(name)
        if name != "ffpa_decode_fwd":
            return fn

        def call(*args):
            got["args"] = args
            return fn(*args)

        return call

    decode._decode_fn = fake
    try:
        run()
        torch.cuda.synchronize()
    finally:
        decode._decode_fn = real
    return got["args"]


def host_breakdown(libs, run) -> dict:
    """µs a call at the generate shape: the wrapper with a no-op entry
    point; each library's entry point called directly; the Python steps."""
    out = {}
    use_lib(libs["as_built"])
    args = entry_args(run)
    real = decode._decode_fn
    decode._decode_fn = lambda name: (lambda *a: 0) if name == "ffpa_decode_fwd" else real(name)
    try:
        out["wrapper_no_entry"] = round(host_us(run), 2)
    finally:
        decode._decode_fn = real
    for name in ("as_built", "map_cache", "maps_global", "attr_once"):
        fn = libs[name].ffpa_decode_fwd
        fn.argtypes, fn.restype = decode._ARGTYPES["ffpa_decode_fwd"], ctypes.c_int
        if fn(*args) != 0:
            raise SystemExit(f"{name}: direct call of ffpa_decode_fwd failed")
        out[f"entry/{name}"] = round(host_us(lambda fn=fn: fn(*args)), 2)
    dev = torch.device("cuda")
    q = torch.zeros((1, 4, 2, 512), dtype=torch.bfloat16, device=dev)
    kv = torch.zeros((1, 4, 4224, 512), dtype=torch.bfloat16, device=dev)
    bias = torch.zeros((1, 1, 1, 4224), dtype=torch.float32, device=dev)

    def device_ctx():
        with torch.cuda.device(dev):
            pass

    steps = {
        "decode_plan": lambda: config.decode_plan(512, 512, 2),
        "sm_count_cached": lambda: decode._sm_count(dev.index or 0),
        "sm_count_query": lambda: torch.cuda.get_device_properties(dev).multi_processor_count,
        "split_rule": lambda: decode._tma_splits(4, 66, 132, 2),
        "kv_band": lambda: decode._kv_band(1, 4224, False, -1, -1),
        "check_inputs": lambda: flash_fwd.check_kernel_inputs("probe", q, kv, kv),
        "pad_contiguous": lambda: flash_fwd._pad_last(kv, 512).contiguous(),
        "empty_fp32": lambda: torch.empty((1, 4, 33, 2, 512), dtype=torch.float32, device=dev),
        "bias_to_strides": lambda: flash_fwd._bias_strides(
            bias.to(device=dev, dtype=torch.float32), (1, 4, 2, 4224)),
        "log_level": ENV.device_log_level,
        "device_ctx": device_ctx,
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "data_ptr": q.data_ptr,
        "entry_lookup": lambda: decode._decode_fn("ffpa_decode_fwd"),
        "check_ok": lambda: decode._check(0, "probe"),
    }
    for name, fn in steps.items():
        out[f"python/{name}"] = round(python_us(fn), 3)
    use_lib(None)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    libs = build(REPO / "build" / "decode_probe")
    runs = shapes(torch.Generator(device="cuda").manual_seed(0))
    # variant -> (library, split count or None for the wrapper's rule, shapes)
    variants = {"as_built": ("as_built", None, tuple(runs))}
    variants.update({name: (name, None, LIB_SHAPES) for name in LIBS if name != "as_built"})
    for shape, counts in SPLITS.items():
        for n in counts:
            lib, _, on = variants.get(f"splits_{n}", ("as_built", n, ()))
            variants[f"splits_{n}"] = (lib, n, on + (shape,))
    rule = decode._tma_splits
    dev, ev, hus, errs = {}, {}, {}, {}
    for name in list(variants) + list(variants)[::-1]:
        lib, n, on = variants[name]
        use_lib(libs[lib])
        for shape in on:
            run, plain = runs[shape]
            decode._tma_splits = rule if n is None else (lambda *_, n=n: n)
            key = f"{shape}/{name}"
            dev.setdefault(key, []).append(round(device_ms(run, reps=REPS, warmup=3), 5))
            ev.setdefault(key, []).append(round(cuda_ms(run, reps=REPS, warmup=3), 5))
            hus.setdefault(key, []).append(round(host_us(run), 2))
            got = run()
            torch.cuda.synchronize()
            errs[key] = max(errs.get(key, 0.0), row_rel(got, plain()))
    decode._tma_splits = rule
    use_lib(None)
    breakdown = host_breakdown(libs, runs["generate"][0])
    host = {k: [round(e - d, 5) for e, d in zip(ev[k], dev[k])] for k in dev}
    print(json.dumps({"device_ms": dev, "event_ms": ev, "host_ms": host, "host_us_enqueue": hus,
                      "host_us_breakdown": breakdown, "row_rel_err_vs_plain": errs, "tol": TOL}))
    return 0 if all(e < TOL for e in errs.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
