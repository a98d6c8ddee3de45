"""A/B device times of the port's CUDA kernels built from two source trees.

Run on a machine with a card, from the repository root:

    python tools/torch_kernel_ab.py --base DIR [--kernels flash_fwd,dkdv,...]

DIR holds another version of the kernel sources (``flash_fwd.cu``,
``decode.cu``, ``flash_bwd.cu`` and their headers; e.g.
``ffpa_attn_tpu_torch/csrc`` of a parent checkout). Both versions are
compiled with the package's nvcc flags and timed at the main-path shapes of
``chip_smoke.py`` in the order base, head, head, base, through the same
Python wrappers (the two share the C interface; a base library whose
banded entry points still read a row tile is given the one its own
wrappers passed, ``LegacyBanded``; one built from sources before the e4m3
dS slab has the dS width taken out of its dK/dV and banded dQ argument
lists, ``LegacyDsBits``: every run here stores a 16-bit slab; one built
from sources before the backward rings' run-time cap has the cap taken out
of its backward entry points' and their plans' argument lists,
``LegacyRingCap``: every run here launches at the plan's depth):

* flash_fwd: B1 H8/4 N4096 D512 causal bf16 (the serving prefill), and
  flash_fwd_scores the same with the S residual; flash_fwd_train and
  flash_fwd_train_scores: N8192 (a training layer), without and with it.
  At D512 the head library runs its wgmma route, a base built from older
  sources the mma.sync kernel; flash_fwd_d1024: B1 H8/4 N4096 D1024 causal
  bf16, where the head library runs the cluster of two blocks, a base built
  from sources before it the mma.sync kernel;
* decode: B1 H8/4 Nkv 4224 D512 with the validity bias (the generate step),
  and decode_serving (``--kernels decode`` runs both): B4 H8/4 max_len 1152
  with the serving step's shared-row bias and its gap; decode_d1024 and
  decode_d1024_serving (``--kernels decode_d1024`` runs both) the same
  steps at D1024, where the head library runs its two-warpgroup block and
  a base built from sources before it the cp.async kernel; four caches in
  turn so K/V are not L2-resident, each run held against ``_decode_plain``
  per row at the bf16 forward tolerance 2e-2. A base library whose plan
  names the cp.async route for a shape (route 0 in ``ffpa_decode_plan``'s
  first field, or no ``ffpa_decode_plan`` at all: sources before the TMA
  route) is split there by that route's own rule (``legacy_splits``);
* dkdv (with the dS slab) and banded_dq: B1 H8/4 N8192 D512 causal bf16
  (the training step's dS-handoff backward); head and base take the same
  slab padding (the head wrapper's), and at D512 the head library runs
  its wgmma route, a base built from older sources the mma.sync kernel;
  dkdv_d1024 and dkdv_d640: B1 H8/4 N4096 causal fp16 with the slab (the
  handoff tier fp16 takes at the bench's D sweep), where the head library
  runs the cluster of two blocks and a base built from sources before it
  the mma.sync kernel, given the column passes its wrapper passed
  (``LegacyDkdv``), each held against the plain version at the fp16
  gradient tolerance 1e-2;
* dq: the same shape with a 4096-token left window (the windowed model's
  recompute backward); dq_d1024 and dq_d640: B1 H8/4 N4096 causal bf16 (the
  recompute tier at the bench's D sweep's head dims), and dq_d1024_fp16
  the first in fp16, on the plain forward's (o, lse), where the head
  library runs the cluster of two blocks and a base built from sources
  before it the mma.sync kernel, given the row tile its plan names
  (``LegacyDq``), each held against the plain version (fp16 at the fp16
  gradient tolerance 1e-2);
* from_s (the from-S dK/dV pass with dK out of the kernel, on a fresh copy
  of the S residual each call: it overwrites S with dS) and banded_dk: the
  same shape as dkdv (the S-resident backward of the training step). At
  D512 the head library runs its wgmma route, a base built from older
  sources the mma.sync kernel; from_s_d1024 and from_s_d640: the same pass
  at B1 H8/4 N4096 causal bf16 (the S-resident tier bf16 takes at the
  bench's D sweep), where the head library runs the cluster of two blocks
  and a base built from sources before it the mma.sync kernel, each held
  against the plain version (dV and the slab) at the bf16 gradient
  tolerance 5e-2;
* varlen_fwd: the serving packing of continuous batching (prompts of 589,
  698, 763 and 886 tokens, H8/4 D512 causal bf16), and varlen_fwd_train
  (``--kernels varlen_fwd`` runs both) the packed-training packing (8
  documents of 2048..284 tokens, 8192 in all); the kernel's device time
  alone (either route's, ``varlen.FWD_KERNELS``: the wrapper's metadata
  and schedule kernels are not counted), each held against
  ``_varlen_forward_plain`` per row at the bf16 forward tolerance 2e-2,
  and the names of the kernels each tree ran (``kernel_names``). A base
  library without ``ffpa_varlen_fwd_plan`` (built from sources before the
  wgmma route) is called with its own argument list and its intervals at
  64-row Q tiles (``LegacyVarlenFwd``);
* varlen_fwd_d1024, varlen_fwd_d640 and varlen_fwd_d1024_fp16: the varlen
  forward above D512 over 8 documents packed into 4096 tokens ([1024, 768,
  600, 512, 450, 350, 250, 142]), H8/4 causal, each held against
  ``_varlen_forward_plain`` per row (fp16 at its forward tolerance 1e-2).
  The head library runs the cluster of two blocks on its 64 x 64 walk; a
  base library whose plan sends D1024 to the mma.sync route is given its
  plan's row tile and each Q tile's [jmin, jmax] at it
  (``LegacyVarlenWideFwd``);
* paged_decode and paged_decode_int8 (``--kernels paged_decode`` runs
  both): the serving step over bf16 and over int8 pools (B4, lens 64 tokens
  into generation, page 256, D512), four layers' pools in turn, each held
  against ``_paged_decode_plain`` per row at the bf16 forward tolerance
  2e-2; paged_decode_page16 and paged_decode_page32_int8 the same step
  over pages of 16 bf16 and 32 int8 rows (boxes of 16 and 32 rows);
  paged_decode_page24 over pages of 24 rows and paged_decode_d1024 at
  D1024 (page 256), where a base built from sources before the one-route
  block runs its cp.async kernel. A base library whose
  entry point still takes a row tile and kv_per_split is given them
  (``LegacyPagedArgs``);
* varlen_dkdv and varlen_dq: the packed-training backward of
  ``chip_smoke.py`` (8 documents of 2048..284 tokens, 8192 in all, H8/4
  D512 causal bf16), each kernel alone on the plain forward's (o, lse) with
  its tile schedule computed beforehand (``varlen._backward_schedules`` on
  the forward's 64 x 64 walk); the kernel's device time alone (either
  tree's kernel, ``VARLEN_DKDV_KERNELS`` / ``varlen.DQ_KERNELS``) and the
  names of the kernels each tree ran. At D512 the head library runs the wgmma
  routes; a base library without ``ffpa_varlen_bwd_dkdv_plan`` (built from
  sources before the wgmma dK/dV route) is called with its own argument
  list and its mma.sync route's 128 x 32 schedule and 512-column passes
  (``LegacyVarlenBwd``);
* varlen_dkdv_d1024, varlen_dkdv_d640 and varlen_dkdv_d1024_fp16: the
  varlen dK/dV kernel alone above D512, over 8 documents packed into 4096
  tokens ([1024, 768, 600, 512, 450, 350, 250, 142]), H8/4 causal, on the
  plain forward's (o, lse), each held against ``_varlen_dkdv_plain`` (fp16
  at the fp16 gradient tolerance 1e-2). The head library runs the cluster
  of two blocks on its 64 x 64 schedule; a base library whose plan sends
  D1024 to the mma.sync route is given that route's own 128 x 32 schedule
  and 512-column passes (``LegacyVarlenWideDkdv``);
* varlen_dq_d1024, varlen_dq_d640 and varlen_dq_d1024_fp16: the varlen dQ
  kernel alone on the same packing, inputs and schedules, each held
  against ``_varlen_dq_plain`` (fp16 at 1e-2). The head library runs the
  cluster of two blocks on its 64 x 64 walk; a base library whose plan
  sends D1024 to the mma.sync route (and whose dQ entry point takes each Q
  tile's [jmin, jmax] and a row tile, at every width) is given its plan's
  row tile and that route's intervals at it (``LegacyVarlenWideDq``).

A kernel whose source the base tree lacks is timed on the head alone. Each
time is the kernels' device time per call from torch.profiler (for from_s
the from-S kernel's alone, without the copy of S), with the call's
CUDA-event time beside it (``event_ms``: device plus whatever the host adds
between launches); for the decode kernels also the host's wall-clock µs a
call spends enqueueing (``host_us``: the wrapper and its launches without a
synchronize, the least of 20 runs of 20 calls, which the host's noise only
raises). The forward's runs are
held against the plain version per output: O per row at the bf16 forward
tolerance 2e-2, lse at 1e-4 of max|lse|, the S residual per row on the
causal band at 1e-2. dkdv (dK, dV and the slab) is held against its plain
version, from_s (dV and the slab) against its own, banded_dq and banded_dk
against theirs on the slab each tree's own dK/dV (or from-S) kernel wrote, per row at the bf16 gradient tolerance
5e-2 (a row's floor at 1e-3 of the tensor's max). A miss exits 1.
max|diff| head vs base is given per output (the forward: O, lse, S; dkdv:
dK, dV, slab; from_s: dV, slab; varlen_dkdv: dK, dV). varlen_dkdv and
varlen_dq are held against their plain versions per row at the same 5e-2.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from ffpa_attn_tpu_torch.models.serving import shared_row_bias  # noqa: E402
from ffpa_attn_tpu_torch.ops import (  # noqa: E402
    _build, decode, flash_bwd, flash_fwd, paged, varlen,
)
from ffpa_attn_tpu_torch.ops.config import (  # noqa: E402
    FWD_ACC_ELEMS, cdiv, varlen_dkdv_plan, varlen_dq_plan,
)
from ffpa_attn_tpu_torch.ops.dispatch import (  # noqa: E402
    pick_backward_config, pick_varlen_backward_config,
)
from ffpa_attn_tpu_torch.ops.reference import DEFAULT_MASK_VALUE  # noqa: E402
from ffpa_attn_tpu_torch.utils.profiling import (  # noqa: E402
    cuda_ms, device_ms, device_window,
)

# kernel -> the source it is built from
SOURCE = {"flash_fwd": "flash_fwd", "flash_fwd_scores": "flash_fwd",
          "flash_fwd_train": "flash_fwd", "flash_fwd_train_scores": "flash_fwd",
          "flash_fwd_d1024": "flash_fwd",
          "decode": "decode", "decode_serving": "decode", "decode_d1024": "decode",
          "decode_d1024_serving": "decode", "dkdv": "flash_bwd",
          "dkdv_d1024": "flash_bwd", "dkdv_d640": "flash_bwd",
          "banded_dq": "flash_bwd", "dq": "flash_bwd", "dq_d1024": "flash_bwd",
          "dq_d640": "flash_bwd", "dq_d1024_fp16": "flash_bwd", "from_s": "flash_bwd",
          "from_s_d1024": "flash_bwd", "from_s_d640": "flash_bwd",
          "banded_dk": "flash_bwd", "varlen_fwd": "varlen_fwd", "varlen_fwd_train": "varlen_fwd",
          "varlen_fwd_d1024": "varlen_fwd", "varlen_fwd_d640": "varlen_fwd",
          "varlen_fwd_d1024_fp16": "varlen_fwd",
          "paged_decode": "paged_decode",
          "paged_decode_int8": "paged_decode", "paged_decode_page16": "paged_decode",
          "paged_decode_page32_int8": "paged_decode", "paged_decode_page24": "paged_decode",
          "paged_decode_d1024": "paged_decode", "varlen_dkdv": "varlen_bwd",
          "varlen_dq": "varlen_bwd", "varlen_dkdv_d1024": "varlen_bwd",
          "varlen_dkdv_d640": "varlen_bwd", "varlen_dkdv_d1024_fp16": "varlen_bwd",
          "varlen_dq_d1024": "varlen_bwd", "varlen_dq_d640": "varlen_bwd",
          "varlen_dq_d1024_fp16": "varlen_bwd"}
# The varlen forward kernels of every tree: the wgmma kernel (one block or
# the cluster) and the mma.sync kernel an older tree ran above D512.
VARLEN_FWD_KERNELS = ("varlen_fwd_kernel<", "varlen_fwd_wgmma_kernel<")
# The varlen dK/dV kernels of every tree: the wgmma kernel (one block or the
# cluster) and the mma.sync kernel an older tree ran above D512.
VARLEN_DKDV_KERNELS = ("varlen_dkdv_kernel<", "varlen_dkdv_wgmma_kernel<")
# The varlen dQ kernels of every tree: the wgmma kernel (one block or the
# cluster) and the mma.sync kernel an older tree ran above D512.
VARLEN_DQ_KERNELS = ("varlen_dq_kernel<", "varlen_dq_wgmma_kernel<")
# kernel -> the substrings of its CUDA kernels' names (either route), where a
# run also launches other kernels that are not timed
ONLY = {"from_s": flash_bwd.FROM_S_KERNELS, "from_s_d1024": flash_bwd.FROM_S_KERNELS,
        "from_s_d640": flash_bwd.FROM_S_KERNELS, "varlen_fwd": VARLEN_FWD_KERNELS,
        "varlen_fwd_train": VARLEN_FWD_KERNELS, "varlen_fwd_d1024": VARLEN_FWD_KERNELS,
        "varlen_fwd_d640": VARLEN_FWD_KERNELS, "varlen_fwd_d1024_fp16": VARLEN_FWD_KERNELS,
        "varlen_dkdv": VARLEN_DKDV_KERNELS,
        "varlen_dq": VARLEN_DQ_KERNELS, "varlen_dkdv_d1024": VARLEN_DKDV_KERNELS,
        "varlen_dkdv_d640": VARLEN_DKDV_KERNELS, "varlen_dkdv_d1024_fp16": VARLEN_DKDV_KERNELS,
        "varlen_dq_d1024": VARLEN_DQ_KERNELS, "varlen_dq_d640": VARLEN_DQ_KERNELS,
        "varlen_dq_d1024_fp16": VARLEN_DQ_KERNELS}
# kernels whose C entry point an older tree may lack
ENTRY = {"from_s": "ffpa_bwd_dkdv_from_s", "from_s_d1024": "ffpa_bwd_dkdv_from_s",
         "from_s_d640": "ffpa_bwd_dkdv_from_s", "banded_dk": "ffpa_bwd_banded_dk",
         "varlen_fwd": "ffpa_varlen_fwd", "varlen_fwd_train": "ffpa_varlen_fwd",
         "varlen_fwd_d1024": "ffpa_varlen_fwd", "varlen_fwd_d640": "ffpa_varlen_fwd",
         "varlen_fwd_d1024_fp16": "ffpa_varlen_fwd",
         "paged_decode": "ffpa_paged_decode",
         "paged_decode_int8": "ffpa_paged_decode", "paged_decode_page16": "ffpa_paged_decode",
         "paged_decode_page32_int8": "ffpa_paged_decode",
         "paged_decode_page24": "ffpa_paged_decode", "paged_decode_d1024": "ffpa_paged_decode",
         "varlen_dkdv": "ffpa_varlen_bwd_dkdv",
         "varlen_dq": "ffpa_varlen_bwd_dq", "varlen_dkdv_d1024": "ffpa_varlen_bwd_dkdv",
         "varlen_dkdv_d640": "ffpa_varlen_bwd_dkdv", "varlen_dkdv_d1024_fp16": "ffpa_varlen_bwd_dkdv",
         "varlen_dq_d1024": "ffpa_varlen_bwd_dq", "varlen_dq_d640": "ffpa_varlen_bwd_dq",
         "varlen_dq_d1024_fp16": "ffpa_varlen_bwd_dq"}


# Whether the base tree's flash_bwd.cu / varlen_bwd.cu take a ring cap (set
# by main from the sources; every adapter below serves only the base tree).
BASE_RING = {"flash_bwd": True, "varlen_bwd": True}
# entry point -> index of the ring cap in the package's argument list
RING_AT = {"ffpa_bwd_dkdv": -2, "ffpa_bwd_dq": -2, "ffpa_bwd_dkdv_from_s": -2,
           "ffpa_varlen_bwd_dkdv": -2, "ffpa_varlen_bwd_dq": -2, "ffpa_bwd_dkdv_plan": -1,
           "ffpa_bwd_dq_plan": -1, "ffpa_bwd_from_s_plan": -1, "ffpa_varlen_bwd_dkdv_plan": -1,
           "ffpa_varlen_bwd_dq_plan": -1}


def pre_ring(table: dict, name: str) -> list:
    """``table[name]`` without the ring cap: the argument list of sources
    before it (every older tree the Legacy adapters below serve)."""
    argtypes = list(table[name])
    if name in RING_AT:
        del argtypes[RING_AT[name] % len(argtypes)]
    return argtypes


def base_plan(lib, source: str, table: dict, name: str, *args) -> int:
    """Call the plan entry point ``name`` of the base tree's library
    ``lib`` (of ``source``), with a ring cap of 0 where its sources take
    one."""
    fn = getattr(lib, name)
    ring = BASE_RING[source]
    fn.argtypes = table[name] if ring else pre_ring(table, name)
    fn.restype = ctypes.c_int
    return fn(*args, *((0,) if ring else ()))


def legacy_splits(blocks_per_split: int, kv_tiles: int, num_sms: int, *_) -> int:
    """The split count of the retired cp.async decode route (``ops/decode.py``
    before the two-warpgroup block): about two blocks on every SM, at least
    one KV tile a split, no empty trailing split."""
    if kv_tiles <= 0:
        return 1
    want = cdiv(2 * num_sms, max(blocks_per_split, 1))
    splits = max(1, min(kv_tiles, want))
    return cdiv(kv_tiles, cdiv(kv_tiles, splits))


def cp_async_decode(lib, d: int) -> bool:
    """Whether decode library ``lib`` sends head dim ``d`` (D = Dv, the A/B's
    two packed rows) to the cp.async route."""
    if not hasattr(lib, "ffpa_decode_plan"):
        return True
    out = (ctypes.c_int * 8)()
    fn = lib.ffpa_decode_plan
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    fn.restype = ctypes.c_int
    if fn(d, d, 2, out, len(out)) != 0:
        raise RuntimeError(f"ffpa_decode_plan failed at D{d}")
    return out[0] == 0


def mma_sync_passes(d: int, dv: int) -> int:
    """The column passes an older tree's mma.sync dK/dV kernels took (dense
    before the cluster, varlen above D512): at most 512 columns of dK and of
    dV a pass."""
    return max(cdiv(d, 512), cdiv(dv, 512))


def build_tree(src: Path, out: Path, wanted) -> dict:
    """Compile the sources ``wanted`` that ``src`` has into ``out`` (nvcc in
    parallel) and load the libraries."""
    out.mkdir(parents=True, exist_ok=True)
    names = [n for n in _build.SOURCES if n in wanted and (src / f"{n}.cu").exists()]
    procs = {
        name: subprocess.Popen([
            _build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src),
            "-o", str(out / f"lib{name}.so"), str(src / f"{name}.cu"),
        ])
        for name in names
    }
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on {src / name}.cu")
    libs = {}
    for name in names:
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        lib.ffpa_error_string.argtypes = [ctypes.c_int]
        lib.ffpa_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


class LegacyRingCap:
    """A flash_bwd or varlen_bwd library built from sources before the
    backward rings' run-time cap (the argument lists of the parent of the
    autotune slice): its backward entry points and their plans take no
    ring_cap, so the one the package's wrappers pass (0, the plan's depth,
    in every run of this tool) is taken out of the argument list; any other
    cap raises. Every other symbol is the wrapped library's own (or its
    inner adapter's)."""

    @staticmethod
    def needed(src: Path, source: str) -> bool:
        """Whether ``source``.cu in ``src`` predates the ring cap."""
        return "int ring_cap" not in (src / f"{source}.cu").read_text()

    def __init__(self, lib, table: dict):
        self._lib, self._table = lib, table

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name not in RING_AT:
            return fn
        argtypes = pre_ring(self._table, name)
        if isinstance(fn, ctypes._CFuncPtr):
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        at = RING_AT[name] % len(self._table[name])

        def call(*args):
            args = list(args)
            if args[at] != 0:
                raise ValueError(f"{name}: a library without the ring cap launches at the "
                                 f"plan's depth only")
            del args[at]
            return fn(*args)

        call.argtypes = argtypes
        return call


class LegacyDsBits:
    """A flash_bwd library built from sources before the e4m3 dS slab: its
    dK/dV and banded dQ entry points, their plan and their attributes take
    no dS width, so the 16 the package's wrappers pass (every run of this
    tool stores a 16-bit slab) is taken out of the argument list; any other
    width raises. Every other symbol is the wrapped library's own."""

    # entry point -> index of the dS width in the package's argument list
    DS_BITS = {"ffpa_bwd_dkdv": -2, "ffpa_bwd_banded_dq": -2, "ffpa_bwd_banded_plan": 1,
               "ffpa_bwd_banded_attrs": 2, "ffpa_bwd_dkdv_attrs": 2}

    @staticmethod
    def needed(src: Path) -> bool:
        """Whether the sources in ``src`` predate the dS width."""
        return "int ds_bits" not in (src / "flash_bwd.cu").read_text()

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name not in self.DS_BITS:
            return fn
        argtypes = pre_ring(flash_bwd._ARGTYPES, name)
        at = self.DS_BITS[name] % len(argtypes)
        del argtypes[at]
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int

        def call(*args):
            args = list(args)
            if args[at] != 16:
                raise ValueError(f"{name}: a library without the e4m3 slab takes 16-bit dS only")
            del args[at]
            return fn(*args)

        call.argtypes = fn.argtypes
        return call


class LegacyBanded:
    """A flash_bwd library built from sources whose banded entry points
    still read their row-tile argument, which the package's wrappers pass
    as 0 (the current launcher picks its own tiles): the tile those sources
    took is put in, 64 where a 64 x D fp32 tile fits the registers and
    divides the slab's rows (dQ) or columns (dK), else 32. Every other
    symbol is the library's own."""

    # entry point -> (index of the tile, of D, of the slab dimension it divides)
    TILE_ARG = {"ffpa_bwd_banded_dq": (5, 11, 12), "ffpa_bwd_banded_dk": (4, 10, 12)}

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name not in self.TILE_ARG:
            return fn
        fn.argtypes = flash_bwd._ARGTYPES[name]
        tile, d, dim = self.TILE_ARG[name]

        def call(*args):
            args = list(args)
            args[tile] = 64 if 64 * args[d] <= FWD_ACC_ELEMS and args[dim] % 64 == 0 else 32
            return fn(*args)

        call.argtypes = fn.argtypes
        return call


class LegacyDkdv:
    """A flash_bwd library built from sources before the dK/dV cluster
    route: D or Dv above 512 take its mma.sync kernel, whose entry point
    takes col_passes after Dv (the current one picks its own passes), so
    the passes those sources' wrapper passed (``mma_sync_passes``) are put
    in. Every other symbol is the wrapped library's own."""

    PASSES, D, DV = 24, 22, 23  # ffpa_bwd_dkdv's col_passes, D and Dv

    @staticmethod
    def needed(lib) -> bool:
        """Whether ``lib`` sends D1024 to the mma.sync route (route 0)."""
        if not hasattr(lib, "ffpa_bwd_dkdv_plan"):
            return True
        out = (ctypes.c_int * 64)()
        return (base_plan(lib, "flash_bwd", flash_bwd._ARGTYPES, "ffpa_bwd_dkdv_plan", 1024, 1024,
                          out, len(out)) == 0 and out[0] == 0)

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name != "ffpa_bwd_dkdv":
            return fn
        argtypes = pre_ring(flash_bwd._ARGTYPES, name)
        argtypes.insert(self.PASSES, ctypes.c_int)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int

        def call(*args):
            args = list(args)
            args.insert(self.PASSES, mma_sync_passes(args[self.D], args[self.DV]))
            return fn(*args)

        call.argtypes = fn.argtypes
        return call


class LegacyDq:
    """A flash_bwd library built from sources before the dQ cluster route:
    D or Dv above 512 take its mma.sync kernel, which reads block_q (the
    current entry point takes its own 64-row tile, and the wrapper passes
    0), so the row tile that library's own plan names is put in. Every
    other symbol is the wrapped library's own."""

    BLOCK_Q, D, DV = 16, 22, 23  # ffpa_bwd_dq's block_q, D and Dv

    @staticmethod
    def _rows(lib, d: int, dv: int) -> tuple:
        """(route, Q rows) of ``lib``'s dQ plan at (d, dv)."""
        out = (ctypes.c_int * 32)()
        if base_plan(lib, "flash_bwd", flash_bwd._ARGTYPES, "ffpa_bwd_dq_plan", d, dv, out,
                     len(out)) != 0:
            raise RuntimeError(f"the base library refuses a dQ plan at D{d}/Dv{dv}")
        return out[0], out[1]

    @staticmethod
    def needed(lib) -> bool:
        """Whether ``lib`` sends D1024 to the mma.sync route (route 0)."""
        return LegacyDq._rows(lib, 1024, 1024)[0] == 0

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name != "ffpa_bwd_dq":
            return fn
        fn.argtypes = pre_ring(flash_bwd._ARGTYPES, name)
        fn.restype = ctypes.c_int

        def call(*args):
            args = list(args)
            args[self.BLOCK_Q] = self._rows(self._lib, args[self.D], args[self.DV])[1]
            return fn(*args)

        call.argtypes = fn.argtypes
        return call


class LegacyPagedArgs:
    """A paged_decode library built from sources with the cp.async route
    beside the TMA one: its entry point takes a row tile after
    the int8 flag and the cp.async route's kv_per_split before the split
    count, which the package's wrapper no longer passes. It is given 16
    (the row tile those sources planned for R <= 16 on both routes) and the
    capacity's 64-row tiles cut evenly over the wrapper's splits (its TMA
    route reads neither; at the wrapper's splits its cp.async route walks
    the same capacity). Its plan and attribute entry points are not
    called."""

    @staticmethod
    def needed(src: Path) -> bool:
        """Whether the sources in ``src`` still take kv_per_split."""
        return "kv_per_split" in (src / "paged_decode.cu").read_text()

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name != "ffpa_paged_decode":
            return fn
        argtypes = list(paged._ARGTYPES[name])
        argtypes.insert(13, ctypes.c_int)  # the row tile, after the int8 flag
        argtypes.insert(26, ctypes.c_int)  # kv_per_split, before the split count
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int

        def call(*args):
            page, max_pages, splits = args[19], args[20], args[25]
            kv_per_split = cdiv(cdiv(max_pages * page, 64), splits) * 64
            return fn(*args[:13], 16, *args[13:25], kv_per_split, *args[25:])

        call.argtypes = argtypes
        return call


class LegacyVarlenBwd:
    """A varlen_bwd library built from sources before the wgmma dK/dV
    route: its dK/dV entry point takes no order (the argument after imax),
    reads the intervals at its own 128 x 32 tiles and splits the columns
    into passes of 512. Those intervals (``SCHEDULE``, set by
    ``make_runs``) and passes are put in; every other symbol is the
    library's own."""

    SCHEDULE = None  # (imin, imax) at 128 x 32
    IMIN, IMAX, ORDER, TILES, D, DV, PASSES = 20, 21, 22, 29, 30, 31, 32

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name != "ffpa_varlen_bwd_dkdv":
            return fn
        argtypes = pre_ring(varlen._VARLEN_BWD_ARGTYPES, name)
        del argtypes[self.ORDER]
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int

        def call(*args):
            args = list(args)
            imin, imax = self.SCHEDULE
            args[self.IMIN], args[self.IMAX] = imin.data_ptr(), imax.data_ptr()
            args[self.TILES] = imin.shape[0]
            args[self.PASSES] = mma_sync_passes(args[self.D], args[self.DV])
            del args[self.ORDER]
            return fn(*args)

        call.argtypes = argtypes
        return call


class LegacyVarlenWideDkdv:
    """A varlen_bwd library whose plan sends D or Dv above 512 to its
    mma.sync dK/dV kernel (built from sources before the cluster route):
    there its entry point reads each KV tile's interval at its own 128 x 32
    tiles, ceil(Tk / 32) KV tiles and passes of 512 columns, and not the
    order. Those intervals (``SCHEDULE``, set by ``make_runs`` for the wide
    packing) and passes are put in at D or Dv above 512; every other call
    and symbol is the library's own."""

    SCHEDULE = None  # (imin, imax) at 128 x 32
    IMIN, IMAX, TILES, D, DV, PASSES = 20, 21, 29, 30, 31, 32

    @staticmethod
    def needed(lib) -> bool:
        """Whether ``lib`` sends D1024 to the mma.sync route (route 0)."""
        out = (ctypes.c_int * 64)()
        return (base_plan(lib, "varlen_bwd", varlen._VARLEN_BWD_ARGTYPES,
                          "ffpa_varlen_bwd_dkdv_plan", 1024, 1024, out, len(out)) == 0
                and out[0] == 0)

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name != "ffpa_varlen_bwd_dkdv":
            return fn
        fn.argtypes = pre_ring(varlen._VARLEN_BWD_ARGTYPES, name)
        fn.restype = ctypes.c_int

        def call(*args):
            args = list(args)
            if max(args[self.D], args[self.DV]) > 512:
                imin, imax = self.SCHEDULE
                args[self.IMIN], args[self.IMAX] = imin.data_ptr(), imax.data_ptr()
                args[self.TILES] = imin.shape[0]
                args[self.PASSES] = mma_sync_passes(args[self.D], args[self.DV])
            return fn(*args)

        call.argtypes = fn.argtypes
        return call


class LegacyVarlenWideDq:
    """A varlen_bwd library whose plan sends D or Dv above 512 to its
    mma.sync dQ kernel (built from sources before the dQ cluster route):
    its dQ entry point takes each Q tile's [jmin, jmax] (the two arguments
    before the tile list) and a row tile (the argument before Hq), and
    above D512 walks every 64-row KV tile of each ``block_q``-row Q tile's
    interval. There the row tile its plan names and those intervals
    (``SCHEDULE[(tq, rows)]``, set by ``make_runs`` for the wide packing)
    and their Q tile count are put in; at D, Dv <= 512 (its wgmma route)
    the intervals are null and the row tile is not read. Every other symbol
    is the library's own."""

    SCHEDULE = {}  # (tq, rows) -> (jmin, jmax) at rows x 64
    ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 8 + [ctypes.c_void_p] * 13
                + [ctypes.c_int] * 10 + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                + [ctypes.c_void_p])
    TILES, HQ, TQ, NQT, D, DV = 19, 24, 26, 28, 30, 31  # in the head's argument list

    @staticmethod
    def rows(lib, d: int, dv: int) -> int:
        """The route (0 mma.sync) and row tile of ``lib``'s dQ plan."""
        out = (ctypes.c_int * 64)()
        if base_plan(lib, "varlen_bwd", varlen._VARLEN_BWD_ARGTYPES, "ffpa_varlen_bwd_dq_plan",
                     d, dv, out, len(out)) != 0:
            raise RuntimeError(f"the base library's dQ plan refuses D{d}/Dv{dv}")
        return out[0], out[1]

    @classmethod
    def needed(cls, lib) -> bool:
        """Whether ``lib`` sends D1024 to the mma.sync route (route 0)."""
        return hasattr(lib, "ffpa_varlen_bwd_dq_plan") and cls.rows(lib, 1024, 1024)[0] == 0

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name != "ffpa_varlen_bwd_dq":
            return fn
        fn.argtypes = self.ARGTYPES
        fn.restype = ctypes.c_int

        def call(*args):
            args = list(args)
            jmin = jmax = None
            route, rows = self.rows(self._lib, args[self.D], args[self.DV])
            if route == 0:
                jmin, jmax = self.SCHEDULE[(args[self.TQ], rows)]
                args[self.NQT] = jmin.shape[0]
            old = (args[:self.TILES] + [None if jmin is None else jmin.data_ptr(),
                                        None if jmax is None else jmax.data_ptr()]
                   + args[self.TILES:self.HQ] + [rows] + args[self.HQ:])
            return fn(*old)

        call.argtypes = self.ARGTYPES
        return call


class LegacyVarlenFwd:
    """A varlen_fwd library built from sources before the wgmma route: its
    entry point takes no needed-tile list, counts or order (the three
    arguments after jmax) and no KV tile count (the argument after the Q
    tile count), and walks each ``block_q``-row Q tile's [jmin, jmax]. The
    intervals at 64-row Q tiles of the packing of ``tq`` rows
    (``SCHEDULE[tq]``, set by ``make_runs``) and that row tile are put in;
    every other symbol is the library's own."""

    SCHEDULE = {}  # tq -> (jmin, jmax) at 64 x 64
    JMIN, JMAX, TILES, NTILE, ORDER, BLOCK_Q, TQ, NQT, NKVT = 15, 16, 17, 18, 19, 22, 25, 27, 28

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name != "ffpa_varlen_fwd":
            return fn
        drop = (self.NKVT, self.ORDER, self.NTILE, self.TILES)  # descending
        argtypes = list(varlen._VARLEN_ARGTYPES[name])
        for i in drop:
            del argtypes[i]
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int

        def call(*args):
            args = list(args)
            jmin, jmax = self.SCHEDULE[args[self.TQ]]
            args[self.JMIN], args[self.JMAX] = jmin.data_ptr(), jmax.data_ptr()
            args[self.BLOCK_Q], args[self.NQT] = 64, jmin.shape[0]
            for i in drop:
                del args[i]
            return fn(*args)

        call.argtypes = argtypes
        return call


class LegacyVarlenWideFwd:
    """A varlen_fwd library whose plan sends D or Dv above 512 to its
    mma.sync kernel (built from sources before the forward's cluster
    route): there its entry point walks every KV tile of each
    ``block_q``-row Q tile's [jmin, jmax] (ceil(Tq / block_q) Q tiles). The
    row tile its plan names, the intervals at it (``SCHEDULE[(tq, rows)]``,
    set by ``make_runs`` for the wide packing) and their Q tile count are
    put in; at D, Dv <= 512 (its wgmma route) the call is passed as it is.
    Every other symbol is the library's own."""

    SCHEDULE = {}  # (tq, rows) -> (jmin, jmax) at rows x 64
    JMIN, JMAX, BLOCK_Q, TQ, NQT, D, DV = 15, 16, 22, 25, 27, 29, 30

    @staticmethod
    def plan(lib, d: int, dv: int) -> tuple:
        """The route (0 mma.sync) and row tile of ``lib``'s forward plan."""
        fn = lib.ffpa_varlen_fwd_plan
        fn.argtypes = varlen._VARLEN_ARGTYPES["ffpa_varlen_fwd_plan"]
        fn.restype = ctypes.c_int
        out = (ctypes.c_int * 32)()
        if fn(d, dv, out, len(out)) != 0:
            raise RuntimeError(f"the base library's forward plan refuses D{d}/Dv{dv}")
        return out[0], out[1]

    @classmethod
    def needed(cls, lib) -> bool:
        """Whether ``lib`` sends D1024 to the mma.sync route (route 0)."""
        return hasattr(lib, "ffpa_varlen_fwd_plan") and cls.plan(lib, 1024, 1024)[0] == 0

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name != "ffpa_varlen_fwd":
            return fn
        fn.argtypes = varlen._VARLEN_ARGTYPES[name]
        fn.restype = ctypes.c_int

        def call(*args):
            args = list(args)
            route, rows = self.plan(self._lib, args[self.D], args[self.DV])
            if route == 0:
                jmin, jmax = self.SCHEDULE[(args[self.TQ], rows)]
                args[self.JMIN], args[self.JMAX] = jmin.data_ptr(), jmax.data_ptr()
                args[self.BLOCK_Q], args[self.NQT] = rows, jmin.shape[0]
            return fn(*args)

        call.argtypes = fn.argtypes
        return call


TOL = 5e-2  # bf16 gradients (tests/test_ffpa_bwd.py:19)
# Gradient kernels run in fp16: its gradient tolerance (tests/test_ffpa_bwd.py:19).
GRAD_KERNEL_TOL = {"dkdv_d1024": 1e-2, "dkdv_d640": 1e-2, "dq_d1024_fp16": 1e-2,
                   "varlen_dkdv_d1024_fp16": 1e-2, "varlen_dq_d1024_fp16": 1e-2}
# Per-kernel tolerances where a kernel is held to the forward's (per row).
KERNEL_TOL = {"paged_decode": 2e-2, "paged_decode_int8": 2e-2, "paged_decode_page16": 2e-2,
              "paged_decode_page32_int8": 2e-2, "paged_decode_page24": 2e-2,
              "paged_decode_d1024": 2e-2, "decode": 2e-2,
              "decode_serving": 2e-2, "decode_d1024": 2e-2, "decode_d1024_serving": 2e-2,
              "varlen_fwd": 2e-2, "varlen_fwd_train": 2e-2,
              "varlen_fwd_d1024": 2e-2, "varlen_fwd_d640": 2e-2, "varlen_fwd_d1024_fp16": 1e-2}
# The forward's outputs: O per row (bf16, tests/test_features.py:127), lse
# relative to max|lse| (fp32 math on both sides), S per row on the band.
FWD_TOL = {"o": 2e-2, "lse": 1e-4, "s": 1e-2}


def host_us(fn, calls: int = 20, repeats: int = 20) -> float:
    """Wall-clock µs a call of ``fn`` spends on the host, enqueueing only:
    the least of ``repeats`` runs of ``calls`` calls."""
    best = float("inf")
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return best


def row_rel(got, want, floor: float = 1e-3) -> float:
    """Largest per-row max|got - want| over the row's max|want|, floored at
    ``floor`` of the tensor's max (causal row 0 of dQ is 0 by cancellation)."""
    got, want = got.float(), want.float()
    ref = want.abs().amax(-1).clamp_min(floor * float(want.abs().max()) + 1e-30)
    return float(((got - want).abs().amax(-1) / ref).max())


def fwd_errs(got, want) -> dict:
    """{output: error} of a causal self-attention forward run (Nq = Nkv)
    against its plain version."""
    o, lse = got[0].float(), got[1].float()
    errs = {"o": row_rel(o, want[0], floor=0.0),
            "lse": float((lse - want[1]).abs().max() / want[1].abs().max())}
    if len(got) == 3:
        n = o.shape[2]
        band = torch.ones((n, n), dtype=torch.bool, device=o.device).tril()
        g, w = got[2][:, :, :n, :n].float(), want[2][:, :, :n, :n].float()
        err = torch.where(band, (g - w).abs(), 0.0).amax(-1)
        ref = torch.where(band, w.abs(), 0.0).amax(-1).clamp_min(1e-30)
        errs["s"] = float((err / ref).max())
    return errs


def make_runs(gen) -> tuple:
    """({kernel: a function that launches it once at its main-path shape},
    reset, {kernel: its plain version on the inputs of the last run})."""

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    b, hq, hkv, d = 1, 8, 4, 512
    scale = 1.0 / math.sqrt(d)
    n, max_len, nt = 4096, 4224, 8192
    q, k, v = randn(b, hq, n, d), randn(b, hkv, n, d), randn(b, hkv, n, d)
    wq, wk, wv = randn(b, hq, n, 1024), randn(b, hkv, n, 1024), randn(b, hkv, n, 1024)
    cols = torch.arange(max_len, device="cuda")
    bias = torch.where(cols <= n, 0.0, DEFAULT_MASK_VALUE).float()[None, None, None]
    turn = [0]
    # The serving step: B4, max_len 1152, 64 tokens into generation; prompt
    # rows below lens[b], the gap, the generated rows from the longest prompt.
    slens, smax, st = [589, 698, 763, 886], 1152, 64
    sbias = shared_row_bias(torch.tensor(slens, device="cuda"), st, max(slens), smax)
    # (head dim, serving) -> (q, four caches); made at first use.
    dec_inputs, last_cache = {}, {}

    def dec_in(serving, hd):
        if (hd, serving) not in dec_inputs:
            db, nkv = (4, smax) if serving else (b, max_len)
            dec_inputs[(hd, serving)] = (randn(db, hq, 1, hd), [
                (randn(db, hkv, nkv, hd), randn(db, hkv, nkv, hd)) for _ in range(4)])
        return dec_inputs[(hd, serving)]

    def run_decode(serving=False, hd=d):
        q_, pool = dec_in(serving, hd)
        kc, vc = last_cache[(hd, serving)] = pool[turn[0] % len(pool)]
        turn[0] += 1
        return decode._decode_forward(q_, kc, vc, sbias if serving else bias,
                                      scale=hd ** -0.5, is_causal=False)

    def decode_plain(serving=False, hd=d):
        q_, _ = dec_in(serving, hd)
        kc, vc = last_cache[(hd, serving)]
        o, _ = decode._decode_plain(q_.reshape(q_.shape[0], hkv, hq // hkv, hd), kc, vc,
                                    sbias if serving else bias, nq=1, scale=hd ** -0.5,
                                    is_causal=False, softcap=0.0, window_left=-1,
                                    window_right=-1)
        return o.reshape(q_.shape)

    # The backward's inputs: the plain forward's (o, lse), not a kernel's,
    # so both trees see the same ones.
    tq, tdo = randn(b, hq, nt, d), randn(b, hq, nt, d)
    tk, tv = randn(b, hkv, nt, d), randn(b, hkv, nt, d)
    cfg = pick_backward_config(d=d, dv=d, nq=nt, nkv=nt, dtype=torch.bfloat16)
    state = {}
    for window in ((-1, -1), (4096, -1)):
        o, lse = flash_fwd.flash_attention_forward_plain(tq, tk, tv, None, scale=scale,
                                                         is_causal=True, window=window)
        state[window] = (lse, (tdo.float() * o.float()).sum(-1))
        del o
    kw = dict(scale=scale, is_causal=True, causal_offset=0, dropout_p=0.0, group=hq // hkv)

    def run_dkdv():
        lse, delta = state[(-1, -1)]
        out = flash_bwd._dkdv_launch(tq, tk, tv, None, tdo, lse, delta, 0, cfg,
                                     grad_kv_storage_dtype=None, emit_ds=True, **kw)
        state["ds"] = out[2]
        return out

    # The dK/dV cluster route's shapes: fp16, the plain forward's (o, lse).
    wn = n  # n is reused below
    def wide_inputs(wd):
        def h(*shape):
            return torch.randn(shape, generator=gen, device="cuda").half()

        q_, k_, v_, do_ = h(b, hq, wn, wd), h(b, hkv, wn, wd), h(b, hkv, wn, wd), h(b, hq, wn, wd)
        o_, lse_ = flash_fwd.flash_attention_forward_plain(q_, k_, v_, None, scale=wd ** -0.5,
                                                           is_causal=True)
        return q_, k_, v_, do_, lse_, (do_.float() * o_.float()).sum(-1)

    wide = {}  # made at first use: only these two runs need them

    def run_dkdv_wide(wd):
        if wd not in wide:
            wide[wd] = wide_inputs(wd)
        q_, k_, v_, do_, lse_, delta_ = wide[wd]
        wcfg = pick_backward_config(d=wd, dv=wd, nq=wn, nkv=wn, dtype=torch.float16)
        return flash_bwd._dkdv_launch(q_, k_, v_, None, do_, lse_, delta_, 0, wcfg,
                                      grad_kv_storage_dtype=None, emit_ds=True,
                                      scale=wd ** -0.5, is_causal=True, causal_offset=0,
                                      dropout_p=0.0, group=hq // hkv)

    def dkdv_wide_plain(wd):
        q_, k_, v_, do_, lse_, delta_ = wide[wd]
        return flash_bwd._dkdv_plain(q_, k_, v_, None, do_, lse_, delta_, scale=wd ** -0.5,
                                     emit_ds=True, nq_pad=wn, nkv_pad=wn, is_causal=True,
                                     causal_offset=0, dropout_p=0.0, seed=0, softcap=0.0,
                                     window=(-1, -1), alibi=None)

    # The from-S cluster route's shapes: bf16, the plain forward's (lse, S),
    # so both trees read the same ones; each call works on a copy of S.
    def s_wide_inputs(wd):
        q_, k_, v_, do_ = (randn(b, hq, wn, wd), randn(b, hkv, wn, wd), randn(b, hkv, wn, wd),
                           randn(b, hq, wn, wd))
        o_, lse_ = flash_fwd.flash_attention_forward_plain(q_, k_, v_, None, scale=wd ** -0.5,
                                                           is_causal=True)
        s_ = flash_fwd.scores_plain(q_, k_, None, scale=wd ** -0.5, is_causal=True, nq_pad=wn,
                                    nkv_pad=wn)
        return q_, v_, do_, lse_, (do_.float() * o_.float()).sum(-1), s_

    s_wide = {}  # made at first use: only these two runs need them
    s_wkw = dict(is_causal=True, causal_offset=0, dropout_p=0.0)

    def run_from_s_wide(wd):
        if wd not in s_wide:
            s_wide[wd] = s_wide_inputs(wd)
        q_, v_, do_, lse_, delta_, s_ = s_wide[wd]
        wcfg = dataclasses.replace(pick_backward_config(d=wd, dv=wd, nq=wn, nkv=wn,
                                                        dtype=torch.bfloat16),
                                   dkdv_dk_in_kernel=False)
        _, dv_, slab_ = flash_bwd._dkdv_from_s_launch(q_, v_, s_.clone(), do_, lse_, delta_, 0,
                                                      wcfg, scale=wd ** -0.5, group=hq // hkv,
                                                      grad_kv_storage_dtype=None, **s_wkw)
        return dv_, slab_

    def from_s_wide_plain(wd):
        q_, v_, do_, lse_, delta_, s_ = s_wide[wd]
        return flash_bwd._dkdv_from_s_plain(q_, v_, s_, do_, lse_, delta_, scale=wd ** -0.5,
                                            seed=0, softcap=0.0, dk_in_kernel=False,
                                            **s_wkw)[1:]

    def run_banded():
        if "ds" not in state:
            run_dkdv()
        return flash_bwd._banded_dq_from_ds(state["ds"], tk, cfg, scale=scale, group=hq // hkv,
                                            nq=nt, nkv=nt, causal_offset=0,
                                            dq_dtype=torch.bfloat16)

    def run_dq():
        lse, delta = state[(4096, -1)]
        return flash_bwd._dq_launch(tq, tk, tv, None, tdo, lse, delta, 0, cfg,
                                    grad_q_storage_dtype=None, window=(4096, -1), **kw)[0]

    # The dQ cluster route's shapes: the plain forward's (o, lse), so both
    # trees read the same ones.
    dq_wide = {}  # made at first use: only these runs need them

    def dq_wide_inputs(wd, dt):
        if (wd, dt) not in dq_wide:
            def h(*shape):
                return torch.randn(shape, generator=gen, device="cuda").to(dt)

            q_, k_, v_, do_ = h(b, hq, wn, wd), h(b, hkv, wn, wd), h(b, hkv, wn, wd), h(b, hq, wn,
                                                                                        wd)
            o_, lse_ = flash_fwd.flash_attention_forward_plain(q_, k_, v_, None,
                                                               scale=wd ** -0.5, is_causal=True)
            dq_wide[wd, dt] = (q_, k_, v_, do_, lse_, (do_.float() * o_.float()).sum(-1))
        return dq_wide[wd, dt]

    def run_dq_wide(wd, dt=torch.bfloat16):
        q_, k_, v_, do_, lse_, delta_ = dq_wide_inputs(wd, dt)
        wcfg = pick_backward_config(d=wd, dv=wd, nq=wn, nkv=wn, dtype=dt)
        return flash_bwd._dq_launch(q_, k_, v_, None, do_, lse_, delta_, 0, wcfg,
                                    grad_q_storage_dtype=None, scale=wd ** -0.5, is_causal=True,
                                    causal_offset=0, dropout_p=0.0, group=hq // hkv)[0]

    def dq_wide_plain(wd, dt=torch.bfloat16):
        q_, k_, v_, do_, lse_, delta_ = dq_wide_inputs(wd, dt)
        return flash_bwd._dq_plain(q_, k_, v_, None, do_, lse_, delta_, scale=wd ** -0.5,
                                   emit_dbias=False, is_causal=True, causal_offset=0,
                                   dropout_p=0.0, seed=0, softcap=0.0, window=(-1, -1),
                                   alibi=None)[0]

    # The S-resident tier: the plain version's S residual, so both trees
    # read the same one; from_s works on a copy (it writes dS over S).
    s_pad = flash_fwd.scores_plain(tq, tk, None, scale=scale, is_causal=True, nq_pad=nt,
                                   nkv_pad=nt)
    s_cfg = dataclasses.replace(cfg, dkdv_dk_in_kernel=False)
    lse, delta = state[(-1, -1)]

    def run_from_s():
        _, dv, slab = flash_bwd._dkdv_from_s_launch(tq, tv, s_pad.clone(), tdo, lse, delta, 0,
                                                    s_cfg, grad_kv_storage_dtype=None, **kw)
        state["s_ds"] = slab
        return dv, slab

    def run_banded_dk():
        if "s_ds" not in state:
            run_from_s()
        return flash_bwd._banded_dk_from_ds(state["s_ds"], tq, s_cfg, scale=scale,
                                            group=hq // hkv, nq=nt, nkv=nt, causal_offset=0,
                                            dk_dtype=torch.bfloat16)

    # Continuous batching: the packed prefill's varlen call and a paged
    # decode step at the serving shape.
    lens = [589, 698, 763, 886]
    tot = sum(lens)
    vq, vk, vv = randn(tot, hq, d), randn(tot, hkv, d), randn(tot, hkv, d)
    cu = torch.tensor([0] + torch.tensor(lens).cumsum(0).tolist(), dtype=torch.int32,
                      device="cuda")
    # Pools keyed by kind: bf16 (False) and int8 (True) pages of 256 rows
    # at D512, pages of 16 bf16, 32 int8 and 24 bf16 rows at D512, pages of
    # 256 rows at D1024.
    kinds = {False: (d, 256, False), True: (d, 256, True), "page16": (d, 16, False),
             "page32_int8": (d, 32, True), "page24": (d, 24, False), "d1024": (1024, 256, False)}
    pools = {kind: [] for kind in kinds}
    for kind, (pd, page, quantized) in kinds.items():
        for _ in range(4):
            pool = paged.PagedKVCache.alloc(len(lens), 1152, hkv, pd, page_size=page,
                                            quantized=quantized)
            n = max(lens) + 64
            pools[kind].append(paged.fill_from_prefill(
                pool, randn(len(lens), hkv, n, pd), randn(len(lens), hkv, n, pd),
                [m + 64 for m in lens]))
    qpds = {512: randn(len(lens), hq, 1, d), 1024: randn(len(lens), hq, 1, 1024)}
    last_pool = {}

    def run_paged(kind):
        pool = pools[kind][turn[0] % 4]
        turn[0] += 1
        last_pool[kind] = pool
        pd = kinds[kind][0]
        return paged.paged_decode_attention(qpds[pd], pool, scale=pd ** -0.5)

    def paged_plain(kind):
        pd = kinds[kind][0]
        o, _ = paged._paged_decode_plain(qpds[pd].reshape(len(lens), hkv, hq // hkv, pd),
                                         last_pool[kind], nq=1, scale=pd ** -0.5, softcap=0.0,
                                         window_left=-1)
        return o.reshape(len(lens), hq, 1, pd)

    # Packed training: the backward of the 8192-token packing.
    blens = [2048, 1536, 1200, 1024, 900, 700, 500, 284]
    bt = sum(blens)
    bcu = torch.tensor([0] + torch.tensor(blens).cumsum(0).tolist(), dtype=torch.int32,
                       device="cuda")
    bq, bk, bv, bdo = randn(bt, hq, d), randn(bt, hkv, d), randn(bt, hkv, d), randn(bt, hq, d)
    meta = varlen._call_metadata(bcu, bcu, bt, bt, "cuda")
    bo, blse = varlen._varlen_forward_plain(bq, bk, bv, meta, scale=scale, causal=True)
    bcfg = pick_varlen_backward_config(d=d, dv=d, dtype=torch.bfloat16)
    bdelta = varlen._varlen_delta(bdo, bo)
    ops = varlen._BwdOperands(bq, bk, bv, bdo, blse, bdelta, None)
    sched = varlen._backward_schedules(meta, bt, varlen_dkdv_plan(d, d), varlen_dq_plan(d, d),
                                       True, (-1, -1))
    # The mma.sync dK/dV route's intervals at its 128 x 32 tiles.
    LegacyVarlenBwd.SCHEDULE = varlen._dkdv_intervals(varlen._tile_needed(*meta, 128, 32,
                                                                          True))[:2]
    bkw = dict(scale=scale, causal=True, softcap=0.0, window=(-1, -1))
    del bo
    # The varlen dK/dV above D512: 8 documents in 4096 tokens, H8/4 causal.
    wlens = [1024, 768, 600, 512, 450, 350, 250, 142]
    wt = sum(wlens)
    wcu = torch.tensor([0] + torch.tensor(wlens).cumsum(0).tolist(), dtype=torch.int32,
                       device="cuda")
    wmeta = varlen._call_metadata(wcu, wcu, wt, wt, "cuda")
    wide_varlen = {}
    for wd, wdt in ((1024, torch.bfloat16), (640, torch.bfloat16), (1024, torch.float16)):
        def h(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(wdt)

        wq_, wk_, wv_, wdo = h(wt, hq, wd), h(wt, hkv, wd), h(wt, hkv, wd), h(wt, hq, wd)
        wkw = dict(scale=wd ** -0.5, causal=True, softcap=0.0, window=(-1, -1))
        wo, wlse = varlen._varlen_forward_plain(wq_, wk_, wv_, wmeta, scale=wkw["scale"],
                                                causal=True)
        wdelta = varlen._varlen_delta(wdo, wo)
        wcfg = pick_varlen_backward_config(d=wd, dv=wd, dtype=wdt)
        wsched, wdq_sched = varlen._backward_schedules(wmeta, wt, varlen_dkdv_plan(wd, wd),
                                                       varlen_dq_plan(wd, wd), True, (-1, -1))
        wops = varlen._BwdOperands(wq_, wk_, wv_, wdo, wlse, wdelta, None)
        wargs = (wq_, wk_, wv_, wdo, wlse, wdelta)
        wide_varlen[wd, wdt] = dict(
            run=(lambda o_=wops, s_=wsched, c_=wcfg, k_=wkw:
                 varlen._varlen_dkdv_kernel(o_, wmeta, s_, c_, **k_)),
            plain=(lambda a_=wargs, k_=wkw: varlen._varlen_dkdv_plain(*a_, wmeta, **k_)),
            dq_run=(lambda o_=wops, s_=wdq_sched, k_=wkw:
                    varlen._varlen_dq_kernel(o_, wmeta, s_, **k_)),
            dq_plain=(lambda a_=wargs, k_=wkw: varlen._varlen_dq_plain(*a_, wmeta, **k_)),
            fwd_run=(lambda a_=(wq_, wk_, wv_), s_=wkw["scale"]:
                     varlen._varlen_forward(*a_, wcu, wcu, scale=s_, causal=True)[0]),
            fwd_plain=(lambda a_=(wq_, wk_, wv_), s_=wkw["scale"]:
                       varlen._varlen_forward_plain(*a_, wmeta, scale=s_, causal=True)[0]))
        del wo
    # The mma.sync routes' intervals above D512: dK/dV's at 128 x 32, dQ's
    # at each row tile x 64.
    LegacyVarlenWideDkdv.SCHEDULE = varlen._dkdv_intervals(varlen._tile_needed(
        *wmeta, 128, 32, True))[:2]
    for rows in (64, 32):
        LegacyVarlenWideDq.SCHEDULE[(wt, rows)] = LegacyVarlenWideFwd.SCHEDULE[(wt, rows)] = (
            varlen._interval_schedule(varlen._tile_needed(*varlen._q_tiles(wmeta, wt, rows), rows,
                                                          64, True)))
    vmeta = varlen._call_metadata(cu, cu, tot, tot, "cuda")
    for t_, m_ in ((tot, vmeta), (bt, meta)):  # a base library's intervals at 64 rows
        needed = varlen._tile_needed(*varlen._q_tiles(m_, t_, 64), 64, 64, True)
        LegacyVarlenFwd.SCHEDULE[t_] = varlen._interval_schedule(needed)

    def reset():
        turn[0] = 0
        state.pop("ds", None)
        state.pop("s_ds", None)

    def fwd(q_, k_, v_, scores):
        return flash_fwd.flash_attention_forward(q_, k_, v_, None, scale=q_.shape[-1] ** -0.5,
                                                 is_causal=True, return_scores=scores)

    def fwd_plain(q_, k_, v_, scores):
        hd = q_.shape[-1]
        o, lse = flash_fwd.flash_attention_forward_plain(q_, k_, v_, None, scale=hd ** -0.5,
                                                         is_causal=True)
        if not scores:
            return o, lse
        nq_pad, nkv_pad = flash_fwd.scores_padding(q_.shape[2], k_.shape[2], hd, hd, q_.dtype)
        return o, lse, flash_fwd.scores_plain(q_, k_, None, scale=hd ** -0.5, is_causal=True,
                                              nq_pad=nq_pad, nkv_pad=nkv_pad)

    fwd_inputs = {"flash_fwd": (q, k, v, False), "flash_fwd_scores": (q, k, v, True),
                  "flash_fwd_train": (tq, tk, tv, False),
                  "flash_fwd_train_scores": (tq, tk, tv, True),
                  "flash_fwd_d1024": (wq, wk, wv, False)}
    runs = {name: (lambda a=a: fwd(*a)) for name, a in fwd_inputs.items()}
    runs.update({
        "decode": lambda: run_decode()[0],
        "decode_serving": lambda: run_decode(True)[0],
        "decode_d1024": lambda: run_decode(hd=1024)[0],
        "decode_d1024_serving": lambda: run_decode(True, hd=1024)[0],
        "dkdv": run_dkdv,
        "dkdv_d1024": lambda: run_dkdv_wide(1024),
        "dkdv_d640": lambda: run_dkdv_wide(640),
        "banded_dq": run_banded,
        "dq": run_dq,
        "dq_d1024": lambda: run_dq_wide(1024),
        "dq_d640": lambda: run_dq_wide(640),
        "dq_d1024_fp16": lambda: run_dq_wide(1024, torch.float16),
        "from_s": run_from_s,
        "from_s_d1024": lambda: run_from_s_wide(1024),
        "from_s_d640": lambda: run_from_s_wide(640),
        "banded_dk": run_banded_dk,
        "varlen_fwd": lambda: varlen._varlen_forward(vq, vk, vv, cu, cu, scale=scale,
                                                     causal=True)[0],
        "varlen_fwd_train": lambda: varlen._varlen_forward(bq, bk, bv, bcu, bcu, scale=scale,
                                                           causal=True)[0],
        "paged_decode": lambda: run_paged(False),
        "paged_decode_int8": lambda: run_paged(True),
        "paged_decode_page16": lambda: run_paged("page16"),
        "paged_decode_page32_int8": lambda: run_paged("page32_int8"),
        "paged_decode_page24": lambda: run_paged("page24"),
        "paged_decode_d1024": lambda: run_paged("d1024"),
        "varlen_dkdv": lambda: varlen._varlen_dkdv_kernel(ops, meta, sched[0], bcfg, **bkw),
        "varlen_dq": lambda: varlen._varlen_dq_kernel(ops, meta, sched[1], **bkw),
        "varlen_dkdv_d1024": wide_varlen[1024, torch.bfloat16]["run"],
        "varlen_dkdv_d640": wide_varlen[640, torch.bfloat16]["run"],
        "varlen_dkdv_d1024_fp16": wide_varlen[1024, torch.float16]["run"],
        "varlen_dq_d1024": wide_varlen[1024, torch.bfloat16]["dq_run"],
        "varlen_dq_d640": wide_varlen[640, torch.bfloat16]["dq_run"],
        "varlen_dq_d1024_fp16": wide_varlen[1024, torch.float16]["dq_run"],
        "varlen_fwd_d1024": wide_varlen[1024, torch.bfloat16]["fwd_run"],
        "varlen_fwd_d640": wide_varlen[640, torch.bfloat16]["fwd_run"],
        "varlen_fwd_d1024_fp16": wide_varlen[1024, torch.float16]["fwd_run"],
    })

    def dkdv_plain():
        lse, delta = state[(-1, -1)]
        return flash_bwd._dkdv_plain(tq, tk, tv, None, tdo, lse, delta, scale=scale, emit_ds=True,
                                     nq_pad=nt, nkv_pad=nt, is_causal=True, causal_offset=0,
                                     dropout_p=0.0, seed=0, softcap=0.0, window=(-1, -1),
                                     alibi=None)

    plains = {name: (lambda a=a: fwd_plain(*a)) for name, a in fwd_inputs.items()}
    plains.update({
        "dkdv": dkdv_plain,
        "dkdv_d1024": lambda: dkdv_wide_plain(1024),
        "dkdv_d640": lambda: dkdv_wide_plain(640),
        "dq_d1024": lambda: dq_wide_plain(1024),
        "dq_d640": lambda: dq_wide_plain(640),
        "dq_d1024_fp16": lambda: dq_wide_plain(1024, torch.float16),
        "banded_dq": lambda: flash_bwd._banded_dq_plain(state["ds"], tk, scale=scale, nq=nt,
                                                        nkv=nt),
        "from_s": lambda: flash_bwd._dkdv_from_s_plain(
            tq, tv, s_pad, tdo, lse, delta, scale=scale, is_causal=True, causal_offset=0,
            dropout_p=0.0, seed=0, softcap=0.0, dk_in_kernel=False)[1:],
        "from_s_d1024": lambda: from_s_wide_plain(1024),
        "from_s_d640": lambda: from_s_wide_plain(640),
        "banded_dk": lambda: flash_bwd._banded_dk_plain(state["s_ds"], tq, scale=scale, nq=nt,
                                                        nkv=nt, hkv=hkv),
        "paged_decode": lambda: paged_plain(False),
        "paged_decode_int8": lambda: paged_plain(True),
        "paged_decode_page16": lambda: paged_plain("page16"),
        "paged_decode_page32_int8": lambda: paged_plain("page32_int8"),
        "paged_decode_page24": lambda: paged_plain("page24"),
        "paged_decode_d1024": lambda: paged_plain("d1024"),
        "decode": decode_plain,
        "decode_serving": lambda: decode_plain(True),
        "decode_d1024": lambda: decode_plain(hd=1024),
        "decode_d1024_serving": lambda: decode_plain(True, hd=1024),
        "varlen_dkdv": lambda: varlen._varlen_dkdv_plain(bq, bk, bv, bdo, blse, bdelta, meta,
                                                         **bkw),
        "varlen_dq": lambda: varlen._varlen_dq_plain(bq, bk, bv, bdo, blse, bdelta, meta, **bkw),
        "varlen_dkdv_d1024": wide_varlen[1024, torch.bfloat16]["plain"],
        "varlen_dkdv_d640": wide_varlen[640, torch.bfloat16]["plain"],
        "varlen_dkdv_d1024_fp16": wide_varlen[1024, torch.float16]["plain"],
        "varlen_dq_d1024": wide_varlen[1024, torch.bfloat16]["dq_plain"],
        "varlen_dq_d640": wide_varlen[640, torch.bfloat16]["dq_plain"],
        "varlen_dq_d1024_fp16": wide_varlen[1024, torch.float16]["dq_plain"],
        "varlen_fwd_d1024": wide_varlen[1024, torch.bfloat16]["fwd_plain"],
        "varlen_fwd_d640": wide_varlen[640, torch.bfloat16]["fwd_plain"],
        "varlen_fwd_d1024_fp16": wide_varlen[1024, torch.float16]["fwd_plain"],
        "varlen_fwd": lambda: varlen._varlen_forward_plain(vq, vk, vv, vmeta, scale=scale,
                                                           causal=True)[0],
        "varlen_fwd_train": lambda: varlen._varlen_forward_plain(bq, bk, bv, meta, scale=scale,
                                                                 causal=True)[0],
    })
    return runs, reset, plains


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True, help="directory of the other kernel sources")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kernels", default=",".join(SOURCE), help="comma-separated subset")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    kernels = [k for k in args.kernels.split(",") if k]
    if "paged_decode" in kernels and "paged_decode_int8" not in kernels:
        kernels.append("paged_decode_int8")  # paged decode is timed over both pool types
    for k in ("decode", "decode_d1024"):
        if k in kernels and f"{k}_serving" not in kernels:
            kernels.append(f"{k}_serving")  # decode is timed at both steps
    if "varlen_fwd" in kernels and "varlen_fwd_train" not in kernels:
        kernels.append("varlen_fwd_train")  # the varlen forward at both packings

    wanted = {SOURCE[k] for k in kernels}
    trees = {
        "base": build_tree(Path(args.base).resolve(), REPO / "build" / "ab" / "base", wanted),
        "head": build_tree(_build.CSRC_DIR, REPO / "build" / "ab" / "head", wanted),
    }
    base_src = Path(args.base).resolve()
    for source in BASE_RING:
        if (base_src / f"{source}.cu").exists():
            BASE_RING[source] = not LegacyRingCap.needed(base_src, source)
    base_bwd = trees["base"].get("flash_bwd")
    if base_bwd is not None and LegacyDsBits.needed(Path(args.base).resolve()):
        trees["base"]["flash_bwd"] = base_bwd = LegacyDsBits(base_bwd)
    if base_bwd is not None and not hasattr(base_bwd, "ffpa_bwd_banded_plan"):
        trees["base"]["flash_bwd"] = base_bwd = LegacyBanded(base_bwd)
    if base_bwd is not None and LegacyDkdv.needed(base_bwd):
        trees["base"]["flash_bwd"] = base_bwd = LegacyDkdv(base_bwd)
    if base_bwd is not None and LegacyDq.needed(base_bwd):
        trees["base"]["flash_bwd"] = LegacyDq(base_bwd)
    base_paged = trees["base"].get("paged_decode")
    if base_paged is not None and LegacyPagedArgs.needed(Path(args.base).resolve()):
        trees["base"]["paged_decode"] = LegacyPagedArgs(base_paged)
    base_varlen = trees["base"].get("varlen_bwd")
    if base_varlen is not None and not hasattr(base_varlen, "ffpa_varlen_bwd_dkdv_plan"):
        trees["base"]["varlen_bwd"] = base_varlen = LegacyVarlenBwd(base_varlen)
    if (base_varlen is not None and hasattr(base_varlen, "ffpa_varlen_bwd_dkdv_plan")
            and LegacyVarlenWideDkdv.needed(base_varlen)):
        trees["base"]["varlen_bwd"] = base_varlen = LegacyVarlenWideDkdv(base_varlen)
    if base_varlen is not None and LegacyVarlenWideDq.needed(base_varlen):
        trees["base"]["varlen_bwd"] = LegacyVarlenWideDq(base_varlen)
    for source, table in (("flash_bwd", flash_bwd._ARGTYPES),
                          ("varlen_bwd", varlen._VARLEN_BWD_ARGTYPES)):
        if source in trees["base"] and not BASE_RING[source]:
            trees["base"][source] = LegacyRingCap(trees["base"][source], table)
    base_fwd = trees["base"].get("varlen_fwd")
    if base_fwd is not None and not hasattr(base_fwd, "ffpa_varlen_fwd_plan"):
        trees["base"]["varlen_fwd"] = LegacyVarlenFwd(base_fwd)
    elif base_fwd is not None and LegacyVarlenWideFwd.needed(base_fwd):
        trees["base"]["varlen_fwd"] = LegacyVarlenWideFwd(base_fwd)
    runs, reset, plains = make_runs(torch.Generator(device="cuda").manual_seed(0))

    decode_splits = decode._tma_splits

    def use(tag, k):
        _build.load = lambda name: trees[tag][name]
        lib = trees[tag].get("decode")
        wide = k.startswith("decode_d1024")
        legacy = lib is not None and k.startswith("decode") and cp_async_decode(
            lib, 1024 if wide else 512)
        decode._tma_splits = legacy_splits if legacy else decode_splits

    times = {tag: {k: [] for k in kernels} for tag in trees}
    events = {tag: {k: [] for k in kernels} for tag in trees}
    enqueue = {tag: {k: [] for k in kernels if k.startswith("decode")} for tag in trees}
    vs_plain = {tag: {k: [] for k in kernels if k in plains} for tag in trees}
    names = {tag: {} for tag in trees}  # the kernels of ONLY's filters each tree ran
    outs = {}
    for tag in ("base", "head", "head", "base"):
        for k in kernels:
            if SOURCE[k] not in trees[tag] or not hasattr(trees[tag][SOURCE[k]],
                                                          ENTRY.get(k, "ffpa_error_string")):
                continue
            use(tag, k)
            reps = 5 * args.reps if k.startswith(("decode", "paged_decode")) else args.reps
            events[tag][k].append(cuda_ms(runs[k], reps=reps))
            if k in enqueue[tag]:
                enqueue[tag][k].append(round(host_us(runs[k]), 2))
            if k in ONLY:
                w = device_window(runs[k], reps=reps, warmup=3)["by_kernel"]
                hits = [ms for n, ms in w.items() if any(o in n for o in ONLY[k])]
                if not hits:
                    raise RuntimeError(f"no kernel named like {ONLY[k]} ran for {k}; the "
                                       f"profiler saw {sorted(w)}")
                times[tag][k].append(sum(hits) / reps)
                names[tag][k] = sorted(n[:80] for n in w if any(o in n for o in ONLY[k]))
            else:
                times[tag][k].append(device_ms(runs[k], reps=reps))
            reset()
            res = runs[k]()
            outs[(tag, k)] = tuple(t.float() for t in (res if isinstance(res, tuple) else (res,)))
            if SOURCE[k] == "flash_fwd" and len(outs[(tag, k)]) == 3:
                o, lse, s_pad = outs[(tag, k)]  # S above the band is never written
                outs[(tag, k)] = (o, lse, s_pad.tril_())
            if k in plains:
                want = plains[k]()
                want = want if isinstance(want, tuple) else (want,)
                if SOURCE[k] == "flash_fwd":
                    vs_plain[tag][k].append(fwd_errs(outs[(tag, k)], want))
                else:
                    floor = 0.0 if k in KERNEL_TOL else 1e-3
                    vs_plain[tag][k].append(
                        max(row_rel(g, w, floor) for g, w in zip(outs[(tag, k)], want)))
                del want
            reset()
    torch.cuda.synchronize()
    diff = {
        k: [float((h - b_).abs().max()) for h, b_ in zip(outs[("head", k)], outs[("base", k)])]
        for k in kernels if ("base", k) in outs and ("head", k) in outs
    }
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "order": "base head head base", "device_ms": times,
                      "event_ms": events, "host_us": enqueue, "kernel_names": names,
                      "max_abs_diff_head_vs_base": diff, "row_rel_err_vs_plain": vs_plain,
                      "tol": TOL, "fwd_tol": FWD_TOL, "kernel_tol": KERNEL_TOL,
                      "grad_kernel_tol": GRAD_KERNEL_TOL}))

    def held(k, e) -> bool:
        if isinstance(e, dict):
            return all(v < FWD_TOL[n] for n, v in e.items())
        return e < KERNEL_TOL.get(k, GRAD_KERNEL_TOL.get(k, TOL))

    return 0 if all(held(k, e) for per in vs_plain.values() for k, es in per.items()
                    for e in es) else 1


if __name__ == "__main__":
    sys.exit(main())
