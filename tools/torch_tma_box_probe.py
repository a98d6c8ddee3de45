"""Whether TMA's 128 B swizzle follows the shared address (so paged decode
may land a stage as boxes of fewer than 8 rows): ``tools/tma_box_probe.cu``
loads 64 cache rows of a paged bf16 pool into one 1024 B aligned stage as
boxes of 1..64 rows through the paged kernel's 3-D map, and this script
compares the stage's bytes with two images of the 64 rows: swizzled by the
row within the stage (the address rule, what the kernel's wgmma
descriptors read) and by the row within each box.

    python tools/torch_tma_box_probe.py

Needs a card and nvcc; builds into build/tma_box_probe/. Prints one JSON
line: for each (page, box rows) which image the stage equals.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from ffpa_attn_tpu_torch.ops import _build  # noqa: E402

# (page, box rows): the box is the largest power of two dividing both.
CASES = [(17, 1), (18, 2), (20, 4), (100, 4), (24, 8), (48, 16), (96, 32), (256, 64)]


def swizzled(rows_in_atom):
    """Element index (16-bit) of (row, col) of the stage, the 128 B swizzle
    taking its XOR from ``rows_in_atom(row)``."""
    out = torch.empty(64 * 64, dtype=torch.int64)
    for r in range(64):
        for c in range(64):
            byte = r * 128 + ((((c >> 3) ^ (rows_in_atom(r) & 7)) << 4) | ((c & 7) << 1))
            out[byte // 2] = r * 64 + c
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_tma_box_probe: needs a CUDA card", file=sys.stderr)
        return 1
    out_dir = REPO / "build" / "tma_box_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libtma_box_probe.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o",
                    str(lib_path), str(REPO / "tools" / "tma_box_probe.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.ffpa_tma_box_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    results = []
    for page, box_rows in CASES:
        pages = -(-64 // page) + 1
        pos = torch.arange(pages * page)[:, None]
        # Element (pos, col) holds pos * 64 + col as 16 bits: TMA moves bytes.
        pool = (pos * 64 + torch.arange(64)[None]).to(torch.int16).reshape(pages, page, 64)
        pool = pool.cuda().view(torch.bfloat16)
        out = torch.zeros(64 * 64, dtype=torch.int16, device="cuda")
        err = fn(pool.data_ptr(), pages, page, box_rows, out.data_ptr())
        if err != 0:
            raise RuntimeError(f"tma box probe page {page} box {box_rows}: CUDA error {err}")
        got = out.cpu().long()
        by_address = bool(torch.equal(got, swizzled(lambda r: r)))
        by_box_row = bool(torch.equal(got, swizzled(lambda r, b=box_rows: r % b)))
        results.append(dict(page=page, box_rows=box_rows, by_address=by_address,
                            by_box_row=by_box_row))
        print(f"page {page:4d} box_rows {box_rows:2d}: stage equals the address-swizzled image "
              f"{by_address}, the box-row-swizzled image {by_box_row}", flush=True)
    print(json.dumps({"tma_box_probe": results,
                      "device": torch.cuda.get_device_name(0),
                      "swizzle_by_address": all(r["by_address"] for r in results)}))
    return 0 if all(r["by_address"] for r in results) else 2


if __name__ == "__main__":
    sys.exit(main())
