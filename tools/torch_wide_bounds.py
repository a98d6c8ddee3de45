"""The bound of each wide kernel route: the recompute dQ's and the varlen
forward's, dK/dV's and dQ's clusters above D512, dense decode above D512
(its two-warpgroup block), and paged decode over pages of 24 rows and above D512 (its
two-warpgroup block).

Run anywhere (it needs no card: the numbers are counted from the shapes):

    python tools/torch_wide_bounds.py

Each route is counted at the shape the bench or ``chip_smoke.py`` would
give it at D1024 (dense decode at the generate step, the rows the
validity bias leaves live; paged decode at the serving step, D512 over
pages of 24 rows and D1024 over pages of 256): operations and bytes from ``utils/profiling.py`` (each input read
once, each output written once, products over the band's pairs only), the
bound (the larger of operations over 989 TFLOP/s and bytes over 3.35 TB/s)
and the launches a call makes of the route's wrapper. Prints one JSON line.
``tools/torch_wide_probe.py`` times the same routes at the same shapes on
a card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ffpa_attn_tpu_torch.utils.profiling import (  # noqa: E402
    backward_counts, bound_ms, paged_decode_counts, varlen_backward_counts, varlen_counts,
)

PACKING = [2048, 1536, 1200, 1024, 900, 700, 500, 284]  # chip_smoke.py's packed training
SERVE_LENS = [716, 825, 890, 1013]  # the serving step's cached rows (B4)


def decode_counts(live: int, nkv: int, *, hq: int, hkv: int, d: int, dv: int) -> tuple:
    """(flop, bytes) of a B1 decode step (``chip_smoke.py``'s decode row):
    the ``live`` cache rows the validity bias leaves, the bias read and the
    lse written."""
    flops, nbytes = paged_decode_counts([live], hq=hq, hkv=hkv, d=d, dv=dv)
    return flops, nbytes + 4 * nkv + 4 * hq


def routes() -> list:
    d = 1024
    wide = dict(hq=8, hkv=4, d=d, dv=d)
    return [
        ("3 (D > 512)", "dq::wgmma_dq_kernel<T, DROP, true> (the cluster)",
         "B1 H8/4 N8192 D1024 causal, recompute tier",
         "1 a recompute-tier backward",
         backward_counts("dq", b=1, nq=8192, nkv=8192, causal=True, **wide)),
        ("7 (D > 512)", "tma::decode_tma_kernel<T, true> (two consumer warpgroups)",
         "B1 H8/4 Nkv 4224 D1024, one query row, 4097 rows live under the validity bias",
         "1 a decode step (walk and split merge)", decode_counts(4097, 4224, **wide)),
        ("8 (D > 512)", "tma::varlen_fwd_wgmma_kernel<T, true> (the cluster)",
         "8 documents in 8192 tokens, H8/4 D1024 causal", "1 a packed call",
         varlen_counts(PACKING, PACKING, causal=True, **wide)),
        ("9 (D > 512)", "tma::varlen_dkdv_wgmma_kernel<T, true> (the cluster)",
         "8 documents in 8192 tokens, H8/4 D1024 causal", "1 a packed backward",
         varlen_backward_counts("varlen_dkdv", PACKING, PACKING, causal=True, **wide)),
        ("10 (D > 512)", "tma::varlen_dq_wgmma_kernel<T, true> (the cluster)",
         "8 documents in 8192 tokens, H8/4 D1024 causal", "1 a packed backward",
         varlen_backward_counts("varlen_dq", PACKING, PACKING, causal=True, **wide)),
        ("11 (page 24)", "tma::paged_tma_kernel<T, false, false> (boxes of 8 rows)",
         "B4 H8/4 D512, pages of 24 rows, the serving step", "1 a decode step (walk and merge)",
         paged_decode_counts(SERVE_LENS, hq=8, hkv=4, d=512, dv=512)),
        ("11 (D > 512)", "tma::paged_tma_kernel<T, false, true> (two consumer warpgroups)",
         "B4 H8/4 D1024, pages of 256 rows, the serving step",
         "1 a decode step (walk and merge)", paged_decode_counts(SERVE_LENS, **wide)),
    ]


def main() -> int:
    out = []
    for row, kernel, shape, launches, (flops, nbytes) in routes():
        ms, by = bound_ms(flops, nbytes)
        out.append(dict(row=row, kernel=kernel, shape=shape, launches=launches, flop=flops,
                        bytes=nbytes, bound_ms=round(ms, 4), bound_by=by))
    print(json.dumps({"wide_routes": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
