"""Variable-length (packed THD) attention: the CUDA kernels
``csrc/varlen_fwd.cu`` and ``csrc/varlen_bwd.cu`` and their plain PyTorch
versions.

Replaces three Pallas kernels of ``ffpa_attn_tpu/ops/varlen.py``: the
forward ``_varlen_fwd_kernel`` (launched by ``_varlen_forward``) and the
backward pair ``_varlen_dkdv_kernel`` and ``_varlen_dq_kernel`` (launched by
``_varlen_backward``), so packed training runs through
``ffpa_attn_varlen_func`` under ``torch.autograd``.

``cu_seqlens`` expand, with torch ops on the tensor's device and no host
sync, into per-token int32 metadata (``_segment_metadata``): segment id and
the tail-aligned causal rank, so the keep-mask is the JAX package's three
compares ``(q_seg == k_seg) & (k_pos <= q_rank [+ wr]) [& k_pos >= q_rank -
wl]`` (``_varlen_mask``). ``_tile_needed`` marks the (Q tile, KV tile)
pairs that are not provably fully masked, at each kernel's own tile sizes;
``_interval_schedule`` turns it into intervals of tiles and
``_needed_tiles`` into per-tile lists. One 64 x 64 walk serves the whole
call at every width (``_walk_schedule``: the needed matrix at 64 x 64 and
its lists): the forward and dQ walk each 64-row Q tile's needed KV tiles
only, the Q tiles most needed first; dK/dV each KV tile's [imin, imax] of
Q tiles, the needed matrix transposed (``_backward_schedules``). The
forward computes the walk once and saves it for the backward. The kernels
read their schedules from device memory.
The metadata is computed once per call, padded so that every kernel's
tiles divide it, and saved for the backward.

Bound on an H100: bytes, barely. The forward does 4 * Hq * D flop per
attended (row, col) pair, summed over the segments' bands; at the serving
packing (4 prompts of 589..886 tokens, Hq8 D512 causal) 1.8e10 flop per
layer, 0.018 ms at 989 TFLOP/s, against 0.022 ms for its 72 MB (q, k, v,
o once each) at 3.35 TB/s. A kernel that re-reads K/V per Q tile is bound
by its products long before either.

Design against that bound: the dense forward's TMA + wgmma block (64 Q
rows with Q resident, K and V boxes through a ring of stages, two consumer
warpgroups, a fast path for blocks inside one segment's band) over the
packed [T, H, D] layout through 3-D tensor maps at the true extents (no
head-major copy, no padding of T), visiting only the needed KV tiles; above
D512 a cluster of two such blocks splitting D and Dv, the partial S
exchanged through distributed shared memory.

The backward is bound by operations: 4 matmul units of 2 * Hq * D flop per
band pair for dK/dV and 3 for dQ (``utils/profiling.py``
``varlen_backward_counts``). Its kernels are the dense backward's blocks
(``csrc/flash_bwd.cu``) with the segment mask and the schedule, each with
a fast path for blocks inside one segment's band: dK/dV the TMA + wgmma
block (64 KV rows, 64-row Q tiles, the longest intervals first; above
D512 a cluster of two blocks splitting D and Dv, the partial S^T and dP^T
exchanged through distributed shared memory); dQ the TMA + wgmma block (64
Q rows walking the needed tiles, the most needed Q tiles first; above D512
a cluster of two blocks splitting D and Dv, the partial S and dP exchanged
through distributed shared memory). The dK/dV block reduces the GQA group
in fp32 in its registers. delta = rowsum(dO * O) is a plain reduction,
outside any kernel as in JAX.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..env import ENV
from ..logger import init_logger
from . import _build
from .config import (
    D_CHUNK, DKDV_MIN_STAGES, DKDV_Q_TILE, DQ_MIN_STAGES, FWD_ROW_TILES, KV_TILE, BlockConfig,
    DkdvPlan, DqPlan, FwdPlan, cdiv, ring_depth, varlen_dkdv_plan, varlen_dq_plan, varlen_fits,
    varlen_fwd_plan,
)
from .flash_bwd import dkdv_plan_from, dq_plan_from
from .flash_fwd import _pad_last, check_kernel_inputs, fwd_plan_from
from .reference import DEFAULT_MASK_VALUE

logger = init_logger(__name__)

# Kwargs the reference rejects and the varlen path does not implement
# (softcap, window_size, alibi_slopes and sinks are supported natively).
_REJECTED_KWARGS = (
    "attention_mask",
    "attn_mask",
    "block_mask",
    "score_mod",
    "aux_tensors",
    "seqused_k",
    "block_table",
    "num_splits",
)

_REJECT_DEFAULTS = {
    "num_splits": 1,
}

_BIG = 2**30


def _check_supported_options(kwargs: dict) -> None:
    """Consolidated rejection: every offending option named in one
    NotImplementedError, an unknown keyword a TypeError."""
    offending = []
    for name in _REJECTED_KWARGS:
        if name in kwargs:
            val = kwargs.pop(name)
            default = _REJECT_DEFAULTS.get(name)
            if val is not None and val != default:
                offending.append(name)
    if kwargs:
        raise TypeError(
            f"ffpa_attn_varlen_func() got unexpected keyword argument(s): "
            f"{', '.join(sorted(kwargs))}"
        )
    if offending:
        raise NotImplementedError(
            "ffpa_attn_varlen_func does not support non-default values for: "
            + ", ".join(sorted(offending))
        )


def _segment_metadata(cu_q, cu_k, tq: int, tk: int, tq_pad: int, tk_pad: int):
    """Expand cu_seqlens into per-token (q_seg, q_rank, k_seg, k_pos) int32
    arrays of lengths tq_pad and tk_pad, on the device of ``cu_q``.

    ``q_rank[t]`` is the intra-segment q position + (len_k - len_q), so the
    causal mask is ``k_pos <= q_rank`` (tail-aligned per segment). Tokens
    past ``tq`` / ``tk`` get segment id -1 (q) / -2 (k) and never match; the
    tail in ``[cu[-1], T)`` that ``pack_prompts`` pads with forms the
    pseudo-segment B (only ``t >= T`` is set to -1), as in the JAX package.
    """
    dev = cu_q.device
    cu_q = cu_q.to(torch.int32)
    cu_k = cu_k.to(device=dev, dtype=torch.int32)
    nb = cu_q.shape[0]
    tq_ids = torch.arange(tq_pad, dtype=torch.int32, device=dev)
    tk_ids = torch.arange(tk_pad, dtype=torch.int32, device=dev)
    q_seg = torch.searchsorted(cu_q[1:].contiguous(), tq_ids, right=True).to(torch.int32)
    k_seg = torch.searchsorted(cu_k[1:].contiguous(), tk_ids, right=True).to(torch.int32)
    q_start = cu_q[q_seg.long().clamp(0, nb - 2)]
    k_start = cu_k[k_seg.long().clamp(0, nb - 2)]
    len_q = cu_q[(q_seg.long() + 1).clamp(0, nb - 1)] - q_start
    len_k_of_q = cu_k[(q_seg.long() + 1).clamp(0, nb - 1)] - cu_k[q_seg.long().clamp(0, nb - 2)]
    q_pos = tq_ids - q_start
    q_rank = q_pos + (len_k_of_q - len_q)
    k_pos = tk_ids - k_start
    q_seg = torch.where(tq_ids < tq, q_seg, -1)
    k_seg = torch.where(tk_ids < tk, k_seg, -2)
    return q_seg, q_rank.to(torch.int32), k_seg, k_pos.to(torch.int32)


def _varlen_mask(q_seg, q_rank, k_seg, k_pos, causal: bool,
                 window_left: int = -1, window_right: int = -1):
    """Keep-mask from column-shaped q metadata and row-shaped k metadata:
    the sliding window is the dense path's band around the tail-aligned
    rank, ``k_pos in [q_rank - left, q_rank + right]``, per segment."""
    keep = q_seg == k_seg
    wr_eff = 0 if causal else window_right
    if causal or window_right >= 0:
        keep = keep & (k_pos <= q_rank + wr_eff)
    if window_left >= 0:
        keep = keep & (k_pos >= q_rank - window_left)
    return keep


def _tile_needed(q_seg, q_rank, k_seg, k_pos, bq, bkv, causal,
                 window_left: int = -1, window_right: int = -1):
    """``needed [nqb, nkb]``: False only where the (Q tile, KV tile) pair is
    provably fully masked (disjoint segment ranges, or every k position
    past every q rank under causal, or every k position below every row's
    window) — conservative for any packing."""
    nqb = q_seg.shape[0] // bq
    nkb = k_seg.shape[0] // bkv
    qs = q_seg.reshape(nqb, bq)
    qr = torch.where(qs >= 0, q_rank.reshape(nqb, bq), -_BIG)
    ks = k_seg.reshape(nkb, bkv)
    kp = torch.where(ks >= 0, k_pos.reshape(nkb, bkv), _BIG)

    q_seg_min = torch.where(qs >= 0, qs, _BIG).amin(dim=1)
    q_seg_max = torch.where(qs >= 0, qs, -_BIG).amax(dim=1)
    q_rank_max = qr.amax(dim=1)
    q_rank_min = torch.where(qs >= 0, q_rank.reshape(nqb, bq), _BIG).amin(dim=1)
    k_seg_min = torch.where(ks >= 0, ks, _BIG).amin(dim=1)
    k_seg_max = torch.where(ks >= 0, ks, -_BIG).amax(dim=1)
    k_pos_min = kp.amin(dim=1)
    k_pos_max = torch.where(ks >= 0, k_pos.reshape(nkb, bkv), -_BIG).amax(dim=1)

    needed = (k_seg_min[None, :] <= q_seg_max[:, None]) & (
        k_seg_max[None, :] >= q_seg_min[:, None]
    )
    wr_eff = 0 if causal else window_right
    if causal or window_right >= 0:
        needed = needed & (k_pos_min[None, :] <= q_rank_max[:, None] + wr_eff)
    if window_left >= 0:
        needed = needed & (k_pos_max[None, :] >= q_rank_min[:, None] - window_left)
    return needed


def _full_blocks(meta, q_rows: int, kv_rows: int, causal: bool, window=(-1, -1), *,
                 softcap: float = 0.0, alibi: bool = False):
    """``full [nq, nk]``: the wgmma consumers' test, in Python, of whether
    the block of ``q_rows`` query rows (block i) x ``kv_rows`` keys (block
    j) keeps every pair, so it may skip the mask: no softcap, no ALiBi, no
    left window, the block's first and last rows and keys in one segment
    (id >= 0), and, under a right edge, the last key's k_pos at most the
    first row's q_rank plus it. Exact for packings whose segments are
    contiguous with rising positions, as ``_segment_metadata`` makes them.
    The forward's consumer blocks are 64 x 32 (``_walk_schedule``'s Q
    tiles, half a KV tile each); dK/dV's are ``_dkdv_full_blocks``.
    ``window`` is normalized."""
    q_seg, q_rank, k_seg, k_pos = meta
    nq, nk = q_seg.shape[0] // q_rows, k_seg.shape[0] // kv_rows
    if softcap > 0.0 or alibi or window[0] >= 0:
        return torch.zeros((nq, nk), dtype=torch.bool, device=q_seg.device)
    qs = q_seg[:nq * q_rows].reshape(nq, q_rows)
    qr = q_rank[:nq * q_rows].reshape(nq, q_rows)
    ks, kp = k_seg[:nk * kv_rows].reshape(nk, kv_rows), k_pos[:nk * kv_rows].reshape(nk, kv_rows)
    full = ((ks[None, :, 0] >= 0) & (ks[None, :, 0] == ks[None, :, -1])
            & (qs[:, :1] == ks[None, :, 0]) & (qs[:, -1:] == ks[None, :, 0]))
    wr = 0 if causal else int(window[1])
    if wr >= 0:
        full = full & (kp[None, :, -1] <= qr[:, :1] + wr)
    return full


def _dkdv_full_blocks(meta, causal: bool, window=(-1, -1), *, softcap: float = 0.0,
                      alibi: bool = False):
    """``full [nkb, nqc]``: ``_full_blocks`` for the wgmma dK/dV consumer's
    blocks of 64 KV rows (KV tile b) x 32 Q columns (32 c ..)."""
    return _full_blocks(meta, 32, 64, causal, window, softcap=softcap, alibi=alibi).T


def _interval_schedule(needed):
    """Per-row [lo, hi] bounds of the needed columns (int32); an empty row
    collapses to [0, 0], which the kernel still computes, fully masked."""
    cols = needed.shape[1]
    ids = torch.arange(cols, dtype=torch.int32, device=needed.device)
    lo = torch.where(needed, ids[None, :], cols).amin(dim=1).to(torch.int32)
    hi = torch.where(needed, ids[None, :], -1).amax(dim=1).to(torch.int32)
    hi = hi.clamp_min(0)
    lo = torch.minimum(lo, hi)
    return lo, hi


def _needed_tiles(needed):
    """(tiles [nqb, nkb], count [nqb], order [nqb]), int32 on ``needed``'s
    device, no host sync: row i of ``tiles`` lists the columns
    ``needed[i]`` marks, rising, then ``nkb`` past them; ``count[i]`` is how
    many it marks; ``order`` lists the rows by count, largest first (a
    stable sort). A row that marks none walks nothing."""
    nkb = needed.shape[1]
    ids = torch.arange(nkb, dtype=torch.int32, device=needed.device)
    tiles = torch.sort(torch.where(needed, ids[None, :], nkb), dim=1).values
    count = needed.sum(dim=1, dtype=torch.int32)
    order = torch.argsort(count, descending=True, stable=True).to(torch.int32)
    return tiles.to(torch.int32).contiguous(), count, order


def _call_metadata(cu_q, cu_k, tq: int, tk: int, device):
    """A call's ``_segment_metadata`` on ``device``, padded so that every
    varlen kernel's tiles divide it: query tokens to a multiple of
    DKDV_Q_TILE (128, a multiple of every row tile), keys to a multiple of
    KV_TILE (64: the KV tile of every varlen kernel)."""
    return _segment_metadata(cu_q.to(device), cu_k.to(device), tq, tk,
                             cdiv(max(tq, 1), DKDV_Q_TILE) * DKDV_Q_TILE,
                             cdiv(max(tk, 1), KV_TILE) * KV_TILE)


def _q_tiles(meta, tq: int, bq: int):
    """The metadata with its query side cut to the ``bq``-row tiles that
    cover ``tq`` rows (views, no copy)."""
    n = cdiv(max(tq, 1), bq) * bq
    q_seg, q_rank, k_seg, k_pos = meta
    return q_seg[:n], q_rank[:n], k_seg, k_pos


def _varlen_forward_plain(q, k, v, meta, *, scale, causal, softcap=0.0,
                          window=(-1, -1), alibi=None):
    """The kernel's function in plain PyTorch (fp32 math) on packed q [Tq,
    Hq, D], k [Tk, Hkv, D], v [Tk, Hkv, Dv] and the metadata of
    ``_segment_metadata``: (o [Tq, Hq, Dv] in q.dtype, lse [Hq, Tq] fp32).
    A row with no attended key gives o = 0 and lse = MASK + log(1e-38)."""
    tq, hq, _ = q.shape
    tk, hkv, _ = k.shape
    q_seg, q_rank, k_seg, k_pos = (m.to(q.device) for m in meta)
    q_seg, q_rank, k_seg, k_pos = q_seg[:tq], q_rank[:tq], k_seg[:tk], k_pos[:tk]
    group = hq // hkv
    qh = q.transpose(0, 1).float()
    kh = k.transpose(0, 1).float().repeat_interleave(group, dim=0)
    vh = v.transpose(0, 1).float().repeat_interleave(group, dim=0)
    s = torch.einsum("htd,hsd->hts", qh, kh) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    if alibi is not None:
        dist = (q_rank[:, None] - k_pos[None, :]).abs().float()
        s = s - alibi.float().reshape(hq, 1, 1) * dist
    keep = _varlen_mask(q_seg[:, None], q_rank[:, None], k_seg[None, :], k_pos[None, :],
                        causal, int(window[0]), -1 if causal else int(window[1]))
    s = torch.where(keep, s, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("hts,hsd->htd", p, vh) / torch.where(l == 0.0, torch.ones_like(l), l)
    lse = (m + torch.log(l.clamp_min(1e-38)))[..., 0]
    return o.transpose(0, 1).to(q.dtype), lse


_VARLEN_ARGTYPES = {
    "ffpa_varlen_fwd": [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 6 + [ctypes.c_void_p] * 12
    + [ctypes.c_int] * 10 + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    "ffpa_varlen_fwd_plan": [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                             ctypes.c_int],
    "ffpa_varlen_fwd_attrs": [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2,
}

# The forward kernel (both routes), by the substring of its name (what a
# profiler filter matches).
FWD_KERNELS = ("varlen_fwd_wgmma_kernel<",)


def _varlen_lib() -> ctypes.CDLL:
    lib = _build.load("varlen_fwd")
    for name, argtypes in _VARLEN_ARGTYPES.items():
        fn = getattr(lib, name, None)  # None: a library built from older sources
        if fn is not None and fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def varlen_fwd_kernel_plan(d: int, dv: int) -> FwdPlan:
    """The route and tiling the varlen forward launcher takes at head dims
    (d, dv) (padded to 64-column chunks), read from the library: what
    ``config.varlen_fwd_plan`` mirrors. Needs a card."""
    lib = _varlen_lib()
    out = (ctypes.c_int * 32)()
    err = lib.ffpa_varlen_fwd_plan(cdiv(d, D_CHUNK) * D_CHUNK, cdiv(dv, D_CHUNK) * D_CHUNK, out,
                                   len(out))
    _build.check(lib, err, "varlen forward kernel plan")
    return fwd_plan_from(out)


def varlen_fwd_kernel_attrs(route: str, dtype=torch.bfloat16) -> dict:
    """Registers a thread (at launch, before setmaxnreg) and local (spill)
    bytes of the varlen forward kernel of ``route`` ("wgmma" or
    "wgmma_cluster"), from cudaFuncGetAttributes. Needs a card."""
    lib = _varlen_lib()
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    code = {"wgmma": 1, "wgmma_cluster": 2}[route]
    err = lib.ffpa_varlen_fwd_attrs(code, int(dtype == torch.float16), ctypes.byref(regs),
                                    ctypes.byref(local))
    _build.check(lib, err, "varlen forward kernel attributes")
    return {"registers": regs.value, "local_bytes": local.value}


def _strided_rows(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` [T, H, width'] padded to ``width`` columns, with a unit last
    stride and 16-byte aligned base, row and head strides (what cp.async
    and TMA need); a copy only where ``x`` is not already so."""
    x = _pad_last(x, width)
    ok = (x.stride(2) == 1 and x.stride(0) % 8 == 0 and x.stride(1) % 8 == 0
          and x.data_ptr() % 16 == 0)
    return x if ok else x.contiguous()


def _walk_schedule(meta, tq: int, rows: int, causal: bool, window):
    """The call's one 64 x 64 schedule (``rows`` = 64), on the metadata's
    device with no host sync: (needed, tiles, count, order), ``needed``
    [ceil(Tq / rows), Tk_pad / KV_TILE] of ``_tile_needed`` over the
    metadata cut to ``rows``-row Q tiles, then its ``_needed_tiles``. The
    forward and dQ walk each Q tile's listed KV tiles, the Q tiles in
    ``order``; dK/dV the intervals of ``needed``'s transpose
    (``_dkdv_intervals``). ``window`` is normalized."""
    needed = _tile_needed(*_q_tiles(meta, tq, rows), rows, KV_TILE, causal, int(window[0]),
                          int(window[1]))
    return (needed,) + _needed_tiles(needed)


def _call_walk(meta, tq: int, causal: bool, window):
    """The call's ``_walk_schedule`` at the forward's 64-row Q tiles (both
    routes of every varlen kernel walk 64 x 64 tiles, whatever the head
    dims), which the forward saves for the backward. ``window`` is
    normalized."""
    return _walk_schedule(meta, tq, varlen_fwd_plan(D_CHUNK, D_CHUNK).q_rows, causal, window)


def _varlen_fwd_tiles(meta, tq: int, d_pad: int, dv_pad: int, config: BlockConfig, causal: bool,
                      window, walk=None):
    """(plan, rows, meta, schedule) of a forward launch, on the metadata's
    device with no host sync: the route by head dims (``varlen_fwd_plan``),
    its Q rows (the plan's 64 whatever ``config.block_q`` asks), the
    metadata cut to those rows' tiles, and the lists of ``walk`` (each Q
    tile's needed KV tiles, their count, the Q tiles most needed first;
    ``_call_walk`` computed here when not given). ``window`` is
    normalized."""
    del config  # the JAX API's row tile: both routes walk 64-row Q tiles
    plan = varlen_fwd_plan(d_pad, dv_pad)
    if walk is None:
        walk = _call_walk(meta, tq, causal, window)
    return plan, plan.q_rows, _q_tiles(meta, tq, plan.q_rows), walk[1:]


def _varlen_kernel(q, k, v, meta, schedule, config: BlockConfig, *, scale, causal, softcap,
                   window, alibi):
    """Launch ``csrc/varlen_fwd.cu`` (same contract as
    ``_varlen_forward_plain``) on the route its plan names by head dims (one
    block, or the cluster of two above D512), with the call's metadata and
    ``schedule`` of ``_varlen_fwd_tiles``: the lists (tiles, count, order)
    at 64-row Q tiles. ``config.block_q`` is passed on and not read."""
    check_kernel_inputs("_varlen_forward", q, k, v)
    tq, hq, d = q.shape
    tk, hkv, _ = k.shape
    dv = v.shape[-1]
    d_pad, dv_pad = cdiv(d, D_CHUNK) * D_CHUNK, cdiv(dv, D_CHUNK) * D_CHUNK
    q_, k_, v_ = _strided_rows(q, d_pad), _strided_rows(k, d_pad), _strided_rows(v, dv_pad)
    o = torch.empty((tq, hq, dv_pad), dtype=q.dtype, device=q.device)
    lse = torch.empty((hq, tq), dtype=torch.float32, device=q.device)
    tiles, ntile, order = schedule
    alibi_ptr = None
    if alibi is not None:
        alibi = alibi.to(device=q.device, dtype=torch.float32).contiguous()
        alibi_ptr = alibi.data_ptr()
    q_seg, q_rank, k_seg, k_pos = meta
    if ENV.device_log_level() >= 2:
        plan = varlen_fwd_plan(d_pad, dv_pad)
        logger.info("varlen_fwd launch route=%s grid=(%d,%d) smem=%d D=%d Dv=%d Tq=%d Tk=%d",
                    plan.route, hq * (2 if plan.rank_blocks else 1), tiles.shape[0],
                    plan.smem_bytes, d_pad, dv_pad, tq, tk)
    lib = _varlen_lib()
    with torch.cuda.device(q.device):
        err = lib.ffpa_varlen_fwd(
            q_.data_ptr(), k_.data_ptr(), v_.data_ptr(),
            q_.stride(0), q_.stride(1), k_.stride(0), k_.stride(1), v_.stride(0), v_.stride(1),
            o.data_ptr(), lse.data_ptr(), q_seg.data_ptr(), q_rank.data_ptr(),
            k_seg.data_ptr(), k_pos.data_ptr(), None, None, tiles.data_ptr(), ntile.data_ptr(),
            order.data_ptr(), alibi_ptr, int(q.dtype == torch.float16), config.block_q, hq, hkv,
            tq, tk, tiles.shape[0], k_seg.shape[0] // KV_TILE, d_pad, dv_pad, float(scale),
            float(softcap),
            int(window[0]), 0 if causal else int(window[1]),  # causal is the band's right edge 0
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, err, "varlen_fwd kernel launch")
    _varlen_forward.launches += 1
    return (o if dv_pad == dv else o[..., :dv]), lse


def _varlen_forward(q, k, v, cu_q, cu_k, *, scale, causal, config: Optional[BlockConfig] = None,
                    softcap: float = 0.0, window: tuple = (-1, -1), alibi=None, meta=None,
                    walk=None):
    """Packed varlen forward: (o [Tq, Hq, Dv], lse [Hq, Tq] fp32).

    ``meta`` is the call's ``_call_metadata`` (computed here when not
    given), ``walk`` its ``_call_walk`` (computed here, on the inputs'
    device with no host sync, when not given). CPU tensors run the plain
    version; CUDA tensors launch the kernel, or raise for what it does not
    take."""
    from .dispatch import pick_varlen_config

    tq, _, d = q.shape
    d_pad, dv_pad = cdiv(d, D_CHUNK) * D_CHUNK, cdiv(v.shape[-1], D_CHUNK) * D_CHUNK
    if config is None:
        config = pick_varlen_config(d=d_pad, dv=dv_pad, tq=tq, dtype=q.dtype)
    if meta is None:
        meta = _call_metadata(cu_q, cu_k, tq, k.shape[0], q.device)
    window = (int(window[0]), -1 if causal else int(window[1]))
    if q.device.type == "cpu":
        return _varlen_forward_plain(q, k, v, meta, scale=scale, causal=causal, softcap=softcap,
                                     window=window, alibi=alibi)
    _, _, meta, schedule = _varlen_fwd_tiles(meta, tq, d_pad, dv_pad, config, causal, window,
                                             walk)
    return _varlen_kernel(q, k, v, meta, schedule, config, scale=scale, causal=causal,
                          softcap=softcap, window=window, alibi=alibi)


_varlen_forward.launches = 0


# -- backward ----------------------------------------------------------------


def _varlen_delta(do, o):
    """delta = rowsum(dO * O) [Hq, Tq] in fp32 (a plain reduction)."""
    return (do.float() * o.float()).sum(-1).transpose(0, 1).contiguous()


def _varlen_score_grads_plain(q, k, v, do, lse, delta, meta, *, scale, causal, softcap=0.0,
                              window=(-1, -1), alibi=None):
    """The JAX package's ``_varlen_recompute_ds`` over the whole packing:
    fp32 (p, ds) [Hq, Tq, Tk], ds with softcap's chain factor. ``window`` is
    normalized (its right edge -1 under causal); masked pairs, rows with no
    key among them, give p = 0."""
    tq, hq, _ = q.shape
    tk, hkv, _ = k.shape
    q_seg, q_rank, k_seg, k_pos = (m.to(q.device) for m in meta)
    q_seg, q_rank, k_seg, k_pos = q_seg[:tq], q_rank[:tq], k_seg[:tk], k_pos[:tk]
    group = hq // hkv
    kh = k.transpose(0, 1).float().repeat_interleave(group, dim=0)
    vh = v.transpose(0, 1).float().repeat_interleave(group, dim=0)
    s = torch.einsum("htd,hsd->hts", q.transpose(0, 1).float(), kh) * scale
    cap = None
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
        cap = 1.0 - torch.square(s / softcap)
    if alibi is not None:
        dist = (q_rank[:, None] - k_pos[None, :]).abs().float()
        s = s - alibi.to(s.device).float().reshape(hq, 1, 1) * dist
    keep = _varlen_mask(q_seg[:, None], q_rank[:, None], k_seg[None, :], k_pos[None, :],
                        causal, int(window[0]), int(window[1]))
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    del s, keep
    ds = torch.einsum("htd,hsd->hts", do.transpose(0, 1).float(), vh)
    ds = p * (ds - delta[..., None])
    if cap is not None:
        ds = ds * cap
    return p, ds


def _varlen_dkdv_plain(q, k, v, do, lse, delta, meta, *, scale, **kw):
    """The dK/dV kernel's function in plain PyTorch: (dk [Tk, Hkv, D], dv
    [Tk, Hkv, Dv]) in k's and v's dtypes, the GQA group summed in fp32, with
    the kernel's roundings (P and dS in the input type)."""
    tk, hkv, _ = k.shape
    hq = q.shape[1]
    p, ds = _varlen_score_grads_plain(q, k, v, do, lse, delta, meta, scale=scale, **kw)
    t = q.dtype
    dv = torch.einsum("hts,htd->hsd", p.to(t).float(), do.transpose(0, 1).float())
    del p
    dk = torch.einsum("hts,htd->hsd", ds.to(t).float(), q.transpose(0, 1).float()) * scale
    dk = dk.reshape(hkv, hq // hkv, tk, -1).sum(1)
    dv = dv.reshape(hkv, hq // hkv, tk, -1).sum(1)
    return dk.transpose(0, 1).to(k.dtype), dv.transpose(0, 1).to(v.dtype)


def _varlen_dq_plain(q, k, v, do, lse, delta, meta, *, scale, **kw):
    """The dQ kernel's function in plain PyTorch: dq [Tq, Hq, D] in q's
    dtype, with the kernel's rounding of dS to the input type."""
    group = q.shape[1] // k.shape[1]
    _, ds = _varlen_score_grads_plain(q, k, v, do, lse, delta, meta, scale=scale, **kw)
    kh = k.transpose(0, 1).float().repeat_interleave(group, dim=0)
    dq = torch.einsum("hts,hsd->htd", ds.to(q.dtype).float(), kh) * scale
    return dq.transpose(0, 1).to(q.dtype)


def _varlen_backward_plain(q, k, v, o, lse, do, meta, *, scale, causal, softcap=0.0,
                           window=(-1, -1), alibi=None):
    """The backward's function in plain PyTorch (fp32 math over the packed
    layout): (dq, dk, dv) in the inputs' dtypes from q, k, v, the forward's
    o and lse (sink-inclusive where there are sinks), the cotangent do and
    the metadata of ``_segment_metadata``."""
    window = (int(window[0]), -1 if causal else int(window[1]))
    kw = dict(scale=scale, causal=causal, softcap=softcap, window=window, alibi=alibi)
    delta = _varlen_delta(do, o)
    dk, dv = _varlen_dkdv_plain(q, k, v, do, lse, delta, meta, **kw)
    return _varlen_dq_plain(q, k, v, do, lse, delta, meta, **kw), dk, dv


def _dkdv_intervals(needed):
    """The dK/dV kernel's (imin, imax, order) from a ``needed`` matrix at
    its tiles [Q tiles, KV tiles]: each KV tile's interval of Q tiles (the
    matrix transposed), and the KV tiles longest interval first (a stable
    sort on the device)."""
    imin, imax = _interval_schedule(needed.T)
    order = torch.argsort(imax - imin, descending=True, stable=True).to(torch.int32)
    return imin, imax, order


def _backward_schedules(meta, tq: int, dkdv_plan: DkdvPlan, dq_plan: DqPlan, causal: bool,
                        window, walk=None):
    """(dK/dV schedule, dQ schedule) of a backward launch, on the
    metadata's device with no host sync, from one 64 x 64 walk at every
    width (both routes of both kernels walk 64 x 64 tiles): the forward's
    ``walk`` (``_call_walk``, which the forward saves) or, where none is
    given (a direct call), ``_walk_schedule`` computed here. dQ takes its
    lists (tiles, count, order) as they are,
    dK/dV the ``_dkdv_intervals`` of its needed matrix. That matrix has
    ceil(Tq / 64) rows where ``_tile_needed`` over the call's metadata
    (padded to 128 query rows) has one more when ceil(Tq / 64) is odd; that
    tile holds only rows past Tq, whose segment id -1 matches no key, so
    its row is all False and the intervals are the same. ``window`` is
    normalized."""
    assert (dkdv_plan.q_rows, dkdv_plan.kv_rows) == (dq_plan.q_rows, dq_plan.kv_rows)
    assert dq_plan.kv_rows == KV_TILE
    if walk is None:
        walk = _walk_schedule(meta, tq, dq_plan.q_rows, causal, window)
    return _dkdv_intervals(walk[0]), walk[1:]


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_VARLEN_BWD_ARGTYPES = {
    "ffpa_varlen_bwd_dkdv": [_P] * 4 + [_LL] * 8 + [_P] * 12 + [_I] * 9 + [_F] * 2 + [_I] * 3
    + [_P],
    "ffpa_varlen_bwd_dkdv_plan": [_I, _I, ctypes.POINTER(ctypes.c_int), _I, _I],
    "ffpa_varlen_bwd_dkdv_attrs": [_I] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2,
    "ffpa_varlen_bwd_dq": [_P] * 4 + [_LL] * 8 + [_P] * 11 + [_I] * 9 + [_F] * 2 + [_I] * 3
    + [_P],
    "ffpa_varlen_bwd_dq_plan": [_I, _I, ctypes.POINTER(ctypes.c_int), _I, _I],
    "ffpa_varlen_bwd_dq_attrs": [_I] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2,
}


# The dK/dV kernel and the dQ kernel (both routes of each), by the
# substrings of their names (what a profiler filter matches).
DKDV_KERNELS = ("varlen_dkdv_wgmma_kernel<",)
DQ_KERNELS = ("varlen_dq_wgmma_kernel<",)


def _varlen_bwd_lib() -> ctypes.CDLL:
    lib = _build.load("varlen_bwd")
    for name, argtypes in _VARLEN_BWD_ARGTYPES.items():
        fn = getattr(lib, name, None)  # None: a library built from older sources
        if fn is not None and fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def varlen_dkdv_kernel_plan(d: int, dv: int, ring_cap: int = 0) -> DkdvPlan:
    """The route and tiling the varlen dK/dV launcher takes at head dims
    (d, dv) (padded to 64-column chunks) and ``ring_cap``, read from the
    library: what ``config.varlen_dkdv_plan`` mirrors. Needs a card."""
    lib = _varlen_bwd_lib()
    out = (ctypes.c_int * 64)()
    err = lib.ffpa_varlen_bwd_dkdv_plan(cdiv(d, D_CHUNK) * D_CHUNK, cdiv(dv, D_CHUNK) * D_CHUNK,
                                        out, len(out), int(ring_cap))
    _build.check(lib, err, "varlen dkdv kernel plan")
    return dkdv_plan_from(out)


def varlen_dkdv_kernel_attrs(route: str, dtype=torch.bfloat16) -> dict:
    """Registers a thread (at launch, before setmaxnreg) and local (spill)
    bytes of the varlen dK/dV kernel of ``route`` ("wgmma" or
    "wgmma_cluster"), from cudaFuncGetAttributes. Needs a card."""
    lib = _varlen_bwd_lib()
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    code = {"wgmma": 1, "wgmma_cluster": 2}[route]
    err = lib.ffpa_varlen_bwd_dkdv_attrs(code, int(dtype == torch.float16), ctypes.byref(regs),
                                         ctypes.byref(local))
    _build.check(lib, err, "varlen dkdv kernel attributes")
    return {"registers": regs.value, "local_bytes": local.value}


def varlen_dq_kernel_plan(d: int, dv: int, ring_cap: int = 0) -> DqPlan:
    """The route and tiling the varlen dQ launcher takes at head dims (d,
    dv) (padded to 64-column chunks) and ``ring_cap``, read from the
    library: what ``config.varlen_dq_plan`` mirrors. Needs a card."""
    lib = _varlen_bwd_lib()
    out = (ctypes.c_int * 32)()
    err = lib.ffpa_varlen_bwd_dq_plan(cdiv(d, D_CHUNK) * D_CHUNK, cdiv(dv, D_CHUNK) * D_CHUNK,
                                      out, len(out), int(ring_cap))
    _build.check(lib, err, "varlen dq kernel plan")
    return dq_plan_from(out)


def varlen_dq_kernel_attrs(route: str, dtype=torch.bfloat16) -> dict:
    """Registers a thread (at launch, before setmaxnreg) and local (spill)
    bytes of the varlen dQ kernel of ``route`` ("wgmma" or
    "wgmma_cluster"), from cudaFuncGetAttributes. Needs a card."""
    lib = _varlen_bwd_lib()
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    code = {"wgmma": 1, "wgmma_cluster": 2}[route]
    err = lib.ffpa_varlen_bwd_dq_attrs(code, int(dtype == torch.float16), ctypes.byref(regs),
                                       ctypes.byref(local))
    _build.check(lib, err, "varlen dq kernel attributes")
    return {"registers": regs.value, "local_bytes": local.value}


class _BwdOperands:
    """The backward kernels' inputs: q, k, v, dO padded to 64-column heads
    and read through their row and head strides, their strides in the C
    entry points' order, fp32 lse and delta [Hq, Tq], fp32 ALiBi slopes."""

    def __init__(self, q, k, v, do, lse, delta, alibi):
        check_kernel_inputs("_varlen_backward", q, k, v)
        self.d, self.dv = q.shape[-1], v.shape[-1]
        self.d_pad = cdiv(self.d, D_CHUNK) * D_CHUNK
        self.dv_pad = cdiv(self.dv, D_CHUNK) * D_CHUNK
        self.q, self.k = _strided_rows(q, self.d_pad), _strided_rows(k, self.d_pad)
        self.v = _strided_rows(v, self.dv_pad)
        self.do = _strided_rows(do.to(q.dtype), self.dv_pad)  # an expanded dO is copied
        self.lse, self.delta = lse.float().contiguous(), delta.float().contiguous()
        self.alibi = (None if alibi is None
                      else alibi.to(device=q.device, dtype=torch.float32).contiguous())

    def head(self) -> list:
        """q, k, v, dO pointers, their eight strides, lse and delta."""
        ts = (self.q, self.k, self.v, self.do)
        return ([t.data_ptr() for t in ts] + [s for t in ts for s in (t.stride(0), t.stride(1))]
                + [self.lse.data_ptr(), self.delta.data_ptr()])


def _varlen_dkdv_kernel(ops: _BwdOperands, meta, schedule, config: BlockConfig, *, scale,
                        causal, softcap, window):
    """Launch the dK/dV kernel of ``csrc/varlen_bwd.cu``: (dk, dv) packed
    in the input type (same contract as ``_varlen_dkdv_plain``). The
    route is the library's by head dims (``config.varlen_dkdv_plan``: one
    block, or the cluster of two above D512); ``schedule`` is
    ``_backward_schedules``' dK/dV part at its 64 x 64 tiles,
    ``config.dkdv_col_passes`` its passes and ``config.bwd_ring_cap`` the
    ring's cap (``config.ring_depth``)."""
    tq, hq = ops.q.shape[0], ops.q.shape[1]
    tk, hkv = ops.k.shape[0], ops.k.shape[1]
    dk = torch.empty((tk, hkv, ops.d_pad), dtype=ops.q.dtype, device=ops.q.device)
    dv = torch.empty((tk, hkv, ops.dv_pad), dtype=ops.q.dtype, device=ops.q.device)
    imin, imax, order = schedule
    q_seg, q_rank, k_seg, k_pos = meta
    passes = config.dkdv_col_passes
    cap = config.bwd_ring_cap
    ring = (ring_depth(varlen_dkdv_plan(ops.d_pad, ops.dv_pad).stages, cap, DKDV_MIN_STAGES)
            if cap else 0)
    if ENV.device_log_level() >= 2:
        plan = varlen_dkdv_plan(ops.d_pad, ops.dv_pad, ops.q.element_size())
        logger.info("varlen_dkdv launch route=%s grid=(%d,%d) smem=%d D=%d Dv=%d Tq=%d Tk=%d",
                    plan.route, len(plan.d_blocks) * hkv, imin.shape[0], plan.smem_bytes,
                    ops.d_pad, ops.dv_pad, tq, tk)
    lib = _varlen_bwd_lib()
    with torch.cuda.device(ops.q.device):
        err = lib.ffpa_varlen_bwd_dkdv(
            *ops.head(), dk.data_ptr(), dv.data_ptr(), q_seg.data_ptr(), q_rank.data_ptr(),
            k_seg.data_ptr(), k_pos.data_ptr(), imin.data_ptr(), imax.data_ptr(),
            order.data_ptr(), None if ops.alibi is None else ops.alibi.data_ptr(),
            int(ops.q.dtype == torch.float16), hq, hkv, tq, tk, imin.shape[0], ops.d_pad,
            ops.dv_pad, passes, float(scale), float(softcap), int(window[0]),
            0 if causal else int(window[1]),  # causal is the band's right edge 0
            ring, torch.cuda.current_stream(ops.q.device).cuda_stream,
        )
    _build.check(lib, err, "varlen_dkdv kernel launch")
    _varlen_backward.dkdv_launches += 1
    return dk[..., :ops.d], dv[..., :ops.dv]


def _varlen_dq_kernel(ops: _BwdOperands, meta, schedule, config: Optional[BlockConfig] = None, *,
                      scale, causal, softcap, window):
    """Launch the dQ kernel of ``csrc/varlen_bwd.cu``: dq packed in the
    input type (same contract as ``_varlen_dq_plain``). The route is the
    library's by head dims (``config.varlen_dq_plan``: one block, or the
    cluster of two above D512); ``schedule`` is ``_backward_schedules``'
    dQ part: (tiles, count, order) at 64-row Q tiles; ``config.bwd_ring_cap``
    the ring's cap (``config.ring_depth``; None: the plan's depth)."""
    tq, hq = ops.q.shape[0], ops.q.shape[1]
    tk, hkv = ops.k.shape[0], ops.k.shape[1]
    dq = torch.empty((tq, hq, ops.d_pad), dtype=ops.q.dtype, device=ops.q.device)
    tiles, ntile, order = schedule
    q_seg, q_rank, k_seg, k_pos = meta
    cap = 0 if config is None else config.bwd_ring_cap
    ring = (ring_depth(varlen_dq_plan(ops.d_pad, ops.dv_pad).stages, cap, DQ_MIN_STAGES)
            if cap else 0)
    if ENV.device_log_level() >= 2:
        plan = varlen_dq_plan(ops.d_pad, ops.dv_pad, ops.q.element_size())
        logger.info("varlen_dq launch route=%s grid=(%d,%d) smem=%d D=%d Dv=%d Tq=%d Tk=%d",
                    plan.route, hq * (2 if plan.rank_blocks else 1), tiles.shape[0],
                    plan.smem_bytes, ops.d_pad, ops.dv_pad, tq, tk)
    lib = _varlen_bwd_lib()
    with torch.cuda.device(ops.q.device):
        err = lib.ffpa_varlen_bwd_dq(
            *ops.head(), dq.data_ptr(), q_seg.data_ptr(), q_rank.data_ptr(), k_seg.data_ptr(),
            k_pos.data_ptr(), tiles.data_ptr(), ntile.data_ptr(), order.data_ptr(),
            None if ops.alibi is None else ops.alibi.data_ptr(),
            int(ops.q.dtype == torch.float16), hq, hkv, tq, tk, tiles.shape[0],
            k_seg.shape[0] // KV_TILE, ops.d_pad, ops.dv_pad, float(scale), float(softcap),
            int(window[0]), 0 if causal else int(window[1]),  # causal is the band's right edge 0
            ring, torch.cuda.current_stream(ops.q.device).cuda_stream,
        )
    _build.check(lib, err, "varlen_dq kernel launch")
    _varlen_backward.dq_launches += 1
    return dq[..., :ops.d]


def _varlen_backward(q, k, v, o, lse, do, meta, *, scale, causal, softcap: float = 0.0,
                     config: Optional[BlockConfig] = None,
                     window: tuple = (-1, -1), alibi=None, walk=None):
    """Packed varlen backward: (dq [Tq, Hq, D], dk [Tk, Hkv, D], dv [Tk,
    Hkv, Dv]) in the inputs' dtypes, from the forward's o and lse
    (sink-inclusive where there are sinks) and the cotangent ``do``;
    ``meta`` is the call's ``_call_metadata`` and ``walk`` its
    ``_call_walk`` as the forward saved it (None: computed here).

    CPU tensors run the plain version. CUDA tensors compute delta and both
    tile schedules on the device (``_backward_schedules``: no host sync,
    both from ``walk`` or one walk computed there) and launch
    the dK/dV kernel then the dQ kernel, counted in ``dkdv_launches`` and
    ``dq_launches``, or raise for what they do not take. ``config`` is the
    pair's tiles and ring cap (None: ``pick_varlen_backward_config``, with
    the tuned store's entry for the packed totals)."""
    from .dispatch import pick_varlen_backward_config

    window = (int(window[0]), -1 if causal else int(window[1]))
    kw = dict(scale=scale, causal=causal, softcap=softcap, window=window)
    if q.device.type == "cpu":
        return _varlen_backward_plain(q, k, v, o, lse, do, meta, alibi=alibi, **kw)
    ops = _BwdOperands(q, k, v, do, lse, _varlen_delta(do, o), alibi)
    if config is None:
        config = pick_varlen_backward_config(d=ops.d_pad, dv=ops.dv_pad, dtype=q.dtype,
                                             tq=q.shape[0], tk=k.shape[0])
    dkdv_sched, dq_sched = _backward_schedules(
        meta, q.shape[0], varlen_dkdv_plan(ops.d_pad, ops.dv_pad, q.element_size()),
        varlen_dq_plan(ops.d_pad, ops.dv_pad, q.element_size()), causal, window, walk)
    dk, dv = _varlen_dkdv_kernel(ops, meta, dkdv_sched, config, **kw)
    dq = _varlen_dq_kernel(ops, meta, dq_sched, config, **kw)
    return dq, dk, dv


_varlen_backward.dkdv_launches = 0
_varlen_backward.dq_launches = 0


def _varlen_apply_sinks(o, lse, sinks):
    """Sink-inclusive rescale of o [T, H, Dv] with lse [H, T]."""
    from .attention import apply_sinks

    o_h, lse_s = apply_sinks(o.transpose(0, 1), lse, sinks, head_axis=0)
    return o_h.transpose(0, 1), lse_s


class _VarlenCore(torch.autograd.Function):
    """The varlen core op (the JAX package's ``_varlen_core`` custom_vjp).

    The forward computes the call's metadata and its one tile schedule
    (``_call_walk``) once, runs ``_varlen_forward`` on them and applies
    sinks; it saves q, k, v, the
    sink-inclusive o and lse, the metadata and the schedule. The backward
    runs ``_varlen_backward`` on the saved metadata and schedule (the
    kernels are exact under sink-inclusive residuals), the sinks'
    closed-form gradient and a zero gradient for ALiBi slopes; the lse
    cotangent is ignored."""

    @staticmethod
    def forward(ctx, scale, causal, config, softcap, window, q, k, v, cu_q, cu_k, alibi, sinks):
        meta = _call_metadata(cu_q, cu_k, q.shape[0], k.shape[0], q.device)
        wnorm = (int(window[0]), -1 if causal else int(window[1]))
        walk = _call_walk(meta, q.shape[0], causal, wnorm)
        o, lse = _varlen_forward(q, k, v, cu_q, cu_k, scale=scale, causal=causal, config=config,
                                 softcap=softcap, window=window, alibi=alibi, meta=meta,
                                 walk=walk)
        if sinks is not None:
            o, lse = _varlen_apply_sinks(o, lse, sinks)
        ctx.save_for_backward(q, k, v, o, lse, *meta, alibi, sinks, *walk)
        ctx.static = dict(scale=scale, causal=causal, softcap=softcap, window=window)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        del dlse  # lse is a non-differentiable output
        q, k, v, o, lse, *rest = ctx.saved_tensors
        meta, (alibi, sinks), walk = rest[:4], rest[4:6], rest[6:]
        dq, dk, dv = _varlen_backward(q, k, v, o, lse, do, tuple(meta), alibi=alibi,
                                      walk=tuple(walk), **ctx.static)
        dsinks = None
        if sinks is not None:
            from .attention import sink_grad

            dsinks = sink_grad(do.transpose(0, 1), o.transpose(0, 1), lse, sinks, head_axis=0)
        dalibi = None if alibi is None else torch.zeros_like(alibi)
        return None, None, None, None, None, dq, dk, dv, None, None, dalibi, dsinks


def _varlen_block_config(block_q, block_kv, d, dv, tq, dtype) -> Optional[BlockConfig]:
    """The kernel's tiles for explicit ``block_q`` / ``block_kv`` (None:
    ``pick_varlen_config``). The KV tile is the compiled KV_TILE, the row
    tile one of FWD_ROW_TILES that fits; the tuned store has no forward
    knob to set here (the ring is fixed at compile time)."""
    if block_kv is not None and block_kv != KV_TILE:
        raise ValueError(f"varlen block_kv must be {KV_TILE} (the compiled KV tile), "
                         f"got {block_kv}")
    if block_q is None:
        return None
    if block_q not in FWD_ROW_TILES:
        raise ValueError(f"varlen block_q must be one of {FWD_ROW_TILES}, got {block_q}")
    cfg = BlockConfig(block_q=block_q)
    itemsize = torch.empty((), dtype=dtype).element_size()
    if not varlen_fits(cfg, cdiv(d, D_CHUNK) * D_CHUNK, cdiv(dv, D_CHUNK) * D_CHUNK, itemsize):
        raise ValueError(f"varlen block_q={block_q} does not fit D={d}, Dv={dv}")
    return cfg


def ffpa_varlen_attention(
    q,
    k,
    v,
    cu_seqlens_q,
    cu_seqlens_k,
    max_seqlen_q: int,
    max_seqlen_k: int,
    *,
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    enable_gqa: bool = False,
    return_lse: bool = False,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
    softcap: float = 0.0,
    window_size=(-1, -1),
    alibi_slopes=None,
    sinks=None,
    **kwargs,
):
    """Packed-THD varlen attention. See ``interface.ffpa_attn_varlen_func``.

    The JAX package's checks and error taxonomy. fp16 runs natively (no
    round trip through bf16)."""
    del max_seqlen_q, max_seqlen_k  # the metadata carries the segment lengths
    _check_supported_options(dict(kwargs))
    softcap = float(softcap or 0.0)
    if softcap < 0.0:
        raise ValueError(f"softcap must be >= 0, got {softcap}")
    if isinstance(window_size, int):
        window_size = (window_size, window_size)
    window_size = (int(window_size[0]), int(window_size[1]))
    if window_size[0] < -1 or window_size[1] < -1:
        raise ValueError(f"window_size entries must be >= -1, got {window_size}")
    if alibi_slopes is not None:
        alibi_slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32, device=q.device)
        if tuple(alibi_slopes.shape) != (q.shape[1],):
            raise ValueError(
                f"varlen alibi_slopes must have shape ({q.shape[1]},), got "
                f"{tuple(alibi_slopes.shape)}"
            )
    if sinks is not None:
        sinks = torch.as_tensor(sinks, dtype=torch.float32, device=q.device)
        if tuple(sinks.shape) != (q.shape[1],):
            raise ValueError(f"sinks must have shape ({q.shape[1]},), got {tuple(sinks.shape)}")
    if dropout_p != 0.0:
        raise NotImplementedError("ffpa_attn_varlen_func does not support dropout_p > 0")
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError(
            f"varlen inputs must be packed [T, H, D]; got q={tuple(q.shape)}, "
            f"k={tuple(k.shape)}, v={tuple(v.shape)}"
        )
    if q.dtype not in (torch.float16, torch.bfloat16):
        raise TypeError(f"dtype must be fp16/bf16, got {q.dtype}")
    if cu_seqlens_q.dtype != torch.int32:
        raise TypeError(f"cu_seqlens_q must be int32, got {cu_seqlens_q.dtype}")
    if cu_seqlens_k is None:
        cu_seqlens_k = cu_seqlens_q
    if cu_seqlens_k.dtype != torch.int32:
        raise TypeError(f"cu_seqlens_k must be int32, got {cu_seqlens_k.dtype}")
    tq, hq, d = q.shape
    tk, hkv, dk_ = k.shape
    if dk_ != d:
        raise ValueError(f"q/k head_dim mismatch: {d} vs {dk_}")
    if v.shape[0] != tk or v.shape[1] != hkv:
        raise ValueError(f"k/v shape mismatch: k={tuple(k.shape)}, v={tuple(v.shape)}")
    if hq != hkv and not enable_gqa:
        raise ValueError(f"H_q ({hq}) != H_kv ({hkv}) requires enable_gqa=True")
    if hq % hkv != 0:
        raise ValueError(f"GQA requires H_q % H_kv == 0, got {hq} % {hkv}")
    if softmax_scale is None:
        softmax_scale = 1.0 / (d ** 0.5)
    config = _varlen_block_config(block_q, block_kv, d, v.shape[-1], tq, q.dtype)
    out, lse = _VarlenCore.apply(
        float(softmax_scale), bool(causal), config, softcap, window_size, q, k, v,
        cu_seqlens_q, cu_seqlens_k, alibi_slopes, sinks,
    )
    if return_lse:
        return out, lse
    return out


__all__ = [
    "ffpa_varlen_attention",
    "_segment_metadata",
    "_varlen_mask",
    "_tile_needed",
    "_interval_schedule",
    "_varlen_forward",
    "_varlen_forward_plain",
    "_varlen_backward",
    "_varlen_backward_plain",
]
