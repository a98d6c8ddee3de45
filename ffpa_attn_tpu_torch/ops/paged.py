"""Paged decode attention over KV page pools: the CUDA kernel
``csrc/paged_decode.cu``, its plain PyTorch version, and the pools and their
host-side management.

Replaces the Pallas ``_paged_decode_kernel`` of ``ffpa_attn_tpu/ops/paged.py``
(launched by its ``paged_decode_attention``).

K/V live in a global pool of pages ``[num_pages, Hkv, page_size, Dh]``
owned by ``PagedKVCache``, with a per-sequence page table and ``lens``;
page 0 is a reserved null page. Where the JAX package returns a new pytree
(``append_token``, ``fill_from_prefill``, ``fill_slot``,
``assign_sequence``), the port writes the pools in place and returns the same
cache, so call sites read the same. int8 pools carry per-row fp32 scales
(symmetric amax / 127, rounded half to even as ``jnp.round`` does), so
they are bit-equal to the JAX package's.

Bound on an H100: bytes. A decode step reads each sequence's ``lens[b]``
cached rows of K and V once per KV head, ``sum_b lens[b] * Hkv * (D + Dv)``
elements (plus the fp32 row scales of an int8 pool): 24 MB per layer at the
serving shape (B4, lens ~600..1000, Hkv4, D512, bf16), 7 us at 3.35 TB/s.

Design against that bound: the TPU walks one sequence's pages in order on a
(B, Hkv, max_pages) grid, 16 blocks at the serving shape; the kernel splits
each sequence's page walk over blocks (their count from the SM count, the
plan's blocks an SM and the pool's capacity, so no host sync reads
``lens``) and merges the splits by LSE with the dense decode's merge
launch. One TMA + wgmma block takes every shape (``config.paged_plan``:
head dims up to 1024, pages of any size): each block cuts its split from
its sequence's length on the device (``paged_split_ranges`` is the rule),
so every block of a live sequence streams about the same bytes, and keeps
a ring of TMA boxes in flight, one page-table read per box. PackGQA rows
stream each KV head's pages once; an int8 pool halves the bytes, its
scales folded into S and P.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..env import ENV, resolve_device
from ..logger import init_logger
from . import _build
from .config import D_CHUNK, KV_TILE, PagedPlan, cdiv, paged_plan
from .reference import DEFAULT_MASK_VALUE

logger = init_logger(__name__)

_PAGED_MAX_NQ = 8


@dataclass
class PagedKVCache:
    """Global page pool + per-sequence page tables.

    ``k_pages`` / ``v_pages``: [num_pages, Hkv, page_size, Dh]. Page 0 is a
    reserved null page (unused table entries point at it, so the kernel
    never reads out of bounds). ``page_table``: [B, max_pages] int32 pool
    page ids. ``lens``: [B] int32 tokens stored per sequence. int8 pools
    carry per-row fp32 dequant scales [num_pages, Hkv, page_size]
    (``k_scales`` / ``v_scales``; None for bf16/f16 pools)."""

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    page_table: torch.Tensor
    lens: torch.Tensor
    k_scales: Optional[torch.Tensor] = None
    v_scales: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scales is not None

    @staticmethod
    def alloc(
        batch: int,
        max_len: int,
        n_kv_heads: int,
        head_dim: int,
        page_size: int = 128,
        dtype=torch.bfloat16,
        extra_pages: int = 0,
        quantized: bool = False,
        device=None,
    ) -> "PagedKVCache":
        """Pool sized for ``batch`` sequences of up to ``max_len`` tokens,
        pages pre-assigned contiguously per sequence (page 0 reserved), on
        ``device`` (CUDA unless the caller asks for another)."""
        dev = resolve_device(device)
        max_pages = cdiv(max_len, page_size)
        num_pages = 1 + batch * max_pages + extra_pages
        shape = (num_pages, n_kv_heads, page_size, head_dim)
        table = 1 + torch.arange(batch * max_pages, dtype=torch.int32, device=dev).reshape(
            batch, max_pages)
        scales = None
        pool_dtype = dtype
        if quantized:
            pool_dtype, scales = torch.int8, torch.zeros(shape[:3], dtype=torch.float32,
                                                         device=dev)
        return PagedKVCache(
            k_pages=torch.zeros(shape, dtype=pool_dtype, device=dev),
            v_pages=torch.zeros(shape, dtype=pool_dtype, device=dev),
            page_table=table,
            lens=torch.zeros((batch,), dtype=torch.int32, device=dev),
            k_scales=scales,
            v_scales=None if scales is None else scales.clone(),
        )


def _quantize_rows(x):
    """Symmetric per-row int8: x [..., rows, D] -> (int8 values, fp32
    scales [..., rows]). Zero rows get scale 1 (stored zeros). Rounds half
    to even, as ``jnp.round``."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scl = torch.where(amax > 0, amax / 127.0, 1.0)
    return torch.round(xf / scl[..., None]).to(torch.int8), scl


def append_token(cache: PagedKVCache, k_new, v_new) -> PagedKVCache:
    """Append one token's K/V per sequence (``k_new`` / ``v_new`` [B, Hkv,
    1, Dh]) in place; returns the cache.

    A full sequence (``lens[b] == max_pages * page_size``) drops the
    append: the write goes to the reserved null page and its len freezes at
    capacity, as in the JAX package. Everything stays on the device."""
    page = cache.page_size
    max_pages = cache.page_table.shape[1]
    cap = max_pages * page
    pos = cache.lens.long()
    in_range = pos < cap
    slot_page = torch.gather(cache.page_table, 1,
                             (pos // page).clamp(0, max_pages - 1)[:, None])[:, 0].long()
    page_ids = torch.where(in_range, slot_page, 0)  # the null page soaks overflow
    rows = torch.where(in_range, pos % page, 0)
    k_row, v_row = k_new[:, :, 0], v_new[:, :, 0]
    if cache.quantized:
        k_row, k_scl = _quantize_rows(k_row)  # [B, Hkv, Dh] -> + [B, Hkv]
        v_row, v_scl = _quantize_rows(v_row)
        cache.k_scales[page_ids, :, rows] = k_scl
        cache.v_scales[page_ids, :, rows] = v_scl
    cache.k_pages[page_ids, :, rows] = k_row.to(cache.k_pages.dtype)
    cache.v_pages[page_ids, :, rows] = v_row.to(cache.v_pages.dtype)
    cache.lens.add_(1).clamp_(max=cap)
    return cache


def _store_pages(cache: PagedKVCache, ids, k_chunks, v_chunks) -> None:
    """Write page-shaped chunks [n, Hkv, page, Dh] into pool pages ``ids``
    (quantized per row for an int8 pool)."""
    for pages, scales, chunks in ((cache.k_pages, cache.k_scales, k_chunks),
                                  (cache.v_pages, cache.v_scales, v_chunks)):
        if scales is not None:
            chunks, scl = _quantize_rows(chunks)
            scales[ids] = scl
        pages[ids] = chunks.to(pages.dtype)


def fill_from_prefill(cache: PagedKVCache, k_dense, v_dense, lens) -> PagedKVCache:
    """Load a prefill's dense K/V ([B, Hkv, Np, Dh], ragged via ``lens``)
    into the pool in one shot, walking the page table (entries may be any
    pool pages). Rows beyond ``lens[b]`` are written too: they are masked
    and past the walk, so unreachable."""
    b, hkv, np_, dh = k_dense.shape
    page = cache.page_size
    max_pages = cache.page_table.shape[1]
    pad = cdiv(np_, page) * page
    n_seq_pages = pad // page
    assert n_seq_pages <= max_pages, (np_, page, max_pages)
    ids = cache.page_table[:, :n_seq_pages].reshape(-1).long()

    def chunks(dense):  # [B, Hkv, Np, Dh] -> [B * n_seq_pages, Hkv, page, Dh]
        d5 = F.pad(dense, (0, 0, 0, pad - np_)).reshape(b, hkv, n_seq_pages, page, dh)
        return d5.transpose(1, 2).reshape(b * n_seq_pages, hkv, page, dh)

    _store_pages(cache, ids, chunks(k_dense), chunks(v_dense))
    cache.lens.copy_(torch.as_tensor(lens, dtype=torch.int32))
    return cache


def fill_slot(cache: PagedKVCache, slot: int, k_dense, v_dense, length) -> PagedKVCache:
    """Load one sequence's dense K/V ([Hkv, Np, Dh]) into batch slot
    ``slot``'s pages and set its length: the per-sequence half of admission
    (``PageAllocator.acquire`` + ``assign_sequence`` gave the slot its
    pages)."""
    hkv, np_, dh = k_dense.shape
    page = cache.page_size
    max_pages = cache.page_table.shape[1]
    pad = cdiv(max(np_, 1), page) * page
    n_seq_pages = pad // page
    assert n_seq_pages <= max_pages, (np_, page, max_pages)
    ids = cache.page_table[slot, :n_seq_pages].long()

    def chunks(dense):  # [Hkv, Np, Dh] -> [n_seq_pages, Hkv, page, Dh]
        d4 = F.pad(dense, (0, 0, 0, pad - np_)).reshape(hkv, n_seq_pages, page, dh)
        return d4.transpose(0, 1)

    _store_pages(cache, ids, chunks(k_dense), chunks(v_dense))
    cache.lens[slot] = int(length)
    return cache


def _dense_rows(pool, table):
    """[P, Hkv, page, ...] pool rows of each sequence in cache order:
    [B, Hkv, max_pages * page, ...]."""
    g = pool[table.long()]  # [B, max_pages, Hkv, page, ...]
    b, mp, hkv, page = g.shape[:4]
    return g.transpose(1, 2).reshape(b, hkv, mp * page, *g.shape[4:])


def _paged_decode_plain(qp, cache: PagedKVCache, *, nq, scale, softcap, window_left):
    """The kernel's function in plain PyTorch (fp32 math) on packed rows qp
    [B, Hkv, R, D] (row r at query position r % nq): (o [B, Hkv, R, Dv] in
    qp.dtype, lse [B, Hkv, R] fp32). Row r of sequence b attends cached
    positions < lens[b] - (nq - 1) + r % nq (with a window, those >= that
    limit - 1 - window_left); a row that attends nothing gives o = 0 and
    lse = -inf."""
    rows = qp.shape[2]
    k = _dense_rows(cache.k_pages, cache.page_table).float()
    v = _dense_rows(cache.v_pages, cache.page_table).float()
    s = torch.einsum("bhrd,bhkd->bhrk", qp.float(), k) * scale
    if cache.quantized:
        s = s * _dense_rows(cache.k_scales, cache.page_table)[:, :, None, :]
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    cols = torch.arange(k.shape[2], device=qp.device)
    qpos = torch.arange(rows, device=qp.device) % nq
    limit = (cache.lens.long()[:, None, None, None] - (nq - 1) + qpos[None, None, :, None])
    keep = cols < limit
    if window_left >= 0:
        keep = keep & (cols >= limit - 1 - window_left)
    s = torch.where(keep, s, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if cache.quantized:
        p = p * _dense_rows(cache.v_scales, cache.page_table)[:, :, None, :]
    o = torch.einsum("bhrk,bhkd->bhrd", p, v) / torch.where(l == 0.0, torch.ones_like(l), l)
    lse = torch.where(l == 0.0, float("-inf"), m + torch.log(l.clamp_min(1e-38)))[..., 0]
    return o.to(qp.dtype), lse


def _tma_splits(blocks_per_split: int, kv_tiles: int, num_sms: int, plan: PagedPlan,
                quantized: bool) -> int:
    """KV splits of the launch: as many as keep every block of the launch
    resident at once, and no more than the capacity's tiles. Over bf16 /
    f16 pools a stage costs its consumers only bytes, so one block an SM
    (fewer splits to merge); over int8 pools the consumers widen every
    stage, so as many as the plan holds an SM (two below D512: twice the
    warps on that work). Each block cuts its share of the live range on
    the device, so the count need not divide the capacity."""
    per_sm = plan.blocks_per_sm if quantized else 1
    return max(1, min(kv_tiles, per_sm * num_sms // max(blocks_per_split, 1)))


def paged_split_ranges(lens, num_splits: int, *, nq: int = 1, window_left: int = -1,
                       capacity: Optional[int] = None):
    """The cache rows each split of the TMA route walks, per sequence: a
    list of ``num_splits`` [lo, hi) pairs for each of ``lens``. The live
    range [first, lens[b]) (first: the window's first position, that of
    the earliest of the nq rows, rounded down to a KV tile; else 0) is cut
    into ``num_splits`` near-equal runs of whole tiles, the last cut at
    ``lens[b]``; a split with no tile is (x, x). The kernel computes the
    same on the device (``csrc/paged_decode.cu`` ``tma::range_of``); this
    copy is for the tests and runs on no path."""
    out = []
    for n in lens:
        n = int(n) if capacity is None else min(int(n), capacity)
        first = 0 if window_left < 0 else (max(0, n - nq - window_left) // KV_TILE) * KV_TILE
        live = cdiv(n - first, KV_TILE) if n > first else 0
        cuts = [first + (s * live // num_splits) * KV_TILE for s in range(num_splits + 1)]
        out.append([(min(lo, n), min(hi, n)) for lo, hi in zip(cuts, cuts[1:])])
    return out


_I, _P = ctypes.c_int, ctypes.c_void_p
_ARGTYPES = {
    "ffpa_paged_decode": [_P] * 11 + [_I] * 11 + [ctypes.c_float] * 2 + [_I] * 2 + [_P],
    "ffpa_paged_plan": [_I] * 4 + [ctypes.POINTER(_I), _I],
    "ffpa_paged_attrs": [_I] * 3 + [ctypes.POINTER(_I)] * 2,
}


def _paged_fn(name: str):
    """Entry point ``name`` of the paged decode library, its argument types
    set at first use."""
    fn = getattr(_build.load("paged_decode"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check(err: int, what: str) -> None:
    _build.check(_build.load("paged_decode"), err, what)


def paged_kernel_plan(d: int, dv: int, page: int, quantized: bool = False) -> PagedPlan:
    """The tiling the launcher takes at head dims (d, dv) (padded to
    64-column chunks) over pages of ``page`` rows, read from the library:
    what ``config.paged_plan`` mirrors. Needs a card."""
    out = (ctypes.c_int * 8)()
    err = _paged_fn("ffpa_paged_plan")(cdiv(d, D_CHUNK) * D_CHUNK, cdiv(dv, D_CHUNK) * D_CHUNK,
                                       page, int(quantized), out, len(out))
    _check(err, "paged decode plan")
    if out[0] != 1:
        raise RuntimeError(f"paged decode plan: unknown route {out[0]}")
    return PagedPlan("tma", *out[1:7])


def paged_kernel_attrs(dtype=torch.bfloat16, quantized: bool = False,
                       consumers: int = 1) -> dict:
    """Registers a thread and local (spill) bytes of the paged decode
    kernel with ``consumers`` warpgroups (1: D, Dv <= 512; 2: wider), from
    cudaFuncGetAttributes. Needs a card."""
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    err = _paged_fn("ffpa_paged_attrs")(int(consumers), int(dtype == torch.float16),
                                        int(quantized), ctypes.byref(regs), ctypes.byref(local))
    _check(err, "paged decode kernel attributes")
    return {"registers": regs.value, "local_bytes": local.value}


def _paged_decode_kernel(qp, cache: PagedKVCache, *, nq, scale, softcap, window_left):
    """Launch ``csrc/paged_decode.cu`` and its merge (same contract as
    ``_paged_decode_plain``) on the tiling ``config.paged_plan`` names."""
    if qp.device.type != "cuda":
        raise ValueError("paged_decode_attention: the kernel takes CUDA tensors")
    if qp.dtype not in (torch.bfloat16, torch.float16):
        raise TypeError(f"paged_decode_attention: kernel dtype must be bf16 or f16, got {qp.dtype}")
    pool_dtype = torch.int8 if cache.quantized else qp.dtype
    for t in (cache.k_pages, cache.v_pages, cache.page_table, cache.lens):
        if t.device != qp.device:
            raise ValueError("paged_decode_attention: q and the cache must share a device")
    if cache.k_pages.dtype != pool_dtype or cache.v_pages.dtype != pool_dtype:
        raise TypeError(f"paged_decode_attention: pools must be {pool_dtype} for {qp.dtype} q")
    if cache.page_table.dtype != torch.int32 or cache.lens.dtype != torch.int32:
        raise TypeError("paged_decode_attention: page_table and lens must be int32")
    b, hkv, rows, d = qp.shape
    dv, page = cache.v_pages.shape[-1], cache.page_size
    if d % D_CHUNK or dv % D_CHUNK:
        raise ValueError(f"paged_decode_attention: the kernel takes head dims that are "
                         f"multiples of {D_CHUNK}, got D={d}, Dv={dv}")
    max_pages = cache.page_table.shape[1]
    plan = paged_plan(d, dv, page, cache.quantized)
    row_blocks = cdiv(rows, plan.rows)
    kv_tiles = cdiv(max_pages * page, KV_TILE)
    num_sms = torch.cuda.get_device_properties(qp.device).multi_processor_count
    splits = _tma_splits(b * hkv * row_blocks, kv_tiles, num_sms, plan, cache.quantized)
    dev = qp.device
    q_ = qp.contiguous()
    o = torch.empty((b, hkv, rows, dv), dtype=qp.dtype, device=dev)
    lse = torch.empty((b, hkv, rows), dtype=torch.float32, device=dev)
    o_part = torch.empty((b, hkv, splits, rows, dv), dtype=torch.float32, device=dev)
    lse_part = torch.empty((b, hkv, splits, rows), dtype=torch.float32, device=dev)
    pools = [t.contiguous() for t in (cache.k_pages, cache.v_pages, cache.page_table, cache.lens)]
    scales = [None, None]
    if cache.quantized:
        scales = [t.contiguous() for t in (cache.k_scales, cache.v_scales)]
    if ENV.device_log_level() >= 2:
        logger.info(
            "paged_decode launch grid=(%d,%d,%d) rows=%d page=%d box_rows=%d stages=%d "
            "consumers=%d int8=%s", splits, hkv * row_blocks, b, rows, page, plan.box_rows,
            plan.stages, plan.consumers, cache.quantized,
        )
    launch = _paged_fn("ffpa_paged_decode")
    with torch.cuda.device(dev):
        err = launch(
            q_.data_ptr(), pools[0].data_ptr(), pools[1].data_ptr(),
            None if scales[0] is None else scales[0].data_ptr(),
            None if scales[1] is None else scales[1].data_ptr(),
            pools[2].data_ptr(), pools[3].data_ptr(), o.data_ptr(), lse.data_ptr(),
            o_part.data_ptr(), lse_part.data_ptr(),
            int(qp.dtype == torch.float16), int(cache.quantized), b, hkv, rows, nq, d, dv, page,
            max_pages, cache.k_pages.shape[0], float(scale), float(softcap), int(window_left),
            splits, torch.cuda.current_stream(dev).cuda_stream,
        )
    _check(err, "paged_decode kernel launch")
    paged_decode_attention.launches += 1
    return o, lse


def paged_decode_attention(
    q,
    cache: PagedKVCache,
    *,
    scale: Optional[float] = None,
    softcap: float = 0.0,
    window_left: int = -1,
    sinks: Optional[torch.Tensor] = None,
):
    """Decode attention over a paged KV cache.

    ``q``: [B, Hq, nq, D] with nq <= 8 (one decode token or a speculative
    tail; all nq tokens' K/V must already be appended, so the t-th new
    token attends positions [0, lens[b] - (nq - 1) + t)). GQA from Hq vs
    the pool's Hkv. ``softcap`` caps the true (dequantized) logits,
    ``window_left`` reads only the window's pages, ``sinks`` ([Hq] fp32)
    applies the sink-inclusive softmax as an LSE rescale. Returns [B, Hq,
    nq, Dv]. CPU tensors run the plain version; CUDA tensors launch the
    kernel, or raise for what it does not take."""
    b, hq, nq, d = q.shape
    assert nq <= _PAGED_MAX_NQ, "paged decode handles tiny-Nq (speculative) tiles only"
    hkv = cache.k_pages.shape[1]
    dv = cache.v_pages.shape[-1]
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    # PackGQA rows: row r is q-head hk * group + r // nq at position r % nq.
    qp = q.reshape(b, hkv, group * nq, d)
    kw = dict(nq=nq, scale=float(scale), softcap=float(softcap), window_left=int(window_left))
    run = _paged_decode_plain if q.device.type == "cpu" else _paged_decode_kernel
    o, lse = run(qp, cache, **kw)
    out = o.reshape(b, hq, nq, dv)
    if sinks is not None:
        from .attention import apply_sinks

        sinks = torch.as_tensor(sinks, dtype=torch.float32, device=q.device)
        out, _ = apply_sinks(out, lse.reshape(b, hq, nq), sinks, head_axis=1)
    return out


paged_decode_attention.launches = 0


def releasable_lead_pages(lens, window_left: int, page_size: int, nq: int = 1):
    """Host-side helper: per-sequence count of leading pages that a
    sliding-window decode can no longer read (every row is below
    ``lens[b] - nq - window_left``, the earliest position any future token
    attends; lens only grows, so the bound is monotone)."""
    lens = np.asarray(lens)
    first_needed = np.maximum(lens - nq - window_left, 0)
    return (first_needed // page_size).astype(np.int32)


class PageAllocator:
    """Host-side free-list allocator for the serving pool: which pool pages
    are free; sequence slots acquire and release whole page runs between
    steps, and the device-side ``PagedKVCache`` never changes shape."""

    def __init__(self, num_pages: int, reserved: int = 1):
        # Page ids [0, reserved) are never handed out (0 = null page).
        self._free = list(range(num_pages - 1, reserved - 1, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def acquire(self, n: int):
        """Pop ``n`` free pages, or None (the caller queues the sequence)."""
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def release(self, pages) -> None:
        seen = set(self._free)
        for p in pages:
            if p in seen:
                raise ValueError(f"double free of page {p}")
            self._free.append(int(p))
            seen.add(p)


def assign_sequence(cache: PagedKVCache, slot: int, pages) -> PagedKVCache:
    """Point batch slot ``slot`` at ``pages`` (from ``PageAllocator.acquire``)
    and reset its length, in place: the device-side half of admission.
    Unused table entries point at the null page."""
    max_pages = cache.page_table.shape[1]
    assert len(pages) <= max_pages, (len(pages), max_pages)
    row = torch.zeros((max_pages,), dtype=torch.int32)
    row[: len(pages)] = torch.as_tensor(list(pages), dtype=torch.int32)
    cache.page_table[slot] = row.to(cache.page_table.device)
    cache.lens[slot] = 0
    return cache


__all__ = [
    "PagedKVCache",
    "paged_split_ranges",
    "paged_kernel_plan",
    "paged_kernel_attrs",
    "append_token",
    "fill_from_prefill",
    "fill_slot",
    "paged_decode_attention",
    "releasable_lead_pages",
    "PageAllocator",
    "assign_sequence",
]
