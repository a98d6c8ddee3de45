"""Decode (Nq <= 8) attention: the split-KV CUDA kernel ``csrc/decode.cu``
and its plain PyTorch version.

Replaces the Pallas ``_decode_kernel`` of ``ffpa_attn_tpu/ops/decode.py``
(launched by its ``_decode_forward``).

**PackGQA:** the whole GQA group packs into the row tile (row ``r`` is query
head ``hk*group + r // Nq`` at position ``r % Nq``), so K/V stream from
device memory once per KV head instead of once per query head.

Bound on an H100: bytes. Every step reads the whole K and V cache once,
2*B*Hkv*Nkv*D*2 bytes: 34.6 MB per layer at B1 Hkv4 Nkv4224 D512, 10 us at
3.35 TB/s; its 2*B*Hq*Nkv*(D+Dv) flop take 0.03 us on the tensor cores.

Design against that bound: at B=1 the (B, Hkv) grid of the TPU kernel would
fill 4 of 132 SMs, so the KV range is split across blocks (launch 1 writes
fp32 partials with their LSE, launch 2 merges them by LSE); with a sliding
window only the tiles of the band are read. Launch 1 is one TMA block at
every D, Dv <= 1024 (``config.decode_plan``): a producer thread keeps up to
12 boxes of 8 KiB in flight; at D, Dv <= 512 one wgmma warpgroup does the
math, two blocks an SM; above, two warpgroups split Dv, one block an SM.
Splits by ``_tma_splits`` (one block for every SM where the band has the
tiles, every block of the launch resident at once), cut by
``decode_split_ranges``.

Under autograd the forward also writes the fp32 masked scores of the packed
rows (``return_scores``; 135 KB at the serving step), and the backward is
the grouped fp32 composite ``_decode_core_bwd`` in plain PyTorch, as the
JAX package leaves it to XLA: at Nq <= 8 its scores are O(group * Nq * Nkv).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..env import ENV
from ..logger import init_logger
from . import _build
from .config import D_CHUNK, KV_TILE, DecodePlan, cdiv, decode_plan
from .flash_fwd import _bias_strides, _pad_last, check_kernel_inputs
from .reference import DEFAULT_MASK_VALUE
from .rng import make_row_col_ids

logger = init_logger(__name__)

_DECODE_MAX_NQ = 8
# Above this many score elements (B*Hq*Nq*Nkv) the decode composite's fp32
# score buffers stop being small: the MHA forward takes the kernel, and the
# backward the tiled flash backward.
_DECODE_BWD_COMPOSITE_MAX_ELEMS = 1 << 28
# Score-residual budget of a differentiated decode call (divided by the
# assumed live layers): below it the forward emits the fp32 masked scores
# and the backward skips its K re-read for the score recompute.
_DECODE_SCORES_MAX_BYTES = 256 * 1024 * 1024


def decode_attention_supported(q, k) -> bool:
    return q.shape[2] <= _DECODE_MAX_NQ


def _decode_block_kv(d: int, dv: int, nkv: int, dtype, group: int = 1) -> int:
    """KV rows per tile of the decode kernel (compiled in: ops/config.py
    KV_TILE). The tuned-config store sets no decode knob: the split count
    is ``_tma_splits``'s rule."""
    del d, dv, nkv, dtype, group
    return KV_TILE


# The split count. A second block on an SM walks no faster,
# and every split adds a partial that the merge launch reads after the
# others. On an H100 80GB HBM3 at 700 W (tools/torch_decode_probe.py,
# device ms of walk + merge, two readings each): the generate step (B1
# H8/4 Nkv 4224 D512, 66 tiles, 4 blocks a split) read 0.0209-0.0213 at
# this rule's 33 splits, 0.0234-0.0244 at 66 and 0.0215 at 22; B1 Nkv 4096
# (64 tiles) 0.0202-0.0204 at its 32 and 0.0233-0.0237 at 64; the serving
# step (B4, 18 tiles) 0.0198 at its 9, 0.0244 at 18 and 0.0207-0.0208 at
# 6; the tiny model's step (B1 H2/1 Nkv 136 D320, 3 tiles, one block a
# split) 0.0085 at its 3, 0.0108 at 2 and 0.0133 at 1.
def _tma_splits(blocks_per_split: int, kv_tiles: int, num_sms: int, blocks_per_sm: int) -> int:
    """KV splits of the launch: as many as give every SM one block, at most
    one a tile; of those, the fewest that give the same longest run of
    tiles. Every block of the launch is resident at once: where the plan
    holds two blocks an SM (D, Dv <= 512) the count rounds up (fewer than
    num_sms + blocks_per_split blocks, two an SM at most while
    blocks_per_split <= num_sms), where it holds one (above 512) it rounds
    down (num_sms blocks at most)."""
    if kv_tiles <= 0:
        return 1
    bps = max(blocks_per_split, 1)
    per_sm = cdiv(num_sms, bps) if blocks_per_sm > 1 else num_sms // bps
    cap = max(1, min(kv_tiles, per_sm))
    return cdiv(kv_tiles, cdiv(kv_tiles, cap))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    """SMs of a card: the properties query costs the host ~5 us a call."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def decode_split_ranges(kv_start: int, kv_end: int, num_splits: int):
    """The cache rows each split of the TMA route walks: ``num_splits``
    [lo, hi) pairs that cut the band [kv_start, kv_end) (kv_start on a tile
    edge, ``_kv_band``) into near-equal runs of whole 64-row tiles, the last
    cut at kv_end; a split with no tile is (x, x). The kernel computes the
    same on the device (``csrc/decode.cu`` ``tma::range_of``); this copy is
    for the tests and runs on no path."""
    tiles = cdiv(kv_end - kv_start, KV_TILE) if kv_end > kv_start else 0
    cuts = [kv_start + (s * tiles // num_splits) * KV_TILE for s in range(num_splits + 1)]
    return [(min(lo, kv_end), min(hi, kv_end)) for lo, hi in zip(cuts, cuts[1:])]


def _kv_band(nq: int, nkv: int, is_causal: bool, window_left: int, window_right: int):
    """[start, end) of the KV rows any packed row attends; start is
    rounded down to a KV tile."""
    offset = nkv - nq
    wr = 0 if is_causal else window_right
    end = nkv if wr < 0 else min(nkv, nq - 1 + offset + wr + 1)
    start = 0 if window_left < 0 else max(0, offset - window_left)
    return (start // KV_TILE) * KV_TILE, end


def _decode_plain(qp, k, v, bias, *, nq, scale, is_causal, softcap, window_left, window_right,
                  return_scores=False):
    """The kernel's function in plain PyTorch on PACKED rows: qp
    [B, Hkv, R, D] with row r at query position r % nq; bias packed like
    qp. Returns (o [B, Hkv, R, Dv] in qp.dtype, lse [B, Hkv, R] fp32) and,
    with ``return_scores``, the fp32 masked scores [B, Hkv, R, Nkv_pad]
    (MASK_VALUE on padding)."""
    rows, nkv = qp.shape[2], k.shape[2]
    offset = nkv - nq
    s = torch.einsum("bhrd,bhkd->bhrk", qp.float(), k.float()) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    if bias is not None:
        s = s + bias.float()
    qpos = torch.arange(rows, device=qp.device)[:, None] % nq
    cols = torch.arange(nkv, device=qp.device)[None, :]
    wr = 0 if is_causal else window_right
    if wr >= 0:
        s = torch.where(cols <= qpos + offset + wr, s, DEFAULT_MASK_VALUE)
    if window_left >= 0:
        s = torch.where(cols >= qpos + offset - window_left, s, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(l.clamp_min(1e-38)))[..., 0]
    p = p / torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhrk,bhkd->bhrd", p, v.float()).to(qp.dtype)
    if not return_scores:
        return o, lse
    nkv_pad = cdiv(nkv, KV_TILE) * KV_TILE
    return o, lse, torch.nn.functional.pad(s, (0, nkv_pad - nkv), value=DEFAULT_MASK_VALUE)


_I, _P = ctypes.c_int, ctypes.c_void_p
_ARGTYPES = {
    "ffpa_decode_fwd": [_P] * 8 + [ctypes.c_longlong] * 4 + [_I] * 9 + [ctypes.c_float] * 2
    + [_I] * 7 + [_P, _I, _P],
    "ffpa_decode_plan": [_I] * 3 + [ctypes.POINTER(_I), _I],
    "ffpa_decode_attrs": [_I] * 2 + [ctypes.POINTER(_I)] * 2,
}


def _decode_fn(name: str):
    """Entry point ``name`` of the decode library, its argument types set
    at first use."""
    lib = _build.load("decode")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check(err: int, what: str) -> None:
    if err:
        _build.check(_build.load("decode"), err, what)


def decode_kernel_plan(d: int, dv: int, rows: int) -> DecodePlan:
    """The tiling the launcher takes at head dims (d, dv) (padded to
    64-column chunks) and ``rows`` packed rows, read from the library: what
    ``config.decode_plan`` mirrors. Needs a card."""
    out = (ctypes.c_int * 8)()
    err = _decode_fn("ffpa_decode_plan")(cdiv(d, D_CHUNK) * D_CHUNK, cdiv(dv, D_CHUNK) * D_CHUNK,
                                         rows, out, len(out))
    _check(err, "decode plan")
    return DecodePlan("tma" if out[0] == 1 else f"route {out[0]}", *out[1:6])


def decode_kernel_attrs(consumers: int, dtype=torch.bfloat16) -> dict:
    """Registers a thread and local (spill) bytes of the decode kernel
    with ``consumers`` warpgroups (1: D, Dv <= 512; 2: wider), from
    cudaFuncGetAttributes. Needs a card."""
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    err = _decode_fn("ffpa_decode_attrs")(consumers, int(dtype == torch.float16),
                                          ctypes.byref(regs), ctypes.byref(local))
    _check(err, "decode kernel attributes")
    return {"registers": regs.value, "local_bytes": local.value}


def _decode_kernel(qp, k, v, bias, *, nq, scale, is_causal, softcap, window_left, window_right,
                   return_scores=False):
    """Launch the split-KV kernel and its merge on packed rows (same
    contract as ``_decode_plain``), tiled as ``config.decode_plan``
    says."""
    check_kernel_inputs("_decode_forward", qp, k, v)
    b, hkv, rows, d = qp.shape
    nkv, dv = k.shape[2], v.shape[-1]
    d_pad, dv_pad = cdiv(d, D_CHUNK) * D_CHUNK, cdiv(dv, D_CHUNK) * D_CHUNK
    plan = decode_plan(d_pad, dv_pad, rows)
    row_blocks = cdiv(rows, plan.rows)
    kv_start, kv_end = _kv_band(nq, nkv, is_causal, window_left, window_right)
    kv_tiles = cdiv(kv_end - kv_start, KV_TILE) if kv_end > kv_start else 0
    num_sms = _sm_count(qp.device.index)
    splits = _tma_splits(b * hkv * row_blocks, kv_tiles, num_sms, plan.blocks_per_sm)
    kv_per_split = max(cdiv(kv_tiles, splits), 1) * KV_TILE

    q_ = _pad_last(qp, d_pad).contiguous()
    k_ = _pad_last(k, d_pad).contiguous()
    v_ = _pad_last(v, dv_pad).contiguous()
    dev = qp.device
    o = torch.empty((b, hkv, rows, dv_pad), dtype=qp.dtype, device=dev)
    lse = torch.empty((b, hkv, rows), dtype=torch.float32, device=dev)
    o_part = torch.empty((b, hkv, splits, rows, dv_pad), dtype=torch.float32, device=dev)
    lse_part = torch.empty((b, hkv, splits, rows), dtype=torch.float32, device=dev)
    bias_ptr, strides = None, (0, 0, 0, 0)
    if bias is not None:
        bias = bias.to(device=dev, dtype=torch.float32)
        strides = _bias_strides(bias, (b, hkv, rows, nkv))
        bias_ptr = bias.data_ptr()
    scores = None
    if return_scores:
        scores = torch.empty((b, hkv, rows, cdiv(nkv, KV_TILE) * KV_TILE), dtype=torch.float32,
                             device=dev)

    level = ENV.device_log_level()
    if level >= 2:
        logger.info(
            "decode launch consumers=%d grid=(%d,%d,%d) block_rows=%d rows=%d stages=%d",
            plan.consumers, splits, hkv * row_blocks, b, plan.rows, rows, plan.stages,
        )
    if level >= 3:
        logger.info(
            "decode split-KV band=[%d,%d) tiles=%d kv_per_split=%d",
            kv_start, kv_end, kv_tiles, kv_per_split,
        )
    launch = _decode_fn("ffpa_decode_fwd")
    with torch.cuda.device(dev):
        err = launch(
            q_.data_ptr(), k_.data_ptr(), v_.data_ptr(), o.data_ptr(),
            lse.data_ptr(), o_part.data_ptr(), lse_part.data_ptr(), bias_ptr,
            *strides, int(qp.dtype == torch.float16), plan.rows,
            b, hkv, rows, nq, nkv, d_pad, dv_pad, float(scale), float(softcap),
            nkv - nq, window_left, 0 if is_causal else window_right,
            kv_start, kv_end, kv_per_split, splits,
            None if scores is None else scores.data_ptr(),
            0 if scores is None else scores.shape[3],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check(err, "decode kernel launch")
    _decode_forward.launches += 1
    if dv_pad != dv:
        o = o[..., :dv]
    return (o, lse) if scores is None else (o, lse, scores)


def _decode_forward(
    q,
    k,
    v,
    bias,
    *,
    scale,
    is_causal,
    block_kv: Optional[int] = None,
    softcap: float = 0.0,
    window: tuple = (-1, -1),
    return_scores: bool = False,
):
    """Decode attention for Nq <= 8: (o [B, Hq, Nq, Dv], lse [B, Hq, Nq]),
    and with ``return_scores`` the fp32 masked post-softcap / bias scores
    of the packed rows [B, Hkv, group * Nq, Nkv_pad] (the decode backward's
    residual; each split of the kernel writes its own columns).

    Q rows and a head- or row-varying bias are packed per KV head
    (PackGQA); CPU tensors run the plain version, CUDA tensors the kernel.
    ``block_kv`` must be the kernel's KV tile if given.
    """
    b, hq, nq, d = q.shape
    _, hkv, nkv, _ = k.shape
    dv = v.shape[-1]
    group = hq // hkv
    if block_kv is not None and block_kv != _decode_block_kv(d, dv, nkv, q.dtype, group):
        raise ValueError(f"decode block_kv must be {KV_TILE}, got {block_kv}")

    # PackGQA: rows of the tile are (group, nq) pairs of one KV head.
    rows = group * nq
    q_packed = q.reshape(b, hkv, rows, d)
    if bias is not None and (bias.shape[1] != 1 or (bias.shape[2] != 1 and group > 1)):
        # Head- or row-varying bias must be packed like Q.
        bias = bias.expand(bias.shape[0], hq, nq, bias.shape[3]).reshape(
            bias.shape[0], hkv, rows, bias.shape[3]
        )
    kw = dict(
        nq=nq, scale=scale, is_causal=is_causal, softcap=float(softcap),
        window_left=int(window[0]), window_right=int(window[1]), return_scores=return_scores,
    )
    run = _decode_plain if q.device.type == "cpu" else _decode_kernel
    out = run(q_packed, k, v, bias, **kw)
    o, lse = out[0].reshape(b, hq, nq, dv), out[1].reshape(b, hq, nq)
    return (o, lse, out[2]) if return_scores else (o, lse)


_decode_forward.launches = 0


def _decode_emits_scores(q, k, bias, softcap, window) -> bool:
    """Whether a differentiated decode call keeps its score residual: it
    fits the budget (per assumed live layer), the S carries no additive
    term under softcap (the tanh factor is read back from S), and there is
    no sliding window (the band's skipped columns would cost a full-width
    residual)."""
    b, hq, nq, _ = q.shape
    hkv, nkv = k.shape[1], k.shape[2]
    budget = _DECODE_SCORES_MAX_BYTES // max(1, ENV.scores_auto_assumed_layers())
    nbytes = b * hkv * (hq // hkv) * nq * cdiv(nkv, KV_TILE) * KV_TILE * 4
    return (nbytes <= budget and not (softcap > 0.0 and bias is not None)
            and int(window[0]) < 0 and int(window[1]) < 0)


def _decode_core_bwd(scale, is_causal, softcap, window, q, k, v, bias, sinks, o, lse, scores,
                     do, need_bias):
    """Grouped fp32 composite backward of a decode call (Nq <= 8), as the
    JAX package leaves it to XLA: everything stays in the [B, Hkv, G, Nq, *]
    layout (K/V are never expanded to Hq), P comes from the score residual
    (band re-masked) or from recomputed scores, and dK / dV contract the
    whole (group, Nq) row axis per KV head. Above
    ``_DECODE_BWD_COMPOSITE_MAX_ELEMS`` score elements the tiled flash
    backward takes the call. Returns (dq, dk, dv, dbias, dsinks)."""
    from .attention import sink_grad
    from .flash_bwd import flash_attention_backward

    b, hq, nq, d = q.shape
    hkv, nkv, dv_dim = k.shape[1], k.shape[2], v.shape[-1]
    g = hq // hkv
    dsinks = None if sinks is None else sink_grad(do, o, lse, sinks)
    if b * hq * nq * nkv > _DECODE_BWD_COMPOSITE_MAX_ELEMS:
        dq, dk, dv, dbias = flash_attention_backward(
            q, k, v, bias, o, lse, do.to(o.dtype), scale=scale, is_causal=is_causal,
            softcap=softcap, window=window, bias_grad=need_bias,
        )
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias, dsinks

    rows, cols = make_row_col_ids(nq, nkv, device=q.device)
    wl, wr = int(window[0]), 0 if is_causal else int(window[1])
    band = None
    if wr >= 0 or wl >= 0:
        band = torch.ones((nq, nkv), dtype=torch.bool, device=q.device)
        if wr >= 0:
            band = band & (cols <= rows + nkv - nq + wr)
        if wl >= 0:
            band = band & (cols >= rows + nkv - nq - wl)
    qg = q.reshape(b, hkv, g, nq, d).float()
    dog = do.to(o.dtype).reshape(b, hkv, g, nq, dv_dim).float()
    t = None
    if scores is not None:
        s = scores[:, :, : g * nq, :nkv].reshape(b, hkv, g, nq, nkv)
        if band is not None:
            s = torch.where(band, s, DEFAULT_MASK_VALUE)
        if softcap > 0.0:
            # s = cap * tanh(s_pre / cap) (no additive term by the emit
            # gate); clamped so masked entries give a factor of 0, not NaN.
            t = (s / softcap).clamp(-1.0, 1.0)
    else:
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
        if softcap > 0.0:
            t = torch.tanh(s / softcap)
            s = softcap * t
        if bias is not None:
            s = s + bias.float().expand(b, hq, nq, nkv).reshape(b, hkv, g, nq, nkv)
        if band is not None:
            s = torch.where(band, s, DEFAULT_MASK_VALUE)
    p = torch.exp(s - lse.reshape(b, hkv, g, nq)[..., None])
    delta = (do.float() * o.float()).sum(-1).reshape(b, hkv, g, nq)
    dp = torch.einsum("bhgqe,bhke->bhgqk", dog, v.float())
    ds = p * (dp - delta[..., None])
    dbias = None
    if need_bias:
        ds_full = ds.reshape(b, hq, nq, nkv)
        axes = tuple(ax for ax in range(4) if bias.shape[ax] == 1 and ds_full.shape[ax] != 1)
        dbias = (ds_full.sum(dim=axes, keepdim=True) if axes else ds_full).to(bias.dtype)
    if t is not None:
        ds = ds * (1.0 - t * t)
    ds = ds * scale
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float()).reshape(b, hq, nq, d)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg)
    dv = torch.einsum("bhgqk,bhgqe->bhke", p, dog)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias, dsinks


class _DecodeCore(torch.autograd.Function):
    """The decode route under autograd: the forward keeps the score
    residual where ``_decode_emits_scores`` allows, the backward is the
    grouped composite ``_decode_core_bwd``."""

    @staticmethod
    def forward(ctx, scale, is_causal, softcap, window, q, k, v, bias, sinks):
        scores = None
        if any(ctx.needs_input_grad) and _decode_emits_scores(q, k, bias, softcap, window):
            o, lse, scores = _decode_forward(
                q, k, v, bias, scale=scale, is_causal=is_causal,
                softcap=softcap, window=window, return_scores=True,
            )
        else:
            o, lse = _decode_forward(
                q, k, v, bias, scale=scale, is_causal=is_causal,
                softcap=softcap, window=window,
            )
        if sinks is not None:
            from .attention import apply_sinks

            # Sink-inclusive residuals: the backward is exact under them.
            o, lse = apply_sinks(o, lse, sinks)
        ctx.static = (scale, is_causal, softcap, window)
        ctx.save_for_backward(q, k, v, bias, sinks, o, lse, scores)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, sinks, o, lse, scores = ctx.saved_tensors
        need_bias = bias is not None and ctx.needs_input_grad[7]
        dq, dk, dv, dbias, dsinks = _decode_core_bwd(
            *ctx.static, q, k, v, bias, sinks, o, lse, scores, do, need_bias)
        return None, None, None, None, dq, dk, dv, dbias, dsinks


def decode_attention(
    q, k, v, bias, *, scale, is_causal, softcap=0.0, window=(-1, -1), sinks=None,
):
    return _DecodeCore.apply(
        scale, is_causal, float(softcap), tuple(window), q, k, v, bias, sinks
    )


__all__ = [
    "decode_attention",
    "decode_attention_supported",
    "decode_kernel_attrs",
    "decode_kernel_plan",
    "decode_split_ranges",
    "_decode_forward",
    "_decode_core_bwd",
]
