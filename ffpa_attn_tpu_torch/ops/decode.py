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
fp32 partials with their LSE, launch 2 merges them by LSE); K/V chunks
stream through shared memory with cp.async one chunk ahead of the math;
with a sliding window only the tiles of the band are read.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..env import ENV
from ..logger import init_logger
from . import _build
from .config import D_CHUNK, KV_TILE, cdiv
from .flash_fwd import _bias_strides, _pad_last, check_kernel_inputs

_DECODE_GRAD_SLICE = (
    "it belongs to a later part of the training slice of the port (ROADMAP.md, "
    "queue 1: decode return_scores and the grouped composite backward "
    "_decode_core_bwd), which has not landed yet"
)
from .reference import DEFAULT_MASK_VALUE

logger = init_logger(__name__)

_DECODE_MAX_NQ = 8
# Above this many score elements (B*Hq*Nq*Nkv) the MHA decode composite's
# fp32 score buffers stop being small; the kernel takes those calls.
_DECODE_BWD_COMPOSITE_MAX_ELEMS = 1 << 28


def decode_attention_supported(q, k) -> bool:
    return q.shape[2] <= _DECODE_MAX_NQ


def _decode_block_kv(d: int, dv: int, nkv: int, dtype, group: int = 1) -> int:
    """KV rows per tile of the decode kernel (compiled in: ops/config.py
    KV_TILE); there is no tuned store in the port yet."""
    del d, dv, nkv, dtype, group
    return KV_TILE


def _num_splits(blocks_per_split: int, kv_tiles: int, num_sms: int) -> int:
    """KV splits so that about two blocks land on every SM, with at least
    one KV tile per split."""
    if kv_tiles <= 0:
        return 1
    want = cdiv(2 * num_sms, max(blocks_per_split, 1))
    splits = max(1, min(kv_tiles, want))
    return cdiv(kv_tiles, cdiv(kv_tiles, splits))  # no empty trailing split


def _kv_band(nq: int, nkv: int, is_causal: bool, window_left: int, window_right: int):
    """[start, end) of the KV rows any packed row attends; start is
    rounded down to a KV tile."""
    offset = nkv - nq
    wr = 0 if is_causal else window_right
    end = nkv if wr < 0 else min(nkv, nq - 1 + offset + wr + 1)
    start = 0 if window_left < 0 else max(0, offset - window_left)
    return (start // KV_TILE) * KV_TILE, end


def _decode_plain(qp, k, v, bias, *, nq, scale, is_causal, softcap, window_left, window_right):
    """The kernel's function in plain PyTorch on PACKED rows: qp
    [B, Hkv, R, D] with row r at query position r % nq; bias packed like
    qp. Returns (o [B, Hkv, R, Dv] in qp.dtype, lse [B, Hkv, R] fp32)."""
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
    return o, lse


_DECODE_ARGTYPES = (
    [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 9
    + [ctypes.c_float] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
)


def _decode_lib() -> ctypes.CDLL:
    lib = _build.load("decode")
    if lib.ffpa_decode_fwd.argtypes is None:
        lib.ffpa_decode_fwd.argtypes = _DECODE_ARGTYPES
        lib.ffpa_decode_fwd.restype = ctypes.c_int
    return lib


def _decode_kernel(qp, k, v, bias, *, nq, scale, is_causal, softcap, window_left, window_right):
    """Launch the split-KV kernel and its merge on packed rows (same
    contract as ``_decode_plain``)."""
    from .dispatch import pick_decode_config

    check_kernel_inputs("_decode_forward", qp, k, v)
    b, hkv, rows, d = qp.shape
    nkv, dv = k.shape[2], v.shape[-1]
    d_pad, dv_pad = cdiv(d, D_CHUNK) * D_CHUNK, cdiv(dv, D_CHUNK) * D_CHUNK
    cfg = pick_decode_config(d=d_pad, dv=dv_pad, nkv=nkv, dtype=qp.dtype, rows=rows)
    row_blocks = cdiv(rows, cfg.block_q)
    kv_start, kv_end = _kv_band(nq, nkv, is_causal, window_left, window_right)
    kv_tiles = cdiv(kv_end - kv_start, KV_TILE) if kv_end > kv_start else 0
    num_sms = torch.cuda.get_device_properties(qp.device).multi_processor_count
    splits = _num_splits(b * hkv * row_blocks, kv_tiles, num_sms)
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

    level = ENV.device_log_level()
    if level >= 2:
        logger.info(
            "decode launch grid=(%d,%d,%d) block_rows=%d rows=%d", splits,
            hkv * row_blocks, b, cfg.block_q, rows,
        )
    if level >= 3:
        logger.info(
            "decode split-KV band=[%d,%d) tiles=%d kv_per_split=%d",
            kv_start, kv_end, kv_tiles, kv_per_split,
        )
    lib = _decode_lib()
    with torch.cuda.device(dev):
        err = lib.ffpa_decode_fwd(
            q_.data_ptr(), k_.data_ptr(), v_.data_ptr(), o.data_ptr(),
            lse.data_ptr(), o_part.data_ptr(), lse_part.data_ptr(), bias_ptr,
            *strides, int(qp.dtype == torch.float16), cfg.block_q,
            b, hkv, rows, nq, nkv, d_pad, dv_pad, float(scale), float(softcap),
            nkv - nq, window_left, 0 if is_causal else window_right,
            kv_start, kv_end, kv_per_split, splits,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, err, "decode kernel launch")
    _decode_forward.launches += 1
    if dv_pad != dv:
        o = o[..., :dv]
    return o, lse


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
    """Decode attention for Nq <= 8: (o [B, Hq, Nq, Dv], lse [B, Hq, Nq]).

    Q rows and a head- or row-varying bias are packed per KV head
    (PackGQA); CPU tensors run the plain version, CUDA tensors the kernel.
    ``block_kv`` must be the kernel's KV tile if given.
    """
    if return_scores:
        raise NotImplementedError(f"decode return_scores: {_DECODE_GRAD_SLICE}")
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
        window_left=int(window[0]), window_right=int(window[1]),
    )
    if q.device.type == "cpu":
        o, lse = _decode_plain(q_packed, k, v, bias, **kw)
    else:
        o, lse = _decode_kernel(q_packed, k, v, bias, **kw)
    return o.reshape(b, hq, nq, dv), lse.reshape(b, hq, nq)


_decode_forward.launches = 0


class _DecodeCore(torch.autograd.Function):
    """Forward of the decode route; its gradient (the grouped composite
    backward ``_decode_core_bwd``) comes with a later part of the training
    slice."""

    @staticmethod
    def forward(ctx, scale, is_causal, softcap, window, q, k, v, bias, sinks):
        o, lse = _decode_forward(
            q, k, v, bias, scale=scale, is_causal=is_causal,
            softcap=softcap, window=window,
        )
        if sinks is not None:
            from .attention import apply_sinks

            o, _ = apply_sinks(o, lse, sinks)
        return o

    @staticmethod
    def backward(ctx, do):
        raise NotImplementedError(f"the decode backward: {_DECODE_GRAD_SLICE}")


def decode_attention(
    q, k, v, bias, *, scale, is_causal, softcap=0.0, window=(-1, -1), sinks=None,
):
    return _DecodeCore.apply(
        scale, is_causal, float(softcap), tuple(window), q, k, v, bias, sinks
    )


__all__ = [
    "decode_attention",
    "decode_attention_supported",
    "_decode_forward",
]
