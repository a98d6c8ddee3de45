"""Backward attention: the CUDA kernels of ``csrc/flash_bwd.cu``, their plain
PyTorch versions, and ``flash_attention_backward``, which chains them.

Counterpart of ``ffpa_attn_tpu/ops/flash_bwd.py``. Five Pallas kernels are
replaced, each by a wrapper of the same name and arguments that launches
the CUDA kernel for CUDA tensors and runs the plain version for CPU
tensors:

* ``_dkdv_launch`` (Pallas ``_dkdv_kernel``): dK, dV and optionally the dS
  slab of the dS-handoff tier, in the input type or (``ds_store_bits =
  8``) in float8_e4m3fn;
* ``_dq_launch`` (``_dq_kernel``): dQ and optionally dbias, the recompute
  tier's second launch;
* ``_banded_dq_from_ds`` (``_banded_dq_kernel``): dQ = scale * dS K from
  the slab (16-bit, or e4m3 widened to bf16 in the kernel), causal tiles
  above the diagonal skipped;
* ``_dkdv_from_s_launch`` (``_dkdv_from_s_kernel``): the S-resident tier's
  dV (and dK) from the forward's S residual, dS written over S in place;
* ``_banded_dk_from_ds`` (``_banded_dk_kernel``): dK = scale * dS^T Q from
  the slab, causal tiles skipped, the GQA group reduced in fp32.

The S-resident tier does 2 matmul units in the from-S pass with dK out of
kernel (dP, dV; 3 with dK) and reads S where the recompute reads K: at the
training shape 5.5e11 flop (0.56 ms at 989 TFLOP/s) and 1 GiB of S read
and dS written (0.64 ms at 3.35 TB/s). Banded dK is banded dQ's mirror (one
unit, 0.28 ms).

Bound on an H100: operations. At the training shape (B1 Hq8 N8192 D512
causal) the dK/dV pass does 4 matmul units of 2 * Hq * N(N+1)/2 * D flop,
1.1e12 in all (1.1 ms at 989 TFLOP/s), and writes a 1 GiB dS slab (0.32 ms
at 3.35 TB/s); banded dQ does one unit (0.28 ms). Design against that bound
(``csrc/flash_bwd.cu``): whole tiles outside the causal / window band are
never loaded; a dK/dV block loops over the GQA group and the Q tiles itself
(one store of the group-reduced dK/dV, no atomics). The dK/dV block runs
on TMA and wgmma (``config.dkdv_plan``): 64 KV rows with K and V resident,
a producer warpgroup streaming 64-row Q and dO boxes, two consumer
warpgroups each computing half of S^T and dP^T and then one of dK and
dV, at most 256 columns a pass; for D or Dv above 512 a cluster of two
such blocks splits D and Dv, each rank adding the partner's partial S^T
and dP^T through distributed shared memory. The recompute dQ block is
its mirror (``config.dq_plan``): 64 Q rows with Q and dO resident, K, V
and again K boxes streamed, two consumers each computing half of S and dP
and then owning half of dQ's columns; for D or Dv above 512 a cluster of
two such blocks splits D and Dv, each rank adding the partner's partial S
and dP through distributed shared memory. Banded dQ and banded
dK are plain GEMMs over a causal k-range and run on Hopper's TMA and wgmma
(``csrc/sm90.cuh``): a producer warpgroup keeps a 4-stage ring of TMA
tiles full, two consumer warpgroups run wgmma.m64n256k16 on 128 rows x at
most 256 columns a block
(``config.banded_plan``), the transposes (K and Q read N-major, dS^T read
M-major from the [q][kv] slab) done by wgmma's operand bits. Their tensor
maps declare the slab's extents (nq, nkv), so its padding is never read.

fp8 dS storage (opt-in, ``FFPA_TORCH_ALLOW_FP8_DS``; bf16 inputs, no fp16
cotangent, no bias, the handoff tier only): the dK/dV kernel quantizes its
fp32 dS straight to float8_e4m3fn (never through bf16: the double rounding
can round a tie the other way) with round-to-nearest-even, and dK and dV,
formed from the 16-bit dS in the kernel, are bit-equal to the 16-bit run.
Past e4m3's range the port saturates: |dS| > 448 is stored as +-448 (CUDA's
``cvt.rn.satfinite``; the plain version clamps before its cast), so a
gradient never holds a NaN that its input did not. The JAX package's
``astype`` gives NaN from ~464 on; this is a deliberate difference. NaN
stays NaN. Readers widen exactly (every e4m3 value is a bf16 value).

The delta preprocess ``rowsum(dO * O)``, ``_dq_from_ds`` and
``_dbias_from_ds`` are plain large reductions and products outside any
Pallas kernel in JAX and stay PyTorch here. fp16 runs natively: there is no
hi+lo split of P and dO for the dV product (the JAX package needs one
because Mosaic computes fp16 in bf16).
"""

from __future__ import annotations

import ctypes
from dataclasses import replace
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..env import ENV
from ..logger import init_logger
from . import _build
from .config import (
    D_CHUNK,
    DKDV_Q_TILE,
    DKDV_SLAB_COLS,
    KV_TILE,
    BandedPlan,
    BlockConfig,
    DkdvPlan,
    DqPlan,
    FromSPlan,
    banded_plan,
    cdiv,
    dkdv_plan,
    dq_plan,
    from_s_fits,
    from_s_plan,
)
from .flash_fwd import _bias_strides, _pad_last, check_kernel_inputs, dropout_args
from .reference import DEFAULT_MASK_VALUE, expand_kv_heads, reduce_q_heads
from .rng import dropout_keep_mask, make_row_col_ids

logger = init_logger(__name__)

_GRAD_DTYPES = {"f16": torch.float16, "bf16": torch.bfloat16, "f32": torch.float32}

# The largest finite float8_e4m3fn, where the port saturates dS.
E4M3_MAX = 448.0


def quantize_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` (fp32) in float8_e4m3fn by the port's rule: round to nearest
    even, saturating to +-448 past the range (NaN stays NaN), as the dK/dV
    kernel's ``cvt.rn.satfinite.e4m3x2.f32``."""
    return x.float().clamp(-E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn)


def e4m3_steps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Element by element, how many places of the ordered e4m3 grid lie
    between two float8_e4m3fn tensors (+0 and -0 are one place): 1 where a
    kernel and a plain version rounded fp32 values that differ in their
    last bits to neighbouring values."""
    def place(x):
        code = x.contiguous().view(torch.uint8).to(torch.int16)
        return torch.where(code >= 0x80, -(code & 0x7F), code)

    return (place(a) - place(b)).abs()


def _grad_dtype(storage: Optional[str], default_dtype: torch.dtype) -> torch.dtype:
    return default_dtype if storage is None else _GRAD_DTYPES[storage]


def _pad_rows(x: torch.Tensor, rows: int, dim: int = 2) -> torch.Tensor:
    pad = rows - x.shape[dim]
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - 1 - dim) + [0, pad]
    return F.pad(x, widths)


# ---------------------------------------------------------------------------
# Plain versions (fp32 math, the kernels' roundings)
# ---------------------------------------------------------------------------


def _score_grads_plain(
    q, k, v, do, lse, delta, bias, *, scale, is_causal, causal_offset, dropout_p,
    seed, softcap, window, alibi, row_offset=0, col_offset=0,
):
    """``_recompute_ds`` over the whole problem: fp32 [B, Hq, Nq, Nkv]
    (p_dropped, ds, ds_qk). ``ds`` is the post-bias score gradient (the
    bias gradient); ``ds_qk`` carries softcap's chain factor."""
    b, hq, nq, _ = q.shape
    nkv = k.shape[2]
    dev = q.device
    kx, vx = expand_kv_heads(k, hq).float(), expand_kv_heads(v, hq).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx) * scale
    cap = None
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
        cap = 1.0 - torch.square(s / softcap)
    rows, cols = make_row_col_ids(nq, nkv, device=dev)
    if alibi is not None:
        dist = (rows + causal_offset - cols).abs().float()
        s = s - alibi.float().reshape(b, hq, 1, 1) * dist
    if bias is not None:
        s = s + bias.float()
    wl = int(window[0])
    wr = 0 if is_causal else int(window[1])
    if wr >= 0:
        s = torch.where(cols <= rows + causal_offset + wr, s, DEFAULT_MASK_VALUE)
    if wl >= 0:
        s = torch.where(cols >= rows + causal_offset - wl, s, DEFAULT_MASK_VALUE)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), vx)
    p_dropped = p
    if dropout_p > 0.0:
        bi = torch.arange(b, device=dev)[:, None, None, None]
        hi = torch.arange(hq, device=dev)[None, :, None, None]
        keep = dropout_keep_mask(seed, bi, hi, rows + row_offset, cols + col_offset, dropout_p)
        inv = 1.0 / (1.0 - dropout_p)
        p_dropped = torch.where(keep, p, 0.0) * inv
        dp = torch.where(keep, dp, 0.0) * inv
    ds = p * (dp - delta[..., None])
    return p_dropped, ds, ds if cap is None else ds * cap


def _dkdv_plain(q, k, v, bias, do, lse, delta, *, scale, emit_ds, nq_pad, nkv_pad,
                ds_fp8=False, **kw):
    """(dk, dv) in fp32, group-reduced, and the dS slab (padded; the input
    type, or with ``ds_fp8`` float8_e4m3fn quantized from the fp32 dS by
    ``quantize_e4m3``). dK takes the 16-bit dS either way."""
    hkv, t = k.shape[1], q.dtype
    p_dropped, _, ds_qk = _score_grads_plain(q, k, v, do, lse, delta, bias, scale=scale, **kw)
    ds_t = ds_qk.to(t)
    dv = reduce_q_heads(torch.einsum("bhqk,bhqd->bhkd", p_dropped.to(t).float(), do.float()), hkv)
    dk = reduce_q_heads(torch.einsum("bhqk,bhqd->bhkd", ds_t.float(), q.float()), hkv) * scale
    ds_full = None
    if emit_ds:
        src = ds_qk if ds_fp8 else ds_t
        ds_full = _pad_rows(_pad_rows(src, nkv_pad, dim=3), nq_pad, dim=2)
        if ds_fp8:
            ds_full = quantize_e4m3(ds_full)
    return dk, dv, ds_full


def _dq_plain(q, k, v, bias, do, lse, delta, *, scale, emit_dbias, **kw):
    """dq in fp32 and, when asked, the fp32 bias gradient [B, Hq, Nq, Nkv]."""
    _, ds, ds_qk = _score_grads_plain(q, k, v, do, lse, delta, bias, scale=scale, **kw)
    kx = expand_kv_heads(k, q.shape[1]).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds_qk.to(q.dtype).float(), kx) * scale
    return dq, (ds if emit_dbias else None)


def _banded_dq_plain(ds_full, k, *, scale, nq, nkv):
    kx = expand_kv_heads(k, ds_full.shape[1]).float()
    return torch.einsum("bhqk,bhkd->bhqd", ds_full[:, :, :nq, :nkv].float(), kx) * scale


def _dkdv_from_s_plain(q, v, s_pad, do, lse, delta, *, scale, is_causal, causal_offset,
                       dropout_p, seed, softcap, dk_in_kernel):
    """(dk or None, dv) in fp32, group-reduced, and dS [B, Hq, nq_pad,
    nkv_pad] in bf16 (zeros outside the band and on padding) from the S
    residual. The band is re-masked here, so what the slab holds outside it
    never matters."""
    b, hq, nq, _ = q.shape
    hkv, nkv = v.shape[1], v.shape[2]
    nq_pad, nkv_pad = s_pad.shape[2], s_pad.shape[3]
    s = s_pad[:, :, :nq, :nkv].float()
    rows, cols = make_row_col_ids(nq, nkv, device=q.device)
    band = torch.ones((nq, nkv), dtype=torch.bool, device=q.device)
    if is_causal:
        band = cols <= rows + causal_offset
    p = torch.where(band, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), expand_kv_heads(v, hq).float())
    p_dropped = p
    if dropout_p > 0.0:
        bi = torch.arange(b, device=q.device)[:, None, None, None]
        hi = torch.arange(hq, device=q.device)[None, :, None, None]
        keep = dropout_keep_mask(seed, bi, hi, rows, cols, dropout_p)
        inv = 1.0 / (1.0 - dropout_p)
        p_dropped = torch.where(keep, p, 0.0) * inv
        dp = torch.where(keep, dp, 0.0) * inv
    ds = p * (dp - delta[..., None])
    if softcap > 0.0:
        ds = ds * torch.where(band, (1.0 - torch.square(s / softcap)).clamp_min(0.0), 0.0)
    ds_t = ds.to(torch.bfloat16)
    dv = reduce_q_heads(
        torch.einsum("bhqk,bhqd->bhkd", p_dropped.to(torch.bfloat16).float(), do.float()), hkv)
    dk = None
    if dk_in_kernel:
        dk = reduce_q_heads(torch.einsum("bhqk,bhqd->bhkd", ds_t.float(), q.float()), hkv) * scale
    return dk, dv, _pad_rows(_pad_rows(ds_t, nkv_pad, dim=3), nq_pad, dim=2)


def _banded_dk_plain(ds_full, q, *, scale, nq, nkv, hkv):
    dk = torch.einsum("bhqk,bhqd->bhkd", ds_full[:, :, :nq, :nkv].float(), q.float())
    return reduce_q_heads(dk, hkv) * scale


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_ARGTYPES = {
    "ffpa_bwd_dkdv": (
        [_P] * 10 + [_LL] * 4 + [_P] + [_I] * 11 + [_F] * 2 + [_I] * 3 + [_F] * 2
        + [ctypes.c_uint32] + [_I] * 3 + [_P]
    ),
    "ffpa_bwd_dq": (
        [_P] * 9 + [_LL] * 4 + [_P] + [_I] * 12 + [_F] * 2 + [_I] * 3 + [_F] * 2
        + [ctypes.c_uint32] + [_P]
    ),
    "ffpa_bwd_banded_dq": [_P] * 3 + [_I] * 11 + [_F] + [_I] * 2 + [_P],
    "ffpa_bwd_dkdv_from_s": (
        [_P] * 8 + [_I] * 12 + [_F] * 2 + [_I] * 2 + [_F] * 2 + [ctypes.c_uint32] + [_P]
    ),
    "ffpa_bwd_banded_dk": [_P] * 3 + [_I] * 10 + [_F] + [_I] + [_P],
    "ffpa_bwd_banded_attrs": [_I] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2,
    "ffpa_bwd_banded_plan": [_I, _I, ctypes.POINTER(ctypes.c_int), _I],
    "ffpa_bwd_dkdv_attrs": [_I] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2,
    "ffpa_bwd_dkdv_plan": [_I, _I, ctypes.POINTER(ctypes.c_int), _I],
    "ffpa_bwd_from_s_attrs": [_I] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2,
    "ffpa_bwd_from_s_plan": [_I, _I, ctypes.POINTER(ctypes.c_int), _I],
    "ffpa_bwd_dq_attrs": [_I] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2,
    "ffpa_bwd_dq_plan": [_I, _I, ctypes.POINTER(ctypes.c_int), _I],
}


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_bwd")
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name, None)  # None: a library built from older sources
        if fn is not None and fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


class _Operands(NamedTuple):
    """A backward kernel's inputs: head dims padded to 64-multiples,
    contiguous, fp32 bias / ALiBi / lse / delta."""

    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    do: torch.Tensor
    lse: torch.Tensor
    delta: torch.Tensor
    bias: Optional[torch.Tensor]
    strides: tuple  # the bias's element strides, 0 on broadcast dims
    alibi: Optional[torch.Tensor]

    def ptrs(self) -> list:
        """q, k, v, dO, lse and delta pointers, in the C entry points' order."""
        return [t.data_ptr() for t in (self.q, self.k, self.v, self.do, self.lse, self.delta)]

    def extras(self) -> list:
        """bias pointer, its four strides and the ALiBi pointer."""
        return [None if self.bias is None else self.bias.data_ptr(), *self.strides,
                None if self.alibi is None else self.alibi.data_ptr()]


def _kernel_operands(q, k, v, do, bias, alibi, lse, delta) -> _Operands:
    check_kernel_inputs("flash_attention_backward", q, k, v)
    b, hq, nq, d = q.shape
    d_pad = cdiv(d, D_CHUNK) * D_CHUNK
    dv_pad = cdiv(v.shape[-1], D_CHUNK) * D_CHUNK
    strides = (0, 0, 0, 0)
    if bias is not None:
        bias = bias.to(device=q.device, dtype=torch.float32)
        strides = _bias_strides(bias, (b, hq, nq, k.shape[2]))
    if alibi is not None:
        alibi = torch.as_tensor(alibi, dtype=torch.float32, device=q.device).expand(
            b, hq).contiguous()
    return _Operands(
        _pad_last(q, d_pad).contiguous(), _pad_last(k, d_pad).contiguous(),
        _pad_last(v, dv_pad).contiguous(), _pad_last(do.to(q.dtype), dv_pad).contiguous(),
        lse.float().contiguous(), delta.float().contiguous(), bias, strides, alibi,
    )


def _out_dtype(want: torch.dtype, t: torch.dtype):
    """(kernel writes fp32?, dtype it writes): the input type when asked
    for, else fp32 (cast by the wrapper)."""
    return (0, t) if want == t else (1, torch.float32)


def _dkdv_launch(
    q, k, v, bias, do, lse, delta, seed, config, *, scale, is_causal, causal_offset,
    dropout_p, group, grad_kv_storage_dtype, emit_ds=False, col_offset=0,
    row_offset=0, softcap=0.0, window=(-1, -1), alibi=None,
):
    """dK, dV [B, Hkv, Nkv, D|Dv] (GQA group reduced) and, with
    ``emit_ds``, the dS slab [B, Hq, nq_pad, nkv_pad]: the score gradient
    with softcap's factor, zeros outside the band and on padding, in q's
    dtype or, where ``config.ds_store_bits`` is 8 (bf16 inputs only),
    in float8_e4m3fn quantized from the fp32 dS (``quantize_e4m3``); dK
    and dV are the same either way. A caller applies the rules that keep
    16 bits (``flash_attention_backward``). ``causal_offset`` is the
    launch's local offset; ``row_offset`` / ``col_offset`` map its rows /
    columns to the global ids the dropout hash takes. ``seed`` is the
    dropout seed. The kernel's
    route is the launcher's own, by head dims alone (``config.dkdv_plan``):
    one wgmma block for D, Dv <= 512, above that a cluster of two whose
    ranks split D and Dv and exchange partial S^T and dP^T; either picks
    its own column passes. The slab's padding (DKDV_Q_TILE rows,
    DKDV_SLAB_COLS columns) suits both routes' 64 x 64 tiles."""
    b, hq, nq, d = q.shape
    _, hkv, nkv, _ = k.shape
    dv_dim = v.shape[-1]
    nq_pad = cdiv(nq, DKDV_Q_TILE) * DKDV_Q_TILE
    nkv_pad = cdiv(nkv, DKDV_SLAB_COLS) * DKDV_SLAB_COLS
    dk_dtype = _grad_dtype(grad_kv_storage_dtype, k.dtype)
    dv_dtype = _grad_dtype(grad_kv_storage_dtype, v.dtype)
    window_left = int(window[0])
    window_right = -1 if is_causal else int(window[1])
    ds_fp8 = emit_ds and config is not None and config.ds_store_bits == 8
    if ds_fp8 and q.dtype != torch.bfloat16:
        raise TypeError("dkdv: an e4m3 dS slab takes bf16 inputs")
    if q.device.type == "cpu":
        dk, dv, ds_full = _dkdv_plain(
            q, k, v, bias, do, lse, delta, scale=scale, emit_ds=emit_ds, nq_pad=nq_pad,
            nkv_pad=nkv_pad, ds_fp8=ds_fp8, is_causal=is_causal, causal_offset=causal_offset,
            dropout_p=dropout_p, seed=seed, softcap=softcap,
            window=(window_left, window_right), alibi=alibi, row_offset=row_offset,
            col_offset=col_offset,
        )
        return dk.to(dk_dtype), dv.to(dv_dtype), ds_full

    ops = _kernel_operands(q, k, v, do, bias, alibi, lse, delta)
    d_pad, dv_pad = ops.q.shape[-1], ops.v.shape[-1]
    out_f32, wt = _out_dtype(dk_dtype, q.dtype)
    dk = torch.empty((b, hkv, nkv, d_pad), dtype=wt, device=q.device)
    dv = torch.empty((b, hkv, nkv, dv_pad), dtype=wt, device=q.device)
    ds_dtype = torch.float8_e4m3fn if ds_fp8 else q.dtype
    ds_full = (torch.empty((b, hq, nq_pad, nkv_pad), dtype=ds_dtype, device=q.device)
               if emit_ds else None)
    if ENV.device_log_level() >= 2:
        plan = dkdv_plan(d_pad, dv_pad)
        logger.info("dkdv launch route=%s passes=%d kv_rows=%d D=%d Dv=%d emit_ds=%s ds=%s",
                    plan.route, plan.passes, plan.kv_rows, d_pad, dv_pad, emit_ds, ds_dtype)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        err = lib.ffpa_bwd_dkdv(
            *ops.ptrs(), dk.data_ptr(), dv.data_ptr(),
            None if ds_full is None else ds_full.data_ptr(), *ops.extras(),
            int(q.dtype == torch.float16), out_f32, b, hq, hkv, nq, nkv, d_pad, dv_pad,
            nq_pad, nkv_pad, float(scale), float(softcap), int(causal_offset),
            window_left, 0 if is_causal else window_right,
            *dropout_args(dropout_p, seed), int(row_offset), int(col_offset),
            8 if ds_fp8 else 16, torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, err, "dkdv kernel launch")
    if ds_fp8:
        _dkdv_launch.fp8_launches += 1
    else:
        _dkdv_launch.launches += 1
    return dk[..., :d].to(dk_dtype), dv[..., :dv_dim].to(dv_dtype), ds_full


# launches: the 16-bit-slab (or slab-less) kernel; fp8_launches: the
# instance that writes an e4m3 slab.
_dkdv_launch.launches = 0
_dkdv_launch.fp8_launches = 0


def dbias_slab_shape(nq: int, nkv: int, d: int, dv: int) -> tuple:
    """(rows, columns) of the fp32 dbias slab the dQ kernel writes at head
    dims (d, dv) (padded to 64-column chunks): rows padded to the block's Q
    rows (64 on both routes), columns to KV_TILE."""
    rows = dq_plan(d, dv).q_rows
    return cdiv(nq, rows) * rows, cdiv(nkv, KV_TILE) * KV_TILE


def _dq_launch(
    q, k, v, bias, do, lse, delta, seed, config, *, scale, is_causal, causal_offset,
    dropout_p, group, grad_q_storage_dtype, softcap=0.0, window=(-1, -1), alibi=None,
    emit_dbias=True,
):
    """dQ [B, Hq, Nq, D] and, for a bias when ``emit_dbias``, its gradient
    reduced to the bias's compact shape: the post-bias score gradient,
    without softcap's factor. The kernel's route (one wgmma block for D,
    Dv <= 512, a cluster of two up to 1024) and its 64-row tile are the
    launcher's own, by head dims alone (``config.dq_plan``); ``config`` is
    not read. The dbias slab pads to its rows (``dbias_slab_shape``)."""
    b, hq, nq, d = q.shape
    _, hkv, nkv, _ = k.shape
    dq_dtype = _grad_dtype(grad_q_storage_dtype, q.dtype)
    emit_dbias = emit_dbias and bias is not None
    window_left = int(window[0])
    window_right = -1 if is_causal else int(window[1])
    if q.device.type == "cpu":
        dq, dbias_full = _dq_plain(
            q, k, v, bias, do, lse, delta, scale=scale, emit_dbias=emit_dbias,
            is_causal=is_causal, causal_offset=causal_offset, dropout_p=dropout_p,
            seed=seed, softcap=softcap, window=(window_left, window_right), alibi=alibi,
        )
        dq = dq.to(dq_dtype)
    else:
        ops = _kernel_operands(q, k, v, do, bias, alibi, lse, delta)
        d_pad, dv_pad = ops.q.shape[-1], ops.v.shape[-1]
        out_f32, wt = _out_dtype(dq_dtype, q.dtype)
        dq = torch.empty((b, hq, nq, d_pad), dtype=wt, device=q.device)
        dbias_full = None
        if emit_dbias:
            dbias_full = torch.empty((b, hq, *dbias_slab_shape(nq, nkv, d_pad, dv_pad)),
                                     dtype=torch.float32, device=q.device)
        if ENV.device_log_level() >= 2:
            logger.info("dq launch route=%s D=%d Dv=%d dbias=%s", dq_plan(d_pad, dv_pad).route,
                        d_pad, dv_pad, emit_dbias)
        lib = _bwd_lib()
        with torch.cuda.device(q.device):
            err = lib.ffpa_bwd_dq(
                *ops.ptrs(), dq.data_ptr(),
                None if dbias_full is None else dbias_full.data_ptr(), *ops.extras(),
                int(q.dtype == torch.float16), out_f32, 0, b, hq, hkv, nq, nkv, d_pad, dv_pad,
                0 if dbias_full is None else dbias_full.shape[2],
                0 if dbias_full is None else dbias_full.shape[3],
                float(scale), float(softcap), int(causal_offset), window_left,
                0 if is_causal else window_right, *dropout_args(dropout_p, seed),
                torch.cuda.current_stream(q.device).cuda_stream,
            )
        _build.check(lib, err, "dq kernel launch")
        _dq_launch.launches += 1
        dq = dq[..., :d].to(dq_dtype)
        if dbias_full is not None:
            dbias_full = dbias_full[:, :, :nq, :nkv]
    dbias = None
    if dbias_full is not None:
        dbias = _dbias_from_ds(dbias_full, bias).to(bias.dtype)
    return dq, dbias


_dq_launch.launches = 0


# The dK/dV launcher's routes by the codes of its C entry points.
_DKDV_ROUTES = {1: "wgmma", 2: "wgmma_cluster"}
# Substrings of the dK/dV kernels' names (both routes), for timing filters.
DKDV_KERNELS = ("dkdv::kernel<",)


def dkdv_kernel_attrs(route: str, dtype=torch.bfloat16, ds_bits: int = 16) -> dict:
    """Registers a thread (at launch, before setmaxnreg) and local (spill)
    bytes of the dK/dV kernel of ``route`` ("wgmma" or "wgmma_cluster"),
    from cudaFuncGetAttributes; ``ds_bits`` 8 the instance that writes an
    e4m3 slab (bf16 only). Needs a card."""
    lib = _bwd_lib()
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    code = {name: num for num, name in _DKDV_ROUTES.items()}[route]
    err = lib.ffpa_bwd_dkdv_attrs(code, int(dtype == torch.float16), int(ds_bits),
                                  ctypes.byref(regs), ctypes.byref(local))
    _build.check(lib, err, "dkdv kernel attributes")
    return {"registers": regs.value, "local_bytes": local.value}


def dkdv_kernel_plan(d: int, dv: int) -> DkdvPlan:
    """The route and tiling the dK/dV launcher takes at head dims (d, dv)
    (padded to 64-column chunks), read from the library: what
    ``config.dkdv_plan`` mirrors. Needs a card."""
    lib = _bwd_lib()
    out = (ctypes.c_int * 64)()
    err = lib.ffpa_bwd_dkdv_plan(cdiv(d, D_CHUNK) * D_CHUNK, cdiv(dv, D_CHUNK) * D_CHUNK, out,
                                 len(out))
    _build.check(lib, err, "dkdv kernel plan")
    return dkdv_plan_from(out)


def dkdv_plan_from(out) -> DkdvPlan:
    """The DkdvPlan that ``out`` holds in the layout of ``ffpa_bwd_dkdv_plan``
    (which ``ffpa_varlen_bwd_dkdv_plan`` shares): route code, passes, KV
    rows, Q rows, stages, shared memory, ranks, each block's dK and dV
    columns, each rank's share."""
    passes, ranks = out[1], out[6]
    blocks = [tuple(out[7 + 4 * i:11 + 4 * i]) for i in range(ranks * passes)]
    n = 7 + 4 * ranks * passes
    rank_blocks = tuple(((out[n + 4 * r], out[n + 4 * r + 1]),
                         (out[n + 4 * r + 2], out[n + 4 * r + 3]))
                        for r in range(ranks if ranks == 2 else 0))
    return DkdvPlan(_DKDV_ROUTES[out[0]], passes, out[2], out[3], out[4], out[5],
                    tuple(bl[:2] for bl in blocks), tuple(bl[2:] for bl in blocks), rank_blocks)


# The recompute dQ launcher's routes by the codes of its C entry points.
_DQ_ROUTES = {1: "wgmma", 2: "wgmma_cluster"}
# Substrings of the recompute dQ kernel's name (both routes), for timing
# filters.
DQ_KERNELS = ("dq::wgmma_dq_kernel<",)


def dq_kernel_attrs(route: str, dtype=torch.bfloat16) -> dict:
    """Registers a thread (at launch, before setmaxnreg) and local (spill)
    bytes of the recompute dQ kernel of ``route`` ("wgmma" or
    "wgmma_cluster": the larger spill of its two dropout instantiations),
    from cudaFuncGetAttributes. Needs a card."""
    lib = _bwd_lib()
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    code = {name: num for num, name in _DQ_ROUTES.items()}[route]
    err = lib.ffpa_bwd_dq_attrs(code, int(dtype == torch.float16), ctypes.byref(regs),
                                ctypes.byref(local))
    _build.check(lib, err, "dq kernel attributes")
    return {"registers": regs.value, "local_bytes": local.value}


def dq_plan_from(out) -> DqPlan:
    """The DqPlan that ``out`` holds in the layout of ``ffpa_bwd_dq_plan``
    (which ``ffpa_varlen_bwd_dq_plan`` shares): route code, Q rows, KV
    rows, stages, shared memory, each consumer's dQ columns, each rank's
    share."""
    n = out[5]
    blocks = tuple((out[6 + 2 * i], out[7 + 2 * i]) for i in range(n))
    r0 = 7 + 2 * n
    rank_blocks = tuple(((out[r0 + 4 * r], out[r0 + 4 * r + 1]),
                         (out[r0 + 4 * r + 2], out[r0 + 4 * r + 3]))
                        for r in range(out[6 + 2 * n]))
    return DqPlan(_DQ_ROUTES[out[0]], out[1], out[2], out[3], out[4], blocks, rank_blocks)


def dq_kernel_plan(d: int, dv: int) -> DqPlan:
    """The route and tiling the recompute dQ launcher takes at head dims
    (d, dv) (padded to 64-column chunks), read from the library: what
    ``config.dq_plan`` mirrors. Needs a card."""
    lib = _bwd_lib()
    out = (ctypes.c_int * 32)()
    err = lib.ffpa_bwd_dq_plan(cdiv(d, D_CHUNK) * D_CHUNK, cdiv(dv, D_CHUNK) * D_CHUNK, out,
                               len(out))
    _build.check(lib, err, "dq kernel plan")
    return dq_plan_from(out)


# The from-S routes, indexed by the code the C entry points use.
_FROM_S_ROUTES = ("mma_sync", "wgmma", "wgmma_cluster")


def from_s_kernel_attrs(route: str) -> dict:
    """Registers a thread (at launch, before setmaxnreg) and local (spill)
    bytes of the from-S kernel of ``route`` ("wgmma", "wgmma_cluster" or
    "mma_sync", which holds dK in the kernel), from cudaFuncGetAttributes.
    Needs a card."""
    lib = _bwd_lib()
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.ffpa_bwd_from_s_attrs(_FROM_S_ROUTES.index(route), int(route == "mma_sync"),
                                    ctypes.byref(regs), ctypes.byref(local))
    _build.check(lib, err, "from-S kernel attributes")
    return {"registers": regs.value, "local_bytes": local.value}


def from_s_kernel_plan(dv: int, dk_in_kernel: bool) -> FromSPlan:
    """The route and tiling the from-S launcher takes at value head dim
    ``dv`` (padded to 64-column chunks), read from the library: what
    ``config.from_s_plan`` mirrors. Needs a card."""
    lib = _bwd_lib()
    out = (ctypes.c_int * 24)()
    err = lib.ffpa_bwd_from_s_plan(cdiv(dv, D_CHUNK) * D_CHUNK, int(dk_in_kernel), out, len(out))
    _build.check(lib, err, "from-S kernel plan")
    n = out[5]
    blocks = tuple((out[6 + 2 * i], out[7 + 2 * i]) for i in range(n))
    ranks = tuple((out[7 + 2 * n + 2 * r], out[8 + 2 * n + 2 * r]) for r in range(out[6 + 2 * n]))
    return FromSPlan(_FROM_S_ROUTES[out[0]], out[1], out[2], out[3], out[4], blocks, ranks)


def banded_kernel_attrs(dk: bool, dtype=torch.bfloat16, ds_bits: int = 16) -> dict:
    """Registers a thread (at launch, before setmaxnreg) and local (spill)
    bytes of the banded dK (``dk``) or banded dQ kernel, from
    cudaFuncGetAttributes; ``ds_bits`` 8 the banded dQ instance that reads
    an e4m3 slab (bf16 K). Needs a card."""
    lib = _bwd_lib()
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.ffpa_bwd_banded_attrs(int(dk), int(dtype == torch.float16), int(ds_bits),
                                    ctypes.byref(regs), ctypes.byref(local))
    _build.check(lib, err, "banded kernel attributes")
    return {"registers": regs.value, "local_bytes": local.value}


def banded_kernel_plan(d: int, ds_bits: int = 16) -> BandedPlan:
    """The tiling the banded kernels' launcher takes at head dim ``d``
    (padded to 64-column chunks) for a slab of ``ds_bits`` (8: banded dQ
    over an e4m3 slab), read from the library: what ``config.banded_plan``
    mirrors. Needs a card."""
    lib = _bwd_lib()
    out = (ctypes.c_int * 32)()
    err = lib.ffpa_bwd_banded_plan(cdiv(d, D_CHUNK) * D_CHUNK, int(ds_bits), out, len(out))
    _build.check(lib, err, "banded kernel plan")
    blocks = tuple((out[5 + 2 * i], out[6 + 2 * i]) for i in range(out[0]))
    return BandedPlan(blocks, out[1], out[2], out[3], out[4])


def _check_banded_slab(name, ds_full):
    """The banded kernels read the slab through a TMA tensor map: its row
    stride must be a multiple of 16 B (8 elements of 16 bits, 16 of e4m3)
    and its start 16 B-aligned."""
    if (ds_full.shape[3] * ds_full.element_size()) % 16 != 0 or ds_full.data_ptr() % 16 != 0:
        raise ValueError(f"{name}: the dS slab needs rows of a multiple of 16 bytes and a "
                         f"16-byte-aligned start (TMA), got {tuple(ds_full.shape)} "
                         f"{ds_full.dtype}")


def _banded_dq_from_ds(ds_full, k, config, *, scale, group, nq, nkv, causal_offset, dq_dtype):
    """Causal dQ = scale * dS K from the dS slab ([B, Hq, nq_pad, nkv_pad],
    zeros above the band), tiles above the diagonal skipped.
    ``causal_offset`` is the launch's local offset. The slab is in K's
    type, or float8_e4m3fn with bf16 K (widened exactly to bf16 before the
    product, in the kernel and in the plain version)."""
    del group
    b, hq, nq_pad, nkv_pad = ds_full.shape
    d = k.shape[-1]
    fp8 = ds_full.dtype == torch.float8_e4m3fn
    if fp8 and k.dtype != torch.bfloat16:
        raise TypeError("banded dQ: an e4m3 dS slab takes bf16 K")
    if ds_full.device.type == "cpu":
        return _banded_dq_plain(ds_full, k, scale=scale, nq=nq, nkv=nkv).to(dq_dtype)
    if not fp8 and (ds_full.dtype not in (torch.bfloat16, torch.float16)
                    or k.dtype != ds_full.dtype):
        raise TypeError("banded dQ: dS and K must share a bf16 or f16 dtype")
    hkv = k.shape[1]
    d_pad = cdiv(d, D_CHUNK) * D_CHUNK
    k_ = _pad_last(k, d_pad).contiguous()
    ds_ = ds_full.contiguous()
    _check_banded_slab("banded dQ", ds_)
    out_f32, wt = _out_dtype(dq_dtype, k.dtype)
    dq = torch.empty((b, hq, nq, d_pad), dtype=wt, device=k.device)
    if ENV.device_log_level() >= 2:
        plan = banded_plan(d_pad, ds_itemsize=ds_.element_size())
        logger.info("banded dq launch grid=(%d,%d,%d) col_blocks=%s D=%d ds=%s",
                    len(plan.col_blocks) * cdiv(nq, plan.rows), hq, b, plan.col_blocks, d_pad,
                    ds_.dtype)
    lib = _bwd_lib()
    with torch.cuda.device(k.device):
        err = lib.ffpa_bwd_banded_dq(
            ds_.data_ptr(), k_.data_ptr(), dq.data_ptr(), int(k.dtype == torch.float16),
            out_f32, 0,  # the row tile: not read, the launcher picks its own
            b, hq, hkv, nq, nkv, d_pad, nq_pad, nkv_pad,
            float(scale), int(causal_offset), 8 if fp8 else 16,
            torch.cuda.current_stream(k.device).cuda_stream,
        )
    _build.check(lib, err, "banded dq kernel launch")
    if fp8:
        _banded_dq_from_ds.fp8_launches += 1
    else:
        _banded_dq_from_ds.launches += 1
    return dq[..., :d].to(dq_dtype)


# launches: over a 16-bit slab; fp8_launches: over an e4m3 slab.
_banded_dq_from_ds.launches = 0
_banded_dq_from_ds.fp8_launches = 0


def _check_slab(name, s_pad, q):
    if s_pad.dtype != torch.bfloat16 or q.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the S-resident kernels take bf16 inputs and a bf16 slab")
    if not s_pad.is_contiguous():
        raise ValueError(f"{name}: the slab must be contiguous (it is updated in place)")


def _dkdv_from_s_launch(
    q, v, s_pad, do, lse, delta, seed, config, *, scale, is_causal, causal_offset,
    dropout_p, group, grad_kv_storage_dtype, softcap=0.0,
):
    """The S-resident dK/dV pass. ``s_pad`` is the forward's padded S
    residual [B, Hq, nq_pad, nkv_pad] (``flash_attention_forward(...,
    return_scores=True)``); the score gradient dS (softcap's factor
    included) overwrites it in place, zeros outside the band and on
    padding. Returns (dk, dv, ds_full): dk is None unless
    ``config.dkdv_dk_in_kernel``; ds_full is ``s_pad`` itself. K is not
    read (S is not recomputed). ``seed`` is the dropout seed."""
    b, hq, nq, d = q.shape
    hkv, nkv, dv_dim = v.shape[1], v.shape[2], v.shape[-1]
    nq_pad, nkv_pad = s_pad.shape[2], s_pad.shape[3]
    dk_in = config.dkdv_dk_in_kernel
    kv_dtype = _grad_dtype(grad_kv_storage_dtype, v.dtype)
    if q.device.type == "cpu":
        dk, dv, ds = _dkdv_from_s_plain(
            q, v, s_pad, do, lse, delta, scale=scale, is_causal=is_causal,
            causal_offset=causal_offset, dropout_p=dropout_p, seed=seed, softcap=softcap,
            dk_in_kernel=dk_in,
        )
        s_pad.copy_(ds)  # in place, as the kernel
        return None if dk is None else dk.to(kv_dtype), dv.to(kv_dtype), s_pad

    _check_slab("_dkdv_from_s_launch", s_pad, q)
    check_kernel_inputs("_dkdv_from_s_launch", q, v, do.to(q.dtype))
    d_pad, dv_pad = cdiv(d, D_CHUNK) * D_CHUNK, cdiv(dv_dim, D_CHUNK) * D_CHUNK
    plan = from_s_plan(dv_pad, dk_in)
    q_ = _pad_last(q, d_pad).contiguous()
    v_ = _pad_last(v, dv_pad).contiguous()
    do_ = _pad_last(do.to(q.dtype), dv_pad).contiguous()
    lse_, delta_ = lse.float().contiguous(), delta.float().contiguous()
    out_f32, wt = _out_dtype(kv_dtype, q.dtype)
    dk = torch.empty((b, hkv, nkv, d_pad), dtype=wt, device=q.device) if dk_in else None
    dv = torch.empty((b, hkv, nkv, dv_pad), dtype=wt, device=q.device)
    if ENV.device_log_level() >= 2:
        logger.info("dkdv_from_s launch route=%s kv_tiles=%d hkv=%d b=%d stages=%d "
                    "dk_in_kernel=%s D=%d Dv=%d", plan.route, nkv_pad // plan.kv_rows, hkv, b,
                    plan.stages, dk_in, d_pad, dv_pad)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        err = lib.ffpa_bwd_dkdv_from_s(
            q_.data_ptr(), v_.data_ptr(), do_.data_ptr(), lse_.data_ptr(), delta_.data_ptr(),
            s_pad.data_ptr(),
            None if dk is None else dk.data_ptr(), dv.data_ptr(), int(dk_in),
            plan.kv_rows,  # the launcher plans its own; a library of older sources reads it
            out_f32,
            b, hq, hkv, nq, nkv, d_pad, dv_pad, nq_pad, nkv_pad, float(scale), float(softcap),
            int(causal_offset), 0 if is_causal else -1, *dropout_args(dropout_p, seed),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, err, "dkdv_from_s kernel launch")
    _dkdv_from_s_launch.launches += 1
    if dk is not None:
        dk = dk[..., :d].to(kv_dtype)
    return dk, dv[..., :dv_dim].to(kv_dtype), s_pad


_dkdv_from_s_launch.launches = 0

# The from-S kernels' names as the profiler reports them: the mma.sync
# ``(anonymous namespace)::dkdv_from_s_kernel`` (dK in the kernel; in
# libraries built from older sources the template ``dkdv_from_s_kernel<...>``,
# which also took dK out above Dv 512, and before the wgmma route every dK-out
# launch) and ``from_s::wgmma_dkdv_from_s_kernel<DROP, SPLIT>`` (both dK-out
# routes). Timing tools match a kernel on any.
FROM_S_KERNELS = ("::dkdv_from_s_kernel", "wgmma_dkdv_from_s_kernel")


def _banded_dk_from_ds(ds_full, q, config, *, scale, group, nq, nkv, causal_offset, dk_dtype):
    """Causal dK = scale * dS^T Q [B, Hkv, Nkv, D] from the dS slab
    ([B, Hq, nq_pad, nkv_pad], zeros above the band), tiles above the
    diagonal skipped and the GQA group reduced in fp32."""
    del config
    b, hq, nq_pad, nkv_pad = ds_full.shape
    hkv, d = hq // group, q.shape[-1]
    if ds_full.device.type == "cpu":
        return _banded_dk_plain(ds_full, q, scale=scale, nq=nq, nkv=nkv, hkv=hkv).to(dk_dtype)
    _check_slab("_banded_dk_from_ds", ds_full, q)
    _check_banded_slab("banded dK", ds_full)
    d_pad = cdiv(d, D_CHUNK) * D_CHUNK
    q_ = _pad_last(q, d_pad).contiguous()
    out_f32, wt = _out_dtype(dk_dtype, q.dtype)
    dk = torch.empty((b, hkv, nkv, d_pad), dtype=wt, device=q.device)
    if ENV.device_log_level() >= 2:
        plan = banded_plan(d_pad)
        logger.info("banded dk launch grid=(%d,%d,%d) col_blocks=%s D=%d",
                    len(plan.col_blocks) * cdiv(nkv, plan.rows), hkv, b, plan.col_blocks, d_pad)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        err = lib.ffpa_bwd_banded_dk(
            ds_full.data_ptr(), q_.data_ptr(), dk.data_ptr(), out_f32,
            0,  # the row tile: not read, the launcher picks its own
            b, hq, hkv, nq, nkv, d_pad, nq_pad, nkv_pad,
            float(scale), int(causal_offset), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, err, "banded dk kernel launch")
    _banded_dk_from_ds.launches += 1
    return dk[..., :d].to(dk_dtype)


_banded_dk_from_ds.launches = 0


def _dk_from_ds(ds_full, q, *, scale, group, nq, nkv, dk_dtype):
    """dK = scale * dS^T Q from the dS slab, the GQA group reduced in fp32:
    one plain product, as JAX leaves it to XLA (the non-causal half of
    the dK-out-of-kernel dispatch)."""
    b, hq = ds_full.shape[:2]
    hkv = hq // group
    ds_c = ds_full[:, :, :nq, :nkv].float().reshape(b, hkv, group, nq, nkv)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds_c, q.float().reshape(b, hkv, group, nq, -1))
    return (dk * scale).to(dk_dtype)


def _fit_blocks_to_scores(config: BlockConfig, nq_pad: int, nkv_pad: int, d: int, dv: int,
                          dtype) -> BlockConfig:
    """The from-S variant that takes this S residual: dK stays in the
    kernel only where one column pass holds it (a second pass would read S
    after the first overwrote it with dS) and the block fits shared
    memory. The kernels' KV tiles (64 or 32) divide the slab's 64-column
    padding; their Q tiles (128 rows from-S, 64 banded dK) are bounded by
    the slab's rows, so any row padding of the forward's is taken."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    if nkv_pad % KV_TILE != 0:
        raise ValueError(f"S residual columns {nkv_pad} are not a multiple of {KV_TILE}")
    del nq_pad
    if config.dkdv_dk_in_kernel and not from_s_fits(d, dv, True, itemsize):
        config = replace(config, dkdv_dk_in_kernel=False)
    if not from_s_fits(d, dv, config.dkdv_dk_in_kernel, itemsize):
        raise ValueError(f"the from-S dK/dV kernel does not take D={d}, Dv={dv}")
    return config


def _dbias_from_ds(ds_c, bias):
    """Bias gradient: the cropped score gradient summed over the bias's
    broadcast axes."""
    axes = tuple(ax for ax, sz in enumerate(bias.shape) if sz == 1)
    dbias = ds_c.float()
    return dbias.sum(dim=axes, keepdim=True) if axes else dbias


def _dq_from_ds(ds_full, k, bias, *, scale, group, nq, nkv, dq_dtype):
    """dQ (and dbias) from the dS slab: one plain product, as JAX leaves
    it to XLA. An e4m3 slab is widened (exactly) with the rest."""
    hq = ds_full.shape[1]
    ds_c = ds_full[:, :, :nq, :nkv]
    dq = torch.einsum("bhqk,bhkd->bhqd", ds_c.float(), expand_kv_heads(k, hq).float())
    dq = (dq * scale).to(dq_dtype)
    dbias = None if bias is None else _dbias_from_ds(ds_c, bias).to(bias.dtype)
    return dq, dbias


# ---------------------------------------------------------------------------
# The backward
# ---------------------------------------------------------------------------


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    scale: float,
    is_causal: bool,
    dropout_p: float = 0.0,
    dropout_seed=0,
    config: Optional[BlockConfig] = None,
    grad_kv_storage_dtype: Optional[str] = None,
    grad_q_storage_dtype: Optional[str] = None,
    ds_handoff: Optional[bool] = None,
    softcap: float = 0.0,
    window: tuple = (-1, -1),
    alibi_slopes: Optional[torch.Tensor] = None,
    bias_grad: bool = True,
    scores: Optional[torch.Tensor] = None,
    extra_resident_bytes: int = 0,
):
    """Returns (dq, dk, dv, dbias or None).

    ``scores``: the forward's padded bf16 S residual
    (``flash_attention_forward(..., return_scores=True)``). With it the
    backward takes the S-resident tier: the from-S dK/dV kernel (no S
    recompute, no K read; dS overwrites ``scores`` in place), then dK from
    the slab when it is not in the kernel (banded dK under causal, one
    product otherwise), then dQ from the slab (banded dQ under causal, one
    product otherwise) and the bias gradient from the slab. Not defined
    with a sliding window, or softcap with a bias or ALiBi.

    ``extra_resident_bytes``: device memory this call cannot see from its
    own operands that is live while it runs (the S residual of the other
    heads under partial residency); it comes out of the dS-handoff gate's
    headroom.

    Otherwise two tiers, as in the JAX package:

    * dS handoff (``ds_handoff``; None = auto by the device-memory budget):
      the dK/dV kernel also writes the score gradient dS, and dQ is
      ``scale * dS K`` (the banded kernel under causal, a plain product
      otherwise). A slab larger than ``ENV.ds_handoff_limit_bytes()`` is
      cut into KV stripes; under causal each stripe drops the Q rows that
      cannot see it. Sliding windows, and softcap with a bias or ALiBi,
      always take the recompute tier.
    * recompute: the dK/dV kernel, then the dQ kernel (which also gives
      dbias).

    ``bias_grad=False`` skips the bias gradient (dbias is then None).
    """
    b, hq, nq, d = q.shape
    _, hkv, nkv, _ = k.shape
    dv_dim = v.shape[-1]
    group = hq // hkv
    if config is None:
        from .dispatch import pick_backward_config

        config = pick_backward_config(
            d=d, dv=dv_dim, nq=nq, nkv=nkv, dtype=q.dtype, has_bias=bias is not None,
            f16=torch.float16 in (q.dtype, do.dtype))
    grad_bias = bias if bias_grad else None

    window_left = int(window[0])
    window_right = -1 if is_causal else int(window[1])
    window_active = window_left >= 0 or window_right >= 0
    alibi = None
    if alibi_slopes is not None:
        alibi = torch.as_tensor(alibi_slopes, dtype=torch.float32, device=q.device)
        if alibi.ndim == 1:
            alibi = alibi[None].expand(b, hq)
    if scores is not None and window_active:
        raise ValueError(
            "S-resident backward is not defined for sliding windows (out-of-band S "
            "tiles are never written); callers gate save_scores off"
        )
    if scores is not None and softcap > 0.0 and (bias is not None or alibi is not None):
        raise ValueError(
            "S-resident backward with softcap requires a bias/alibi-free call (the "
            "tanh chain factor is recovered from the saved S)"
        )
    if window_active or (softcap > 0.0 and (bias is not None or alibi is not None)):
        # Windows want the band-skipping recompute kernels (an N^2 slab
        # defeats O(N * W)); softcap with additive terms needs the
        # kernel's split of dS (bias grad) and dS_qk (matmul grad).
        ds_handoff = False

    # Preprocess, before any cast: delta = rowsum(dO * O) in fp32.
    delta = (do.float() * o.float()).sum(dim=-1)
    causal_offset = nkv - nq
    kw = dict(scale=scale, is_causal=is_causal, dropout_p=dropout_p, group=group,
              softcap=softcap, alibi=alibi)

    if scores is not None:
        config = _fit_blocks_to_scores(config, scores.shape[2], scores.shape[3], d, dv_dim,
                                       q.dtype)
        dk, dv, ds_full = _dkdv_from_s_launch(
            q, v, scores, do, lse, delta, dropout_seed, config, scale=scale,
            is_causal=is_causal, causal_offset=causal_offset, dropout_p=dropout_p,
            group=group, grad_kv_storage_dtype=grad_kv_storage_dtype, softcap=softcap,
        )
        dq_dtype = _grad_dtype(grad_q_storage_dtype, q.dtype)
        if dk is None:
            dk_dtype = _grad_dtype(grad_kv_storage_dtype, k.dtype)
            ds_kw = dict(scale=scale, group=group, nq=nq, nkv=nkv)
            if is_causal:
                dk = _banded_dk_from_ds(ds_full, q, config, causal_offset=causal_offset,
                                        dk_dtype=dk_dtype, **ds_kw)
            else:
                dk = _dk_from_ds(ds_full, q, dk_dtype=dk_dtype, **ds_kw)
        if not is_causal:
            dq, dbias = _dq_from_ds(ds_full, k, grad_bias, scale=scale, group=group, nq=nq,
                                    nkv=nkv, dq_dtype=dq_dtype)
            return dq, dk, dv, dbias
        dq = _banded_dq_from_ds(ds_full, k, config, scale=scale, group=group, nq=nq, nkv=nkv,
                                causal_offset=causal_offset, dq_dtype=dq_dtype)
        dbias = None
        if grad_bias is not None:
            dbias = _dbias_from_ds(ds_full[:, :, :nq, :nkv], bias).to(bias.dtype)
        return dq, dk, dv, dbias

    itemsize = q.element_size()
    # fp8 dS storage only for bf16 inputs, a cotangent that is not fp16
    # (the 1e-2 contract leaves no room for its noise), no bias (dbias sums
    # the stored slab) and the opt-in set: the JAX package's rule. The slab,
    # and so the stripes and the auto gate, follow the stored width.
    if config.ds_store_bits == 8 and (
            q.dtype != torch.bfloat16 or do.dtype == torch.float16 or bias is not None
            or not ENV.allow_fp8_ds()):
        config = replace(config, ds_store_bits=16)
    ds_itemsize = config.ds_store_bits // 8
    limit = ENV.ds_handoff_limit_bytes()
    bq_h, bkv_h = DKDV_Q_TILE, DKDV_SLAB_COLS
    ds_bytes = b * hq * cdiv(nq, bq_h) * bq_h * cdiv(nkv, bkv_h) * bkv_h * ds_itemsize
    if ds_handoff is None:
        # The largest live slab (one stripe, <= limit) must fit the call's
        # device-memory headroom: the card minus this call's tensors (q, k,
        # v, do and their gradients) minus the model's margin.
        residents = itemsize * 2 * (q.numel() + k.numel() + v.numel() + do.numel()) + (
            0 if bias is None else bias.numel() * 4) + extra_resident_bytes
        headroom = ENV.hbm_bytes() - residents - ENV.hbm_model_margin_bytes()
        slab_limit = min(limit, max(headroom, 0))
        ds_handoff = slab_limit > 0 and (
            ds_bytes <= slab_limit or cdiv(ds_bytes, max(slab_limit, 1)) <= 8
        )
        limit = slab_limit if slab_limit > 0 else limit

    if not ds_handoff:
        dk, dv, _ = _dkdv_launch(
            q, k, v, bias, do, lse, delta, dropout_seed, config,
            causal_offset=causal_offset, grad_kv_storage_dtype=grad_kv_storage_dtype,
            emit_ds=False, window=window, **kw,
        )
        dq, dbias = _dq_launch(
            q, k, v, bias, do, lse, delta, dropout_seed, config,
            causal_offset=causal_offset, grad_q_storage_dtype=grad_q_storage_dtype,
            window=window, emit_dbias=grad_bias is not None, **kw,
        )
        return dq, dk, dv, dbias

    n_stripes = max(1, cdiv(ds_bytes, max(limit, 1)))
    stripe_cols = cdiv(cdiv(nkv, n_stripes), bkv_h) * bkv_h
    dq_dtype = _grad_dtype(grad_q_storage_dtype, q.dtype)
    single = stripe_cols >= nkv
    dq_acc = None if single else torch.zeros((b, hq, nq, d), dtype=torch.float32,
                                             device=q.device)
    dk_parts, dv_parts, dbias_parts = [], [], []
    for lo in range(0, nkv, stripe_cols):
        hi = min(nkv, lo + stripe_cols)
        # Causal: Q rows below lo - offset cannot see this stripe.
        row_start = 0
        if is_causal and lo > causal_offset:
            row_start = ((lo - causal_offset) // bq_h) * bq_h
        k_s, v_s = k[:, :, lo:hi], v[:, :, lo:hi]
        q_s, do_s = q[:, :, row_start:], do[:, :, row_start:]
        lse_s, delta_s = lse[:, :, row_start:], delta[:, :, row_start:]
        bias_s = bias
        if bias is not None:
            if bias.shape[3] != 1:
                bias_s = bias_s[:, :, :, lo:hi]
            if row_start and bias.shape[2] != 1:
                bias_s = bias_s[:, :, row_start:]
        local_off = causal_offset - lo + row_start
        dk_s, dv_s, ds_s = _dkdv_launch(
            q_s, k_s, v_s, bias_s, do_s, lse_s, delta_s, dropout_seed, config,
            causal_offset=local_off, grad_kv_storage_dtype=grad_kv_storage_dtype,
            emit_ds=True, col_offset=lo, row_offset=row_start, **kw,
        )
        dk_parts.append(dk_s)
        dv_parts.append(dv_s)
        nq_loc = nq - row_start
        dbias_s = None
        if is_causal:
            dq_s = _banded_dq_from_ds(
                ds_s, k_s, config, scale=scale, group=group, nq=nq_loc, nkv=hi - lo,
                causal_offset=local_off, dq_dtype=dq_dtype if single else torch.float32,
            )
            if grad_bias is not None:
                dbias_s = _dbias_from_ds(ds_s[:, :, :nq_loc, : hi - lo], bias)
        else:
            dq_s, dbias_s = _dq_from_ds(
                ds_s, k_s, bias_s if grad_bias is not None else None, scale=scale,
                group=group, nq=nq_loc, nkv=hi - lo,
                dq_dtype=dq_dtype if single else torch.float32,
            )
        del ds_s
        if single:
            dq_acc = dq_s
        else:
            dq_acc[:, :, row_start:] += dq_s
        if dbias_s is not None:
            dbias_parts.append((row_start, dbias_s))
    dq = dq_acc if single else dq_acc.to(dq_dtype)
    dk = dk_parts[0] if len(dk_parts) == 1 else torch.cat(dk_parts, dim=2)
    dv = dv_parts[0] if len(dv_parts) == 1 else torch.cat(dv_parts, dim=2)
    dbias = None
    if grad_bias is not None:
        dbias = _assemble_dbias(dbias_parts, bias)
    return dq, dk, dv, dbias


def _assemble_dbias(parts, bias):
    """The bias gradient from per-stripe parts [(row_start, part)]: column
    stripes side by side, each part's rows placed at its row_start."""
    if bias.shape[3] != 1:
        full_rows = bias.shape[2] != 1
        if not full_rows or all(rs == 0 for rs, _ in parts):
            return torch.cat([p for _, p in parts], dim=3).to(bias.dtype)
        cols = sum(p.shape[3] for _, p in parts)
        dbias = torch.zeros(bias.shape[:3] + (cols,), dtype=torch.float32, device=bias.device)
        off = 0
        for rs, p in parts:
            dbias[:, :, rs:rs + p.shape[2], off:off + p.shape[3]] = p.float()
            off += p.shape[3]
        return dbias.to(bias.dtype)
    dbias = None
    for rs, p in parts:
        if bias.shape[2] != 1 and rs:
            p = F.pad(p, (0, 0, rs, 0))
        dbias = p if dbias is None else dbias + p
    return dbias.to(bias.dtype)


__all__ = [
    "flash_attention_backward",
    "_dkdv_launch",
    "_dq_launch",
    "DQ_KERNELS",
    "_banded_dq_from_ds",
    "_dkdv_from_s_launch",
    "FROM_S_KERNELS",
    "_banded_dk_from_ds",
    "_dk_from_ds",
    "_fit_blocks_to_scores",
    "_dq_from_ds",
    "_dbias_from_ds",
    "_grad_dtype",
    "quantize_e4m3",
    "e4m3_steps",
    "E4M3_MAX",
]
