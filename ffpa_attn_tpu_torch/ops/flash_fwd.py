"""Forward attention: the CUDA kernel ``csrc/flash_fwd.cu`` and its plain
PyTorch version.

Replaces the Pallas ``_fwd_kernel`` of ``ffpa_attn_tpu/ops/flash_fwd.py``
(launched by its ``flash_attention_forward``).

Bound on an H100: operations. The forward does 2*B*Hq*Nq*Nkv*(D+Dv) flop,
halved for causal; at the serving prefill (B1 Hq8 N4096 D512 causal) that is
1.37e11 flop per layer, 0.14 ms at 989 TFLOP/s, while its bytes (q, k, v, o
once each, ~100 MB) take 0.03 ms at 3.35 TB/s.

Design against that bound (``csrc/flash_fwd.cu``): one TMA + wgmma block
(the reference's SM90 split-D forward) on two routes chosen by head dims
alone (``config.fwd_plan`` mirrors the launcher's plan; a build or launch
error raises, nothing retries another way). A producer warpgroup loads Q
once into resident 128 B-swizzled boxes and streams each KV tile's K and V
boxes through an mbarrier ring; two consumer warpgroups each compute S for
half of the tile's KV columns (``wgmma``), meet on the row maxima through a
small shared buffer, write their halves of P into one shared box and
accumulate P V into their own half of the fp32 O tile's columns. The
softmax runs in the accumulator's layout (a row in one quad of threads);
tiles with no feature inside the band skip the per-element feature code.

* D and Dv <= 512 ("wgmma"): one such block per 64 Q rows.
* D or Dv in (512, 1024] ("wgmma_cluster"): a thread-block cluster of two,
  each rank holding half of D's and half of Dv's boxes. Each rank computes a
  partial S over its D boxes and stores it into the partner's shared memory
  (distributed shared memory); both add the two partials in the same
  commutative fp32 sum, so both hold bit-identical S and so the same
  softmax, and each accumulates P V into its own Dv boxes. Every byte of
  Q, K and V is read once per cluster.

Whole KV tiles outside the causal / window band are never loaded, and
heads and query tiles fill the grid, the longest causal tiles first. Dropout is the hash of ``rng.py``, written into the kernel
(``csrc/rng.cuh``) so the backward replays its bits. With
``return_scores`` the softmax also stores each visited tile's scores as the
bf16 S residual of the S-resident backward (1 GiB at B1 Hq8 N8192, 0.32 ms
of writes at 3.35 TB/s).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ..env import ENV
from ..logger import init_logger
from . import _build
from .config import (
    D_CHUNK,
    FWD_MIN_STAGES,
    FWD_ROW_TILES,
    KV_TILE,
    FWD_MAX_HEAD_DIM,
    BlockConfig,
    FwdPlan,
    cdiv,
    fwd_fits,
    fwd_plan,
    ring_depth,
)
from .reference import DEFAULT_MASK_VALUE, expand_kv_heads, reference_attention

logger = init_logger(__name__)


def _pad_last(x: torch.Tensor, to: int) -> torch.Tensor:
    pad = to - x.shape[-1]
    return x if pad == 0 else F.pad(x, (0, pad))


def _bias_strides(bias: torch.Tensor, shape) -> tuple:
    """Element strides of ``bias`` broadcast to ``shape`` (0 on size-1 dims)."""
    return tuple(int(s) for s in bias.expand(*shape).stride())


def check_kernel_inputs(name: str, q, k, v) -> None:
    """What every kernel wrapper refuses before launching."""
    if q.device.type != "cuda":
        raise ValueError(
            f"{name}: the kernel takes CUDA tensors (got {q.device}); CPU "
            "tensors take the plain PyTorch version"
        )
    if q.dtype not in (torch.bfloat16, torch.float16):
        raise TypeError(f"{name}: kernel dtype must be bf16 or f16, got {q.dtype}")
    for t in (k, v):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: q, k, v must share dtype and device")


def dropout_args(dropout_p: float, dropout_seed) -> tuple:
    """(p, 1 / (1 - p), seed as uint32) for a kernel's dropout arguments."""
    p = float(dropout_p)
    return p, (1.0 / (1.0 - p)) if p > 0.0 else 1.0, int(dropout_seed) & 0xFFFFFFFF


_ARGTYPES = {
    "ffpa_flash_fwd": (
        [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
        + [ctypes.c_int] * 9 + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
        + [ctypes.c_float] * 2 + [ctypes.c_uint32] + [ctypes.c_void_p]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    ),
    "ffpa_flash_fwd_plan": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                            ctypes.c_int],
    "ffpa_flash_fwd_attrs": [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2,
}
# The library's route numbers (csrc/flash_fwd.cu fwd::WGMMA, fwd::CLUSTER).
_ROUTES = {1: "wgmma", 2: "wgmma_cluster"}
# Substrings of the forward kernel's name in a profiler's trace, on either
# route (both are instantiations of one template).
FWD_KERNELS = ("fwd::wgmma_fwd_kernel",)


def _fwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_fwd")
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name, None)  # None: a library built from older sources
        if fn is not None and fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def fwd_kernel_plan(d: int, dv: int, ring_cap: int = 0) -> FwdPlan:
    """The route and tiling the forward launcher takes at head dims (d, dv)
    (padded to 64-column chunks) and ``ring_cap`` (0: the plan's depth; the
    library refuses a cap below FWD_MIN_STAGES or past the plan's depth),
    read from the library: what ``config.fwd_plan`` mirrors. Needs a
    card."""
    lib = _fwd_lib()
    out = (ctypes.c_int * 32)()
    err = lib.ffpa_flash_fwd_plan(cdiv(d, D_CHUNK) * D_CHUNK, cdiv(dv, D_CHUNK) * D_CHUNK, out,
                                  len(out), ring_cap)
    _build.check(lib, err, "flash_fwd kernel plan")
    return fwd_plan_from(out)


def fwd_plan_from(out) -> FwdPlan:
    """A ``FwdPlan`` from the ints a plan entry point wrote in
    ``ffpa_flash_fwd_plan``'s layout (the packed varlen forward's
    ``ffpa_varlen_fwd_plan`` writes the same)."""
    n = 6 + 2 * out[5]
    blocks = tuple((out[6 + 2 * i], out[7 + 2 * i]) for i in range(out[5]))
    ranks = tuple(((out[n + 1 + 4 * r], out[n + 2 + 4 * r]),
                   (out[n + 3 + 4 * r], out[n + 4 + 4 * r])) for r in range(out[n]))
    return FwdPlan(_ROUTES[out[0]], out[1], out[2], out[3], out[4], blocks, ranks)


def fwd_kernel_attrs(route: str, dtype=torch.bfloat16) -> dict:
    """Registers a thread (at launch, before setmaxnreg) and local (spill)
    bytes of the forward kernel of ``route`` ("wgmma" or "wgmma_cluster"),
    from cudaFuncGetAttributes. Needs a card."""
    lib = _fwd_lib()
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    code = {name: num for num, name in _ROUTES.items()}[route]
    err = lib.ffpa_flash_fwd_attrs(code, int(dtype == torch.float16), ctypes.byref(regs),
                                   ctypes.byref(local))
    _build.check(lib, err, "flash_fwd kernel attributes")
    return {"registers": regs.value, "local_bytes": local.value}


def flash_attention_forward_plain(
    q, k, v, bias, *, scale, is_causal, dropout_p=0.0, dropout_seed=0,
    softcap=0.0, window=(-1, -1), alibi_slopes=None,
):
    """The kernel's function in plain PyTorch (fp32 math): (o, lse)."""
    hq = q.shape[1]
    return reference_attention(
        q, expand_kv_heads(k, hq), expand_kv_heads(v, hq), bias,
        is_causal=is_causal, scale=scale, dropout_p=dropout_p,
        dropout_seed=dropout_seed, return_lse=True, softcap=softcap,
        window=window, alibi_slopes=alibi_slopes,
    )


def scores_plain(q, k, bias, *, scale, is_causal, softcap=0.0, alibi_slopes=None,
                 nq_pad, nkv_pad):
    """The forward's S residual in plain PyTorch: the post-scale / softcap /
    ALiBi / bias / causal-mask scores in fp32 math, rounded to bf16 and
    padded to [B, Hq, nq_pad, nkv_pad]. Masked and padding entries hold
    DEFAULT_MASK_VALUE (the kernel leaves the tiles above the causal band
    unwritten; every consumer re-masks them)."""
    b, hq, nq, _ = q.shape
    nkv = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), expand_kv_heads(k, hq).float()) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    rows = torch.arange(nq, device=q.device)[:, None]
    cols = torch.arange(nkv, device=q.device)[None, :]
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32, device=q.device)
        s = s - slopes.expand(b, hq).reshape(b, hq, 1, 1) * (rows + nkv - nq - cols).abs().float()
    if bias is not None:
        s = s + bias.float()
    if is_causal:
        s = torch.where(cols <= rows + nkv - nq, s, DEFAULT_MASK_VALUE)
    return F.pad(s, (0, nkv_pad - nkv, 0, nq_pad - nq), value=DEFAULT_MASK_VALUE).to(
        torch.bfloat16)


def _fit_fwd_for_scores(config: BlockConfig, d: int, dv: int, dtype) -> BlockConfig:
    """The forward config that emits the S residual: the residual is stored
    from the softmax's registers and adds no shared memory, so the block
    that fits without it fits with it; raise where none does."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    d_pad, dv_pad = cdiv(d, D_CHUNK) * D_CHUNK, cdiv(dv, D_CHUNK) * D_CHUNK
    if not fwd_fits(config, d_pad, dv_pad, itemsize):
        raise ValueError(f"return_scores: block_q={config.block_q} does not fit D={d}, Dv={dv}")
    return config


def scores_padding(nq: int, nkv: int, d: int, dv: int, dtype,
                   config: Optional[BlockConfig] = None, **query) -> tuple:
    """(nq_pad, nkv_pad) of the S residual: the forward's row tile and its
    64-column KV tile. Without ``config``, the forward's pick, queried
    with ``query``'s fields (``pick_forward_config``: causal, has_bias,
    dropout, gqa, group); a tuned entry sets only the ring's cap, so the
    slab's rows are the default's."""
    if config is None:
        from .dispatch import pick_forward_config

        config = pick_forward_config(d=d, dv=dv, nq=nq, nkv=nkv, dtype=dtype, **query)
    config = _fit_fwd_for_scores(config.clamp(nq, nkv, FWD_ROW_TILES), d, dv, dtype)
    return cdiv(nq, config.block_q) * config.block_q, cdiv(nkv, KV_TILE) * KV_TILE


def flash_attention_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
    *,
    scale: float,
    is_causal: bool,
    dropout_p: float = 0.0,
    dropout_seed=0,
    config: Optional[BlockConfig] = None,
    return_scores: bool = False,
    softcap: float = 0.0,
    window: tuple = (-1, -1),
    alibi_slopes: Optional[torch.Tensor] = None,
):
    """Forward attention.

    Args:
      q: [B, Hq, Nq, D]; k: [B, Hkv, Nkv, D]; v: [B, Hkv, Nkv, Dv].
      bias: fp32 additive bias, 4-D broadcast-compact, or None.
      softcap / window / alibi_slopes: see ``reference_attention``.
      dropout_p / dropout_seed: hash dropout (``rng.py``), replayed by the
        backward kernels.
      config: the block config, ``pick_forward_config``'s where None (the
        tuned-config store's entry at these head dims); its
        ``fwd_ring_cap`` caps the kernel's ring (``config.ring_depth``).
      return_scores: also return the S residual of the S-resident backward
        (``scores_plain`` says what it holds): bf16 [B, Hq, nq_pad,
        nkv_pad], padded to the forward's row tile and its 64-column KV
        tile. Not defined with a sliding window.

    Returns:
      (o [B, Hq, Nq, Dv] in q.dtype, lse [B, Hq, Nq] fp32), plus the S
      residual with ``return_scores``. Queries are tail-aligned:
      ``causal_offset = Nkv - Nq``.

    CPU tensors run the plain version; CUDA tensors launch the kernel, or
    raise for what it does not take.
    """
    window_left = int(window[0])
    window_right = int(window[1])
    if return_scores and (window_left >= 0 or (not is_causal and window_right >= 0)):
        raise ValueError(
            "return_scores is not supported with sliding windows (out-of-band "
            "S tiles are never written); the caller must gate save_scores off"
        )
    b, hq, nq, d = q.shape
    _, hkv, nkv, _ = k.shape
    dv = v.shape[-1]
    if config is None:
        from .dispatch import head_layout, pick_forward_config

        config = pick_forward_config(d=d, dv=dv, nq=nq, nkv=nkv, dtype=q.dtype, causal=is_causal,
                                     has_bias=bias is not None, dropout=dropout_p > 0.0,
                                     **head_layout(hq, hkv))
    config = config.clamp(nq, nkv, FWD_ROW_TILES)
    s_pad = None
    if return_scores:
        nq_pad, nkv_pad = scores_padding(nq, nkv, d, dv, q.dtype, config)
    if q.device.type == "cpu":
        o, lse = flash_attention_forward_plain(
            q, k, v, bias, scale=scale, is_causal=is_causal,
            dropout_p=dropout_p, dropout_seed=dropout_seed, softcap=softcap,
            window=window, alibi_slopes=alibi_slopes,
        )
        if not return_scores:
            return o, lse
        return o, lse, scores_plain(q, k, bias, scale=scale, is_causal=is_causal,
                                    softcap=softcap, alibi_slopes=alibi_slopes,
                                    nq_pad=nq_pad, nkv_pad=nkv_pad)
    check_kernel_inputs("flash_attention_forward", q, k, v)
    if return_scores:
        s_pad = torch.empty((b, hq, nq_pad, nkv_pad), dtype=torch.bfloat16, device=q.device)
    d_pad, dv_pad = cdiv(d, D_CHUNK) * D_CHUNK, cdiv(dv, D_CHUNK) * D_CHUNK
    if max(d_pad, dv_pad) > FWD_MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_forward: the kernel takes D, Dv <= "
                         f"{FWD_MAX_HEAD_DIM}, got D={d}, Dv={dv}")
    if not fwd_fits(config, d_pad, dv_pad, q.element_size()):
        raise ValueError(
            f"flash_attention_forward: block_q={config.block_q} does not fit "
            f"D={d}, Dv={dv} (row tiles {FWD_ROW_TILES}, block_q * Dv <= 32768)"
        )
    q_ = _pad_last(q, d_pad).contiguous()
    k_ = _pad_last(k, d_pad).contiguous()
    v_ = _pad_last(v, dv_pad).contiguous()
    o = torch.empty((b, hq, nq, dv_pad), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, nq), dtype=torch.float32, device=q.device)

    bias_ptr, strides = None, (0, 0, 0, 0)
    if bias is not None:
        bias = bias.to(device=q.device, dtype=torch.float32)
        strides = _bias_strides(bias, (b, hq, nq, nkv))
        bias_ptr = bias.data_ptr()
    alibi_ptr = None
    if alibi_slopes is not None:
        alibi_slopes = torch.as_tensor(
            alibi_slopes, dtype=torch.float32, device=q.device
        ).expand(b, hq).contiguous()
        alibi_ptr = alibi_slopes.data_ptr()

    cap = config.fwd_ring_cap
    ring = ring_depth(fwd_plan(d_pad, dv_pad).stages, cap, FWD_MIN_STAGES) if cap else 0
    if ENV.device_log_level() >= 2:
        plan = fwd_kernel_plan(d_pad, dv_pad, ring)
        logger.info(
            "flash_fwd launch route=%s grid=(%d,%d,%d) rows=%d smem=%d D=%d Dv=%d",
            plan.route, hq * max(1, len(plan.rank_blocks)), b, cdiv(nq, plan.q_rows),
            plan.q_rows, plan.smem_bytes, d_pad, dv_pad,
        )
    lib = _fwd_lib()
    with torch.cuda.device(q.device):
        err = lib.ffpa_flash_fwd(
            q_.data_ptr(), k_.data_ptr(), v_.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bias_ptr, *strides, alibi_ptr,
            int(q.dtype == torch.float16), config.block_q,
            b, hq, hkv, nq, nkv, d_pad, dv_pad,
            float(scale), float(softcap), nkv - nq, window_left,
            0 if is_causal else window_right,  # causal is the band's right edge 0
            *dropout_args(dropout_p, dropout_seed),
            None if s_pad is None else s_pad.data_ptr(),
            0 if s_pad is None else s_pad.shape[2], 0 if s_pad is None else s_pad.shape[3],
            ring, torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, err, "flash_fwd kernel launch")
    flash_attention_forward.launches += 1
    if dv_pad != dv:
        o = o[..., :dv]
    return (o, lse) if s_pad is None else (o, lse, s_pad)


flash_attention_forward.launches = 0


__all__ = [
    "flash_attention_forward",
    "flash_attention_forward_plain",
    "fwd_kernel_plan",
    "fwd_kernel_attrs",
    "FWD_KERNELS",
    "scores_plain",
    "scores_padding",
    "check_kernel_inputs",
    "dropout_args",
]
