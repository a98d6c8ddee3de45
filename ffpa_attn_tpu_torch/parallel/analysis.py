"""Analytic ring-attention scaling model (roofline projection) for H100s.

One card cannot measure multi-card scaling, so this model projects it from
the ring's structure (``ring.py``), S ranks with the sequence N sharded to
N/S each:

* compute per ring step: the local tile pair's two products,
  ``t_step = 2 * B * Hq * (N/S)^2 * (d + dv) / rate``;
* communication per step: the K / V pair moves one hop; under GQA only the
  KV heads travel, ``bytes = 2 * B * Hkv * (N/S) * d * itemsize``.

The rotation for step r + 1 is issued while step r computes, so in steady
state every rank advances at ``max(t_step, t_slowest_hop)`` (a slow link
throttles the whole lock-step rotation) plus a fixed per-step latency.
Efficiency is the ideal (one card's time / S) over the projection.

The constants are specifications, not measurements:

* ``NVLINK_BW_BYTES``: NVLink 4 within a host, 900 GB/s per GPU in both
  directions, 450 GB/s one way (NVIDIA H100 SXM5 datasheet).
* ``NETWORK_BW_BYTES``: one ConnectX-7 NDR InfiniBand link between hosts,
  400 Gb/s = 50 GB/s one way (NVIDIA ConnectX-7 datasheet).
* ``STEP_LATENCY_S``: a model constant for a step's issue and
  synchronisation, not a reading.
* ``PEAK_BF16_FLOPS``: ``utils/profiling.py``'s dense bf16 peak of the
  H100 SXM (989 TFLOP/s); a measured rate replaces it where one is given.

With the mesh recipe of ``mesh.py`` (dp across hosts, sp within one), a
ring of up to 8 ranks stays on one host's NVLink; only rings that span
hosts pay ``NETWORK_BW_BYTES`` (``inter_host_hops``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..utils.profiling import PEAK_BF16_FLOPS

NVLINK_BW_BYTES = 450e9  # SPEC: NVLink 4, one way per GPU (H100 SXM5 datasheet)
NETWORK_BW_BYTES = 50e9  # SPEC: ConnectX-7 NDR 400 Gb/s, one way
STEP_LATENCY_S = 5e-6  # MODEL CONSTANT: a step's issue + synchronisation


@dataclass(frozen=True)
class RingProjection:
    chips: int
    t_step_ms: float  # per-step compute (per rank)
    t_hop_ms: float  # per-step slowest KV hop
    t_total_ms: float
    efficiency: float  # vs perfect linear scaling of the one-card time

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"S={self.chips}: step {self.t_step_ms:.2f} ms, "
            f"hop {self.t_hop_ms:.2f} ms -> total {self.t_total_ms:.2f} ms "
            f"({self.efficiency * 100:.1f}% scaling efficiency)"
        )


def ring_scaling_projection(
    *,
    b: int,
    h: int,
    n: int,
    d: int,
    dv: Optional[int] = None,
    hkv: Optional[int] = None,
    chips: int,
    itemsize: int = 2,
    tensor_core_efficiency: float = 0.85,
    flops_rate: Optional[float] = None,
    inter_host_hops: int = 0,
    causal: bool = False,
) -> RingProjection:
    """Project ring-attention forward scaling efficiency at ``chips`` ranks.

    ``hkv``: KV heads actually rotated (GQA rotates fewer bytes).
    ``inter_host_hops``: ring hops that cross the network between hosts
    (the JAX package's ``hops_over_dcn``, hops that cross a TPU slice);
    any such hop throttles the rotation to ``NETWORK_BW_BYTES``.
    ``causal`` models the zigzag schedule (half the pair FLOPs per step,
    the same rotated bytes).
    ``flops_rate``: a MEASURED one-card attention rate (FLOP/s), which
    replaces the spec estimate ``PEAK_BF16_FLOPS * tensor_core_efficiency``
    (the JAX package's ``mxu_flops`` / ``mxu_efficiency``).
    """
    dv = dv if dv is not None else d
    hkv = hkv if hkv is not None else h
    s = chips
    shard = n // s
    flops_per_step = 2 * b * h * shard * shard * (d + dv)
    if causal:
        flops_per_step //= 2
    rate = flops_rate if flops_rate else PEAK_BF16_FLOPS * tensor_core_efficiency
    t_step = flops_per_step / rate

    kv_bytes = 2 * b * hkv * shard * d * itemsize  # K and V blocks
    t_hop = kv_bytes / (NETWORK_BW_BYTES if inter_host_hops > 0 else NVLINK_BW_BYTES)

    period = max(t_step, t_hop) + STEP_LATENCY_S
    t_total = s * period

    t_one = (2 * b * h * n * n * (d + dv) // (2 if causal else 1)) / rate
    ideal = t_one / s
    eff = ideal / t_total
    return RingProjection(
        chips=s,
        t_step_ms=t_step * 1e3,
        t_hop_ms=t_hop * 1e3,
        t_total_ms=t_total * 1e3,
        efficiency=min(eff, 1.0),
    )


def two_host_report(
    b: int = 1, h: int = 32, n: int = 16384, d: int = 512,
    flops_rate: Optional[float] = None,
) -> list[RingProjection]:
    """Two hosts of 8 H100s under ``mesh.py``'s recipe: dp across the
    hosts, the sp ring within one host at S in {2, 4, 8}, MHA and 4:1 GQA,
    every hop on NVLink. ``flops_rate``: a measured one-card rate (see
    ``ring_scaling_projection``); the bench's ``scaling_projection`` leg
    passes the rate it just measured on the card."""
    out = []
    for hkv in (h, h // 4):
        for s in (2, 4, 8):
            out.append(
                ring_scaling_projection(
                    b=b, h=h, hkv=hkv, n=n, d=d, chips=s, flops_rate=flops_rate,
                )
            )
    return out


__all__ = ["RingProjection", "ring_scaling_projection", "two_host_report", "NVLINK_BW_BYTES",
           "NETWORK_BW_BYTES", "STEP_LATENCY_S"]
