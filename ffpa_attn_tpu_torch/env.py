"""Runtime environment flags and device selection for the PyTorch/CUDA port.

Only the readers this port uses are here, under the port's own
``FFPA_TORCH_*`` names. All flags are read lazily so tests can monkeypatch
``os.environ``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Union

import torch

_GIB = 1024**3


def _env_bool(name: str, default: bool = False) -> bool:
    val = os.environ.get(name)
    if val is None:
        return default
    return val.strip().lower() in ("1", "true", "yes", "on")


def _env_int(name: str, default: int) -> int:
    val = os.environ.get(name)
    if val is None:
        return default
    try:
        return int(val)
    except ValueError:
        return default


@dataclass(frozen=True)
class EnvSnapshot:
    """A frozen snapshot of the port's runtime flags (for logging and
    debugging), the counterpart of the JAX package's ``EnvSnapshot``. Its
    TPU-only fields have no counterpart here and are absent, not faked:
    ``interpret`` (Pallas interpret mode; the port's CPU tensors take each
    kernel's plain version instead) and ``vmem_limit_bytes`` (the TPU's
    VMEM; the Hopper kernels plan their own shared memory). The port's own
    flags follow the shared ones."""

    allow_small_d: bool
    skip_persistent_tuned_config: bool
    tuned_config_dir: str | None
    autotune_max_configs: int
    min_seqlen_q: int
    min_seqlen_kv: int
    ds_handoff_limit_bytes: int
    scores_residual_limit_bytes: int
    allow_fp8_ds: bool
    hbm_bytes: int
    hbm_model_margin_bytes: int
    scores_auto_assumed_layers: int
    device_log_level: int


class ENV:
    """Namespace of runtime env flags."""

    @staticmethod
    def allow_small_d() -> bool:
        """Allow the kernel path for D <= 256 (otherwise it falls back to the
        fp32 reference)."""
        return _env_bool("FFPA_TORCH_ALLOW_SMALL_D", False)

    @staticmethod
    def min_seqlen_q() -> int:
        """Below this Nq (but above the decode threshold of 8) the call falls
        back to the fp32 reference."""
        return _env_int("FFPA_TORCH_MIN_SEQLEN_Q", 128)

    @staticmethod
    def min_seqlen_kv() -> int:
        return _env_int("FFPA_TORCH_MIN_SEQLEN_KV", 128)

    @staticmethod
    def ds_handoff_limit_bytes() -> int:
        """Largest dS score-gradient slab the dS-handoff backward writes in
        one stripe (default 5 GiB); 0 disables the handoff."""
        return _env_int("FFPA_TORCH_DS_HANDOFF_LIMIT_BYTES", 5 * _GIB)

    @staticmethod
    def allow_fp8_ds() -> bool:
        """Opt-in for float8_e4m3fn storage of the dS-handoff slab
        (``BlockConfig.ds_store_bits = 8``), default off. It halves the
        slab's device-memory write and read; dQ carries the slab's
        rounding (dS is stored unscaled, as in the JAX package, so a small
        dS loses its digits). Unset, the backward stores 16-bit dS and the
        dispatcher proposes no fp8. The counterpart of the JAX package's
        ``FFPA_TPU_ALLOW_FP8_DS``."""
        return _env_bool("FFPA_TORCH_ALLOW_FP8_DS", False)

    @staticmethod
    def hbm_bytes() -> int:
        """Device memory the backward's headroom gates assume: an H100's
        80 GB (the port's own setting, not the TPU's 16 GiB)."""
        return _env_int("FFPA_TORCH_HBM_BYTES", 80 * 10**9)

    @staticmethod
    def hbm_model_margin_bytes() -> int:
        """Device memory left to co-resident model state (weights, optimizer,
        activations) when gating the dS slab."""
        return _env_int("FFPA_TORCH_HBM_MODEL_MARGIN_BYTES", 16 * _GIB)

    @staticmethod
    def scores_residual_limit_bytes() -> int:
        """Largest bf16 S residual (the padded [B, Hq, Nq, Nkv] score
        matrix of one attention call) the auto S-residency policy keeps for
        the S-resident backward (default 8 GiB); 0 disables auto
        residency. A budget below the whole residual buys partial head
        residency (``ops/attention.py`` ``_resident_head_count``)."""
        return _env_int("FFPA_TORCH_SCORES_RESIDUAL_LIMIT_BYTES", 8 * _GIB)

    @staticmethod
    def scores_auto_assumed_layers() -> int:
        """Copies of one call's S residual the auto policy assumes live at
        once (default 2): a stacked model keeps every layer's residual from
        its forward to its backward. Also divides the decode score
        residual's budget."""
        return _env_int("FFPA_TORCH_SCORES_AUTO_ASSUMED_LAYERS", 2)

    @staticmethod
    def skip_persistent_tuned_config() -> bool:
        """Kill-switch for the tuned-config store (``autotune/store.py``):
        set, every lookup misses and the dispatch takes its defaults (decode's
        memoised split count from the next ``store.clear_lookup_cache``).
        The counterpart of the JAX package's ``FFPA_TPU_SKIP_TUNED_CONFIG``."""
        return _env_bool("FFPA_TORCH_SKIP_TUNED_CONFIG", False)

    @staticmethod
    def tuned_config_dir() -> str | None:
        """A directory of tuned-config files read before the bundled one
        and written by the autotune CLI when it is given no
        ``--output-dir`` (``FFPA_TPU_TUNED_CONFIG_DIR``'s counterpart)."""
        return os.environ.get("FFPA_TORCH_TUNED_CONFIG_DIR") or None

    @staticmethod
    def autotune_max_configs() -> int:
        """Cap on the candidates the autotune times per task (0: all;
        ``FFPA_TPU_AUTOTUNE_MAX_CONFIGS``'s counterpart)."""
        return _env_int("FFPA_TORCH_AUTOTUNE_MAX_CONFIGS", 0)

    @staticmethod
    def device_log_level() -> int:
        """Kernel trace level: 0 off | 1 host-only (logger.py) | 2 one log
        line per kernel launch (grid, tile, shared memory) | 3 the same,
        plus the launch's split-KV layout for decode."""
        return _env_int("FFPA_TORCH_DEVICE_LOG_LEVEL", 0)

    @staticmethod
    def snapshot() -> EnvSnapshot:
        return EnvSnapshot(**{name: getattr(ENV, name)()
                              for name in EnvSnapshot.__dataclass_fields__})


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Asking for CUDA (explicitly or by default) on a machine with no
    card raises; nothing falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


__all__ = ["ENV", "EnvSnapshot", "resolve_device"]
