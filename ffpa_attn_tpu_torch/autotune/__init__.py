"""Persistent autotune of the port: the tuned-config store (``store``), its
search over the Hopper kernels' run-time knobs (``search``), the CLI
(``python -m ffpa_attn_tpu_torch.autotune``), its worker processes
(``engine``) and the verify tool (``verify``)."""

from .store import (
    ConfigKey,
    clear_lookup_cache,
    lookup_tuned_config,
    write_config_file,
)

__all__ = [
    "ConfigKey",
    "clear_lookup_cache",
    "lookup_tuned_config",
    "write_config_file",
]
