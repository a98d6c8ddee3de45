"""Model layer: the large-head-dim transformer LM and its serving path."""

from .convert import params_from_jax, random_params
from .generate import decode_step, generate, init_kv_cache, prefill
from .sampling import filter_logits, sample_logits
from .transformer import ModelConfig, Transformer

__all__ = [
    "ModelConfig",
    "Transformer",
    "params_from_jax",
    "random_params",
    "init_kv_cache",
    "prefill",
    "decode_step",
    "generate",
    "filter_logits",
    "sample_logits",
]
