"""Model layer: the large-head-dim transformer LM, its serving paths
(``generate``, continuous batching over a dense or paged cache, the serving
engine) and its training step."""

from .convert import params_from_jax, params_to_jax, random_params
from .engine import ServingEngine
from .generate import decode_step, generate, init_kv_cache, prefill
from .sampling import filter_logits, sample_logits
from .serving import pack_prompts, prefill_packed, serve_batch, serve_batch_paged
from .transformer import (
    ModelConfig,
    Transformer,
    adamw,
    forward,
    loss_fn,
    make_train_step,
)

__all__ = [
    "ModelConfig",
    "Transformer",
    "params_from_jax",
    "params_to_jax",
    "random_params",
    "forward",
    "loss_fn",
    "adamw",
    "make_train_step",
    "init_kv_cache",
    "prefill",
    "decode_step",
    "generate",
    "pack_prompts",
    "prefill_packed",
    "serve_batch",
    "serve_batch_paged",
    "ServingEngine",
    "filter_logits",
    "sample_logits",
]
