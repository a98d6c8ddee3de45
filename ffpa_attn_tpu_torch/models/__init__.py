"""Model layer: the large-head-dim transformer LM, its serving paths
(``generate``, continuous batching over a dense or paged cache, the serving
engine, speculative decoding), its training step (single-card, or
dp x tp x sp over a mesh) and train-state checkpoints."""

from .checkpoint import latest_step, restore_train_state, save_train_state
from .convert import (
    gather_params_to_jax,
    gather_train_state,
    param_specs,
    params_from_jax,
    params_to_jax,
    random_params,
    shard_params,
    shard_train_state,
)
from .engine import ServingEngine
from .generate import decode_step, generate, init_kv_cache, prefill
from .sampling import filter_logits, sample_logits
from .serving import pack_prompts, prefill_packed, serve_batch, serve_batch_paged
from .speculative import speculative_accept, speculative_generate
from .transformer import (
    ModelConfig,
    Transformer,
    adamw,
    forward,
    init_params,
    loss_fn,
    make_train_step,
)

__all__ = [
    "ModelConfig",
    "Transformer",
    "init_params",
    "params_from_jax",
    "params_to_jax",
    "random_params",
    "param_specs",
    "shard_params",
    "gather_params_to_jax",
    "gather_train_state",
    "shard_train_state",
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
    "speculative_accept",
    "speculative_generate",
    "save_train_state",
    "restore_train_state",
    "latest_step",
    "filter_logits",
    "sample_logits",
]
