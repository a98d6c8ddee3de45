"""Attention ops: the CUDA kernel wrappers, their plain versions, the fp32
oracle and the block-config cost model."""

from .config import BlockConfig, default_config
from .reference import reference_attention

__all__ = ["BlockConfig", "default_config", "reference_attention"]
