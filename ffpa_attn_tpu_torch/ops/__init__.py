"""Attention ops: the CUDA kernel wrappers, their plain versions, the fp32
oracle and the block-config cost model."""
