"""FFPA attention for large head dims, ported to PyTorch and CUDA on Hopper.

The PyTorch/CUDA counterpart of ``ffpa_attn_tpu``: the same public surface,
the same ``[B, H, N, D]`` layout, with the Pallas TPU kernels replaced by
kernels hand-written in CUDA C++ for ``sm_90a`` (``csrc/``, built with nvcc at
first use). CPU tensors run each kernel's plain PyTorch version.
"""

from .functional import Backend, CudaBackend, FFPAAttnMeta, PallasBackend, SDPABackend
from .interface import (
    ffpa_attn_func,
    ffpa_attn_varlen_func,
    patch_dot_product_attention,
    unpatch_dot_product_attention,
)
from .ops.paged import (
    PageAllocator,
    PagedKVCache,
    append_token,
    assign_sequence,
    fill_from_prefill,
    paged_decode_attention,
)
from .version import __version__

__all__ = [
    "ffpa_attn_func",
    "ffpa_attn_varlen_func",
    "patch_dot_product_attention",
    "unpatch_dot_product_attention",
    "Backend",
    "SDPABackend",
    "CudaBackend",
    "PallasBackend",
    "FFPAAttnMeta",
    "PageAllocator",
    "PagedKVCache",
    "append_token",
    "assign_sequence",
    "fill_from_prefill",
    "paged_decode_attention",
    "__version__",
]
