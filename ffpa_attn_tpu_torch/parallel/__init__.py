"""Multi-GPU parallelism over ``torch.distributed``: head-sharded tensor
parallelism and sequence-sharded attention (the ring, its zigzag
load-balanced layout, halo exchange for sliding windows, Ulysses
all-to-all), with the mesh bootstrap and the ring's scaling projection.

Every rank runs the same program; the kernels run per rank on their shard
and the collectives between them are explicit (``_collectives.py``). The
model's dp x tp x sp train step is ``models.make_train_step(...,
mesh=...)``; ``python -m ffpa_attn_tpu_torch.parallel.dryrun --world N``
runs one step of it on N spawned ranks.
"""

from .analysis import ring_scaling_projection, two_host_report
from .mesh import initialize_distributed, make_mesh
from .ring import ring_attention, ring_attention_sharded
from .tp import head_parallel_attention, paged_head_parallel_decode
from .ulysses import ulysses_attention, ulysses_attention_sharded
from .window import window_attention, window_attention_sharded
from .zigzag import zigzag_ring_attention_sharded

__all__ = [
    "window_attention",
    "window_attention_sharded",
    "ring_scaling_projection",
    "two_host_report",
    "initialize_distributed",
    "make_mesh",
    "ring_attention",
    "ring_attention_sharded",
    "head_parallel_attention",
    "paged_head_parallel_decode",
    "ulysses_attention",
    "ulysses_attention_sharded",
    "zigzag_ring_attention_sharded",
]
