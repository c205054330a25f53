"""Data-parallel scaling over jax device meshes.

The libhuffman format's blocks are fully independent (own histogram, own
tree header, own zero-padded bitstream — SURVEY.md §2.5), so the block axis
is the sharding axis: no cross-block communication exists in the math, and
the only collectives are reductions/gathers of per-block *sizes* for ordered
stream assembly.
"""

from .shard import (  # noqa: F401
    block_mesh,
    encode_sharded,
)
