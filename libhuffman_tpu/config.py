"""Frozen codec configurations mirroring ``huf_config_t``.

The reference bundles every tunable into one value-copied struct
(/root/reference/include/huffman/config.h:10-36: length, blocksize,
reader_buffer_size, writer_buffer_size, reader, writer) with zero-value
semantics: blocksize == 0 treats the whole input as one block
(src/encoder.c:163-165) and zero buffer sizes mean unbuffered I/O
(src/bufio.c:58-68).  These dataclasses carry the same fields and defaults,
plus the device knobs (device batching, an optional ``jax.sharding.Mesh``
for the block axis) that replace the reference's reader/writer stream
pointers (SURVEY.md §5.6).

``memlimit`` follows the reference's observable semantics: it sizes the
decompressor's working buffers (reference huffmanfile.py:375-376) and is
*not* an enforced cap — the membuf grows past it instead of erroring, so no
limit-exceeded condition exists to raise (PARITY.md).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from .format import DEFAULT_BLOCK_SIZE, DEFAULT_MEM_LIMIT


@dataclasses.dataclass(frozen=True)
class EncodeConfig:
    """Encoder settings (huf_config_t analogue, encode side).

    length: bytes of input to encode; 0 = the whole input (the reference
        requires an explicit length; 0-means-all matches its Python layer).
    blocksize: bytes per independent block; 0 = single whole-input block
        (src/encoder.c:163-165).
    reader_buffer_size / writer_buffer_size: host I/O buffering hints
        (0 = unbuffered, src/bufio.c:58-68); arrays make them advisory here.
    batch_blocks: blocks per device dispatch.
    mesh: optional ``jax.sharding.Mesh`` to shard the block axis over
        (parallel/shard.py); None = single-device jit.
    """

    length: int = 0
    blocksize: int = DEFAULT_BLOCK_SIZE
    reader_buffer_size: int = 0
    writer_buffer_size: int = 0
    batch_blocks: int = 256
    mesh: Any = None

    def __post_init__(self):
        if self.length < 0 or self.blocksize < 0:
            raise ValueError("length and blocksize must be non-negative")
        if self.batch_blocks <= 0:
            raise ValueError("batch_blocks must be positive")


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Decoder settings (huf_config_t analogue, decode side).

    length: compressed bytes to consume; 0 = the whole input.
    memlimit: working-buffer sizing hint (see module docstring).
    use_device: route eligible blocks through the device kernels (host-exact
        fallback handles the rest either way).
    mesh: optional ``jax.sharding.Mesh``: every device plan of the stream
        runs under shard_map over the block axis
        (parallel/shard.decode_plans_sharded) — the parallelized twin of
        the reference's outer block loop (src/decoder.c:218-275).
    """

    length: int = 0
    memlimit: int = DEFAULT_MEM_LIMIT
    reader_buffer_size: int = 0
    writer_buffer_size: int = 0
    use_device: bool = True
    mesh: Any = None

    def __post_init__(self):
        if self.length < 0 or self.memlimit < 0:
            raise ValueError("length and memlimit must be non-negative")
