"""Whole-stream encode: host orchestration around the device kernels.

The stream is split into independent fixed-size blocks (the reference's block
loop, src/encoder.c:288-374), batched, and pushed through one jitted program
per batch (ops/device.encode_blocks: histogram -> tree -> codes -> packed
payload words).

Host work is limited to tree-header serialization and ordered concatenation
of (header, payload) per block.  Batch sizes are bucketed to keep the jit
cache small.  Blocks whose codes exceed the 32-bit device fast path
(physically impossible below ~2 MB blocks; adversarial only) fall back to the
host-exact codec, preserving bit-exactness unconditionally.
"""

from __future__ import annotations

import numpy as np

from .format import ArrayTree, DEFAULT_BLOCK_SIZE, pack_block, serialize_tree
from . import native
from .ops import device as dev
from .ops import hostref
from .utils.trace import annotate

# Blocks per device sub-batch, and sub-batches fused into one dispatch
# (ops/device.encode_blocks_many).
DEFAULT_BATCH_BLOCKS = 128
FUSE_BATCHES = 48

# Blocks encoded in this process, by path: "device", "host" (blocksize
# above the device path's 2 MiB limit) and "reencode" (device-flagged
# blocks — codes over 32 bits or payload over the word budget — encoded
# again on the host).
_BLOCK_COUNTS = {"device": 0, "host": 0, "reencode": 0}


def block_counts() -> dict[str, int]:
    """Blocks encoded in this process, by path."""
    return dict(_BLOCK_COUNTS)


def _bucket(n: int, lo: int) -> int:
    """Round up to a power of two (>= lo) to bound jit-cache size."""
    b = lo
    while b < n:
        b *= 2
    return b


def _bucket_blocks(nb: int) -> int:
    """Batch-size bucket: powers of two to 256, then multiples of 256.

    Pow2-only bucketing wastes up to 2x of device compute at large B (a
    1537-block stream would pad to 2048); multiples of 256 keep padding
    under 17% while the jit-key count stays bounded (<= 8 keys to 2048)."""
    if nb <= 256:
        return _bucket(nb, 1)
    return -(-nb // 256) * 256


def _words_per_block(N: int) -> int:
    """Payload word budget for blocksize N: 9 bits per byte.  A Huffman
    code is no longer on average than the 8-bit fixed code, and the unary
    root adds one bit to every codeword, so no block exceeds it."""
    return -(-9 * N // 32)


def _encode_batch(batch: np.ndarray, n_valid: np.ndarray) -> list[bytes]:
    """Encode a (B, N) uint8 batch; returns per-block wire bytes."""
    import jax.numpy as jnp

    with annotate("huff.encode.device"):
        res = dev.encode_blocks(jnp.asarray(batch), jnp.asarray(n_valid),
                                _words_per_block(batch.shape[1]))
    return _assemble_batch(batch, n_valid, res)


def _assemble_batch(batch: np.ndarray, n_valid: np.ndarray,
                    res) -> list[bytes]:
    """Transfer + assemble one device batch's results into wire bytes."""
    W = _words_per_block(batch.shape[1])
    payload, total_bits, left, right, root, overflow = res
    total_bits_h = np.asarray(total_bits)
    overflow_h = np.asarray(overflow)
    # Transfer only a bucketed prefix of the padded payload buffer: rows are
    # ragged and typical payloads are ~0.6N of the 1.125N budget.
    with annotate("huff.encode.d2h"):
        maxb = _bucket(max(1, (int(total_bits_h.max()) + 7) // 8), 1024)
        payload_h = np.asarray(payload[:, : min(maxb, 4 * W)])
        left_h = np.asarray(left)
        right_h = np.asarray(right)
        root_h = np.asarray(root)

    trees = lens_t = None
    if native.available():
        trees, lens_t = native.serialize_trees(left_h, right_h, root_h)

    live = n_valid > 0
    _BLOCK_COUNTS["reencode"] += int(np.sum(overflow_h & live))
    _BLOCK_COUNTS["device"] += int(np.sum(~overflow_h & live))
    if trees is not None and not overflow_h.any():
        # Whole-batch native assembly (reference emit order,
        # src/encoder.c:325-351): one pass instead of a per-block Python
        # loop — n_valid == 0 rows are padding and skipped natively.
        with annotate("huff.encode.assemble"):
            plens = (total_bits_h.astype(np.int64) + 7) // 8
            return [native.assemble_blocks(
                n_valid.astype(np.uint64), trees, lens_t, payload_h, plens)]

    out = []
    with annotate("huff.encode.assemble"):
        for b in range(len(batch)):
            nv = int(n_valid[b])
            if nv == 0:
                continue  # padding block
            if overflow_h[b]:
                out.append(hostref.encode_block(batch[b, :nv]))
                continue
            if trees is not None:
                tree = trees[b, : lens_t[b]]
            else:
                tree = serialize_tree(
                    ArrayTree(left_h[b], right_h[b], int(root_h[b]))
                )
            nbytes = (int(total_bits_h[b]) + 7) // 8
            out.append(pack_block(nv, tree, payload_h[b, :nbytes].tobytes()))
    return out


def encode(
    data: bytes | np.ndarray,
    blocksize: int = DEFAULT_BLOCK_SIZE,
    batch_blocks: int = DEFAULT_BATCH_BLOCKS,
    config=None,
) -> bytes:
    """Encode ``data`` into the libhuffman block format on the device.

    ``blocksize == 0`` treats the whole input as one block
    (src/encoder.c:163-165); the ragged tail becomes its own smaller block.
    Passing an :class:`~libhuffman_tpu.config.EncodeConfig` overrides the
    positional knobs (config.length caps the input; config.mesh routes the
    batches through the sharded path).
    """
    buf = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
    if config is not None:
        blocksize = config.blocksize
        batch_blocks = config.batch_blocks
        if config.length:
            buf = buf[: config.length]
        if config.mesh is not None:
            from .parallel.shard import encode_stream_sharded

            return encode_stream_sharded(buf, blocksize, config.mesh)
    n = len(buf)
    if n == 0:
        return b""
    if blocksize <= 0:
        blocksize = n
    if blocksize > (1 << 21):
        # Oversized single blocks (blocksize=0 on a large input, or an
        # explicit multi-MB blocksize): codes can exceed the 32-bit device
        # fast path beyond ~2 MB (ops/device.MAX_CODE_BITS) — take the
        # host-exact encoder, block by block.
        out = []
        for off in range(0, n, blocksize):
            out.append(hostref.encode_block(buf[off : off + blocksize]))
            _BLOCK_COUNTS["host"] += 1
        return b"".join(out)
    nblocks = -(-n // blocksize)

    import jax.numpy as jnp

    def make_batch(start_blk: int):
        nb = min(batch_blocks, nblocks - start_blk)
        B = _bucket_blocks(nb)
        batch = np.zeros((B, blocksize), dtype=np.uint8)
        n_valid = np.zeros(B, dtype=np.int32)
        for i in range(nb):
            off = (start_blk + i) * blocksize
            seg = buf[off : off + blocksize]
            batch[i, : len(seg)] = seg
            n_valid[i] = len(seg)
        return batch, n_valid

    starts = list(range(0, nblocks, batch_blocks))
    chunks: list[bytes] = []
    # Up to FUSE_BATCHES sub-batches per dispatch (tuple length is part of
    # the jit key, so group sizes stay few).
    for g in range(0, len(starts), FUSE_BATCHES):
        host_batches = [make_batch(s) for s in starts[g : g + FUSE_BATCHES]]
        if len(host_batches) == 1:
            chunks.extend(_encode_batch(*host_batches[0]))
            continue
        # Same-shape sub-batches fuse; a ragged tail batch (different B
        # bucket) dispatches separately rather than forcing a new key.
        shapes = {b.shape for b, _ in host_batches}
        fused = [bn for bn in host_batches if bn[0].shape == max(shapes)]
        rest = [bn for bn in host_batches if bn[0].shape != max(shapes)]
        with annotate("huff.encode.device"):
            results = dev.encode_blocks_many(
                tuple((jnp.asarray(b), jnp.asarray(nv)) for b, nv in fused),
                _words_per_block(blocksize))
        for (b, nv), res in zip(fused, results):
            chunks.extend(_assemble_batch(b, nv, res))
        for b, nv in rest:
            chunks.extend(_encode_batch(b, nv))
    return b"".join(chunks)
