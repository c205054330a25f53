"""Multi-host codec: process-parallel encode/decode with ordered assembly.

SURVEY.md §5.8's plan made concrete.  Two layers of parallelism compose:

  * within a host, the block axis shards over local devices through
    ``jax.sharding.Mesh`` (parallel/shard.py);
  * across hosts, block *ranges* split by process; the only cross-host
    traffic is the all-gather of per-range compressed sizes (tiny) and the
    final ordered byte gather (``multihost_utils.process_allgather``).

Because every block is self-contained (own header, own tree, byte-aligned —
src/encoder.c:288-374), a contiguous range of blocks encodes to a
self-contained byte string, so ordered concatenation by process rank *is*
the stream: no other coordination exists.  An exclusive scan of the
gathered sizes gives every process its byte offset (the §5.8 recipe).

Usage (one call per process, same arguments everywhere):

    initialize(coordinator_address, num_processes, process_id)  # once
    stream = encode_stream_multihost(data, blocksize)   # same bytes on all
    plain = decode_stream_multihost(stream)             # same bytes on all

Single-process calls degrade to the local pipeline, so the same code runs
unchanged from a laptop to a cluster.
"""

from __future__ import annotations

import os

import numpy as np

import jax

from .. import decode as _decode_mod
from .. import encode as _encode_mod


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, **kwargs) -> None:
    """Bring up the JAX distributed runtime (no-op for a single process).

    On a GPU host, a process given no ``local_device_ids`` binds to local
    GPU ``process_id % (GPUs on the host)``: unbound, every process would
    reserve most of every card's memory."""
    if num_processes is None or num_processes <= 1:
        return
    n_gpus = _local_gpu_count()
    if n_gpus and "local_device_ids" not in kwargs:
        kwargs["local_device_ids"] = [process_id % n_gpus]
    jax.distributed.initialize(coordinator_address, num_processes,
                               process_id, **kwargs)


def _local_gpu_count() -> int:
    """GPUs this host shows a process, counted without starting a JAX
    backend (jax.distributed must initialize first)."""
    if os.environ.get("JAX_PLATFORMS", "").strip() == "cpu":
        return 0
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        return len([d for d in visible.split(",") if d.strip()])
    try:
        return len(os.listdir("/proc/driver/nvidia/gpus"))
    except OSError:
        return 0


# Cross-host traffic accounting (SURVEY.md §5.8: DCN bytes per process
# should scale ~ stream/nproc on the sizes-only paths; tests assert on it).
DCN_BYTES = 0


def _count_dcn(n: int) -> None:
    global DCN_BYTES
    DCN_BYTES += int(n)


def _allgather_sizes(local_size: int) -> np.ndarray:
    """All processes' sizes, in process order (tiny, DCN)."""
    from jax.experimental import multihost_utils

    nproc = jax.process_count()
    if nproc == 1:
        return np.asarray([local_size], np.int64)
    _count_dcn(8 * nproc)
    return np.asarray(
        multihost_utils.process_allgather(
            np.asarray([local_size], np.int64))
    ).reshape(nproc)


def _allgather_bytes(local: bytes) -> list[bytes]:
    """Gather one byte string from every process, in process order."""
    from jax.experimental import multihost_utils

    nproc = jax.process_count()
    if nproc == 1:
        return [local]
    sizes = _allgather_sizes(len(local))
    cap = int(sizes.max())
    padded = np.zeros(cap, np.uint8)
    padded[: len(local)] = np.frombuffer(local, np.uint8)
    _count_dcn(cap * nproc)
    gathered = np.asarray(
        multihost_utils.process_allgather(padded)
    ).reshape(nproc, cap)
    return [gathered[i, : sizes[i]].tobytes() for i in range(nproc)]


def _broadcast_bytes(local: bytes) -> bytes:
    """Rank 0's byte string on every process (others contribute nothing)."""
    from jax.experimental import multihost_utils

    nproc = jax.process_count()
    if nproc == 1:
        return local
    mine = local if jax.process_index() == 0 else b""
    sizes = _allgather_sizes(len(mine))
    cap = int(sizes[0])
    if cap == 0:
        # Degenerate rank-0 payload: a zero-length process_allgather may
        # fail inside the collective instead of propagating the normal
        # error path (advisor r4); the size exchange above already
        # synchronized every rank.
        return b""
    padded = np.zeros(cap, np.uint8)
    padded[: len(mine)] = np.frombuffer(mine, np.uint8)
    _count_dcn(cap * nproc)
    gathered = np.asarray(
        multihost_utils.process_allgather(padded)
    ).reshape(nproc, cap)
    return gathered[0].tobytes()


def _my_range(n_items: int) -> tuple[int, int]:
    """Contiguous [lo, hi) item range owned by this process."""
    nproc = jax.process_count()
    pid = jax.process_index()
    per = -(-n_items // nproc)
    lo = min(pid * per, n_items)
    return lo, min(lo + per, n_items)


def encode_stream_multihost_local(data, blocksize: int, mesh=None):
    """The §5.8 option-(b) recipe: encode shard-locally, gather SIZES only.

    Each process encodes its contiguous block range with the local pipeline
    and keeps the payload local; the only cross-host traffic is the
    all-gather of per-range compressed sizes (8 bytes/process).  Returns
    ``(local_segment, offset, total_size)`` — the caller writes its segment
    at ``offset`` (shared filesystem, object store, rank-ordered send), and
    the concatenation of segments in rank order IS the stream (every block
    is self-contained and byte-aligned, src/encoder.c:288-374).
    """
    buf = np.frombuffer(bytes(data), np.uint8)
    n = len(buf)
    if n == 0:
        return b"", 0, 0
    bs = blocksize if blocksize > 0 else n
    nblocks = -(-n // bs)
    lo, hi = _my_range(nblocks)
    local_bytes = buf[lo * bs : min(hi * bs, n)].tobytes()
    if mesh is not None and local_bytes:
        from .shard import encode_stream_sharded

        local_stream = encode_stream_sharded(
            np.frombuffer(local_bytes, np.uint8), bs, mesh
        )
    else:
        local_stream = _encode_mod.encode(local_bytes, bs) if local_bytes else b""
    sizes = _allgather_sizes(len(local_stream))
    pid = jax.process_index()
    offset = int(sizes[:pid].sum())
    return local_stream, offset, int(sizes.sum())


def encode_stream_multihost(data, blocksize: int, mesh=None) -> bytes:
    """Encode across processes; every process returns the full stream.

    The sizes-only split (:func:`encode_stream_multihost_local`) plus the
    full-payload all-gather the same-bytes-everywhere contract requires;
    callers who write rank-local segments should use the ``_local`` variant
    directly and skip the payload gather entirely.
    """
    local_stream, _off, total = encode_stream_multihost_local(
        data, blocksize, mesh)
    if total == 0:
        return b""
    return b"".join(_allgather_bytes(local_stream))


def decode_stream_multihost_local(stream: bytes) -> tuple[bytes, int, int]:
    """The §5.8 sizes-only recipe, decode side: every process runs the
    device work for ITS slice of header candidates and keeps the decoded
    bytes local; the only cross-host traffic is the candidate-offset
    broadcast plus the all-gather of (offset, consumed, produced) TABLES
    (24 bytes per resolved candidate).  Every process walks the chain over
    the merged table (host work, cheap, deterministic) and returns
    ``(local_segment, offset, total_size)`` — candidate ranges are
    contiguous in stream order, so the rank-ordered concatenation of
    segments IS the decoded output.

    Chain gaps (candidates nobody resolved: host-fallback blocks, missed
    candidates) are decoded host-exactly on every rank — each rank needs
    the block's consumed/produced sizes to continue its walk — and their
    bytes belong to the rank owning the preceding candidate.  Errors raise
    with reference semantics identically on every rank
    (src/decoder.c:218-275).
    """
    nproc = jax.process_count()
    if nproc == 1:
        out = _decode_mod.decode(stream)
        return out, 0, len(out)

    buf = np.frombuffer(stream, np.uint8)
    # Rank 0 runs the vectorized header scan once and broadcasts the
    # candidate offsets; other ranks only re-parse headers at those
    # offsets (identical results by construction — parse_block_header is
    # deterministic on the replicated stream bytes).
    if jax.process_index() == 0:
        cands = _decode_mod.scan_candidates(buf)
        _broadcast_bytes(
            np.asarray([c.off for c in cands], np.int64).tobytes())
    else:
        offs = np.frombuffer(_broadcast_bytes(b""), np.int64)
        cands = _decode_mod.scan_candidates(buf, offsets=offs)
    me = jax.process_index()
    lo, hi = _my_range(len(cands))
    _decode_mod._decode_candidates_device(buf, cands[lo:hi])

    # Sizes-only exchange: (offset, consumed, produced) per resolved
    # candidate — the payload bytes stay on the resolving rank.
    mine = [(c.off, c.result[1], len(c.result[0])) for c in cands[lo:hi]
            if c.result is not None]
    local_bytes = {c.off: c.result[0] for c in cands[lo:hi]
                   if c.result is not None}
    tables = _allgather_bytes(
        np.asarray(mine, np.int64).reshape(-1, 3).tobytes())
    results: dict[int, tuple[int, int, int]] = {}
    for rank, tbl in enumerate(tables):
        for off, cns, prod in np.frombuffer(tbl, np.int64
                                            ).reshape(-1, 3).tolist():
            results[int(off)] = (rank, int(cns), int(prod))

    # Ownership of chain pieces: resolved candidates belong to their
    # resolving rank; gap pieces to the rank owning the preceding
    # candidate (keeps the owner sequence monotone in chain order).
    cand_offs = [c.off for c in cands]
    per = -(-len(cands) // nproc) if cands else 1

    def owner_of_gap(off: int) -> int:
        import bisect

        idx = bisect.bisect_right(cand_offs, off) - 1
        return 0 if idx < 0 else min(idx // per, nproc - 1)

    cand_by_off = {c.off: c for c in cands}
    segment = []
    seg_offset = 0
    total = 0
    off = 0
    while off < len(stream):
        hit = results.get(off)
        if hit is not None:
            owner, consumed, produced = hit
            if owner == me:
                segment.append(bytes(local_bytes[off]))
            off = cand_by_off[off].payload_off + consumed
        else:
            # Gap: host-exact chain-prefix decode, every rank.
            piece, new_off = _decode_mod.decode_prefix(
                bytes(stream[off:]), use_device=False)
            if new_off == 0:
                # errors propagate with reference semantics on all ranks
                _decode_mod.decode(bytes(stream[off:]), use_device=False)
                break
            produced = len(piece)
            owner = owner_of_gap(off)
            if owner == me:
                segment.append(piece)
            off += new_off
        if owner < me:
            # Owners are monotone in chain order (contiguous candidate
            # ranges), so this sum is exactly my segment's byte offset.
            seg_offset += produced
        total += produced
    return b"".join(segment), seg_offset, total


def decode_stream_multihost(stream: bytes) -> bytes:
    """Decode across processes; every process returns the full output.

    The sizes-only split (:func:`decode_stream_multihost_local`) plus the
    rank-ordered payload all-gather the same-bytes-everywhere contract
    requires; callers who write rank-local segments should use the
    ``_local`` variant directly and skip the payload gather entirely.
    """
    if jax.process_count() == 1:
        return _decode_mod.decode(stream)
    segment, _off, total = decode_stream_multihost_local(stream)
    if total == 0:
        return b""
    return b"".join(_allgather_bytes(segment))
