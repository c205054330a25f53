"""Host (numpy) implementation of the exact libhuffman block-codec semantics.

This module is the *semantic anchor* of the framework: a from-scratch, readable
re-derivation of the reference algorithm (verified against the compiled reference
as an oracle in tests/).  It serves three roles:

  1. ground truth for property-testing the device kernels,
  2. the fallback path for pathological blocks the fast device path rejects
     (code length > 32 bits — requires a block of ~Fib(34) ≈ 5.7 MB of
     adversarially distributed bytes, see SURVEY.md §7 item 5),
  3. the sequential stream scanner used when speculative parallel block
     discovery cannot be validated.

Algorithm citations refer to the reference sources (read-only, /root/reference).
"""

from __future__ import annotations

import numpy as np

from ..errors import BtreeCorruptedError, ReadWriteError
from ..format import (
    ASCII_COUNT,
    BLOCK_HEADER,
    HISTOGRAM_LEN,
    ArrayTree,
    deserialize_tree,
    pack_block,
    parse_block_header,
    serialize_tree,
)

_INF = np.int64(1) << 62


def histogram(block: np.ndarray) -> np.ndarray:
    """Byte-frequency histogram widened to 512 slots (src/histogram.c:74-100;
    the 256 extra slots are scratch for internal-node rates, src/tree.c:407)."""
    h = np.zeros(HISTOGRAM_LEN, dtype=np.int64)
    h[:ASCII_COUNT] = np.bincount(block, minlength=ASCII_COUNT)
    return h


def build_tree(freqs: np.ndarray) -> tuple[ArrayTree, np.ndarray]:
    """Frequency-sorted tree build replicating src/tree.c:292-427 exactly.

    Per merge round over the 512-slot rate array: the two smallest non-zero
    rates are combined, with ties broken toward the *larger* index (the
    reference's running two-minimum scan uses ``<=`` comparisons,
    tree.c:341-347, so the last index attaining the minimum wins; the second
    minimum is then the largest index attaining the minimum of the rest).
    New internal nodes take slots 256, 257, ... in merge order.  The final
    single survivor is wrapped in a parent with only a left child
    (tree.c:410-413), so every tree has a unary root and every codeword
    starts with a 0 bit.

    Returns the array tree and the parent-pointer vector.
    """
    rates = np.asarray(freqs, dtype=np.int64).copy()
    left = np.full(HISTOGRAM_LEN, -1, dtype=np.int32)
    right = np.full(HISTOGRAM_LEN, -1, dtype=np.int32)
    parent = np.full(HISTOGRAM_LEN, -1, dtype=np.int32)
    node = ASCII_COUNT
    root = -1
    while True:
        (nz,) = np.nonzero(rates)
        if len(nz) == 0:
            break  # empty histogram: no tree (encoder never hits this)
        m1 = rates[nz].min()
        i1 = nz[rates[nz] == m1].max()
        rest = nz[nz != i1]
        if len(rest) == 0:
            # Unary wrap: sole survivor becomes the left child of the root.
            left[node] = i1
            parent[i1] = node
            rates[i1] = 0
            root = node
            break
        m2 = rates[rest].min()
        i2 = rest[rates[rest] == m2].max()
        left[node] = i1
        right[node] = i2
        parent[i1] = node
        parent[i2] = node
        rates[i1] = 0
        rates[i2] = 0
        rates[node] = m1 + m2
        node += 1
    return ArrayTree(left, right, int(root)), parent


def code_table(tree: ArrayTree, parent: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-symbol codewords from the array tree.

    Returns ``(codes, lengths)`` — ``codes[s]`` holds the codeword for symbol
    ``s`` as an integer whose bit ``lengths[s]-1-i`` is the i-th emitted bit
    (MSB-first root-to-leaf path, 0 = left / 1 = right).  Matches the
    reference's leaf-to-root string walk (src/tree.c:12-47) re-reversed by
    the encoder (src/encoder.c:106-108).  Symbols absent from the tree get
    length 0.  Codes can exceed 64 bits only for blocks far larger than any
    physical memory, but uint64 may still overflow for adversarial
    histograms; use object dtype there via ``code_bits``.
    """
    codes = np.zeros(ASCII_COUNT, dtype=np.uint64)
    lengths = np.zeros(ASCII_COUNT, dtype=np.int32)
    for s in range(ASCII_COUNT):
        if parent[s] < 0:
            continue
        c = 0
        ln = 0
        nodeid = s
        while parent[nodeid] >= 0:
            p = parent[nodeid]
            bit = 0 if tree.left[p] == nodeid else 1
            # Walking leaf-to-root while shifting each bit ln positions up
            # leaves the root-most bit highest: c is already the MSB-first
            # (root-to-leaf) codeword value.
            c |= bit << ln
            ln += 1
            nodeid = p
        codes[s] = c
        lengths[s] = ln
    return codes, lengths


def pack_bits(block: np.ndarray, codes: np.ndarray, lengths: np.ndarray) -> bytes:
    """MSB-first bit-packing of the block's codewords (src/encoder.c:85-131),
    zero-padded to a whole byte per block (encoder.c:123-128).

    Vectorized per distinct symbol: all occurrences of a symbol place the
    same bit pattern at their cumsum offsets.
    """
    lens = lengths[block]
    offsets = np.concatenate(([0], np.cumsum(lens, dtype=np.int64)))
    total = int(offsets[-1])
    bits = np.zeros(((total + 7) // 8) * 8, dtype=np.uint8)
    for s in np.nonzero(np.bincount(block, minlength=ASCII_COUNT))[0]:
        ln = int(lengths[s])
        if ln == 0:
            continue
        sym_bits = np.array(
            [(int(codes[s]) >> (ln - 1 - i)) & 1 for i in range(ln)], dtype=np.uint8
        )
        starts = offsets[:-1][block == s]
        pos = starts[:, None] + np.arange(ln, dtype=np.int64)[None, :]
        bits[pos.ravel()] = np.tile(sym_bits, len(starts))
    return np.packbits(bits).tobytes()


def encode_block(block: np.ndarray) -> bytes:
    """One self-contained block: header + serialized tree + payload
    (src/encoder.c:288-374)."""
    tree, parent = build_tree(histogram(block))
    codes, lengths = code_table(tree, parent)
    payload = pack_bits(block, codes, lengths)
    return pack_block(len(block), serialize_tree(tree), payload)


def encode(data: bytes, blocksize: int = 0) -> bytes:
    """Whole-input encode: independent blocks of ``blocksize`` bytes (the
    ragged tail becomes its own smaller block).  ``blocksize == 0`` means one
    block spanning the input (src/encoder.c:163-165)."""
    buf = np.frombuffer(data, dtype=np.uint8)
    n = len(buf)
    if n == 0:
        return b""
    if blocksize <= 0:
        blocksize = n
    out = []
    for off in range(0, n, blocksize):
        out.append(encode_block(buf[off : off + blocksize]))
    return b"".join(out)


_walk_cache: dict = {}


def _walk_tables(tree_i16: np.ndarray):
    """Deserialize a wire tree and precompute the byte-level walk table.

    Returns (step, emit, root, n) where for flat node ids 0..n-1:
      step[node, byte] -> node reached after consuming 8 bits from ``node``
                          with emit-and-reset-to-root on every leaf hit,
      emit[node, byte] -> number of symbols emitted during those 8 bits,
    plus per-(node, byte) the emitted symbols; -2 marks a corrupt walk.
    Built vectorized in O(nodes * 256 * 8).
    """
    key = np.asarray(tree_i16, dtype=np.int16).tobytes()
    if key in _walk_cache:
        return _walk_cache[key]
    left, right, index, root = deserialize_tree(tree_i16)
    n = len(left)
    if root < 0:
        return None
    is_leaf = (left < 0) & (right < 0)
    # Bit-level transition with emit/reset semantics (decoder.c:58-91).
    # next1[node, bit]: step from non-leaf node; stepping into a missing
    # child -> -2 (corrupt).  Stepping into a leaf emits its index and
    # resets to root.
    lr = np.stack([left, right], axis=1).astype(np.int64)  # (n, 2)
    child_corrupt = lr < 0
    sym1 = np.where(child_corrupt, -1, np.where(is_leaf[np.clip(lr, 0, n - 1)], index[np.clip(lr, 0, n - 1)] & 0xFF, -1))
    next1 = np.where(child_corrupt, -2, np.where(is_leaf[np.clip(lr, 0, n - 1)], root, np.clip(lr, 0, n - 1)))
    # Compose 8 bit-steps over all (node, byte) pairs.
    states = np.repeat(np.arange(n, dtype=np.int64)[:, None], 256, axis=1)
    byte = np.arange(256, dtype=np.int64)[None, :]
    emit_count = np.zeros((n, 256), dtype=np.int64)
    emitted = np.full((n, 256, 8), -1, dtype=np.int64)
    corrupt_at = np.full((n, 256), -1, dtype=np.int64)  # bit idx of corruption
    for b in range(8):
        bit = (byte >> (7 - b)) & 1
        ok = states >= 0
        s_idx = np.clip(states, 0, n - 1)
        ns = np.where(ok, next1[s_idx, bit], states)
        sy = np.where(ok, sym1[s_idx, bit], -1)
        newly_corrupt = ok & (ns == -2)
        corrupt_at = np.where(newly_corrupt & (corrupt_at < 0), b, corrupt_at)
        did_emit = ok & (sy >= 0)
        for_rows = did_emit
        emitted[:, :, b] = np.where(for_rows, sy, -1)
        emit_count += for_rows
        states = ns
    tables = {
        "next8": states,  # (n,256): -2 once corrupted
        "emit_count": emit_count,
        "emitted": emitted,
        "corrupt_at": corrupt_at,
        "next1": next1,
        "sym1": sym1,
        "root": root,
        "is_leaf": is_leaf,
        "index": index,
    }
    if len(_walk_cache) > 64:
        _walk_cache.clear()
    _walk_cache[key] = tables
    return tables


def decode_block_payload(
    tree_i16: np.ndarray, payload: memoryview | np.ndarray, n_sym: int
) -> tuple[np.ndarray, int]:
    """Decode one block given its tree and the remaining stream bytes.

    Returns ``(symbols, payload_bytes_consumed)``.  Raises BtreeCorruptedError
    when the walk steps into a missing child before restoring ``n_sym``
    symbols (decoder.c:69-71) and ReadWriteError when the stream ends early
    (bufio.c read-through short-read, decoder.c:52-56 path).
    """
    syms, end_bit = decode_block_bits(tree_i16, payload, n_sym)
    return syms, (end_bit + 7) // 8


def decode_block_bits(
    tree_i16: np.ndarray, payload: memoryview | np.ndarray, n_sym: int
) -> tuple[np.ndarray, int]:
    """:func:`decode_block_payload` with the exact end: returns
    ``(symbols, end_bit)``, the bit offset after the last codeword.  The
    BtreeCorruptedError it raises carries ``bad_bit``, the payload bit that
    stepped into a missing child."""
    if n_sym == 0:
        return np.zeros(0, dtype=np.uint8), 0
    if n_sym > 8 * len(payload):
        # Each symbol consumes >= 1 bit: guaranteed short read; checking
        # before the output allocation guards adversarial u64 block lengths.
        raise ReadWriteError("Failed to decode the data")
    t = _walk_tables(tree_i16)
    if t is None:
        # NULL root with data to restore: the reference would crash; raise
        # the corruption error instead (SURVEY.md §7 item 8).
        raise BtreeCorruptedError("Failed to decode the data")
    buf = np.asarray(payload, dtype=np.uint8)
    out = np.empty(n_sym, dtype=np.uint8)
    restored = 0
    state = t["root"]
    next8, emit_count, emitted = t["next8"], t["emit_count"], t["emitted"]
    next1, sym1 = t["next1"], t["sym1"]
    pos = 0
    nbuf = len(buf)
    while True:
        if pos >= nbuf:
            raise ReadWriteError("Failed to decode the data")
        byte = int(buf[pos])
        pos += 1
        if restored + emit_count[state, byte] < n_sym and next8[state, byte] >= 0:
            # Whole byte consumed without finishing the block: table fast path.
            cnt = int(emit_count[state, byte])
            if cnt:
                out[restored : restored + cnt] = emitted[state, byte][
                    emitted[state, byte] >= 0
                ]
                restored += cnt
            state = int(next8[state, byte])
            continue
        # Final byte of the block (or a corrupt walk): bit-by-bit with
        # early stop, mirroring decoder.c:58-91.
        for b in range(8):
            bit = (byte >> (7 - b)) & 1
            ns = int(next1[state, bit])
            if ns == -2:
                err = BtreeCorruptedError("Failed to decode the data")
                err.bad_bit = 8 * (pos - 1) + b
                raise err
            sy = int(sym1[state, bit])
            state = ns
            if sy >= 0:
                out[restored] = sy
                restored += 1
                if restored >= n_sym:
                    return out, 8 * (pos - 1) + b + 1


def walk_progress(tree_i16: np.ndarray, payload, n_sym: int) -> int:
    """How many of ``n_sym`` symbols the available payload already yields.

    Used by the incremental decompressor to compute an exact lower bound on
    the bytes still needed (each remaining symbol consumes >= 1 bit), so it
    can skip hopeless decode attempts while never delaying a completable
    block.  Returns ``n_sym`` if the payload is sufficient; corruption is
    ignored here (the real decode attempt reports it).
    """
    return walk_progress_resume(tree_i16, payload, n_sym)[0]


def walk_progress_resume(tree_i16: np.ndarray, payload, n_sym: int,
                         state: tuple[int, int, int] | None = None
                         ) -> tuple[int, tuple[int, int, int]]:
    """Resumable :func:`walk_progress`: ``state = (node, restored, pos)``
    carries the measurement walk across incremental feeds so each payload
    byte is walked exactly once overall (O(n) total for byte-drip feeding).
    Node -1 freezes a walk that hit a missing child — the caller's decode
    attempt classifies the corruption."""
    t = _walk_tables(tree_i16)
    if t is None:
        return 0, (-1, 0, 0)
    buf = np.asarray(payload, dtype=np.uint8)
    node, restored, pos = state if state is not None else (t["root"], 0, 0)
    next8, emit_count = t["next8"], t["emit_count"]
    nbuf = len(buf)
    while node >= 0 and restored < n_sym and pos < nbuf:
        byte = int(buf[pos])
        pos += 1
        if next8[node, byte] < 0:
            node = -1  # corrupt walk: let the decode attempt classify it
            break
        restored += int(emit_count[node, byte])
        node = int(next8[node, byte])
    return min(restored, n_sym), (node, restored, pos)


def decode(data: bytes, length: int | None = None) -> bytes:
    """Sequential whole-stream decode (the reference's outer loop,
    src/decoder.c:201-287): consume blocks while fewer than ``length``
    compressed bytes have been processed."""
    buf = memoryview(data)
    if length is None:
        length = len(buf)
    out = []
    off = 0
    while off < length:
        hdr = parse_block_header(buf, off)
        syms, consumed = decode_block_payload(
            hdr.tree, np.frombuffer(buf, np.uint8, offset=hdr.payload_off), hdr.n_sym
        )
        out.append(syms.tobytes())
        off = hdr.payload_off + consumed
    return b"".join(out)


def scan_blocks(data: bytes, length: int | None = None):
    """Sequential block-boundary scan: yields (offset, BlockHeader,
    payload_nbytes) per block without keeping decoded output."""
    buf = memoryview(data)
    if length is None:
        length = len(buf)
    off = 0
    while off < length:
        hdr = parse_block_header(buf, off)
        _, consumed = decode_block_payload(
            hdr.tree, np.frombuffer(buf, np.uint8, offset=hdr.payload_off), hdr.n_sym
        )
        yield off, hdr, consumed
        off = hdr.payload_off + consumed
