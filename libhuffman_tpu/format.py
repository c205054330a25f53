"""The libhuffman wire format: constants, block headers, tree (de)serialization.

Stream layout (verified empirically against the compiled reference, SURVEY.md §2.9):

    repeated blocks, no magic / global header / checksum / EOF marker:
        u64  LE   block_original_length   (raw bytes encoded in this block)
        i16  LE   tree_length             (count of int16 entries, 0 < n <= 1024)
        i16[LE]   preorder tree           (-1 = missing child; leaf = idx, -1, -1)
        u8[ceil(total_code_bits/8)]       MSB-first bitstream, zero-padded per block

The u64 length is the reference's ``need_to_read`` written with ``sizeof(size_t)``
(src/encoder.c:325-328) — the format is de facto 64-bit little-endian.

Trees are represented here in *array form*: parallel int32 vectors indexed by slot
(0..255 = leaf slots keyed by symbol, 256.. = internal nodes in merge order), which is
the layout the device kernels produce and consume.  This module converts between array
form and the preorder int16 wire form.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

from .errors import BtreeOverflowError, ReadWriteError

# Constants mirroring include/huffman/common.h and tree.h.
HUF_1KIB = 1024
HUF_64KIB = 65536
HUF_128KIB = 131072
ASCII_COUNT = 256  # HUF_ASCII_COUNT, tree.h:9
BTREE_LEN = 1024  # HUF_BTREE_LEN, tree.h:12 (see BTREE_SER_MAX below)
# True worst-case serialized length: a block containing all 256 symbols has
# 512 nodes (256 leaves + 255 binary merges + the unary root) and therefore
# 2*512+1 = 1025 serialized entries.  The reference's 1024-entry buffer
# (src/encoder.c:270) silently overflows and its decoder then rejects the
# stream (verified against the compiled reference: encode succeeds with
# tree_length=1025, decode fails BTREE_OVERFLOW).  This framework encodes
# bit-exactly (emitting 1025 when required) and *accepts* up to 1025 on
# decode — a strict superset that can decode everything the reference
# encodes (SURVEY.md §7 item 8: documented deliberate fix).
BTREE_SER_MAX = 1025
HISTOGRAM_LEN = 512  # HUF_HISTOGRAM_LEN, tree.h:15
LEAF_MARK = -1  # HUF_LEAF_NODE

# Python-layer defaults (huffmanfile/huffmanfile.py:26-27).
DEFAULT_BLOCK_SIZE = 131072
DEFAULT_MEM_LIMIT = 262144

BLOCK_HEADER = struct.Struct("<Qh")  # u64 original length, i16 tree length


def pack_block(n_sym: int, tree_i16: np.ndarray, payload: bytes) -> bytes:
    """Assemble one self-contained block (src/encoder.c:325-351)."""
    return (
        BLOCK_HEADER.pack(n_sym, len(tree_i16))
        + np.asarray(tree_i16, dtype="<i2").tobytes()
        + payload
    )


class BlockHeader(NamedTuple):
    n_sym: int  # original (decoded) byte count of the block
    tree: np.ndarray  # int16 preorder serialization
    payload_off: int  # absolute offset of the first payload byte


def parse_block_header(buf: memoryview, off: int) -> BlockHeader:
    """Parse one block header starting at ``off``.

    Raises the same error conditions the reference decoder detects:
    short reads -> ReadWriteError (src/bufio.c:197-287 via decoder.c:220-252),
    tree_length outside [0, 1024] -> BtreeOverflowError (decoder.c:237-239).
    """
    if off + BLOCK_HEADER.size > len(buf):
        raise ReadWriteError("Failed to decode the data")
    n_sym, tree_length = BLOCK_HEADER.unpack_from(buf, off)
    if tree_length < 0 or tree_length > BTREE_SER_MAX:
        raise BtreeOverflowError("Failed to decode the data")
    tree_off = off + BLOCK_HEADER.size
    if tree_off + 2 * tree_length > len(buf):
        raise ReadWriteError("Failed to decode the data")
    tree = np.frombuffer(buf, dtype="<i2", count=tree_length, offset=tree_off)
    return BlockHeader(n_sym, tree, tree_off + 2 * tree_length)


class ArrayTree(NamedTuple):
    """Array-form Huffman tree over 512 slots.

    Slot s < 256 is the leaf for symbol s; slots >= 256 are internal nodes in
    creation (merge) order, matching the reference's node numbering
    (src/tree.c:303,406).  ``left``/``right`` hold child slot ids or -1.
    ``root`` is the root slot id (always an internal node with right == -1,
    the reference's unary-root invariant, src/tree.c:410-413) or -1 for an
    empty tree.
    """

    left: np.ndarray  # (512,) int32
    right: np.ndarray  # (512,) int32
    root: int


def serialize_tree(tree: ArrayTree) -> np.ndarray:
    """Preorder int16 serialization (src/tree.c:233-270).

    Emits node index, then the left subtree, then the right subtree; a missing
    child emits a single -1.  Node index of slot s is s itself (leaves carry
    their symbol, internal nodes their 256+ merge-order id).
    """
    out = np.empty(BTREE_SER_MAX, dtype=np.int16)
    pos = 0
    # Iterative preorder with an explicit stack; entries are slot ids or -1.
    stack = [tree.root]
    left, right = tree.left, tree.right
    while stack:
        node = stack.pop()
        out[pos] = LEAF_MARK if node < 0 else node
        pos += 1
        if node >= 0:
            stack.append(int(right[node]))
            stack.append(int(left[node]))
    return out[:pos].copy()


def deserialize_tree(buf: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Preorder deserialization (src/tree.c:138-227) into flat arrays.

    Returns ``(left, right, index, root)`` where nodes are numbered 0..n-1 in
    preorder appearance, ``left``/``right`` are child node ids or -1, and
    ``index`` is each node's serialized index value (for a leaf: the symbol).
    ``root`` is node 0, or -1 for an empty tree.

    Mirrors the reference's tolerance of truncated input: running out of
    entries mid-subtree yields missing (-1) children rather than an error;
    the walk later reports BTREE_CORRUPTED when it steps into one
    (decoder.c:69-71).  Extra trailing entries are ignored (tree.c:205).
    """
    buf = np.asarray(buf, dtype=np.int64)
    n = len(buf)
    # Worst case every entry is a node.
    left = np.full(max(n, 1), -1, dtype=np.int32)
    right = np.full(max(n, 1), -1, dtype=np.int32)
    index = np.zeros(max(n, 1), dtype=np.int32)
    count = 0

    # Iterative version of __huf_deserialize_tree (tree.c:139-208).  The
    # recursive structure is: parse(pos, limit) -> (node_id, consumed).
    # We emulate with an explicit stack of pending child links.
    def parse(pos: int, limit: int) -> tuple[int, int]:
        nonlocal count
        if limit < 1:
            return -1, 0
        v = int(buf[pos])
        if v == LEAF_MARK:
            return -1, 1
        me = count
        count += 1
        index[me] = v
        l, lc = parse(pos + 1, limit - 1)
        r, rc = parse(pos + 1 + lc, limit - 1 - lc)
        left[me] = l
        right[me] = r
        return me, 1 + lc + rc

    import sys

    old_limit = sys.getrecursionlimit()
    if n + 64 > old_limit:
        sys.setrecursionlimit(n * 2 + 128)
    try:
        root, _ = parse(0, n)
    finally:
        sys.setrecursionlimit(old_limit)
    return left[:count], right[:count], index[:count], root


def node_to_string(tree: ArrayTree, node: int, limit: int = 1024) -> str:
    """Leaf-to-root path of ``node`` as '0'/'1' characters.

    Debugging analogue of ``huf_node_to_string`` (src/tree.c:12-47): emits
    '0' when the walked node is its parent's left child, '1' otherwise, in
    leaf-to-root order (i.e. the codeword *reversed*, exactly like the
    reference, which re-reverses it during encoding at encoder.c:106-108);
    output clamps to ``limit`` characters like the caller-provided buffer.
    """
    parent = np.full(HISTOGRAM_LEN, -1, np.int32)
    for p in range(HISTOGRAM_LEN):
        if tree.left[p] >= 0:
            parent[tree.left[p]] = p
        if tree.right[p] >= 0:
            parent[tree.right[p]] = p
    out = []
    cur = node
    while parent[cur] >= 0 and len(out) < limit:
        out.append("0" if tree.left[parent[cur]] == cur else "1")
        cur = parent[cur]
    return "".join(out)


def describe_tree(tree_i16: np.ndarray) -> dict[int, str]:
    """Codebook of a serialized block tree: {symbol: MSB-first code string}.

    The introspection surface the reference exposes through
    ``huf_node_to_string`` (src/tree.c:12-47) — here one call dumps every
    leaf of a wire-format tree, root-to-leaf (ready-to-read) bit order.
    """
    left, right, index, root = deserialize_tree(np.asarray(tree_i16))
    codes: dict[int, str] = {}
    if root < 0:
        return codes
    stack = [(root, "")]
    while stack:
        node, path = stack.pop()
        l, r = int(left[node]), int(right[node])
        if l < 0 and r < 0:
            codes[int(index[node])] = path
            continue
        if r >= 0:
            stack.append((r, path + "1"))
        if l >= 0:
            stack.append((l, path + "0"))
    return codes


# A block's compressed payload length is NOT stored in the header: the
# reference decoder discovers it implicitly by walking bits until n_sym
# symbols are restored (decoder.c:34-96).  Block boundaries are therefore a
# sequential chain.  Two discovery strategies are provided by the decoders:
#
#   1. Sequential scan (exact, always correct): walk each block's bitstream
#      counting symbols — see ops/hostref.py and the native scanner.
#   2. Speculative parallel discovery: valid headers are statistically
#      self-identifying (u64 length with zero high bytes, tree_length in
#      [1, 1024]), so all *candidate* block starts can be found with one
#      vectorized pass, decoded in parallel, and the true chain resolved
#      afterwards — see decode.py.  Any chain break falls back to (1).


def find_candidate_headers(data: np.ndarray, max_n_sym: int = 1 << 32) -> np.ndarray:
    """Offsets of plausible block headers in a compressed stream.

    A plausible header has 1 <= n_sym < max_n_sym with the top four bytes of
    the u64 zero, and 1 <= tree_length <= 1025 (BTREE_SER_MAX — the native
    find_headers must stay in lockstep; tests/sanitize_native.py
    cross-checks them).  Every true mid-stream block
    start matches (the encoder never emits empty blocks, src/encoder.c:288;
    tree_length >= 5 in practice); false positives are possible but rare and
    merely cost wasted speculative work.

    ``data`` is a uint8 numpy array.  Returns ascending int64 offsets.
    """
    n = len(data)
    if n < BLOCK_HEADER.size:
        return np.zeros(0, dtype=np.int64)
    m = n - BLOCK_HEADER.size + 1  # last offset where a full header fits
    # Pure-u8 predicate chain (the previous int64 widening cost ~0.4 s per
    # scanned MB on this host — 10.9 s for a 25 MB stream, measured round
    # 3); chunked so a 10 GB stream never holds more than ~12x CHUNK of
    # temporaries.
    CHUNK = 1 << 26
    found: list[np.ndarray] = []
    for base in range(0, m, CHUNK):
        end = min(base + CHUNK, m)
        d = data[base : end + BLOCK_HEADER.size - 1]
        c = end - base
        lo_nz = (d[0:c] | d[1 : c + 1] | d[2 : c + 2] | d[3 : c + 3]) != 0
        hi_z = (d[4 : c + 4] | d[5 : c + 5] | d[6 : c + 6]
                | d[7 : c + 7]) == 0
        d8 = d[8 : c + 8]
        d9 = d[9 : c + 9]
        # 1 <= tree_len <= BTREE_SER_MAX (1025 = 0x0401), i16 LE:
        tree_ok = ((d9 < 4) & ((d8 | d9) != 0)) | ((d9 == 4) & (d8 <= 1))
        ok = lo_nz & hi_z & tree_ok
        hits = np.flatnonzero(ok)
        if len(hits) and max_n_sym < (1 << 32):
            lo = (d[0:c][hits].astype(np.int64)
                  | (d[1 : c + 1][hits].astype(np.int64) << 8)
                  | (d[2 : c + 2][hits].astype(np.int64) << 16)
                  | (d[3 : c + 3][hits].astype(np.int64) << 24))
            hits = hits[lo < max_n_sym]
        if len(hits):
            found.append(hits.astype(np.int64) + base)
    if not found:
        return np.zeros(0, dtype=np.int64)
    return np.concatenate(found)
