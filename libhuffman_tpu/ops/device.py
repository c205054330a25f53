"""Batched device encode (plain JAX, compiled by XLA).

Everything here operates on a *batch* of independent fixed-size blocks — the
format's parallelism axis (SURVEY.md §2.5).  The reference's three sequential
hot loops (src/encoder.c: histogram per byte, two-minimum scan per merge
round, bit emission per bit) become:

  * ``histogram``      — byte counts as a per-block scatter-add of ones,
  * ``build_trees``    — fixed-trip (256-round) masked two-argmin over the
                         512-slot rate vectors, batched over blocks; replicates
                         the reference's exact tie-breaking (src/tree.c:318-414,
                         ties to the larger index via ``<=`` comparisons),
  * ``extract_codes``  — 32-step parent-pointer walk producing MSB-first
                         codeword values (fast path: code length <= 32 bits,
                         which covers every physically possible block up to
                         ~2 MB; deeper blocks are flagged for host fallback),
  * ``pack_words``     — every codeword lands at its exclusive-cumsum bit
                         offset, added into the one or two u32 words it
                         touches (replaces the sequential 1-byte bit
                         accumulator, src/bufio.c:16-32).

All shapes are static; ragged blocks are padded and masked via ``n_valid``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..format import ASCII_COUNT, HISTOGRAM_LEN

MAX_CODE_BITS = 32  # device fast-path limit; see module docstring
# Plain int, not jnp.int32: a module-level device scalar would initialize
# the XLA backend at import time, breaking jax.distributed.initialize for
# multihost workers (it must run before any backend touch).
_BIG = 1 << 30


def histogram(blocks: jax.Array, n_valid: jax.Array) -> jax.Array:
    """Byte-frequency histograms, (B, N) u8 -> (B, 512) i32: a per-block
    scatter-add of ones.

    Equivalent of src/histogram.c:74-100 with iota=1, length=512 — slots
    256..511 are zero scratch for the tree builder's internal-node rates.
    """
    B, N = blocks.shape
    rows = jax.lax.broadcasted_iota(jnp.int32, (B, N), 0)
    counts = jnp.zeros((B, ASCII_COUNT), jnp.int32).at[
        rows, blocks.astype(jnp.int32)].add(1)
    return _finish_histogram(counts, N, n_valid)


def _finish_histogram(counts, N: int, n_valid):
    # Padding positions are zero bytes; counting them and subtracting the
    # pad count from slot 0 is cheaper than masking every byte.
    counts = counts.at[:, 0].add(-(N - n_valid).astype(jnp.int32))
    return jnp.concatenate(
        [counts, jnp.zeros((counts.shape[0], HISTOGRAM_LEN - ASCII_COUNT),
                           jnp.int32)], axis=1)


# --------------------------------------------------------------------------
# Tree construction
# --------------------------------------------------------------------------

def build_trees(freqs: jax.Array):
    """Batched reference-exact tree build, (B, 512) i32 -> array trees.

    256 fixed merge rounds (enough for 255 binary merges + the unary root
    wrap).  Per round the two smallest non-zero rates are found with ties
    broken toward the larger slot index — the batched equivalent of the
    reference's running two-minimum scan (src/tree.c:329-352, `<=`
    comparisons make the last minimum win).  The sole survivor is wrapped in
    a parent with only a left child (tree.c:410-413): the unary-root
    invariant that gives every codeword its leading 0 bit.

    Returns (left, right, parent, pbit, root): (B,512) i32 x4 and (B,) i32
    (root == -1 for all-zero histograms, i.e. padding blocks).  ``pbit`` is
    each node's branch bit within its parent (0 = left child, 1 = right),
    recorded during the merge so codeword extraction needs no second lookup.
    """
    B = freqs.shape[0]
    iota = jax.lax.broadcasted_iota(jnp.int32, (B, HISTOGRAM_LEN), 1)

    def round_fn(i, st):
        rates, left, right, parent, pbit, root, done = st
        node = ASCII_COUNT + i
        active = rates > 0
        cnt = jnp.sum(active, axis=1)
        r1 = jnp.min(jnp.where(active, rates, _BIG), axis=1)
        i1 = jnp.max(jnp.where(active & (rates == r1[:, None]), iota, -1), axis=1)
        oh1 = iota == i1[:, None]
        act2 = active & ~oh1
        r2 = jnp.min(jnp.where(act2, rates, _BIG), axis=1)
        i2 = jnp.max(jnp.where(act2 & (rates == r2[:, None]), iota, -1), axis=1)
        oh2 = iota == i2[:, None]

        merge = ~done & (cnt >= 2)
        wrap = ~done & (cnt == 1)
        upd = merge | wrap

        rates = jnp.where(upd[:, None] & oh1, 0, rates)
        rates = jnp.where(merge[:, None] & oh2, 0, rates)
        new_rate = jnp.where(merge, r1 + r2, r1)
        col = jnp.where(upd, new_rate, rates[:, node])
        rates = jax.lax.dynamic_update_index_in_dim(rates, col, node, axis=1)

        lcol = jnp.where(upd, i1, left[:, node])
        left = jax.lax.dynamic_update_index_in_dim(left, lcol, node, axis=1)
        rcol = jnp.where(merge, i2, right[:, node])
        right = jax.lax.dynamic_update_index_in_dim(right, rcol, node, axis=1)
        parent = jnp.where(upd[:, None] & oh1, node, parent)
        parent = jnp.where(merge[:, None] & oh2, node, parent)
        pbit = jnp.where(merge[:, None] & oh2, 1, pbit)  # oh1 stays 0
        root = jnp.where(wrap, node, root)
        done = done | wrap | (cnt == 0)
        return rates, left, right, parent, pbit, root, done

    neg = jnp.full((B, HISTOGRAM_LEN), -1, jnp.int32)
    st = (
        freqs.astype(jnp.int32),
        neg, neg,
        jnp.full((B, HISTOGRAM_LEN), -1, jnp.int32),
        jnp.zeros((B, HISTOGRAM_LEN), jnp.int32),
        jnp.full((B,), -1, jnp.int32),
        jnp.zeros((B,), bool),
    )
    _, left, right, parent, pbit, root, _ = jax.lax.fori_loop(
        0, ASCII_COUNT, round_fn, st
    )
    return left, right, parent, pbit, root


# --------------------------------------------------------------------------
# Codeword extraction
# --------------------------------------------------------------------------

def extract_codes(parent: jax.Array, pbit: jax.Array):
    """Per-symbol codewords from parent pointers + recorded branch bits.

    (B,512) trees -> codes (B,256) u32, lens (B,256) i32, overflow (B,) bool.

    Walks each leaf toward the root for MAX_CODE_BITS steps; setting the
    t-th collected bit at position t leaves the root-most bit highest, so
    ``codes`` holds the MSB-first codeword value directly (matches the
    reference's reversed string walk, src/tree.c:12-47 + encoder.c:106-108).
    Each step is one per-block lookup of a packed (parent + 1, branch bit)
    word.  ``overflow`` flags blocks whose walk did not reach the root —
    those are re-encoded on the host fallback path (requires a multi-MB
    adversarial block; never hit on real data).
    """
    B = parent.shape[0]
    sym = jax.lax.broadcasted_iota(jnp.int32, (B, ASCII_COUNT), 1)
    # pp[n] = (parent[n] + 1) | pbit[n] << 10; parent -1 (root / absent) -> 0.
    pp = ((parent + 1).astype(jnp.uint32) | (pbit.astype(jnp.uint32) << 10))

    node = sym
    code = jnp.zeros((B, ASCII_COUNT), jnp.uint32)
    ln = jnp.zeros((B, ASCII_COUNT), jnp.int32)
    for _ in range(MAX_CODE_BITS):
        e = jnp.take_along_axis(pp, node, axis=1)
        p1 = (e & 0x3FF).astype(jnp.int32)
        has = p1 > 0
        bit = (e >> 10) & 1
        code = jnp.where(has, code | (bit << ln.astype(jnp.uint32)), code)
        ln = ln + has.astype(jnp.int32)
        node = jnp.where(has, p1 - 1, node)
    final = jnp.take_along_axis(pp, node, axis=1)
    overflow = jnp.any((final & 0x3FF) > 0, axis=1)
    return code, ln, overflow


# --------------------------------------------------------------------------
# Bit packing
# --------------------------------------------------------------------------

def symbol_layout(blocks: jax.Array, codes: jax.Array, lens: jax.Array,
                  n_valid: jax.Array):
    """Per-position codeword and code length for a block batch: a lookup
    into each block's 256-entry tables (zero length past n_valid)."""
    B, N = blocks.shape
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, N), 1)
    sym = blocks.astype(jnp.int32)
    C = jnp.take_along_axis(codes, sym, axis=1)
    L = jnp.where(pos < n_valid[:, None],
                  jnp.take_along_axis(lens, sym, axis=1), 0)
    return C, L


def pack_words(C: jax.Array, L: jax.Array, W: int) -> jax.Array:
    """Pack per-position codewords into (B, W) big-endian u32 words.

    C: (B, N) u32 MSB-first codeword values; L: (B, N) bit lengths
    (0 = padding position).  Each code, left-aligned, is added into the
    word at its exclusive-cumsum bit offset and the next one.  The codes'
    bits are disjoint, so the adds are ORs and the result is exact in any
    order.  Bits past 32 * W are dropped (the caller flags those blocks).
    """
    B, N = C.shape
    u32 = jnp.uint32
    ln = L.astype(u32)
    al = jnp.where(ln > 0, C << ((u32(32) - ln) & 31), u32(0))
    off = jnp.cumsum(L, axis=1) - L
    w = off >> 5
    s = (off & 31).astype(u32)
    rows = jax.lax.broadcasted_iota(jnp.int32, (B, N), 0)
    words = jnp.zeros((B, W), u32)
    words = words.at[rows, w].add(al >> s, mode="drop")
    # (al << 1) << (31 - s) instead of al << (32 - s): s == 0 would shift
    # by 32; it yields 0 there, as a code inside one word needs.
    return words.at[rows, w + 1].add((al << 1) << (u32(31) - s), mode="drop")


def words_to_bytes(words: jax.Array) -> jax.Array:
    """(B, W) big-endian u32 -> (B, 4W) u8 payload bytes."""
    B, W = words.shape
    b = jnp.stack(
        [(words >> 24), (words >> 16), (words >> 8), words], axis=-1
    ).astype(jnp.uint8)
    return b.reshape(B, 4 * W)


# --------------------------------------------------------------------------
# Jitted pipeline
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(2,))
def encode_blocks(blocks: jax.Array, n_valid: jax.Array, W: int):
    """Full batched encode: (B, N) u8 + valid lengths -> per-block payload
    bytes, bit totals, array trees, and per-block fallback flags.

    ``W`` is the payload word budget per block; blocks whose payload
    exceeds 32 * W bits, or whose codes exceed MAX_CODE_BITS, are flagged
    in ``overflow`` and the driver re-encodes them on the host.
    """
    freqs = histogram(blocks, n_valid)
    left, right, parent, pbit, root = build_trees(freqs)
    codes, lens, overflow = extract_codes(parent, pbit)
    total_bits = jnp.sum(freqs[:, :ASCII_COUNT] * lens, axis=1)
    C, L = symbol_layout(blocks, codes, lens, n_valid)
    words = pack_words(C, L, W)
    return (words_to_bytes(words), total_bits, left, right, root,
            overflow | (total_bits > 32 * W))


@functools.partial(jax.jit, static_argnums=(1,))
def encode_blocks_many(batches, W: int):
    """Several same-shape block batches in one dispatch; XLA frees each
    sub-batch's intermediates before the next runs."""
    return tuple(encode_blocks(b, nv, W) for (b, nv) in batches)
