"""Batched device decode: one Pallas kernel whose programs each walk a block.

Within a block, decode is sequential (reference src/decoder.c:34-96): the
codeword at bit p decides where the next one starts.  Each program of the
kernel (compiled through Triton) owns one block of a plan and follows its
own chain of codewords:

  window   the 32 bits at the block's bit position, built from two u32
           words of the block's staged payload row;
  resolve  a cascade of lookups into the block's tables (native
           build_decode_tables, TAB_ROWS rows of 128 u32 cells, two 16-bit
           entries per cell): a 1024-entry LUT on the first 10 bits, then
           up to five 3-bit stages for codes of up to 25 bits;
  emit     the symbol joins a u32 accumulator that is stored every four
           symbols; the position advances by the code length.

A walk stops after n_sym symbols, at a dead table entry (a missing child:
corruption), or at the plan's NP bit positions (a short read).  So the work
is one lookup chain per symbol, and nothing per bit position reaches device
memory.  Blocks whose trees the table builder rejects never get here: the
driver routes them to the host-exact walk.

Table entries: terminal = DONE(15) | aux(13:6) | len(5:0), where len == 0
marks a dead entry whose aux is the failing bit's offset in the codeword
(else aux is the symbol); non-terminal = the next stage's state id.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .backend import pallas_route

TAB_ROWS = 13
# Lookup stages beyond the 10-bit LUT: NS stages cover codes of at most
# MAXL_OF_NS[NS] bits.  NS is a static jit key.
MAXL_OF_NS = (10, 13, 16, 19, 22, 25)
_DONE = 1 << 15
# (first cell, state mask) of stage k = 1..5 in the packed table rows:
# stage 1 = 128 states x 3 bits, stage 2 = 64 states, stages 3-5 = 32.
_STAGES = ((512, 127), (1024, 63), (1280, 31), (1408, 31), (1536, 31))


def resolve(win, NS: int, load_cell):
    """Terminal table entry of the codeword at the top of the u32 window.

    ``load_cell(c, need)`` returns cell ``c`` of each block's table where
    ``need`` holds (None: every block); a block whose codeword has resolved
    needs no further loads."""
    u32 = jnp.uint32

    def entry(cell, i):
        return (cell >> ((i & 1) << 4)) & u32(0xFFFF)

    i = win >> u32(22)
    e = entry(load_cell(i >> 1, None), i)
    for k in range(1, NS + 1):
        base, smask = _STAGES[k - 1]
        i = ((e & u32(smask)) << 3) | ((win >> u32(22 - 3 * k)) & u32(7))
        need = e & u32(_DONE) == 0
        e = jnp.where(need, entry(load_cell(u32(base) + (i >> 1), need), i),
                      e)
    return e


def window(w0, w1, s):
    """The 32 bits at offset s (u32, 0..31) of the big-endian pair w0 w1.

    (w1 >> 1) >> (31 - s) instead of w1 >> (32 - s): s == 0 would shift by
    32, which is undefined."""
    return (w0 << s) | ((w1 >> 1) >> (jnp.uint32(31) - s))


def _walk_kernel(NP: int, OUTW: int, NS: int):
    u32, i32 = jnp.uint32, jnp.int32

    def kernel(words_ref, tables_ref, nsym_ref,
               out_ref, end_ref, corrupt_ref, bad_ref):
        # One block per program, held as a one-element vector.  A walk is
        # a chain of dependent loads, so what counts is how much of each
        # block's rows and tables stays in its SM's L1: on an H100, 32
        # blocks per program (one warp, a block per thread) ran a plan 2x
        # slower than one, and 64 ran it 6x slower.
        b = jnp.full((1,), pl.program_id(0), i32)
        n_sym = nsym_ref[b]

        def load_cell(c, need):
            cell = tables_ref.at[b, c.astype(i32)]
            if need is None:
                return cell[...]
            return pl_triton.load(cell, mask=need, other=0)

        def step(carry):
            pos, cnt, acc, dead, bad = carry
            act = ~dead & (cnt < n_sym) & (pos < NP)
            p = jnp.minimum(pos, NP - 1)
            w = p >> 5
            win = window(words_ref[b, w], words_ref[b, w + 1],
                         (p & 31).astype(u32))
            e = resolve(win, NS, load_cell)
            ln = (e & u32(63)).astype(i32)
            aux = (e >> u32(6)) & u32(255)
            hit = act & (ln == 0)
            ok = act & (ln > 0)
            acc = jnp.where(ok, acc | (aux << ((cnt & 3) << 3).astype(u32)),
                            acc)
            flush = ok & (((cnt & 3) == 3) | (cnt + 1 == n_sym))
            pl_triton.store(
                out_ref.at[b, jnp.minimum(cnt >> 2, OUTW - 1)], acc,
                mask=flush)
            return (jnp.where(ok, pos + ln, pos),
                    jnp.where(act, cnt + 1, cnt),
                    jnp.where(flush, u32(0), acc),
                    dead | hit,
                    jnp.where(hit, pos + aux.astype(i32), bad))

        def live(carry):
            pos, cnt, _acc, dead, _bad = carry
            act = ~dead & (cnt < n_sym) & (pos < NP)
            return jnp.max(act.astype(i32)) > 0

        zeros = jnp.zeros((1,), i32)
        pos, cnt, _acc, dead, bad = jax.lax.while_loop(
            live, step,
            (zeros, zeros, jnp.zeros((1,), u32), jnp.zeros((1,), bool),
             zeros))
        end_ref[b] = jnp.where(cnt >= n_sym, pos, NP)
        corrupt_ref[b] = dead.astype(i32)
        bad_ref[b] = bad

    return kernel


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def decode_blocks(words, tables, n_sym, NP: int, OUTW: int, NS: int):
    """Decode a batch of blocks, one Triton program per block.

    words:  (B, NP // 32 + 1) u32 big-endian payload words, zero past each
            block's staged payload (windows read one word ahead);
    tables: (B, TAB_ROWS, 128) u32 packed tables (native build);
    n_sym:  (B,) i32 symbols to restore; 0 marks a padding block.
    NP: static bit-position count; OUTW: static output u32 words per block
    (4 * OUTW >= max n_sym); NS: static lookup-stage count (codes of at
    most MAXL_OF_NS[NS] bits).

    Returns (out, end_bit, corrupt, bad_bit):
      out (B, 4*OUTW) u8 — decoded bytes, valid through n_sym[b] when the
                           block completed,
      end_bit (B,) i32  — bit offset after the n_sym-th codeword (NP when
                          the chain dies first: short read),
      corrupt (B,) bool — a dead entry was reached within n_sym symbols,
      bad_bit (B,) i32  — bit index of the failing bit when corrupt
                          (decoder.c:58-71 read-then-step order).
    """
    B = words.shape[0]
    out, end_bit, corrupt, bad_bit = pl.pallas_call(
        _walk_kernel(NP, OUTW, NS),
        grid=(B,),
        out_shape=(
            jax.ShapeDtypeStruct((B, OUTW), jnp.uint32),
            jax.ShapeDtypeStruct((B,), jnp.int32),
            jax.ShapeDtypeStruct((B,), jnp.int32),
            jax.ShapeDtypeStruct((B,), jnp.int32),
        ),
        name="huff_decode_walk",
        **pallas_route(num_warps=1),
    )(words.reshape(B, -1), tables.reshape(B, TAB_ROWS * 128),
      n_sym.astype(jnp.int32))
    # Symbol 4k + j sits in byte j of word k: a little-endian bitcast.
    out = jax.lax.bitcast_convert_type(out, jnp.uint8).reshape(B, 4 * OUTW)
    return out, end_bit, corrupt != 0, bad_bit


@functools.partial(jax.jit, static_argnums=(1,))
def decode_blocks_many(arrays, shapes):
    """All device plans of a stream in one dispatch.

    arrays: tuple of (words, tables, n_sym) triples; shapes: matching tuple
    of static (NP, OUTW, NS).  The plans run one after another; each
    returns its decode_blocks results."""
    return tuple(decode_blocks(w, t, n, *shp)
                 for (w, t, n), shp in zip(arrays, shapes))
