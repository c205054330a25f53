// Native host runtime for libhuffman_tpu.
//
// The device kernels own the compute path; this library owns the host-side
// per-block work that Python is too slow for at stream scale:
//
//   * batch preorder tree serialization  (encode header generation)
//   * batch preorder tree deserialization -> packed node tables (decode prep)
//   * sequential block walk             (exact fallback + boundary scanning)
//
// Built from scratch against the wire format specification (SURVEY.md §2.9);
// layout notes cite the reference implementation for parity, e.g. the
// preorder emit order (reference src/tree.c:233-270) and the decoder's
// read-then-step error ordering (reference src/decoder.c:52-91).
//
// Exposed as a plain C ABI for ctypes.

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// Batch preorder serialization.
//
// Array-form trees over 512 slots (slot<256 = leaf for that symbol, >=256 =
// internal in merge order). Emits node index, left subtree, right subtree;
// missing child emits -1. Returns per-tree serialized length.
// out stride is 1025 int16 (the true worst case: 512 nodes + 513 nulls).
// ---------------------------------------------------------------------------
void serialize_trees(const int32_t* left,   // [B, 512]
                     const int32_t* right,  // [B, 512]
                     const int32_t* root,   // [B]
                     int32_t B,
                     int16_t* out,          // [B, 1025]
                     int32_t* out_len)      // [B]
{
    for (int32_t b = 0; b < B; ++b) {
        const int32_t* L = left + (int64_t)b * 512;
        const int32_t* R = right + (int64_t)b * 512;
        int16_t* o = out + (int64_t)b * 1025;
        int32_t pos = 0;
        if (root[b] < 0) { out_len[b] = 0; continue; }
        // Explicit stack of slot ids; -1 entries emit the leaf marker.
        int32_t stack[1100];
        int32_t sp = 0;
        stack[sp++] = root[b];
        while (sp > 0) {
            int32_t node = stack[--sp];
            if (node < 0) { o[pos++] = -1; continue; }
            o[pos++] = (int16_t)node;
            stack[sp++] = R[node];
            stack[sp++] = L[node];
        }
        out_len[b] = pos;
    }
}

// ---------------------------------------------------------------------------
// Preorder deserialization into the packed node-table form the decode kernel
// consumes: left(11) | right(11) | symcode(9), symcode: 0..255 leaf symbol,
// 256 internal, 257 trap. Node 0 is the root; missing children point at the
// trap node (nt-1). Returns node count (<0 on overflow) and tree depth.
//
// Iterative emulation of the recursive grammar: node := index left right,
// where -1 terminates a branch (reference src/tree.c:139-208; truncated
// input yields missing children, not an error).
// ---------------------------------------------------------------------------
static int32_t deser_rec(const int16_t* buf, int32_t pos, int32_t limit,
                         uint32_t* nodes, int32_t* count, int32_t nt,
                         int32_t* consumed, int32_t depth, int32_t* maxdepth)
{
    if (limit < 1) { *consumed = 0; return nt - 1; }
    int16_t v;  // trees start at arbitrary stream offsets: unaligned load
    memcpy(&v, reinterpret_cast<const char*>(buf) + 2 * (size_t)pos, 2);
    if (v == -1) { *consumed = 1; return nt - 1; }
    if (*count >= nt - 1) { *consumed = 1; return nt - 1; }  // overflow guard
    int32_t me = (*count)++;
    if (depth > *maxdepth) *maxdepth = depth;
    int32_t lc = 0, rc = 0;
    int32_t l = deser_rec(buf, pos + 1, limit - 1, nodes, count, nt, &lc,
                          depth + 1, maxdepth);
    int32_t r = deser_rec(buf, pos + 1 + lc, limit - 1 - lc, nodes, count, nt,
                          &rc, depth + 1, maxdepth);
    uint32_t symcode;
    bool is_leaf = (l == nt - 1) && (r == nt - 1);
    if (is_leaf) symcode = (uint32_t)(v & 0xFF);
    else symcode = 256u;
    nodes[me] = (uint32_t)l | ((uint32_t)r << 11) | (symcode << 22);
    *consumed = 1 + lc + rc;
    return me;
}

// Returns: node count, or -1 if the tree has no root. depth_out gets the
// max root-to-leaf edge count (code length bound).
int32_t deserialize_tree(const int16_t* buf, int32_t len,
                         uint32_t* nodes,  // [nt]
                         int32_t nt,
                         int32_t* depth_out)
{
    // Fill with trap self-loops.
    uint32_t trap = (uint32_t)(nt - 1) | ((uint32_t)(nt - 1) << 11)
                  | (257u << 22);
    for (int32_t i = 0; i < nt; ++i) nodes[i] = trap;
    int32_t count = 0, consumed = 0, maxd = 0;
    int32_t root = deser_rec(buf, 0, len, nodes, &count, nt, &consumed, 0,
                             &maxd);
    *depth_out = maxd;  // deepest leaf's node-depth == max code length
    if (root == nt - 1 || count == 0) return -1;
    return count;
}

// Batch variant: trees packed back-to-back with offsets/lengths.
void deserialize_trees(const int16_t* bufs, const int64_t* offs,
                       const int32_t* lens, int32_t B,
                       uint32_t* nodes,     // [B, nt]
                       int32_t nt,
                       int32_t* counts,     // [B]
                       int32_t* depths)     // [B]
{
    for (int32_t b = 0; b < B; ++b) {
        counts[b] = deserialize_tree(bufs + offs[b], lens[b],
                                     nodes + (int64_t)b * nt, nt, &depths[b]);
    }
}

// ---------------------------------------------------------------------------
// Sequential block walk: decode up to n_sym symbols from payload.
//
// Per-bit tree walk with emit-and-reset (reference src/decoder.c:34-96):
// read a byte, then step per bit MSB->LSB; stepping into a missing child is
// corruption; the byte containing the last symbol is consumed whole and its
// remaining pad bits ignored.
//
// Returns:  >=0  payload bytes consumed (restored == n_sym)
//           -1   corruption (trap stepped within available bytes)
//           -2   short read (payload exhausted before n_sym symbols)
// out may be null (pure scan / progress measurement).
// restored_out receives the number of symbols produced either way.
// ---------------------------------------------------------------------------
int64_t walk_block(const uint32_t* nodes, int32_t nt,
                   const uint8_t* payload, int64_t payload_len,
                   uint64_t n_sym, uint8_t* out, uint64_t* restored_out)
{
    uint64_t restored = 0;
    int32_t state = 0;  // root
    int64_t pos = 0;
    int32_t trap = nt - 1;
    while (restored < n_sym) {
        if (pos >= payload_len) { *restored_out = restored; return -2; }
        uint8_t byte = payload[pos++];
        for (int b = 7; b >= 0; --b) {
            uint32_t node = nodes[state];
            int32_t nxt = (byte >> b) & 1 ? (int32_t)((node >> 11) & 0x7FF)
                                          : (int32_t)(node & 0x7FF);
            if (nxt == trap) { *restored_out = restored; return -1; }
            uint32_t sc = nodes[nxt] >> 22;
            if (sc < 256) {
                if (out) out[restored] = (uint8_t)sc;
                ++restored;
                state = 0;
                if (restored >= n_sym) break;  // pad bits ignored
            } else {
                state = nxt;
            }
        }
    }
    *restored_out = restored;
    return pos;
}

// ---------------------------------------------------------------------------
// Sequential whole-stream scan/decode.
//
// Walks the block chain from offset 0 (reference src/decoder.c:218-275).
// For each block: u64 LE original length, i16 LE tree length, tree, payload.
// Decodes into out (if non-null, must hold the full decoded size).
//
// Returns 0 ok; 3 READ_WRITE; 5 BTREE_OVERFLOW; 6 BTREE_CORRUPTED
// (huf_error_t-compatible codes). consumed_out: bytes of stream consumed;
// produced_out: decoded bytes written/counted; blocks_out: block count.
// ---------------------------------------------------------------------------
int32_t scan_stream(const uint8_t* data, int64_t length,
                    uint8_t* out, int64_t out_cap,
                    int64_t* consumed_out, int64_t* produced_out,
                    int64_t* blocks_out, int64_t max_blocks)
{
    const int32_t NT = 1027;
    uint32_t nodes[1027];
    int64_t off = 0, produced = 0, blocks = 0;
    *consumed_out = 0; *produced_out = 0; *blocks_out = 0;
    while (off < length && (max_blocks < 0 || blocks < max_blocks)) {
        if (off + 10 > length) return 3;
        uint64_t n_sym;
        std::memcpy(&n_sym, data + off, 8);
        int16_t tree_len;
        std::memcpy(&tree_len, data + off + 8, 2);
        if (tree_len < 0 || tree_len > 1025) return 5;
        int64_t tree_off = off + 10;
        if (tree_off + 2LL * tree_len > length) return 3;
        int32_t depth = 0;
        int32_t cnt = deserialize_tree(
            (const int16_t*)(data + tree_off), tree_len, nodes, NT, &depth);
        int64_t payload_off = tree_off + 2LL * tree_len;
        if (n_sym > 0) {
            if (cnt < 0) return 6;  // NULL root with data (ref NULL-derefs)
            if (out && produced + (int64_t)n_sym > out_cap) return 3;
            uint64_t restored = 0;
            int64_t used = walk_block(nodes, NT, data + payload_off,
                                      length - payload_off, n_sym,
                                      out ? out + produced : nullptr,
                                      &restored);
            if (used == -1) return 6;
            if (used == -2) return 3;
            produced += (int64_t)n_sym;
            off = payload_off + used;
        } else {
            off = payload_off;
        }
        ++blocks;
        *consumed_out = off; *produced_out = produced; *blocks_out = blocks;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Decode resolve tables: LUT10 + (128-state x 3-bit) stage + a 64-state
// 3-bit tail, then 32-state 3-bit tails.
//
// The device decode walker (ops/decode_walk.py) resolves the codeword at
// a lane's bit position with a cascade of lookups into these tables.
// Every logical entry fits 16 bits, so TWO entries pack per u32 cell.
// Packed layout per block, TAB_ROWS = 13 rows of 128 u32 (entry i of a
// table lives in cell i>>1, half i&1, little-halfword first):
//
//   rows 0..3   LUT10:   index = first 10 window bits           (1024)
//   rows 4..7   stage 1: index = state(7b) << 3 | bits [10,13)  (1024)
//   rows 8..9   tail 1:  index = state(6b) << 3 | 3 bits        (512)
//   rows 10..12 tails 2-4: index = state(5b) << 3 | 3 bits      (256 each,
//               one row per stage) covering cuts 13, 16, 19, 22 -> max
//               depth 25 (MAX_TABLE_DEPTH; decode_walk.MAXL_OF_NS)
//
// Cut capacities follow measured tree shapes (tree-shape analysis plus
// the round-4 widening): realistic 64 KiB text blocks (Zipf word mix with
// a rare-byte tail) fit 128 states at depth 10 and 64 at depth 13;
// uniform-byte blocks have depth <= 10 entirely.
//
// Entry packing (int32):
//   terminal:  (1 << 15) | bad << 14 | lnfail(6) << 8 | sym(8)
//              lnfail = code length (bad=0) or the failing bit offset
//              (bad=1, the bit that stepped into a missing child —
//              reference read-then-step order, src/decoder.c:58-71).
//   internal:  state id in the low bits (the walk continues next stage).
//
// Over-capacity states or depth > 26 return -1 (host-exact fallback).
// Returns the number of lookup stages beyond LUT10 (0..5).
// ---------------------------------------------------------------------------
static void walk_entry(const uint32_t* nodes, int32_t nt, int32_t start_node,
                       int32_t base_depth, uint32_t bits, int32_t nbits,
                       // out:
                       int32_t* term, int32_t* bad, int32_t* lnfail,
                       int32_t* sym, int32_t* end_node)
{
    int32_t trap = nt - 1;
    int32_t node = start_node;
    *term = 0; *bad = 0; *lnfail = 0; *sym = 0;
    for (int32_t d = 0; d < nbits; ++d) {
        uint32_t bit = (bits >> (nbits - 1 - d)) & 1;
        uint32_t nd = nodes[node];
        int32_t nxt = bit ? (int32_t)((nd >> 11) & 0x7FF) : (int32_t)(nd & 0x7FF);
        if (nxt == trap) {
            *term = 1; *bad = 1; *lnfail = base_depth + d;
            *end_node = trap;
            return;
        }
        uint32_t sc = nodes[nxt] >> 22;
        if (sc < 256) {
            *term = 1; *lnfail = base_depth + d + 1; *sym = (int32_t)sc;
            *end_node = nxt;
            return;
        }
        node = nxt;
    }
    *end_node = node;
}

static const int32_t TAB_ROWS = 13;   // packed: 4 (LUT10) + 4 (stage 1)
                                      // + 2 (tail 1: 64st) + 3 (tails 2-4)
static const int32_t LOGI_ROWS = 26;  // logical: 8 + 8 + 4 + 3*2

// Terminal entries are stored in the walker's layout
// DONE(15) | aux(13:6) | len(5:0) — len == 0 marks a dead/corrupt
// position whose aux byte is the fail offset, else aux is the decoded
// symbol; non-terminal entries hold next-stage state indices in the low
// bits.
static inline int32_t term_entry(int32_t bad, int32_t lnfail, int32_t sym)
{
    const int32_t DONE = 1 << 15;
    return bad ? (DONE | (lnfail << 6)) : (DONE | (sym << 6) | lnfail);
}

static int32_t build_decode_tables_logical(const uint32_t* nodes, int32_t nt,
                                           int32_t* tables)  // [LOGI_ROWS*128]
{
    const int32_t DONE = 1 << 15;
    // Unary-root requirement: every wire codeword starts with a 0 bit
    // (reference src/tree.c:410-413 always wraps the root), so the upper
    // half of LUT10 is the constant dead entry.  Crafted streams can
    // serialize a tree with a real right child under the root; those take
    // the host-exact walk (bit-exact either way).
    if (((nodes[0] >> 11) & 0x7FF) != (uint32_t)(nt - 1)) return -1;
    // Unreachable slots decode as dead positions (len 0, fail offset 0).
    for (int32_t i = 0; i < LOGI_ROWS * 128; ++i) tables[i] = DONE;

    int32_t states[128];  // internal nodes at the current cut
    int32_t n_states = 0;
    int32_t next_states[128];
    // Measured state populations (round 4): near-incompressible 64 KiB
    // blocks (12-bit sensor data) reach 86 internal nodes at depth 10;
    // enwik-like text blocks reach 34 at depth 14.  Caps: 128 at cut 10
    // (3-bit stage 1 keeps the table at 1024 entries), 64 at cut 13,
    // 32 at the later cuts (they decay fast).
    const int32_t LUT10_CAP = 128;
    const int32_t TAIL1_CAP = 64;
    const int32_t TAIL_CAP = 32;

    // LUT10 from the root (rows 0..7).
    for (uint32_t v = 0; v < 1024; ++v) {
        int32_t term, bad, lnfail, sym, end;
        walk_entry(nodes, nt, 0, 0, v, 10, &term, &bad, &lnfail, &sym, &end);
        if (term) {
            tables[v] = term_entry(bad, lnfail, sym);
        } else {
            int32_t sid = -1;
            for (int32_t s = 0; s < n_states; ++s)
                if (states[s] == end) { sid = s; break; }
            if (sid < 0) {
                if (n_states >= LUT10_CAP) return -1;
                sid = n_states;
                states[n_states++] = end;
            }
            tables[v] = sid;
        }
    }
    if (n_states == 0) return 0;

    // Stage 1 (logical rows 8..15): 128 states x 3 bits, cut 10 -> 13.
    int32_t n_next = 0;
    for (int32_t s = 0; s < n_states; ++s) {
        for (uint32_t v = 0; v < 8; ++v) {
            int32_t term, bad, lnfail, sym, end;
            walk_entry(nodes, nt, states[s], 10, v, 3,
                       &term, &bad, &lnfail, &sym, &end);
            int32_t idx = 1024 + ((s << 3) | (int32_t)v);
            if (term) {
                tables[idx] = term_entry(bad, lnfail, sym);
            } else {
                int32_t sid = -1;
                for (int32_t t = 0; t < n_next; ++t)
                    if (next_states[t] == end) { sid = t; break; }
                if (sid < 0) {
                    if (n_next >= TAIL1_CAP) return -1;
                    sid = n_next;
                    next_states[n_next++] = end;
                }
                tables[idx] = sid;
            }
        }
    }
    for (int32_t t = 0; t < n_next; ++t) states[t] = next_states[t];
    n_states = n_next;

    // Tail stages, cuts 13/16/19/22: stage 1 = 64 states x 3 bits
    // (512 entries, logical rows 16..19); stages 2..4 = 32 states x 3
    // bits (256 entries each, logical rows 20..25).
    int32_t ns = 1;
    int32_t depth = 13;
    while (n_states > 0) {
        if (ns >= 5) return -1;  // depth > 25
        int32_t* tab = (ns == 1)
            ? tables + 16 * 128
            : tables + (20 + 2 * (ns - 2)) * 128;
        n_next = 0;
        for (int32_t s = 0; s < n_states; ++s) {
            for (uint32_t v = 0; v < 8; ++v) {
                int32_t term, bad, lnfail, sym, end;
                walk_entry(nodes, nt, states[s], depth, v, 3,
                           &term, &bad, &lnfail, &sym, &end);
                int32_t idx = (s << 3) | (int32_t)v;
                if (term) {
                    tab[idx] = term_entry(bad, lnfail, sym);
                } else {
                    int32_t sid = -1;
                    for (int32_t t = 0; t < n_next; ++t)
                        if (next_states[t] == end) { sid = t; break; }
                    if (sid < 0) {
                        if (n_next >= TAIL_CAP) return -1;
                        sid = n_next;
                        next_states[n_next++] = end;
                    }
                    tab[idx] = sid;
                }
            }
        }
        for (int32_t t = 0; t < n_next; ++t) states[t] = next_states[t];
        n_states = n_next;
        depth += 3;
        ++ns;
    }
    return ns;
}

// Pack the logical 24-row tables into the 12-row u32 form the kernel reads:
// two 16-bit entries per lane cell (entry i -> cell i>>1, halfword i&1).
int32_t build_decode_tables(const uint32_t* nodes, int32_t nt,
                            uint32_t* tables)  // [TAB_ROWS * 128]
{
    int32_t logical[LOGI_ROWS * 128];
    int32_t ns = build_decode_tables_logical(nodes, nt, logical);
    if (ns < 0) return ns;
    // LUT10 entries 0..1023 -> cells 0..511 (rows 0..3); stage-1 entries
    // 1024..2047 -> cells 512..1023 (rows 4..7); tail-1 entries (512,
    // logical rows 16..19) -> cells 1024..1279 (rows 8..9); tail stages
    // 2..4 (256 each, logical rows 20..25) -> cells 1280+128k (rows
    // 10..12).
    for (int32_t i = 0; i < 2048; ++i) {
        uint32_t e = (uint32_t)logical[i] & 0xFFFFu;
        uint32_t* cell = tables + (i >> 1);
        if ((i & 1) == 0) *cell = e;
        else *cell |= e << 16;
    }
    {
        const int32_t* src = logical + 16 * 128;
        uint32_t* dst = tables + 1024;
        for (int32_t i = 0; i < 512; ++i) {
            uint32_t e = (uint32_t)src[i] & 0xFFFFu;
            uint32_t* cell = dst + (i >> 1);
            if ((i & 1) == 0) *cell = e;
            else *cell |= e << 16;
        }
    }
    for (int32_t k = 0; k < 3; ++k) {
        const int32_t* src = logical + (20 + 2 * k) * 128;
        uint32_t* dst = tables + 1280 + 128 * k;
        for (int32_t i = 0; i < 256; ++i) {
            uint32_t e = (uint32_t)src[i] & 0xFFFFu;
            uint32_t* cell = dst + (i >> 1);
            if ((i & 1) == 0) *cell = e;
            else *cell |= e << 16;
        }
    }
    return ns;
}

// Batch: trees packed back-to-back (int16 wire form with offsets/lengths,
// same inputs as deserialize_trees), one deserialize + table build per
// block.  Outputs per block: stage count; -1 = host-exact fallback (state
// overflow or depth outside [2, 26] — mindepth < 2 means a tree admitting
// 1-bit codes, which the encoder never emits, src/tree.c:410-413);
// -2 = no root (the reference NULL-derefs; callers raise BTREE_CORRUPTED).
static void leaf_depths(const uint32_t* nodes, int32_t nt, int32_t node,
                        int32_t d, int32_t* mind, int32_t* maxd)
{
    int32_t trap = nt - 1;
    uint32_t nd = nodes[node];
    int32_t l = (int32_t)(nd & 0x7FF), r = (int32_t)((nd >> 11) & 0x7FF);
    uint32_t sc = nd >> 22;
    if (sc < 256) {
        if (d < *mind) *mind = d;
        if (d > *maxd) *maxd = d;
        return;
    }
    if (l != trap) leaf_depths(nodes, nt, l, d + 1, mind, maxd);
    if (r != trap) leaf_depths(nodes, nt, r, d + 1, mind, maxd);
}

void build_decode_tables_batch(const int16_t* bufs, const int64_t* offs,
                               const int32_t* lens, int32_t B,
                               uint32_t* tables,  // [B, TAB_ROWS, 128]
                               int32_t* nstages,  // [B]
                               int32_t* mindep,   // [B]
                               int32_t* maxdep)   // [B]
{
    const int32_t NT = 1027;
    uint32_t nodes[1027];
    for (int32_t b = 0; b < B; ++b) {
        int32_t depth = 0;
        int32_t cnt = deserialize_tree(bufs + offs[b], lens[b], nodes, NT,
                                       &depth);
        uint32_t* tab = tables + (int64_t)b * TAB_ROWS * 128;
        if (cnt < 0) {
            nstages[b] = -2; mindep[b] = 0; maxdep[b] = 0;
            continue;
        }
        int32_t mind = 1 << 30, maxd = 0;
        leaf_depths(nodes, NT, 0, 0, &mind, &maxd);
        mindep[b] = (mind == (1 << 30)) ? 0 : mind;
        maxdep[b] = maxd;
        if (mindep[b] < 2 || maxd > 26) {
            nstages[b] = -1;
            continue;
        }
        nstages[b] = build_decode_tables(nodes, NT, tab);
    }
}

// Measure-only variant used by the incremental decompressor: how many
// symbols does the available payload of a single block yield?
uint64_t walk_progress(const int16_t* tree, int32_t tree_len,
                       const uint8_t* payload, int64_t payload_len,
                       uint64_t n_sym)
{
    const int32_t NT = 1027;
    uint32_t nodes[1027];
    int32_t depth = 0;
    if (deserialize_tree(tree, tree_len, nodes, NT, &depth) < 0) return 0;
    uint64_t restored = 0;
    walk_block(nodes, NT, payload, payload_len, n_sym, nullptr, &restored);
    return restored;
}

// Resumable variant: continues a measurement walk from (pos, state,
// restored) over the same block's payload, so an incremental feeder walks
// each payload byte exactly once across calls (O(n) total instead of the
// O(n^2) full re-walk per feed).  state -1 marks a walk that stepped into a
// missing child: progress is frozen and the caller's decode attempt
// classifies the corruption (reference read-then-step order,
// src/decoder.c:52-91).  Returns 0 on bad tree (state set to -1).
int32_t walk_progress_resume(const int16_t* tree, int32_t tree_len,
                             const uint8_t* payload, int64_t payload_len,
                             uint64_t n_sym, int64_t* pos_io,
                             int32_t* state_io, uint64_t* restored_io)
{
    const int32_t NT = 1027;
    uint32_t nodes[1027];
    int32_t depth = 0;
    if (deserialize_tree(tree, tree_len, nodes, NT, &depth) < 0) {
        *state_io = -1;
        return 0;
    }
    int64_t pos = *pos_io;
    int32_t state = *state_io;
    uint64_t restored = *restored_io;
    const int32_t trap = NT - 1;
    if (state < 0) return 1;  // stuck on corruption: no further progress
    while (restored < n_sym && pos < payload_len) {
        uint8_t byte = payload[pos++];
        for (int b = 7; b >= 0; --b) {
            uint32_t node = nodes[state];
            int32_t nxt = (byte >> b) & 1 ? (int32_t)((node >> 11) & 0x7FF)
                                          : (int32_t)(node & 0x7FF);
            if (nxt == trap) { state = -1; break; }
            uint32_t sc = nodes[nxt] >> 22;
            if (sc < 256) {
                ++restored;
                state = 0;
                if (restored >= n_sym) break;
            } else {
                state = nxt;
            }
        }
        if (state < 0) break;
    }
    *pos_io = pos;
    *state_io = state;
    *restored_io = restored;
    return 1;
}

// ---------------------------------------------------------------------------
// Host-side stream plumbing at native speed (round-4: the Python/numpy
// versions of these three dominated end-to-end walls at the 100 MB scale).
// ---------------------------------------------------------------------------

// Candidate block-header scan: offsets where a plausible header starts
// (u64 n_sym with zero high bytes and nonzero low word, 1 <= tree_len <=
// 1025; mirrors format.find_candidate_headers / reference block layout
// src/encoder.c:288-374).  Fills up to cap offsets; returns the TOTAL
// count (callers re-invoke with a larger buffer on overflow).
int64_t find_headers(const uint8_t* d, int64_t n, int64_t* out, int64_t cap)
{
    if (n < 10) return 0;
    const int64_t last = n - 10;  // max candidate offset
    int64_t k = 0;
    // A candidate needs bytes [i+4, i+8) all zero, i.e. a zero RUN of
    // length >= 4.  Compressed payload bytes are near-uniform, so such
    // runs are rare: hop between zero bytes with SIMD memchr (~15 GB/s)
    // and only examine windows whose zero-quad fits inside a run.
    int64_t pos = 4;
    while (pos < n) {
        const void* z = std::memchr(d + pos, 0, (size_t)(n - pos));
        if (!z) break;
        int64_t z0 = (const uint8_t*)z - d;
        int64_t z1 = z0 + 1;
        while (z1 < n && d[z1] == 0) ++z1;
        int64_t ilo = z0 - 4 < 0 ? 0 : z0 - 4;
        int64_t ihi = z1 - 8 < last ? z1 - 8 : last;
        for (int64_t i = ilo; i <= ihi; ++i) {
            const uint8_t* p = d + i;
            if (p[4] | p[5] | p[6] | p[7]) continue;   // run-edge guard
            if (!(p[0] | p[1] | p[2] | p[3])) continue;  // n_sym > 0
            uint8_t d8 = p[8], d9 = p[9];
            bool tree_ok = (d9 < 4 && (d8 | d9) != 0) || (d9 == 4 && d8 <= 1);
            if (!tree_ok) continue;
            if (k < cap) out[k] = i;
            ++k;
        }
        pos = z1 + 1;
    }
    return k;
}

// Decode plan staging: per block, copy `caps[b]` payload bytes from
// `data + offs[b]` into a zero-padded row of big-endian u32 words (the
// decode walker's input layout, ops/decode_walk.decode_blocks).
void stage_plan(const uint8_t* data, int64_t n,
                const int64_t* offs, const int64_t* caps, int32_t B,
                int64_t row_words,  // words per output row (incl. pad row)
                uint32_t* out)      // [B, row_words]
{
    for (int32_t b = 0; b < B; ++b) {
        uint32_t* o = out + (int64_t)b * row_words;
        int64_t off = offs[b];
        int64_t len = off < 0 ? 0 : caps[b];
        if (off + len > n) len = n - off;
        if (len > row_words * 4) len = row_words * 4;
        if (len < 0) len = 0;
        // Zero only the padding tail (zeroing full rows then overwriting
        // doubled the staging wall at stream scale).
        std::memset(o + len / 4, 0, (size_t)(row_words - len / 4) * 4);
        if (len == 0) continue;
        const uint8_t* s = data + off;
        int64_t w = 0;
        for (; (w + 1) * 4 <= len; ++w) {
            uint32_t v;
            std::memcpy(&v, s + 4 * w, 4);
            o[w] = __builtin_bswap32(v);
        }
        int64_t rem = len - 4 * w;
        if (rem > 0) {
            uint32_t v = 0;
            for (int64_t j = 0; j < rem; ++j)
                v |= (uint32_t)s[4 * w + j] << (24 - 8 * j);
            o[w] = v;
        }
    }
}

// Encode stream assembly: ordered concatenation of (header, tree, payload)
// per block (reference block emit order, src/encoder.c:325-351).  Blocks
// with n_sym == 0 are padding and skipped.  Little-endian host assumed
// (u64/i16 header fields memcpy'd directly — matches the wire format).
int64_t assemble_blocks(const uint64_t* n_sym,
                        const int16_t* trees, const int32_t* tree_lens,
                        int64_t tree_stride,
                        const uint8_t* payloads, int64_t payload_stride,
                        const int64_t* payload_lens, int32_t B,
                        uint8_t* out)
{
    int64_t pos = 0;
    for (int32_t b = 0; b < B; ++b) {
        if (n_sym[b] == 0) continue;
        std::memcpy(out + pos, &n_sym[b], 8); pos += 8;
        int16_t tl = (int16_t)tree_lens[b];
        std::memcpy(out + pos, &tl, 2); pos += 2;
        std::memcpy(out + pos, trees + (int64_t)b * tree_stride,
                    (size_t)(2 * tl));
        pos += 2 * tl;
        std::memcpy(out + pos, payloads + (int64_t)b * payload_stride,
                    (size_t)payload_lens[b]);
        pos += payload_lens[b];
    }
    return pos;
}

}  // extern "C"
