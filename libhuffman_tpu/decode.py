"""Whole-stream decode: speculative parallel block discovery + device kernels.

Block boundaries in the libhuffman format are only discoverable by decoding
(the payload length is implicit, SURVEY.md §2.9), which would make the stream
a sequential chain.  This decoder breaks the chain speculatively:

  1. One vectorized pass finds every *candidate* header (u64 length with zero
     high bytes, tree_length in range — true block starts always match,
     false positives are rare and merely waste speculative work).
  2. All candidates are decoded in parallel on the device
     (ops/decode_walk.py, one program per block), each yielding its symbols,
     its consumed payload size, and error flags.
  3. The true chain is resolved on the host by following consumed sizes from
     offset 0; any gap (missed candidate, flagged block, adversarial stream)
     falls back to the host-exact sequential decoder for that block, so
     correctness never depends on the speculation.

Error semantics mirror src/decoder.c:201-287: the first failing block in
*chain order* raises; garbage beyond the consumed span of a valid stream
suffix still raises ReadWrite/BtreeOverflow exactly like the reference's
outer loop.
"""

from __future__ import annotations

import numpy as np

from .errors import BtreeCorruptedError, ReadWriteError
from .format import (
    BLOCK_HEADER,
    deserialize_tree,
    find_candidate_headers,
    parse_block_header,
)
from . import native
from .ops import hostref
from .ops import decode_walk as ddec
from .utils.trace import annotate

# Device batch sizing: total bit positions per plan (32 MiB of staged
# payload).  Each block of a plan is one program of the walker, and the
# plans of a stream run one after another.
_POSITION_BUDGET = 1 << 28

# Distinct device-kernel shapes dispatched so far: (B, NP, OUTW, NS).  The
# bucket scheme bounds the product — B bucketed, NP and OUTW pow2, NS
# one of six values — and the bench reports len(compile_keys()) so
# jit-cache pressure is measured, not guessed.
_COMPILE_KEYS: set[tuple] = set()

# Blocks decoded in this process, by path: "device" (the walker) and
# "host" (the host-exact walk: no native library, trees the table builder
# rejects, oversized or missed blocks, speculation gone short).
_BLOCK_COUNTS = {"device": 0, "host": 0}


def compile_keys() -> frozenset:
    """Distinct decode-kernel jit keys dispatched in this process."""
    return frozenset(_COMPILE_KEYS)


def block_counts() -> dict[str, int]:
    """Blocks decoded in this process, by path ("device", "host")."""
    return dict(_BLOCK_COUNTS)


def _bucket(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _p_bucket(n: int) -> int:
    """Payload-byte budget of a device plan: a power of two >= 512.  The
    walker's work follows the codewords, not the padded row, so coarse
    buckets cost only staging bytes and give fewer, wider plans."""
    return _bucket(n, 512)


def _b_bucket(n: int) -> int:
    """Block-count bucket: pow2 to 128, then multiples of 128 (padding
    blocks have n_sym = 0 and do no work)."""
    if n <= 128:
        return _bucket(n, 16)
    return -(-n // 128) * 128


class _Candidate:
    __slots__ = (
        "off", "n_sym", "tree", "payload_off", "avail",
        "fallback", "error", "result",
    )

    def __init__(self, off, n_sym, tree, payload_off, avail):
        self.off = off
        self.n_sym = n_sym
        self.tree = tree
        self.payload_off = payload_off
        self.avail = avail  # payload bytes available before stream end
        self.fallback = False  # decode on host when reached
        self.error = None  # exception class to raise when reached
        self.result = None  # (symbols bytes, consumed payload bytes)


def _decode_candidates_device(data: np.ndarray, cands: list[_Candidate],
                              mesh=None):
    """Speculatively decode eligible candidates in batches on the device.

    The device path needs the native table builder (native
    build_decode_tables); without a toolchain every candidate takes the
    host-exact walk instead — slower, never incorrect (block_counts()
    shows it).
    """
    pending = []
    for c in cands:
        if c.n_sym == 0:
            c.result = (b"", 0)
            continue
        if c.n_sym > 8 * c.avail:
            # Each symbol consumes >= 1 bit: guaranteed short read if this
            # block is ever reached (decoder.c:52-56 path).
            c.error = ReadWriteError
            continue
        pending.append(c)

    if not pending:
        return
    if not native.available():
        for c in pending:
            c.fallback = True
        return

    plans = _build_plans(data, _eligible(pending, cands),
                         lane_mult=mesh.devices.size if mesh else 1)
    if not plans:
        return
    with annotate("huff.decode.device"):
        results = _run_plans(plans, mesh)
    for plan, (out, end_bit, corrupt, bad_bit) in zip(plans, results):
        _apply_plan_results(plan, np.asarray(out), np.asarray(end_bit),
                            np.asarray(corrupt), np.asarray(bad_bit))


def _eligible(pending: list[_Candidate], cands: list[_Candidate]):
    """(candidate, tables, cap, NS) for every pending candidate the device
    path takes; marks the others for the host walk or an error."""
    bufs = np.concatenate([np.asarray(c.tree, np.int16) for c in pending])
    lens = np.array([len(c.tree) for c in pending], np.int32)
    offs = np.concatenate(([0], np.cumsum(lens[:-1], dtype=np.int64)))
    tables_all, nstages_all, _mindep, maxdep_all = (
        native.build_decode_tables(bufs, offs, lens)
    )
    next_off = _next_candidate_offsets(cands)
    eligible = []
    for i, c in enumerate(pending):
        ns = int(nstages_all[i])
        if ns == -2:
            # NULL root with symbols to restore: reference NULL-derefs;
            # we raise BTREE_CORRUPTED (SURVEY.md §7 item 8).
            c.error = BtreeCorruptedError
            continue
        if ns < 0:
            # 1-bit codes, over-capacity state cuts, or depth > 25
            # (crafted trees): host-exact path.
            c.fallback = True
            continue
        cap = _payload_cap(c, int(maxdep_all[i]), next_off.get(c.off))
        if cap > (1 << 18):
            # The device path's documented limit: payloads above 256 KiB
            # take the host walk.
            c.fallback = True
            continue
        eligible.append((c, tables_all[i], cap, ns))
    return eligible


class _Plan:
    __slots__ = ("words", "tables", "n_sym", "NP", "OUTW", "ns", "batch")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


def _next_candidate_offsets(cands) -> dict[int, int]:
    """Map candidate offset -> offset of the next candidate (or None)."""
    offs = sorted(c.off for c in cands)
    return {offs[i]: offs[i + 1] for i in range(len(offs) - 1)}


def _payload_cap(c: _Candidate, depth: int, next_off: int | None) -> int:
    """Payload byte budget for a speculative block.

    Two sound-ish upper bounds combine:
      * every code is <= depth bits: ceil(n_sym * depth / 8) (always sound);
      * a true block's payload ends at the next true header, and every true
        header is in the candidate list — so the next *candidate* offset
        bounds it, UNLESS that candidate is a false positive inside this
        payload.  A too-small cap is recovered by the retry path
        (_apply_plan_results sends short reads below ``avail`` back to the
        host-exact walk), so tightening never costs correctness — it cuts
        the position-budget waste of the worst-case bound (~2.4x measured).
    """
    cap = min(c.avail, (c.n_sym * depth + 7) // 8)
    if next_off is not None:
        gap = next_off - c.payload_off
        if gap > 0:
            # + 8: a payload whose last byte is zero makes the offset one
            # byte before the next true header parse as a header too; the
            # slack keeps that alias from cutting the true payload short.
            cap = min(cap, gap + 8)
    return cap


def _build_plans(data: np.ndarray, eligible, lane_mult: int = 1
                 ) -> list[_Plan]:
    """Shape-homogeneous device batches from eligible candidates.

    A plan takes only candidates of one P bucket: every staged payload must
    fit its plan's P bytes — a cap > P would silently truncate the payload
    and let the walk run into zero padding (accepted as a bogus "complete"
    decode).  Within a bucket, blocks sort by stage count so a plan's NS
    (the largest of its blocks') stays low where it can."""
    eligible = sorted(eligible, key=lambda e: (_p_bucket(e[2] + 8), e[3], e[2]))
    batches = []
    i = 0
    while i < len(eligible):
        P = _p_bucket(eligible[i][2] + 8)
        j = i
        while j < len(eligible) and _p_bucket(eligible[j][2] + 8) == P:
            j += 1
        # Near-equal chunks of at most bmax blocks.
        bmax = max(1, _POSITION_BUDGET // (8 * P))
        size = -(-(j - i) // -(-(j - i) // bmax))
        for s0 in range(i, j, size):
            batches.append((P, eligible[s0 : min(s0 + size, j)]))
        i = j

    def plan(P, batch):
        assert all(cap <= P for (_c, _t, cap, _n) in batch)
        B = _b_bucket(len(batch))
        if lane_mult > 1:
            B = -(-B // lane_mult) * lane_mult
        tables = np.zeros((B, native.TAB_ROWS, 128), np.uint32)
        n_sym = np.zeros(B, np.int32)  # 0: padding block, no work
        offs = np.full(B, -1, np.int64)
        caps = np.zeros(B, np.int64)
        for b, (c, tab, cap, _ns) in enumerate(batch):
            offs[b] = c.payload_off
            caps[b] = cap
            tables[b] = tab
            n_sym[b] = c.n_sym
        # One native pass per plan: slice, zero-pad and byteswap each block
        # into the walker's word rows (P // 4 words + one read-ahead word).
        words = native.stage_plan(data, offs, caps, P // 4 + 1)
        return _Plan(words=words, tables=tables, n_sym=n_sym, NP=8 * P,
                     OUTW=_bucket(int(n_sym.max()), 512) // 4,
                     ns=max(e[3] for e in batch), batch=batch)

    # The ctypes calls release the GIL, so plans stage in parallel.
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(native._POOL_WORKERS) as ex:
        return list(ex.map(lambda pb: plan(*pb), batches))


def _run_plans(plans: list[_Plan], mesh=None):
    """All plans in one device dispatch.

    With a mesh, the same plans run through shard_map over the block axis
    (parallel/shard.decode_plans_sharded) — the DecodeConfig.mesh path."""
    import jax.numpy as jnp

    for p in plans:
        _COMPILE_KEYS.add((p.words.shape[0], p.NP, p.OUTW, p.ns))
    if mesh is not None:
        from .parallel.shard import decode_plans_sharded

        return decode_plans_sharded(plans, mesh)
    arrays = tuple(
        (jnp.asarray(p.words), jnp.asarray(p.tables), jnp.asarray(p.n_sym))
        for p in plans
    )
    shapes = tuple((p.NP, p.OUTW, p.ns) for p in plans)
    return ddec.decode_blocks_many(arrays, shapes)


def scan_candidates(data, length: int | None = None,
                    limit: int | None = None,
                    offsets=None) -> list[_Candidate] | None:
    """All plausible block-header candidates of a stream, in offset order.

    The shared front half of speculative decoding (decode.py's chain,
    parallel/multihost.py's range split, and the bench profilers): one
    vectorized header scan + per-candidate parse.  ``limit`` bails out
    (returns None) on a raw-offset explosion before paying per-candidate
    parses — crafted streams only.  ``offsets`` skips the vectorized scan
    and parses the given header offsets instead (multihost ranks reuse the
    rank-0 scan this way, SURVEY.md §5.8).
    """
    buf = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) \
        else data
    if length is None:
        length = len(buf)
    if offsets is not None:
        offs = np.asarray(offsets, np.int64)
    elif native.available():
        offs = native.find_headers(buf[:length])
    else:
        offs = find_candidate_headers(buf[:length])
    if limit is not None and len(offs) > limit:
        return None
    mv = memoryview(buf)
    cands = []
    for off in offs.tolist():
        try:
            hdr = parse_block_header(mv, off)
        except Exception:
            continue
        avail = length - hdr.payload_off
        if avail < 0:
            continue
        cands.append(_Candidate(off, hdr.n_sym, np.asarray(hdr.tree),
                                hdr.payload_off, avail))
    return cands


def build_device_plans(enc: bytes):
    """Device decode plans for a whole stream (bench/profiling entry).

    Runs the same host-side preparation the decoder does — candidate scan,
    header parse, native table build, eligibility, batching — and returns
    (plans, n_out): the shape-homogeneous device batches plus the total
    output byte count they cover.
    """
    buf = np.frombuffer(enc, np.uint8)
    cands = [c for c in scan_candidates(buf)
             if c.n_sym and c.n_sym <= 8 * c.avail]
    if not cands:
        return [], 0
    eligible = _eligible(cands, cands)
    return _build_plans(buf, eligible), sum(e[0].n_sym for e in eligible)


def _apply_plan_results(plan, out_h, end_h, cor_h, bad_h):
    for b, (c, _tab, cap, _ns) in enumerate(plan.batch):
        if cor_h[b]:
            # Read-then-step precedence (decoder.c:52-71): a failing bit
            # beyond the available payload is a short read, not corruption
            # of a byte that was never read.  A failure beyond a
            # *tightened* cap (but within avail) is speculation gone
            # short, not a verdict: retry on the host-exact path.
            bb = int(bad_h[b]) // 8
            if bb < cap:
                c.error = BtreeCorruptedError
            elif cap < c.avail:
                c.fallback = True
            else:
                c.error = ReadWriteError
            continue
        consumed = (int(end_h[b]) + 7) // 8
        if consumed <= cap:
            # memoryview, not tobytes(): the final b"".join copies once;
            # a per-block copy here doubled assembly time at stream scale.
            c.result = (out_h[b, : c.n_sym].data, consumed)
        elif cap < c.avail:
            c.fallback = True
        else:
            c.error = ReadWriteError


def _chain(data: bytes, length: int, use_device: bool, mesh=None):
    """Resolve the block chain from offset 0.

    Yields per-block decoded bytes; raises on the first failing block in
    chain order.  ReadWriteError carries ``consumed`` (the offset of the
    block whose data is incomplete) so incremental callers can buffer.
    """
    buf = np.frombuffer(data, dtype=np.uint8)
    cand_map: dict[int, _Candidate] = {}
    if use_device and length > 0:
        with annotate("huff.decode.scan"):
            # Candidate explosions (crafted input) bail to sequential.
            cands = scan_candidates(buf, length,
                                    limit=max(64, length // 64))
        if cands is not None:
            cand_map = {c.off: c for c in cands}
            _decode_candidates_device(buf, cands, mesh)

    out = []
    mv = memoryview(data)
    off = 0
    while off < length:
        try:
            c = cand_map.get(off)
            if c is not None and c.error is not None:
                raise c.error("Failed to decode the data")
            if c is not None and c.result is not None:
                syms, consumed = c.result
                out.append(syms)
                off = c.payload_off + consumed
                if c.n_sym:
                    _BLOCK_COUNTS["device"] += 1
                continue
            # Host-exact fallback (missed candidates, deep trees, explosions).
            hdr = parse_block_header(mv, off)
            if hdr.n_sym > 8 * max(length - hdr.payload_off, 0):
                # Each symbol consumes >= 1 bit: guaranteed short read.  Also
                # guards output allocation against adversarial u64 lengths.
                raise ReadWriteError("Failed to decode the data")
            if hdr.n_sym:
                _BLOCK_COUNTS["host"] += 1
            if native.available():
                err, consumed_b, produced, _blocks, o = native.scan_stream(
                    buf[off:length], decode=True, out_cap=hdr.n_sym,
                    max_blocks=1,
                )
                if err == 3:
                    raise ReadWriteError("Failed to decode the data")
                if err == 5:
                    from .errors import BtreeOverflowError

                    raise BtreeOverflowError("Failed to decode the data")
                if err == 6:
                    raise BtreeCorruptedError("Failed to decode the data")
                out.append(o[:produced].tobytes())
                off = off + consumed_b
            else:
                syms, consumed = hostref.decode_block_payload(
                    hdr.tree, buf[hdr.payload_off : length], hdr.n_sym
                )
                out.append(syms.tobytes())
                off = hdr.payload_off + consumed
        except ReadWriteError as e:
            # Incomplete data at the chain tail: everything decoded so far
            # is valid and ``off`` marks the incomplete block's start.
            e.partial = (b"".join(out), off)
            raise
    return b"".join(out), off


def decode(data: bytes, length: int | None = None, use_device: bool = True,
           config=None) -> bytes:
    """Whole-stream decode with the reference's strict semantics: the first
    failing block in chain order raises (src/decoder.c:218-275).

    A :class:`~libhuffman_tpu.config.DecodeConfig` overrides the positional
    knobs (config.length caps consumption; use_device routes eligibility;
    config.mesh shards every device plan over the block axis via shard_map
    — the parallelized twin of the reference outer loop,
    src/decoder.c:218-275)."""
    mesh = None
    if config is not None:
        use_device = config.use_device
        mesh = config.mesh
        if config.length:
            length = config.length
    if length is None:
        length = len(data)
    if length == 0:
        return b""
    out, _ = _chain(data, length, use_device, mesh)
    return out


def decode_prefix(data: bytes, length: int | None = None,
                  use_device: bool = True) -> tuple[bytes, int]:
    """Decode every *complete* block; returns (output, consumed offset).

    A trailing incomplete block (short header, tree, or payload) stops the
    chain cleanly instead of raising — the incremental decompressor buffers
    from ``consumed`` onward.  Corruption errors still raise.
    """
    if length is None:
        length = len(data)
    if length == 0:
        return b"", 0
    try:
        return _chain(data, length, use_device)
    except ReadWriteError as e:
        return getattr(e, "partial", (b"", 0))
