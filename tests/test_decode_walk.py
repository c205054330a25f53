"""The decode walker (ops/decode_walk.py, interpret mode here) against the
host-exact walk, hostref.decode_block_bits."""

import numpy as np
import pytest

from libhuffman_tpu import decode as dec_mod
from libhuffman_tpu import format as fmt
from libhuffman_tpu import native
from libhuffman_tpu.errors import BtreeCorruptedError, ReadWriteError
from libhuffman_tpu.ops import decode_walk as walk
from libhuffman_tpu.ops import hostref

import corpora


@pytest.fixture(autouse=True)
def _needs_native():
    if not native.available():
        pytest.skip("the walker's tables come from the native builder")


def _fib_block(depth: int) -> bytes:
    """Fibonacci byte counts: a chain tree whose longest code is ``depth``
    bits (one more than the chain for the unary root)."""
    counts = [1, 1]
    while len(counts) < depth:
        counts.append(counts[-1] + counts[-2])
    return b"".join(bytes([i]) * c for i, c in enumerate(counts))


def _zipf_block(n: int = 65536, a: float = 1.0) -> bytes:
    p = 1 / np.arange(1, 257) ** a
    rng = np.random.default_rng(5)
    return rng.choice(256, n, p=p / p.sum()).astype(np.uint8).tobytes()


def _walk(blocks: list[bytes], cap_delta: int = 0, flip=None):
    """Encode each block alone, stage them as one plan by hand (payload caps
    = true payload + ``cap_delta`` bytes) and walk it.  ``flip(i, payload)``
    may corrupt block i's staged payload bytes.  Returns the walker's
    results, the trees and the staged payloads."""
    encs = [hostref.encode_block(np.frombuffer(b, np.uint8)) for b in blocks]
    hdrs = [fmt.parse_block_header(memoryview(e), 0) for e in encs]
    trees = [np.asarray(h.tree, np.int16) for h in hdrs]
    lens = np.array([len(t) for t in trees], np.int32)
    tables, ns, _mind, _maxd = native.build_decode_tables(
        np.concatenate(trees),
        np.concatenate(([0], np.cumsum(lens[:-1], dtype=np.int64))), lens)
    assert (ns >= 0).all()
    payloads = [np.frombuffer(e, np.uint8)[h.payload_off:].copy()
                for e, h in zip(encs, hdrs)]
    caps = [len(p) + cap_delta for p in payloads]
    if flip is not None:
        for i, p in enumerate(payloads):
            flip(i, p)
    staged = [np.concatenate([p, np.zeros(max(0, c - len(p)), np.uint8)])
              for p, c in zip(payloads, caps)]
    stream = np.concatenate(staged)
    offs = np.concatenate(([0], np.cumsum([len(s) for s in staged])[:-1]))
    P = dec_mod._p_bucket(max(caps) + 8)
    words = native.stage_plan(stream, offs.astype(np.int64),
                              np.array(caps, np.int64), P // 4 + 1)
    n_sym = np.array([len(b) for b in blocks], np.int32)
    OUTW = dec_mod._bucket(int(n_sym.max()), 512) // 4
    res = walk.decode_blocks(words, tables, n_sym, 8 * P, OUTW, int(ns.max()))
    return ([np.asarray(r) for r in res], trees,
            [p[:c] for p, c in zip(payloads, caps)], 8 * P)


def _host(tree, payload, n_sym):
    try:
        return ("ok",) + hostref.decode_block_bits(tree, payload, n_sym)
    except BtreeCorruptedError as e:
        return ("corrupt", e.bad_bit)
    except ReadWriteError:
        return ("short",)


def _assert_matches_host(blocks, cap_delta=0, flip=None):
    (out, end_bit, corrupt, bad), trees, payloads, NP = _walk(
        blocks, cap_delta, flip)
    verdicts = []
    for i, b in enumerate(blocks):
        host = _host(trees[i], payloads[i], len(b))
        verdicts.append(host[0])
        if host[0] == "ok":
            assert not corrupt[i], i
            assert int(end_bit[i]) == host[2], i
            assert out[i, : len(b)].tobytes() == host[1].tobytes(), i
        elif host[0] == "corrupt":
            assert corrupt[i] and int(bad[i]) == host[1], (i, bad[i], host)
        else:
            # Past the staged payload: a failing bit or an end beyond it.
            beyond = int(bad[i]) if corrupt[i] else int(end_bit[i]) - 1
            assert beyond >= 8 * len(payloads[i]), i
    return verdicts


@pytest.mark.parametrize("depth", walk.MAXL_OF_NS)
def test_walker_depth_buckets(depth):
    """Every lookup-stage count: the longest code is exactly the bucket's
    depth, so the deepest stage decides the last symbols."""
    blk = _fib_block(depth)
    assert _assert_matches_host([blk, blk[::-1]]) == ["ok", "ok"]


@pytest.mark.parametrize("kind", ["narrow", "wide"])
def test_walker_narrow_and_wide_tables(kind):
    """Text fills only the first 256 stage-1 entries (<= 32 states at
    10 bits); a Zipf byte mix reaches ~60 states, so every stage-1 row is
    read."""
    if kind == "narrow":
        blocks = [corpora.text(65536, seed=s) for s in (1, 2, 3)]
    else:
        blocks = [_zipf_block(65536, a) for a in (0.9, 1.0, 1.1)]
    assert _assert_matches_host(blocks) == ["ok"] * 3


def test_walker_bit_flip_corruption():
    """Flipped payload bits: where the host walk steps into a missing child,
    the walker reports the same failing bit; elsewhere it decodes the same
    (garbage) symbols to the same end."""
    blocks = [_zipf_block(16384, a) for a in (0.6, 0.8, 1.0, 1.2)]
    rng = np.random.default_rng(3)

    def flip(i, p):
        for bit in rng.integers(0, 8 * len(p), 4):
            p[bit // 8] ^= np.uint8(0x80 >> (bit % 8))

    verdicts = _assert_matches_host(blocks, flip=flip)
    assert "corrupt" in verdicts, verdicts


def test_walker_short_read():
    """A payload cut short (the stream ends early): the walker runs past
    the staged bytes, which the driver reports as a short read."""
    blocks = [corpora.text(8192, seed=4), _zipf_block(8192)]
    assert _assert_matches_host(blocks, cap_delta=-5) == ["short", "short"]


def test_walker_tightened_cap():
    """A cap tightened below the true payload, with the true bytes past it
    zeroed: the walker's end lands past the cap, so the driver retries the
    block on the host walk, and the symbols before the cap are exact."""
    blk = corpora.text(16384, seed=6)
    (out, end_bit, corrupt, bad), trees, payloads, _NP = _walk(
        [blk], cap_delta=-40)
    cap = len(payloads[0])
    assert (int(bad[0]) if corrupt[0] else int(end_bit[0]) - 1) >= 8 * cap
    head = hostref.decode_block_bits(trees[0], payloads[0], 100)[0]
    assert out[0, :100].tobytes() == head.tobytes() == blk[:100]


def test_walker_driver_short_read_stays_on_device():
    """A truncated stream raises ReadWriteError from the device verdict,
    without a host walk: the two whole blocks before the cut decode on the
    device, the cut one fails there."""
    data = corpora.text(40000, seed=8)
    enc = hostref.encode(data, 16384)  # 3 blocks
    before = dec_mod.block_counts()
    with pytest.raises(ReadWriteError):
        dec_mod.decode(enc[:-3])
    after = dec_mod.block_counts()
    assert after["host"] == before["host"]
    assert after["device"] == before["device"] + 2
