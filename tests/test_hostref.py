"""Golden-vector and oracle cross-check tests for the host-exact codec.

Golden byte strings were captured from the compiled reference (SURVEY.md §2.9)
and are also re-derived live from the oracle when its sources are present;
the tests whose only subject is the compiled reference skip without them.
"""

import numpy as np
import pytest

from libhuffman_tpu.ops import hostref
from libhuffman_tpu import format as fmt
from libhuffman_tpu.errors import (
    BtreeCorruptedError,
    BtreeOverflowError,
    HuffmanError,
    ReadWriteError,
)
import oracle
from oracle import ref_compress, ref_decompress

GOLDEN_0123456789 = bytes.fromhex(
    "0a000000000000002900"
    "09010801050104013100ffffffff3000ffffffff03013300ffffffff3200ffffffff"
    "070100013900ffffffff3800ffffffff060102013500ffffffff3400ffffffff0101"
    "3700ffffffff3600ffffffffffff"
    "10326b1ee540"
)
GOLDEN_1 = bytes.fromhex("0100000000000000" + "0500" + "00013100ffffffffffff" + "00")


def test_golden_0123456789():
    out = hostref.encode(b"0123456789", 65536)
    assert out == GOLDEN_0123456789
    if oracle.available():
        assert out == ref_compress(b"0123456789", 65536)


def test_golden_single_byte():
    # 1 byte in => exactly 21 bytes out (test/encode_test.c:35); tree is
    # [256, 49, -1, -1, -1] and the code for '1' is the single bit "0".
    out = hostref.encode(b"1", 256)
    assert out == GOLDEN_1
    assert len(out) == 21


def test_golden_aab():
    # Tie-break check: b (rate 1) is the left child, a (rate 2) right, then
    # the unary root above; payload is a="01" b="00" -> 0101_0000 = 0x50.
    out = hostref.encode(b"aab", 65536)
    hdr = fmt.parse_block_header(memoryview(out), 0)
    assert list(hdr.tree) == [257, 256, 98, -1, -1, 97, -1, -1, -1]
    assert out[hdr.payload_off:] == b"\x50"
    if oracle.available():
        assert out == ref_compress(b"aab", 65536)


def test_multiblock_independent():
    # "aabba" at blocksize 2 -> three fully independent blocks (2+2+1 bytes).
    out = hostref.encode(b"aabba", 2)
    if oracle.available():
        assert out == ref_compress(b"aabba", 2)
    offs = [off for off, _, _ in hostref.scan_blocks(out)]
    assert len(offs) == 3


def test_roundtrip_small():
    for data in [b"a" * 1000, b"0123456789", b"\x00\xff" * 37]:
        enc = hostref.encode(data, 131072)
        assert hostref.decode(enc) == data
        if oracle.available():
            assert enc == ref_compress(data)
            assert ref_decompress(enc) == data


def test_all_256_symbols_block():
    # A block containing all 256 symbols serializes to 1025 tree entries.
    # The reference encodes it (overflowing its own 1024-entry buffer) but
    # cannot decode its own output (BTREE_OVERFLOW); this framework encodes
    # bit-exactly and deliberately accepts the stream on decode.
    oracle.require()
    data = bytes(range(256)) * 5
    enc = hostref.encode(data, 131072)
    assert enc == ref_compress(data)
    hdr = fmt.parse_block_header(memoryview(enc), 0)
    assert len(hdr.tree) == 1025
    assert hostref.decode(enc) == data
    with pytest.raises(Exception):
        ref_decompress(enc)  # the reference rejects its own output here


@pytest.mark.parametrize("seed", range(8))
def test_random_roundtrip_vs_oracle(seed):
    oracle.require()
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 5000))
    # Mix of skewed and near-uniform histograms.
    if seed % 2:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    else:
        probs = rng.dirichlet(np.full(8, 0.3))
        data = rng.choice(
            np.frombuffer(b"abcdefgh", np.uint8), n, p=probs
        ).astype(np.uint8).tobytes()
    bs = int(rng.choice([0, 1, 7, 256, 1024, 131072]))
    enc = hostref.encode(data, bs)
    ref = ref_compress(data, bs if bs else len(data))
    assert enc == ref, f"encode mismatch seed={seed} n={n} bs={bs}"
    assert hostref.decode(enc) == data
    # The reference cannot decode blocks containing all 256 symbols (its own
    # 1025-entry trees are rejected by its decoder) — skip the oracle decode
    # check for those.
    step = bs if bs else n
    arr = np.frombuffer(data, np.uint8)
    if all(
        len(np.unique(arr[o : o + step])) < 256 for o in range(0, n, step)
    ):
        assert ref_decompress(enc) == data


def test_adversarial_fibonacci_histogram():
    # Fibonacci-like frequencies produce a maximally deep tree.
    counts = [1, 1]
    while sum(counts) < 5000 and len(counts) < 64:
        counts.append(counts[-1] + counts[-2])
    data = b"".join(bytes([i]) * c for i, c in enumerate(counts))
    enc = hostref.encode(data, 0)
    if oracle.available():
        assert enc == ref_compress(data, len(data))
    assert hostref.decode(enc) == data


def test_decode_errors_mirror_reference():
    # Mirrors test/decode_test.c: empty input ok; garbage => BTREE_OVERFLOW;
    # truncated tree => READ_WRITE; undersized tree + short payload =>
    # BTREE_CORRUPTED.
    assert hostref.decode(b"") == b""
    with pytest.raises(BtreeOverflowError):
        hostref.decode(b"\xde\xad\xbe\xef\x00\x00\x00\x00\xff\x7f" + b"\x00" * 16)
    good = hostref.encode(b"0123456789", 65536)
    with pytest.raises(ReadWriteError):
        hostref.decode(good[:20])  # truncated inside the serialized tree
    # Undersized tree: claim fewer tree entries than the payload walk needs.
    bad = bytearray(good)
    bad[8:10] = (3).to_bytes(2, "little")  # tree_length = 3: [265, 264, 261]
    with pytest.raises((BtreeCorruptedError, ReadWriteError)):
        hostref.decode(bytes(bad))
    # tree_length == 0 with n_sym > 0: the reference NULL-derefs; we raise.
    hdr = fmt.BLOCK_HEADER.pack(5, 0)
    with pytest.raises(HuffmanError):
        hostref.decode(hdr + b"\x00\x00")


def test_candidate_header_scan():
    data = (b"The quick brown fox jumps over the lazy dog. " * 400)
    enc = hostref.encode(data, 1024)
    true_offs = [off for off, _, _ in hostref.scan_blocks(enc)]
    cands = fmt.find_candidate_headers(np.frombuffer(enc, np.uint8))
    assert set(true_offs) <= set(cands.tolist())
