"""Parallel device decode vs the host codec's streams, and error taxonomy."""

import numpy as np
import pytest

from libhuffman_tpu import decode as dec_mod
from libhuffman_tpu import encode as enc_mod
from libhuffman_tpu.errors import (
    BtreeCorruptedError,
    BtreeOverflowError,
    HuffmanError,
    ReadWriteError,
)
from oracle import reference_stream


def _roundtrip(data: bytes, bs: int):
    enc = reference_stream(data, bs if bs else len(data))
    got = dec_mod.decode(enc)
    assert got == data


def test_decode_golden_small():
    _roundtrip(b"0123456789", 65536)
    _roundtrip(b"1", 256)
    _roundtrip(b"aab", 65536)
    _roundtrip(b"aabba", 2)


def test_decode_multiblock_text():
    data = (b"The quick brown fox jumps over the lazy dog. " * 2000)[:65536]
    _roundtrip(data, 1024)
    _roundtrip(data, 4096)


def test_decode_single_symbol_run():
    # All-"a" blocks: 1-bit codes, the densest pointer-jump chains.
    _roundtrip(b"a" * 10000, 1024)


def test_decode_zero_run_candidate_explosion():
    # b"\x00" * N payloads are all-zero bytes: would flood the speculative
    # candidate scan if n_sym=0 offsets weren't filtered; either way the
    # chain must resolve (sequential fallback allowed).
    _roundtrip(b"\x00" * 30000, 4096)


@pytest.mark.parametrize("seed", range(5))
def test_decode_random_vs_oracle(seed):
    rng = np.random.default_rng(200 + seed)
    n = int(rng.integers(1, 30000))
    data = rng.integers(0, 256 if seed % 2 else 4, n, dtype=np.uint8).tobytes()
    bs = int(rng.choice([0, 100, 1024, 65536]))
    _roundtrip(data, bs)


def test_decode_long_same_size_run_chunking():
    # >128 same-P-bucket candidates: the plan splitter's chunks must never
    # reach past the bucket into larger-cap candidates (the cap <= P
    # invariant).
    data = (b"The quick brown fox jumps over the lazy dog. " * 8000)[:200 << 10]
    _roundtrip(data, 1024)


def test_decode_own_encode():
    import corpora

    data = corpora.text(20000, seed=12)
    enc = enc_mod.encode(data, 2048)
    assert dec_mod.decode(enc) == data


def test_decode_errors():
    assert dec_mod.decode(b"") == b""
    with pytest.raises(BtreeOverflowError):
        dec_mod.decode(b"\xde\xad\xbe\xef\x00\x00\x00\x00\xff\x7f" + b"\x00" * 16)
    good = reference_stream(b"0123456789", 65536)
    with pytest.raises(ReadWriteError):
        dec_mod.decode(good[:20])
    bad = bytearray(good)
    bad[8:10] = (3).to_bytes(2, "little")
    with pytest.raises((BtreeCorruptedError, ReadWriteError)):
        dec_mod.decode(bytes(bad))
    # Truncated payload: all-"a" stream cut mid-payload.
    enc = reference_stream(b"a" * 10000, 0)
    with pytest.raises(ReadWriteError):
        dec_mod.decode(enc[:-1])
    # Trailing garbage after a valid block.
    with pytest.raises(HuffmanError):
        dec_mod.decode(good + b"\x01\x02\x03")


def test_decode_matches_reference_on_trailing_block():
    # A second valid block appended: both must decode.
    e1 = reference_stream(b"hello world", 0)
    e2 = reference_stream(b"goodbye", 0)
    assert dec_mod.decode(e1 + e2) == b"hello worldgoodbye"


# --- decode safety valves -------------------------------------------------

def test_tightened_cap_short_read_retries_on_host(monkeypatch):
    """A speculative cap tightened below the true payload (the
    false-positive-candidate-inside-payload scenario) must route the block
    back to the host-exact walk, not raise or corrupt
    (decode.py _apply_plan_results cap < avail branches)."""
    from libhuffman_tpu import decode as dec_mod
    from libhuffman_tpu import native

    data = (b"The retry path must stay byte-exact under short caps. " * 3000
            )[:96 << 10]
    enc = enc_mod.encode(data, 4096)
    orig = dec_mod._payload_cap
    monkeypatch.setattr(
        dec_mod, "_payload_cap",
        lambda c, depth, nxt: max(96, orig(c, depth, nxt) // 3))
    fallbacks = []
    if native.available():
        orig_scan = native.scan_stream

        def spy(*a, **kw):
            fallbacks.append(1)
            return orig_scan(*a, **kw)

        monkeypatch.setattr(native, "scan_stream", spy)
    assert dec_mod.decode(enc) == data
    if native.available():
        assert fallbacks, "short caps must exercise the host retry path"


def test_threaded_header_scan_matches_reference_scanner():
    """The segmented (threaded) native header scan only engages above
    8 MB; its overlap/half-open-range splitting must reproduce the pure
    python scanner exactly, including candidates straddling segment
    boundaries."""
    from libhuffman_tpu import native
    from libhuffman_tpu.format import find_candidate_headers

    if not native.available():
        pytest.skip("needs the native library")
    rng = np.random.default_rng(123)
    # Dense candidate bait: periodic zero quads + plausible tree lengths.
    buf = rng.integers(0, 256, 9 << 20, dtype=np.uint8)
    buf[::97] = 0
    buf[1::97] = 0
    buf[2::97] = 0
    buf[3::97] = 0
    got = native.find_headers(buf)
    ref = find_candidate_headers(buf)
    assert np.array_equal(got, ref)


def test_non_unary_root_tree_matches_reference():
    """Crafted streams may serialize a tree whose root has a REAL right
    child (our encoder never emits one — src/tree.c:410-413 always wraps);
    the native table builder routes those to the host-exact walk, which
    must decode byte-identically to the reference."""
    import struct

    import oracle

    tree = [256, ord("a"), -1, -1, ord("b"), -1, -1]  # a="0", b="1"
    payload = bytes([0b01100000])  # a b b a + pad
    stream = (struct.pack("<Q", 4) + struct.pack("<h", len(tree))
              + b"".join(struct.pack("<h", v) for v in tree) + payload)
    if oracle.available():
        assert oracle.ref_decompress(stream) == b"abba", "oracle premise"
    assert dec_mod.decode(stream) == b"abba"
    # And the builder really does reject it from the device path.
    from libhuffman_tpu import native

    if native.available():
        buf = np.array(tree, np.int16)
        _t, ns, _mi, _ma = native.build_decode_tables(
            buf, np.array([0], np.int64), np.array([len(tree)], np.int32))
        assert int(ns[0]) < 0
