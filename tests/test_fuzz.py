"""Property-based fuzzing (SURVEY.md §5.2).

The reference's only "sanitizer" story is valgrind memcheck over its unit
tests (reference: test/CMakeLists.txt:8-26).  The JAX framework has no C
memory to check; the equivalent robustness surface is:

  * round-trip identity on arbitrary inputs and blocksizes,
  * structured errors (never crashes, hangs, or wrong output) on arbitrarily
    corrupted / truncated / garbage streams — mirroring the adversarial cases
    of reference test/decode_test.c:12-81 but generatively.
"""

import numpy as np
import pytest

hyp = pytest.importorskip("hypothesis")
from hypothesis import HealthCheck, given, settings, strategies as st

import huffmanfile
from libhuffman_tpu import decode as dec_mod
from libhuffman_tpu import encode as enc_mod
from libhuffman_tpu.errors import HuffmanError

_fuzz = settings(
    max_examples=40,
    deadline=None,
    suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large],
)


@given(
    data=st.binary(min_size=1, max_size=4096),
    blocksize=st.integers(min_value=1, max_value=1024),
)
@_fuzz
def test_roundtrip_any_input(data, blocksize):
    enc = enc_mod.encode(data, blocksize)
    assert dec_mod.decode(enc) == data


@given(
    data=st.binary(min_size=1, max_size=2048),
    blocksize=st.integers(min_value=1, max_value=512),
    flips=st.lists(
        st.tuples(st.integers(min_value=0), st.integers(min_value=1, max_value=255)),
        min_size=1,
        max_size=8,
    ),
)
@_fuzz
def test_corrupted_stream_never_crashes(data, blocksize, flips):
    """Arbitrary byte corruption either still decodes to *something* or
    raises a HuffmanError subclass — never an unstructured failure
    (mirrors reference test/decode_test.c's taxonomy generatively)."""
    enc = bytearray(enc_mod.encode(data, blocksize))
    for pos, delta in flips:
        enc[pos % len(enc)] ^= delta
    try:
        out = dec_mod.decode(bytes(enc))
        assert isinstance(out, bytes)
    except HuffmanError:
        pass


@given(
    data=st.binary(min_size=1, max_size=2048),
    blocksize=st.integers(min_value=1, max_value=512),
    cut=st.floats(min_value=0.0, max_value=1.0, exclude_max=True),
)
@_fuzz
def test_truncated_stream(data, blocksize, cut):
    """Any strict prefix of a valid stream raises (strict whole-stream
    semantics, src/decoder.c:218) while decode_prefix recovers exactly the
    complete blocks and reports the resume offset."""
    enc = enc_mod.encode(data, blocksize)
    n = int(cut * len(enc))
    prefix = enc[:n]
    try:
        out = dec_mod.decode(prefix)
        # Only acceptable if the prefix happens to be block-aligned.
        assert data.startswith(out)
        assert enc_mod.encode(data[: len(out)], blocksize) == prefix
    except HuffmanError:
        pass
    out, consumed = dec_mod.decode_prefix(prefix)
    assert consumed <= n
    assert data.startswith(out)
    # The consumed prefix re-encodes to itself (block-aligned resume point).
    if consumed:
        assert enc[:consumed] == enc_mod.encode(data[: len(out)], blocksize)


@given(garbage=st.binary(min_size=0, max_size=512))
@_fuzz
def test_garbage_input(garbage):
    """Pure garbage: empty input decodes to b'' (test/decode_test.c:32);
    everything else either raises HuffmanError or is a valid stream."""
    try:
        out = dec_mod.decode(garbage)
        if garbage == b"":
            assert out == b""
    except HuffmanError:
        pass


@given(
    parts=st.lists(st.binary(min_size=0, max_size=700), min_size=1, max_size=6),
    blocksize=st.integers(min_value=1, max_value=256),
)
@_fuzz
def test_incremental_compressor_equivalence(parts, blocksize):
    """Chunked compression is wire-identical to one-shot (the reference's
    whole-block buffering arithmetic, huffmanfile.py:313-319)."""
    comp = huffmanfile.HuffmanCompressor(blocksize)
    out = b"".join(comp.compress(p) for p in parts) + comp.flush()
    assert out == huffmanfile.compress(b"".join(parts), blocksize)


@given(
    data=st.binary(min_size=1, max_size=2000),
    chunk=st.integers(min_value=1, max_value=97),
)
@_fuzz
def test_incremental_decompressor_byte_drip(data, chunk):
    enc = huffmanfile.compress(data, 128)
    d = huffmanfile.HuffmanDecompressor()
    out = b"".join(d.decompress(enc[i : i + chunk]) for i in range(0, len(enc), chunk))
    assert out == data
