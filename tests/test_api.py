"""huffmanfile API parity tests.

Mirrors the reference's pytest suite one-for-one
(reference: huffmanfile/huffmanfile_test.py) plus the documented fixes and
the MemStream semantics from test/io_test.c.
"""

import io

import numpy as np
import pytest

import huffmanfile
from libhuffman_tpu.streams import MemStream
from oracle import reference_stream


# ---- reference huffmanfile_test.py, one-for-one -------------------------

def test_compress_decompress():
    data = b"a" * 1000
    c = huffmanfile.compress(data)
    d = huffmanfile.decompress(c)
    assert d == data
    assert c == reference_stream(data, 131072)  # wire-identical to the reference


def test_decompress_corrupted():
    with pytest.raises(huffmanfile.HuffmanError):
        data = b"\x08\x00\x00\x00\x00\x00\x00\x00\x02\x00"
        huffmanfile.decompress(data)


def test_compress_incremental():
    def gen_data(parts=10, partsize=1000):
        for _ in range(parts):
            yield b"z" * partsize

    comp = huffmanfile.HuffmanCompressor()
    out = bytes()
    data = bytes()
    for data_part in gen_data():
        out += comp.compress(data_part)
        data += data_part
    out += comp.flush()
    assert huffmanfile.decompress(out) == data


def test_write_file(tmp_path):
    data = """\
    Donec rhoncus quis sapien sit amet molestie. Fusce scelerisque vel augue
    nec ullamcorper. Nam rutrum pretium placerat. Aliquam vel tristique lorem,
    sit amet cursus ante. In interdum laoreet mi, sit amet ultrices purus
    pulvinar a. Nam gravida euismod magna, non varius justo tincidunt feugiat.
    Aliquam pharetra lacus non risus vehicula rutrum. Maecenas aliquam leo
    felis. Pellentesque semper nunc sit amet nibh ullamcorper, ac elementum
    dolor luctus. Curabitur lacinia mi ornare consectetur vestibulum."""

    filename = tmp_path / "archive.hm"
    with huffmanfile.open(filename, "wt") as f:
        f.write(data)
    with huffmanfile.open(filename, "rt") as f:
        content = f.read()
    assert content == data


# ---- incremental semantics (reference-broken, fixed here) ---------------

def test_incremental_compressor_wire_equivalence():
    # Each compress() call is an independent encode run of whole blocks; the
    # reference's buffering arithmetic (huffmanfile.py:313-319) must produce
    # the same stream as one-shot when chunks align.
    data = bytes(np.random.default_rng(1).integers(32, 127, 5000, dtype=np.uint8))
    comp = huffmanfile.HuffmanCompressor(1024)
    out = b""
    for i in range(0, len(data), 700):
        out += comp.compress(data[i : i + 700])
    out += comp.flush()
    assert out == reference_stream(data, 1024)
    assert huffmanfile.decompress(out) == data


def test_incremental_decompressor():
    data = b"The quick brown fox. " * 500
    enc = reference_stream(data, 1024)
    dec = huffmanfile.HuffmanDecompressor()
    out = b""
    for i in range(0, len(enc), 333):  # arbitrary chunking incl. mid-header
        out += dec.decompress(enc[i : i + 333])
    assert out == data


def test_incremental_decompressor_drip_walk_is_linear(monkeypatch):
    # Byte-drip feeding a single-block stream must do O(n) *total*
    # measurement-walk work: the resumable walk state (api.py _tail_need)
    # revisits no payload byte.  Count walked bytes through both backends'
    # entry points and assert they never exceed the payload length.
    data = bytes(np.random.default_rng(7).integers(97, 123, 1 << 15,
                                                   dtype=np.uint8))
    enc = reference_stream(data, 0)  # blocksize 0: one block (encoder.c:163-165)

    from libhuffman_tpu import native
    from libhuffman_tpu.ops import hostref

    walked = [0]
    real_native, real_host = native.walk_progress_resume, hostref.walk_progress_resume

    def count_native(tree, payload, n_sym, state=None):
        pos0 = state[2] if state else 0
        restored, st = real_native(tree, payload, n_sym, state)
        walked[0] += st[2] - pos0
        return restored, st

    def count_host(tree, payload, n_sym, state=None):
        pos0 = state[2] if state else 0
        restored, st = real_host(tree, payload, n_sym, state)
        walked[0] += st[2] - pos0
        return restored, st

    monkeypatch.setattr(native, "walk_progress_resume", count_native)
    monkeypatch.setattr(hostref, "walk_progress_resume", count_host)

    dec = huffmanfile.HuffmanDecompressor()
    out = b""
    step = 97  # drip in sub-block chunks, including mid-header feeds
    for i in range(0, len(enc), step):
        out += dec.decompress(enc[i : i + step])
    assert out == data
    payload_len = len(enc)  # header included: a safe upper bound
    assert walked[0] <= payload_len, (walked[0], payload_len)


def test_incremental_decompressor_big_drip_linear_buffer():
    # ~1 MB multi-block stream dripped in small chunks: the sliding-window
    # buffer must (a) decode correctly, (b) never hold more than a small
    # multiple of the pending tail (the round-3 MemStream version copied
    # the whole history every feed — O(n^2) for drip feeding).
    rng = np.random.default_rng(11)
    words = [bytes(rng.integers(97, 123, int(rng.integers(2, 9)),
                                dtype=np.uint8)) for _ in range(64)]
    data = b" ".join(words[int(i)] for i in
                     rng.integers(0, 64, 170_000))[: 1 << 20]
    enc = reference_stream(data, 65536)
    dec = huffmanfile.HuffmanDecompressor()
    out = []
    step = 4096
    for i in range(0, len(enc), step):
        out.append(dec.decompress(enc[i : i + step]))
    assert b"".join(out) == data
    # Compaction keeps capacity ~ max pending tail (one block + slack),
    # not the full stream history.
    assert len(dec._buf) < len(enc), (len(dec._buf), len(enc))


def test_compressor_after_flush_raises():
    comp = huffmanfile.HuffmanCompressor()
    comp.compress(b"abc")
    comp.flush()
    # The reference crashes with TypeError ("bytes object is not callable",
    # huffmanfile.py:303-305); we raise ValueError deliberately.
    with pytest.raises(ValueError):
        comp.compress(b"more")
    assert comp.flush() == b""  # second flush returns empty (parity)


def test_huffmanfile_binary_roundtrip(tmp_path):
    data = bytes(np.random.default_rng(2).integers(0, 250, 300000, dtype=np.uint8))
    fn = tmp_path / "blob.hm"
    with huffmanfile.HuffmanFile(fn, "wb", blocksize=4096) as f:
        for i in range(0, len(data), 50000):
            f.write(data[i : i + 50000])
    # Chunked reads (reference only supports one-gulp; fixed here).
    out = b""
    with huffmanfile.HuffmanFile(fn, "rb") as f:
        while True:
            part = f.read(8192)
            if not part and f._fp.peek(1) == b"":  # EOF of underlying file
                break
            out += part
    assert out == data


def test_huffmanfile_fileobj():
    bio = io.BytesIO()
    with huffmanfile.HuffmanFile(bio, "wb") as f:
        f.write(b"hello fileobj")
    bio.seek(0)
    with huffmanfile.HuffmanFile(bio, "rb") as f:
        assert f.read(10 ** 6) == b"hello fileobj"


def test_huffmanfile_modes(tmp_path):
    fn = tmp_path / "m.hm"
    with pytest.raises(ValueError):
        huffmanfile.HuffmanFile(fn, "q")
    f = huffmanfile.HuffmanFile(fn, "wb")
    assert f.writable() and not f.seekable()
    with pytest.raises(io.UnsupportedOperation):
        f.read()
    f.close()
    f.close()  # double close ok
    with pytest.raises(ValueError):
        f.writable()  # closed
    with pytest.raises(TypeError):
        huffmanfile.HuffmanFile(123)


# ---- MemStream semantics (test/io_test.c mirror) ------------------------

def test_memstream_write_len_and_doubling():
    s = MemStream(4)
    s.write(b"abcd")
    assert len(s) == 4 and s.capacity == 4
    s.write(b"ef")  # forces doubling realloc (io.c:84-103)
    assert len(s) == 6 and s.capacity == 8
    assert s.getvalue() == b"abcdef"


def test_memstream_cursor_reads():
    s = MemStream(0)
    s.write(b"0123456789")
    assert s.read(4) == b"0123"
    assert len(s) == 6  # len counts unread bytes (huf_memlen)
    assert s.read(100) == b"456789"  # clamped to available
    assert s.read(1) == b""  # empty read at exhaustion
    s.seek(0)
    assert s.read(3) == b"012"
    with pytest.raises(ValueError):
        s.seek(1)
    with pytest.raises(ValueError):
        s.seek(0, io.SEEK_END)
