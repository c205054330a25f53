"""huffmanfile-compatible public API.

Drop-in surface of the reference Python binding (huffmanfile/huffmanfile.py):
``HuffmanError``, ``HuffmanFile``, ``HuffmanCompressor``,
``HuffmanDecompressor``, ``compress``, ``decompress``, ``open``, with the
same defaults (DEFAULT_BLOCK_SIZE=131072, DEFAULT_MEM_LIMIT=262144,
huffmanfile.py:26-27) — backed by the JAX codec instead of cffi'd C.

Deliberate fixes over the reference (SURVEY.md §7 item 8, each verified
against the reference's observable behavior in tests/test_api.py):
  * ``HuffmanCompressor.compress`` after ``flush`` raises ValueError instead
    of crashing on ``encoding()`` (huffmanfile.py:303-305 calls a bytes
    object);
  * ``HuffmanDecompressor`` is genuinely incremental: complete blocks are
    decoded as they arrive and partial tails are buffered, where the
    reference errors on the second call (confirmed defect, SURVEY.md §2
    item 18); one-shot use is byte-identical;
  * ``HuffmanFile.read`` therefore works for files larger than one gulp.
"""

from __future__ import annotations

import io
import os
from builtins import open as builtin_open

from . import decode as _decode_mod
from . import encode as _encode_mod
from .errors import HuffmanError
from .format import DEFAULT_BLOCK_SIZE, DEFAULT_MEM_LIMIT
from .streams import MemStream

__all__ = [
    "HuffmanError",
    "HuffmanFile",
    "HuffmanCompressor",
    "HuffmanDecompressor",
    "compress",
    "decompress",
]


class HuffmanCompressor:
    """Incremental compressor.

    Buffers input (through the L0 ``MemStream``, the membuf analogue the
    reference routes all codec bytes through) and encodes only whole
    multiples of ``blocksize`` per ``compress()`` call — each call is an
    independent encode run emitting self-contained blocks, exactly the
    reference's buffering arithmetic (huffmanfile.py:294-342); ``flush()``
    encodes the remainder.
    """

    def __init__(self, blocksize: int = DEFAULT_BLOCK_SIZE):
        if blocksize <= 0:
            raise ValueError("blocksize must be positive")
        self._blocksize = blocksize
        self._flushed = False
        self._stream = MemStream()

    def compress(self, data) -> bytes:
        """Provide data; returns compressed whole blocks when available."""
        if self._flushed:
            raise ValueError("Compressor has been flushed")
        self._stream.write(bytes(data))
        num_blocks = len(self._stream) // self._blocksize
        if num_blocks == 0:
            return b""
        head = self._stream.read(num_blocks * self._blocksize)
        carry = self._stream.read(len(self._stream))
        self._stream = MemStream()  # drop consumed backing storage
        self._stream.write(carry)
        return _encode_mod.encode(head, self._blocksize)

    def flush(self) -> bytes:
        """Encode any buffered remainder and finish; the compressor may not
        be used afterwards (returns b"" if called again — reference
        semantics, huffmanfile.py:350-353)."""
        if self._flushed:
            return b""
        self._flushed = True
        tail = self._stream.read(len(self._stream))
        self._stream.close()
        if not tail:
            return b""
        return _encode_mod.encode(tail, self._blocksize)


class HuffmanDecompressor:
    """Incremental decompressor.

    Decodes every complete block available so far and buffers partial
    tails; one-shot use matches the reference byte-for-byte
    (huffmanfile.py:385-400 — whose own incremental path is broken, see
    module docstring).
    """

    def __init__(self, memlimit: int = DEFAULT_MEM_LIMIT):
        import numpy as np

        # ``memlimit`` mirrors huf_config_t's reader/writer buffer sizing
        # (reference huffmanfile.py:375-376): it is a buffering *hint*, not
        # an enforced cap — the reference grows its membuf past it rather
        # than erroring, so there is no limit-exceeded condition to raise
        # (PARITY.md "memlimit").  Kept as the initial buffer capacity.
        self._memlimit = memlimit
        # Sliding-window buffer: a doubling uint8 array with a consumed
        # offset.  The round-3 MemStream form copied the whole buffered
        # stream on every feed (getvalue()[-n:]) — O(n^2) for byte-drip
        # feeding; views into this array cost nothing per feed.
        self._buf = np.empty(max(int(memlimit), 64), np.uint8)
        self._len = 0
        self._off = 0
        self._closed = False
        self._need = 1  # bytes the buffer must reach before the next attempt
        # Measurement-walk cache for the pending (incomplete) head block:
        # (sig, (node, restored, payload_pos)).  Carrying the walk across
        # feeds makes byte-drip decompression O(n) total walk work instead
        # of a full O(n) re-walk per feed (O(n^2)).
        self._walk_sig = None
        self._walk_state = None

    def _write(self, data: bytes) -> None:
        import numpy as np

        n = len(data)
        if self._len + n > len(self._buf):
            # Compact the consumed prefix first; double if still short.
            if self._off:
                live = self._len - self._off
                self._buf[:live] = self._buf[self._off:self._len]
                self._len = live
                self._off = 0
            cap = len(self._buf)
            while self._len + n > cap:
                cap *= 2
            if cap != len(self._buf):
                grown = np.empty(cap, np.uint8)
                grown[: self._len] = self._buf[: self._len]
                self._buf = grown
        self._buf[self._len : self._len + n] = np.frombuffer(data, np.uint8)
        self._len += n

    def _pending(self):
        return self._buf[self._off : self._len]

    def decompress(self, data) -> bytes:
        if self._closed:
            raise ValueError("Decompressor has been closed")
        self._write(bytes(data))
        # Skip attempts that cannot possibly complete a block: every symbol
        # consumes >= 1 bit, so the bound below is exact-never-late (a
        # completable buffer is always attempted) while turning byte-drip
        # feeding from O(n^2) re-decodes into O(code_len) attempts per block.
        if self._len - self._off < self._need:
            return b""
        out, consumed = _decode_mod.decode_prefix(self._pending())
        self._off += consumed
        self._need = self._tail_need()
        return out

    def _tail_need(self) -> int:
        from .format import BLOCK_HEADER, parse_block_header
        from .errors import ReadWriteError
        from .ops import hostref

        buf = self._pending()
        if len(buf) < BLOCK_HEADER.size:
            return BLOCK_HEADER.size
        try:
            hdr = parse_block_header(memoryview(buf), 0)
        except ReadWriteError:
            # Header parsed but the serialized tree is still short.
            import struct

            _, tree_len = BLOCK_HEADER.unpack_from(buf, 0)
            return BLOCK_HEADER.size + 2 * max(tree_len, 0) + 1
        except HuffmanError:
            return len(buf)  # corrupt: next attempt raises it properly
        if hdr.n_sym == 0:
            return len(buf)
        from . import native

        import numpy as np

        tree = np.asarray(hdr.tree, np.int16)
        use_native = native.available()
        sig = (hdr.n_sym, hdr.payload_off, tree.tobytes(), use_native)
        state = self._walk_state if sig == self._walk_sig else None
        payload = np.frombuffer(buf, np.uint8, offset=hdr.payload_off)
        if use_native:
            restored, state = native.walk_progress_resume(
                tree, payload, hdr.n_sym, state
            )
        else:
            restored, state = hostref.walk_progress_resume(
                tree, payload, hdr.n_sym, state
            )
        self._walk_sig, self._walk_state = sig, state
        return len(buf) + max(1, -(-(hdr.n_sym - restored) // 8))

    @property
    def needs_input(self) -> bool:
        return self._len - self._off > 0

    def close(self):
        """Release resources (reference parity, huffmanfile.py:402-406)."""
        self._closed = True
        self._len = self._off = 0


# HuffmanFile mode table: accepted spelling -> (raw-file mode, side).
_FILE_MODES = {
    "": ("rb", "r"), "r": ("rb", "r"), "rb": ("rb", "r"),
    "w": ("wb", "w"), "wb": ("wb", "w"),
    "x": ("xb", "w"), "xb": ("xb", "w"),
    "a": ("ab", "w"), "ab": ("ab", "w"),
}


class HuffmanFile(io.BufferedIOBase):
    """A file object providing transparent Huffman (de)compression.

    Behavior-compatible with the reference class (huffmanfile.py:45-181;
    re-derived, not transcribed): binary interface, modes r/w/x/a, path or
    file-object, not seekable; ``read(size)`` sizes the *compressed* read
    from the underlying file; ``write`` returns the uncompressed length.
    """

    def __init__(self, filename, mode="w", blocksize=DEFAULT_BLOCK_SIZE,
                 memlimit=DEFAULT_MEM_LIMIT):
        self._raw = None
        self._owns_raw = False
        self._side = None  # "r" | "w" | None == closed
        self._codec = None

        try:
            raw_mode, side = _FILE_MODES[mode]
        except KeyError:
            raise ValueError("Invalid mode: %r" % (mode,)) from None
        codec = (HuffmanDecompressor(memlimit) if side == "r"
                 else HuffmanCompressor(blocksize))

        if isinstance(filename, (str, bytes, os.PathLike)):
            self._raw = builtin_open(filename, raw_mode)
            self._owns_raw = True
        elif hasattr(filename, "read") or hasattr(filename, "write"):
            self._raw = filename
        else:
            raise TypeError(
                "filename must be a str, bytes, file or PathLike object"
            )
        self._side = side
        self._codec = codec

    def close(self):
        """Flush and close; idempotent.  Later operations raise ValueError."""
        if self._side is None:
            return
        side, codec, raw, owns = self._side, self._codec, self._raw, self._owns_raw
        self._side = None
        self._codec = None
        self._raw = None
        self._owns_raw = False
        try:
            if side == "w":
                raw.write(codec.flush())
            else:
                codec.close()
        finally:
            if owns:
                raw.close()

    @property
    def closed(self):
        return self._side is None

    @property
    def _fp(self):
        """Underlying binary file (reference-internal name kept: existing
        callers poke it, e.g. to peek for EOF)."""
        return self._raw

    def _live_raw(self):
        if self._side is None:
            raise ValueError("I/O operation on closed file")
        return self._raw

    def fileno(self):
        return self._live_raw().fileno()

    def seekable(self):
        return False

    def readable(self):
        self._live_raw()
        return self._side == "r"

    def writable(self):
        self._live_raw()
        return self._side == "w"

    def read(self, size=-1):
        """Read up to ``size`` *compressed* bytes from the underlying file
        and return their decompressed expansion (reference quirk kept:
        huffmanfile.py:152-162 sizes the compressed read)."""
        if not self.readable():
            raise io.UnsupportedOperation("File not open for reading")
        n = size if size >= 0 else io.DEFAULT_BUFFER_SIZE
        return self._codec.decompress(self._raw.read(n))

    def write(self, data):
        if not self.writable():
            raise io.UnsupportedOperation("File not open for writing")
        view = data if isinstance(data, (bytes, bytearray)) else memoryview(data)
        self._raw.write(self._codec.compress(view))
        return view.nbytes if isinstance(view, memoryview) else len(view)


def open(filename, mode="rb", encoding=None, errors=None, newline=None):
    """Open a Huffman-compressed file in binary or text mode
    (behavioral twin of reference huffmanfile.py:184-216)."""
    text = "t" in mode
    if text and "b" in mode:
        raise ValueError("Invalid mode: %r" % (mode,))
    if not text:
        for name, val in (("encoding", encoding), ("errors", errors),
                          ("newline", newline)):
            if val is not None:
                raise ValueError(
                    "Argument '%s' not supported in binary mode" % name
                )
    hf = HuffmanFile(filename, mode.replace("t", ""))
    return io.TextIOWrapper(hf, encoding, errors, newline) if text else hf


def compress(data, blocksize: int = DEFAULT_BLOCK_SIZE) -> bytes:
    """One-shot compress (huffmanfile.py:409-417)."""
    comp = HuffmanCompressor(blocksize)
    return comp.compress(data) + comp.flush()


def decompress(data, memlimit: int = DEFAULT_MEM_LIMIT) -> bytes:
    """One-shot decompress with the reference's strict whole-stream
    semantics: truncated or corrupt streams raise HuffmanError
    (huffmanfile.py:420-432)."""
    return _decode_mod.decode(bytes(data))
