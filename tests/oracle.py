"""Test oracle: the compiled reference libhuffman, driven via ctypes.

Builds ``libhuffman_ref.so`` from the read-only reference sources at
``/root/reference`` when they are present (nothing from the reference is
copied into this repository) and exposes ``ref_compress`` /
``ref_decompress``.  Where the sources are absent, ``reference_stream``
falls back to ops/hostref, whose encoder the golden vectors of
test_hostref.py pin to the reference's bytes.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
import subprocess
import tempfile

import pytest

from libhuffman_tpu.ops import hostref

REF = pathlib.Path("/root/reference")


def available() -> bool:
    """Whether the reference sources are present to build the oracle."""
    return (REF / "src").is_dir()


def require() -> None:
    """Skip the calling test when the reference sources are absent."""
    if not available():
        pytest.skip(f"needs the C reference sources at {REF}")


def reference_stream(data: bytes, blocksize: int) -> bytes:
    """The expected wire bytes of ``data``: hostref's encoding, checked
    against the compiled reference as well when its sources are present.
    ``blocksize == 0`` means one block spanning the input."""
    want = hostref.encode(data, blocksize)
    if available():
        assert want == ref_compress(data, blocksize or len(data))
    return want


class HufReadWriter(ctypes.Structure):
    _fields_ = [
        ("stream", ctypes.c_void_p),
        ("write", ctypes.c_void_p),
        ("read", ctypes.c_void_p),
    ]


class HufConfig(ctypes.Structure):
    _fields_ = [
        ("length", ctypes.c_uint64),
        ("blocksize", ctypes.c_uint64),
        ("reader_buffer_size", ctypes.c_size_t),
        ("writer_buffer_size", ctypes.c_size_t),
        ("reader", ctypes.POINTER(HufReadWriter)),
        ("writer", ctypes.POINTER(HufReadWriter)),
    ]


@functools.lru_cache(maxsize=1)
def _lib():
    build = pathlib.Path(tempfile.gettempdir()) / "libhuffman_ref_oracle"
    build.mkdir(exist_ok=True)
    so = build / "libhuffman_ref.so"
    srcs = sorted(str(p) for p in (REF / "src").glob("*.c"))
    if not so.exists():
        subprocess.run(
            ["cc", "-std=c99", "-O2", "-fPIC", "-shared", "-I", str(REF / "include"),
             *srcs, "-o", str(so)],
            check=True,
        )
    lib = ctypes.CDLL(str(so))
    lib.huf_memopen.argtypes = [
        ctypes.POINTER(ctypes.POINTER(HufReadWriter)),
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_size_t,
    ]
    lib.huf_memlen.argtypes = [ctypes.POINTER(HufReadWriter), ctypes.POINTER(ctypes.c_size_t)]
    lib.huf_memrewind.argtypes = [ctypes.POINTER(HufReadWriter)]
    lib.huf_memclose.argtypes = [ctypes.POINTER(ctypes.POINTER(HufReadWriter))]
    lib.huf_encode.argtypes = [ctypes.POINTER(HufConfig)]
    lib.huf_decode.argtypes = [ctypes.POINTER(HufConfig)]
    lib.huf_error_string.restype = ctypes.c_char_p
    return lib


class _MemStream:
    def __init__(self, capacity: int = 1 << 16):
        lib = _lib()
        self._rw = ctypes.POINTER(HufReadWriter)()
        self._buf = ctypes.c_void_p()
        err = lib.huf_memopen(ctypes.byref(self._rw), ctypes.byref(self._buf), capacity)
        assert err == 0, err

    @property
    def this(self):
        return self._rw

    def write(self, data: bytes):
        write_fn = ctypes.CFUNCTYPE(
            ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t
        )(self._rw.contents.write)
        err = write_fn(self._rw.contents.stream, data, len(data))
        assert err == 0, err

    def __len__(self):
        n = ctypes.c_size_t()
        assert _lib().huf_memlen(self._rw, ctypes.byref(n)) == 0
        return n.value

    def getvalue(self) -> bytes:
        return ctypes.string_at(self._buf, len(self))

    def close(self):
        _lib().huf_memclose(ctypes.byref(self._rw))


class OracleError(Exception):
    def __init__(self, code: int):
        self.code = code
        super().__init__(_lib().huf_error_string(code).decode())


def ref_compress(data: bytes, blocksize: int = 131072) -> bytes:
    """One-shot huf_encode through membuf streams (mirrors huffmanfile.compress)."""
    lib = _lib()
    ist, ost = _MemStream(max(len(data), 16)), _MemStream(max(len(data), 16))
    try:
        if data:
            ist.write(data)
        cfg = HufConfig(
            length=len(data), blocksize=blocksize,
            reader_buffer_size=0, writer_buffer_size=0,
            reader=ist.this, writer=ost.this,
        )
        if len(data):
            err = lib.huf_encode(ctypes.byref(cfg))
            if err != 0:
                raise OracleError(err)
        return ost.getvalue()
    finally:
        ist.close()
        ost.close()


def ref_decompress(data: bytes) -> bytes:
    lib = _lib()
    ist, ost = _MemStream(max(len(data), 16)), _MemStream(max(len(data), 16))
    try:
        if data:
            ist.write(data)
        cfg = HufConfig(
            length=len(data), blocksize=0,
            reader_buffer_size=0, writer_buffer_size=0,
            reader=ist.this, writer=ost.this,
        )
        err = lib.huf_decode(ctypes.byref(cfg))
        if err != 0:
            raise OracleError(err)
        return ost.getvalue()
    finally:
        ist.close()
        ost.close()
