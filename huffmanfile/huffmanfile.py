"""This module provides classes and convenience functions for compressing and
decompressing data using the Huffman compression algorithm.

The interface provided by this module is very similar to that of the
:mod:`bz2` module.  Backed by the JAX codec in :mod:`libhuffman_tpu`;
see libhuffman_tpu.api for the implementation and the reference-parity notes.
"""

from libhuffman_tpu.api import (  # noqa: F401
    HuffmanError,
    HuffmanFile,
    HuffmanCompressor,
    HuffmanDecompressor,
    compress,
    decompress,
    open,
)
from libhuffman_tpu.format import DEFAULT_BLOCK_SIZE, DEFAULT_MEM_LIMIT  # noqa: F401

__all__ = [
    "HuffmanError",
    "HuffmanFile",
    "HuffmanCompressor",
    "HuffmanDecompressor",
    "compress",
    "decompress",
]
