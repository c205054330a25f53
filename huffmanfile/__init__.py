"""Drop-in replacement for the ``huffmanfile`` package, GPU-backed.

Same public surface and wire format as the reference binding
(reference: huffmanfile/__init__.py), implemented by libhuffman_tpu.
"""

from .huffmanfile import *  # noqa
# The reference's star-import hides module-level ``open`` behind the
# submodule (its own test reaches it via ``from . import huffmanfile``);
# export it at package level too, like bz2/lzma do.
from .huffmanfile import open  # noqa: F401

__all__ = [
    "HuffmanError",
    "HuffmanFile",
    "HuffmanCompressor",
    "HuffmanDecompressor",
    "compress",
    "decompress",
]
