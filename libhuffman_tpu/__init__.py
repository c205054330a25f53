"""A Huffman codec on NVIDIA GPUs in JAX, wire-compatible with libhuffman.

A from-scratch JAX re-design of the capabilities of ybubnov/libhuffman (the
C99 reference): per-block byte histograms, frequency-sorted tree
construction with the reference's exact tie-breaking, preorder tree headers,
and MSB-first bitstreams — bit-for-bit compatible with
``huf_encode``/``huf_decode`` — plus a ``huffmanfile``-compatible Python API.

Encode runs as one XLA program per block batch (scatter-add histogram ->
fixed-trip two-argmin tree build -> code extraction -> scatter-add bit
packing, ops/device.py); decode is a Pallas kernel compiled through Triton
in which each lane walks one block's codewords (ops/decode_walk.py).  Blocks
are fully independent (the format's latent parallelism axis) and shard
data-parallel over a ``jax.sharding.Mesh``.
"""

from .errors import (
    ErrorCode,
    HuffmanError,
    InvalidArgumentError,
    ReadWriteError,
    BtreeOverflowError,
    BtreeCorruptedError,
    error_string,
)
from .format import (
    DEFAULT_BLOCK_SIZE,
    DEFAULT_MEM_LIMIT,
    describe_tree,
    node_to_string,
)
from .config import DecodeConfig, EncodeConfig
from .histogram import Histogram
from .api import (
    HuffmanFile,
    HuffmanCompressor,
    HuffmanDecompressor,
    compress,
    decompress,
    open,
)
# Low-level one-shot entry points live on the submodules to avoid shadowing
# them: libhuffman_tpu.encode.encode(data, blocksize) and
# libhuffman_tpu.decode.decode(stream); the bz2-style API above is the
# public surface.
from . import encode, decode  # noqa: F401
# Auxiliary subsystems (SURVEY.md §5): block-aligned checkpoint/resume and
# tracing/profiling hooks.
from . import resume  # noqa: F401
from .utils import trace  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "ErrorCode",
    "HuffmanError",
    "InvalidArgumentError",
    "ReadWriteError",
    "BtreeOverflowError",
    "BtreeCorruptedError",
    "error_string",
    "HuffmanFile",
    "HuffmanCompressor",
    "HuffmanDecompressor",
    "compress",
    "decompress",
    "open",
    "DEFAULT_BLOCK_SIZE",
    "DEFAULT_MEM_LIMIT",
    "EncodeConfig",
    "DecodeConfig",
    "Histogram",
    "describe_tree",
    "node_to_string",
    "__version__",
]
