"""Device (jitted, CPU-backend in tests) encode vs the host-exact codec."""

import numpy as np
import pytest

from libhuffman_tpu import encode as enc_mod
from libhuffman_tpu.ops import hostref
from oracle import reference_stream


def _check(data: bytes, blocksize: int):
    got = enc_mod.encode(data, blocksize)
    want = hostref.encode(data, blocksize)
    assert got == want
    assert hostref.decode(got) == data


def test_golden_small():
    _check(b"0123456789", 65536)
    _check(b"1", 256)
    _check(b"aab", 65536)
    _check(b"aabba", 2)


def test_single_symbol_runs():
    _check(b"a" * 1000, 131072)
    _check(b"\x00" * 4096, 256)


def test_all_256_symbols():
    _check(bytes(range(256)) * 17, 1024)


def test_multiblock_batching():
    data = (b"The quick brown fox jumps over the lazy dog. " * 1000)[:40000]
    _check(data, 1024)  # 40 blocks: exercises batch path
    got = enc_mod.encode(data, 512, batch_blocks=16)  # multiple batches
    assert got == hostref.encode(data, 512)


@pytest.mark.parametrize("seed", range(6))
def test_random_vs_oracle(seed):
    """Random inputs of three histogram shapes against the reference
    encoding (hostref, and the C reference when present)."""
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(1, 20000))
    kinds = [
        lambda: rng.integers(0, 256, n, dtype=np.uint8),
        lambda: rng.integers(97, 105, n, dtype=np.uint8),
        lambda: rng.choice(
            np.frombuffer(b" etaoinshrdlu", np.uint8),
            n,
            p=np.array([18, 10, 8, 8, 7, 7, 7, 6, 6, 6, 6, 6, 5]) / 100,
        ).astype(np.uint8),
    ]
    data = kinds[seed % 3]().tobytes()
    bs = int(rng.choice([0, 100, 1024, 65536]))
    got = enc_mod.encode(data, bs)
    assert got == reference_stream(data, bs if bs else len(data))
    assert hostref.decode(got) == data


def test_deep_tree_device_path():
    # Fibonacci frequencies make the deepest trees per byte: 22 symbols
    # (~17 KB) reach code depth ~20 — well past the resolve-LUT width but
    # inside the 32-bit device fast path — at a shape CPU tests can jit.
    counts = [1, 1]
    while len(counts) < 22:
        counts.append(counts[-1] + counts[-2])
    data = b"".join(bytes([i]) * c for i, c in enumerate(counts))
    _check(data, 0)


def test_overflow_flag_on_crafted_histogram():
    # Depth > MAX_CODE_BITS needs a multi-MB block of real data (Fib(34)
    # bytes); flag correctness is checked on a crafted histogram instead —
    # the encode driver re-routes flagged blocks to the host codec.
    import jax.numpy as jnp

    from libhuffman_tpu.ops import device as dev

    counts = [1, 1]
    while len(counts) < 40:
        counts.append(counts[-1] + counts[-2])
    freqs = np.zeros((1, 512), np.int32)
    freqs[0, : len(counts)] = counts
    left, right, parent, pbit, root = dev.build_trees(jnp.asarray(freqs))
    codes, lens, overflow = dev.extract_codes(parent, pbit)
    assert bool(np.asarray(overflow)[0])

    shallow = np.zeros((1, 512), np.int32)
    shallow[0, :4] = [3, 3, 3, 3]
    left, right, parent, pbit, root = dev.build_trees(jnp.asarray(shallow))
    codes, lens, overflow = dev.extract_codes(parent, pbit)
    assert not bool(np.asarray(overflow)[0])


def test_non_pow2_1024_multiple_blocksizes():
    """Blocksizes that are multiples of 1024 but not powers of two (3072,
    5120) stay wire-exact through encode and decode."""
    from libhuffman_tpu import decode as dec_mod
    from libhuffman_tpu import encode as enc_mod
    from libhuffman_tpu.ops import hostref

    data = (b"abcdefg hijklmnop " * 800)[:12 << 10]
    for bs in (3072, 5120):
        enc = enc_mod.encode(data, bs)
        assert enc == hostref.encode(data, bs), bs
        assert dec_mod.decode(enc) == data, bs


def test_histogram_matches_bincount():
    """The scatter-add histogram against np.bincount, with ragged valid
    lengths (zero padding must not count) and all-equal and all-distinct
    blocks."""
    import jax.numpy as jnp

    from libhuffman_tpu.ops import device as dev

    rng = np.random.default_rng(4)
    B, N = 5, 3000
    blocks = rng.integers(0, 256, (B, N), dtype=np.uint8)
    blocks[1] = 7
    blocks[2, :256] = np.arange(256)
    n_valid = np.array([N, N, 256, 1, 0], np.int32)
    for b in range(B):
        blocks[b, n_valid[b]:] = 0
    got = np.asarray(dev.histogram(jnp.asarray(blocks), jnp.asarray(n_valid)))
    assert got.shape == (B, 512) and not got[:, 256:].any()
    for b in range(B):
        want = np.bincount(blocks[b, : n_valid[b]], minlength=256)
        assert np.array_equal(got[b, :256], want), b


@pytest.mark.parametrize("max_len", [8, 24, 32])
def test_pack_words_matches_hostref(max_len):
    """The scatter-add packer against hostref.pack_bits for a codebook of
    1..max_len-bit codes: codes straddle word boundaries at every offset,
    and with max_len 32 codes of 25-32 bits straddle two words."""
    import jax.numpy as jnp

    from libhuffman_tpu.ops import device as dev

    rng = np.random.default_rng(max_len)
    lengths = rng.integers(1, max_len + 1, 256).astype(np.int32)
    lengths[:8] = np.arange(max_len - 7, max_len + 1)
    codes = (rng.integers(0, 1 << 32, 256, dtype=np.uint64)
             & ((np.uint64(1) << lengths.astype(np.uint64)) - np.uint64(1)))
    B, N = 3, 2000
    blocks = rng.integers(0, 256, (B, N), dtype=np.uint8)
    n_valid = np.array([N, 1234, 1], np.int32)
    C = codes[blocks].astype(np.uint32)
    L = np.where(np.arange(N)[None, :] < n_valid[:, None], lengths[blocks], 0)
    W = N  # 32 bits per position: room for any code
    words = dev.pack_words(jnp.asarray(C), jnp.asarray(L), W)
    got = np.asarray(dev.words_to_bytes(words))
    for b in range(B):
        want = hostref.pack_bits(blocks[b, : n_valid[b]], codes, lengths)
        assert got[b, : len(want)].tobytes() == want, b
        assert not got[b, len(want):].any(), b


def test_pallas_route_by_platform():
    """GPU compiles through Triton, CPU interprets, and any other platform
    raises naming itself."""
    from libhuffman_tpu.ops.backend import pallas_route

    assert pallas_route(1, "gpu")["backend"] == "triton"
    assert "compiler_params" in pallas_route(4, "gpu")
    assert pallas_route(1, "cpu") == {"backend": "triton", "interpret": True}
    with pytest.raises(NotImplementedError, match="'rocm'"):
        pallas_route(1, "rocm")


@pytest.mark.gpu
def test_encode_decode_compiled_on_gpu():
    """The compiled kernels (no interpret mode) at a real blocksize: wire
    bytes equal hostref and every block stays on the device path."""
    import corpora
    from libhuffman_tpu import decode as dec_mod

    data = corpora.text(4 << 20, seed=2)
    before = dec_mod.block_counts()
    enc = enc_mod.encode(data, 131072)
    assert enc == hostref.encode(data, 131072)
    assert dec_mod.decode(enc) == data
    assert dec_mod.block_counts()["host"] == before["host"]
