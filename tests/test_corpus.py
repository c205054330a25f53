"""Corpus-scale cross-check (>= 16 MB, enwik-like text + binary).

The unit suite maxes out at a few hundred KB; this mirrors the
BASELINE.json corpus intent (Silesia/enwik8-class inputs) with a
deterministic Zipf-text corpus: our stream must byte-equal the reference
encoding (reference_stream) and round-trip.  The 16 MB cases are ``gpu``
tests; the CPU suite covers the same logic at smaller sizes.
"""

import numpy as np
import pytest

from libhuffman_tpu import decode as dec_mod
from libhuffman_tpu import encode as enc_mod
from oracle import reference_stream

_MB = 16


def _corpus(n_bytes: int) -> bytes:
    rng = np.random.default_rng(42)
    letters = np.frombuffer(b"etaoinshrdlcumwfgypbvkjxqz", np.uint8)
    vocab = [bytes(rng.choice(letters, 1 + int(rng.integers(1, 9)))) + b" "
             for _ in range(4096)]
    ranks = np.arange(1, 4097, dtype=np.float64)
    probs = (1 / ranks) / (1 / ranks).sum()
    words = rng.choice(4096, size=n_bytes // 5, p=probs)
    out = b"".join(vocab[w] for w in words)
    while len(out) < n_bytes:
        out += out
    return out[:n_bytes]


@pytest.mark.gpu
def test_16mb_text_oracle_exact_roundtrip():
    data = _corpus(_MB << 20)
    ours = enc_mod.encode(data, 65536)
    assert ours == reference_stream(data, 65536)
    assert dec_mod.decode(ours) == data


def _families():
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "bench_corpora",
        pathlib.Path(__file__).resolve().parent.parent / "bench"
        / "corpora.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FAMILIES


@pytest.mark.parametrize("fam", ["xray", "samba", "mixed"])
def test_family_small_oracle_exact(fam):
    # CPU-scale slice of every corpus family (the full-size sweep is a
    # gpu test); pins wire-exactness on the near-incompressible,
    # zero-heavy, and composite regimes.
    data = _families()[fam](256 << 10)
    ours = enc_mod.encode(data, 65536)
    assert ours == reference_stream(data, 65536)
    assert dec_mod.decode(ours) == data


def test_oversized_single_block_oracle_exact():
    # blocksize=0 on a multi-MB input: one block beyond the device path's
    # 2 MiB limit (codes can exceed 32 bits) — must route to the
    # host-exact encoder and stay wire-exact.
    data = _families()["mixed"](3 << 20)
    ours = enc_mod.encode(data, 0)
    assert ours == reference_stream(data, len(data))
    assert dec_mod.decode(ours) == data


@pytest.mark.gpu
def test_mixed_family_corpus_scale():
    data = _families()["mixed"](_MB << 20)
    ours = enc_mod.encode(data, 65536)
    assert ours == reference_stream(data, 65536)
    assert dec_mod.decode(ours) == data


@pytest.mark.gpu
def test_16mb_mixed_blocksizes_oracle_exact():
    half = (_MB << 20) // 2
    data = _corpus(half) + np.random.default_rng(7).integers(
        0, 256, half, np.uint8).tobytes()
    for bs in (4096, 131072):
        ours = enc_mod.encode(data, bs)
        assert ours == reference_stream(data, bs)
    assert dec_mod.decode(enc_mod.encode(data, 131072)) == data
