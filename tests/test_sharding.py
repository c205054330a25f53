"""Multi-device sharding tests on the 8-device virtual CPU mesh."""

import numpy as np
import pytest

import jax


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_dryrun_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)
    ge.dryrun_multichip(4)


def test_entry_compiles():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)


def test_decode_config_mesh_matches_unsharded():
    """DecodeConfig(mesh=...) shards a whole-stream decode over the block
    axis and must be byte-equal to the single-device path."""
    from libhuffman_tpu import decode as dec_mod
    from libhuffman_tpu.config import DecodeConfig
    from libhuffman_tpu.ops import hostref
    from libhuffman_tpu.parallel import block_mesh

    data = (b"A sharded stream of many independent blocks! " * 800)[:24 << 10]
    enc = hostref.encode(data, 1024)  # 24 blocks
    mesh = block_mesh()
    got = dec_mod.decode(enc, config=DecodeConfig(mesh=mesh))
    assert got == data
    assert got == dec_mod.decode(enc)
    # error semantics survive the mesh path
    from libhuffman_tpu.errors import ReadWriteError

    with pytest.raises(ReadWriteError):
        dec_mod.decode(enc[:-3], config=DecodeConfig(mesh=mesh))


def test_encode_stream_sharded_wire_exact():
    """The sharded whole-stream encode (word budget, fused sub-batches,
    bucketed transfer) stays wire-exact."""
    from libhuffman_tpu.ops import hostref
    from libhuffman_tpu.parallel import block_mesh
    from libhuffman_tpu.parallel.shard import encode_stream_sharded

    rng = np.random.default_rng(11)
    # Mixed compressibility, incompressible tail included.
    data = ((b"the quick brown fox " * 400)[:4096] * 5
            + rng.integers(0, 256, 4096, dtype=np.uint8).tobytes())
    mesh = block_mesh()
    got = encode_stream_sharded(np.frombuffer(data, np.uint8), 1024, mesh)
    assert got == hostref.encode(data, 1024)


def test_sharded_encode_matches_unsharded():
    from libhuffman_tpu.parallel import block_mesh, encode_sharded
    from libhuffman_tpu.parallel.shard import assemble_stream
    from libhuffman_tpu.ops import hostref

    rng = np.random.default_rng(7)
    B, N = 16, 1000
    data = rng.choice(
        np.frombuffer(b"abcdefgh \n", np.uint8), B * N
    ).astype(np.uint8)
    batch = data.reshape(B, N)
    n_valid = np.full(B, N, np.int32)
    mesh = block_mesh()
    payload, total_bits, left, right, root, overflow = encode_sharded(
        batch, n_valid, mesh, words_per_block=N
    )
    stream = assemble_stream(
        n_valid, total_bits, payload, left, right, root, overflow, batch
    )
    assert stream == hostref.encode(data.tobytes(), N)
