"""shard_map / sharded-jit encode over the block axis.

Design (SURVEY.md §5.7-5.8):

  * 1-D mesh ``('blocks',)`` over all devices; a stream of n bytes becomes
    ceil(n / blocksize) independent blocks, padded to a multiple of the mesh
    size and laid out ``P('blocks', None)``.
  * The whole encode pipeline (histogram -> tree -> codes -> pack) and the
    decode walker run per block, so each device runs them under shard_map
    on its own blocks with no communication; the only cross-device step is
    the final gather of ragged (payload, size) pairs for ordered assembly.
  * Multi-host: each host feeds its local shard of blocks;
    per-block compressed sizes are all-gathered (tiny), an exclusive scan
    gives every block its byte offset in the final stream, and payloads are
    assembled in block order.  On a single host the gather is a device->host
    copy.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import device as dev
from ..ops import decode_walk as ddec


def block_mesh(devices=None) -> Mesh:
    """1-D mesh over ``devices`` (default: all) with axis ``'blocks'``."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), ("blocks",))


def _encode_shard_mapped(mesh: Mesh, W: int):
    """shard_map-wrapped encode_blocks over the block axis: each device
    encodes its own blocks, with no collectives."""
    spec2 = P("blocks", None)
    vspec = P("blocks")
    return jax.shard_map(
        lambda b, nv: dev.encode_blocks.__wrapped__(b, nv, W),
        mesh=mesh, in_specs=(spec2, vspec),
        out_specs=(spec2, vspec, spec2, spec2, vspec, vspec),
        check_vma=False)


def encode_sharded(batch: np.ndarray, n_valid: np.ndarray, mesh: Mesh,
                   words_per_block: int | None = None):
    """Encode a (B, N) block batch sharded over ``mesh``.

    B must be a multiple of the mesh size (pad with n_valid == 0 blocks).
    Returns host numpy (payload, total_bits, left, right, root, overflow).

    ``words_per_block``: static word budget; defaults to the worst case
    (N words = 32 bits/byte) — callers with size knowledge pass less.
    """
    B, N = batch.shape
    assert B % mesh.devices.size == 0, (B, mesh.devices.size)
    W = words_per_block or N
    blocks = jax.device_put(batch, NamedSharding(mesh, P("blocks", None)))
    nv = jax.device_put(n_valid, NamedSharding(mesh, P("blocks")))
    res = jax.jit(_encode_shard_mapped(mesh, W))(blocks, nv)
    return tuple(np.asarray(r) for r in res)


def _decode_shard_mapped(mesh: Mesh, NP: int, OUTW: int, NS: int):
    """shard_map-wrapped decode_blocks over the block axis — blocks are
    fully independent, so there are no collectives at all."""
    spec2 = P("blocks", None)
    spec3 = P("blocks", None, None)
    vspec = P("blocks")

    def per_shard(w, t, n):
        return ddec.decode_blocks.__wrapped__(w, t, n, NP, OUTW, NS)

    return jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=(spec2, spec3, vspec),
        out_specs=(spec2, vspec, vspec, vspec),
        check_vma=False,  # pallas_call out_shapes carry no replication info
    )


@functools.partial(jax.jit, static_argnums=(1, 2))
def _decode_plans_sharded_step(arrays, shapes, mesh):
    return tuple(
        _decode_shard_mapped(mesh, *shp)(w, t, n)
        for (w, t, n), shp in zip(arrays, shapes)
    )


def decode_plans_sharded(plans, mesh: Mesh):
    """All device plans of a stream through shard_map, one dispatch.

    The sharded twin of ops/decode_walk.decode_blocks_many for the public
    ``DecodeConfig(mesh=...)`` path (reference outer loop being
    parallelized: src/decoder.c:218-275).  Plan lane counts are padded to
    a mesh multiple by the driver (decode._build_plans lane_mult)."""
    arrays = tuple(
        (jax.device_put(p.words, NamedSharding(mesh, P("blocks", None))),
         jax.device_put(p.tables, NamedSharding(mesh, P("blocks", None, None))),
         jax.device_put(p.n_sym, NamedSharding(mesh, P("blocks"))))
        for p in plans)
    shapes = tuple((p.NP, p.OUTW, p.ns) for p in plans)
    return _decode_plans_sharded_step(arrays, shapes, mesh)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _encode_many_step(args, W: int, mesh: Mesh):
    """Several sharded sub-batches in one dispatch (the sharded twin of
    ops/device.encode_blocks_many)."""
    step = _encode_shard_mapped(mesh, W)
    return tuple(step(b, nv) for b, nv in args)


def encode_stream_sharded(buf: np.ndarray, blocksize: int, mesh: Mesh) -> bytes:
    """Whole-stream encode over a device mesh.

    The stream splits into sub-batches of 256 blocks per device; every
    sub-batch uses the local driver's word budget, all of them fuse into
    one dispatch, and assembly (host re-encode of flagged blocks included)
    is the local driver's.
    """
    from ..encode import _assemble_batch, _words_per_block

    n = len(buf)
    if n == 0:
        return b""
    if blocksize <= 0:
        blocksize = n
    if blocksize > (1 << 21):
        # Oversized single blocks: same host-exact route as encode.encode.
        from ..ops import hostref

        return b"".join(hostref.encode_block(buf[off : off + blocksize])
                        for off in range(0, n, blocksize))
    nblocks = -(-n // blocksize)
    nd = mesh.devices.size
    W = _words_per_block(blocksize)
    group = 256 * nd
    spec = NamedSharding(mesh, P("blocks", None))
    vspec = NamedSharding(mesh, P("blocks"))
    host_batches = []
    staged = []
    for s in range(0, nblocks, group):
        nb = min(group, nblocks - s)
        B = -(-nb // nd) * nd
        batch = np.zeros((B, blocksize), np.uint8)
        n_valid = np.zeros(B, np.int32)
        seg = buf[s * blocksize : min(n, (s + nb) * blocksize)]
        batch.reshape(-1)[: len(seg)] = seg
        n_valid[:nb] = blocksize
        if s + nb == nblocks and n % blocksize:
            n_valid[nb - 1] = n % blocksize
        host_batches.append((batch, n_valid))
        staged.append((jax.device_put(batch, spec),
                       jax.device_put(n_valid, vspec)))
    results = _encode_many_step(tuple(staged), W, mesh)
    chunks: list[bytes] = []
    for (batch, n_valid), res in zip(host_batches, results):
        chunks.extend(_assemble_batch(batch, n_valid, res))
    return b"".join(chunks)


def assemble_stream(n_valid, total_bits, payload, left, right, root,
                    overflow, batch=None) -> bytes:
    """Ordered host assembly of a sharded encode's outputs.

    The per-block compressed size is header + ceil(total_bits/8); an
    exclusive scan of sizes gives each block its offset (the multi-host
    contract: sizes are what crosses hosts, payload bytes stay local until
    this final ordered concatenation).
    """
    from ..format import ArrayTree, pack_block, serialize_tree
    from ..ops import hostref
    from .. import native

    if native.available() and not np.asarray(overflow).any():
        # Whole-batch native assembly (one pass; encode.py's fast path).
        trees, lens_t = native.serialize_trees(
            np.ascontiguousarray(left, np.int32),
            np.ascontiguousarray(right, np.int32),
            np.ascontiguousarray(root, np.int32))
        plens = (np.asarray(total_bits).astype(np.int64) + 7) // 8
        return native.assemble_blocks(
            np.asarray(n_valid).astype(np.uint64), trees, lens_t,
            np.ascontiguousarray(payload, np.uint8), plens)

    out = []
    for b in range(len(n_valid)):
        nv = int(n_valid[b])
        if nv == 0:
            continue
        if overflow[b]:
            assert batch is not None, "overflow block needs raw input"
            out.append(hostref.encode_block(batch[b, :nv]))
            continue
        tree = serialize_tree(ArrayTree(left[b], right[b], int(root[b])))
        nbytes = (int(total_bits[b]) + 7) // 8
        out.append(pack_block(nv, tree, payload[b, :nbytes].tobytes()))
    return b"".join(out)
