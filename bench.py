"""Benchmark harness: per-device codec throughput + wire exactness.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "GB/s", "vs_baseline": N, "detail": ...}

Two families of numbers:

  * device-resident — input blocks / compressed batches already in device
    memory, outputs left there: the per-device codec throughput;
  * end-to-end — bytes-in/bytes-out through the full Python API including
    host work and host<->device transfers (reported in detail fields).

``value`` is the combined device-resident throughput
(n / (t_enc + t_dec)); ``vs_baseline`` compares it against the compiled C
reference (single core, this machine, same corpus sample) since the
reference publishes no numbers (BASELINE.md).

Timing: every repetition salts its inputs and forces a host transfer of a
scalar checksum of the outputs.

Wire exactness: every run byte-compares this framework's compressed stream
against the compiled reference oracle on a corpus prefix (when its sources
are present), and round-trips the full corpus.

Environment knobs: BENCH_MB (corpus size cap, default 400), BENCH_BLOCK
(blocksize, default 65536), BENCH_SKIP_REF=1 (skip the C baseline),
BENCH_ORACLE_MB (exactness prefix, default 16).  The JAX compile cache is
JAX_COMPILATION_CACHE_DIR when set, else .jax_cache in the checkout.
"""

import functools
import json
import os
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(_ROOT, ".jax_cache"))


def _corpora():
    """Load bench/corpora.py (the bench/ dir is shadowed by this module's
    name, so spec-load it by path)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bench_corpora",
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "bench", "corpora.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def corpus(n_bytes: int) -> bytes:
    for cand in (os.environ.get("ENWIK8"), "enwik8", "/root/enwik8",
                 "/tmp/enwik8"):
        if cand and os.path.exists(cand):
            with open(cand, "rb") as f:
                return f.read(n_bytes)
    # Deterministic enwik-like text (bench/corpora.py): Zipf-weighted word
    # vocabulary over a full-width byte alphabet.  enwik8 blocks have ~205
    # distinct bytes producing Huffman trees 12-16 deep; a letters-only
    # corpus gives 27 symbols and depth ~7, which understates decode work
    # (measured round 3).
    # Generation costs ~9 s per 100 MB, so cache the deterministic bytes.
    cache = f"/tmp/libhuffman_bench_text_{n_bytes}.bin"
    try:
        if os.path.exists(cache) and os.path.getsize(cache) == n_bytes:
            with open(cache, "rb") as f:
                return f.read()
    except OSError:
        pass
    data = _corpora().text(n_bytes)
    try:
        with open(cache + ".tmp", "wb") as f:
            f.write(data)
        os.replace(cache + ".tmp", cache)
    except OSError:
        pass
    return data


def mixed_corpus(n_bytes: int) -> bytes:
    """Silesia-like composite (bench/corpora.py): near-incompressible
    sensor data + text + zero-heavy binary records, 256 KiB segments."""
    for cand in (os.environ.get("SILESIA"), "silesia.tar",
                 "/root/silesia.tar"):
        if cand and os.path.exists(cand):
            with open(cand, "rb") as f:
                return f.read(n_bytes)
    return _corpora().mixed(n_bytes)


def time_call(fn, *args, repeat=2):
    best = float("inf")
    r = None
    for _ in range(repeat):
        t0 = time.perf_counter()
        r = fn(*args)
        best = min(best, time.perf_counter() - t0)
    return r, best


def bench_encode_device(data: np.ndarray, bs: int, repeat=3):
    """Device-resident encode throughput: batches pre-staged on the device,
    fused into as few dispatches as the encode driver uses."""
    from libhuffman_tpu import encode as enc_mod
    from libhuffman_tpu.ops import device as dev

    n = len(data)
    nblk = -(-n // bs)
    BB = enc_mod.DEFAULT_BATCH_BLOCKS
    batches = []
    for s in range(0, nblk, BB):
        nb = min(BB, nblk - s)
        B = enc_mod._bucket_blocks(nb)
        arr = np.zeros((B, bs), np.uint8)
        seg = data[s * bs : min(n, (s + nb) * bs)]
        arr.reshape(-1)[: len(seg)] = seg
        nv = np.full(B, bs, np.int32)
        full = len(seg) // bs
        rem = len(seg) - full * bs
        nv[full:] = 0
        if rem:
            nv[full] = rem
        batches.append((jax.device_put(jnp.asarray(arr)),
                        jax.device_put(jnp.asarray(nv))))
    W = enc_mod._words_per_block(bs)

    # One dispatch per fused group: encode + checksum under a single jit.
    @functools.partial(jax.jit, static_argnums=())
    def enc_check(bs_nv, salt):
        acc = jnp.uint32(0)
        for payload, total_bits, left, right, root, overflow in (
                dev.encode_blocks_many(
                    tuple((b ^ salt, nv) for b, nv in bs_nv), W)):
            acc = (acc + jnp.sum(payload.astype(jnp.uint32))
                   + jnp.sum(total_bits.astype(jnp.uint32))
                   + jnp.sum(root.astype(jnp.uint32))
                   + jnp.sum(overflow.astype(jnp.uint32)))
        return acc

    FB = enc_mod.FUSE_BATCHES
    groups = [tuple(batches[g : g + FB])
              for g in range(0, len(batches), FB)]
    # Warm/compile; every timed repetition transfers a scalar checksum.
    for grp in groups:
        np.asarray(enc_check(grp, jnp.uint8(0)))
    best = float("inf")
    for rep in range(repeat):
        salt = jnp.uint8(rep + 1)  # defeat dispatch coalescing
        t0 = time.perf_counter()
        acc = [enc_check(grp, salt) for grp in groups]
        _ = [np.asarray(a) for a in acc]
        best = min(best, time.perf_counter() - t0)
    return n / best / 1e9


def decode_plans(enc: bytes):
    """Host-side decode plan building (scan, parse, table build, batching).

    Returns (plans, n_out)."""
    from libhuffman_tpu import decode as dec_mod

    return dec_mod.build_device_plans(enc)


def bench_decode_device(enc: bytes, repeat=3):
    """Device-resident decode throughput on the real compressed stream.

    Returns (dev_gbps, n_out, hostdev_gbps): the last number also counts
    the host-side plan building (candidate scan, header parse, native
    table build, batch layout) and the final output-byte assembly — i.e.
    everything a production host would do except the host<->device
    transfers.
    """
    t0 = time.perf_counter()
    plans, n_out = decode_plans(enc)
    t_plan = time.perf_counter() - t0
    arrays = tuple(
        (jax.device_put(jnp.asarray(p.words)),
         jax.device_put(jnp.asarray(p.tables)),
         jax.device_put(jnp.asarray(p.n_sym)))
        for p in plans
    )
    shapes = tuple((p.NP, p.OUTW, p.ns) for p in plans)
    from libhuffman_tpu.ops import decode_walk as ddec

    # One fused dispatch for the whole stream, checksum included.
    @functools.partial(jax.jit, static_argnums=(2,))
    def dec_check(arrs, salt, shp):
        salted = tuple((w ^ salt, t, ns) for (w, t, ns) in arrs)
        acc = jnp.uint32(0)
        for out, end_bit, corrupt, bad_bit in ddec.decode_blocks_many(
                salted, shp):
            acc = (acc + jnp.sum(out.astype(jnp.uint32))
                   + jnp.sum(end_bit.astype(jnp.uint32))
                   + jnp.sum(bad_bit.astype(jnp.uint32)))
        return acc

    np.asarray(dec_check(arrays, jnp.uint32(0), shapes))
    best = float("inf")
    for rep in range(repeat):
        t0 = time.perf_counter()
        np.asarray(dec_check(arrays, jnp.uint32(rep + 1), shapes))
        best = min(best, time.perf_counter() - t0)

    # Host-side output assembly, timed on pre-transferred results so only
    # the transfers are excluded: apply per-block results + ordered join.
    import libhuffman_tpu.decode as dec_mod

    host_res = [tuple(np.asarray(r) for r in res)
                for res in ddec.decode_blocks_many(arrays, shapes)]
    t0 = time.perf_counter()
    pieces = []
    for p, (out_h, end_h, cor_h, bad_h) in zip(plans, host_res):
        dec_mod._apply_plan_results(p, out_h, end_h, cor_h, bad_h)
        for c, *_rest in p.batch:
            if c.result is not None:
                pieces.append(c.result[0])
    _ = b"".join(pieces)
    t_asm = time.perf_counter() - t0
    hostdev = n_out / (best + t_plan + t_asm) / 1e9
    return n_out / best / 1e9, n_out, hostdev


def main():
    mb = int(os.environ.get("BENCH_MB", "400"))
    bs = int(os.environ.get("BENCH_BLOCK", "65536"))
    data = corpus(mb << 20)
    n = len(data)

    from libhuffman_tpu import decode as dec_mod
    from libhuffman_tpu import encode as enc_mod

    # Correctness first: full round-trip + oracle wire exactness.
    enc = enc_mod.encode(data, bs)
    dec = dec_mod.decode(enc)
    assert dec == data, "roundtrip failure in bench"
    wire_exact = None
    if os.environ.get("BENCH_SKIP_REF") != "1":
        try:
            from oracle import ref_compress

            om = int(os.environ.get("BENCH_ORACLE_MB", "16")) << 20
            om = (min(om, n) // bs) * bs or min(om, n)
            ref_bytes = ref_compress(data[:om], bs)
            ours = enc_mod.encode(data[:om], bs)
            wire_exact = ref_bytes == ours
            assert wire_exact, "compressed bytes differ from the C reference"
        except AssertionError:
            raise
        except Exception:
            wire_exact = None  # no toolchain for the oracle

    # End-to-end walls (include the host<->device transfers).
    _, t_enc = time_call(enc_mod.encode, data, bs, repeat=2)
    _, t_dec = time_call(dec_mod.decode, enc, repeat=2)

    # Device-resident throughput.
    dbuf = np.frombuffer(data, np.uint8)
    enc_dev_gbps = bench_encode_device(dbuf, bs)
    dec_dev_gbps, dec_dev_bytes, dec_hostdev_gbps = bench_decode_device(enc)
    t_enc_dev = n / enc_dev_gbps / 1e9
    t_dec_dev = n / dec_dev_gbps / 1e9 if dec_dev_bytes else float("inf")
    gbps = n / (t_enc_dev + t_dec_dev) / 1e9

    # Second corpus family: Silesia-like mixed binary (near-incompressible
    # + text + zero-heavy records) — different tree-shape regime than the
    # enwik-like headline corpus.
    corpora_rows = {}
    mix_mb = int(os.environ.get("BENCH_MIX_MB", "96"))
    if mix_mb:
        mdata = mixed_corpus(mix_mb << 20)
        menc = enc_mod.encode(mdata, bs)
        assert dec_mod.decode(menc) == mdata, "mixed-corpus roundtrip"
        m_exact = None
        if os.environ.get("BENCH_SKIP_REF") != "1":
            try:
                from oracle import ref_compress as _rc

                om = (min(4 << 20, len(mdata)) // bs) * bs
                m_exact = _rc(mdata[:om], bs) == enc_mod.encode(
                    mdata[:om], bs)
                assert m_exact, "mixed-corpus wire mismatch vs reference"
            except AssertionError:
                raise
            except Exception:
                m_exact = None
        mbuf = np.frombuffer(mdata, np.uint8)
        m_enc = bench_encode_device(mbuf, bs, repeat=2)
        m_dec, m_bytes, m_hostdev = bench_decode_device(menc, repeat=2)
        corpora_rows["silesia-mixed"] = {
            "bytes": len(mdata),
            "encode_gbps": round(m_enc, 4),
            "decode_gbps": round(m_dec, 4),
            "decode_hostdev_gbps": round(m_hostdev, 4),
            "ratio": round(len(menc) / len(mdata), 4),
            "wire_exact_vs_oracle": m_exact,
            "decode_device_out_bytes": m_bytes,
        }

    scaling = None
    if os.environ.get("BENCH_SCALING") != "0":
        import subprocess

        env = dict(os.environ)
        # CPU-only subprocess: only this process ever opens the GPU.
        env["JAX_PLATFORMS"] = "cpu"
        # XLA:CPU cache entries are machine code and loading entries built
        # for other CPU features SIGILLs (see tests/conftest.py); keep the
        # CPU subprocess's cache in a host-fingerprinted subdir.
        try:
            import hashlib

            with open("/proc/cpuinfo", "rb") as f:
                blob = f.read()
            flags = b"\n".join(l for l in blob.splitlines()
                               if l.startswith((b"flags", b"model name")))
            fp = hashlib.md5(flags).hexdigest()[:10]
        except OSError:
            fp = "unknown"
        env["JAX_COMPILATION_CACHE_DIR"] = os.path.join(
            jax.config.jax_compilation_cache_dir, "cpu-" + fp)
        try:
            r = subprocess.run(
                [sys.executable,
                 os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "bench", "scaling.py")],
                env=env, capture_output=True, timeout=900,
            )
            scaling = json.loads(r.stdout.decode().strip().splitlines()[-1])
        except Exception:
            scaling = None

    vs = None
    if os.environ.get("BENCH_SKIP_REF") != "1":
        try:
            from oracle import ref_compress, ref_decompress

            sub = data[: min(n, 16 << 20)]  # reference is slow; sample
            r_enc, rt_enc = time_call(ref_compress, sub, bs, repeat=1)
            _, rt_dec = time_call(ref_decompress, r_enc, repeat=1)
            ref_gbps = len(sub) / (rt_enc + rt_dec) / 1e9
            vs = gbps / ref_gbps
        except Exception:
            vs = None

    print(json.dumps({
        "metric": "enwik-corpus combined encode+decode throughput"
                  " (1 device, device-resident)",
        "value": round(gbps, 4),
        "unit": "GB/s",
        "vs_baseline": round(vs, 2) if vs else None,
        "detail": {
            "bytes": n, "blocksize": bs,
            "encode_gbps": round(enc_dev_gbps, 4),
            "decode_gbps": round(dec_dev_gbps, 4),
            "decode_hostdev_gbps": round(dec_hostdev_gbps, 4),
            "e2e_encode_gbps": round(n / t_enc / 1e9, 4),
            "e2e_decode_gbps": round(n / t_dec / 1e9, 4),
            "wire_exact_vs_oracle": wire_exact,
            "decode_device_out_bytes": dec_dev_bytes,
            "ratio": round(len(enc) / n, 4),
            "decode_jit_keys": len(dec_mod.compile_keys()),
            "device": str(jax.devices()[0]),
            **({"corpora": corpora_rows} if corpora_rows else {}),
            **({"scaling": scaling} if scaling else {}),
        },
    }))


if __name__ == "__main__":
    main()
