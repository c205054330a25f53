"""Smoke run of the codec on one NVIDIA GPU: kernels at real widths, then the
public API end to end.  Exits non-zero on any failure; the last line of a
passing run is one JSON object naming the device.

    python chip_smoke.py                 # the default run (one GPU)
    python chip_smoke.py --time-kernels  # also time device kernels against
                                         # their plain XLA alternatives
    python chip_smoke.py --devices 4     # only the sharded path, 4 GPUs

Phases of the default run:
  1. device — a GPU must be JAX's default device; the native host library
     must build.
  2. kernels — one encode batch of 128 x 131072 bytes of enwik-like text,
     byte-exact against ops/hostref; one real decode plan of that stream,
     byte-exact against the input and the true payload ends; a bit-flipped
     copy, whose corruption verdicts must match the host walk's.
  3. end to end — compress/decompress and encode/decode round trips of
     100 MiB of text (blocksizes 131072 and 65536) and 32 MiB of
     silesia-like mixed data, wire bytes against hostref on a 32 MiB
     prefix, and every block on the device path.

Walls printed here are smoke-run walls, not benchmark results.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "bench"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", str(ROOT / ".jax_cache"))

import corpora  # noqa: E402
from libhuffman_tpu import compress, decompress, native  # noqa: E402
from libhuffman_tpu import decode as dec_mod  # noqa: E402
from libhuffman_tpu import encode as enc_mod  # noqa: E402
from libhuffman_tpu.errors import BtreeCorruptedError, ReadWriteError  # noqa: E402,E501
from libhuffman_tpu.ops import decode_walk as walk  # noqa: E402
from libhuffman_tpu.ops import device as dev  # noqa: E402
from libhuffman_tpu.ops import hostref  # noqa: E402

MiB = 1 << 20


def log(*a):
    print(*a, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --------------------------------------------------------------------------
# Phase 1: device
# --------------------------------------------------------------------------

def phase_device(n_devices: int) -> None:
    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"no GPU: JAX's default device is {devs[0]}")
    check(len(devs) >= n_devices,
          f"{n_devices} GPUs wanted, {len(devs)} found")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    for line in smi.splitlines():
        log(f"card: {line}")
    log(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")
    t0 = time.perf_counter()
    native._lib()  # raises if the native library does not build
    check(native.available(), "native library unavailable")
    log(f"native library ready in {time.perf_counter() - t0:.2f} s")


# --------------------------------------------------------------------------
# Phase 2: kernels at real widths against the host reference
# --------------------------------------------------------------------------

def compile_timed(fn, *args, name: str):
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    log(f"{name}: compile {time.perf_counter() - t0:.2f} s; "
        f"memory_analysis {compiled.memory_analysis()}")
    return compiled


def host_walk(tree, payload: np.ndarray, n_sym: int):
    """("ok", symbols, end_bit), ("corrupt", bad_bit) or ("short",) from the
    host-exact walk of a staged payload."""
    try:
        return ("ok",) + hostref.decode_block_bits(tree, payload, n_sym)
    except BtreeCorruptedError as e:
        return ("corrupt", e.bad_bit)
    except ReadWriteError:
        return ("short",)


def phase_kernels(B: int = 128, N: int = 131072) -> None:
    data = np.frombuffer(corpora.text(B * N, seed=7), np.uint8)
    batch = data.reshape(B, N)
    n_valid = np.full(B, N, np.int32)
    W = enc_mod._words_per_block(N)
    enc_c = compile_timed(dev.encode_blocks, jnp.asarray(batch),
                          jnp.asarray(n_valid), W, name="encode_blocks")
    res = enc_c(jnp.asarray(batch), jnp.asarray(n_valid))
    jax.block_until_ready(res)
    overflow = np.asarray(res[5])
    check(not overflow.any(), f"{int(overflow.sum())} blocks flagged")
    stream = b"".join(enc_mod._assemble_batch(batch, n_valid, res))
    want = [hostref.encode_block(batch[b]) for b in range(B)]
    if stream != b"".join(want):
        off = 0
        for b, w in enumerate(want):
            check(stream[off:off + len(w)] == w,
                  f"encode block {b} differs from hostref")
            off += len(w)
    log(f"encode: {B} x {N} bytes, wire bytes equal hostref for every block")
    total_bits = np.asarray(res[1])

    plans, n_out = dec_mod.build_device_plans(stream)
    check(len(plans) == 1 and n_out == B * N, "one plan covers the batch")
    p = plans[0]
    check(all(e[0].n_sym == N for e in p.batch), "plan holds every block")
    order = sorted(range(B), key=lambda i: p.batch[i][0].off)
    args = (jnp.asarray(p.words), jnp.asarray(p.tables),
            jnp.asarray(p.n_sym), p.NP, p.OUTW, p.ns)
    dec_c = compile_timed(walk.decode_blocks, *args, name="decode_blocks")
    out, end_bit, corrupt, _bad = (np.asarray(r) for r in dec_c(*args[:3]))
    check(not corrupt[:B].any(), "no corruption in a clean plan")
    for rank, i in enumerate(order):
        check(np.array_equal(out[i, :N], batch[rank]),
              f"decoded block {rank} differs from the input")
        check(int(end_bit[i]) == int(total_bits[rank]),
              f"block {rank}: end bit {end_bit[i]} != {total_bits[rank]}")
    log(f"decode: plan of {p.words.shape[0]} lanes, NP={p.NP}, NS={p.ns}: "
        "symbols and payload ends equal the input")

    # Bit flips in every 8th block; the rest stay clean.
    rng = np.random.default_rng(11)
    words = p.words.copy()
    flipped = list(range(0, B, 8))
    for i in flipped:
        cap = p.batch[i][2]
        for bit in rng.integers(0, 8 * cap, 3):
            words[i, bit // 32] ^= np.uint32(1 << (31 - bit % 32))
    out, end_bit, corrupt, bad = (np.asarray(r) for r in dec_c(
        jnp.asarray(words), args[1], args[2]))
    n_corrupt = n_short = 0
    for i in range(B):
        c, _t, cap, _ns = p.batch[i]
        payload = words[i].byteswap().view(np.uint8)[:cap]
        host = host_walk(np.asarray(c.tree), payload, c.n_sym)
        if host[0] == "corrupt":
            n_corrupt += 1
            check(bool(corrupt[i]) and int(bad[i]) == host[1],
                  f"lane {i}: corrupt {corrupt[i]} bad {bad[i]}, host {host}")
        elif host[0] == "short":
            # The walk ran past the staged payload: the driver sees a
            # failing bit or an end beyond the cap.
            n_short += 1
            beyond = int(bad[i]) if corrupt[i] else int(end_bit[i]) - 1
            check(beyond >= 8 * cap, f"lane {i}: short read not reported")
        else:
            check(not corrupt[i] and int(end_bit[i]) == host[2]
                  and np.array_equal(out[i, :c.n_sym], host[1]),
                  f"lane {i}: decode differs from the host walk")
    log(f"corruption: {len(flipped)} blocks bit-flipped; {n_corrupt} corrupt "
        f"and {n_short} short by the host walk; every lane's verdict, failing "
        "bit, symbols and end agree with it")


# --------------------------------------------------------------------------
# Phase 3: the public API end to end
# --------------------------------------------------------------------------

def counts_delta(before_enc, before_dec):
    e, d = enc_mod.block_counts(), dec_mod.block_counts()
    return ({k: e[k] - before_enc[k] for k in e},
            {k: d[k] - before_dec[k] for k in d})


def timed(fn, *a, **kw):
    t0 = time.perf_counter()
    r = fn(*a, **kw)
    return r, time.perf_counter() - t0


def phase_end_to_end() -> None:
    text = corpora.text(100 * MiB)
    mixed = corpora.mixed(32 * MiB)
    for name, data, bs in (("text", text, 131072), ("text", text, 65536),
                           ("mixed", mixed, 131072)):
        label = f"{name} {len(data) // MiB} MiB @ {bs}"
        nblocks = -(-len(data) // bs)
        groups = -(-nblocks // enc_mod.DEFAULT_BATCH_BLOCKS)
        full = nblocks // enc_mod.DEFAULT_BATCH_BLOCKS
        if groups > 1 and full > 1:
            shp = jax.ShapeDtypeStruct(
                (enc_mod.DEFAULT_BATCH_BLOCKS, bs), jnp.uint8)
            nvs = jax.ShapeDtypeStruct((enc_mod.DEFAULT_BATCH_BLOCKS,),
                                       jnp.int32)
            compile_timed(dev.encode_blocks_many, ((shp, nvs),) * full,
                          enc_mod._words_per_block(bs),
                          name=f"encode_blocks_many[{full}] ({label})")
        e0, d0 = enc_mod.block_counts(), dec_mod.block_counts()
        enc, t_enc = timed(enc_mod.encode, data, bs)
        dec, t_dec = timed(dec_mod.decode, enc)
        check(dec == data, f"{label}: decode(encode(x)) != x")
        comp, t_comp = timed(compress, data, bs)
        check(comp == enc, f"{label}: compress != encode")
        plain, t_decomp = timed(decompress, comp)
        check(plain == data, f"{label}: decompress(compress(x)) != x")
        ecnt, dcnt = counts_delta(e0, d0)
        log(f"{label}: blocks by path: encode {ecnt}, decode {dcnt}")
        check(ecnt["host"] == 0 and ecnt["reencode"] == 0
              and ecnt["device"] == 2 * nblocks,
              f"{label}: encode blocks off the device path")
        check(dcnt["host"] == 0 and dcnt["device"] == 2 * nblocks,
              f"{label}: decode blocks off the device path")
        prefix = data[: 32 * MiB]
        check(enc_mod.encode(prefix, bs) == hostref.encode(prefix, bs),
              f"{label}: 32 MiB prefix differs from hostref.encode")
        log(f"{label}: smoke walls (not a benchmark): encode {t_enc:.2f} s, "
            f"decode {t_dec:.2f} s, compress {t_comp:.2f} s, decompress "
            f"{t_decomp:.2f} s; ratio {len(enc) / len(data):.4f}; 32 MiB "
            "prefix equals hostref.encode")


# --------------------------------------------------------------------------
# --devices N: the sharded path
# --------------------------------------------------------------------------

def phase_sharded(n: int) -> None:
    from libhuffman_tpu import DecodeConfig, EncodeConfig
    from libhuffman_tpu.parallel import block_mesh

    mesh = block_mesh(jax.devices()[:n])
    data = corpora.text(256 * MiB)
    one, t_one = timed(enc_mod.encode, data)
    sharded, t_sh = timed(enc_mod.encode, data,
                          config=EncodeConfig(mesh=mesh))
    check(sharded == one, "sharded encode differs from the one-device encode")
    dec, t_dec = timed(dec_mod.decode, sharded,
                       config=DecodeConfig(mesh=mesh))
    check(dec == data, "sharded decode(encode(x)) != x")
    log(f"sharded over {n} devices: 256 MiB text encodes to the one-device "
        f"bytes and decodes back; smoke walls (not a benchmark): one-device "
        f"encode {t_one:.2f} s, sharded encode {t_sh:.2f} s, sharded decode "
        f"{t_dec:.2f} s")


# --------------------------------------------------------------------------
# --time-kernels: device kernels against their plain XLA alternatives
# --------------------------------------------------------------------------

def device_ms(fn, *args, reps: int = 5) -> float:
    """Median wall of a jitted call on device-resident inputs, ending in
    block_until_ready (compiled and warmed first)."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


def histogram_nibble(blocks, n_valid, chunk: int = 8192):
    """ops/device.histogram as a bf16 nibble one-hot contraction with
    float32 accumulation (exact: counts < 2^24):
    count[s] = sum_j [hi_j == s >> 4][lo_j == s & 15]."""
    B, N = blocks.shape
    nib = jnp.arange(16)[None, :, None]
    chunk = min(chunk, N)

    def step(acc, xs):
        hi, lo = xs  # (B, chunk)
        return acc + jax.lax.dot_general(
            (hi[:, None, :] == nib).astype(jnp.bfloat16),
            (lo[:, None, :] == nib).astype(jnp.bfloat16),
            (((2,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.float32), None

    x = blocks.astype(jnp.int32).reshape(B, N // chunk, chunk).swapaxes(0, 1)
    acc, _ = jax.lax.scan(step, jnp.zeros((B, 16, 16), jnp.float32),
                          (x >> 4, x & 15))
    counts = acc.reshape(B, 256).astype(jnp.int32)
    return dev._finish_histogram(counts, N, n_valid)


def onehot_take(table, idx, chunk: int = 4096):
    """take_along_axis(table, idx, 1) for a (B, T) u32 table as a one-hot
    bf16 contraction with float32 accumulation, byte by byte."""
    B, T = table.shape
    pieces = jnp.stack([(table >> (8 * k)) & 0xFF for k in range(4)],
                       axis=-1).astype(jnp.bfloat16)  # (B, T, 4), exact
    N = idx.shape[1]
    chunk = min(chunk, N)

    def one(ix):  # (B, chunk)
        oh = (ix[:, :, None] == jnp.arange(T)[None, None, :]).astype(
            jnp.bfloat16)
        g = jax.lax.dot_general(oh, pieces, (((2,), (1,)), ((0,), (0,))),
                                preferred_element_type=jnp.float32)
        g = g.astype(jnp.uint32)
        return g[..., 0] | (g[..., 1] << 8) | (g[..., 2] << 16) | (
            g[..., 3] << 24)

    parts = jax.lax.map(one, idx.reshape(B, N // chunk, chunk).swapaxes(0, 1))
    return parts.swapaxes(0, 1).reshape(B, N)


def walk_plain(words, tables, n_sym, NP: int, NS: int, max_steps: int):
    """The walker's loop as plain lax.while_loop over symbols with (B,)
    carries, stopped after max_steps symbols."""
    B = words.shape[0]
    tab = tables.reshape(B, -1)
    rows = jnp.arange(B)

    def body(c):
        k, pos, cnt, out = c
        p = jnp.minimum(pos, NP - 1)
        w = p >> 5
        win = walk.window(words[rows, w], words[rows, w + 1],
                          (p & 31).astype(jnp.uint32))
        e = walk.resolve(win, NS, lambda cell, _need: jnp.take_along_axis(
            tab, cell.astype(jnp.int32)[:, None], axis=1)[:, 0])
        ln = (e & 63).astype(jnp.int32)
        act = (cnt < n_sym) & (ln > 0)
        out = out.at[rows, jnp.minimum(cnt, out.shape[1] - 1)].set(
            jnp.where(act, (e >> 6) & 255, out[rows, cnt]).astype(jnp.uint8))
        return (k + 1, jnp.where(act, pos + ln, pos),
                jnp.where(act, cnt + 1, cnt), out)

    out0 = jnp.zeros((B, max_steps), jnp.uint8)
    _, pos, cnt, out = jax.lax.while_loop(
        lambda c: c[0] < max_steps, body,
        (0, jnp.zeros(B, jnp.int32), jnp.zeros(B, jnp.int32), out0))
    return out, pos


def time_kernels(B: int = 128, N: int = 131072) -> None:
    data = np.frombuffer(corpora.text(B * N, seed=7), np.uint8)
    blocks = jnp.asarray(data.reshape(B, N))
    nv = jnp.full((B,), N, jnp.int32)
    W = enc_mod._words_per_block(N)
    shape = f"{B} x {N}"

    h_nib = jax.jit(histogram_nibble)
    h_sc = jax.jit(dev.histogram)
    check(bool(jnp.array_equal(h_nib(blocks, nv), h_sc(blocks, nv))),
          "histograms agree")
    log(f"time histogram nibble-contraction {shape}: "
        f"{device_ms(h_nib, blocks, nv):.3f} ms")
    log(f"time histogram scatter-add {shape}: "
        f"{device_ms(h_sc, blocks, nv):.3f} ms")

    freqs = h_nib(blocks, nv)
    trees = jax.jit(dev.build_trees)
    log(f"time build_trees {B} blocks: {device_ms(trees, freqs):.3f} ms")
    _l, _r, parent, pbit, _root = trees(freqs)
    ext = jax.jit(dev.extract_codes)
    codes, lens, _ovf = ext(parent, pbit)
    log(f"time extract_codes take_along_axis {B} blocks: "
        f"{device_ms(ext, parent, pbit):.3f} ms")

    def ext_onehot(parent, pbit):
        pp = ((parent + 1).astype(jnp.uint32)
              | (pbit.astype(jnp.uint32) << 10))
        node = jnp.broadcast_to(jnp.arange(256), (B, 256))
        for _ in range(dev.MAX_CODE_BITS):
            e = onehot_take(pp, node, chunk=256)
            node = jnp.where((e & 0x3FF) > 0, (e & 0x3FF).astype(jnp.int32)
                             - 1, node)
        return node

    log(f"time extract_codes one-hot contraction {B} blocks: "
        f"{device_ms(jax.jit(ext_onehot), parent, pbit):.3f} ms")

    lay = jax.jit(dev.symbol_layout)
    C, L = lay(blocks, codes, lens, nv)
    log(f"time symbol_layout take_along_axis {shape}: "
        f"{device_ms(lay, blocks, codes, lens, nv):.3f} ms")
    lay_oh = jax.jit(lambda b, c: onehot_take(c, b.astype(jnp.int32)))
    check(bool(jnp.array_equal(lay_oh(blocks, codes), C)),
          "one-hot layout agrees")
    log(f"time symbol_layout one-hot contraction {shape}: "
        f"{device_ms(lay_oh, blocks, codes):.3f} ms")

    pk = jax.jit(dev.pack_words, static_argnums=2)
    log(f"time pack scatter-add {shape}: {device_ms(pk, C, L, W):.3f} ms")
    enc = jax.jit(dev.encode_blocks, static_argnums=2)
    log(f"time encode_blocks {shape}: {device_ms(enc, blocks, nv, W):.3f} ms")

    # Decode: the walker against the plain while_loop walk on one real
    # plan, the plain walk stopped after a bounded number of symbols.
    stream = b"".join(enc_mod._assemble_batch(
        np.asarray(blocks), np.asarray(nv), enc(blocks, nv, W)))
    plans, _ = dec_mod.build_device_plans(stream)
    p = plans[0]
    a = (jnp.asarray(p.words), jnp.asarray(p.tables), jnp.asarray(p.n_sym))
    wk = jax.jit(walk.decode_blocks, static_argnums=(3, 4, 5))
    t_walk = device_ms(wk, *a, p.NP, p.OUTW, p.ns)
    log(f"time walker plan {p.words.shape[0]} lanes x {N} symbols "
        f"(NS={p.ns}): {t_walk:.3f} ms")
    steps = 2048
    pw = jax.jit(walk_plain, static_argnums=(3, 4, 5))
    t_plain = device_ms(pw, *a, p.NP, p.ns, steps, reps=3)
    out_w = np.asarray(wk(*a, p.NP, p.OUTW, p.ns)[0])
    out_p = np.asarray(pw(*a, p.NP, p.ns, steps)[0])
    check(np.array_equal(out_w[:, :steps], out_p), "plain walk agrees")
    log(f"time plain while_loop walk {p.words.shape[0]} lanes x {steps} "
        f"symbols: {t_plain:.3f} ms (x{N // steps} = "
        f"{t_plain * N / steps:.1f} ms scaled to the plan)")

    # Every plan of a 100 MiB text stream: device time and lane count.
    text = corpora.text(100 * MiB)
    for bs in (131072, 65536):
        plans, _ = dec_mod.build_device_plans(enc_mod.encode(text, bs))
        total = 0.0
        for i, p in enumerate(plans):
            t = device_ms(wk, jnp.asarray(p.words), jnp.asarray(p.tables),
                          jnp.asarray(p.n_sym), p.NP, p.OUTW, p.ns, reps=3)
            total += t
            log(f"time plan {i} of 100 MiB text @ {bs}: "
                f"{len(p.batch)} blocks on {p.words.shape[0]} lanes, "
                f"NP={p.NP}, NS={p.ns}: {t:.3f} ms")
        log(f"time all {len(plans)} plans of 100 MiB text @ {bs}: "
            f"{total:.3f} ms")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="run only the sharded path over this many GPUs")
    ap.add_argument("--time-kernels", action="store_true",
                    help="also time kernels against plain XLA versions")
    args = ap.parse_args()
    phase_device(args.devices)
    if args.devices > 1:
        phase_sharded(args.devices)
    else:
        phase_kernels()
        if args.time_kernels:
            time_kernels()
        phase_end_to_end()
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}))


if __name__ == "__main__":
    main()
