"""Scaling efficiency on a virtual device mesh (BASELINE.md target: >= 85%).

Runs standalone in a CPU-backend process with 8 virtual devices (the same
simulation recipe as tests/ and the driver's multichip dryrun — SURVEY.md
§5.8): times the sharded whole-stream encode on a 1-device and an 8-device
mesh and reports efficiency = t1 / (8 * t8).

Caveat (recorded in the output): virtual devices share one physical CPU, so
8-way sharding cannot speed wall clock up — perfect sharding shows as
efficiency ~1/8 * (t1/t8) ~ 12.5%-per-device-equivalent... which is why the
reported ``efficiency`` instead normalizes by *work*: the sharded program
partitions with zero collectives on the block axis, so the honest statement
this harness can make without real multi-chip hardware is the overhead
ratio t8 / t1 (how much slower the 8-way-sharded program runs on the same
silicon).  A ratio near 1.0 means sharding added no redundant work or
communication; on real chips that translates to near-linear scaling.

Invoked by bench.py (subprocess, JAX_PLATFORMS=cpu) unless BENCH_SCALING=0.
"""

import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    import bench as bench_mod
    from libhuffman_tpu.parallel.shard import block_mesh, encode_sharded

    mb = int(os.environ.get("BENCH_SCALING_MB", "4"))
    bs = 65024
    data = np.frombuffer(bench_mod.corpus(mb << 20), np.uint8)
    nblk = len(data) // bs
    nblk -= nblk % 8
    batch = data[: nblk * bs].reshape(nblk, bs)
    n_valid = np.full(nblk, bs, np.int32)

    from libhuffman_tpu.parallel.shard import assemble_stream

    results = {}
    for nd in (1, 8):
        mesh = block_mesh(jax.devices()[:nd])
        encode_sharded(batch, n_valid, mesh, words_per_block=bs // 4)  # warm
        best = float("inf")
        best_asm = float("inf")
        # best-of-4: single measurements on this shared-CPU host swing
        # 1.0-1.4x with background load (the round-3 1.195-vs-1.002
        # discrepancy was exactly this noise, one number per run).
        for rep in range(4):
            salted = batch ^ np.uint8(rep + 1)
            t0 = time.perf_counter()
            res = encode_sharded(salted, n_valid, mesh,
                                 words_per_block=bs // 4)
            t1 = time.perf_counter()
            # The part that costs at scale beyond the device step: ordered
            # host assembly of the sharded outputs (the multihost gather's
            # local equivalent; sizes-only across hosts — SURVEY.md §5.8).
            assemble_stream(n_valid, res[1], res[0], res[2], res[3],
                            res[4], res[5], salted)
            best = min(best, t1 - t0)
            best_asm = min(best_asm, time.perf_counter() - t1)
        results[f"t{nd}"] = best
        results[f"asm{nd}"] = best_asm

    overhead = results["t8"] / results["t1"]
    print(json.dumps({
        "bytes": int(nblk * bs),
        "t1_s": round(results["t1"], 3),
        "t8_s": round(results["t8"], 3),
        "shard_overhead_ratio": round(overhead, 3),
        "assembly_t1_s": round(results["asm1"], 3),
        "assembly_t8_s": round(results["asm8"], 3),
        "note": "8 virtual devices share one CPU: ratio ~1.0 = zero-overhead"
                " partitioning (no collectives on the block axis); real-chip"
                " scaling efficiency ~ 1/ratio.  assembly_* = ordered host"
                " assembly wall (the cross-host cost is sizes-only,"
                " parallel/multihost.py)",
    }))


if __name__ == "__main__":
    main()
