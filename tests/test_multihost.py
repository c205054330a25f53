"""Multihost layer tests (SURVEY.md §5.8; parallel/multihost.py).

Two layers:
  * in-process nproc==1 smoke tests — the degenerate path every laptop run
    takes (process_count() == 1 short-circuits all gathers);
  * a real 2-process integration test: two subprocesses bring up
    jax.distributed on the CPU backend, encode/decode the same corpus via
    the multihost entry points, and must produce byte-identical streams
    that match a single-process encode.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))


def _corpus() -> bytes:
    rng = np.random.default_rng(11)
    return rng.choice(
        np.frombuffer(b"abcdefgh \n", np.uint8), 40_000
    ).astype(np.uint8).tobytes()


def test_single_process_paths():
    """nproc==1: multihost entry points degrade to the local pipeline."""
    from libhuffman_tpu import decode, encode
    from libhuffman_tpu.parallel import multihost

    data = _corpus()
    multihost.initialize(None, 1, 0)  # no-op
    stream = multihost.encode_stream_multihost(data, 4096)
    assert stream == encode.encode(data, 4096)
    assert multihost.decode_stream_multihost(stream) == data
    assert decode.decode(stream) == data


def test_allgather_bytes_single():
    from libhuffman_tpu.parallel.multihost import _allgather_bytes

    assert _allgather_bytes(b"abc") == [b"abc"]


def test_my_range_partition():
    """Block ranges must partition [0, n) contiguously in rank order."""
    from libhuffman_tpu.parallel.multihost import _my_range

    lo, hi = _my_range(17)
    assert (lo, hi) == (0, 17)


@pytest.mark.parametrize("gpus,pid,given,want", [
    (4, 6, None, [2]),     # bound round-robin to a local GPU
    (4, 1, [3], [3]),      # an explicit binding wins
    (0, 1, None, None),    # CPU hosts pass nothing
])
def test_initialize_binds_one_gpu_per_process(monkeypatch, gpus, pid, given,
                                              want):
    from libhuffman_tpu.parallel import multihost

    seen = {}
    monkeypatch.setattr(multihost, "_local_gpu_count", lambda: gpus)
    monkeypatch.setattr(multihost.jax.distributed, "initialize",
                        lambda *a, **kw: seen.update(kw))
    kw = {} if given is None else {"local_device_ids": given}
    multihost.initialize("localhost:1234", 8, pid, **kw)
    assert seen.get("local_device_ids") == want


@pytest.mark.slow
def test_two_process_roundtrip(tmp_path):
    """Two real processes over jax.distributed produce the single-process
    stream byte-for-byte (ordered assembly by rank, §5.8)."""
    port = _free_port()
    coordinator = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(HERE, "multihost_worker.py"),
             coordinator, "2", str(pid), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]

    from libhuffman_tpu import encode

    ref = encode.encode(_corpus(), 4096)
    for pid in range(2):
        with open(tmp_path / f"out_{pid}.json") as f:
            got = json.load(f)
        assert got["plain_ok"] is True
        assert got["stream_len"] == len(ref)
        assert got["stream_sha"] == hashlib.sha256(ref).hexdigest()
        # Sizes-only split (§5.8 option (b)): the rank-local segment is a
        # verbatim stream slice, and its cross-host traffic is just the
        # per-process size exchange (8 bytes x nproc), far below the
        # stream size.
        assert got["seg_ok"] is True
        assert got["dcn_sizes_only"] <= 64, got["dcn_sizes_only"]
        # Decode sizes-only split: cross-host bytes are the offset
        # broadcast + 24 B/candidate tables — table-only, far below the
        # 40 KB output.
        assert got["dseg_ok"] is True
        assert got["dseg_len"] > 0  # both ranks own real output
        assert got["dcn_decode_local"] <= 2048, got["dcn_decode_local"]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port
