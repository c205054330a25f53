"""Test configuration: CPU backend with 8 virtual devices by default.

Multi-device sharding is exercised without a GPU via XLA's host-platform
device-count override (SURVEY.md §5.8), and the Pallas kernels run in
interpret mode (ops/backend.py).  XLA_FLAGS must be set before the first
backend initialization.  Tests marked ``gpu`` need the card and skip
elsewhere; on a GPU machine run them with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402

# Persistent compile cache: DISABLED for the CPU suite by default.  This
# jax build's XLA:CPU AOT executable (de)serialization is unreliable:
# observed segfaults in executable.serialize() during cache writes AND in
# the loader when an entry compiled on a different host's CPU features is
# read back (the loader itself warns "machine type ... doesn't match ...
# SIGILL").  Opt back in with JAX_TEST_CACHE_DIR (the dir is then keyed by
# jax version + a host-CPU fingerprint).
_cache_root = os.environ.get("JAX_TEST_CACHE_DIR")
if _cache_root:
    import hashlib

    try:
        with open("/proc/cpuinfo", "rb") as f:
            _blob = f.read()
        _flags = b"\n".join(l for l in _blob.splitlines()
                            if l.startswith((b"flags", b"model name")))
    except OSError:
        _flags = b"unknown"
    _fp = hashlib.md5(_flags).hexdigest()[:10]
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(_cache_root, "v-" + jax.__version__ + "-" + _fp))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "bench"))  # corpora
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX's default backend is a GPU
    (decided per test, never at import: every worker collects the same
    tests)."""
    if (request.node.get_closest_marker("gpu")
            and jax.default_backend() != "gpu"):
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda pytest -m gpu")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """XLA:CPU segfaults deterministically deep in compile (or executable
    serialize) after ~50 tests' worth of accumulated in-process compile
    state — reproduced at the same suite position across four runs, never
    reproducible with the same tests in a fresh process.  Dropping the
    executable caches at module boundaries sheds that state; re-compiles
    across modules are the price."""
    yield
    jax.clear_caches()


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (big shapes, subprocess integration)",
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow: needs --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
