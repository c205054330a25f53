"""Tracing / profiling hooks (SURVEY.md §5.1).

The reference has no observability at all (no timers, counters, or trace
hooks anywhere; its only stdio include, sys.h:5, is unused for logging).
The equivalents here are:

  * ``annotate(name)``   — a ``jax.profiler.TraceAnnotation`` around a host
                           phase so encode/decode stages show up as named
                           spans in a Perfetto/XProf trace;
  * ``start_trace`` /
    ``stop_trace``       — thin wrappers over ``jax.profiler`` producing a
                           Perfetto-compatible dump directory;
  * ``timed(name)`` +
    ``get_timings()``    — opt-in wall-clock accumulation per phase (used by
                           the benchmark harness; off by default so the
                           library stays as silent as the reference).

Nothing here is on the device hot path: annotations are host-side range
markers and the timers are plain ``perf_counter`` reads, enabled only when
``enable_timing(True)`` was called.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

_state = threading.local()
_timings: dict[str, list[float]] = defaultdict(list)
_timing_enabled = False


def enable_timing(on: bool = True) -> None:
    """Toggle wall-clock phase accumulation (off by default)."""
    global _timing_enabled
    _timing_enabled = on


def reset_timings() -> None:
    _timings.clear()


def get_timings() -> dict[str, list[float]]:
    """Per-phase wall-time samples (seconds) recorded since the last reset."""
    return {k: list(v) for k, v in _timings.items()}


@contextlib.contextmanager
def annotate(name: str):
    """Named span: a jax.profiler.TraceAnnotation when jax is importable
    (shows up in device traces), a no-op otherwise, plus optional timing."""
    t0 = time.perf_counter() if _timing_enabled else None
    try:
        from jax.profiler import TraceAnnotation
    except Exception:  # pragma: no cover - jax always present in this env
        TraceAnnotation = None
    if TraceAnnotation is not None:
        with TraceAnnotation(name):
            yield
    else:  # pragma: no cover
        yield
    if t0 is not None:
        _timings[name].append(time.perf_counter() - t0)


@contextlib.contextmanager
def timed(name: str):
    """Wall-clock-only span (no profiler annotation)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if _timing_enabled:
            _timings[name].append(time.perf_counter() - t0)


def start_trace(log_dir: str) -> None:
    """Begin a device+host profiler trace (Perfetto/XProf dump in log_dir)."""
    import jax

    jax.profiler.start_trace(log_dir)


def stop_trace() -> None:
    import jax

    jax.profiler.stop_trace()
