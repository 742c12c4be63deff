"""Profiling hooks and the persistent compilation cache (SURVEY.md
§5: the reference has none; this build adds jax.profiler tracing).

Set CATCH_TPU_PROFILE_DIR=/path to capture one trace per hot region
(cover scan, set-cover solve) into that directory on the region's
first execution; view with TensorBoard or xprof.  Unset (the default)
the hooks are free.
"""

import contextlib
import logging
import os
import threading

logger = logging.getLogger(__name__)

_captured = set()

# Process-wide phase accumulator: hot-path components (the scan
# pipeline, the designer's filter loop) report wall-clock here in
# addition to any per-object stats, so an end-to-end CLI run can be
# broken down without threading a stats object through every layer.
# Benchmarks reset it around a run and snapshot afterwards.  Lock-
# protected: the designer's group pipeline reports from worker
# threads, and an unlocked read-modify-write would drop updates.
phase_seconds = {}
_phase_lock = threading.Lock()


def add_phase(key, seconds):
    with _phase_lock:
        phase_seconds[key] = phase_seconds.get(key, 0.0) + seconds


def reset_phases():
    with _phase_lock:
        phase_seconds.clear()


def snapshot_phases():
    with _phase_lock:
        return {k: round(v, 2) for k, v in phase_seconds.items()}


# Fixed cache location inside the checkout (listed in .gitignore): a
# path that moved between runs would never hit.
_CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def compilation_cache_dir():
    """Directory of JAX's persistent compilation cache:
    JAX_COMPILATION_CACHE_DIR when set, else .jax_cache in the
    checkout."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or _CHECKOUT_CACHE_DIR)


def enable_compilation_cache():
    """Enable JAX's persistent compilation cache for this process.

    The scan and solve programs compile once per power-of-two shape
    bucket, so a disk-backed cache makes every run after the first
    start hot.  Called by the CLI entry points, bench.py and
    chip_smoke.py (not at library import, which must stay side-effect
    free).  Opt out with CATCH_TPU_NO_COMPILE_CACHE=1.
    """
    if os.environ.get("CATCH_TPU_NO_COMPILE_CACHE"):
        return
    import jax

    path = compilation_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


@contextlib.contextmanager
def maybe_trace(region):
    """Trace the wrapped block with jax.profiler on first execution.

    One capture per region name per process, so steady-state loops pay
    nothing and the trace directory stays small.
    """
    trace_dir = os.environ.get("CATCH_TPU_PROFILE_DIR")
    if not trace_dir or region in _captured:
        yield
        return
    _captured.add(region)
    import jax

    path = os.path.join(trace_dir, region)
    os.makedirs(path, exist_ok=True)
    logger.info("Capturing jax.profiler trace for region %r to %s",
                region, path)
    cm = None
    try:
        cm = jax.profiler.trace(path)
        cm.__enter__()
    except Exception:
        logger.exception("Could not start profiler trace for %r; "
                         "continuing without it", region)
        cm = None
    try:
        yield
    finally:
        if cm is not None:
            try:
                cm.__exit__(None, None, None)
            except Exception:
                logger.exception("Profiler trace for %r failed to "
                                 "finalize", region)
