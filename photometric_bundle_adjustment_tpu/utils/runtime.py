"""Runtime utilities: persistent compilation cache and matmul precision,
stage timers, profiling hooks, NaN canaries.

The reference has no tracing/profiling at all (SURVEY §5) — console
counters only.  Here: wall-clock stage timers (the counters the pipeline
logs are the de-facto regression oracle), an opt-in ``jax.profiler`` trace
context, a persistent XLA compilation cache (bucketed static shapes make
recompiles the dominant cost of short runs), and a debug-NaN switch that
plays the role of the reference's EIGEN_INITIALIZE_MATRICES_BY_NAN canary
(CMakeLists.txt:59-60).
"""

from __future__ import annotations

import contextlib
import os
import time


REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def compilation_cache_dir() -> str:
    """Where compiled executables persist: ``JAX_COMPILATION_CACHE_DIR``
    as given when it is set, else a fixed directory inside the checkout
    (the path is part of the cache key, so it must not move)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def configure_runtime() -> str:
    """Process-wide JAX settings every entry point applies before its
    first computation; returns the compilation cache directory.

    * Persistent compilation cache.  JAX reads ``JAX_COMPILATION_CACHE_DIR``
      itself, so the directory is only set here when that variable is not.
    * float32 matrix products at full precision.  The one-hot lifts,
      Gauss-Jordan steps and dense Cholesky assembly were validated at
      f32; the GPU would otherwise run them in TF32.  A deliberate local
      lowering stays explicit (``BAConfig.schur_matmul_precision``).
    """
    import jax

    path = compilation_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_default_matmul_precision", "float32")
    return path


def enable_nan_canary() -> None:
    """Raise on NaNs flowing out of jitted computations (debug builds)."""
    import jax

    jax.config.update("jax_debug_nans", True)


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """jax.profiler trace context; no-op when logdir is None."""
    if not logdir:
        yield
        return
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StageTimer:
    """Accumulating named wall-clock timers."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        return ", ".join(
            f"{k}={self.totals[k]:.2f}s/{self.counts[k]}x"
            for k in sorted(self.totals)
        )
