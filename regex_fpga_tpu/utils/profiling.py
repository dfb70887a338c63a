"""Profiling / tracing helpers (SURVEY.md SS5.1 — the reference's only
instrumentation is a cycle counter printed at the end of simulation,
``testbench_BLK_Mem.sv:19,52,84``)."""

from __future__ import annotations

import contextlib
import os
import time

__all__ = ["trace", "profile_to", "throughput_probe"]


@contextlib.contextmanager
def profile_to(logdir: str):
    """Capture a jax.profiler trace (view with TensorBoard/Perfetto)."""
    import jax

    os.makedirs(logdir, exist_ok=True)
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def trace(name: str):
    """Named region in the profiler timeline."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield


class throughput_probe:
    """Measure sustained bytes/s around device work.

    JAX returns before the device finishes: pass the work's result to
    ``stop``, which waits for it with ``jax.block_until_ready``."""

    def __init__(self, nbytes: int):
        self.nbytes = nbytes

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def stop(self, force_result=None) -> float:
        if force_result is not None:
            import jax

            jax.block_until_ready(force_result)
        self.seconds = time.perf_counter() - self.t0
        self.bytes_per_second = self.nbytes / self.seconds
        return self.bytes_per_second

    def __exit__(self, *exc):
        if not hasattr(self, "seconds"):
            self.stop()
