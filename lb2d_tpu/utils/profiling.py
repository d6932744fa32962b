"""Profiling helpers — the counterpart of the reference's
``PROFILING_ENABLE`` command queues and ``%%prun`` notebook cells
(SURVEY.md §5): ``jax.profiler`` traces plus simple step timing.
"""

from __future__ import annotations

import contextlib
import time

import jax

__all__ = ["trace", "time_steps"]


@contextlib.contextmanager
def trace(logdir: str = "/tmp/lb2d_trace"):
    """Capture a ``jax.profiler`` trace of the enclosed block (view with
    TensorBoard / xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def time_steps(model, num_steps: int = 100, repeats: int = 3):
    """Wall-clock a model's ``run`` and return per-step milliseconds and
    MLUPS for each repeat (first call warms the compile)."""
    jax.block_until_ready(model.run(1).state)
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(model.run(num_steps).state)
        dt = time.perf_counter() - t0
        out.append({
            "ms_per_step": dt * 1000 / num_steps,
            "mlups": model.num_cells * num_steps / dt / 1e6,
        })
    return out
