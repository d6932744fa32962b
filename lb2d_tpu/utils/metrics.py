"""Runtime self-checks and throughput metrics.

Rebuilds the reference's scattered in-code diagnostics as reusable pieces:

* :func:`mach_number` / :class:`MachWatchdog` — the ``check_max_ulb``
  stability watchdog (``porous_media/single_component.py:221-225``,
  ``screened_poisson_waves.py:347-351``): warn when the maximum lattice
  velocity approaches the sound speed.
* :func:`conservation_report` — the ``check_fields`` debug dump of per-field
  sums (``single_component.py:753-766``, ``multi.py:805-818``).
* :class:`MLUPSMeter` — wall-clock million-lattice-updates-per-second, the
  benchmark metric from ``docs/python_cython_opencl_comparison.ipynb``.

All device reductions happen on-device; only scalars come back to the host.
"""

from __future__ import annotations

import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np

from ..core.lattice import D2Q9

__all__ = ["mach_number", "MachWatchdog", "accumulated_sum",
           "conservation_report", "MLUPSMeter"]


def mach_number(u, v, lattice=D2Q9) -> float:
    """max |u| / cs over the grid (device reduction, scalar readback)."""
    umax = jnp.sqrt(jnp.max(u * u + v * v))
    return float(umax) / lattice.cs


class MachWatchdog:
    """Warn when flow speed exceeds ``tolerance * cs``
    (``single_component.py:221-225`` prints at 0.1 by default)."""

    def __init__(self, tolerance: float = 0.1, lattice=D2Q9):
        self.tolerance = tolerance
        self.lattice = lattice

    def check(self, u, v) -> float:
        ma = mach_number(u, v, self.lattice)
        if ma > self.tolerance:
            warnings.warn(
                f"Max Mach number {ma:.4f} exceeds tolerance "
                f"{self.tolerance}: simulation may be inaccurate/unstable",
                stacklevel=2)
        return ma


def accumulated_sum(x, accumulate: str = "f32") -> float:
    """Global sum of a device array with selectable accumulation.

    ``"f32"``: plain on-device ``jnp.sum`` — fine at notebook scales, but
    naive fp32 accumulation over 67M cells (8192^2) loses ~3-4 significant
    digits, which swamps the conservation drifts the dump exists to catch.
    ``"f64"``: the lane axis is reduced on device in 128-element windows
    (f32 absorption bounded to one window: ~7 * eps_f32 relative per
    window for similar-magnitude cells) and the small partials cross to
    host where numpy accumulates them in float64 — fp64-grade totals
    without requiring x64 mode (the reference is hard-fp64 here,
    ``single_component.cl:1-7``). Pathological dynamic
    range *within* a 128-cell window is not defended — conservation
    fields are homogeneous."""
    if accumulate == "f64":
        nx = x.shape[-1]
        if nx % 128 == 0 and nx > 128:
            x = x.reshape(*x.shape[:-1], nx // 128, 128)
        parts = np.asarray(jax.device_get(jnp.sum(x, axis=-1)),
                           dtype=np.float64)
        return float(parts.sum())
    return float(jnp.sum(x))


def conservation_report(f, rho=None, feq=None, accumulate: str = "f32") -> dict:
    """Sums of f (per direction collapsed), rho, feq — the ``check_fields``
    conservation dump. Returns host floats. ``accumulate="f64"`` switches
    to fp64-grade accumulation (see :func:`accumulated_sum`)."""
    out = {"sum_f": accumulated_sum(f, accumulate)}
    if rho is not None:
        out["sum_rho"] = accumulated_sum(rho, accumulate)
    if feq is not None:
        out["sum_feq"] = accumulated_sum(feq, accumulate)
    return out


class MLUPSMeter:
    """Measure throughput of a step callable over a state pytree.

    Waits for completion with ``jax.block_until_ready``.
    """

    def __init__(self, num_cells: int):
        self.num_cells = num_cells

    def measure(self, run_fn, state, num_steps: int):
        """``run_fn(state, n) -> state`` must be jitted. Returns
        (state, mlups)."""
        state = jax.block_until_ready(run_fn(state, jnp.int32(1)))  # warm
        t0 = time.perf_counter()
        state = jax.block_until_ready(run_fn(state, jnp.int32(num_steps)))
        dt = time.perf_counter() - t0
        return state, self.num_cells * num_steps / dt / 1e6

