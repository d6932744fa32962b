"""Base machinery shared by every simulation model.

The reference drives 5-6 blocking kernel launches per step from the host
(``opencl_dim.py:372-387``). Here a model is a pure ``step(state) -> state``
function compiled once; ``run(n)`` executes ``n`` steps on-device inside a
single ``lax.fori_loop`` with the state buffer donated, so the host is never
in the loop and XLA fuses the whole step into a handful of memory passes.
"""

from __future__ import annotations

import time
from functools import partial

import jax
import numpy as np

__all__ = ["LBModel", "resolve_backend", "BACKENDS"]

# Every family runs its XLA step; "auto" resolves to it. PipeFlow adds the
# C++ CPU backend ("native").
BACKENDS = ("auto", "xla")


def resolve_backend(backend: str, extra: tuple[str, ...] = ()) -> str:
    """Validate a ``backend=`` request and resolve ``"auto"``.

    Raises ``ValueError`` naming the valid choices for anything else, so a
    request for a backend that no longer exists is never accepted silently.
    """
    valid = BACKENDS + tuple(extra)
    if backend not in valid:
        raise ValueError(
            f"unknown backend {backend!r}; valid backends: "
            + ", ".join(repr(b) for b in valid))
    return "xla" if backend == "auto" else backend


class LBModel:
    """Owns a state pytree and a compiled multi-step runner.

    Subclasses must set ``self.state`` (a pytree of device arrays) and
    implement :meth:`make_step` returning a pure ``step(state) -> state``.
    """

    backend = "xla"

    def __init__(self):
        self._step = self.make_step()
        self._run_compiled = jax.jit(partial(_run_loop, self._step),
                                     donate_argnums=0)
        self.steps_taken = 0
        self.last_mlups = None

    # -- to be provided by subclasses ---------------------------------------
    def make_step(self):
        raise NotImplementedError

    @property
    def num_cells(self) -> int:
        raise NotImplementedError

    # -- execution ------------------------------------------------------------
    def run(self, num_iterations: int, *, timed: bool = False):
        """Advance the simulation ``num_iterations`` steps on-device.

        Mirrors ``Pipe_Flow.run`` (``opencl_dim.py:372-387``). With
        ``timed=True`` blocks until done and records throughput in
        ``self.last_mlups`` (million lattice-site updates per second, the
        reference's benchmark metric).
        """
        if timed and not getattr(self, "_warm", False):
            # compile outside the timed region (a 0-step call builds the same
            # executable: the iteration count is a traced argument)
            self.state = jax.block_until_ready(
                self._run_compiled(self.state, np.int32(0)))
            self._warm = True
        t0 = time.perf_counter() if timed else None
        self.state = self._run_compiled(self.state, np.int32(num_iterations))
        if timed:
            jax.block_until_ready(self.state)
            dt = time.perf_counter() - t0
            self.last_mlups = self.num_cells * num_iterations / dt / 1e6
        self.steps_taken += num_iterations
        return self

    def block_until_ready(self):
        jax.block_until_ready(self.state)
        return self

    # -- device-side field access (for rendering without host round-trips) ----
    def device_field(self, name):
        """Return one 2-D field as a device array [ny, nx], or None if the
        model doesn't support device-side extraction (renderer falls back to
        ``get_fields``)."""
        return None

    # -- helpers ---------------------------------------------------------------
    @staticmethod
    def _to_host_xy(arr) -> np.ndarray:
        """Device ``[..., ny, nx]`` -> host ``[..., nx, ny]`` to match the
        reference's (x, y)-indexed field arrays (``opencl_dim.py:390-415``)."""
        a = np.asarray(arr)
        return np.swapaxes(a, -1, -2)


def _run_loop(step, state, n):
    return jax.lax.fori_loop(0, n, lambda i, s: step(s), state)
