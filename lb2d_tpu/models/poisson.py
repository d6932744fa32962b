"""LBM Poisson solver (Chai & Shi style), iterate-to-steady-state.

Rebuilds ``poisson/solver.py`` (``Poisson_Solver``): a diffusion LBM with the
special feq ``(w_0 - 1) rho`` / ``w_j rho`` (``D2Q9_poisson.cl:1-31``),
density recovered as ``(9/5) sum_{j>=1} f_j`` (``:59``), a per-step source
``w_j * S * dt * D`` in collision (``:65-97``), Dirichlet density on all four
walls + corners via weight-renormalized redistribution (``:149-254``), and a
convergence test ``avg|drho| / avg rho < tol`` that stops the iteration and
triggers a central-difference negative gradient (``solver.py:324-358``).

Changes from the reference: it does a device->host sync *per iteration*
for the convergence reduction (``solver.py:348-352``); here the entire
iterate-check-stop loop is one ``lax.while_loop`` with on-device reductions
— zero host round-trips.

Reproduced quirks (documented, verified against the reference's consumers):

* The source is scaled **twice** by ``D_lb * dt`` — once in ``update_source``
  (``solver.py:157-158``) and once in the collision kernel
  (``D2Q9_poisson.cl:83``). We keep both stages so coupled models
  (``repelling_fisher_waves_old.py:380-392``) see identical magnitudes.
* ``update_negative_gradient`` writes the **y**-derivative into ``u`` and the
  **x**-derivative into ``v`` (``D2Q9_poisson.cl:294-304``) with
  zero-padded edges; consumers compensate. Preserved verbatim.
* The gradient is only refreshed when the loop *converges*
  (``solver.py:354-358``); a non-converged ``run`` leaves u, v stale.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.lattice import D2Q9
from ..ops.equilibrium import feq_poisson
from ..ops.moments import rho_poisson
from ..ops.stream import stream

__all__ = ["PoissonSolver"]


def _poisson_bcs(f, rho_b, w):
    """Dirichlet-density walls + corners (``D2Q9_poisson.cl:149-254``).

    On each boundary cell the three populations streaming in from outside are
    replaced by ``w_j * rho_to_add`` with
    ``rho_to_add = -(sum known f + (w_0 - 1) rho_b) / (sum unknown w)``.
    """
    s = f  # snapshot semantics: each region's formula reads pre-BC values

    def redistribute(known_sum, unknown):
        denom = sum(w[j] for j in unknown)
        return -(known_sum + (w[0] - 1.0) * rho_b) / denom

    # north wall (on_top): unknown 4, 7, 8
    k = s[1, -1, 1:-1] + s[2, -1, 1:-1] + s[3, -1, 1:-1] + s[5, -1, 1:-1] + s[6, -1, 1:-1]
    r = redistribute(k, (4, 7, 8))
    f = f.at[4, -1, 1:-1].set(w[4] * r).at[7, -1, 1:-1].set(w[7] * r).at[8, -1, 1:-1].set(w[8] * r)
    # east wall (on_right): unknown 3, 6, 7
    k = s[1, 1:-1, -1] + s[2, 1:-1, -1] + s[4, 1:-1, -1] + s[5, 1:-1, -1] + s[8, 1:-1, -1]
    r = redistribute(k, (3, 6, 7))
    f = f.at[3, 1:-1, -1].set(w[3] * r).at[6, 1:-1, -1].set(w[6] * r).at[7, 1:-1, -1].set(w[7] * r)
    # south wall (on_bottom): unknown 2, 5, 6
    k = s[1, 0, 1:-1] + s[3, 0, 1:-1] + s[4, 0, 1:-1] + s[7, 0, 1:-1] + s[8, 0, 1:-1]
    r = redistribute(k, (2, 5, 6))
    f = f.at[2, 0, 1:-1].set(w[2] * r).at[5, 0, 1:-1].set(w[5] * r).at[6, 0, 1:-1].set(w[6] * r)
    # west wall (on_left): unknown 1, 5, 8
    k = s[2, 1:-1, 0] + s[3, 1:-1, 0] + s[4, 1:-1, 0] + s[6, 1:-1, 0] + s[7, 1:-1, 0]
    r = redistribute(k, (1, 5, 8))
    f = f.at[1, 1:-1, 0].set(w[1] * r).at[5, 1:-1, 0].set(w[5] * r).at[8, 1:-1, 0].set(w[8] * r)

    # corners (D2Q9_poisson.cl:225-252)
    k = s[3, 0, 0] + s[4, 0, 0] + s[6, 0, 0] + s[7, 0, 0] + s[8, 0, 0]
    r = redistribute(k, (1, 2, 5))
    f = f.at[1, 0, 0].set(w[1] * r).at[2, 0, 0].set(w[2] * r).at[5, 0, 0].set(w[5] * r)
    k = s[1, 0, -1] + s[4, 0, -1] + s[5, 0, -1] + s[7, 0, -1] + s[8, 0, -1]
    r = redistribute(k, (2, 3, 6))
    f = f.at[2, 0, -1].set(w[2] * r).at[3, 0, -1].set(w[3] * r).at[6, 0, -1].set(w[6] * r)
    k = s[2, -1, 0] + s[3, -1, 0] + s[5, -1, 0] + s[6, -1, 0] + s[7, -1, 0]
    r = redistribute(k, (1, 4, 8))
    f = f.at[1, -1, 0].set(w[1] * r).at[4, -1, 0].set(w[4] * r).at[8, -1, 0].set(w[8] * r)
    k = s[1, -1, -1] + s[2, -1, -1] + s[5, -1, -1] + s[6, -1, -1] + s[8, -1, -1]
    r = redistribute(k, (3, 4, 7))
    f = f.at[3, -1, -1].set(w[3] * r).at[4, -1, -1].set(w[4] * r).at[7, -1, -1].set(w[7] * r)
    return f


def negative_gradient(rho, delta_x):
    """Central-difference negative gradient with zero-padded edges; note the
    reference's axis swap: ``u`` gets the y-derivative, ``v`` the
    x-derivative (``D2Q9_poisson.cl:294-304``)."""
    yp = jnp.pad(rho[1:, :], ((0, 1), (0, 0)))
    ym = jnp.pad(rho[:-1, :], ((1, 0), (0, 0)))
    xp = jnp.pad(rho[:, 1:], ((0, 0), (0, 1)))
    xm = jnp.pad(rho[:, :-1], ((0, 0), (1, 0)))
    u = -(yp - ym) / (2.0 * delta_x)
    v = -(xp - xm) / (2.0 * delta_x)
    return u, v


class PoissonSolver:
    """API mirror of ``Poisson_Solver`` (``poisson/solver.py:56-376``).

    Args:
      nx, ny: grid size (note: reference arrays are (nx, ny) x-major; ours
        are [ny, nx] with identical cell indexing).
      sources: source field, ``[ny, nx]`` (or reference-layout ``[nx, ny]``
        via ``sources_xy=True``).
      delta_t, delta_x: lattice scales of the *embedding* simulation; the
        solver's diffusivity is ``D_lb = dt/dx^2`` and
        ``omega = (0.5 + D_lb/cs^2)^-1`` (``solver.py:144-150``).
      rho_on_boundary: Dirichlet boundary density.
      tolerance: convergence threshold for ``avg|drho|/avg rho``.
    """

    def __init__(self, nx=None, ny=None, sources=None, delta_t=None,
                 delta_x=None, rho_on_boundary=0.0, tolerance=1e-6,
                 seed=0, dtype=jnp.float32, sources_xy=False,
                 check_every=10):
        self.nx, self.ny = int(nx), int(ny)
        self.delta_x = float(delta_x)
        self.delta_t = float(delta_t)
        self.rho_on_boundary = float(rho_on_boundary)
        self.tolerance = float(tolerance)
        self.check_every = max(1, int(check_every))
        self.dtype = dtype
        self.lattice = D2Q9

        self.lb_D = self.delta_t / self.delta_x**2
        self.omega = 1.0 / (0.5 + self.lb_D / self.lattice.cs2)
        assert self.omega < 2.0

        self.rho = jnp.zeros((self.ny, self.nx), dtype)
        self.u = jnp.zeros((self.ny, self.nx), dtype)
        self.v = jnp.zeros((self.ny, self.nx), dtype)
        self.scaled_sources = None
        self.num_iterations = 0

        self.update_source(sources, sources_xy=sources_xy)

        # init f = perturbed feq of rho=0 (solver.py:263-287)
        feq0 = feq_poisson(self.rho, self.lattice)
        rng = np.random.RandomState(seed)
        perturb = 1.0 + 1e-5 * rng.randn(9, self.ny, self.nx)
        self.f = feq0 * jnp.asarray(perturb, dtype)

        self._run_jit = jax.jit(partial(_poisson_run, self._consts()),
                                donate_argnums=(0, 1))

    def _consts(self):
        w = tuple(float(x) for x in self.lattice.w)
        return dict(
            w=w, omega=self.omega, rho_b=self.rho_on_boundary,
            tol=self.tolerance, delta_t=self.delta_t, lb_D=self.lb_D,
            delta_x=self.delta_x, lattice=self.lattice,
            check_every=self.check_every,
        )

    def update_source(self, new_source, sources_xy=False):
        """Rescale and install a new source; keeps the current rho as the
        warm-start guess (``solver.py:152-161``)."""
        s = np.asarray(jax.device_get(new_source), dtype=np.float32)
        if sources_xy:
            s = s.T
        assert s.shape == (self.ny, self.nx)
        self.scaled_sources = jnp.asarray(s * self.lb_D * self.delta_t,
                                          self.dtype)
        self.num_iterations = 0

    def update_negative_gradient(self):
        self.u, self.v = negative_gradient(self.rho, self.delta_x)

    def run(self, num_iterations: int, *, timed=False):
        """Iterate until convergence or ``num_iterations``; on convergence the
        negative gradient is refreshed (``solver.py:324-358``).

        The convergence test runs every ``check_every`` iterations (the
        reference pays a device->host reduction sync *per* iteration,
        ``solver.py:348-352``; ``check_every=1`` reproduces that cadence
        exactly, on-device). With ``timed=True`` records throughput in
        ``last_mlups`` / ``last_solve_seconds``.
        """
        if timed:
            import time
            it_before = self.num_iterations
            jax.block_until_ready(self.f)
            t0 = time.perf_counter()
        f, rho, u, v, it, converged = self._run_jit(
            self.f, self.rho, self.u, self.v, self.scaled_sources,
            jnp.int32(self.num_iterations),
            jnp.int32(self.num_iterations + num_iterations))
        self.f, self.rho, self.u, self.v = f, rho, u, v
        self.num_iterations = int(it)
        self.converged = bool(converged)
        if timed:
            dt = time.perf_counter() - t0
            iters = self.num_iterations - it_before
            self.last_solve_seconds = dt
            self.last_mlups = self.nx * self.ny * iters / dt / 1e6
        return self

    def get_fields(self):
        rho = self.rho
        feq = feq_poisson(rho, self.lattice)
        return {
            "f": np.swapaxes(np.asarray(self.f), -1, -2),
            "feq": np.swapaxes(np.asarray(feq), -1, -2),
            "rho": np.asarray(rho).T,
            "u": np.asarray(self.u).T,
            "v": np.asarray(self.v).T,
        }


def _make_poisson_iter(c):
    """One LBM-Poisson iteration as ``(f, react) -> (f, rho)``; ``react``
    is the fully scaled per-cell source already multiplied by both
    ``D_lb * dt`` stages (the reference's double scaling, see module
    docstring). Shared by the converge-to-tolerance loop and the
    fixed-budget tracking mode of ``RepellingFisherWave``."""
    lattice = c["lattice"]
    w_arr = jnp.asarray(np.asarray(c["w"], np.float32))[:, None, None]
    omega = jnp.float32(c["omega"])

    def lbm_iter(f, react):
        f = stream(f, lattice)
        f = _poisson_bcs(f, jnp.float32(c["rho_b"]), c["w"])
        new_rho = rho_poisson(f, lattice)
        feq = feq_poisson(new_rho, lattice)
        f = f * (1.0 - omega) + omega * feq + w_arr * react
        return f, new_rho

    return lbm_iter


def _poisson_run(c, f, rho, u, v, scaled_sources, it0, it_max):
    # second source scaling stage (D2Q9_poisson.cl:83): * delta_t * D
    react = scaled_sources * jnp.float32(c["delta_t"]) * jnp.float32(c["lb_D"])
    base_iter = _make_poisson_iter(c)

    def lbm_iter(f):
        return base_iter(f, react)

    n_cells = rho.shape[0] * rho.shape[1]
    check_every = int(c.get("check_every", 1))

    def cond(state):
        f, rho, rho_before, it, converged = state
        return (it < it_max) & jnp.logical_not(converged)

    def body(state):
        f, rho, rho_before, it, _ = state
        # advance check_every-1 unchecked iterations (bounded by it_max),
        # then one checked iteration: the convergence metric still compares
        # two *consecutive* rho fields, exactly as solver.py:348-352.
        def unchecked(_, st):
            f, rho, it = st
            f2, rho2 = lbm_iter(f)
            take = it < it_max - 1  # leave the last slot for the checked step
            f = jax.tree.map(lambda a, b: jnp.where(take, a, b), f2, f)
            rho = jnp.where(take, rho2, rho)
            return f, rho, it + jnp.where(take, 1, 0)

        if check_every > 1:
            f, rho, it = jax.lax.fori_loop(
                0, check_every - 1, unchecked, (f, rho, it))
        rho_before = rho
        f, rho = lbm_iter(f)
        it = it + 1
        avg_diff = jnp.sum(jnp.abs(rho_before - rho)) / n_cells
        avg_rho = jnp.sum(rho_before) / n_cells
        # skip the check on the very first iteration (solver.py:346-347)
        converged = (it != 1) & (avg_diff / avg_rho < jnp.float32(c["tol"]))
        return (f, rho, rho_before, it, converged)

    f, rho, _, it, converged = jax.lax.while_loop(
        cond, body, (f, rho, rho, it0, jnp.bool_(False)))

    # gradient refresh only on convergence (solver.py:354-358)
    gu, gv = negative_gradient(rho, jnp.float32(c["delta_x"]))
    u = jnp.where(converged, gu, u)
    v = jnp.where(converged, gv, v)
    return f, rho, u, v, it, converged
