"""Surfactant-nutrient wave models (population + nutrient, shared flow).

Rebuilds ``reaction_diffusion/surfactant_nutrient_waves.py``:

* :class:`SurfactantNutrientWave` — two fields sharing one (u, v) from a
  screened-Poisson solve of the population density each step
  (``surfactant_nutrient_waves.py:373-397``); growth ``G rho n`` feeds the
  population and depletes the nutrient (kernel ``collide_particles``,
  ``surfactant_nutrient_waves.cl:74-128``).
* :class:`ClumpySurfactantNutrientWave` — adds Shan-Chen self-attraction:
  pseudopotential ``psi = rho_o (1 - exp(-rho/rho_o))``
  (``update_psi``, ``:242-260``), pseudo-force
  ``F = -cs^2 G_chen psi(x) sum_j w_j c_j psi(x + c_j)`` with periodic halo
  (``update_pseudo_force``, ``:283-364`` — the local-memory halo tile maps to
  plain rolls here), applied as a force term ``w (c.F)/cs^2`` in the
  population collision (``collide_particles_attraction``, ``:130-199``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.lattice import D2Q9
from .base import LBModel
from .waves import _ScreenedVelocity

__all__ = [
    "SurfactantNutrientWave",
    "ClumpySurfactantNutrientWave",
    "psi_shan_chen",
    "psi_sticky_repulsive",
    "pseudo_force",
]


def psi_shan_chen(rho, rho_o):
    """``psi = rho_o (1 - exp(-rho/rho_o))`` with negative-density clamp
    (``surfactant_nutrient_waves.cl:242-260``)."""
    r = jnp.maximum(rho, 0.0)
    return rho_o * (1.0 - jnp.exp(-r / rho_o))


def psi_sticky_repulsive(rho, rho_o):
    """``psi = rho - rho_o rho^2`` (``surfactant_nutrient_waves.cl:262-281``)."""
    r = jnp.maximum(rho, 0.0)
    return r - rho_o * r * r


def pseudo_force(psi, G_chen, lattice=D2Q9):
    """Shan-Chen pseudo-force with periodic neighbors
    (``surfactant_nutrient_waves.cl:283-364``):
    ``F = -cs^2 G_chen psi(x) sum_j w_j c_j psi(x + c_j)``."""
    fx = jnp.zeros_like(psi)
    fy = jnp.zeros_like(psi)
    for j in range(1, lattice.q):
        cxj, cyj = lattice.cx[j], lattice.cy[j]
        # psi(x + c_j): shift by -c on the array index
        shifted = jnp.roll(jnp.roll(psi, -cyj, axis=0), -cxj, axis=1)
        fx = fx + lattice.w[j] * cxj * shifted
        fy = fy + lattice.w[j] * cyj * shifted
    pref = -lattice.cs2 * G_chen * psi
    return pref * fx, pref * fy


class SurfactantNutrientWave(LBModel):
    """Dimensionless two-field wave (``surfactant_nutrient_waves.py:60-135``):
    D = 1/4 (population), Dn (nutrient), G = 1; state ``f[Q, 2, ny, nx]``
    with field 0 = population, field 1 = nutrient."""

    POP, NUT = 0, 1

    def __init__(self, Lx=1.0, Ly=1.0, vc=1.0, lam=1.0, Dn=1.0 / 4.0, R0=5.0,
                 time_prefactor=1.0, N=50, seed=0, check_max_ulb=False,
                 mach_tolerance=0.1, dtype=jnp.float32, method="auto"):
        self.Lx, self.Ly = Lx, Ly
        self.D, self.Dn, self.G = 1.0 / 4.0, Dn, 1.0
        self.vc, self.lam, self.R0 = vc, lam, R0
        self.L = self.T = 1.0
        self.N = N
        self.lattice = D2Q9
        self.dtype = dtype
        self.check_max_ulb = check_max_ulb
        self.mach_tolerance = mach_tolerance

        self.delta_x = 1.0 / N
        self.delta_t = time_prefactor * self.delta_x**2
        self.ulb = self.delta_t / self.delta_x
        cs2 = self.lattice.cs2
        self.lb_D = np.float32(self.D * self.delta_t / self.delta_x**2)
        self.omega = np.float32(1.0 / (0.5 + self.lb_D / cs2))
        self.lb_Dn = np.float32(self.Dn * self.delta_t / self.delta_x**2)
        self.omega_n = np.float32(1.0 / (0.5 + self.lb_Dn / cs2))
        assert self.omega < 2.0 and self.omega_n < 2.0
        self.lb_G = np.float32(self.G * self.delta_t)

        self.nx = int(np.round(N * Lx))
        self.ny = int(np.round(N * Ly))

        self._velocity = _ScreenedVelocity(self.ny, self.nx, lam,
                                           self.delta_x, vc, self.ulb, method)

        rng = np.random.RandomState(seed)
        X, Y = np.meshgrid(np.arange(self.nx), np.arange(self.ny))
        Xd = (X - self.nx // 2) / N
        Yd = (Y - self.ny // 2) / N
        # surfactant_nutrient_waves.py:283-288
        pop0 = 1.2 * np.exp(-(Xd**2 + Yd**2) / R0**2) * (
            1.0 + 0.05 * rng.randn(self.ny, self.nx))
        nut0 = np.ones((self.ny, self.nx), np.float32)
        rho0 = jnp.asarray(np.stack([pop0, nut0]), dtype)  # [2, ny, nx]
        self.state = self._state_from_rho(rho0)
        super().__init__()

    # -- helpers ---------------------------------------------------------------
    def _feq(self, rho, u, v):
        lat = self.lattice
        w = jnp.asarray(lat.w_np())[:, None, None, None]
        cx = jnp.asarray(lat.cx_np(np.float32))[:, None, None, None]
        cy = jnp.asarray(lat.cy_np(np.float32))[:, None, None, None]
        cu = cx * u[None, None] + cy * v[None, None]
        return w * rho[None] * (1.0 + cu / lat.cs2)

    def _state_from_rho(self, rho):
        u, v = self._velocity(rho[self.POP])
        return self._feq(rho, u, v)

    def redo_initial_condition(self, rho_field):
        self.state = self._state_from_rho(jnp.asarray(rho_field, self.dtype))
        return self

    @property
    def num_cells(self):
        return self.nx * self.ny

    # -- step ------------------------------------------------------------------
    def _collide(self, f, feq, rho, force=None):
        lat = self.lattice
        w = jnp.asarray(lat.w_np())[:, None, None]
        growth = jnp.asarray(self.lb_G, self.dtype) * rho[self.POP] * rho[self.NUT]
        om, om_n = jnp.asarray(self.omega), jnp.asarray(self.omega_n)
        new_pop = f[:, self.POP] * (1 - om) + om * feq[:, self.POP] + w * growth
        if force is not None:
            fx, fy = force
            cx = jnp.asarray(lat.cx_np(np.float32))[:, None, None]
            cy = jnp.asarray(lat.cy_np(np.float32))[:, None, None]
            new_pop = new_pop + w * (cx * fx + cy * fy) / lat.cs2
        new_nut = (f[:, self.NUT] * (1 - om_n) + om_n * feq[:, self.NUT]
                   - w * growth)
        return jnp.stack([new_pop, new_nut], axis=1)

    def _force(self, rho):
        return None

    def make_step(self):
        from .multifield import _stream_fields

        lat = self.lattice
        velocity = self._velocity

        def step(f):
            f = _stream_fields(f, lat)      # move_periodic
            rho = jnp.sum(f, axis=0)        # [2, ny, nx]
            u, v = velocity(rho[self.POP])
            feq = self._feq(rho, u, v)
            return self._collide(f, feq, rho, force=self._force(rho))

        return step

    def device_field(self, name):
        if name == "rho":
            return jnp.sum(self.state[:, self.POP], axis=0)
        if name == "nutrient":
            return jnp.sum(self.state[:, self.NUT], axis=0)
        return None

    def get_fields(self):
        f = self.state
        rho = jnp.sum(f, axis=0)
        u, v = self._velocity(rho[self.POP])
        feq = self._feq(rho, u, v)
        return {
            "f": np.transpose(np.asarray(f), (3, 2, 1, 0)),
            "feq": np.transpose(np.asarray(feq), (3, 2, 1, 0)),
            "rho": np.transpose(np.asarray(rho), (2, 1, 0)),
            "u": np.asarray(u).T,
            "v": np.asarray(v).T,
        }


class ClumpySurfactantNutrientWave(SurfactantNutrientWave):
    """Adds Shan-Chen clumping to the population field
    (``surfactant_nutrient_waves.py:437-521``)."""

    def __init__(self, rho_o=1.0, G_chen=-1.0, **kwargs):
        self.rho_o = float(rho_o)
        self.G_chen = float(G_chen)
        super().__init__(**kwargs)

    def _force(self, rho):
        psi = psi_shan_chen(rho[self.POP], self.rho_o)
        return pseudo_force(psi, self.G_chen, self.lattice)
