"""Rocket-yeast models: population propelled by its own surfactant.

Rebuilds ``rocket_yeast/``:

* :class:`RocketYeast` (``rocket_yeast.py:60-482``): population (logistic
  growth, negativity clip) + surfactant (produced at rate ``Gc rho``); the
  advection velocity **is** the surfactant gradient,
  ``(u, v) = -(epsilon/cs^2) sum_j w_j c_j c(x + c_j)``
  (``rocket_yeast.cl:316-399``), plus a Shan-Chen pseudo-force from
  ``psi(rho_pop)`` applied as a force term in the population collision
  (``rocket_yeast.cl:74-151``, driver ``rocket_yeast.py:395-467``).
* :class:`RocketYeastForcesOnly` (``rocket_yeast_forces_only.py``):
  the velocity is the *sum of force fields* directly —
  surface-tension force ``-(epsilon/cs^2) grad S`` with
  ``S = (1 - exp(-c/c_o))^alpha`` (``rocket_yeast_forces_only.cl:45-62,
  317-399``) plus pressure force ``-G_chen (rho - rho_o) grad rho / cs^2``
  (``:225-316``); collision carries no force term.

All stencil gradients are the reference's D2Q9 weighted sums with periodic
neighbors — plain rolls here.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.lattice import D2Q9
from .base import LBModel
from .multifield import _stream_fields
from .surfactant import pseudo_force, psi_shan_chen

__all__ = ["RocketYeast", "RocketYeastForcesOnly", "stencil_gradient"]


def stencil_gradient(field, lattice=D2Q9):
    """D2Q9 isotropic gradient ``(1/cs^2) sum_j w_j c_j field(x + c_j)``
    with periodic neighbors (``rocket_yeast.cl:377-397``)."""
    gx = jnp.zeros_like(field)
    gy = jnp.zeros_like(field)
    for j in range(1, lattice.q):
        cxj, cyj = lattice.cx[j], lattice.cy[j]
        shifted = jnp.roll(jnp.roll(field, -cyj, axis=0), -cxj, axis=1)
        gx = gx + lattice.w[j] * cxj * shifted
        gy = gy + lattice.w[j] * cyj * shifted
    return gx / lattice.cs2, gy / lattice.cs2


class RocketYeast(LBModel):
    """Dimensionless units (L = T = 1); fields: population (0), surfactant
    (1). State ``f[Q, 2, ny, nx]``."""

    POP, SURF = 0, 1

    def __init__(self, Lx=1.0, Ly=1.0, R0=5.0, epsilon=1.0, Dc=1.0 / 4.0,
                 Gc=2.0, rho_o=1.0, G_chen=-1.0, time_prefactor=1.0, N=10,
                 seed=0, check_max_ulb=False, mach_tolerance=0.1,
                 dtype=jnp.float32):
        self.Lx, self.Ly = Lx, Ly
        self.D, self.G = 1.0 / 4.0, 1.0
        self.Dc = (1.0 / 4.0) * Dc          # rocket_yeast.py:79 quirk: Dc/4
        self.Gc = Gc
        self.epsilon = epsilon
        self.R0 = R0
        self.rho_o, self.G_chen = rho_o, G_chen
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
        self.lb_G = np.float32(self.G * self.delta_t)
        self.lb_Dc = np.float32(self.Dc * self.delta_t / self.delta_x**2)
        self.omega_c = np.float32(1.0 / (0.5 + self.lb_Dc / cs2))
        self.lb_Gc = np.float32(self.Gc * self.delta_t)
        assert self.omega < 2.0 and self.omega_c < 2.0

        self.nx = int(np.round(N * Lx))
        self.ny = int(np.round(N * Ly))

        rng = np.random.RandomState(seed)
        X, Y = np.meshgrid(np.arange(self.nx), np.arange(self.ny))
        Xd = (X - self.nx // 2) / N
        Yd = (Y - self.ny // 2) / N
        # rocket_yeast.py:305-308
        pop0 = np.exp(-(Xd**2 + Yd**2) / R0**2) * (
            1.0 + 0.05 * rng.randn(self.ny, self.nx))
        surf0 = np.zeros((self.ny, self.nx), np.float32)
        rho0 = jnp.asarray(np.stack([pop0, surf0]), dtype)
        u, v = self._velocity(rho0)
        self.state = self._feq(rho0, u, v)
        super().__init__()

    @property
    def num_cells(self):
        return self.nx * self.ny

    def _feq(self, rho, u, v):
        lat = self.lattice
        w = jnp.asarray(lat.w_np())[:, None, None, None]
        cx = jnp.asarray(lat.cx_np(np.float32))[:, None, None, None]
        cy = jnp.asarray(lat.cy_np(np.float32))[:, None, None, None]
        cu = cx * u[None, None] + cy * v[None, None]
        return w * rho[None] * (1.0 + cu / lat.cs2)

    def _velocity(self, rho):
        """(u, v) = -epsilon * grad(surfactant) (``rocket_yeast.py:401-410``)."""
        gx, gy = stencil_gradient(rho[self.SURF], self.lattice)
        return -self.epsilon * gx, -self.epsilon * gy

    def _collide(self, f, feq, rho, force):
        lat = self.lattice
        w = jnp.asarray(lat.w_np())[:, None, None]
        om, om_c = jnp.asarray(self.omega), jnp.asarray(self.omega_c)
        pop_rho = rho[self.POP]
        growth = jnp.asarray(self.lb_G, self.dtype) * pop_rho * (1.0 - pop_rho)
        new_pop = f[:, self.POP] * (1 - om) + om * feq[:, self.POP] + w * growth
        if force is not None:
            fx, fy = force
            cx = jnp.asarray(lat.cx_np(np.float32))[:, None, None]
            cy = jnp.asarray(lat.cy_np(np.float32))[:, None, None]
            new_pop = new_pop + w * (cx * fx + cy * fy) / lat.cs2
        new_pop = jnp.maximum(new_pop, 0.0)  # rocket_yeast.cl:127 clip
        produce = jnp.asarray(self.lb_Gc, self.dtype) * pop_rho
        new_surf = (f[:, self.SURF] * (1 - om_c) + om_c * feq[:, self.SURF]
                    + w * produce)
        return jnp.stack([new_pop, new_surf], axis=1)

    def _force(self, rho):
        psi = psi_shan_chen(rho[self.POP], self.rho_o)
        return pseudo_force(psi, self.G_chen, self.lattice)

    def make_step(self):
        lat = self.lattice

        def step(f):
            f = _stream_fields(f, lat)
            rho = jnp.sum(f, axis=0)
            u, v = self._velocity(rho)
            feq = self._feq(rho, u, v)
            return self._collide(f, feq, rho, self._force(rho))

        return step

    def device_field(self, name):
        if name == "rho":
            return jnp.sum(self.state[:, self.POP], axis=0)
        if name == "surfactant":
            return jnp.sum(self.state[:, self.SURF], axis=0)
        return None

    def get_fields(self):
        f = self.state
        rho = jnp.sum(f, axis=0)
        u, v = self._velocity(rho)
        feq = self._feq(rho, u, v)
        return {
            "f": np.transpose(np.asarray(f), (3, 2, 1, 0)),
            "feq": np.transpose(np.asarray(feq), (3, 2, 1, 0)),
            "rho": np.transpose(np.asarray(rho), (2, 1, 0)),
            "u": np.asarray(u).T,
            "v": np.asarray(v).T,
        }


class RocketYeastForcesOnly(RocketYeast):
    """Velocity = pseudo-force + surface-tension force fields directly
    (``rocket_yeast_forces_only.py``); no force term in collision."""

    def __init__(self, c_o=0.25, alpha=2.0, **kwargs):
        self.c_o = c_o
        self.alpha = alpha
        super().__init__(**kwargs)

    def _velocity(self, rho):
        lat = self.lattice
        # surface-tension force (rocket_yeast_forces_only.cl:45-62, 317-399)
        c = jnp.maximum(rho[self.SURF], 0.0)
        S = (1.0 - jnp.exp(-c / self.c_o)) ** self.alpha
        sx, sy = stencil_gradient(S, lat)
        sfx, sfy = -self.epsilon * sx, -self.epsilon * sy
        # pressure force (rocket_yeast_forces_only.cl:225-316)
        gx, gy = stencil_gradient(rho[self.POP], lat)
        pfx = -self.G_chen * gx * (rho[self.POP] - self.rho_o)
        pfy = -self.G_chen * gy * (rho[self.POP] - self.rho_o)
        return sfx + pfx, sfy + pfy

    def _force(self, rho):
        return None
