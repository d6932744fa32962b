"""Advection-diffusion / reaction-diffusion model family.

Rebuilds ``reaction_diffusion/diffusion.py`` (classes ``Diffusion``,
``Advection_Diffusion``, ``Reaction_Diffusion``,
``Reaction_Advection_Diffusion``, ``Reaction_Advection_Diffusion_Stochastic``)
on the shared XLA core: scalar density advected by an *imposed* velocity
field with linear feq (``D2Q9_diffusion.cl:1-38``), hydro = density only
(``:41-68``), optional Fisher growth ``G rho (1-rho)`` distributed by lattice
weights (``:95-124``) and optional multiplicative noise
``sqrt(Dg rho (1-rho)) * eta`` with negativity clipping (``:126-167``).

Documented divergences from the reference (SURVEY.md §8 "replicate, not
cargo-cult"):

* The reference's ``move_bcs`` for this family is a no-op
  (``diffusion.py:326-331``), which combined with its bounds-checked scatter
  leaves boundary-incoming populations frozen at their initial values — an
  accidental stale-inflow boundary. We use clean periodic wrap instead;
  the two agree wherever the density hasn't reached the domain edge (the
  regime every reference notebook runs in).
* ``diffusion.py:516-519`` passes arguments to ``collide_particles_fisher``
  in an order that does not match the kernel signature
  (``D2Q9_diffusion.cl:96-101``), and ``collide_particles_fisher_stochastic``
  (``diffusion.py:582``) does not exist in the kernel file — both latent
  bugs. We implement the *intended* semantics (the formulas in the kernels).
* The stochastic class passes the physical ``Dg`` straight to the kernel
  (``diffusion.py:568,587``) without unit conversion; we preserve that
  behavior (``Dg`` is taken as the lattice-units noise amplitude) and
  note it here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.lattice import D2Q9
from ..ops.collide import bgk
from ..ops.equilibrium import feq_linear
from ..ops.moments import density
from ..ops.stream import stream
from .base import LBModel

__all__ = [
    "Diffusion",
    "AdvectionDiffusion",
    "ReactionDiffusion",
    "ReactionAdvectionDiffusion",
    "ReactionAdvectionDiffusionStochastic",
]


class Diffusion(LBModel):
    """Pure diffusion of an initially-Gaussian density blob
    (``diffusion.py:56-185``): characteristic scales L = z, T = z^2/D so the
    dimensionless diffusivity is 1; ``D_lb = dt/dx^2``,
    ``omega = (0.5 + D_lb/cs^2)^-1``."""

    def __init__(self, Lx=1.0, Ly=1.0, D=1.0, z=0.1, time_prefactor=1.0,
                 N=50, seed=0, dtype=jnp.float32):
        self.phys_Lx, self.phys_Ly = Lx, Ly
        self.phys_D, self.phys_z = D, z
        self.N = N
        self.time_prefactor = time_prefactor
        self.lattice = D2Q9
        self.dtype = dtype

        self.set_characteristic_length_time()
        self.delta_x = 1.0 / N
        self.delta_t = time_prefactor * self.delta_x**2
        self.ulb = self.delta_t / self.delta_x
        self.set_D_and_omega()

        # grid (diffusion.py:188-198): note +2 boundary ring, and int()
        # truncation (not ceil) of the physical extent
        self.lx = self.N * int(self.phys_Lx / self.L)
        self.ly = self.N * int(self.phys_Ly / self.L)
        self.nx, self.ny = self.lx + 2, self.ly + 2

        rng = np.random.RandomState(seed)
        self._init_velocity()
        self.state = self._init_state(rng)
        super().__init__()

    # -- scaling hooks ---------------------------------------------------------
    def set_characteristic_length_time(self):
        self.L = self.phys_z
        self.T = self.phys_z**2 / self.phys_D

    def set_D_and_omega(self):
        # diffusion.py:168-174
        self.lb_D = self.delta_t / self.delta_x**2
        self.omega = 1.0 / (0.5 + self.lb_D / self.lattice.cs2)
        assert self.omega < 2.0

    # -- velocity field (imposed) ---------------------------------------------
    def _init_velocity(self):
        self.u = jnp.zeros((1, 1), self.dtype)  # broadcastable constants
        self.v = jnp.zeros((1, 1), self.dtype)

    # -- state -----------------------------------------------------------------
    def _initial_rho(self) -> np.ndarray:
        """Gaussian blob in dimensionless coordinates (diffusion.py:258-280),
        centered at (nx//2, ny//2)."""
        X, Y = np.meshgrid(np.arange(self.nx), np.arange(self.ny))
        Xd = (X - self.nx // 2) / self.N
        Yd = (Y - self.ny // 2) / self.N
        return np.exp(-(Xd**2 + Yd**2)).astype(np.float32)  # [ny, nx]

    def _init_state(self, rng):
        rho0 = jnp.asarray(self._initial_rho(), self.dtype)
        feq0 = feq_linear(rho0, self.u, self.v)
        perturb = 1.0 + 0.001 * rng.randn(9, self.ny, self.nx)
        return feq0 * jnp.asarray(perturb, self.dtype)

    @property
    def num_cells(self):
        return self.nx * self.ny

    # -- step ------------------------------------------------------------------
    def _source(self, rho):
        return None  # no reaction

    def make_step(self):
        u, v = self.u, self.v
        omega = jnp.asarray(self.omega, self.dtype)
        w = jnp.asarray(self.lattice.w_np(np.float32), self.dtype)[:, None, None]
        source = self._source

        def step(f):
            f = stream(f, self.lattice)
            rho = density(f)
            feq = feq_linear(rho, u, v, self.lattice)
            f = bgk(f, feq, omega)
            s = source(rho)
            if s is not None:
                f = f + w * s
            return f

        return step

    def device_field(self, name):
        if name == "rho":
            return density(self.state)
        return None

    # -- getters (diffusion.py:385-432) ---------------------------------------
    def get_fields(self):
        f = self.state
        rho = density(f)
        feq = feq_linear(rho, self.u, self.v)
        ones = jnp.broadcast_to
        return {
            "f": self._to_host_xy(f),
            "feq": self._to_host_xy(jnp.broadcast_to(feq, f.shape)),
            "rho": self._to_host_xy(rho),
            "u": self._to_host_xy(ones(self.u, rho.shape)),
            "v": self._to_host_xy(ones(self.v, rho.shape)),
        }

    def get_nondim_fields(self):
        fields = self.get_fields()
        scale = self.delta_x / self.delta_t
        fields["u"] = fields["u"] * scale
        fields["v"] = fields["v"] * scale
        return fields

    def get_physical_fields(self):
        fields = self.get_nondim_fields()
        fields["u"] = fields["u"] * (self.L / self.T)
        fields["v"] = fields["v"] * (self.L / self.T)
        return fields


class AdvectionDiffusion(Diffusion):
    """Diffusion in a uniform imposed flow (``diffusion.py:433-481``):
    L = z, T = z/vc, Peclet Pe = z vc / D, ``D_lb = (dt/dx^2)/Pe``,
    imposed lattice velocity ``(dt/dx) * v_phys/vc``."""

    def __init__(self, vx=1.0, vy=1.0, vc=1.0, **kwargs):
        self.phys_vx, self.phys_vy, self.phys_vc = vx, vy, vc
        self.Pe = None
        super().__init__(**kwargs)

    def set_characteristic_length_time(self):
        self.L = self.phys_z
        self.T = self.phys_z / self.phys_vc

    def set_D_and_omega(self):
        self.Pe = self.phys_z * self.phys_vc / self.phys_D
        self.lb_D = (self.delta_t / self.delta_x**2) / self.Pe
        self.omega = 1.0 / (0.5 + self.lb_D / self.lattice.cs2)
        assert self.omega < 2.0

    def _init_velocity(self):
        lb_vx = self.ulb * self.phys_vx / self.phys_vc
        lb_vy = self.ulb * self.phys_vy / self.phys_vc
        self.u = jnp.asarray(np.float32(lb_vx))[None, None]
        self.v = jnp.asarray(np.float32(lb_vy))[None, None]


class ReactionDiffusion(Diffusion):
    """Fisher wave: diffusion + logistic growth ``G rho (1 - rho)``
    (``diffusion.py:482-519``; source formula ``D2Q9_diffusion.cl:112-121``).
    ``G_lb = (T g) * dt``."""

    def __init__(self, g=1.0, **kwargs):
        self.g = g
        super().__init__(**kwargs)

    def set_D_and_omega(self):
        super().set_D_and_omega()
        self.G_dim = self.T * self.g
        self.G = self.G_dim * self.delta_t

    def _source(self, rho):
        G = jnp.asarray(self.G, self.dtype)
        return G * rho * (1.0 - rho)


class ReactionAdvectionDiffusion(AdvectionDiffusion):
    """Fisher wave advected by a uniform flow (``diffusion.py:521-553``);
    dimensionless Fisher speed ``v_f = 2 sqrt(G_dim / Pe)``
    (``diffusion.py:542``)."""

    def __init__(self, g=1.0, **kwargs):
        self.g = g
        super().__init__(**kwargs)

    def set_D_and_omega(self):
        super().set_D_and_omega()
        self.G_dim = self.T * self.g
        self.G = self.G_dim * self.delta_t
        self.vf_dim = 2.0 * np.sqrt(self.G_dim / self.Pe)

    def _source(self, rho):
        G = jnp.asarray(self.G, self.dtype)
        return G * rho * (1.0 - rho)


class ReactionAdvectionDiffusionStochastic(ReactionAdvectionDiffusion):
    """Stochastic Fisher wave: adds ``sqrt(Dg rho (1-rho)) eta`` per cell with
    fresh normals every step and clips negative populations to zero
    (``D2Q9_diffusion.cl:126-167``; per-step Philox refresh
    ``diffusion.py:596-607`` -> per-step ``jax.random`` key split here).

    State is the pytree ``(f, key)``.
    """

    def __init__(self, Dg=1.0, rng_seed=0, **kwargs):
        self.Dg = Dg
        self._rng_seed = rng_seed
        super().__init__(**kwargs)

    def _init_state(self, rng):
        f = super()._init_state(rng)
        return (f, jax.random.PRNGKey(self._rng_seed))

    def make_step(self):
        u, v = self.u, self.v
        omega = jnp.asarray(self.omega, self.dtype)
        w = jnp.asarray(self.lattice.w_np(np.float32), self.dtype)[:, None, None]
        G = jnp.asarray(self.G, self.dtype)
        Dg = jnp.asarray(self.Dg, self.dtype)

        def step(state):
            f, key = state
            key, sub = jax.random.split(key)
            f = stream(f, self.lattice)
            rho = density(f)
            feq = feq_linear(rho, u, v, self.lattice)
            eta = jax.random.normal(sub, rho.shape, self.dtype)
            grow = G * rho * (1.0 - rho)
            noise = jnp.sqrt(jnp.maximum(Dg * rho * (1.0 - rho), 0.0)) * eta
            f = bgk(f, feq, omega) + w * (grow + noise)
            f = jnp.maximum(f, 0.0)  # negativity clip (D2Q9_diffusion.cl:163)
            return (f, key)

        return step

    def get_fields(self):
        f, _ = self.state
        rho = density(f)
        feq = feq_linear(rho, self.u, self.v)
        return {
            "f": self._to_host_xy(f),
            "feq": self._to_host_xy(jnp.broadcast_to(feq, f.shape)),
            "rho": self._to_host_xy(rho),
            "u": self._to_host_xy(jnp.broadcast_to(self.u, rho.shape)),
            "v": self._to_host_xy(jnp.broadcast_to(self.v, rho.shape)),
        }
