"""Lattice-units pipe-flow API (the reference's ``OLD`` module).

Before the nondimensionalization layer, the reference drove simulations in
raw lattice units: ``Pipe_Flow(omega, lx, ly, dr, dt, deltaP)``
(``OLD/python.py:24-54``), with the Zou-He densities derived directly from
the imposed pressure drop (``outlet_rho = deltaP/cs^2 + inlet_rho``,
``OLD/python.py:38-39``) and a diagnostic ``update_dimensionless_nums``
computing viscosity/Re/Ma from omega (``OLD/python.py:56-64``).

:class:`LatticePipeFlow` reproduces that API on the modern step machinery
(the same XLA step as :class:`~lb2d_tpu.models.pipe_flow.PipeFlow`).
The velocity-inlet and obstacle variants of the OLD module are
covered by :class:`~lb2d_tpu.models.pipe_flow.PipeFlowVelocityInlet` and
the ``obstacle_mask`` argument. Note the OLD module's update order
(``move_bcs`` before the in-place ``move``, ``OLD/python.py``) differs from
the notebook-verified OpenCL order; per SURVEY.md §7 we implement the
verified order (stream -> BC) everywhere.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.lattice import D2Q9
from .base import LBModel, resolve_backend
from .pipe_flow import PipeFlow

__all__ = ["LatticePipeFlow", "LatticePipeFlowPeriodicBC",
           "PipeFlowVelocityInlet"]


class LatticePipeFlow(PipeFlow):
    """``Pipe_Flow`` in raw lattice units (``OLD/python.py:24``)."""

    def __init__(self, omega=0.99, lx=400, ly=400, dr=1.0, dt=1.0,
                 deltaP=-0.1, equilibrium="compressible", obstacle_mask=None,
                 seed=0, dtype=jnp.float32, backend="auto"):
        self.lx, self.ly = int(lx), int(ly)
        self.dr, self.dt_lattice, self.deltaP = dr, dt, deltaP
        self._omega_in = float(omega)
        # Bypass PipeFlow.__init__'s physical-units path entirely.
        self.units = None
        self.lattice = D2Q9
        self.equilibrium = equilibrium
        self.dtype = dtype
        self.omega = float(omega)
        assert self.omega < 2.0

        self.nx, self.ny = self.lx + 1, self.ly + 1
        # OLD/python.py:38-39: deltaP is negative
        self.inlet_rho = 1.0
        self.outlet_rho = deltaP / self.lattice.cs2 + self.inlet_rho

        if obstacle_mask is not None:
            obstacle_mask = jnp.asarray(np.asarray(obstacle_mask, dtype=bool))
        self.obstacle_mask = obstacle_mask
        self.backend = resolve_backend(backend, extra=("native",))

        self.state = self._init_state(np.random.RandomState(seed))
        LBModel.__init__(self)
        self.update_dimensionless_nums()

    def update_dimensionless_nums(self):
        """Diagnostic viscosity / Re / Ma from omega
        (``OLD/python.py:56-64``)."""
        dr, dt = self.dr, self.dt_lattice
        self.viscosity = (dr**2 / (3 * dt)) * (self.omega - 0.5)
        rho, u, v = self._hydro_fn()(self.state)
        U = float(jnp.max(jnp.sqrt(u * u + v * v)))
        L = self.ly * dr
        self.Re = U * L / self.viscosity if self.viscosity else float("inf")
        self.Ma = (dr / (L * np.sqrt(3.0))) * (self.omega - 0.5) * self.Re
        return self.viscosity, self.Re, self.Ma

    # getters: lattice units only (the OLD API has no unit conversions)
    def get_nondim_fields(self):
        raise NotImplementedError(
            "LatticePipeFlow is the lattice-units API (OLD module); use "
            "PipeFlow for unit conversions")

    get_physical_fields = get_nondim_fields


# ``Pipe_Flow_PeriodicBC`` (``OLD/python.py:250-316``) is behaviorally
# identical to the base OLD ``Pipe_Flow``: a line diff shows its
# ``move_bcs`` is a verbatim copy of the base class's (only a "THIS PART
# IS NOT CORRECT" comment added) and its ``__init__`` just delegates — an
# abandoned edit, no periodic BC was ever implemented (DIVERGENCES.md
# #18). Aliased so reference users switching over find the name.
LatticePipeFlowPeriodicBC = LatticePipeFlow


class PipeFlowVelocityInlet(LatticePipeFlow):
    """Zou-He velocity inlet/outlet with y-periodic walls
    (``Pipe_Flow_PeriodicBC_VelocityInlet``, ``OLD/opencl.py:281-328``,
    kernels ``D2Q9.cl:263-374``); the obstacle variant
    (``OLD/opencl.py:329-375``) via ``obstacle_mask``. Like the reference
    class this is a lattice-units model (the OLD module never grew a
    physical-units version): uniform initial state rho = 1, u = u_w, v = 0
    (``OLD/opencl.py:299-317``, no perturbation).

    Stability fix (DIVERGENCES.md #20): the reference's
    ``update_hydro_PeriodicBC_VelocityInlet`` (``D2Q9.cl:323-374``) overrides
    rho/u on the boundary columns with a pre-move formula applied post-move;
    that inconsistency makes the whole scheme explode within ~150 steps even
    from the exact uniform initial condition at the reference's own notebook
    defaults (verified against a numpy oracle of the reference update
    order). We compute plain moments everywhere instead, which is stable
    indefinitely (rho deviation stays at fp32 noise over 3000+ steps).
    """

    def __init__(self, u_w=0.1, omega=0.99, lx=400, ly=400,
                 outlet="zero_gradient", **kwargs):
        self.u_w = float(u_w)
        self.u_e = float(u_w)
        assert outlet in ("zero_gradient", "velocity")
        self.outlet = outlet
        if kwargs.get("backend", "xla") not in ("auto", "xla"):
            # the C++ library bakes the pressure BCs
            raise ValueError("velocity-inlet BC runs on the 'xla' backend only")
        super().__init__(omega=omega, lx=lx, ly=ly, deltaP=0.0, **kwargs)

    def _bc_fn(self):
        from ..ops.boundary import (
            zou_he_velocity_bcs,
            zou_he_velocity_inlet_open_outlet,
        )

        if self.outlet == "zero_gradient":
            return lambda f: zou_he_velocity_inlet_open_outlet(f, self.u_w)
        # outlet="velocity": the reference's (unstable) pair, for parity
        return lambda f: zou_he_velocity_bcs(f, self.u_w, self.u_e)

    def _init_state(self, rng):
        ny, nx = self.ny, self.nx
        rho0 = jnp.ones((ny, nx), self.dtype)
        u0 = jnp.full((ny, nx), self.u_w, self.dtype)
        v0 = jnp.zeros((ny, nx), self.dtype)
        return self._feq_fn()(rho0, u0, v0)

    def make_step(self):
        from ..ops.collide import bgk
        from ..ops.boundary import bounce_back_obstacle
        from ..ops.moments import hydro_compressible
        from ..ops.stream import stream

        feq_fn = self._feq_fn()
        bc_fn = self._bc_fn()
        mask = self.obstacle_mask
        omega = jnp.asarray(self.omega, self.dtype)
        lattice = self.lattice

        def step(f):
            f = stream(f, lattice)
            f = bc_fn(f)
            if mask is not None:
                f = bounce_back_obstacle(f, mask, lattice)
            rho, u, v = hydro_compressible(f, lattice)
            if mask is not None:
                # obstacle variant zeroes velocity inside the mask
                # (set_zero_velocity_in_obstacle, OLD/opencl.py:346-360)
                u = jnp.where(mask, 0.0, u)
                v = jnp.where(mask, 0.0, v)
            feq = feq_fn(rho, u, v)
            return bgk(f, feq, omega)

        return step

    def get_fields(self) -> dict:
        from ..ops.moments import hydro_compressible

        f = self.state
        rho, u, v = hydro_compressible(f, self.lattice)
        feq = self._feq_fn()(rho, u, v)
        return {
            "f": self._to_host_xy(f),
            "feq": self._to_host_xy(feq),
            "rho": self._to_host_xy(rho),
            "u": self._to_host_xy(u),
            "v": self._to_host_xy(v),
        }
