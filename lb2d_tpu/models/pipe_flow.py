"""Pressure-driven pipe flow — the reference's canonical verification model.

Reproduces the capability set of ``dimensionless/opencl_dim.py`` (class
``Pipe_Flow``, ``Pipe_Flow_Cylinder``), ``dimensionless/opencl_dim_D2Q9i.py``
(incompressible He-Luo variant) and the working velocity-inlet / arbitrary
obstacle classes from ``OLD/python.py:250-530``, as one configurable model.

Step order is the notebook-verified OpenCL order (``opencl_dim.py:380-387``):
stream -> boundary conditions -> hydro -> feq -> BGK collide. The stream +
BC + moments + collide chain compiles to one fused XLA program; ``run(n)``
executes entirely on-device.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.lattice import D2Q9
from ..core.nondim import FlowUnits
from ..ops.boundary import (
    bounce_back_obstacle,
    zou_he_pressure_bcs,
    zou_he_pressure_bcs_incompressible,
)
from ..ops.collide import bgk
from ..ops.equilibrium import feq_incompressible, feq_quadratic
from ..ops.moments import hydro_compressible, hydro_incompressible
from ..ops.stream import stream
from .base import LBModel, resolve_backend

__all__ = [
    "PipeFlow",
    "PipeFlowCylinder",
    "PipeFlowObstacles",
    "disk_mask",
]


def disk_mask(nx: int, ny: int, cx: float, cy: float, radius: float) -> np.ndarray:
    """Circular obstacle mask (replaces ``skimage.draw.circle`` at
    ``opencl_dim.py:474-475``): int32 ``[ny, nx]`` with 1 inside the disk."""
    X, Y = np.meshgrid(np.arange(nx), np.arange(ny))
    return ((X - cx) ** 2 + (Y - cy) ** 2 <= radius**2).astype(np.int32)


class PipeFlow(LBModel):
    """2-D pressure-driven channel flow with Zou-He pressure inlet/outlet.

    Physical-parameter constructor mirrors ``Pipe_Flow.__init__``
    (``opencl_dim.py:64-120``): specify diameter/density/viscosity/pressure
    gradient/length in any consistent physical units plus resolution ``N``.

    Args beyond the reference's:
      equilibrium: ``"compressible"`` (D2Q9.cl) or ``"incompressible"``
        (D2Q9i.cl, He-Luo).
      convention: nondimensionalization convention, ``"W"`` or ``"Re"``
        (see :class:`lb2d_tpu.core.nondim.FlowUnits`).
      obstacle_mask: optional ``[ny, nx]`` int/bool mask; full bounce-back is
        applied inside it after the wall BCs (``opencl_dim.py:510-518``).
      seed: RNG seed for the reference's 0.1% initial perturbation
        (``opencl_dim.py:318-321``).
    """

    def __init__(self, diameter=None, rho=None, viscosity=None,
                 pressure_grad=None, pipe_length=None, N=200,
                 time_prefactor=1.0, equilibrium="compressible",
                 convention="W", obstacle_mask=None, seed=0,
                 dtype=jnp.float32, backend="auto", init_state=True):
        self.units = FlowUnits(
            diameter=diameter, rho=rho, viscosity=viscosity,
            pressure_grad=pressure_grad, pipe_length=pipe_length, N=N,
            time_prefactor=time_prefactor, convention=convention,
            L_override=self._characteristic_length(diameter),
        )
        self.lattice = D2Q9
        self.equilibrium = equilibrium
        self.dtype = dtype
        self.omega = self.units.omega

        self.nx, self.ny = self._grid_dims()
        self.lx, self.ly = self.nx - 1, self.ny - 1
        self.inlet_rho, self.outlet_rho = self.units.inlet_outlet_rho(self.nx)

        if obstacle_mask is None:
            obstacle_mask = self._build_obstacle_mask()
        self.obstacle_mask = (
            None if obstacle_mask is None
            else jnp.asarray(np.asarray(obstacle_mask, dtype=bool))
        )

        # "xla" (the default, what "auto" resolves to) or the C++ CPU
        # library ("native", lb2d_tpu/native)
        self.backend = resolve_backend(backend, extra=("native",))

        self.seed = seed
        if not init_state:
            # config-only construction (ShardedPipeFlow builds the state
            # shard-wise instead of staging it on one device)
            return
        self.state = self._init_state(np.random.RandomState(seed))
        super().__init__()

    # --- geometry hooks (overridden by subclasses) ---------------------------
    def _characteristic_length(self, diameter):
        return None  # default: L = diameter (FlowUnits default)

    def _grid_dims(self):
        return self.units.grid_dims()

    def _build_obstacle_mask(self):
        return None

    @property
    def num_cells(self) -> int:
        return self.nx * self.ny

    # --- initialization (opencl_dim.py:258-327) -------------------------------
    def _init_perturb(self, rng: np.random.RandomState) -> np.ndarray:
        """0.1% multiplicative Gaussian perturbation, on host
        (opencl_dim.py:318-321)."""
        return (1.0 + 0.001 * rng.randn(self.lattice.q, self.ny, self.nx)
                ).astype(np.float32)

    def _init_from_perturb(self, perturb):
        """Pure state init given the perturbation field: feq of the linear
        density ramp times the perturbation. jit-able (ShardedPipeFlow runs
        it with sharded outputs)."""
        ny, nx = self.ny, self.nx
        # Linear density ramp inlet -> outlet along x (opencl_dim.py:279-283).
        ramp = self.inlet_rho - np.arange(nx) * (
            (self.inlet_rho - self.outlet_rho) / float(nx)
        )
        rho0 = np.broadcast_to(ramp[None, :], (ny, nx)).astype(np.float32)
        u0 = jnp.zeros((ny, nx), self.dtype)
        v0 = jnp.zeros((ny, nx), self.dtype)
        rho0 = jnp.asarray(rho0, self.dtype)
        feq0 = self._feq_fn()(rho0, u0, v0)
        return feq0 * perturb

    def _init_state(self, rng: np.random.RandomState):
        perturb = jnp.asarray(self._init_perturb(rng), self.dtype)
        return self._init_from_perturb(perturb)

    # --- step construction ------------------------------------------------------
    def _feq_fn(self):
        if self.equilibrium == "incompressible":
            return feq_incompressible
        return feq_quadratic

    def _hydro_fn(self):
        if self.equilibrium == "incompressible":
            return hydro_incompressible
        return hydro_compressible

    def _bc_fn(self):
        if self.equilibrium == "incompressible":
            return lambda f: zou_he_pressure_bcs_incompressible(
                f, self.inlet_rho, self.outlet_rho)
        return lambda f: zou_he_pressure_bcs(f, self.inlet_rho, self.outlet_rho)

    def run(self, num_iterations, *, timed=False):
        if self.backend != "native":
            return super().run(num_iterations, timed=timed)
        # C++ CPU backend (lb2d_tpu/native): the compiled-extension path,
        # mirroring the reference's Cython backend role.
        import time as _time

        from ..native import native_run

        t0 = _time.perf_counter() if timed else None
        mask = (np.asarray(self.obstacle_mask).astype(np.int32)
                if self.obstacle_mask is not None else None)
        f = native_run(
            np.asarray(self.state), num_iterations, omega=self.omega,
            inlet_rho=self.inlet_rho, outlet_rho=self.outlet_rho,
            incompressible=self.equilibrium == "incompressible", mask=mask)
        self.state = jnp.asarray(f)
        if timed:
            dt = _time.perf_counter() - t0
            self.last_mlups = self.num_cells * num_iterations / dt / 1e6
        self.steps_taken += num_iterations
        return self

    def make_step(self):
        feq_fn = self._feq_fn()
        hydro_fn = self._hydro_fn()
        bc_fn = self._bc_fn()
        mask = self.obstacle_mask
        omega = jnp.asarray(self.omega, self.dtype)
        lattice = self.lattice
        zero_vel_in_obstacle = (
            mask is not None and self.equilibrium == "incompressible"
        )

        def step(f):
            f = stream(f, lattice)
            f = bc_fn(f)
            if mask is not None:
                # bounceback_in_obstacle after move_bcs (opencl_dim.py:510-518)
                f = bounce_back_obstacle(f, mask, lattice)
            rho, u, v = hydro_fn(f)
            if zero_vel_in_obstacle:
                # D2Q9i driver zeroes velocity inside the mask after hydro
                # (opencl_dim_D2Q9i.py:494-502).
                u = jnp.where(mask, 0.0, u)
                v = jnp.where(mask, 0.0, v)
            feq = feq_fn(rho, u, v)
            return bgk(f, feq, omega)

        return step

    def device_field(self, name):
        f = self.state
        rho, u, v = self._hydro_fn()(f)
        return {"rho": rho, "u": u, "v": v}.get(name)

    # --- field access (opencl_dim.py:390-438) ------------------------------------
    def get_fields(self) -> dict:
        """All fields in LB units, as numpy arrays indexed ``[x, y]``
        (``f``/``feq`` as ``[9, nx, ny]``) to match the reference layout."""
        f = self.state
        rho, u, v = self._hydro_fn()(f)
        feq = self._feq_fn()(rho, u, v)
        return {
            "f": self._to_host_xy(f),
            "feq": self._to_host_xy(feq),
            "rho": self._to_host_xy(rho),
            "u": self._to_host_xy(u),
            "v": self._to_host_xy(v),
        }

    def get_nondim_fields(self) -> dict:
        fields = self.get_fields()
        scale = self.units.velocity_lb_to_nondim
        fields["u"] = fields["u"] * scale
        fields["v"] = fields["v"] * scale
        return fields

    def get_physical_fields(self) -> dict:
        fields = self.get_nondim_fields()
        scale = self.units.velocity_nondim_to_phys
        fields["u"] = fields["u"] * scale
        fields["v"] = fields["v"] * scale
        return fields


class PipeFlowCylinder(PipeFlow):
    """Flow around a cylinder (``Pipe_Flow_Cylinder``, ``opencl_dim.py:441-518``):
    the characteristic length becomes the cylinder radius and a disk obstacle
    mask of radius N cells is placed at the physical cylinder center.
    """

    def __init__(self, cylinder_center=None, cylinder_radius=None, **kwargs):
        assert cylinder_center is not None
        assert cylinder_radius is not None
        self.phys_cylinder_center = cylinder_center
        self.phys_cylinder_radius = cylinder_radius
        super().__init__(**kwargs)

    def _characteristic_length(self, diameter):
        return self.phys_cylinder_radius  # opencl_dim.py:448-456

    def _grid_dims(self):
        # ly from the pipe diameter, in units of the cylinder radius
        # (opencl_dim.py:458-465).
        return self.units.grid_dims(transverse_extent=self.units.diameter)

    def _build_obstacle_mask(self):
        N = self.units.N
        L = self.units.L
        cx = N * self.phys_cylinder_center[0] / L
        cy = N * self.phys_cylinder_center[1] / L
        return disk_mask(self.nx, self.ny, cx, cy, N)  # radius = N lattice cells


class PipeFlowObstacles(PipeFlow):
    """Pipe flow with an arbitrary user obstacle mask (the working
    ``Pipe_Flow_Obstacles`` class from ``OLD/python.py:417-473``; also the
    cs205_movie.ipynb TIFF-mask workload). ``obstacle_mask`` is required and
    indexed ``[ny, nx]``."""

    def __init__(self, obstacle_mask=None, **kwargs):
        assert obstacle_mask is not None
        assert np.sum(np.asarray(obstacle_mask)) != 0
        super().__init__(obstacle_mask=obstacle_mask, **kwargs)
