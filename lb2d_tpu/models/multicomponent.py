"""Multicomponent / multiphase / porous-media engine.

Rebuilds ``porous_media/single_component.py`` (float64 Guo-porosity engine)
and ``multicomponent_multiphase/multi.py`` (same engine without porosity,
plus growth and screened-Poisson repulsion, D2Q9 **and** D2Q25) as one
configurable runner:

* :class:`Fluid` — per-component parameters (porosity ``epsilon``, effective
  viscosity ``nu_e`` -> tau/omega, fluid viscosity, permeability ``K``,
  Forchheimer ``Fe``, boundary condition) mirroring ``Pourous_Media``
  (``single_component.py:46-67``) / ``multi.py``'s ``Fluid``.
* :class:`SimulationRunner` — owns the state and the reference's composable
  registry of additional force / collision hooks
  (``single_component.py:334-335, 440-677``), which here are **pure
  functions** folded into one fused jitted step; ``run(n)`` is a single
  donated-buffer ``lax.fori_loop``.

Step order is the reference's orchestration exactly
(``single_component.py:679-751``): move -> move_bcs -> hydro -> zero G ->
additional forces -> drag forces (last) -> barycentric velocity -> feq ->
collide -> additional collisions.

Physics formulas (all cited into the kernels):

* porosity feq ``w rho (1 + c.u/cs2 + (c.u)^2/(2 cs4 eps) - u^2/(2 cs2 eps))``
  (``single_component.cl:52-58``); ``eps = 1`` recovers ``multi.cl:52-75``.
* Guo forcing ``F_i = w rho (1 - omega/2)(c.F/cs2 + (c.F)(c.u)/(cs4 eps)
  - u.F/(cs2 eps))`` (``single_component.cl:104-113``); the multicomponent
  variant drops the ``rho`` factor and ``eps`` (``multi.cl:115-126``).
* Darcy + Forchheimer drag ``G += -eps nu_f u / K - eps Fe |u| u / sqrt(K)``
  after scaling accumulated forces by ``eps`` (``single_component.cl:317-331``).
* barycentric velocity ``(sum_i sum_j c_j f_ij + sum_i rho_i G_i/2)/rho_tot``
  (``single_component.cl:161-212``).
* Shan-Chen interaction with 4 pseudopotentials (``get_psi``,
  ``single_component.cl:609-651``) over the D2Q9 first belt
  (``:652-793``) or the explicit two-belt 25-vector stencil built in
  ``single_component.py:530-646`` (``:795-967``), with periodic or
  zero-gradient (clamped) halo neighbors.

dtype: the reference hard-requires fp64 (``single_component.cl:1-7``).
Default here is fp64 when ``jax_enable_x64`` is on, else fp32 (documented
choice per SURVEY.md §7.6; enable x64 for bit-faithful comparisons).
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from ..core.lattice import D2Q9, D2Q25, Lattice
from .base import resolve_backend

__all__ = ["Fluid", "SimulationRunner", "SECOND_BELT_STENCIL"]

ZERO_DENSITY_POROUS = 1e-6   # single_component.cl:9
ZERO_DENSITY_MULTI = 1e-12   # multi.cl:9


def _second_belt_stencil():
    """The explicit 25-vector two-belt stencil and weights constructed in
    ``single_component.py:533-646`` (pi1 over the first belt, pi2 over the
    second)."""
    pi1, c1 = [], []
    for v in [(1, 0), (0, 1), (-1, 0), (0, -1)]:
        pi1.append(4.0 / 63.0)
        c1.append(v)
    for v in [(1, 1), (-1, 1), (-1, -1), (1, -1)]:
        pi1.append(4.0 / 135.0)
        c1.append(v)
    pi2, c2 = [], []
    for v in [(2, 0), (0, 2), (-2, 0), (0, -2)]:
        pi2.append(1.0 / 180.0)
        c2.append(v)
    for v in [(2, -1), (2, 1), (1, 2), (-1, 2), (-2, 1), (-2, -1), (-1, -2),
              (1, -2)]:
        pi2.append(2.0 / 945.0)
        c2.append(v)
    for v in [(2, 2), (-2, 2), (-2, -2), (2, -2)]:
        pi2.append(1.0 / 15120.0)
        c2.append(v)
    return list(zip(pi1 + pi2, c1 + c2))


SECOND_BELT_STENCIL = _second_belt_stencil()


def _shift(field, cx, cy, bc):
    """``field(x + c)`` with periodic wrap or zero-gradient (clamped-edge)
    neighbors (``single_component.cl:700-716``)."""
    if bc == "periodic":
        out = field
        if cy:
            out = jnp.roll(out, -cy, axis=0)
        if cx:
            out = jnp.roll(out, -cx, axis=1)
        return out
    # zero_gradient: clamp out-of-domain neighbors to the edge value
    h = max(abs(cx), abs(cy), 1)
    padded = jnp.pad(field, h, mode="edge")
    ny, nx = field.shape
    return padded[h + cy:h + cy + ny, h + cx:h + cx + nx]


def get_psi(specifier, rho_1, rho_2, parameters, zero_density):
    """The 4 pseudopotential forms (``single_component.cl:609-651``)."""
    if specifier == 0:      # linear
        return rho_1, rho_2
    if specifier == 1:      # shan_chen
        rho_0 = parameters[0]
        return (rho_0 * (1 - jnp.exp(-rho_1 / rho_0)),
                rho_0 * (1 - jnp.exp(-rho_2 / rho_0)))
    if specifier == 2:      # pow
        a = parameters[0]
        p1 = jnp.where(rho_1 > zero_density,
                       jnp.maximum(rho_1, zero_density) ** a, 0.0)
        p2 = jnp.where(rho_2 > zero_density,
                       jnp.maximum(rho_2, zero_density) ** a, 0.0)
        return p1, p2
    if specifier == 3:      # vdw (G must be 1)
        a, b, T, cs = parameters[:4]
        P1 = (rho_1 * T) / (1 - rho_1 * b) - a * rho_1 * rho_1
        P2 = (rho_2 * T) / (1 - rho_2 * b) - a * rho_2 * rho_2
        cs2 = cs * cs
        s1 = jnp.sqrt(jnp.maximum(2 * (P1 - cs2 * rho_1) / cs2, 0.0))
        s2 = jnp.sqrt(jnp.maximum(2 * (P2 - cs2 * rho_2) / cs2, 0.0))
        return s1, s2
    raise ValueError(f"unknown PSI specifier {specifier}")


_PSI_NAMES = {"linear": 0, "shan_chen": 1, "pow": 2, "vdw": 3}


class Fluid:
    """Per-component configuration + init (mirrors ``Pourous_Media``,
    ``single_component.py:46-107``). ``epsilon = 1`` and
    ``porous=False`` on the runner gives the plain multicomponent fluid."""

    def __init__(self, sim, field_index, nu_e=1.0, epsilon=1.0, nu_fluid=1.0,
                 K=1.0, Fe=1.0, bc="periodic"):
        assert bc in ("periodic", "zero_gradient")
        self.sim = sim
        self.field_index = int(field_index)
        self.lb_nu_e = nu_e
        self.epsilon = epsilon
        self.nu_fluid = nu_fluid
        self.K = K
        self.Fe = Fe
        self.bc = bc
        self.tau = 0.5 + nu_e / sim.lattice.cs2
        self.omega = 1.0 / self.tau
        assert self.omega < 2.0

    def initialize(self, rho_arr, f_amp=0.0, seed=None):
        """Install the initial density and seed f = feq(rho, u_bary)
        perturbed by ``f_amp`` (``single_component.py:70-107``).
        ``rho_arr`` is [ny, nx] (pass the reference's (nx, ny) transposed).
        """
        sim = self.sim
        i = self.field_index
        eps = self.epsilon
        rho_arr = jnp.asarray(np.asarray(rho_arr), sim.dtype)
        sim.rho = sim.rho.at[i].set(rho_arr)

        # jitted + donated: the eager per-op path materializes several
        # full-grid [q, ny, nx] temporaries (feq, cu, cu^2, ...) and
        # OOMs at 8192^2
        def install(f, rho_a, u, v, perturb):
            feq_i = sim._feq_single(rho_a, u, v, eps)
            if perturb is not None:
                feq_i = feq_i * perturb
            return f.at[:, i].set(feq_i)

        perturb = None
        if f_amp:
            rng = np.random.RandomState(
                seed if seed is not None else 7 * (i + 1))
            perturb = jnp.asarray(
                1.0 + f_amp * rng.randn(sim.lattice.q, sim.ny, sim.nx),
                sim.dtype)
        sim.f = jax.jit(install, donate_argnums=0,
                        static_argnames=())(
            sim.f, rho_arr, sim.u_bary, sim.v_bary, perturb)


class SimulationRunner:
    """The orchestrator (``single_component.py:245-766`` /
    ``multi.py:226-818``). Force/collision hooks are registered before the
    first ``run``; the step is compiled on first use."""

    def __init__(self, nx=100, ny=100, L_lb=100, T_lb=1.0, num_populations=1,
                 porous=True, lattice: Lattice = D2Q9, dtype=None,
                 check_max_ulb=False, mach_tolerance=0.1, backend="auto"):
        self.nx, self.ny = int(nx), int(ny)
        self.L_lb, self.T_lb = L_lb, T_lb
        self.delta_x = 1.0 / L_lb
        self.delta_t = 1.0 / T_lb
        self.num_populations = int(num_populations)
        self.porous = porous
        self.lattice = lattice
        if dtype is None:
            dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        self.dtype = dtype
        self.zero_density = (ZERO_DENSITY_POROUS if porous
                             else ZERO_DENSITY_MULTI)
        self.check_max_ulb = check_max_ulb
        self.mach_tolerance = mach_tolerance
        C, q = self.num_populations, lattice.q
        self.rho = jnp.zeros((C, self.ny, self.nx), dtype)
        self.u_bary = jnp.zeros((self.ny, self.nx), dtype)
        self.v_bary = jnp.zeros((self.ny, self.nx), dtype)
        self.f = jnp.zeros((q, C, self.ny, self.nx), dtype)

        self.fluid_list: list[Fluid] = []
        self.additional_forces = []      # fns (rho, u, v, Gx, Gy) -> (Gx, Gy)
        self.additional_collisions = []  # fns (f, rho) -> f
        # screened-Poisson solvers of the registered force hooks (switched
        # to the partitionable DFT by shard_over)
        self._screened = []
        self._run_jit = None
        self._mesh = None
        self.backend = resolve_backend(backend)
        self.backend_used = None
        self.steps_taken = 0

    # ---- setup ---------------------------------------------------------------
    def add_fluid(self, fluid: Fluid):
        self.fluid_list.append(fluid)

    def complete_setup(self):
        assert len(self.fluid_list) == self.num_populations
        self.tau_arr = np.array([fl.tau for fl in self.fluid_list])

    def set_bary_velocity(self, u_bary, v_bary):
        self.u_bary = jnp.asarray(np.asarray(u_bary), self.dtype)
        self.v_bary = jnp.asarray(np.asarray(v_bary), self.dtype)

    # ---- registry hooks (reference API names) --------------------------------
    def add_eating_rate(self, eater_index, eatee_index, rate):
        """f_eater += w rate rho_eater rho_eatee; f_eatee -= the same
        (``single_component.cl:120-159``)."""
        w = self._w_col()

        def collision(f, rho):
            growth = rate * rho[eater_index] * rho[eatee_index]
            f = f.at[:, eater_index].add(w * growth)
            f = f.at[:, eatee_index].add(-w * growth)
            return f

        self.additional_collisions.append(collision)

    def add_growth(self, eater_index, min_rho_cutoff, max_rho_cutoff,
                   eat_rate):
        """Uniform growth wherever the density is inside the cutoff window
        (``multi.cl:182-220``)."""
        w = self._w_col()

        def collision(f, rho):
            r = rho[eater_index]
            grow = jnp.where((r > min_rho_cutoff) & (r < max_rho_cutoff),
                             eat_rate, 0.0)
            return f.at[:, eater_index].add(w * grow)

        self.additional_collisions.append(collision)

    def add_constant_body_force(self, fluid_index, force_x, force_y):
        """Constant force per density (``single_component.cl:547-570``)."""

        def force(rho, u, v, Gx, Gy):
            return (Gx.at[fluid_index].add(force_x),
                    Gy.at[fluid_index].add(force_y))

        self.additional_forces.append(force)

    def add_constant_g_force(self, fluid_index, g_x, g_y):
        """Constant gravity: force density ``g rho``
        (``multi.cl:541-566``)."""

        def force(rho, u, v, Gx, Gy):
            return (Gx.at[fluid_index].add(g_x * rho[fluid_index]),
                    Gy.at[fluid_index].add(g_y * rho[fluid_index]))

        self.additional_forces.append(force)

    def _radial(self, center_x, center_y, prefactor, radial_scaling,
                times_rho, fluid_index):
        X, Y = np.meshgrid(np.arange(self.nx), np.arange(self.ny))
        dx_, dy_ = X - center_x, Y - center_y
        r = np.sqrt(dx_**2 + dy_**2)
        theta = np.arctan2(dy_, dx_)
        mag = prefactor * r**radial_scaling
        fx = jnp.asarray(mag * np.cos(theta), self.dtype)
        fy = jnp.asarray(mag * np.sin(theta), self.dtype)

        def force(rho, u, v, Gx, Gy):
            scale = rho[fluid_index] if times_rho else 1.0
            return (Gx.at[fluid_index].add(fx * scale),
                    Gy.at[fluid_index].add(fy * scale))

        self.additional_forces.append(force)

    def add_radial_body_force(self, fluid_index, center_x, center_y,
                              prefactor, radial_scaling):
        """(``single_component.cl:571-607``)"""
        self._radial(center_x, center_y, prefactor, radial_scaling, False,
                     fluid_index)

    def add_radial_g_force(self, fluid_index, center_x, center_y, prefactor,
                           radial_scaling):
        """(``multi.cl:568-606``)"""
        self._radial(center_x, center_y, prefactor, radial_scaling, True,
                     fluid_index)

    def _interaction(self, fluid_1, fluid_2, G_int, bc, potential,
                     potential_parameters, stencil):
        spec = _PSI_NAMES[potential]
        params = (np.asarray(potential_parameters, np.float64)
                  if potential_parameters is not None else np.array([0.0]))
        zd = self.zero_density

        def force(rho, u, v, Gx, Gy):
            r1, r2 = rho[fluid_1], rho[fluid_2]
            psi1_c, psi2_c = get_psi(spec, r1, r2, params, zd)
            fx1 = jnp.zeros_like(r1)
            fy1 = jnp.zeros_like(r1)
            fx2 = jnp.zeros_like(r1)
            fy2 = jnp.zeros_like(r1)
            for wgt, (cxj, cyj) in stencil:
                s1 = _shift(r1, cxj, cyj, bc)
                s2 = _shift(r2, cxj, cyj, bc)
                p1, p2 = get_psi(spec, s1, s2, params, zd)
                fx1 = fx1 + wgt * cxj * p2
                fy1 = fy1 + wgt * cyj * p2
                fx2 = fx2 + wgt * cxj * p1
                fy2 = fy2 + wgt * cyj * p1
            fx1, fy1 = -G_int * psi1_c * fx1, -G_int * psi1_c * fy1
            fx2, fy2 = -G_int * psi2_c * fx2, -G_int * psi2_c * fy2
            # force -> force per density with zero-density guard
            # (single_component.cl:779-792)
            safe1 = jnp.where(r1 > zd, r1, 1.0)
            safe2 = jnp.where(r2 > zd, r2, 1.0)
            Gx = Gx.at[fluid_1].add(jnp.where(r1 > zd, fx1 / safe1, 0.0))
            Gy = Gy.at[fluid_1].add(jnp.where(r1 > zd, fy1 / safe1, 0.0))
            Gx = Gx.at[fluid_2].add(jnp.where(r2 > zd, fx2 / safe2, 0.0))
            Gy = Gy.at[fluid_2].add(jnp.where(r2 > zd, fy2 / safe2, 0.0))
            return Gx, Gy

        self.additional_forces.append(force)

    def add_interaction_force(self, fluid_1_index, fluid_2_index, G_int,
                              bc="periodic", potential="linear",
                              potential_parameters=None):
        """First-belt (D2Q9) Shan-Chen interaction
        (``single_component.cl:652-793``)."""
        lat = D2Q9  # multi.py:517-529 always uses the D2Q9 stencil here
        stencil = [(lat.w[j], (lat.cx[j], lat.cy[j]))
                   for j in range(1, lat.q)]
        self._interaction(fluid_1_index, fluid_2_index, G_int, bc, potential,
                          potential_parameters, stencil)

    def add_interaction_force_second_belt(self, fluid_1_index, fluid_2_index,
                                          G_int, bc="periodic",
                                          potential="linear",
                                          potential_parameters=None):
        """Two-belt 25-vector Shan-Chen interaction
        (``single_component.cl:795-967``; stencil from
        ``single_component.py:533-646``)."""
        self._interaction(fluid_1_index, fluid_2_index, G_int, bc, potential,
                          potential_parameters, SECOND_BELT_STENCIL)

    def add_screened_poisson_force(self, source_index, force_index,
                                   interaction_length, amplitude):
        """Per-step spectral repulsion (``multi.py:488-511, 768-769``):
        ``G[force_index] += amplitude * grad(screen(rho[source_index]))``
        with dx = 1, solved with ``jnp.fft`` (the matmul DFT once
        :meth:`shard_over` spreads the state over several devices)."""
        from .waves import _ScreenedVelocity

        vel = _ScreenedVelocity(self.ny, self.nx, interaction_length,
                                1.0, 1.0, 1.0)
        self._screened.append(vel)
        # _ScreenedVelocity returns -vc*ulb*grad with vc=ulb=1 -> -grad;
        # the reference adds +amplitude*grad, so negate.
        def force(rho, u, v, Gx, Gy):
            gx, gy = vel(rho[source_index].astype(jnp.float32))
            gx = (-amplitude * gx).astype(Gx.dtype)
            gy = (-amplitude * gy).astype(Gy.dtype)
            return Gx.at[force_index].add(gx), Gy.at[force_index].add(gy)

        self.additional_forces.append(force)

    # ---- numerics ------------------------------------------------------------
    def _w_col(self):
        return jnp.asarray(np.asarray(self.lattice.w), self.dtype)[:, None, None]

    def _consts(self):
        lat = self.lattice
        w = jnp.asarray(np.asarray(lat.w), self.dtype)[:, None, None]
        cx = jnp.asarray(np.asarray(lat.cx), self.dtype)[:, None, None]
        cy = jnp.asarray(np.asarray(lat.cy), self.dtype)[:, None, None]
        return w, cx, cy

    def _feq_single(self, rho, u, v, epsilon):
        """Porosity feq for one component (``single_component.cl:39-60``)."""
        lat = self.lattice
        w, cx, cy = self._consts()
        cs2 = lat.cs2
        cu = cx * u + cy * v
        usq = u * u + v * v
        return w * rho * (1.0 + cu / cs2 + cu * cu / (2 * cs2 * cs2 * epsilon)
                          - usq / (2 * cs2 * epsilon))

    def _step(self, f):
        lat = self.lattice
        q, C = lat.q, self.num_populations
        w, cx, cy = self._consts()
        cs2 = lat.cs2
        zd = self.zero_density

        # ---- move + move_bcs per fluid (single_component.py:692-699) -------
        planes = []
        for j in range(q):
            p = f[j]
            if lat.cy[j]:
                p = jnp.roll(p, lat.cy[j], axis=1)
            if lat.cx[j]:
                p = jnp.roll(p, lat.cx[j], axis=2)
            planes.append(p)
        f = jnp.stack(planes)
        for fl in self.fluid_list:
            if fl.bc == "zero_gradient":
                f = _zero_gradient_bcs(f, fl.field_index)

        # ---- hydro per fluid (single_component.cl:214-274) ------------------
        rho = jnp.sum(f, axis=0)                        # [C, ny, nx]
        jx = jnp.sum(cx[:, None] * f, axis=0)
        jy = jnp.sum(cy[:, None] * f, axis=0)
        good = rho > zd
        u = jnp.where(good, jx / jnp.where(good, rho, 1.0), 0.0)
        v = jnp.where(good, jy / jnp.where(good, rho, 1.0), 0.0)

        # ---- forces (registry, then drag last) ------------------------------
        Gx = jnp.zeros_like(rho)
        Gy = jnp.zeros_like(rho)
        for force in self.additional_forces:
            Gx, Gy = force(rho, u, v, Gx, Gy)
        if self.porous:
            # update_forces_pourous (single_component.cl:276-335)
            for fl in self.fluid_list:
                i = fl.field_index
                eps, nuf, K, Fe = fl.epsilon, fl.nu_fluid, fl.K, fl.Fe
                ui, vi, ri = u[i], v[i], rho[i]
                gx = Gx[i] * eps - (eps * nuf * ui) / K
                gy = Gy[i] * eps - (eps * nuf * vi) / K
                vel_mag = jnp.sqrt(ui * ui + vi * vi)
                gx = gx - (eps * Fe * vel_mag * ui) / np.sqrt(K)
                gy = gy - (eps * Fe * vel_mag * vi) / np.sqrt(K)
                ok = ri > zd
                Gx = Gx.at[i].set(jnp.where(ok, gx, 0.0))
                Gy = Gy.at[i].set(jnp.where(ok, gy, 0.0))

        # ---- barycentric velocity (single_component.cl:161-212) -------------
        rho_tot = jnp.sum(rho, axis=0)
        sum_x = jnp.sum(jx, axis=0) + jnp.sum(rho * Gx / 2.0, axis=0)
        sum_y = jnp.sum(jy, axis=0) + jnp.sum(rho * Gy / 2.0, axis=0)
        u_bary = sum_x / rho_tot
        v_bary = sum_y / rho_tot

        # ---- feq + collide per fluid ----------------------------------------
        new_f = []
        for fl in self.fluid_list:
            i = fl.field_index
            eps, omega = fl.epsilon, fl.omega
            feq_i = self._feq_single(rho[i], u_bary, v_bary, eps)
            cF = cx * Gx[i] + cy * Gy[i]
            cu = cx * u_bary + cy * v_bary
            uF = Gx[i] * u_bary + Gy[i] * v_bary
            if self.porous:
                # Guo with rho and porosity (single_component.cl:104-113)
                Fi = w * rho[i] * (1 - 0.5 * omega) * (
                    cF / cs2 + cF * cu / (cs2 * cs2 * eps)
                    - uF / (cs2 * eps))
            else:
                # multi.cl:115-126: no rho factor, no porosity
                Fi = w * (1 - 0.5 * omega) * (
                    cF / cs2 + cF * cu / (cs2 * cs2) - uF / cs2)
            new_f.append(f[:, i] * (1 - omega) + omega * feq_i + Fi)
        f = jnp.stack(new_f, axis=1)

        # ---- additional collisions ------------------------------------------
        for coll in self.additional_collisions:
            f = coll(f, rho)
        return f

    # ---- sharding --------------------------------------------------------------
    def shard_over(self, mesh):
        """Domain-decompose the state over a ``("y", "x")`` device mesh.

        The step is pure jnp (rolls, elementwise, reductions), so GSPMD
        partitions it once the state carries a ``NamedSharding``: rolls
        become halo ``collective-permute``s and the barycentric reductions
        stay shard-local. This is the scaling path for the 8192^2 porous
        workload (BASELINE.json config 5).
        """
        from jax.sharding import NamedSharding, PartitionSpec as P

        names = mesh.axis_names
        assert "y" in names, "shard_over expects a ('y', 'x') mesh"
        xs = ["x"] if "x" in names else []
        s4 = NamedSharding(mesh, P(None, None, "y", *xs))
        s3 = NamedSharding(mesh, P(None, "y", *xs))
        s2 = NamedSharding(mesh, P("y", *xs))
        if mesh.size > 1:
            # cuFFT / the CPU FFT thunk do not partition a sharded operand
            # (the CPU one RET_CHECKs on 2-D-sharded layouts): solve with the
            # GSPMD-partitionable matmul DFT instead
            for vel in self._screened:
                vel.method = "matmul"
        self.f = jax.device_put(self.f, s4)
        self.rho = jax.device_put(self.rho, s3)
        self.u_bary = jax.device_put(self.u_bary, s2)
        self.v_bary = jax.device_put(self.v_bary, s2)
        self._mesh = mesh
        self._run_jit = None  # re-jit against the sharded state
        self._warm = False
        return self

    # ---- execution -----------------------------------------------------------
    def run(self, num_iterations, debug=False, timed=False):
        if self._run_jit is None:
            step = self._step
            self.backend_used = "xla"
            self._run_jit = jax.jit(
                lambda f, n: jax.lax.fori_loop(0, n, lambda i, s: step(s), f),
                donate_argnums=0)
        if timed and not getattr(self, "_warm", False):
            # compile + sync outside the timed region (cf. LBModel.run)
            self.f = jax.block_until_ready(
                self._run_jit(self.f, np.int32(0)))
            self._warm = True
        t0 = time.perf_counter() if timed else None
        if debug:
            for _ in range(num_iterations):
                self.f = self._run_jit(self.f, np.int32(1))
                self.check_fields()
        else:
            self.f = self._run_jit(self.f, np.int32(num_iterations))
        if timed:
            jax.block_until_ready(self.f)
            dt = time.perf_counter() - t0
            self.last_mlups = self.nx * self.ny * num_iterations / dt / 1e6
        self.steps_taken += num_iterations
        # refresh derived host-visible fields
        self._refresh_hydro()
        return self

    def _refresh_hydro(self):
        if not hasattr(self, "_refresh_jit"):
            def refresh(f):
                # jitted: the eager form materializes full [q, C, ny, nx]
                # weighted temporaries (OOM at 8192^2)
                w, cx, cy = self._consts()
                rho = jnp.sum(f, axis=0)
                rho_tot = jnp.sum(rho, axis=0)
                u = jnp.sum(jnp.sum(cx[:, None] * f, axis=0),
                            axis=0) / rho_tot
                v = jnp.sum(jnp.sum(cy[:, None] * f, axis=0),
                            axis=0) / rho_tot
                return rho, u, v

            self._refresh_jit = jax.jit(refresh)
        self.rho, self.u_bary, self.v_bary = self._refresh_jit(self.f)

    def check_fields(self, accumulate: str = "f64"):
        """Conservation debug dump (``single_component.py:753-766``).

        Defaults to fp64-grade accumulation (the reference engine is
        hard-fp64, ``single_component.cl:1-7``; naive f32 sums lose ~3-4
        digits at 8192^2 — see ``utils.metrics.accumulated_sum``)."""
        from ..utils.metrics import accumulated_sum

        rho = jnp.sum(self.f, axis=0)
        out = {}
        for i in range(self.num_populations):
            out[f"sum_rho_{i}"] = accumulated_sum(rho[i], accumulate)
            out[f"sum_f_{i}"] = accumulated_sum(self.f[:, i], accumulate)
        print(out)
        return out

    def get_fields(self):
        """Reference layout: rho (nx, ny, C), f (nx, ny, C, Q)."""
        self._refresh_hydro()
        return {
            "f": np.transpose(np.asarray(self.f), (3, 2, 1, 0)),
            "rho": np.transpose(np.asarray(self.rho), (2, 1, 0)),
            "u_bary": np.asarray(self.u_bary).T,
            "v_bary": np.asarray(self.v_bary).T,
        }


def _zero_gradient_bcs(f, i):
    """``move_open_bcs`` (``single_component.cl:417-519``): every edge cell
    copies ALL populations of field ``i`` from its adjacent interior cell
    (corners from the diagonal interior neighbor).

    Masked-select form, not edge scatters: GSPMD miscompiles ``.at[].set``
    on the edges of y-sharded arrays (each shard applies the global row -1
    update to its own last local row — cf. the noflux multifield BC fix)."""
    fi = f[:, i]
    ny, nx = fi.shape[-2], fi.shape[-1]
    row = jax.lax.broadcasted_iota(jnp.int32, (ny, nx), 0)
    lane = jax.lax.broadcasted_iota(jnp.int32, (ny, nx), 1)
    # neighbor-to-copy coordinates: clamp each edge cell one cell inward
    # (corners clamp both axes -> diagonal interior neighbor)
    down = jnp.roll(fi, -1, axis=-2)   # value at (y+1, x)
    up = jnp.roll(fi, 1, axis=-2)      # value at (y-1, x)
    fi = jnp.where(row == 0, down, fi)
    fi = jnp.where(row == ny - 1, up, fi)
    right = jnp.roll(fi, -1, axis=-1)  # value at (y, x+1), post-row-fix
    left = jnp.roll(fi, 1, axis=-1)    # value at (y, x-1)
    fi = jnp.where(lane == 0, right, fi)
    fi = jnp.where(lane == nx - 1, left, fi)
    return f.at[:, i].set(fi)
