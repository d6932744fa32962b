"""Multifield range-expansion models (N competing populations).

Rebuilds ``advecting_range_expansion/``:

* :class:`FisherExpansion` — ``deterministic_fisher_waves.py`` (``Fisher_
  Expansion``): N populations with logistic competition against the total
  density ``G_i rho_i (1 - rho_tot)`` (``D2Q9_multifield_fisher.cl:91-105``),
  per-population omegas, and no-flux (full bounce-back) walls on all four
  sides (``D2Q9_multifield_fisher.cl:184-289``).
* :class:`Expansion` — ``stochastic_nutrients.py``: N populations plus one
  shared nutrient field; growth ``G_i rho_i c`` consumes the nutrient, the
  stochastic part uses the **Milstein** update
  ``sqrt(Dg rho c) eta + (Dg c / 4)(eta^2 - 1)``
  (``D2Q9_multifield_diffusion.cl:118-121``), with zero/NaN clipping of both
  densities (``:71-74``) and populations (``:137-142,157-162``).

Both use the Fisher scaling ``L = 2 sqrt(D_std/mu_std)``, ``T = 1/mu_std``
(``stochastic_nutrients.py:252-261``). State layout: ``f[Q, F, ny, nx]``
(F = fields), streamed along the last two axes; everything is one fused XLA
step per iteration.

Reproduced quirk note: with the reference defaults ``vx = vy = vc = 0`` the
velocity scaling divides by zero (``stochastic_nutrients.py:390-391``);
we define the imposed velocity as exactly zero in that case.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.lattice import D2Q9
from ..ops.boundary import noflux_walls_masked
from .base import LBModel

__all__ = ["FisherExpansion", "Expansion", "noflux_bcs_multifield"]


def _stream_fields(f, lattice):
    """Periodic streaming of ``f[Q, F, ny, nx]`` along (y, x)."""
    planes = []
    for j in range(lattice.q):
        p = f[j]
        cy, cx = lattice.cy[j], lattice.cx[j]
        if cy:
            p = jnp.roll(p, cy, axis=1)
        if cx:
            p = jnp.roll(p, cx, axis=2)
        planes.append(p)
    return jnp.stack(planes)


def noflux_bcs_multifield(f):
    """No-flux walls + corners for every field, exactly as
    ``D2Q9_multifield_fisher.cl:184-289`` (full bounce-back of the three
    outgoing populations on each wall; three populations per corner).

    Implemented as masked selects (:func:`~lb2d_tpu.ops.boundary.
    noflux_walls_masked`) — NOT ``.at[].set`` edge scatters, which GSPMD
    miscompiles on y-sharded arrays (every shard applies the global row -1
    update to its own last local row)."""
    q, F, ny, nx = f.shape
    rowid = jax.lax.broadcasted_iota(jnp.int32, (ny, nx), 0)
    laneid = jax.lax.broadcasted_iota(jnp.int32, (ny, nx), 1)
    st = [[f[j, p] for p in range(F)] for j in range(q)]
    st = noflux_walls_masked(st, rowid, laneid, ny, nx)
    return jnp.stack([jnp.stack(st[j]) for j in range(q)])


class _MultifieldBase(LBModel):
    """Shared scaffolding: Fisher scaling, grid, imposed velocity, linear feq
    over all fields."""

    def __init__(self, Lx=1.0, Ly=1.0, vx=0.0, vy=0.0, vc=0.0,
                 mu_standard=1.0, mu_list=None, D_standard=1.0, D_list=None,
                 time_prefactor=1.0, N=50, rho_amp=1.0,
                 concentration_amp=1.0, seed=0, dtype=jnp.float32, **kw):
        assert mu_list is not None and D_list is not None
        self.phys_Lx, self.phys_Ly = Lx, Ly
        self.phys_vx, self.phys_vy, self.phys_vc = vx, vy, vc
        self.phys_mu_standard = mu_standard
        self.phys_mu_list = np.asarray(mu_list, np.float64)
        self.D_standard = D_standard
        self.phys_D_list = np.asarray(D_list, np.float64)
        self.num_populations = len(self.phys_mu_list)
        self.rho_amp = rho_amp
        self.concentration_amp = concentration_amp
        self.N = N
        self.lattice = D2Q9
        self.dtype = dtype
        self._extra_init(**kw)

        # Fisher scaling (stochastic_nutrients.py:252-261)
        self.L = 2.0 * np.sqrt(self.D_standard / self.phys_mu_standard)
        self.T = 1.0 / self.phys_mu_standard
        self.vf = self.L / self.T

        self.delta_x = 1.0 / N
        self.delta_t = time_prefactor * self.delta_x**2

        # field constants (stochastic_nutrients.py:204-250)
        self.dim_vel_ratio = self.phys_vc / self.vf
        self.dim_G = self.phys_mu_list / self.phys_mu_standard
        self.lb_G = (self.dim_G * self.delta_t).astype(np.float32)
        self.dim_D_population = self.phys_D_list / (4.0 * self.D_standard)
        self.lb_D_population = (
            self.dim_D_population * self.delta_t / self.delta_x**2
        ).astype(np.float32)
        self.omega = (0.5 + self.lb_D_population / self.lattice.cs2) ** -1.0
        self.omega = self.omega.astype(np.float32)
        assert (self.omega < 2.0).all()

        # grid (stochastic_nutrients.py:263-273): +2 boundary ring
        self.lx = self.N * int(self.phys_Lx / self.L)
        self.ly = self.N * int(self.phys_Ly / self.L)
        self.nx, self.ny = self.lx + 2, self.ly + 2

        # imposed velocity (stochastic_nutrients.py:390-402); vc=0 -> zero
        if self.phys_vc != 0:
            dim_vx = self.dim_vel_ratio * self.phys_vx / self.phys_vc
            dim_vy = self.dim_vel_ratio * self.phys_vy / self.phys_vc
        else:
            dim_vx = dim_vy = 0.0
        self.lb_vx = (self.delta_t / self.delta_x) * dim_vx
        self.lb_vy = (self.delta_t / self.delta_x) * dim_vy
        self.u = jnp.asarray(np.float32(self.lb_vx))[None, None]
        self.v = jnp.asarray(np.float32(self.lb_vy))[None, None]

        self.state = self._init_state(np.random.RandomState(seed))
        super().__init__()

    def _extra_init(self, **kw):
        pass

    @property
    def num_fields(self):
        raise NotImplementedError

    @property
    def num_cells(self):
        return self.nx * self.ny

    def _feq(self, rho):
        """Linear feq per field with the shared (u, v)
        (``D2Q9_multifield_diffusion.cl:1-47``); rho is [F, ny, nx]."""
        lat = self.lattice
        w = jnp.asarray(lat.w_np())[:, None, None, None]
        cx = jnp.asarray(lat.cx_np(np.float32))[:, None, None, None]
        cy = jnp.asarray(lat.cy_np(np.float32))[:, None, None, None]
        cu = cx * self.u[None] + cy * self.v[None]
        return w * rho[None] * (1.0 + cu / lat.cs2)

    def _fields_dict(self, f):
        rho = jnp.sum(f, axis=0)
        feq = self._feq(rho)
        # reference layout: f (nx, ny, F, Q), rho (nx, ny, F)
        return {
            "f": np.transpose(np.asarray(f), (3, 2, 1, 0)),
            "feq": np.transpose(np.asarray(feq), (3, 2, 1, 0)),
            "rho": np.transpose(np.asarray(rho), (2, 1, 0)),
            "u": np.broadcast_to(np.asarray(self.u), (self.nx, self.ny)),
            "v": np.broadcast_to(np.asarray(self.v), (self.nx, self.ny)),
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


class FisherExpansion(_MultifieldBase):
    """Deterministic multifield Fisher waves with logistic competition and
    no-flux walls (``deterministic_fisher_waves.py:55-499``).

    ``initial_frac_widths`` / ``initial_frac_indices`` paint vertical stripes
    of each population over the first ``N * initial_fisher_widths`` rows
    (``deterministic_fisher_waves.py:299-345``).
    """

    def _extra_init(self, initial_frac_widths=None, initial_frac_indices=None,
                    initial_fisher_widths=2):
        assert initial_frac_widths is not None
        assert initial_frac_indices is not None
        self.initial_frac_widths = list(initial_frac_widths)
        self.initial_frac_indices = list(initial_frac_indices)
        self.initial_fisher_widths = initial_fisher_widths

    @property
    def num_fields(self):
        return self.num_populations

    def _init_state(self, rng):
        P = self.num_populations
        # stripes along x, occupied band along y (deterministic_fisher_waves.py:325-345)
        rho = np.zeros((P, self.ny, self.nx), np.float32)
        band = int(self.N * self.initial_fisher_widths)
        sites = 0
        n_w = len(self.initial_frac_widths)
        for count, (width, idx) in enumerate(
                zip(self.initial_frac_widths, self.initial_frac_indices), 1):
            num = int(width * self.nx)
            if count == n_w:
                num = self.nx - sites
            rho[idx, 0:band, sites:sites + num] = 1.0
            sites += num
        f = self._feq(jnp.asarray(rho, self.dtype))
        return f

    def make_step(self):
        lat = self.lattice
        w = jnp.asarray(lat.w_np())[:, None, None, None]
        omega = jnp.asarray(self.omega)[None, :, None, None]
        G = jnp.asarray(self.lb_G)[:, None, None]

        def step(f):
            f = _stream_fields(f, lat)
            f = noflux_bcs_multifield(f)
            rho = jnp.sum(f, axis=0)               # [P, ny, nx]
            rho_tot = jnp.sum(rho, axis=0)         # [ny, nx]
            feq = self._feq(rho)
            growth = G * rho * (1.0 - rho_tot)[None]
            return f * (1.0 - omega) + omega * feq + w * growth[None]

        return step

    def get_fields(self):
        return self._fields_dict(self.state)

    def device_field(self, name):
        # total population density (renderer fast path)
        if name == "rho":
            return jnp.sum(self.state, axis=(0, 1))
        return None


class Expansion(_MultifieldBase):
    """Stochastic multifield range expansion with a consumable nutrient
    (``stochastic_nutrients.py:55-545``). State: ``(f, key)`` with
    ``f[Q, P+1, ny, nx]`` — the last field is the nutrient.

    Per step: periodic stream -> clipped hydro -> linear feq -> collision
    with growth ``G_i rho_i c``, Milstein noise, nutrient consumption
    ``-sum_i react_i``, and zero/negativity/NaN clipping
    (``D2Q9_multifield_diffusion.cl:80-168``); fresh normals per population
    each step (``stochastic_nutrients.py:478-496``).
    """

    def _extra_init(self, Nb=10.0, Dc=1.0, zero_cutoff=0.01, rng_seed=0):
        self.phys_Nb = Nb
        self.phys_Dc = Dc
        self.zero_cutoff = zero_cutoff
        self._rng_seed = rng_seed

    @property
    def num_fields(self):
        return self.num_populations + 1

    def _finish_constants(self):
        # stochastic_nutrients.py:218-248
        self.dim_Dg = (self.phys_mu_list / self.phys_Nb) / (4.0 * self.D_standard)
        self.lb_Dg = (self.dim_Dg * self.delta_t).astype(np.float32)
        self.dim_D_nutrient = self.phys_Dc / (4.0 * self.D_standard)
        self.lb_D_nutrient = self.dim_D_nutrient * self.delta_t / self.delta_x**2
        self.omega_nutrient = np.float32(
            1.0 / (0.5 + self.lb_D_nutrient / self.lattice.cs2))
        assert self.omega_nutrient < 2.0

    def _init_state(self, rng):
        self._finish_constants()
        P = self.num_populations
        rho = np.zeros((P + 1, self.ny, self.nx), np.float32)
        # well-mixed inoculation over the first 2N rows
        # (stochastic_nutrients.py:368-385: occupied where y < 2N)
        rho[0:P, 0:2 * self.N, :] = self.rho_amp / P
        rho[P] = self.concentration_amp
        f = self._feq(jnp.asarray(rho, self.dtype))
        return (f, jax.random.PRNGKey(self._rng_seed))

    def make_step(self):
        lat = self.lattice
        P = self.num_populations
        w = jnp.asarray(lat.w_np())[:, None, None]
        omega_p = jnp.asarray(self.omega)[None, :, None, None]
        G = jnp.asarray(self.lb_G)[:, None, None]
        Dg = jnp.asarray(self.lb_Dg)[:, None, None]
        om_n = jnp.float32(self.omega_nutrient)
        cutoff = jnp.float32(self.zero_cutoff)

        def step(state):
            f, key = state
            key, sub = jax.random.split(key)
            f = _stream_fields(f, lat)
            # clipped hydro (D2Q9_multifield_diffusion.cl:62-75)
            rho = jnp.sum(f, axis=0)
            rho = jnp.where((rho < cutoff) | jnp.isnan(rho), 0.0, rho)
            feq = self._feq(rho)

            eta = jax.random.normal(sub, (P,) + rho.shape[1:], f.dtype)
            c = rho[P]                               # nutrient
            rho_p = rho[:P]
            growth = G * rho_p * c[None]
            # Milstein update (D2Q9_multifield_diffusion.cl:118-121)
            fluct = (jnp.sqrt(jnp.maximum(Dg * rho_p * c[None], 0.0)) * eta
                     + (Dg * c[None] / 4.0) * (eta * eta - 1.0))
            react_p = growth + fluct                  # [P, ny, nx]
            react_n = -jnp.sum(react_p, axis=0)       # nutrient consumption

            new_p = (f[:, :P] * (1.0 - omega_p) + omega_p * feq[:, :P]
                     + w[:, None] * react_p[None])
            # clip: rho below cutoff, negative, or NaN -> 0 (:137-142)
            bad_p = ((rho_p < cutoff)[None, :] | (new_p < 0)
                     | jnp.isnan(new_p))
            new_p = jnp.where(bad_p, 0.0, new_p)

            new_n = (f[:, P] * (1.0 - om_n) + om_n * feq[:, P]
                     + w * react_n[None])
            bad_n = (c < cutoff)[None] | (new_n < 0) | jnp.isnan(new_n)
            new_n = jnp.where(bad_n, 0.0, new_n)

            f = jnp.concatenate([new_p, new_n[:, None]], axis=1)
            return (f, key)

        return step

    def get_fields(self):
        f, _ = self.state
        return self._fields_dict(f)

    def device_field(self, name):
        if name == "rho":
            return jnp.sum(self.state[0], axis=(0, 1))
        return None
