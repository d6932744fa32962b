"""Coupled Fisher-wave models.

* :class:`NoisyAdvectedFisherWave` — ``reaction_diffusion/noisy_fisher_wave.py``
  (``Noisy_Advected_Fisher_Wave``): advected Fisher wave with multiplicative
  demographic noise ``sqrt(Dg rho (1-rho)) eta`` and negativity clipping
  (kernel ``collide_particles_noisy_fisher``, ``D2Q9_diffusion.cl:126-167``),
  fresh Philox normals per step (``noisy_fisher_wave.py:412-430`` ->
  ``jax.random`` key splits).
* :class:`ScreenedFisherWave` — ``reaction_diffusion/screened_poisson_waves.py``
  (``Screened_Fisher_Wave``): all-dimensionless Fisher wave whose advection
  velocity is the negative gradient of a screened-Poisson potential of its
  own density, re-solved spectrally **every step**
  (``screened_poisson_waves.py:337-361``). The reference round-trips
  LBM kernels and gpyfft plans through one command queue; here the spectral
  solve (``jnp.fft``; the matmul DFT on a multi-device mesh) is part of the
  same jitted step.
* :class:`RepellingFisherWave` — ``reaction_diffusion/repelling_fisher_waves_old.py``
  (``Repelling_Fisher_Wave``): like the screened wave but the potential comes
  from the *LBM* Poisson solver run to convergence inside each outer step
  (``repelling_fisher_waves_old.py:380-392``) — a nested on-device
  ``while_loop`` per step here.
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
from ..ops.dft import fft2_mm, ifft2_mm, screened_gradients_mm
from .base import LBModel
from .spectral import _freqs, spectral_method

__all__ = [
    "NoisyAdvectedFisherWave",
    "ScreenedFisherWave",
    "RepellingFisherWave",
]


class NoisyAdvectedFisherWave(LBModel):
    """Stochastic Fisher wave in a uniform imposed flow
    (``noisy_fisher_wave.py:54-480``). Scaling: L = z, T = z^2/D,
    ``Pe = z vc / D``, ``Gd_lb = (g z^2/D) dt``, ``Dg_lb = (z/(Nc D)) dt/dx``
    (``noisy_fisher_wave.py:188-207``). State: ``(f, key)``.
    """

    def __init__(self, Lx=1.0, Ly=1.0, D=1.0, z=0.1, vx=0.0, vy=0.0, vc=0.0,
                 g=1.0, Nc=10.0, time_prefactor=1.0, N=50, seed=0,
                 rng_seed=0, dtype=jnp.float32):
        self.phys_Lx, self.phys_Ly = Lx, Ly
        self.phys_D, self.phys_z = D, z
        self.phys_vx, self.phys_vy, self.phys_vc = vx, vy, vc
        self.phys_g, self.phys_Nc = g, Nc
        self.N = N
        self.lattice = D2Q9
        self.dtype = dtype

        self.L = z
        self.T = z**2 / D
        self.delta_x = 1.0 / N
        self.delta_t = time_prefactor * self.delta_x**2
        self.ulb = self.delta_t / self.delta_x

        # noisy_fisher_wave.py:188-207
        self.Pe = z * vc / D
        self.dim_Gd = g * z**2 / D
        self.lb_Gd = np.float32(self.dim_Gd * self.delta_t)
        self.Dg = (1.0 / Nc) * (z / D)
        self.lb_Dg = np.float32(self.Dg * self.delta_t / self.delta_x)
        self.lb_D = self.delta_t / self.delta_x**2
        self.omega = np.float32(1.0 / (0.5 + self.lb_D / self.lattice.cs2))
        assert self.omega < 2.0

        self.lx = N * int(Lx / self.L)
        self.ly = N * int(Ly / self.L)
        self.nx, self.ny = self.lx + 2, self.ly + 2

        if vc != 0:
            dim_vx, dim_vy = self.Pe * vx / vc, self.Pe * vy / vc
        else:
            dim_vx = dim_vy = 0.0
        self.u = jnp.asarray(np.float32(self.ulb * dim_vx))[None, None]
        self.v = jnp.asarray(np.float32(self.ulb * dim_vy))[None, None]

        rng = np.random.RandomState(seed)
        X, Y = np.meshgrid(np.arange(self.nx), np.arange(self.ny))
        Xd = (X - self.nx // 2) / N
        Yd = (Y - self.ny // 2) / N
        rho0 = jnp.asarray(np.exp(-(Xd**2 + Yd**2)), dtype)
        feq0 = feq_linear(rho0, self.u, self.v)
        perturb = 1.0 + 0.001 * rng.randn(9, self.ny, self.nx)
        self.state = (feq0 * jnp.asarray(perturb, dtype),
                      jax.random.PRNGKey(rng_seed))
        super().__init__()

    @property
    def num_cells(self):
        return self.nx * self.ny

    def make_step(self):
        u, v = self.u, self.v
        lat = self.lattice
        omega = jnp.asarray(self.omega, self.dtype)
        w = jnp.asarray(lat.w_np())[:, None, None]
        G = jnp.asarray(self.lb_Gd, self.dtype)
        Dg = jnp.asarray(self.lb_Dg, self.dtype)

        def step(state):
            f, key = state
            key, sub = jax.random.split(key)
            f = stream(f, lat)
            rho = density(f)
            feq = feq_linear(rho, u, v, lat)
            eta = jax.random.normal(sub, rho.shape, self.dtype)
            react = (G * rho * (1.0 - rho)
                     + jnp.sqrt(jnp.maximum(Dg * rho * (1.0 - rho), 0.0)) * eta)
            f = bgk(f, feq, omega) + w * react
            return (jnp.maximum(f, 0.0), key)  # D2Q9_diffusion.cl:163

        return step

    def get_fields(self):
        f, _ = self.state
        rho = density(f)
        feq = feq_linear(rho, self.u, self.v)
        return {
            "f": self._to_host_xy(f),
            "feq": self._to_host_xy(feq),
            "rho": self._to_host_xy(rho),
            "u": np.broadcast_to(np.asarray(self.u), (self.nx, self.ny)),
            "v": np.broadcast_to(np.asarray(self.v), (self.nx, self.ny)),
        }

    def device_field(self, name):
        if name == "rho":
            return density(self.state[0])
        return None


class _ScreenedVelocity:
    """Per-step screened-Poisson velocity: ``(u, v) = -vc (dt/dx) grad
    screen(rho)`` with the reference's frequency conventions
    (``screened_poisson_waves.py:337-361``; axis note: xgrad varies along the
    reference's x-axis = our lane axis)."""

    def __init__(self, ny, nx, lam, delta_x, vc, ulb, method="auto"):
        # keep only 1-D frequency vectors as constants; the 2-D rescale /
        # gradient-multiplier fields are built in-graph per call (at 8192^2
        # each would be a 268 MB baked-in executable constant otherwise)
        fx, fy = _freqs(ny, nx, delta_x)
        self._fx = jnp.asarray(fx.astype(np.float32))
        self._fy = jnp.asarray(fy.astype(np.float32))
        # Gradient multipliers must be *odd* sequences for the packed
        # one-transform trick below to be exact: at the Nyquist bin
        # (k = n/2, even n) fftfreq holds an unpaired -n/2 entry, which
        # breaks Hermitian symmetry of A and B and leaks the other axis's
        # Nyquist component into each gradient as a checkerboard. Standard
        # spectral-derivative convention: zero the Nyquist mode (the
        # screening `rescale` keeps it — only the derivative is odd).
        gx = fx.astype(np.float32).copy()
        gy = fy.astype(np.float32).copy()
        if nx % 2 == 0:
            gx[nx // 2] = 0.0
        if ny % 2 == 0:
            gy[ny // 2] = 0.0
        self._gx = jnp.asarray(gx)
        self._gy = jnp.asarray(gy)
        self._lam2 = np.float32(lam * lam)
        self.scale = np.float32(-vc * ulb)
        self.method = spectral_method(method)
        self._explicit_method = method != "auto"

    def _fields(self):
        KX = self._fx[None, :]
        KY = self._fy[:, None]
        rescale = 1.0 / (self._lam2 * (KX * KX + KY * KY) + 1.0)
        ax = (2.0 * np.pi) * self._gx[None, :]
        ay = (2.0 * np.pi) * self._gy[:, None]
        return rescale, ax, ay

    def __call__(self, rho):
        # Both gradient spectra are Hermitian (real rho x odd-real
        # multiplier), so ONE complex inverse transform carries both:
        # ifft(A + iB) = xg + i yg exactly. 2 transforms per solve, not 3.
        if self.method == "matmul" and self._fy.shape[0] % 2 == 0:
            # fused real-input half-spectrum solve (see
            # lb2d_tpu/ops/dft.py module comment)
            xg, yg = screened_gradients_mm(
                rho, self._fx, self._fy, self._gx, self._gy, self._lam2)
            return self.scale * xg, self.scale * yg
        rescale, ax, ay = self._fields()
        if self.method == "fft":
            chat = jnp.fft.fft2(rho.astype(jnp.complex64)) * rescale
            g = jnp.fft.ifft2(chat * (1j * ax) + 1j * (chat * (1j * ay)))
            xg, yg = jnp.real(g), jnp.imag(g)
        else:
            cr, ci = fft2_mm(rho)
            cr, ci = cr * rescale, ci * rescale
            # A = (-ax ci, ax cr), B = (-ay ci, ay cr); C = A + iB
            xg, yg = ifft2_mm(-ax * ci - ay * cr, ax * cr - ay * ci)
        return self.scale * xg, self.scale * yg


class ScreenedFisherWave(LBModel):
    """Self-repelling Fisher wave (``screened_poisson_waves.py:55-448``):
    dimensionless units (L = T = 1), D = 1/4, G = 1; each step re-solves the
    screened Poisson equation for the advection field. Includes the optional
    Mach watchdog (``check_max_ulb``, ``:347-351``) and
    :meth:`redo_initial_condition` (``:275-282``)."""

    def __init__(self, Lx=1.0, Ly=1.0, vc=1.0, lam=1.0, R0=5.0,
                 time_prefactor=1.0, N=50, seed=0, check_max_ulb=False,
                 mach_tolerance=0.1, dtype=jnp.float32, method="auto"):
        self.Lx, self.Ly = Lx, Ly
        self.D, self.G = 1.0 / 4.0, 1.0
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
        self.lb_D = np.float32(self.D * self.delta_t / self.delta_x**2)
        self.omega = np.float32(1.0 / (0.5 + self.lb_D / self.lattice.cs2))
        assert self.omega < 2.0
        self.lb_G = np.float32(self.G * self.delta_t)

        # grid: round(N*L), no boundary ring (screened_poisson_waves.py:139-141)
        self.nx = int(np.round(N * Lx))
        self.ny = int(np.round(N * Ly))

        self._velocity = _ScreenedVelocity(self.ny, self.nx, lam,
                                           self.delta_x, vc, self.ulb,
                                           method)

        X, Y = np.meshgrid(np.arange(self.nx), np.arange(self.ny))
        Xd = (X - self.nx // 2) / N
        Yd = (Y - self.ny // 2) / N
        rho0 = jnp.asarray(np.exp(-(Xd**2 + Yd**2) / R0**2), dtype)
        self.state = self._state_from_rho(rho0)
        super().__init__()

    def _state_from_rho(self, rho):
        u, v = self._velocity(rho)
        return feq_linear(rho, u, v, self.lattice)  # init_pop amplitude=0

    def redo_initial_condition(self, rho_field):
        """Re-seed from a user density (``screened_poisson_waves.py:275-282``);
        ``rho_field`` indexed [ny, nx] (or [nx, ny] with ``xy=True``-style
        transpose done by the caller)."""
        self.state = self._state_from_rho(
            jnp.asarray(rho_field, self.dtype))
        return self

    @property
    def num_cells(self):
        return self.nx * self.ny

    def make_step(self):
        lat = self.lattice
        omega = jnp.asarray(self.omega, self.dtype)
        w = jnp.asarray(lat.w_np())[:, None, None]
        G = jnp.asarray(self.lb_G, self.dtype)
        velocity = self._velocity

        def step(f):
            f = stream(f, lat)
            rho = density(f)
            u, v = velocity(rho)
            feq = feq_linear(rho, u, v, lat)
            react = G * rho * (1.0 - rho)
            return bgk(f, feq, omega) + w * react

        return step

    def mach_number(self) -> float:
        from ..utils.metrics import mach_number

        rho = density(self.state)
        u, v = self._velocity(rho)
        return mach_number(u, v, self.lattice)

    def device_field(self, name):
        if name == "rho":
            return density(self.state)
        return None

    def get_fields(self):
        f = self.state
        rho = density(f)
        u, v = self._velocity(rho)
        feq = feq_linear(rho, u, v)
        return {
            "f": self._to_host_xy(f),
            "feq": self._to_host_xy(feq),
            "rho": self._to_host_xy(rho),
            "u": self._to_host_xy(u),
            "v": self._to_host_xy(v),
        }


class RepellingFisherWave(LBModel):
    """Fisher wave repelled by its own LBM-Poisson potential
    (``repelling_fisher_waves_old.py:55-477``): per outer step, the Poisson
    solver re-solves with source rho (to ``max_inner_iter`` or convergence)
    and the advection velocity is ``E (dt/dx) * (solver.u, solver.v)``
    (``:380-392``). The inner solve runs as a nested on-device while_loop.
    """

    def __init__(self, Lx=1.0, Ly=1.0, vc=1.0, E=1.0, R0=5.0,
                 time_prefactor=1.0, N=50, max_inner_iter=200,
                 inner_tolerance=1e-5, seed=0, dtype=jnp.float32,
                 reuse_tolerance=0.0, inner_per_step=None):
        from .poisson import PoissonSolver  # shared tile math

        self.D, self.G = 1.0 / 4.0, 1.0
        self.E = E
        self.R0 = R0
        self.N = N
        self.lattice = D2Q9
        self.dtype = dtype
        self.max_inner_iter = max_inner_iter
        # reuse_tolerance > 0 amortizes the nested solve: the converged
        # potential is reused while mean|rho - rho_at_last_solve| stays
        # below reuse_tolerance * mean(rho). The potential responds to the
        # *accumulated* density change (the wave moves ~ulb cells/step, so
        # small per-step drift), making this a controlled approximation of
        # the reference's solve-every-step loop
        # (repelling_fisher_waves_old.py:380-392). 0 = exact (re-solve
        # every outer step).
        self.reuse_tolerance = float(reuse_tolerance)
        # inner_per_step = k > 0 switches to TRACKING mode: the potential
        # is converged ONCE at init (to inner_tolerance, warm-startable),
        # then every outer step runs exactly k inner Poisson iterations —
        # no while_loop, no convergence reductions, gradient refreshed
        # every step. The potential relaxes toward the instantaneous
        # source much faster than the wave moves (the source drifts
        # O(u_lb) cells/step), so a small fixed budget keeps it converged;
        # the drift vs the exact nested solve is bounded by
        # test_repelling_fisher_tracking_mode (1.4e-6 relative over 300
        # steps at N=128, ~6x the exact mode's throughput). Mutually
        # exclusive with reuse_tolerance.
        #
        # Tracking is deliberately NOT the default (round-5 decision):
        # the exact mode's correctness is grid-size-independent
        # (reference semantics: re-solve to tolerance every step,
        # repelling_fisher_waves_old.py:380-392), while tracking's
        # quasi-static lag grows with resolution — the diffusive inner
        # iteration contracts the lowest mode at O(1/N^2) per sweep but
        # the per-step source motion only shrinks as O(1/N), so the lag
        # scales ~O(N / k) and the N=128 drift bound does not transfer
        # to production grids. Opt in with inner_per_step >= 1 where the
        # bound has been validated for your (N, k), or raise k with N.
        self.inner_per_step = None if inner_per_step is None else int(
            inner_per_step)
        if self.inner_per_step is not None:
            assert self.inner_per_step >= 1
            assert reuse_tolerance == 0.0, (
                "inner_per_step (tracking) and reuse_tolerance (gated) are "
                "mutually exclusive amortization modes")

        self.delta_x = 1.0 / N
        self.delta_t = time_prefactor * self.delta_x**2
        self.ulb = self.delta_t / self.delta_x
        self.lb_D = np.float32(self.D * self.delta_t / self.delta_x**2)
        self.omega = np.float32(1.0 / (0.5 + self.lb_D / self.lattice.cs2))
        self.lb_G = np.float32(self.G * self.delta_t)

        self.nx = int(np.round(N * Lx))
        self.ny = int(np.round(N * Ly))

        X, Y = np.meshgrid(np.arange(self.nx), np.arange(self.ny))
        Xd = (X - self.nx // 2) / N
        Yd = (Y - self.ny // 2) / N
        rho0 = jnp.asarray(np.exp(-(Xd**2 + Yd**2) / R0**2), dtype)

        self.poisson = PoissonSolver(
            nx=self.nx, ny=self.ny, sources=np.asarray(rho0),
            delta_t=self.delta_t, delta_x=self.delta_x,
            tolerance=inner_tolerance, dtype=dtype)

        # state: (wave populations, poisson populations, raw gradient u, v).
        # Carrying the raw (unscaled) gradient reproduces the reference's
        # keep-previous-on-non-convergence behavior without its in-place
        # rescale-compounding bug (repelling_fisher_waves_old.py:384-391
        # multiplies the solver's aliased buffer by E*dt/dx each call).
        zero = jnp.zeros((self.ny, self.nx), dtype)
        if self.inner_per_step is not None:
            # tracking mode: converge the potential for the initial density
            # once (the always-warm start), so the per-step fixed budget
            # only has to follow the wave, never to build the potential
            # from scratch
            self.poisson.run(max_inner_iter)
            # gradient computed unconditionally (run() only refreshes it on
            # convergence, and the pass-through u/v can alias one buffer,
            # which breaks donation of the state tuple)
            from .poisson import negative_gradient as _neg_grad
            pf0 = self.poisson.f
            pu0, pv0 = _neg_grad(self.poisson.rho, self.delta_x)
        else:
            # distinct zero buffers: the state tuple is donated leaf-wise,
            # so no two leaves may alias one buffer
            pf0 = self.poisson.f
            pu0 = jnp.zeros((self.ny, self.nx), dtype)
            pv0 = jnp.zeros((self.ny, self.nx), dtype)
        # 5th member: density at the last inner solve (drives the
        # reuse-tolerance test; carried even at tolerance 0 so the state
        # structure is uniform)
        self.state = (feq_linear(rho0, zero, zero, self.lattice),
                      pf0,
                      jnp.asarray(pu0, dtype),
                      jnp.asarray(pv0, dtype),
                      jnp.full((self.ny, self.nx), -1.0, dtype))
        super().__init__()

    @property
    def num_cells(self):
        return self.nx * self.ny

    def make_step(self):
        from ..ops.moments import rho_poisson
        from .poisson import _make_poisson_iter, _poisson_run, \
            negative_gradient

        lat = self.lattice
        omega = jnp.asarray(self.omega, self.dtype)
        w = jnp.asarray(lat.w_np())[:, None, None]
        G = jnp.asarray(self.lb_G, self.dtype)
        consts = self.poisson._consts()
        source_scale = jnp.float32(self.poisson.lb_D * self.poisson.delta_t)
        max_iter = self.max_inner_iter
        scale = jnp.asarray(self.E * self.ulb, self.dtype)

        reuse_tol = jnp.asarray(self.reuse_tolerance, self.dtype)
        use_reuse = self.reuse_tolerance > 0.0

        if self.inner_per_step is not None:
            # TRACKING mode: k fixed inner iterations per outer step, no
            # while_loop / convergence reductions / cond — the whole outer
            # step is straight-line code XLA can fuse and pipeline. The
            # second source-scaling stage matches _poisson_run (the
            # reference's double scaling, DIVERGENCES #8).
            piter = _make_poisson_iter(consts)
            react_scale = source_scale * jnp.float32(
                consts["delta_t"]) * jnp.float32(consts["lb_D"])
            k_inner = self.inner_per_step
            dx = jnp.float32(consts["delta_x"])

            def step(state):
                f, pf, pu, pv, rho_ref = state
                f = stream(f, lat)
                rho = density(f)
                react = rho * react_scale
                for _ in range(k_inner):  # small static budget: unroll
                    pf, prho = piter(pf, react)
                pu, pv = negative_gradient(prho, dx)
                u, v = scale * pu, scale * pv
                feq = feq_linear(rho, u, v, lat)
                growth = G * rho * (1.0 - rho)
                f = bgk(f, feq, omega) + w * growth
                return (f, pf, pu, pv, rho)

            return step

        def solve(rho, pf, pu, pv):
            # nested Poisson solve with source rho, warm-started from the
            # previous potential (solver.py update_source keeps rho)
            prho = rho_poisson(pf, lat)
            pf, _, pu, pv, _, _ = _poisson_run(
                consts, pf, prho, pu, pv, rho * source_scale,
                jnp.int32(0), jnp.int32(max_iter))
            return pf, pu, pv

        def step(state):
            f, pf, pu, pv, rho_ref = state
            f = stream(f, lat)
            rho = density(f)
            if use_reuse:
                # amortized nested solve: reuse the converged potential
                # while the density has drifted less than reuse_tolerance
                # (relative mean |drho|) since the last solve
                drift = jnp.mean(jnp.abs(rho - rho_ref))
                need = drift > reuse_tol * jnp.mean(rho)
                pf, pu, pv, rho_ref = jax.lax.cond(
                    need,
                    lambda args: (*solve(args[4], args[0], args[1], args[2]),
                                  args[4]),
                    lambda args: args[:4],
                    (pf, pu, pv, rho_ref, rho))
            else:
                pf, pu, pv = solve(rho, pf, pu, pv)
                rho_ref = rho
            u, v = scale * pu, scale * pv
            feq = feq_linear(rho, u, v, lat)
            react = G * rho * (1.0 - rho)
            f = bgk(f, feq, omega) + w * react
            return (f, pf, pu, pv, rho_ref)

        return step

    def get_fields(self):
        f, pf, pu, pv, _ = self.state
        rho = density(f)
        scale = float(self.E * self.ulb)
        return {
            "f": self._to_host_xy(f),
            "rho": self._to_host_xy(rho),
            "u": self._to_host_xy(scale * pu),
            "v": self._to_host_xy(scale * pv),
        }
