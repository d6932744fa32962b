"""Diffusion-family acceptance tests: analytic Gaussian spreading, advection
transport, Fisher growth, stochastic noise sanity, mass conservation."""

import numpy as np
import pytest

from lb2d_tpu.models.diffusion import (
    AdvectionDiffusion,
    Diffusion,
    ReactionAdvectionDiffusion,
    ReactionDiffusion,
    ReactionAdvectionDiffusionStochastic,
)


def test_omega_and_scales():
    # diffusion.py:168-185: lb_D = dt/dx^2 = time_prefactor -> omega fixed
    sim = Diffusion(N=20, z=0.1, D=1.0, Lx=0.5, Ly=0.5)
    assert abs(sim.L - 0.1) < 1e-12
    assert abs(sim.T - 0.01) < 1e-12
    assert abs(sim.lb_D - 1.0) < 1e-12
    assert abs(sim.omega - 1.0 / (0.5 + 3.0)) < 1e-12
    assert (sim.nx, sim.ny) == (5 * 20 + 2, 5 * 20 + 2)


def _gaussian_error(N, t_dim=0.05):
    """Max interior error vs the analytic spreading Gaussian
    ``(1/(1+4t)) exp(-r^2/(1+4t))`` (dimensionless diffusion equation, D=1)."""
    sim = Diffusion(N=N, z=0.1, D=1.0, Lx=0.4, Ly=0.4)
    steps = int(round(t_dim / sim.delta_t))
    sim.run(steps)
    t = steps * sim.delta_t

    rho = sim.get_fields()["rho"].T  # [ny, nx]
    X, Y = np.meshgrid(np.arange(sim.nx), np.arange(sim.ny))
    Xd = (X - sim.nx // 2) / sim.N
    Yd = (Y - sim.ny // 2) / sim.N
    s = 1.0 + 4.0 * t
    expected = (1.0 / s) * np.exp(-(Xd**2 + Yd**2) / s)
    b = sim.N // 2  # exclude the boundary band (periodic vs infinite domain)
    return float(np.abs(rho - expected)[b:-b, b:-b].max())


def test_gaussian_spreading_matches_theory():
    """The reference verifies Gaussian spreading by eye in its notebooks;
    here: small absolute error plus resolution convergence."""
    err25 = _gaussian_error(25)
    assert err25 < 0.02, err25
    err50 = _gaussian_error(50)
    assert err50 < err25, (err25, err50)


def test_mass_conserved():
    sim = Diffusion(N=20, z=0.1, D=1.0, Lx=0.3, Ly=0.3)
    m0 = float(sim.get_fields()["rho"].sum())
    sim.run(500)
    m1 = float(sim.get_fields()["rho"].sum())
    assert abs(m1 - m0) < 1e-3 * abs(m0)


def test_advection_moves_blob():
    sim = AdvectionDiffusion(N=25, z=0.1, D=0.005, vx=1.0, vy=0.0, vc=1.0,
                             Lx=0.4, Ly=0.4)
    assert sim.Pe == pytest.approx(0.1 * 1.0 / 0.005)
    steps = 400
    sim.run(steps)
    rho = sim.get_fields()["rho"]  # [nx, ny]
    # circular (wrap-safe) centroid: the initial Gaussian has sigma ~ N/sqrt(2)
    # cells, so its tails wrap the periodic domain
    w = rho.sum(axis=1)
    ang = 2 * np.pi * np.arange(sim.nx) / sim.nx
    cx = (np.angle(np.sum(w * np.exp(1j * ang))) / (2 * np.pi) * sim.nx) % sim.nx
    expected_cx = (sim.nx // 2 + float(sim.u[0, 0]) * steps) % sim.nx
    assert abs(cx - expected_cx) < 1.0, (cx, expected_cx)


def test_fisher_growth_saturates_at_one():
    # characteristic time T = z^2/D = 0.01; pick g so the dimensionless
    # growth rate G_dim = T*g = 2 (growth resolves within a few T)
    sim = ReactionDiffusion(N=20, g=200.0, z=0.1, D=1.0, Lx=0.3, Ly=0.3)
    assert sim.G_dim == pytest.approx(sim.T * 200.0)
    sim.run(int(3.0 / sim.delta_t))  # 3 characteristic times
    rho = sim.get_fields()["rho"]
    assert rho.max() <= 1.01
    assert rho.max() > 0.95  # core saturated at carrying capacity


def test_reaction_advection_fisher_velocity():
    sim = ReactionAdvectionDiffusion(N=20, g=1.0, z=0.1, D=0.1, vx=0.0,
                                     vy=0.0, vc=1.0, Lx=0.3, Ly=0.3)
    assert sim.vf_dim == pytest.approx(2 * np.sqrt(sim.G_dim / sim.Pe))
    sim.run(100)
    assert np.isfinite(sim.get_fields()["rho"]).all()


def test_stochastic_runs_nonnegative():
    sim = ReactionAdvectionDiffusionStochastic(
        N=20, g=1.0, Dg=1e-4, z=0.1, D=1.0, vx=0.0, vy=0.0, vc=1.0,
        Lx=0.3, Ly=0.3)
    sim.run(200)
    f, key = sim.state
    assert np.isfinite(np.asarray(f)).all()
    assert float(np.asarray(f).min()) >= 0.0
    # two different seeds give different trajectories
    sim2 = ReactionAdvectionDiffusionStochastic(
        N=20, g=1.0, Dg=1e-4, z=0.1, D=1.0, vx=0.0, vy=0.0, vc=1.0,
        Lx=0.3, Ly=0.3, rng_seed=123)
    sim2.run(200)
    assert not np.allclose(np.asarray(f), np.asarray(sim2.state[0]))


