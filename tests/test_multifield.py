"""Multifield range-expansion tests: competition dynamics, no-flux mass
conservation, nutrient consumption, Milstein noise sanity."""

import numpy as np
import pytest

from lb2d_tpu.models.multifield import Expansion, FisherExpansion


def _fisher(**over):
    kw = dict(Lx=4.0, Ly=4.0, mu_standard=1.0, mu_list=[1.0, 1.0],
              D_standard=1.0, D_list=[1.0, 1.0], N=10,
              initial_frac_widths=[0.5, 0.5], initial_frac_indices=[0, 1])
    kw.update(over)
    return FisherExpansion(**kw)


def test_fisher_expansion_scales():
    sim = _fisher()
    assert sim.L == pytest.approx(2.0)
    assert sim.T == pytest.approx(1.0)
    assert sim.num_populations == 2
    # lb scales
    assert sim.lb_G == pytest.approx([sim.delta_t] * 2)
    np.testing.assert_allclose(
        sim.omega, 1.0 / (0.5 + (0.25 * sim.delta_t / sim.delta_x**2) / (1 / 3)))


def test_fisher_expansion_stripes_and_growth():
    sim = _fisher()
    rho0 = sim.get_fields()["rho"]  # [nx, ny, P]
    # stripes: population 0 occupies left half in x, both only y < 2N
    assert rho0[2, 5, 0] == pytest.approx(1.0, abs=1e-5)
    assert rho0[2, 5, 1] == pytest.approx(0.0, abs=1e-5)
    assert rho0[-3, 5, 1] == pytest.approx(1.0, abs=1e-5)
    assert rho0[2, 2 * sim.N + 1, 0] == pytest.approx(0.0, abs=1e-5)

    sim.run(300)
    rho = sim.get_fields()["rho"]
    assert np.isfinite(rho).all()
    # fronts advance: occupied fraction grows, total bounded by capacity
    assert rho.sum() > rho0.sum()
    assert rho.sum(axis=2).max() < 1.05  # logistic cap on rho_tot


def test_fisher_noflux_walls_conserve_without_growth():
    """The reference's copy-style bounce-back BC admits a small transient
    mass adjustment from discontinuous initial data; after it settles, mass
    must be conserved to high precision (no steady leak through the walls)."""
    sim = _fisher(mu_list=[0.0, 0.0])  # no growth -> pure diffusion, walls
    sim.run(200)
    m0 = float(sim.get_fields()["rho"].sum())
    sim.run(400)
    m1 = float(sim.get_fields()["rho"].sum())
    assert abs(m1 - m0) < 2e-4 * m0, (m0, m1)


def _expansion(**over):
    kw = dict(Lx=4.0, Ly=4.0, mu_standard=1.0, mu_list=[1.0, 1.0],
              D_standard=1.0, D_list=[1.0, 1.0], N=10, Nb=1e8, Dc=1.0)
    kw.update(over)
    return Expansion(**kw)


def test_expansion_nutrient_consumed():
    sim = _expansion()
    rho0 = sim.get_fields()["rho"]
    P = sim.num_populations
    nutrient0 = rho0[:, :, P].sum()
    pop0 = rho0[:, :, :P].sum()
    sim.run(500)
    rho = sim.get_fields()["rho"]
    assert np.isfinite(rho).all()
    assert rho[:, :, P].sum() < nutrient0          # nutrient eaten
    assert rho[:, :, :P].sum() > pop0              # populations grew
    # total mass (populations + nutrient) conserved by the reaction
    tot0 = nutrient0 + pop0
    tot1 = rho.sum()
    assert abs(tot1 - tot0) < 2e-2 * tot0


def test_expansion_noise_branches():
    a = _expansion(Nb=10.0, rng_seed=1)
    b = _expansion(Nb=10.0, rng_seed=2)
    a.run(100)
    b.run(100)
    fa, fb = np.asarray(a.state[0]), np.asarray(b.state[0])
    assert np.isfinite(fa).all() and (fa >= 0).all()
    assert not np.allclose(fa, fb)


