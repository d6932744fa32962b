"""Every model class of the zoo runs ``run(n)`` on its XLA step.

One case per class exported by :mod:`lb2d_tpu.models`: built with the
default ``backend="auto"`` (which must resolve to ``"xla"``), run a few
steps at a tiny size, and checked for a finite state and the invariant its
family obeys (mass conservation, growth, consumption, non-negativity, or
the analytic answer).
"""

import numpy as np
import pytest

from lb2d_tpu import models as M

FLOW = dict(diameter=1.5, rho=10.0, viscosity=5.0, pressure_grad=-100.0)
DIFF = dict(Lx=0.3, Ly=0.3, z=0.1, N=10, D=1.0)
MF = dict(Lx=2.05, Ly=2.05, mu_standard=1.0, mu_list=[1.0, 0.8],
          D_standard=1.0, D_list=[1.0, 1.2], N=14)


def _f(model):
    state = model.f if hasattr(model, "f") else model.state
    return np.asarray(state[0] if isinstance(state, tuple) else state,
                      np.float64)


def _mass_steady(before, after):
    np.testing.assert_allclose(after.sum(), before.sum(), rtol=1e-2)


def _mass_exact(before, after):
    np.testing.assert_allclose(after.sum(), before.sum(), rtol=1e-5)


def _grows(before, after):
    assert after.sum() > before.sum()


def _nonnegative(before, after):
    assert after.min() >= 0.0


def _capacity(before, after):
    """Logistic competition: the total density stays near the carrying
    capacity 1 (the stripe fronts overshoot it by a few percent) and the
    no-flux walls keep the mass (``D2Q9_multifield_fisher.cl``)."""
    assert after.sum(axis=(0, 1)).max() <= 1.05
    _mass_steady(before, after)


def _field_sum(index):
    """Total of field ``index`` of a [q, F, ny, nx] state."""
    return lambda f: f[:, index].sum()


def _field_changes(index, sign):
    def check(before, after):
        d = _field_sum(index)(after) - _field_sum(index)(before)
        assert np.sign(d) == sign, d
    return check


def _mass_per_field(before, after):
    np.testing.assert_allclose(after.sum(axis=(0, 2, 3)),
                               before.sum(axis=(0, 2, 3)), rtol=1e-5)


def _runner():
    sim = M.SimulationRunner(nx=32, ny=32, L_lb=32, num_populations=2,
                             porous=False)
    for i in range(2):
        sim.add_fluid(M.Fluid(sim, i, nu_e=1.0 / 6.0))
    sim.complete_setup()
    base = 0.5 + 0.05 * np.random.RandomState(1).rand(32, 32)
    sim.fluid_list[0].initialize(base)
    sim.fluid_list[1].initialize(1.0 - base)
    sim.add_interaction_force(0, 1, G_int=1.5, potential="linear")
    return sim


ZOO = {
    "PipeFlow": (lambda: M.PipeFlow(N=10, pipe_length=3.0, **FLOW),
                 _mass_steady),
    "PipeFlowCylinder": (lambda: M.PipeFlowCylinder(
        N=4, pipe_length=3.0, cylinder_center=(0.75, 0.75),
        cylinder_radius=0.1, **FLOW), _mass_steady),
    "PipeFlowObstacles": (lambda: M.PipeFlowObstacles(
        obstacle_mask=M.disk_mask(21, 11, 6, 5, 2), N=10, pipe_length=3.0,
        **FLOW), _mass_steady),
    "PipeFlowVelocityInlet": (lambda: M.PipeFlowVelocityInlet(
        u_w=0.05, omega=1.2, lx=31, ly=15), _mass_steady),
    "LatticePipeFlow": (lambda: M.LatticePipeFlow(
        omega=1.2, lx=31, ly=15, deltaP=-0.001), _mass_steady),
    "Diffusion": (lambda: M.Diffusion(**DIFF), _mass_exact),
    "AdvectionDiffusion": (lambda: M.AdvectionDiffusion(
        vx=1.0, vy=0.5, vc=1.0, **DIFF), _mass_exact),
    "ReactionDiffusion": (lambda: M.ReactionDiffusion(g=1.0, **DIFF),
                          _grows),
    "ReactionAdvectionDiffusion": (lambda: M.ReactionAdvectionDiffusion(
        g=1.0, vx=1.0, vy=1.0, vc=1.0, **DIFF), _grows),
    "ReactionAdvectionDiffusionStochastic": (
        lambda: M.ReactionAdvectionDiffusionStochastic(
            g=1.0, vx=1.0, vy=1.0, vc=1.0, Dg=0.05, **DIFF), _nonnegative),
    "NoisyAdvectedFisherWave": (lambda: M.NoisyAdvectedFisherWave(
        N=10, z=0.1, Lx=0.3, Ly=0.3, D=1.0, g=10.0, Nc=10.0), _nonnegative),
    "ScreenedFisherWave": (lambda: M.ScreenedFisherWave(
        Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2, N=24), _grows),
    "RepellingFisherWave": (lambda: M.RepellingFisherWave(
        Lx=1.0, Ly=1.0, E=2.0, R0=0.25, N=16, max_inner_iter=20), _grows),
    "FisherExpansion": (lambda: M.FisherExpansion(
        initial_frac_widths=[0.5, 0.5], initial_frac_indices=[0, 1], **MF),
        _capacity),
    "Expansion": (lambda: M.Expansion(Nb=10.0, Dc=1.0, **MF),
                  _field_changes(-1, -1)),
    "SurfactantNutrientWave": (lambda: M.SurfactantNutrientWave(
        Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2, N=24),
        _field_changes(1, -1)),
    "ClumpySurfactantNutrientWave": (lambda: M.ClumpySurfactantNutrientWave(
        Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2, N=24, rho_o=1.0,
        G_chen=-5.0), _field_changes(1, -1)),
    "RocketYeast": (lambda: M.RocketYeast(
        Lx=1.0, Ly=1.0, R0=0.2, epsilon=0.05, Gc=2.0, N=24, G_chen=-0.1),
        _field_changes(1, 1)),
    "RocketYeastForcesOnly": (lambda: M.RocketYeastForcesOnly(
        Lx=1.0, Ly=1.0, R0=0.2, epsilon=0.02, Gc=2.0, N=24, G_chen=-0.05,
        c_o=0.25, alpha=2.0), _field_changes(1, 1)),
    "SimulationRunner": (_runner, _mass_per_field),
}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_model_runs_on_xla(name):
    build, invariant = ZOO[name]
    sim = build()
    assert sim.backend == "xla"
    before = _f(sim)
    sim.run(10)
    after = _f(sim)
    if isinstance(sim, M.SimulationRunner):
        assert sim.backend_used == "xla"
    assert np.isfinite(after).all()
    invariant(before, after)


def test_zoo_poisson_solver_converges():
    """The LBM Poisson solver's nested while_loop: uniform source, converged
    and finite."""
    n = 32
    solver = M.PoissonSolver(nx=n, ny=n, sources=np.ones((n, n)),
                             delta_t=4e-4 * (64 / n) ** 2, delta_x=2.0 / n,
                             tolerance=1e-5)
    solver.run(20000)
    assert solver.converged
    phi = solver.get_fields()["rho"]
    assert np.isfinite(phi).all() and phi.max() > 0


def test_zoo_screened_poisson_constant_charge():
    """A constant charge is its own screened potential (only the k = 0 mode,
    whose multiplier is 1) with zero gradients."""
    sp = M.ScreenedPoisson(np.full((32, 32), 2.0, np.complex64), lam=1.0)
    sp.create_grad_fields()
    sp.solve_and_update_grad_fields()
    sp.inverse_fft()
    np.testing.assert_allclose(np.asarray(sp.charge).real, 2.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(sp.xgrad), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(sp.ygrad), 0.0, atol=1e-5)
