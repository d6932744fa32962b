"""Pipe-flow acceptance tests — the reference's notebook verifications as CI.

1. Poiseuille profile vs analytic theory at fixed dimensionless time
   (``docs/opencl_dimensionless_verification.ipynb`` cells 12-35).
2. Resolution convergence: RMS error decreases with N (cell 35).
3. Streaming+BC equivalence against an independent numpy scatter oracle that
   mimics the reference's two-buffer move (``D2Q9.cl:139-171``).
"""

import numpy as np
import pytest

from lb2d_tpu.core.lattice import D2Q9
from lb2d_tpu.models.pipe_flow import PipeFlow, PipeFlowCylinder

PARAMS = dict(diameter=1.5, rho=10.0, viscosity=5.0, pressure_grad=-100.0,
              pipe_length=3.0)


def poiseuille_rms_error(N, time_to_run=10.0):
    sim = PipeFlow(N=N, time_prefactor=1.0, **PARAMS)
    num_steps = int(time_to_run / sim.units.delta_t)
    sim.run(num_steps)
    fields = sim.get_physical_fields()
    # fields['u'] is [nx, ny]; mean profile across x, vs y position
    mean_u = fields["u"].T.mean(axis=1)  # [ny]
    y = np.arange(mean_u.shape[0]) * sim.units.delta_x * sim.units.L
    D, rho, nu = PARAMS["diameter"], PARAMS["rho"], PARAMS["viscosity"]
    prefactor = (1.0 / (2 * rho * nu)) * PARAMS["pressure_grad"]
    predicted = prefactor * y * (y - D)
    return float(np.sqrt(((mean_u - predicted) ** 2).mean())), float(predicted.max())


def test_poiseuille_matches_theory():
    err, umax = poiseuille_rms_error(N=10)
    # theoretical max velocity is |gradP| D^2 / (8 rho nu) = 0.5625 m/s;
    # at N=10 the discretization error should be a few percent of that.
    assert umax == pytest.approx(0.5625, rel=1e-12)
    assert err < 0.05 * umax, f"RMS error {err} too large vs u_max {umax}"


def test_poiseuille_resolution_convergence():
    err10, _ = poiseuille_rms_error(N=10)
    err30, _ = poiseuille_rms_error(N=30)
    assert err30 < err10, (err10, err30)


def test_steady_state_is_parabolic_everywhere():
    sim = PipeFlow(N=20, **PARAMS)
    sim.run(int(10.0 / sim.units.delta_t))
    f = sim.get_fields()
    # v velocity should be ~0 in the bulk at steady state
    assert np.abs(f["v"][2:-2, 2:-2]).max() < 5e-4
    # u should be x-invariant in the bulk
    u = f["u"][2:-2, 2:-2]
    assert np.abs(u - u.mean(axis=0, keepdims=True)).max() < 5e-4


def _numpy_reference_step(f, sim):
    """Independent oracle: bounds-checked scatter stream into a second buffer
    (keeping stale entries), then the same BC formulas, hydro, feq, collide —
    the reference's exact two-buffer algorithm in plain numpy."""
    q, ny, nx = f.shape
    lat = D2Q9
    streamed = f.copy()  # stale entries persist, as in the reference buffer
    for j in range(q):
        cx, cy = lat.cx[j], lat.cy[j]
        src_y = slice(max(0, -cy), ny - max(0, cy))
        src_x = slice(max(0, -cx), nx - max(0, cx))
        dst_y = slice(max(0, cy), ny + min(0, cy))
        dst_x = slice(max(0, cx), nx + min(0, cx))
        streamed[j, dst_y, dst_x] = f[j, src_y, src_x]
    f = streamed

    inlet_rho, outlet_rho = np.float32(sim.inlet_rho), np.float32(sim.outlet_rho)
    s = f.copy()
    # inlet
    u = -((s[0, 1:-1, 0] + s[2, 1:-1, 0] + 2 * s[3, 1:-1, 0] + s[4, 1:-1, 0]
           + 2 * s[6, 1:-1, 0] + 2 * s[7, 1:-1, 0] - inlet_rho) / inlet_rho)
    f[1, 1:-1, 0] = s[3, 1:-1, 0] + (2 / 3) * inlet_rho * u
    f[5, 1:-1, 0] = (-0.5 * s[2, 1:-1, 0] + 0.5 * s[4, 1:-1, 0]
                     + s[7, 1:-1, 0] + (1 / 6) * u * inlet_rho)
    f[8, 1:-1, 0] = (0.5 * s[2, 1:-1, 0] - 0.5 * s[4, 1:-1, 0]
                     + s[6, 1:-1, 0] + (1 / 6) * u * inlet_rho)
    # outlet
    u = -1 + (s[0, 1:-1, -1] + 2 * s[1, 1:-1, -1] + s[2, 1:-1, -1]
              + s[4, 1:-1, -1] + 2 * s[5, 1:-1, -1] + 2 * s[8, 1:-1, -1]) / outlet_rho
    f[3, 1:-1, -1] = s[1, 1:-1, -1] - (2 / 3) * outlet_rho * u
    f[6, 1:-1, -1] = (-0.5 * s[2, 1:-1, -1] + 0.5 * s[4, 1:-1, -1]
                      + s[8, 1:-1, -1] - (1 / 6) * u * outlet_rho)
    f[7, 1:-1, -1] = (0.5 * s[2, 1:-1, -1] - 0.5 * s[4, 1:-1, -1]
                      + s[5, 1:-1, -1] - (1 / 6) * u * outlet_rho)
    # north / south walls
    f[4, -1, 1:-1] = s[2, -1, 1:-1]
    f[8, -1, 1:-1] = 0.5 * (-s[1, -1, 1:-1] + s[3, -1, 1:-1] + 2 * s[6, -1, 1:-1])
    f[7, -1, 1:-1] = 0.5 * (s[1, -1, 1:-1] - s[3, -1, 1:-1] + 2 * s[5, -1, 1:-1])
    f[2, 0, 1:-1] = s[4, 0, 1:-1]
    f[6, 0, 1:-1] = 0.5 * (s[1, 0, 1:-1] - s[3, 0, 1:-1] + 2 * s[8, 0, 1:-1])
    f[5, 0, 1:-1] = 0.5 * (-s[1, 0, 1:-1] + s[3, 0, 1:-1] + 2 * s[7, 0, 1:-1])
    # corners
    c = s[:, 0, 0]
    f[1, 0, 0] = c[3]; f[2, 0, 0] = c[4]; f[5, 0, 0] = c[7]
    f[6, 0, 0] = f[8, 0, 0] = 0.5 * (-c[0] - 2 * c[3] - 2 * c[4] - 2 * c[7] + inlet_rho)
    c = s[:, -1, 0]
    f[1, -1, 0] = c[3]; f[4, -1, 0] = c[2]; f[8, -1, 0] = c[6]
    f[5, -1, 0] = f[7, -1, 0] = 0.5 * (-c[0] - 2 * c[2] - 2 * c[3] - 2 * c[6] + inlet_rho)
    c = s[:, 0, -1]
    f[3, 0, -1] = c[1]; f[2, 0, -1] = c[4]; f[6, 0, -1] = c[8]
    f[5, 0, -1] = f[7, 0, -1] = 0.5 * (-c[0] - 2 * c[1] - 2 * c[4] - 2 * c[8] + outlet_rho)
    c = s[:, -1, -1]
    f[3, -1, -1] = c[1]; f[4, -1, -1] = c[2]; f[7, -1, -1] = c[5]
    f[6, -1, -1] = f[8, -1, -1] = 0.5 * (-c[0] - 2 * c[1] - 2 * c[2] - 2 * c[5] + outlet_rho)

    # hydro / feq / collide
    rho = f.sum(axis=0)
    cx = np.array(lat.cx, dtype=f.dtype)[:, None, None]
    cy = np.array(lat.cy, dtype=f.dtype)[:, None, None]
    u = (cx * f).sum(axis=0) / rho
    v = (cy * f).sum(axis=0) / rho
    w = np.array(lat.w, dtype=f.dtype)[:, None, None]
    cs2 = np.float32(lat.cs2)
    cu = cx * u + cy * v
    feq = w * rho * (1 + cu / cs2 + cu * cu / (2 * cs2 * cs2) - (u * u + v * v) / (2 * cs2))
    omega = np.float32(sim.omega)
    return f * (1 - omega) + omega * feq


def test_step_matches_numpy_oracle():
    """One fused JAX step == the reference algorithm (two-buffer scatter
    stream + snapshot BC kernel) run in float64 numpy, to tight tolerance."""
    sim = PipeFlow(N=12, **PARAMS)
    f0 = np.asarray(sim.state, dtype=np.float64)
    expect = f0
    for _ in range(5):
        expect = _numpy_reference_step(expect, sim)

    sim.run(5)
    got = np.asarray(sim.state, dtype=np.float64)
    # fp32 step vs fp64 oracle: tolerance set by accumulated rounding.
    np.testing.assert_allclose(got, expect, rtol=2e-5, atol=2e-6)


def test_cylinder_runs_and_sheds_mass_sanely():
    sim = PipeFlowCylinder(
        cylinder_center=(0.75, 0.75), cylinder_radius=0.1,
        diameter=1.5, rho=10.0, viscosity=5.0, pressure_grad=-100.0,
        pipe_length=3.0, N=8,
    )
    rho_before = sim.get_fields()["rho"].mean()
    sim.run(200)
    fields = sim.get_fields()
    assert np.isfinite(fields["rho"]).all()
    assert abs(fields["rho"].mean() - rho_before) < 0.1
    # obstacle exists and covers the expected disk area
    mask = np.asarray(sim.obstacle_mask)
    assert mask.sum() > 0.9 * np.pi * sim.units.N**2


def test_lattice_units_api():
    """OLD-module lattice-units constructor (OLD/python.py:24-64)."""
    from lb2d_tpu.models.lattice_units import LatticePipeFlow

    sim = LatticePipeFlow(omega=0.99, lx=31, ly=15, deltaP=-0.001)
    assert (sim.nx, sim.ny) == (32, 16)
    assert sim.outlet_rho == pytest.approx(1.0 - 0.001 * 3.0)
    sim.run(300)
    fields = sim.get_fields()
    assert np.isfinite(fields["u"]).all()
    # pressure-driven flow develops in +x
    assert fields["u"][2:-2, 2:-2].mean() > 0
    visc, Re, Ma = sim.update_dimensionless_nums()
    assert visc == pytest.approx((1.0 / 3.0) * (0.99 - 0.5))
    assert Re > 0 and Ma > 0
    with pytest.raises(NotImplementedError):
        sim.get_nondim_fields()


class TestVelocityInlet:
    """PipeFlowVelocityInlet (OLD/opencl.py:281-375) with the stability
    fixes of DIVERGENCES.md #20-21."""

    def test_plug_flow_is_steady(self):
        from lb2d_tpu.models import PipeFlowVelocityInlet

        sim = PipeFlowVelocityInlet(u_w=0.05, omega=1.2, lx=31, ly=15)
        sim.run(500)
        fl = sim.get_fields()
        assert np.abs(fl["u"] - 0.05).max() < 1e-5
        assert np.abs(fl["v"]).max() < 1e-6
        assert np.abs(fl["rho"] - 1.0).max() < 1e-5

    def test_perturbation_decays(self):
        import jax.numpy as jnp

        from lb2d_tpu.models import PipeFlowVelocityInlet

        rng = np.random.RandomState(0)
        sim = PipeFlowVelocityInlet(u_w=0.05, omega=1.2, lx=31, ly=15)
        sim.state = sim.state * jnp.asarray(
            1 + 0.01 * rng.randn(*sim.state.shape), sim.dtype)
        sim.run(1500)
        fl = sim.get_fields()
        assert np.isfinite(fl["f"]).all()
        assert np.abs(fl["u"] - 0.05).max() < 1e-4

    def test_obstacle_wake(self):
        from lb2d_tpu.models import PipeFlowVelocityInlet

        mask = np.zeros((16, 32), bool)
        mask[6:10, 12:16] = True
        sim = PipeFlowVelocityInlet(u_w=0.05, omega=1.2, lx=31, ly=15,
                                    obstacle_mask=mask)
        sim.run(800)
        fl = sim.get_fields()
        assert np.isfinite(fl["f"]).all()
        assert np.abs(fl["v"]).max() > 1e-3     # flow deflects around it

    def test_reference_velocity_pair_available(self):
        from lb2d_tpu.models import PipeFlowVelocityInlet

        sim = PipeFlowVelocityInlet(u_w=0.05, omega=1.2, lx=31, ly=15,
                                    outlet="velocity")
        sim.run(20)  # short horizon: the reference pair is unstable (#21)
        assert np.isfinite(sim.get_fields()["f"]).all()

