"""Native C++ backend: build, and parity vs the XLA step."""

import numpy as np
import pytest

from lb2d_tpu.models.pipe_flow import PipeFlow
from lb2d_tpu.native import is_available, native_run

pytestmark = pytest.mark.skipif(not is_available(),
                                reason="no C++ toolchain available")

PHYS = dict(diameter=1.0, rho=10.0, viscosity=5.0, pressure_grad=-100.0)


def test_native_matches_xla():
    sim = PipeFlow(N=15, pipe_length=30.5 / 15, backend="xla", **PHYS)
    a = sim.state
    step = sim.make_step()
    for _ in range(10):
        a = step(a)
    b = native_run(sim.state, 10, omega=sim.omega, inlet_rho=sim.inlet_rho,
                   outlet_rho=sim.outlet_rho)
    d = float(np.abs(np.asarray(a) - b).max())
    assert d < 1e-5, d


def test_native_obstacle_matches_xla():
    mask = np.zeros((16, 32), np.int32)
    mask[6:10, 12:18] = 1
    sim = PipeFlow(N=15, pipe_length=30.5 / 15, backend="xla",
                   obstacle_mask=mask, **PHYS)
    a = sim.state
    step = sim.make_step()
    for _ in range(8):
        a = step(a)
    b = native_run(sim.state, 8, omega=sim.omega, inlet_rho=sim.inlet_rho,
                   outlet_rho=sim.outlet_rho, mask=mask)
    d = float(np.abs(np.asarray(a) - b).max())
    assert d < 1e-5, d


def test_native_incompressible_matches_xla():
    sim = PipeFlow(N=15, pipe_length=30.5 / 15, backend="xla",
                   equilibrium="incompressible", **PHYS)
    a = sim.state
    step = sim.make_step()
    for _ in range(6):
        a = step(a)
    b = native_run(sim.state, 6, omega=sim.omega, inlet_rho=sim.inlet_rho,
                   outlet_rho=sim.outlet_rho, incompressible=True)
    d = float(np.abs(np.asarray(a) - b).max())
    assert d < 1e-5, d


def test_native_matches_xla_256():
    """At the 256 x 257 size the C++/OpenMP backend used to be timed on, 50
    steps agree with the XLA step (a wall-clock rate is not a CPU-test
    property: it depends on what else the host runs)."""
    sim = PipeFlow(N=255, pipe_length=255.5 / 255, backend="xla", **PHYS)
    assert (sim.ny, sim.nx) == (256, 257)
    f0 = np.asarray(sim.state)
    a = sim.run(50).state
    b = native_run(f0, 50, omega=sim.omega,
                   inlet_rho=sim.inlet_rho, outlet_rho=sim.outlet_rho)
    d = float(np.abs(np.asarray(a) - b).max())
    assert d < 1e-5, d


def test_native_backend_via_model():
    a = PipeFlow(N=15, pipe_length=30.5 / 15, backend="xla", **PHYS)
    b = PipeFlow(N=15, pipe_length=30.5 / 15, backend="native", **PHYS)
    a.run(20)
    b.run(20, timed=True)
    assert b.steps_taken == 20 and b.last_mlups > 0
    d = float(np.abs(np.asarray(a.state) - np.asarray(b.state)).max())
    assert d < 2e-5, d
