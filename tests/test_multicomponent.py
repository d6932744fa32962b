"""Multicomponent/porous engine tests: Darcy balance, Shan-Chen separation,
conservation, eating/growth hooks, D2Q25, zero-gradient BCs."""

import jax.numpy as jnp
import numpy as np
import pytest

from lb2d_tpu.core.lattice import D2Q25
from lb2d_tpu.models.multicomponent import (
    Fluid,
    SECOND_BELT_STENCIL,
    SimulationRunner,
)


def _runner(C=1, porous=True, lattice=None, nx=32, ny=32):
    kw = dict(nx=nx, ny=ny, L_lb=nx, T_lb=1.0, num_populations=C,
              porous=porous)
    if lattice is not None:
        kw["lattice"] = lattice
    return SimulationRunner(**kw)


def test_second_belt_stencil_props():
    # 8 first-belt + 16 second-belt vectors (single_component.py:533-646)
    assert len(SECOND_BELT_STENCIL) == 24
    # isotropy: sum w c = 0
    sx = sum(w * c[0] for w, c in SECOND_BELT_STENCIL)
    sy = sum(w * c[1] for w, c in SECOND_BELT_STENCIL)
    assert abs(sx) < 1e-14 and abs(sy) < 1e-14


def test_porous_darcy_balance():
    """Constant body force balanced by Darcy drag: steady u = g K / nu_f
    for small velocity (single_component.cl:317-325)."""
    sim = _runner(C=1, porous=True)
    fl = Fluid(sim, 0, nu_e=0.5, epsilon=0.8, nu_fluid=0.4, K=2.0, Fe=0.0)
    sim.add_fluid(fl)
    sim.complete_setup()
    fl.initialize(np.ones((sim.ny, sim.nx)))
    g = 1e-5
    sim.add_constant_body_force(0, g, 0.0)
    sim.run(3000)
    u = sim.get_fields()["u_bary"]
    expected = g * 2.0 / 0.4
    assert np.allclose(u, expected, rtol=0.05), (u.mean(), expected)


def test_mass_conservation_periodic():
    sim = _runner(C=2, porous=False)
    for i in range(2):
        sim.add_fluid(Fluid(sim, i, nu_e=0.4, epsilon=1.0))
    sim.complete_setup()
    rng = np.random.RandomState(0)
    sim.fluid_list[0].initialize(1.0 + 0.1 * rng.rand(sim.ny, sim.nx))
    sim.fluid_list[1].initialize(1.0 + 0.1 * rng.rand(sim.ny, sim.nx))
    m0 = [float(np.sum(sim.get_fields()["rho"][:, :, i])) for i in range(2)]
    sim.run(300)
    rho = sim.get_fields()["rho"]
    for i in range(2):
        assert np.sum(rho[:, :, i]) == pytest.approx(m0[i], rel=1e-4)


def test_shan_chen_separation():
    """Two mutually repelling fluids phase-separate: densities anticorrelate
    and interfaces sharpen (the multicomponent_test.ipynb workload)."""
    sim = _runner(C=2, porous=False, nx=32, ny=32)
    for i in range(2):
        sim.add_fluid(Fluid(sim, i, nu_e=1.0 / 6.0, epsilon=1.0))
    sim.complete_setup()
    rng = np.random.RandomState(1)
    base = 0.5 + 0.05 * rng.rand(sim.ny, sim.nx)
    sim.fluid_list[0].initialize(base)
    sim.fluid_list[1].initialize(1.0 - base)
    sim.add_interaction_force(0, 1, G_int=1.8, potential="linear")
    std0 = float(sim.get_fields()["rho"][:, :, 0].std())
    sim.run(400)
    rho = sim.get_fields()["rho"]
    r0, r1 = rho[:, :, 0], rho[:, :, 1]
    assert np.isfinite(rho).all()
    corr = np.corrcoef(r0.ravel(), r1.ravel())[0, 1]
    assert corr < -0.5, corr
    # contrast grew strongly (domains formed): std 0.0005 -> ~0.7
    assert r0.std() > 20 * std0, (std0, r0.std())


def test_eating_conserves_total():
    sim = _runner(C=2, porous=False)
    for i in range(2):
        sim.add_fluid(Fluid(sim, i, nu_e=0.4))
    sim.complete_setup()
    sim.fluid_list[0].initialize(0.5 * np.ones((sim.ny, sim.nx)))
    sim.fluid_list[1].initialize(1.0 * np.ones((sim.ny, sim.nx)))
    sim.add_eating_rate(0, 1, rate=1e-3)
    m_eater0 = float(np.sum(sim.get_fields()["rho"][:, :, 0]))
    tot0 = float(np.sum(sim.get_fields()["rho"]))
    sim.run(200)
    rho = sim.get_fields()["rho"]
    assert np.sum(rho[:, :, 0]) > m_eater0          # eater grows
    assert np.sum(rho) == pytest.approx(tot0, rel=1e-4)  # total conserved (fp32)


def test_growth_hook():
    sim = _runner(C=1, porous=False)
    sim.add_fluid(Fluid(sim, 0, nu_e=0.4))
    sim.complete_setup()
    sim.fluid_list[0].initialize(0.5 * np.ones((sim.ny, sim.nx)))
    sim.add_growth(0, min_rho_cutoff=0.1, max_rho_cutoff=10.0, eat_rate=1e-3)
    m0 = float(np.sum(sim.get_fields()["rho"]))
    sim.run(100)
    assert float(np.sum(sim.get_fields()["rho"])) > m0


def test_zero_gradient_bc_runs():
    sim = _runner(C=1, porous=True)
    fl = Fluid(sim, 0, nu_e=0.5, bc="zero_gradient")
    sim.add_fluid(fl)
    sim.complete_setup()
    rho0 = np.ones((sim.ny, sim.nx))
    rho0[10:20, 10:20] = 2.0
    fl.initialize(rho0)
    sim.run(100)
    rho = sim.get_fields()["rho"][:, :, 0]
    assert np.isfinite(rho).all()
    # zero-gradient edges track their interior neighbors
    np.testing.assert_allclose(rho[0, 1:-1], rho[1, 1:-1], rtol=1e-3)


def test_d2q25_runner():
    sim = _runner(C=1, porous=False, lattice=D2Q25)
    sim.add_fluid(Fluid(sim, 0, nu_e=0.5))
    sim.complete_setup()
    rng = np.random.RandomState(2)
    sim.fluid_list[0].initialize(1.0 + 0.05 * rng.rand(sim.ny, sim.nx))
    m0 = float(np.sum(sim.get_fields()["rho"]))
    sim.run(100)
    rho = sim.get_fields()["rho"]
    assert rho.shape[-1] == 1 and sim.f.shape[0] == 25
    assert np.isfinite(rho).all()
    assert np.sum(rho) == pytest.approx(m0, rel=1e-5)


def test_screened_poisson_force_hook():
    sim = _runner(C=2, porous=False)
    for i in range(2):
        sim.add_fluid(Fluid(sim, i, nu_e=0.4))
    sim.complete_setup()
    rng = np.random.RandomState(3)
    blob = np.zeros((sim.ny, sim.nx))
    blob[12:20, 12:20] = 1.0
    sim.fluid_list[0].initialize(0.5 + blob)
    sim.fluid_list[1].initialize(np.ones((sim.ny, sim.nx)))
    sim.add_screened_poisson_force(source_index=0, force_index=1,
                                   interaction_length=2.0, amplitude=1e-3)
    sim.run(50)
    assert np.isfinite(sim.get_fields()["rho"]).all()


# ---- sharded runs (shard_over: the XLA step under GSPMD) ------------------

def _aligned_runner(backend, porous=True, ny=24, nx=128, C=2):
    sim = SimulationRunner(nx=nx, ny=ny, L_lb=nx, T_lb=1.0,
                           num_populations=C, porous=porous, backend=backend)
    for i in range(C):
        sim.add_fluid(Fluid(sim, i, nu_e=0.5,
                            epsilon=0.8 if porous else 1.0,
                            nu_fluid=0.4, K=2.0, Fe=0.5))
    sim.complete_setup()
    rng = np.random.RandomState(3)
    base = 0.5 + 0.05 * rng.rand(sim.ny, sim.nx)
    sim.fluid_list[0].initialize(base)
    if C > 1:
        sim.fluid_list[1].initialize(1.0 - base)
    return sim


def test_kernel_sharded_parity():
    """shard_over a virtual 4x1 mesh (GSPMD; the screened solve on the
    matmul DFT) matches the unsharded XLA step (``jnp.fft`` solve)."""
    from lb2d_tpu.parallel.sharded import make_mesh

    ref = _aligned_runner("xla", porous=False, ny=96)
    ref.add_interaction_force(0, 1, G_int=1.5, potential="shan_chen",
                              potential_parameters=[1.0])
    ref.add_screened_poisson_force(0, 1, interaction_length=4.0,
                                   amplitude=0.02)
    ref.run(5)

    mesh = make_mesh(4, shape=(4, 1))
    sh = _aligned_runner("auto", porous=False, ny=96)
    sh.add_interaction_force(0, 1, G_int=1.5, potential="shan_chen",
                             potential_parameters=[1.0])
    sh.add_screened_poisson_force(0, 1, interaction_length=4.0,
                                  amplitude=0.02)
    sh.shard_over(mesh)
    sh.run(5)
    assert sh.backend_used == "xla"
    np.testing.assert_allclose(np.asarray(sh.f), np.asarray(ref.f),
                               atol=5e-7, rtol=1e-5)


def test_kernel_sharded_parity_2d_mesh():
    """shard_over a virtual 2x2 mesh (x- and y-sharded GSPMD step) with
    the Shan-Chen belt + screened repulsion matches the unsharded XLA
    step."""
    from lb2d_tpu.parallel.sharded import make_mesh

    def build(backend):
        sim = SimulationRunner(nx=256, ny=48, L_lb=256, T_lb=1.0,
                               num_populations=2, porous=True,
                               backend=backend)
        for i in range(2):
            sim.add_fluid(Fluid(sim, i, nu_e=0.5, epsilon=0.8,
                                nu_fluid=0.4, K=2.0, Fe=0.5))
        sim.complete_setup()
        rng = np.random.RandomState(3)
        base = 0.5 + 0.05 * rng.rand(sim.ny, sim.nx)
        sim.fluid_list[0].initialize(base)
        sim.fluid_list[1].initialize(1.0 - base)
        sim.add_interaction_force(0, 1, G_int=1.5, potential="shan_chen",
                                  potential_parameters=[1.0])
        sim.add_screened_poisson_force(0, 1, interaction_length=4.0,
                                       amplitude=0.02)
        return sim

    ref = build("xla")
    ref.run(5)

    sh = build("auto")
    sh.shard_over(make_mesh(4, shape=(2, 2)))
    sh.run(5)
    assert sh.backend_used == "xla"
    np.testing.assert_allclose(np.asarray(sh.f), np.asarray(ref.f),
                               atol=5e-7, rtol=1e-5)


def test_kernel_fallbacks():
    """The "auto" backend resolves to the XLA step for every
    configuration."""
    # unaligned grid
    sim = _runner(C=1, porous=False)
    sim.add_fluid(Fluid(sim, 0, nu_e=0.4))
    sim.complete_setup()
    sim.fluid_list[0].initialize(np.ones((sim.ny, sim.nx)))
    sim.run(1)
    assert sim.backend_used == "xla"
    # zero-gradient BC
    sim = _aligned_runner("auto", porous=True, C=1)
    sim.fluid_list[0].bc = "zero_gradient"
    sim.run(1)
    assert sim.backend_used == "xla"
    # radial g-force (times_rho)
    sim = _aligned_runner("auto", porous=False)
    sim.add_radial_g_force(0, 8.0, 8.0, 1e-5, 1.0)
    sim.run(1)
    assert sim.backend_used == "xla"


def test_sharded_static_ext_forces():
    """A STATIC ext force field (radial body force) on a sharded mesh
    matches the unsharded XLA step over 16 steps, on a 1-D and a 2-D
    mesh."""
    from lb2d_tpu.parallel.sharded import make_mesh

    def build(backend, nx=128):
        sim = SimulationRunner(nx=nx, ny=96, L_lb=nx, T_lb=1.0,
                               num_populations=2, porous=True,
                               backend=backend)
        for i in range(2):
            sim.add_fluid(Fluid(sim, i, nu_e=0.5, epsilon=0.8,
                                nu_fluid=0.4, K=2.0, Fe=0.5))
        sim.complete_setup()
        rng = np.random.RandomState(3)
        base = 0.5 + 0.05 * rng.rand(sim.ny, sim.nx)
        sim.fluid_list[0].initialize(base)
        sim.fluid_list[1].initialize(1.0 - base)
        sim.add_radial_body_force(0, 64.0, 48.0, 1e-3, 1.0)
        return sim

    for shape, nx in (((4, 1), 128), ((2, 2), 256)):
        ref = build("xla", nx)
        ref.run(16)
        sh = build("auto", nx)
        sh.shard_over(make_mesh(4, shape=shape))
        sh.run(16)
        assert sh.backend_used == "xla", shape
        np.testing.assert_allclose(np.asarray(sh.f), np.asarray(ref.f),
                                   atol=5e-7, rtol=1e-5,
                                   err_msg=f"mesh {shape}")


def test_zero_gradient_bc_gspmd_safe():
    """Zero-gradient BC under GSPMD on a y-sharded state matches eager —
    regression for the edge-scatter miscompilation pattern."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from lb2d_tpu.models.multicomponent import _zero_gradient_bcs
    from lb2d_tpu.parallel.sharded import make_mesh

    rng = np.random.RandomState(0)
    f = jnp.asarray(rng.rand(9, 1, 64, 32), jnp.float32)
    mesh = make_mesh(4, shape=(4, 1))
    fs = jax.device_put(f, NamedSharding(mesh, P(None, None, "y", None)))
    a = jax.jit(lambda x: _zero_gradient_bcs(x, 0))(fs)
    b = _zero_gradient_bcs(f, 0)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fp32_long_horizon_conservation():
    """fp32 fidelity pin (the reference hard-requires fp64 for this engine,
    single_component.cl:1-7): over a 2000-step horizon of the config-5-like
    workload, fp32 keeps total mass to ~1e-5 relative and fields finite.
    The full 10k-step fp32-vs-fp64 drift table lives in benchmarks/
    fp64_drift.py (measured max relative drift ~1e-5 at 10k steps)."""
    sim = _runner(C=2, porous=True, nx=64, ny=64)
    for i in range(2):
        sim.add_fluid(Fluid(sim, i, nu_e=1.0 / 6.0, epsilon=0.8,
                            nu_fluid=1.0 / 6.0, K=10.0, Fe=0.1))
    sim.complete_setup()
    rng = np.random.RandomState(0)
    base = 0.5 + 0.05 * rng.rand(64, 64)
    sim.fluid_list[0].initialize(base)
    sim.fluid_list[1].initialize(1.0 - base)
    sim.add_interaction_force(0, 1, G_int=1.5, potential="shan_chen",
                              potential_parameters=[1.0])
    mass0 = float(np.asarray(sim.rho).sum())
    sim.run(2000)
    rho = np.asarray(sim.rho)
    assert np.isfinite(rho).all()
    mass = float(rho.sum())
    assert abs(mass - mass0) / abs(mass0) < 1e-4, (mass, mass0)


def test_sharded_screened_poisson_force_parity():
    """Config-5 composition (the XLA step + the fused matmul-DFT
    screened-Poisson repulsion solve, both under GSPMD) matches the
    unsharded run (``jnp.fft`` solve) — the solve's 4-step reshapes cross shard boundaries, so GSPMD
    resharding must not corrupt it (round-2 lesson: GSPMD miscompiles are
    silent)."""
    import jax
    from lb2d_tpu.parallel.sharded import make_mesh

    def build():
        sim = _aligned_runner("auto", porous=True, ny=128)
        sim.add_interaction_force(0, 1, G_int=1.5, potential="shan_chen",
                                  potential_parameters=[1.0])
        sim.add_screened_poisson_force(0, 1, interaction_length=4.0,
                                       amplitude=1e-3)
        return sim

    a = build()
    a.run(6)
    b = build()
    b.shard_over(make_mesh(4, shape=(4, 1)))
    b.run(6)
    assert b.backend_used == "xla"
    np.testing.assert_allclose(np.asarray(jax.device_get(b.f)),
                               np.asarray(a.f), atol=5e-7, rtol=1e-5)
