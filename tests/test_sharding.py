"""Multi-chip domain decomposition tests on a virtual 8-device CPU mesh."""

import jax
import numpy as np
import pytest

from lb2d_tpu.models.pipe_flow import PipeFlow
from lb2d_tpu.parallel.sharded import ShardedPipeFlow, make_mesh

PARAMS = dict(diameter=1.5, rho=10.0, viscosity=5.0, pressure_grad=-100.0)


@pytest.fixture(scope="module")
def has8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return True


def test_mesh_factoring(has8):
    mesh = make_mesh(8)
    assert mesh.shape["y"] * mesh.shape["x"] == 8
    mesh = make_mesh(8, shape=(2, 4))
    assert mesh.shape["y"] == 2 and mesh.shape["x"] == 4


def test_sharded_matches_single_device(has8):
    # ny = 16 (N=15) divisible by mesh y=2; nx must divide 4.
    # lx = ceil(pipe_length/L*N): want nx=32 -> lx=31 -> length = 30.5/15*L
    mesh = make_mesh(8, shape=(2, 4))
    kwargs = dict(N=15, pipe_length=1.5 * 30.5 / 15, **PARAMS)
    single = PipeFlow(backend="xla", **kwargs)
    assert (single.ny, single.nx) == (16, 32)
    sharded = ShardedPipeFlow(mesh=mesh, **kwargs)

    single.run(20)
    sharded.run(20)
    a = np.asarray(single.state)
    b = np.asarray(jax.device_get(sharded.state))
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)


def test_sharded_with_obstacle(has8):
    mesh = make_mesh(8, shape=(2, 4))
    mask = np.zeros((16, 32), np.int32)
    mask[6:10, 12:16] = 1
    kwargs = dict(N=15, pipe_length=1.5 * 30.5 / 15, obstacle_mask=mask, **PARAMS)
    single = PipeFlow(backend="xla", **kwargs)
    sharded = ShardedPipeFlow(mesh=mesh, **kwargs)
    single.run(10)
    sharded.run(10)
    np.testing.assert_allclose(
        np.asarray(jax.device_get(sharded.state)), np.asarray(single.state),
        rtol=1e-6, atol=1e-7)


def test_graft_dryrun(has8):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8)

    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    assert np.isfinite(np.asarray(out)).all()


def test_multicomponent_gspmd_sharding(has8):
    """SimulationRunner.shard_over: GSPMD-partitioned porous engine matches
    the unsharded run bitwise-close."""
    from lb2d_tpu.models.multicomponent import Fluid, SimulationRunner

    def build():
        sim = SimulationRunner(nx=32, ny=32, L_lb=32, num_populations=2,
                               porous=True)
        for i in range(2):
            sim.add_fluid(Fluid(sim, i, nu_e=0.4, epsilon=0.9, nu_fluid=0.3,
                                K=1.0, Fe=0.1))
        sim.complete_setup()
        rng = np.random.RandomState(0)
        sim.fluid_list[0].initialize(0.5 + 0.05 * rng.rand(32, 32))
        sim.fluid_list[1].initialize(0.5 + 0.05 * rng.rand(32, 32))
        sim.add_interaction_force(0, 1, G_int=0.5, potential="shan_chen",
                                  potential_parameters=[1.0])
        return sim

    a = build()
    b = build()
    b.shard_over(make_mesh(8, shape=(2, 4)))
    a.run(50)
    b.run(50)
    np.testing.assert_allclose(
        np.asarray(jax.device_get(b.f)), np.asarray(a.f),
        rtol=1e-6, atol=1e-7)


class TestTemporalSharded:
    """ShardedPipeFlow's shard_map halo step on y meshes and 1x1 meshes."""

    KW = dict(N=255, pipe_length=1.5 * 126.5 / 255, **PARAMS)

    def test_matches_single_device(self, has8):
        mesh = make_mesh(8, shape=(8, 1))
        single = PipeFlow(backend="xla", **self.KW)
        assert (single.ny, single.nx) == (256, 128)
        sh = ShardedPipeFlow(mesh=mesh, **self.KW)
        single.run(8)
        sh.run(8)
        np.testing.assert_allclose(
            np.asarray(jax.device_get(sh.state)), np.asarray(single.state),
            rtol=1e-6, atol=1e-7)

    def test_one_device_mesh_deep_k(self, has8):
        """1x1 mesh: the halo exchange is the local periodic wrap."""
        mesh = make_mesh(1, shape=(1, 1))
        single = PipeFlow(backend="xla", **self.KW)
        sh = ShardedPipeFlow(mesh=mesh, **self.KW)
        single.run(8)
        sh.run(8)
        np.testing.assert_allclose(
            np.asarray(jax.device_get(sh.state)), np.asarray(single.state),
            rtol=1e-6, atol=1e-7)

    def test_one_device_mesh_halo_only_grid(self, has8):
        """1x1 mesh, 64x128 grid: "auto" and "xla" both run the shard_map
        halo step."""
        mesh = make_mesh(1, shape=(1, 1))
        kw = dict(N=63, pipe_length=1.5 * 127 / 63, **PARAMS)
        single = PipeFlow(backend="xla", **kw)
        assert (single.ny, single.nx) == (64, 128)
        for backend in ("xla", "auto"):
            sh = ShardedPipeFlow(mesh=mesh, backend=backend, **kw)
            assert sh.backend == "xla"
            sh.run(7)
        single.run(7)
        np.testing.assert_allclose(
            np.asarray(jax.device_get(sh.state)), np.asarray(single.state),
            rtol=1e-6, atol=1e-7)

    def test_auto_backend_falls_back(self, has8):
        """Tiny shards (H=16): "auto" resolves to the XLA halo step."""
        mesh = make_mesh(8, shape=(8, 1))
        kw = dict(N=127, pipe_length=1.5 * 126.5 / 127, **PARAMS)
        sh = ShardedPipeFlow(mesh=mesh, backend="auto", **kw)
        assert sh.backend == "xla"

    def test_get_fields_sharded(self, has8):
        """get_fields computes moments on the sharded state (no device-0
        staging) and matches the single-device fields."""
        mesh = make_mesh(8, shape=(8, 1))
        single = PipeFlow(backend="xla", **self.KW)
        sh = ShardedPipeFlow(mesh=mesh, **self.KW)
        single.run(8)
        sh.run(8)
        a = single.get_fields()
        b = sh.get_fields()
        # u, v are O(1e-5) differences of O(0.4) populations, so fp32
        # reassociation noise (~1e-7 absolute) dominates their rtol.
        for k in ("rho", "u", "v"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=1e-6)

    def test_make_mesh_raises_on_too_few_devices(self, has8):
        with pytest.raises(ValueError, match="only"):
            make_mesh(1024)


# ---- ShardedDiffusion (VERDICT r1 #6: shard the diffusion family) ---------

def test_sharded_diffusion_parity():
    """Deterministic Fisher wave under GSPMD on a virtual 4x1 mesh matches
    the unsharded XLA step (the collective-permute ring IS the periodic
    wrap)."""
    import jax
    import jax.numpy as jnp
    from lb2d_tpu.models.diffusion import ReactionAdvectionDiffusion
    from lb2d_tpu.parallel.sharded import ShardedDiffusion, make_mesh

    kw = dict(N=126, z=0.1, D=0.005, vx=1.0, vy=0.5, vc=1.0,
              Lx=0.101, Ly=0.101, g=1.0)
    ref = ReactionAdvectionDiffusion(**kw)
    step = ref.make_step()
    run = jax.jit(lambda f, n: jax.lax.fori_loop(
        0, n, lambda i, s: step(s), f))
    fref = run(ref.state, 7)

    sh = ShardedDiffusion(ReactionAdvectionDiffusion(**kw),
                          mesh=make_mesh(4, shape=(4, 1)))
    sh.run(7)
    np.testing.assert_allclose(np.asarray(sh.state), np.asarray(fref),
                               atol=1e-6, rtol=1e-5)


def test_sharded_diffusion_noisy_runs():
    """Stochastic Fisher sharded: positive, finite, and actually grows
    toward carrying capacity."""
    from lb2d_tpu.models.diffusion import (
        ReactionAdvectionDiffusionStochastic)
    from lb2d_tpu.parallel.sharded import ShardedDiffusion, make_mesh

    st = ReactionAdvectionDiffusionStochastic(
        Dg=0.2, N=126, z=0.1, D=0.005, vx=1.0, vy=0.5, vc=1.0,
        Lx=0.101, Ly=0.101, g=1.0)
    sh = ShardedDiffusion(st, mesh=make_mesh(4, shape=(4, 1)))
    rho0 = float(np.asarray(sh.get_fields()["rho"]).mean())
    sh.run(6)
    rho = np.asarray(sh.get_fields()["rho"])
    assert np.isfinite(rho).all()
    assert rho.min() >= 0.0
    assert rho.mean() > rho0  # Fisher growth


def test_sharded_multifield_fisher_parity():
    """Multifield Fisher (no-flux walls, masked selects) under GSPMD
    matches the unsharded XLA step."""
    import jax
    from lb2d_tpu.models.multifield import FisherExpansion
    from lb2d_tpu.parallel.sharded import ShardedMultifield, make_mesh

    kwf = dict(Lx=2.05, Ly=2.05, mu_standard=1.0, mu_list=[1.0, 0.8],
               D_standard=1.0, D_list=[1.0, 1.0], N=126,
               initial_frac_widths=[0.5, 0.5], initial_frac_indices=[0, 1])
    ref = FisherExpansion(**kwf)
    step = ref.make_step()
    fref = ref.state
    for _ in range(7):
        fref = step(fref)
    sh = ShardedMultifield(FisherExpansion(**kwf),
                           mesh=make_mesh(4, shape=(4, 1)))
    sh.run(7)
    np.testing.assert_allclose(np.asarray(sh.state), np.asarray(fref),
                               atol=1e-6, rtol=1e-5)


def test_sharded_multifield_expansion_runs():
    """Stochastic range expansion (populations + nutrient) sharded: finite,
    non-negative populations, nutrient consumed."""
    from lb2d_tpu.models.multifield import Expansion
    from lb2d_tpu.parallel.sharded import ShardedMultifield, make_mesh

    ex = Expansion(Lx=2.05, Ly=2.05, mu_standard=1.0, mu_list=[1.0, 0.8],
                   D_standard=1.0, D_list=[1.0, 1.0], N=126)
    sh = ShardedMultifield(ex, mesh=make_mesh(4, shape=(4, 1)))
    f0, _ = sh.state
    nut0 = float(np.asarray(f0.sum(axis=0)[-1]).sum())
    sh.run(6)
    f, _ = sh.state
    rho = np.asarray(f.sum(axis=0))
    assert np.isfinite(rho).all() and rho.min() >= 0.0
    assert rho[-1].sum() < nut0  # nutrient consumed by growth


def test_noflux_bcs_gspmd_safe():
    """The no-flux BC under GSPMD on a y-sharded array matches eager —
    regression for the scatter miscompilation (edge .at[].set applied the
    global row -1 update to every shard's last local row)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from lb2d_tpu.models.multifield import noflux_bcs_multifield
    from lb2d_tpu.parallel.sharded import make_mesh

    rng = np.random.RandomState(0)
    f = jnp.asarray(rng.rand(9, 2, 64, 32), jnp.float32)
    mesh = make_mesh(4, shape=(4, 1))
    fs = jax.device_put(f, NamedSharding(mesh, P(None, None, "y", None)))
    a = jax.jit(noflux_bcs_multifield)(fs)
    b = noflux_bcs_multifield(f)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_sharded_coupled_rocket_yeast_parity():
    """Rocket yeast (fully local physics) under GSPMD matches the
    unsharded XLA step."""
    import jax
    from lb2d_tpu.models.rocket_yeast import RocketYeast
    from lb2d_tpu.parallel.sharded import ShardedCoupled, make_mesh

    kw = dict(Lx=1.0, Ly=1.0, R0=0.2, epsilon=0.05, Gc=2.0, N=128,
              G_chen=-0.1)
    ref = RocketYeast(**kw)
    xs = jax.jit(ref.make_step())
    fx = ref.state
    for _ in range(7):
        fx = xs(fx)
    sh = ShardedCoupled(RocketYeast(**kw), mesh=make_mesh(4, shape=(4, 1)))
    sh.run(7)
    np.testing.assert_allclose(np.asarray(sh.state),
                               np.asarray(fx), atol=5e-7, rtol=1e-5)


def test_sharded_coupled_rocket_yeast_forces_only_parity():
    """The sharded forces-only variant must run the forces-only velocity
    (pseudo-force + surface tension), not the standard rocket-yeast
    physics."""
    import jax
    from lb2d_tpu.models.rocket_yeast import RocketYeastForcesOnly
    from lb2d_tpu.parallel.sharded import ShardedCoupled, make_mesh

    kw = dict(Lx=1.0, Ly=1.0, R0=0.2, epsilon=0.05, Gc=2.0, N=128,
              G_chen=-0.1, c_o=0.3, alpha=2.0)
    ref = RocketYeastForcesOnly(**kw)
    xs = jax.jit(ref.make_step())
    fx = ref.state
    for _ in range(7):
        fx = xs(fx)
    sh = ShardedCoupled(RocketYeastForcesOnly(**kw),
                        mesh=make_mesh(4, shape=(4, 1)))
    sh.run(7)
    np.testing.assert_allclose(np.asarray(sh.state),
                               np.asarray(fx), atol=5e-7, rtol=1e-5)


def test_sharded_coupled_spectral_parity():
    """Spectral-velocity families sharded: the screened-Poisson solve runs
    under GSPMD on the matmul DFT, against the unsharded ``jnp.fft``
    solve."""
    import jax
    from lb2d_tpu.models.waves import ScreenedFisherWave
    from lb2d_tpu.parallel.sharded import ShardedCoupled, make_mesh

    kw = dict(Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2, N=128)
    ref = ScreenedFisherWave(**kw)
    xs = jax.jit(ref.make_step())
    fx = ref.state
    for _ in range(5):
        fx = xs(fx)
    sh = ShardedCoupled(ScreenedFisherWave(**kw),
                        mesh=make_mesh(4, shape=(4, 1)))
    sh.run(5)
    np.testing.assert_allclose(np.asarray(sh.state),
                               np.asarray(fx), atol=5e-7, rtol=1e-5)


def test_sharded_coupled_2d_mesh_parity():
    """ShardedCoupled on a 2-D mesh: rocket yeast and the spectral wave
    (GSPMD matmul-DFT solve) vs the unsharded XLA steps on a virtual 2x2
    mesh."""
    import jax
    from lb2d_tpu.models.rocket_yeast import RocketYeast
    from lb2d_tpu.models.waves import ScreenedFisherWave
    from lb2d_tpu.parallel.sharded import ShardedCoupled, make_mesh

    kw = dict(Lx=1.0, Ly=1.0, R0=0.2, epsilon=0.05, Gc=2.0, N=64,
              G_chen=-0.1)
    ref = RocketYeast(**kw)
    xs = jax.jit(ref.make_step())
    fx = ref.state
    for _ in range(7):
        fx = xs(fx)
    sh = ShardedCoupled(RocketYeast(**kw), mesh=make_mesh(4, shape=(2, 2)))
    sh.run(7)
    np.testing.assert_allclose(np.asarray(sh.state),
                               np.asarray(fx), atol=5e-7, rtol=1e-5)

    kw2 = dict(Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2, N=64)
    ref2 = ScreenedFisherWave(**kw2)
    xs2 = jax.jit(ref2.make_step())
    fx2 = ref2.state
    for _ in range(4):
        fx2 = xs2(fx2)
    sh2 = ShardedCoupled(ScreenedFisherWave(**kw2),
                         mesh=make_mesh(4, shape=(2, 2)))
    sh2.run(4)
    np.testing.assert_allclose(np.asarray(sh2.state),
                               np.asarray(fx2), atol=5e-7, rtol=1e-5)


def test_sharded_velocity_uses_partitionable_dft():
    """Under a >1-device mesh the screened-velocity solve must take the
    GSPMD-partitionable matmul DFT, never the FFT custom call, in both
    ShardedCoupled and SimulationRunner.shard_over; a 1-device mesh keeps
    the FFT."""
    from lb2d_tpu.models.multicomponent import Fluid, SimulationRunner
    from lb2d_tpu.models.waves import ScreenedFisherWave
    from lb2d_tpu.parallel.sharded import ShardedCoupled, make_mesh

    kw = dict(Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2, N=32)
    base = ScreenedFisherWave(**kw)
    assert base._velocity.method == "fft"
    ShardedCoupled(base, mesh=make_mesh(1, shape=(1, 1)))
    assert base._velocity.method == "fft"
    ShardedCoupled(base, mesh=make_mesh(4, shape=(4, 1)))
    assert base._velocity.method == "matmul"
    with pytest.warns(UserWarning, match="overriding explicit"):
        ShardedCoupled(ScreenedFisherWave(method="fft", **kw),
                       mesh=make_mesh(4, shape=(4, 1)))

    sim = SimulationRunner(nx=32, ny=32, L_lb=32, T_lb=1.0,
                           num_populations=2)
    for i in range(2):
        sim.add_fluid(Fluid(sim, i, nu_e=1.0 / 6.0))
    sim.complete_setup()
    sim.fluid_list[0].initialize(np.full((32, 32), 0.5, np.float32))
    sim.fluid_list[1].initialize(np.full((32, 32), 0.5, np.float32))
    sim.add_screened_poisson_force(0, 1, interaction_length=4.0,
                                   amplitude=1e-4)
    vel = sim._screened[0]
    assert vel.method == "fft"
    sim.shard_over(make_mesh(4, shape=(4, 1)))
    assert vel.method == "matmul"


def test_sharded_diffusion_2d_mesh_parity():
    """Diffusion family on a 2x4 mesh: the periodic wrap IS the
    collective-permute ring in both directions."""
    import jax
    from lb2d_tpu.models.diffusion import ReactionAdvectionDiffusion
    from lb2d_tpu.parallel.sharded import ShardedDiffusion, make_mesh

    kw = dict(N=126, z=0.1, D=0.005, vx=1.0, vy=0.5, vc=1.0,
              Lx=0.101, Ly=0.101, g=1.0)
    ref = ReactionAdvectionDiffusion(**kw)
    assert (ref.ny, ref.nx) == (128, 128)
    step = ref.make_step()
    run = jax.jit(lambda f, n: jax.lax.fori_loop(
        0, n, lambda i, s: step(s), f))
    fref = run(ref.state, 5)

    sh = ShardedDiffusion(ReactionAdvectionDiffusion(**kw),
                          mesh=make_mesh(8, shape=(2, 4)))
    sh.run(5)
    np.testing.assert_allclose(np.asarray(sh.state), np.asarray(fref),
                               atol=1e-6, rtol=1e-5)


def test_distributed_single_process_init(has8):
    """Multi-host entry point: the single-process path initializes without
    a coordinator and yields a global mesh the sharded models accept."""
    from lb2d_tpu.parallel.distributed import (global_mesh, init_distributed,
                                               is_initialized)

    init_distributed(num_processes=1)
    assert is_initialized()
    mesh = global_mesh()
    assert mesh.shape["y"] * mesh.shape["x"] == len(jax.devices())
    assert mesh.shape["y"] >= mesh.shape["x"]  # rows stay process-contiguous
    # the mesh drives the ordinary sharded surface
    kw = dict(N=15, pipe_length=1.5 * 30.5 / 15, **PARAMS)
    mesh2 = global_mesh(shape=(8, 1))
    sh = ShardedPipeFlow(mesh=mesh2, **kw)
    sh.run(4)
    assert np.isfinite(np.asarray(jax.device_get(sh.state))).all()


def test_distributed_two_process_parity(has8):
    """The >1-process branch of ``init_distributed`` actually executes
    (VERDICT r3 #2): two CPU processes (4 virtual devices each) join
    through a localhost coordinator, build the 8-device global mesh, run
    ShardedPipeFlow, and match the single-process 8-device run."""
    import json
    import os
    import socket
    import subprocess
    import sys as _sys

    import jax.numpy as jnp

    child = os.path.join(os.path.dirname(__file__), "_dist_child_pipe.py")
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen(
        [_sys.executable, child, str(i), str(port), "5"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=420)
        assert p.returncode == 0, (out[-1000:], err[-2000:])
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")][-1]
        outs.append(json.loads(line[len("RESULT "):]))
    assert [o["nproc"] for o in outs] == [2, 2]
    assert [o["ndev"] for o in outs] == [8, 8]
    # both processes computed the identical replicated diagnostics
    np.testing.assert_array_equal(outs[0]["prof"], outs[1]["prof"])
    assert outs[0]["mass"] == outs[1]["mass"]
    # parity vs the single-process run on this test process's own 8 devices
    from lb2d_tpu.parallel.distributed import global_mesh
    sim = ShardedPipeFlow(mesh=global_mesh(shape=(8, 1)), N=15,
                          pipe_length=1.5 * 30.5 / 15, **PARAMS)
    sim.run(5)
    mass = float(jnp.sum(sim.state))
    prof = np.asarray(jnp.sum(sim.state, axis=(0, 2)))
    np.testing.assert_allclose(outs[0]["mass"], mass, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(outs[0]["prof"]), prof, rtol=1e-5)


def test_distributed_two_process_kernel_parity(has8):
    """The GSPMD families across a real process boundary: two CPU
    processes run ShardedDiffusion over the 8-device global mesh — the
    rolls' collective-permutes cross processes — and match the
    single-process run."""
    import json
    import os
    import socket
    import subprocess
    import sys as _sys

    import jax.numpy as jnp

    child = os.path.join(os.path.dirname(__file__), "_dist_child_diffusion.py")
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen(
        [_sys.executable, child, str(i), str(port), "6"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=420)
        assert p.returncode == 0, (out[-1000:], err[-2000:])
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")][-1]
        outs.append(json.loads(line[len("RESULT "):]))
    assert [o["nproc"] for o in outs] == [2, 2]
    np.testing.assert_array_equal(outs[0]["prof"], outs[1]["prof"])
    assert outs[0]["mass"] == outs[1]["mass"]
    # parity vs the single-process run on this test process's 8 devices
    # (same mesh shape, same partitioned program -> same numerics)
    from lb2d_tpu.models.diffusion import ReactionAdvectionDiffusion
    from lb2d_tpu.parallel.distributed import global_mesh
    from lb2d_tpu.parallel.sharded import ShardedDiffusion
    base = ReactionAdvectionDiffusion(N=254, z=0.1, D=0.005, vx=1.0, vy=0.5,
                                      vc=1.0, Lx=0.101, Ly=0.101, g=1.0)
    sim = ShardedDiffusion(base, mesh=global_mesh(shape=(8, 1)))
    sim.run(6)
    mass = float(jnp.sum(sim.state))
    prof = np.asarray(jnp.sum(sim.state, axis=(0, 2)))
    np.testing.assert_allclose(outs[0]["mass"], mass, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(outs[0]["prof"]), prof, rtol=1e-5)


def test_sharded_multifield_fisher_2d_mesh_parity():
    """FisherExpansion on a 2-D mesh (no-flux walls on both sharded
    axes): parity vs the unsharded XLA step on a virtual 2x2 mesh."""
    import jax
    from lb2d_tpu.models.multifield import FisherExpansion
    from lb2d_tpu.parallel.sharded import ShardedMultifield, make_mesh

    kwf = dict(Lx=2.05, Ly=2.05, mu_standard=1.0, mu_list=[1.0, 0.8],
               D_standard=1.0, D_list=[1.0, 1.0], N=62,
               initial_frac_widths=[0.5, 0.5], initial_frac_indices=[0, 1])
    ref = FisherExpansion(**kwf)
    assert (ref.ny, ref.nx) == (64, 64)
    step = ref.make_step()
    fref = ref.state
    for _ in range(5):
        fref = step(fref)
    sh = ShardedMultifield(FisherExpansion(**kwf),
                           mesh=make_mesh(4, shape=(2, 2)))
    sh.run(5)
    np.testing.assert_allclose(np.asarray(sh.state), np.asarray(fref),
                               atol=1e-6, rtol=1e-5)


def test_sharded_multifield_expansion_2d_runs():
    """Stochastic Expansion on a 2-D mesh: finite, non-negative, nutrient
    consumed."""
    from lb2d_tpu.models.multifield import Expansion
    from lb2d_tpu.parallel.sharded import ShardedMultifield, make_mesh

    ex = Expansion(Lx=2.05, Ly=2.05, mu_standard=1.0, mu_list=[1.0, 0.8],
                   D_standard=1.0, D_list=[1.0, 1.0], N=62)
    sh = ShardedMultifield(ex, mesh=make_mesh(4, shape=(2, 2)))
    f0, _ = sh.state
    nut0 = float(np.asarray(f0.sum(axis=0)[-1]).sum())
    sh.run(5)
    f, _ = sh.state
    rho = np.asarray(f.sum(axis=0))
    assert np.isfinite(rho).all() and rho.min() >= 0.0
    assert rho[-1].sum() < nut0  # nutrient consumed by growth


# ---- every sharded surface against its unsharded model ---------------------

def _pipe_pair(obstacle=False):
    kw = dict(N=15, pipe_length=1.5 * 30.5 / 15, **PARAMS)  # 16 x 32
    if obstacle:
        mask = np.zeros((16, 32), np.int32)
        mask[5:11, 10:16] = 1
        kw["obstacle_mask"] = mask
    return (lambda: PipeFlow(**kw),
            lambda mesh: ShardedPipeFlow(mesh=mesh, **kw))


def _family_pair(wrapper, build):
    return build, lambda mesh: wrapper(build(), mesh=mesh)


def _runner_pair():
    from lb2d_tpu.models.multicomponent import Fluid, SimulationRunner

    def build():
        sim = SimulationRunner(nx=32, ny=16, L_lb=32, num_populations=2,
                               porous=True)
        for i in range(2):
            sim.add_fluid(Fluid(sim, i, nu_e=0.4, epsilon=0.9, nu_fluid=0.3,
                                K=1.0, Fe=0.1))
        sim.complete_setup()
        base = 0.5 + 0.05 * np.random.RandomState(0).rand(16, 32)
        sim.fluid_list[0].initialize(base)
        sim.fluid_list[1].initialize(1.0 - base)
        sim.add_interaction_force(0, 1, G_int=1.5, potential="shan_chen",
                                  potential_parameters=[1.0])
        sim.add_screened_poisson_force(0, 1, interaction_length=4.0,
                                       amplitude=1e-3)
        return sim

    def sharded(mesh):
        return build().shard_over(mesh)

    return build, sharded


def _surface(name):
    from lb2d_tpu.models import (Expansion, FisherExpansion,
                                 ReactionAdvectionDiffusion,
                                 ReactionAdvectionDiffusionStochastic,
                                 RocketYeast, ScreenedFisherWave,
                                 SurfactantNutrientWave)
    from lb2d_tpu.parallel.sharded import (ShardedCoupled, ShardedDiffusion,
                                           ShardedMultifield)

    diff = dict(N=30, z=0.1, D=0.005, vx=1.0, vy=0.5, vc=1.0, Lx=0.101,
                Ly=0.101, g=1.0)                       # 32 x 32
    mf = dict(Lx=2.05, Ly=2.05, mu_standard=1.0, mu_list=[1.0, 0.8],
              D_standard=1.0, D_list=[1.0, 1.0], N=30)  # 32 x 32
    return {
        "pipe": lambda: _pipe_pair(),
        "pipe_obstacle": lambda: _pipe_pair(obstacle=True),
        "diffusion": lambda: _family_pair(
            ShardedDiffusion, lambda: ReactionAdvectionDiffusion(**diff)),
        "diffusion_stochastic": lambda: _family_pair(
            ShardedDiffusion,
            lambda: ReactionAdvectionDiffusionStochastic(Dg=0.05, **diff)),
        "multifield_fisher": lambda: _family_pair(
            ShardedMultifield, lambda: FisherExpansion(
                initial_frac_widths=[0.5, 0.5], initial_frac_indices=[0, 1],
                **mf)),
        "multifield_expansion": lambda: _family_pair(
            ShardedMultifield, lambda: Expansion(**mf)),
        "rocket_yeast": lambda: _family_pair(
            ShardedCoupled, lambda: RocketYeast(
                Lx=1.0, Ly=1.0, R0=0.2, epsilon=0.05, Gc=2.0, N=32,
                G_chen=-0.1)),
        "surfactant": lambda: _family_pair(
            ShardedCoupled, lambda: SurfactantNutrientWave(
                Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2, N=32)),
        "screened_wave": lambda: _family_pair(
            ShardedCoupled, lambda: ScreenedFisherWave(
                Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2, N=32)),
        "multicomponent": _runner_pair,
    }[name]()


def _main_leaf(model):
    state = model.f if hasattr(model, "f") else model.state
    return np.asarray(jax.device_get(jax.tree_util.tree_leaves(state)[0]))


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2), (2, 4)])
@pytest.mark.parametrize("surface", [
    "pipe", "pipe_obstacle", "diffusion", "diffusion_stochastic",
    "multifield_fisher", "multifield_expansion", "rocket_yeast",
    "surfactant", "screened_wave", "multicomponent"])
def test_sharded_surface_matches_unsharded(has8, surface, mesh_shape):
    """Each sharded surface on a virtual mesh computes what its unsharded
    model computes (the spectral families solve with the matmul DFT under
    the mesh and with ``jnp.fft`` unsharded, hence the tolerance)."""
    build, sharded = _surface(surface)
    n = mesh_shape[0] * mesh_shape[1]
    ref = build()
    sh = sharded(make_mesh(n, shape=mesh_shape))
    ref.run(6)
    sh.run(6)
    state = sh.f if hasattr(sh, "f") else sh.state
    leaf = jax.tree_util.tree_leaves(state)[0]
    assert len(leaf.sharding.device_set) == n
    np.testing.assert_allclose(_main_leaf(sh), _main_leaf(ref),
                               rtol=1e-5, atol=1e-6)
