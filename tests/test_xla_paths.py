"""The XLA step as the only execution path.

* the flow step against the independent numpy oracle over equilibria,
  obstacles and grid shapes;
* every removed backend name and kernel-only option is rejected, never
  accepted silently;
* the compile-cache rule of the entry points.
"""

import os

import jax
import numpy as np
import pytest

from lb2d_tpu.models import (LatticePipeFlow, PipeFlow, ScreenedFisherWave,
                             SurfactantNutrientWave, disk_mask)
from lb2d_tpu.models.multicomponent import SimulationRunner
from lb2d_tpu.parallel.sharded import ShardedPipeFlow, make_mesh
from lb2d_tpu.utils.oracle import numpy_pipe_step

PARAMS = dict(diameter=1.5, rho=10.0, viscosity=5.0, pressure_grad=-100.0)

# (ny, nx) -> PipeFlow arguments giving exactly that grid
# (ny = N + 1, nx = ceil(pipe_length / L * N) + 1 with L = diameter)
GRIDS = {
    "aligned_64x128": dict(N=63, pipe_length=1.5 * 126.5 / 63),
    "unaligned_37x53": dict(N=36, pipe_length=1.5 * 51.5 / 36),
    "poiseuille_32x256": dict(N=31, pipe_length=1.5 * 254.5 / 31),
}


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("obstacle", [False, True], ids=["open", "cylinder"])
@pytest.mark.parametrize("equilibrium", ["compressible", "incompressible"])
def test_flow_step_matches_numpy_oracle(equilibrium, obstacle, grid):
    """5 fp32 XLA steps == 5 fp64 steps of the reference's two-buffer
    algorithm (:mod:`lb2d_tpu.utils.oracle`), to fp32 rounding."""
    kw = dict(GRIDS[grid], **PARAMS)
    mask = None
    if obstacle:
        probe = PipeFlow(init_state=False, **kw)
        mask = disk_mask(probe.nx, probe.ny, cx=probe.nx / 4,
                         cy=probe.ny / 2, radius=probe.ny / 6)
        assert mask.sum() > 0
    sim = PipeFlow(equilibrium=equilibrium, obstacle_mask=mask, **kw)
    assert sim.backend == "xla"
    expect = np.asarray(sim.state, np.float64)
    for _ in range(5):
        expect = numpy_pipe_step(
            expect, sim.omega, sim.inlet_rho, sim.outlet_rho,
            incompressible=equilibrium == "incompressible", mask=mask)
    got = np.asarray(sim.run(5).state, np.float64)
    np.testing.assert_allclose(got, expect, rtol=2e-5, atol=2e-6)


REMOVED_BACKENDS = ["resident", "temporal", "pipelined", "fused", "kernel"]


def _pipe(backend):
    return PipeFlow(N=7, pipe_length=3.0, backend=backend, **PARAMS)


def _lattice(backend):
    return LatticePipeFlow(lx=15, ly=7, backend=backend)


def _runner(backend):
    return SimulationRunner(nx=8, ny=8, L_lb=8, backend=backend)


def _sharded(backend):
    return ShardedPipeFlow(mesh=make_mesh(1), N=7, pipe_length=3.0,
                           backend=backend, **PARAMS)


@pytest.mark.parametrize("backend", REMOVED_BACKENDS)
@pytest.mark.parametrize("build", [_pipe, _lattice, _runner, _sharded],
                         ids=["PipeFlow", "LatticePipeFlow",
                              "SimulationRunner", "ShardedPipeFlow"])
def test_removed_backend_raises(build, backend):
    with pytest.raises(ValueError, match="valid backends: 'auto', 'xla'"):
        build(backend)


@pytest.mark.parametrize("call", [
    lambda: SimulationRunner(nx=8, ny=8, stale_force=4),
    lambda: SimulationRunner(nx=8, ny=8).run(2, k_steps=2),
    lambda: SimulationRunner(nx=8, ny=8).add_screened_poisson_force(
        0, 0, 4.0, 1e-3, precision="bf16x3"),
    lambda: ScreenedFisherWave(N=16, stale_velocity=4),
    lambda: SurfactantNutrientWave(N=16, solve_precision="bf16x3"),
    lambda: ShardedPipeFlow(mesh=make_mesh(1), N=7, pipe_length=3.0,
                            k_steps=8, **PARAMS),
], ids=["stale_force", "run_k_steps", "screened_precision",
        "stale_velocity", "solve_precision", "sharded_k_steps"])
def test_removed_option_raises(call):
    with pytest.raises(TypeError):
        call()


def test_removed_spectral_method_raises():
    with pytest.raises(ValueError, match="valid: 'auto', 'fft', 'matmul'"):
        ScreenedFisherWave(N=16, method="pallas")


@pytest.fixture
def restore_cache_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


@pytest.mark.parametrize("env_dir", [None, "from-env"])
def test_compile_cache_rule(restore_cache_config, monkeypatch, tmp_path,
                            env_dir):
    """With ``JAX_COMPILATION_CACHE_DIR`` set nothing sets a cache dir in
    code; without it the cache is ``<checkout>/.jax_cache``. Either way the
    minimum compile time to cache drops below JAX's default."""
    from lb2d_tpu.utils import compile_cache

    sentinel = str(tmp_path / "untouched")
    jax.config.update("jax_compilation_cache_dir", sentinel)
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        expect = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            ".jax_cache")
        assert compile_cache.configure_compile_cache() == expect
        assert jax.config.jax_compilation_cache_dir == expect
    else:
        env = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
        assert compile_cache.configure_compile_cache() == env
        assert jax.config.jax_compilation_cache_dir == sentinel
    assert (jax.config.jax_persistent_cache_min_compile_time_secs
            == compile_cache.MIN_COMPILE_SECS < 1.0)
