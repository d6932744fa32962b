"""Benchmark suite: the five BASELINE.json configs, one JSON line each.

1. Dimensionless Poiseuille pipe flow, 32x256 (the reference's
   python_cython_opencl_comparison workload shape).
2. Obstacle channel flow with a bounce-back cylinder mask (cs205_movie).
3. Scalar advection-diffusion (D2Q9_diffusion.cl equivalent).
4. Multifield Fisher reaction-diffusion range expansion
   (D2Q9_multifield_fisher.cl).
5. Porous-media 2-fluid flow with a per-step screened-Poisson repulsion
   solve at 8192^2, domain-decomposed over the available device mesh
   (single device: 1x1 mesh) — the BASELINE.json config-5 workload
   (multi.py:488-511 + single_component.py:679-751). 5b additionally
   reports sharded pipe flow at 8192^2 (the halo-exchange step).

Usage: python benchmarks/run_all.py [--quick]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np


def _spread(rates):
    rates = sorted(rates)
    return rates[len(rates) // 2], {"min": rates[0], "max": rates[-1],
                                    "reps": len(rates)}


def _measure(model, steps, reps=5):
    """Median of `reps` timed runs (compile/warm-up excluded), with min/max
    dispersion — single measurements on a shared host are too noisy to
    distinguish a 30% regression from load."""
    state = "state" if hasattr(model, "state") else "f"
    model.run(max(2, steps // 10))
    jax.block_until_ready(getattr(model, state))
    rates = []
    for _ in range(reps):
        t0 = time.perf_counter()
        model.run(steps)
        jax.block_until_ready(getattr(model, state))
        dt = time.perf_counter() - t0
        rates.append(model.num_cells * steps / dt / 1e6)
    return _spread(rates)


def bench_poiseuille(quick):
    from lb2d_tpu.models import PipeFlow

    sim = PipeFlow(diameter=1.5, rho=10.0, viscosity=5.0,
                   pressure_grad=-100.0, pipe_length=1.5 * 254.5 / 31,
                   N=31)  # 32 rows x 256 cols
    steps = 200 if quick else 20_000
    return "poiseuille 32x256", _measure(sim, steps), sim.backend


def bench_obstacle(quick):
    # explicit 2048x1024 grid via a PipeFlowObstacles disk mask
    from lb2d_tpu.models import PipeFlowObstacles, disk_mask

    ny, nx = 1024, 2048
    mask = disk_mask(nx, ny, cx=nx // 4, cy=ny // 2, radius=ny // 12)
    sim = PipeFlowObstacles(obstacle_mask=mask, diameter=1.5, rho=10.0,
                            viscosity=0.5, pressure_grad=-10.0,
                            pipe_length=1.5 * (nx - 1.5) / (ny - 1),
                            N=ny - 1)
    assert (sim.ny, sim.nx) == (ny, nx), (sim.ny, sim.nx)
    steps = 100 if quick else 2000
    return f"obstacle channel {sim.nx}x{sim.ny}", _measure(sim, steps), sim.backend


def bench_diffusion(quick):
    from lb2d_tpu.models import AdvectionDiffusion

    sim = AdvectionDiffusion(N=341, z=0.1, D=0.005, vx=1.0, vy=0.0, vc=1.0,
                             Lx=0.61, Ly=0.61)  # 2048^2
    steps = 100 if quick else 2000
    return (f"advection-diffusion {sim.nx}x{sim.ny}", _measure(sim, steps),
            sim.backend)


def bench_multifield(quick):
    from lb2d_tpu.models import FisherExpansion

    sim = FisherExpansion(Lx=4.1, Ly=4.1, mu_standard=1.0,
                          mu_list=[1.0, 1.0], D_standard=1.0,
                          D_list=[1.0, 1.0], N=1023,  # 2048^2
                          initial_frac_widths=[0.5, 0.5],
                          initial_frac_indices=[0, 1])
    steps = 50 if quick else 1000
    return (f"multifield fisher {sim.nx}x{sim.ny}x2", _measure(sim, steps),
            sim.backend)


def bench_porous_poisson_8192(quick):
    """BASELINE config 5: porous 2-fluid SimulationRunner + Shan-Chen
    first-belt interaction + per-step screened-Poisson repulsion
    (multi.py:488-511) at 8192^2, shard_over the device mesh: the XLA step
    under GSPMD; the solve is ``jnp.fft`` on one device and the matmul DFT
    on a multi-device mesh."""
    from lb2d_tpu.models.multicomponent import Fluid, SimulationRunner
    from lb2d_tpu.parallel.sharded import make_mesh

    n_dev = len(jax.devices())
    mesh = make_mesh(n_dev, shape=(n_dev, 1))
    size = 1024 if quick else 8192
    sim = SimulationRunner(nx=size, ny=size, L_lb=size, T_lb=1.0,
                           num_populations=2, porous=True)
    for i in range(2):
        sim.add_fluid(Fluid(sim, i, nu_e=1.0 / 6.0, epsilon=0.8,
                            nu_fluid=1.0 / 6.0, K=10.0, Fe=0.1))
    sim.complete_setup()
    rng = np.random.RandomState(0)
    base = 0.5 + 0.05 * rng.rand(size, size).astype(np.float32)
    sim.fluid_list[0].initialize(base)
    sim.fluid_list[1].initialize(1.0 - base)
    sim.add_interaction_force(0, 1, G_int=1.5, potential="shan_chen",
                              potential_parameters=[1.0])
    sim.add_screened_poisson_force(0, 1, interaction_length=10.0,
                                   amplitude=1e-4)
    sim.shard_over(mesh)
    steps = 3 if quick else 10
    sim.run(steps, timed=True)  # warm (compile both paths)
    rates = []
    for _ in range(2 if quick else 5):
        sim.run(steps, timed=True)
        rates.append(sim.last_mlups)
    med, spread = _spread(rates)
    return (f"porous+poisson {size}^2 2-fluid mesh={n_dev}dev",
            (med, spread), sim.backend_used)


def bench_sharded_8192(quick):
    from lb2d_tpu.parallel.sharded import ShardedPipeFlow, make_mesh

    n_dev = len(jax.devices())
    mesh = make_mesh(n_dev)
    size = 1024 if quick else 8192
    N = size - 1
    sim = ShardedPipeFlow(mesh=mesh, diameter=1.0, rho=1.0, viscosity=0.1,
                          pressure_grad=-0.01,
                          pipe_length=(size - 1.5) / N, N=N)
    steps = 10 if quick else 100
    sim.run(2)  # warm (compile) outside the timed region
    jax.block_until_ready(sim.state)
    rates = []
    for _ in range(2 if quick else 5):
        t0 = time.perf_counter()
        sim.run(steps)
        jax.block_until_ready(sim.state)
        dt = time.perf_counter() - t0
        rates.append(sim.num_cells * steps / dt / 1e6)
    med, spread = _spread(rates)
    return (f"sharded pipe {sim.ny}x{sim.nx} mesh={n_dev}dev",
            (med, spread), "shard_map")


def main():
    quick = "--quick" in sys.argv
    for fn in (bench_poiseuille, bench_obstacle, bench_diffusion,
               bench_multifield, bench_porous_poisson_8192,
               bench_sharded_8192):
        name, result, backend = fn(quick)
        mlups, spread = result
        print(json.dumps({"config": name, "mlups": mlups,
                          "backend": backend, "spread": spread}), flush=True)


if __name__ == "__main__":
    main()
