"""BASELINE config 5: porous 2-fluid flow with a per-step screened-Poisson
repulsion, sharded over the device mesh.

The workload composes the reference's two largest subsystems — the Guo
porous-media engine (``porous_media/single_component.py``) and the
spectral-repulsion coupling of the multicomponent runner
(``multicomponent_multiphase/multi.py:488-511``) — at a scale the
reference could not represent (8192^2 needs ~5 GB for f alone; its GPU
had 6 GB for everything, no multi-device support, fp64-only kernels).

Per step here: the multicomponent XLA step (stream + hydro + Shan-Chen
interaction + Darcy/Forchheimer drag + Guo-forced BGK), partitioned by
GSPMD when the mesh has several devices, plus one screened-Poisson solve
(``jnp.fft`` on one device, the matmul DFT on a multi-device mesh).

Usage: python examples/porous_poisson.py [--size 2048] [--steps 50]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(size=2048, steps=50):
    import jax

    from lb2d_tpu.models.multicomponent import Fluid, SimulationRunner
    from lb2d_tpu.parallel.sharded import make_mesh

    n_dev = len(jax.devices())
    mesh = make_mesh(n_dev, shape=(n_dev, 1))

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

    sim.run(steps, timed=True)
    rho = np.asarray(sim.rho)
    print(f"{size}^2 porous+poisson on a {n_dev}x1 mesh "
          f"({sim.backend_used} backend): {sim.last_mlups:.1f} MLUPS")
    print(f"mass: fluid0 {rho[0].sum():.6g}  fluid1 {rho[1].sum():.6g}  "
          f"finite: {np.isfinite(rho).all()}")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=2048)
    p.add_argument("--steps", type=int, default=50)
    a = p.parse_args()
    main(a.size, a.steps)
