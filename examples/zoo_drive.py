"""Drive the ENTIRE model zoo end-to-end on the current device.

One construct -> run -> field-check pass over every model family the
framework (and the reference) ships, each on its XLA step. Prints a table
of backend + throughput.

Usage: python examples/zoo_drive.py [--steps 200] [--big]
  --big uses production-scale grids (a GPU recommended; runs a few
  minutes).
"""

import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def drive(name, build, steps, field="rho"):
    """Build a model, run `steps`, pull a field, report [name, backend,
    mlups, status]."""
    import gc

    import jax

    try:
        sim = build()
        backend = sim.backend
        sim.run(steps, timed=True)
        f = sim.get_fields()[field]
        ok = bool(np.isfinite(f).all())
        return [name, str(backend), f"{sim.last_mlups:.0f}",
                "ok" if ok else "NON-FINITE"]
    except Exception as e:  # keep driving the rest of the zoo
        traceback.print_exc()
        return [name, "-", "-", f"FAIL: {type(e).__name__}: {e}"]
    finally:
        # release device buffers + executables between models so the big
        # grids don't accumulate device memory across the whole zoo
        sim = None
        gc.collect()
        jax.clear_caches()


def main(steps=200, big=False):
    from lb2d_tpu import models as M

    n_flow = 1023 if big else 255
    n_diff = 341 if big else 63  # 2048^2 / 128^2 with the +2 ring
    d_lx = 0.61 if big else 0.21
    zoo = [
        ("PipeFlow", lambda: M.PipeFlow(
            N=n_flow, pipe_length=(n_flow + 0.5) / n_flow, diameter=1.0,
            rho=1.0, viscosity=1.0, pressure_grad=-10.0)),
        # N counts cells per cylinder DIAMETER here (characteristic
        # length), so the grid is ~5N x 5N: N=255 is already 2560^2
        ("PipeFlowCylinder", lambda: M.PipeFlowCylinder(
            N=255, pipe_length=1.0, diameter=1.0,
            rho=1.0, viscosity=1.0, pressure_grad=-10.0,
            cylinder_center=(0.5, 0.5), cylinder_radius=0.1)),
        ("PipeFlowVelocityInlet", lambda: M.PipeFlowVelocityInlet(
            u_w=0.05, omega=1.2, lx=n_flow, ly=n_flow)),
        ("LatticePipeFlow", lambda: M.LatticePipeFlow(
            omega=1.2, lx=n_flow, ly=n_flow, deltaP=-0.01)),
        # big: Lx/z = 6 with N=341 -> 2048^2
        ("Diffusion", lambda: M.Diffusion(
            Lx=d_lx, Ly=d_lx, z=0.1, N=n_diff)),
        ("AdvectionDiffusion", lambda: M.AdvectionDiffusion(
            Lx=d_lx, Ly=d_lx, z=0.1, N=n_diff, vx=1.0, vy=0.5, vc=1.0)),
        ("ReactionDiffusion", lambda: M.ReactionDiffusion(
            Lx=d_lx, Ly=d_lx, z=0.1, N=n_diff, g=1.0)),
        ("ReactionAdvectionDiffusion", lambda: M.ReactionAdvectionDiffusion(
            Lx=d_lx, Ly=d_lx, z=0.1, N=n_diff, g=1.0, vx=1.0, vy=1.0,
            vc=1.0)),
        ("ReactionAdvectionDiffusionStochastic",
         lambda: M.ReactionAdvectionDiffusionStochastic(
             Lx=d_lx, Ly=d_lx, z=0.1, N=n_diff, g=1.0, vx=1.0, vy=1.0,
             vc=1.0, Dg=0.05)),
        ("NoisyAdvectedFisherWave", lambda: M.NoisyAdvectedFisherWave(
            N=n_diff, z=0.1, Lx=d_lx, Ly=d_lx, D=1.0, g=10.0, Nc=10.0)),
        ("ScreenedFisherWave", lambda: M.ScreenedFisherWave(
            Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2,
            N=1024 if big else 48)),
        ("RepellingFisherWave", lambda: M.RepellingFisherWave(
            Lx=1.0, Ly=1.0, E=2.0, R0=0.25, N=128 if big else 24,
            max_inner_iter=60,
            # amortize the nested solve: reuse the converged potential
            # until mean |drho| drifts past 0.2% of mean rho
            reuse_tolerance=2e-3 if big else 0.0)),
        ("FisherExpansion", lambda: M.FisherExpansion(
            Lx=4.1, Ly=4.1, mu_standard=1.0, mu_list=[1.0, 0.8],
            D_standard=1.0, D_list=[1.0, 1.2], N=511 if big else 63,
            initial_frac_widths=[0.5, 0.5], initial_frac_indices=[0, 1])),
        ("Expansion", lambda: M.Expansion(
            Lx=4.1, Ly=4.1, mu_standard=1.0, mu_list=[1.0, 0.8],
            D_standard=1.0, D_list=[1.0, 1.2], N=511 if big else 63,
            Nb=10.0, Dc=1.0)),
        ("SurfactantNutrientWave", lambda: M.SurfactantNutrientWave(
            Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2, N=512 if big else 32)),
        ("ClumpySurfactantNutrientWave",
         lambda: M.ClumpySurfactantNutrientWave(
             Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2, N=512 if big else 32,
             rho_o=1.0, G_chen=-5.0)),
        ("RocketYeast", lambda: M.RocketYeast(
            Lx=1.0, Ly=1.0, R0=0.2, epsilon=0.05, Gc=2.0,
            N=1024 if big else 32, G_chen=-0.1)),
    ]

    rows = [drive(name, build, steps) for name, build in zoo]

    # solver families (no run(n) loop)
    try:
        n_p = 512 if big else 64
        solver = M.PoissonSolver(nx=n_p, ny=n_p,
                                 sources=np.ones((n_p, n_p)),
                                 delta_t=4e-4 * (64 / n_p) ** 2,
                                 delta_x=2.0 / n_p)
        solver.run(20000, timed=True)
        phi = solver.get_fields()["rho"]
        its = solver.num_iterations
        mlups = getattr(solver, "last_mlups", None)
        secs = getattr(solver, "last_solve_seconds", None)
        note = ("ok" if np.isfinite(phi).all() else "NON-FINITE")
        note += (f" ({int(its)} iters, {secs:.2f}s/solve,"
                 f" conv={solver.converged})")
        rows.append(["PoissonSolver", "while_loop",
                     f"{mlups:.0f}" if mlups else "-", note])
    except Exception as e:
        traceback.print_exc()
        rows.append(["PoissonSolver", "-", "-", f"FAIL: {e}"])
    try:
        phi, _, _ = M.screened_poisson_solve(
            np.ones((64, 64), np.float32), lam=1.0, dx=1.0)
        phi_r = np.real(np.asarray(phi))
        rows.append(["ScreenedPoisson", "spectral", "-",
                     "ok" if np.isfinite(phi_r).all() else "NON-FINITE"])
    except Exception as e:
        rows.append(["ScreenedPoisson", "-", "-", f"FAIL: {e}"])
    try:
        # the spinodal-decomposition notebook workload
        n_sc = 1024 if big else 128
        runner = M.SimulationRunner(nx=n_sc, ny=n_sc, L_lb=n_sc, T_lb=1.0,
                                    num_populations=2, porous=False)
        for i in range(2):
            runner.add_fluid(M.Fluid(runner, i, nu_e=1.0 / 6.0, epsilon=1.0))
        runner.complete_setup()
        rng = np.random.RandomState(1)
        base = 0.5 + 0.05 * rng.rand(runner.ny, runner.nx)
        runner.fluid_list[0].initialize(base)
        runner.fluid_list[1].initialize(1.0 - base)
        # G=1.8 linear is past the stable quench depth at >=512^2 (rho
        # overshoots negative and diverges); 1.5 demixes strongly and stays
        # finite at every size
        runner.add_interaction_force(0, 1, G_int=1.5, potential="linear")
        runner.run(steps, timed=True)
        rho = runner.get_fields()["rho"]
        rows.append([f"SimulationRunner (Shan-Chen x2) {n_sc}^2",
                     runner.backend_used,
                     f"{runner.last_mlups:.0f}",
                     "ok" if np.isfinite(rho).all() else "NON-FINITE"])
    except Exception as e:
        traceback.print_exc()
        rows.append(["SimulationRunner", "-", "-", f"FAIL: {e}"])

    import jax
    print(f"\n=== model zoo drive | backend={jax.default_backend()} "
          f"| steps={steps} | {'big' if big else 'small'} grids ===")
    print(f"{'model':38s} {'backend':16s} {'MLUPS':>8s}  status")
    failed = 0
    for name, backend, mlups, status in rows:
        print(f"{name:38s} {backend:16s} {mlups:>8s}  {status}")
        failed += not status.startswith("ok")
    print(f"\n{len(rows) - failed}/{len(rows)} families ok")
    return failed


if __name__ == "__main__":
    steps = 200
    if "--steps" in sys.argv:
        steps = int(sys.argv[sys.argv.index("--steps") + 1])
    sys.exit(main(steps, big="--big" in sys.argv))
