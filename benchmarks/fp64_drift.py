"""Quantify fp32 drift of the porous/multicomponent engine vs an fp64
oracle (the reference hard-requires fp64 here, ``single_component.cl:1-7``;
this framework runs fp32 by default).

Runs the reference-like workload (porous 2-fluid + first-belt Shan-Chen +
eating) twice on CPU — once fp64 (``JAX_ENABLE_X64=1`` subprocess), once
fp32 — through the same XLA step, and reports relative rho drift and mass
conservation at log-spaced horizons.

- ``--c5`` swaps the composition to BASELINE config 5 (porous 2-fluid +
  Shan-Chen + screened-Poisson repulsion force, no eating) so the drift
  is measured on that workload, at any ``--size``.
- ``--conservation`` runs fp32 ONLY, on the default device, and tracks
  the global mass of each fluid with
  :func:`lb2d_tpu.utils.metrics.accumulated_sum(accumulate="f64")` —
  config-5 physics conserves mass exactly (BGK + Guo forcing + streaming
  are all zero-mass-source), so the reported relative drifts ARE the
  engine's fp32 conservation error at production scale, no fp64 oracle
  run needed (the oracle mode stays CPU-bound to small grids/horizons).

Usage: python benchmarks/fp64_drift.py [--steps 10000] [--size 128]
           [--c5] [--conservation]
       (internal: --worker <dtype> <out.npz>)
"""
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

CHECKPOINTS = (100, 300, 1000, 3000, 10000)


def build_sim(size):
    import numpy as np
    from lb2d_tpu.models.multicomponent import Fluid, SimulationRunner

    c5 = os.environ.get("DRIFT_C5", "0") == "1"
    sim = SimulationRunner(nx=size, ny=size, L_lb=size, T_lb=1.0,
                           num_populations=2, porous=True)
    for i in range(2):
        sim.add_fluid(Fluid(sim, i, nu_e=1.0 / 6.0, epsilon=0.8,
                            nu_fluid=1.0 / 6.0, K=10.0, Fe=0.1))
    sim.complete_setup()
    rng = np.random.RandomState(0)
    base = 0.5 + 0.05 * rng.rand(size, size)  # float64 host init
    sim.fluid_list[0].initialize(base)
    sim.fluid_list[1].initialize(1.0 - base)
    sim.add_interaction_force(0, 1, G_int=1.5, potential="shan_chen",
                              potential_parameters=[1.0])
    if c5:
        # BASELINE config-5 composition (benchmarks/c5_one.py)
        sim.add_screened_poisson_force(0, 1, interaction_length=10.0,
                                       amplitude=1e-4, precision="highest")
    else:
        sim.add_eating_rate(0, 1, 1e-4)
    return sim


def conservation(size, steps):
    """fp32-only production-scale run: per-fluid mass drift via the
    fp64-grade accumulator (mass is exactly conserved by the physics)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from lb2d_tpu.utils.metrics import accumulated_sum

    _CACHE = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".jax_cache")
    try:
        jax.config.update("jax_compilation_cache_dir", _CACHE)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)
    except Exception:
        pass

    sim = build_sim(size)

    def masses():
        # sum over directions+fields via per-fluid rho is refreshed by
        # get-style access; use f directly: f[dir, field, y, x]
        f = sim.f
        return [accumulated_sum(jnp.sum(f[:, i], axis=0), "f64")
                for i in range(2)]

    m0 = masses()
    print(json.dumps({"steps": 0, "mass": m0, "total": sum(m0),
                      "size": size}), flush=True)
    done = 0
    for cp in [c for c in CHECKPOINTS if c <= steps]:
        sim.run(cp - done)
        done = cp
        m = masses()
        # Per-fluid drift is the conservation error ONLY for --c5
        # (no eating: BGK + Guo forcing + streaming are zero-mass-source
        # per fluid); with eating on, per-fluid mass moves by physics and
        # only the TOTAL is conserved.
        drift = [abs(a - b) / abs(b) for a, b in zip(m, m0)]
        tdrift = abs(sum(m) - sum(m0)) / abs(sum(m0))
        print(json.dumps({"steps": cp, "mass": m,
                          "mass_rel_drift": [float(f"{d:.3e}")
                                             for d in drift],
                          "total_rel_drift": float(f"{tdrift:.3e}"),
                          "backend": sim.backend_used,
                          "size": size}), flush=True)


def worker(out_path, steps):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    size = int(os.environ.get("DRIFT_SIZE", "128"))
    sim = build_sim(size)
    print(f"worker dtype={sim.dtype}", flush=True)
    out = {}
    done = 0
    for cp in [c for c in CHECKPOINTS if c <= steps]:
        sim.run(cp - done)
        done = cp
        out[f"rho_{cp}"] = np.asarray(sim.rho, np.float64)
    np.savez(out_path, **out)


def main():
    steps = 10000
    size = 128
    if "--steps" in sys.argv:
        steps = int(sys.argv[sys.argv.index("--steps") + 1])
    if "--size" in sys.argv:
        size = int(sys.argv[sys.argv.index("--size") + 1])
    if "--c5" in sys.argv:
        os.environ["DRIFT_C5"] = "1"
    if "--conservation" in sys.argv:
        conservation(size, steps)
        return

    import numpy as np

    here = os.path.abspath(__file__)
    env = dict(os.environ, DRIFT_SIZE=str(size), JAX_PLATFORMS="cpu",
               DRIFT_C5=os.environ.get("DRIFT_C5", "0"))
    paths = {}
    for dt, x64 in (("fp64", "1"), ("fp32", "0")):
        out = f"/tmp/drift_{dt}.npz"
        e = dict(env, JAX_ENABLE_X64=x64)
        subprocess.run([sys.executable, here, "--worker", out,
                        "--steps", str(steps)], env=e, check=True)
        paths[dt] = out

    a = np.load(paths["fp64"])
    b = np.load(paths["fp32"])
    mass0 = None
    for cp in [c for c in CHECKPOINTS if c <= steps]:
        r64, r32 = a[f"rho_{cp}"], b[f"rho_{cp}"]
        scale = np.abs(r64).max()
        drift = np.abs(r64 - r32).max() / scale
        l2 = np.sqrt(np.mean((r64 - r32) ** 2)) / scale
        if mass0 is None:
            mass0 = r64.sum()
        mass_err = abs(r32.sum() - r64.sum()) / abs(r64.sum())
        print(json.dumps({"steps": cp, "max_rel_drift": float(f"{drift:.3e}"),
                          "l2_rel_drift": float(f"{l2:.3e}"),
                          "mass_rel_err": float(f"{mass_err:.3e}"),
                          "size": size}))


if __name__ == "__main__":
    if "--worker" in sys.argv:
        i = sys.argv.index("--worker")
        worker(sys.argv[i + 1], int(sys.argv[sys.argv.index("--steps") + 1]))
    else:
        main()
