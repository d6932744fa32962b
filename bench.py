"""Headline benchmark: MLUPS at 4096^2 D2Q9 pressure-driven pipe flow.

Times ``PipeFlow.run`` on an NVIDIA GPU (fails on any other platform) and
prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "spread",
"device"}. Baseline = 325 MLUPS, the reference pyOpenCL implementation on a
GTX Titan Black (reference README.md:6-7 /
python_cython_opencl_comparison.ipynb).
"""

import json
import sys

import jax

BASELINE_MLUPS = 325.0


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: needs an NVIDIA GPU; JAX found platform "
              f"{dev.platform!r}", file=sys.stderr)
        return 2

    from lb2d_tpu.models.pipe_flow import PipeFlow
    from lb2d_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    sim = PipeFlow(diameter=1.0, rho=1.0, viscosity=0.1, pressure_grad=-0.01,
                   pipe_length=1.0, N=4095)

    # Measurement protocol: warm (compile) outside the timed region, then
    # 7 timed run() calls ending in block_until_ready; report the MEDIAN
    # with min/max dispersion.
    n_meas, reps = 200, 7
    sim.run(n_meas, timed=True)
    rates = []
    for _ in range(reps):
        sim.run(n_meas, timed=True)
        rates.append(sim.last_mlups)
    if not bool(jax.numpy.isfinite(sim.state).all()):
        raise RuntimeError("non-finite state after benchmark")

    rates.sort()
    mlups = rates[len(rates) // 2]
    print(json.dumps({
        "metric": "MLUPS@4096^2 D2Q9 pipe flow",
        "value": mlups,
        "unit": "MLUPS",
        "vs_baseline": mlups / BASELINE_MLUPS,
        "spread": {"min": rates[0], "max": rates[-1], "reps": reps,
                   "steps_per_rep": n_meas},
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
