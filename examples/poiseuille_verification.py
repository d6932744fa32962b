"""Poiseuille verification: profile vs theory + resolution convergence.

Script version of the reference's
``docs/opencl_dimensionless_verification.ipynb``: run the same pipe at
N = 10/50/200 to the same dimensionless time, overlay the mean velocity
profile against ``(dP/dx / 2 rho nu) y (y - D)`` and plot RMS error vs N.

Usage: python examples/poiseuille_verification.py [out.png]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from lb2d_tpu.models import PipeFlow

PARAMS = dict(diameter=1.5, rho=10.0, viscosity=5.0, pressure_grad=-100.0,
              pipe_length=3.0)


def run(N, time_to_run=10.0):
    sim = PipeFlow(N=N, time_prefactor=1.0, **PARAMS)
    sim.run(int(time_to_run / sim.units.delta_t), timed=True)
    fields = sim.get_physical_fields()
    mean_u = fields["u"].T.mean(axis=1)
    y = np.arange(mean_u.shape[0]) * sim.units.delta_x * sim.units.L
    return sim, y, mean_u


def main(out="poiseuille_verification.png"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    D, rho, nu = PARAMS["diameter"], PARAMS["rho"], PARAMS["viscosity"]
    pref = PARAMS["pressure_grad"] / (2 * rho * nu)

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    errors, Ns = [], [10, 50, 200]
    for N in Ns:
        sim, y, mean_u = run(N)
        pred = pref * y * (y - D)
        rms = float(np.sqrt(((mean_u - pred) ** 2).mean()))
        errors.append(rms)
        ax1.plot(y, mean_u, ".", ms=3, label=f"N={N}")
        print(f"N={N}: omega={sim.omega:.5f} rms={rms:.2e}")
    yy = np.linspace(0, D, 200)
    ax1.plot(yy, pref * yy * (yy - D), "k-", lw=1, label="theory")
    ax1.set_xlabel("y [m]")
    ax1.set_ylabel("u [m/s]")
    ax1.legend()
    ax1.set_title("Poiseuille profile vs theory")

    ax2.loglog(Ns, errors, "o-")
    ax2.set_xlabel("N")
    ax2.set_ylabel("RMS error [m/s]")
    ax2.set_title("Resolution convergence")
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    print(f"wrote {out}")


if __name__ == "__main__":
    main(*sys.argv[1:])
