"""Backend comparison on the reference's exact benchmark workload.

Reproduces ``docs/python_cython_opencl_comparison.ipynb``:
``Pipe_Flow_Cylinder`` with D=1, rho=1, nu=1, dP/dx=-10, pipe = 3D,
cylinder r = D/10 at (0.75, 0.5), N=125 -> 3751 x 1251 = 4.693e6 cells,
1000 steps. Reference results on this workload: pure Python 0.50 MLUPS,
Cython 5.9 MLUPS, pyOpenCL (GTX Titan Black) 325 MLUPS.

Usage: python examples/backend_comparison.py [--steps 1000]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

PHYS = dict(diameter=1.0, rho=1.0, viscosity=1.0, pressure_grad=-10.0,
            pipe_length=3.0)
CYL = dict(cylinder_center=(0.75, 0.5), cylinder_radius=0.1)
REFERENCE = {"python (CPU)": 0.50, "cython (CPU)": 5.9,
             "pyOpenCL (GTX Titan Black)": 325.0}


def main(steps=1000):
    from lb2d_tpu.models import PipeFlowCylinder, PipeFlowObstacles, disk_mask

    rows = []

    # exact reference workload, XLA step
    sim = PipeFlowCylinder(N=125, time_prefactor=1.0, **PHYS, **CYL)
    print(f"exact workload grid {sim.nx}x{sim.ny} "
          f"({sim.nx * sim.ny / 1e6:.3f}M cells), backend={sim.backend}")
    sim.run(steps, timed=True)
    rows.append((f"lb2d_tpu {sim.backend} (exact grid)", sim.last_mlups))

    # about the same cell count on a round 3840x1280 grid (the
    # reference's ceil() grid is 3751x1251)
    ny, nx = 1280, 3840
    mask = disk_mask(nx, ny, cx=nx // 4, cy=ny // 2, radius=ny // 10)
    sim2 = PipeFlowObstacles(obstacle_mask=mask, N=ny - 1,
                             pipe_length=(nx - 1.5) / (ny - 1) * 1.0,
                             diameter=1.0, rho=1.0, viscosity=1.0,
                             pressure_grad=-10.0)
    print(f"round workload grid {sim2.nx}x{sim2.ny} "
          f"({sim2.nx * sim2.ny / 1e6:.3f}M cells), backend={sim2.backend}")
    sim2.run(steps, timed=True)
    rows.append((f"lb2d_tpu {sim2.backend} (3840x1280 grid)", sim2.last_mlups))

    # native C++ CPU backend on a reduced copy (CPU-speed)
    try:
        sim3 = PipeFlowCylinder(N=50, time_prefactor=1.0, backend="native",
                                **PHYS, **CYL)
        sim3.run(max(50, steps // 10), timed=True)
        rows.append(("lb2d_tpu native C++ (CPU)", sim3.last_mlups))
    except Exception as e:
        print("native backend unavailable:", e)

    print("\n=== MLUPS on the reference benchmark workload ===")
    for name, val in REFERENCE.items():
        print(f"{name:42s} {val:10.1f}")
    for name, val in rows:
        print(f"{name:42s} {val:10.1f}")


if __name__ == "__main__":
    steps = 1000
    if "--steps" in sys.argv:
        steps = int(sys.argv[sys.argv.index("--steps") + 1])
    main(steps)
