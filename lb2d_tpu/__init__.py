"""lb2d_tpu — a 2-D lattice-Boltzmann framework in JAX/XLA.

A from-scratch rebuild of the capabilities of the ``LB_D2Q9`` reference
project (latticeboltzmann/2d-lb): D2Q9/D2Q25 BGK simulations with a
physical-units nondimensionalization layer, a model zoo (pipe flow, obstacle
flows, advection-diffusion, Fisher waves, multifield range expansion, LBM and
spectral Poisson solvers, Shan-Chen multicomponent / porous media), device-side
rendering, and multi-device domain decomposition over a device mesh.

Architecture: state is a pytree (populations ``f[Q, ny, nx]`` + aux fields);
each model builds a pure ``step(state) -> state`` that XLA fuses into a few
memory passes; ``run(n)`` is a donated-buffer ``lax.fori_loop`` — the host is
never inside the hot loop (unlike the reference's per-kernel blocking
dispatch, ``opencl_dim.py:372-387``).
"""

from .core.lattice import D2Q9, D2Q25, Lattice
from .core.nondim import DiffusionUnits, FlowUnits, diffusive_scaling, omega_from_lb_visc

__version__ = "0.1.0"

__all__ = [
    "D2Q9",
    "D2Q25",
    "Lattice",
    "FlowUnits",
    "DiffusionUnits",
    "diffusive_scaling",
    "omega_from_lb_visc",
]
