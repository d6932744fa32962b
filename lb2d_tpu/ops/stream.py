"""Streaming (propagation) operators.

The reference streams with a bounds-checked scatter into a second buffer plus
a full copy-back (``D2Q9.cl:139-171`` + ``copy_buffer``, driven at
``opencl_dim.py:339-353``). Here we stream functionally with periodic rolls:

For every entry the non-wrapping reference move leaves stale (populations
entering through a domain edge), the reference's ``move_bcs`` kernel
(``D2Q9.cl:173-261``) rewrites the value before it is ever read — so a
periodic roll followed by the same BC rewrite is *exactly* equivalent to the
reference's two-buffer scheme, with no second buffer and no copy pass.
Models with genuinely periodic edges (``move_periodic``,
``single_component.cl:337-377``) use the roll as-is.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.lattice import Lattice, D2Q9

__all__ = ["stream"]


def stream(f: jnp.ndarray, lattice: Lattice = D2Q9) -> jnp.ndarray:
    """Advect each population along its lattice velocity (periodic wrap).

    Args:
      f: populations, shape ``[Q, ny, nx]`` (axis order: direction, y, x).
      lattice: velocity-set descriptor.

    Returns:
      streamed populations, same shape: ``out[j, y, x] = f[j, y-cy_j, x-cx_j]``.
    """
    planes = []
    for j in range(lattice.q):
        cx, cy = lattice.cx[j], lattice.cy[j]
        p = f[j]
        if cy != 0:
            p = jnp.roll(p, cy, axis=0)
        if cx != 0:
            p = jnp.roll(p, cx, axis=1)
        planes.append(p)
    return jnp.stack(planes)
