"""Plain numpy reference of the D2Q9 pipe-flow step.

An independent implementation of the reference's algorithm: a bounds-checked
scatter stream into a second buffer (stale entries persist, as in the
reference's two-buffer ``move``, ``D2Q9.cl:139-171``), the snapshot Zou-He
pressure BC kernel (``D2Q9.cl:173-261`` / ``D2Q9i.cl:173-261``), obstacle
bounce-back (``D2Q9.cl:398-433``), moments, feq and BGK. It shares no code
with the JAX step, so it is the oracle the XLA path is checked against, in
the tests and on the card (``chip_smoke.py``).
"""

from __future__ import annotations

import numpy as np

from ..core.lattice import D2Q9

__all__ = ["numpy_pipe_step"]


def _stream_scatter(f):
    q, ny, nx = f.shape
    out = f.copy()  # stale entries persist, as in the reference buffer
    for j in range(q):
        cx, cy = D2Q9.cx[j], D2Q9.cy[j]
        src_y = slice(max(0, -cy), ny - max(0, cy))
        src_x = slice(max(0, -cx), nx - max(0, cx))
        dst_y = slice(max(0, cy), ny + min(0, cy))
        dst_x = slice(max(0, cx), nx + min(0, cx))
        out[j, dst_y, dst_x] = f[j, src_y, src_x]
    return out


def _pressure_bcs(f, inlet_rho, outlet_rho, incompressible):
    s = f.copy()
    si, so = s[:, 1:-1, 0], s[:, 1:-1, -1]
    if incompressible:
        u = (-si[0] - si[2] - 2 * si[3] - si[4] - 2 * si[6] - 2 * si[7]
             + inlet_rho)
        f[1, 1:-1, 0] = (3 * si[3] + 2 * u) / 3
        f[5, 1:-1, 0] = (-3 * si[2] + 3 * si[4] + 6 * si[7] + u) / 6
        f[8, 1:-1, 0] = (3 * si[2] - 3 * si[4] + 6 * si[6] + u) / 6
        u = (so[0] + 2 * so[1] + so[2] + so[4] + 2 * so[5] + 2 * so[8]
             - outlet_rho)
        f[3, 1:-1, -1] = (3 * so[1] - 2 * u) / 3
        f[6, 1:-1, -1] = (-3 * so[2] + 3 * so[4] + 6 * so[8] - u) / 6
        f[7, 1:-1, -1] = (3 * so[2] - 3 * so[4] + 6 * so[5] - u) / 6
    else:
        u = -((si[0] + si[2] + 2 * si[3] + si[4] + 2 * si[6] + 2 * si[7]
               - inlet_rho) / inlet_rho)
        f[1, 1:-1, 0] = si[3] + (2 / 3) * inlet_rho * u
        f[5, 1:-1, 0] = (-0.5 * si[2] + 0.5 * si[4] + si[7]
                         + (1 / 6) * u * inlet_rho)
        f[8, 1:-1, 0] = (0.5 * si[2] - 0.5 * si[4] + si[6]
                         + (1 / 6) * u * inlet_rho)
        u = -1 + (so[0] + 2 * so[1] + so[2] + so[4] + 2 * so[5]
                  + 2 * so[8]) / outlet_rho
        f[3, 1:-1, -1] = so[1] - (2 / 3) * outlet_rho * u
        f[6, 1:-1, -1] = (-0.5 * so[2] + 0.5 * so[4] + so[8]
                          - (1 / 6) * u * outlet_rho)
        f[7, 1:-1, -1] = (0.5 * so[2] - 0.5 * so[4] + so[5]
                          - (1 / 6) * u * outlet_rho)
    # north / south walls
    sn, ss = s[:, -1, 1:-1], s[:, 0, 1:-1]
    f[4, -1, 1:-1] = sn[2]
    f[8, -1, 1:-1] = 0.5 * (-sn[1] + sn[3] + 2 * sn[6])
    f[7, -1, 1:-1] = 0.5 * (sn[1] - sn[3] + 2 * sn[5])
    f[2, 0, 1:-1] = ss[4]
    f[6, 0, 1:-1] = 0.5 * (ss[1] - ss[3] + 2 * ss[8])
    f[5, 0, 1:-1] = 0.5 * (-ss[1] + ss[3] + 2 * ss[7])
    # corners
    c = s[:, 0, 0]
    f[1, 0, 0], f[2, 0, 0], f[5, 0, 0] = c[3], c[4], c[7]
    f[6, 0, 0] = f[8, 0, 0] = 0.5 * (-c[0] - 2 * c[3] - 2 * c[4] - 2 * c[7]
                                     + inlet_rho)
    c = s[:, -1, 0]
    f[1, -1, 0], f[4, -1, 0], f[8, -1, 0] = c[3], c[2], c[6]
    f[5, -1, 0] = f[7, -1, 0] = 0.5 * (-c[0] - 2 * c[2] - 2 * c[3]
                                       - 2 * c[6] + inlet_rho)
    c = s[:, 0, -1]
    f[3, 0, -1], f[2, 0, -1], f[6, 0, -1] = c[1], c[4], c[8]
    f[5, 0, -1] = f[7, 0, -1] = 0.5 * (-c[0] - 2 * c[1] - 2 * c[4]
                                       - 2 * c[8] + outlet_rho)
    c = s[:, -1, -1]
    f[3, -1, -1], f[4, -1, -1], f[7, -1, -1] = c[1], c[2], c[5]
    f[6, -1, -1] = f[8, -1, -1] = 0.5 * (-c[0] - 2 * c[1] - 2 * c[2]
                                         - 2 * c[5] + outlet_rho)
    return f


def numpy_pipe_step(f, omega, inlet_rho, outlet_rho, incompressible=False,
                    mask=None):
    """One D2Q9 pipe-flow step on ``f[9, ny, nx]`` in the input's dtype.

    ``incompressible`` selects the He-Luo variant (``D2Q9i.cl``), whose
    driver also zeroes the velocity inside the obstacle
    (``opencl_dim_D2Q9i.py:494-502``). ``mask`` is an optional boolean
    ``[ny, nx]`` obstacle: full bounce-back inside it after the wall BCs.
    """
    dt = f.dtype
    f = _stream_scatter(f)
    f = _pressure_bcs(f, dt.type(inlet_rho), dt.type(outlet_rho),
                      incompressible)
    if mask is not None:
        mask = np.asarray(mask, bool)
        f = np.where(mask[None], f[np.asarray(D2Q9.opp)], f)
    cx = np.array(D2Q9.cx, dtype=dt)[:, None, None]
    cy = np.array(D2Q9.cy, dtype=dt)[:, None, None]
    w = np.array(D2Q9.w, dtype=dt)[:, None, None]
    cs2 = dt.type(D2Q9.cs2)
    rho = f.sum(axis=0)
    u = (cx * f).sum(axis=0)
    v = (cy * f).sum(axis=0)
    if not incompressible:
        u, v = u / rho, v / rho
    elif mask is not None:
        u = np.where(mask, 0, u)
        v = np.where(mask, 0, v)
    cu = cx * u + cy * v
    quad = cu / cs2 + cu * cu / (2 * cs2 * cs2) - (u * u + v * v) / (2 * cs2)
    feq = w * (rho + quad) if incompressible else w * rho * (1 + quad)
    omega = dt.type(omega)
    return f * (1 - omega) + omega * feq
