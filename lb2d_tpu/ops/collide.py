"""Collision operators.

:func:`bgk` is the single-relaxation-time collision every reference model
shares (``D2Q9.cl:102-121``): ``f <- f (1 - omega) + omega feq``.
Reaction/noise source terms (Fisher growth, Milstein noise, Guo forcing) are
composed on top of this by the model step functions — the reference's
"registry of additional collision kernels"
(``porous_media/single_component.py:334-335``) survives here as plain
function composition inside one fused XLA program.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.lattice import D2Q9

__all__ = ["bgk", "moments_feq_collide"]


def bgk(f: jnp.ndarray, feq: jnp.ndarray, omega) -> jnp.ndarray:
    """BGK relaxation toward equilibrium (``D2Q9.cl:119``).

    ``omega`` may be a python float, a scalar, or an ``[Q]``/``[fields]``
    broadcastable array (per-population omegas,
    ``D2Q9_multifield_fisher.cl:103``).
    """
    omega = jnp.asarray(omega, f.dtype)
    return f * (1.0 - omega) + omega * feq


def moments_feq_collide(st, mask, omega, incompressible):
    """Bounce-back (optional) + moments + feq + BGK on a list of 9 streamed
    D2Q9 planes (the plane form of the flow family's step after its BCs).
    Returns the post-collision planes. The incompressible variant zeroes
    the velocity inside the obstacle, as its driver does
    (``opencl_dim_D2Q9i.py:494-502``).

    Arithmetic is shared across opposite-direction pairs (Succi-style
    factoring, cf. ``python_dim.py:151-180``): each axis
    ``a in {u, v, u+v, u-v}`` contributes ``quad_+- = 4.5 a^2 - 1.5|u|^2
    +- 3a`` to a +/- direction pair, roughly halving the arithmetic of the
    naive per-direction form.
    """
    cs2 = D2Q9.cs2

    if mask is not None:
        # bounce-back reads the post-BC snapshot (D2Q9.cl:398-433)
        s2 = tuple(st)
        for j in range(D2Q9.q):
            st[j] = jnp.where(mask, s2[D2Q9.opp[j]], st[j])

    f0, f1, f2, f3, f4, f5, f6, f7, f8 = st
    rho = ((f1 + f3) + (f2 + f4)) + ((f5 + f7) + (f6 + f8)) + f0
    d13 = f1 - f3
    d24 = f2 - f4
    d57 = f5 - f7
    d68 = f6 - f8
    jx = d13 + d57 - d68
    jy = d24 + d57 + d68
    if incompressible:
        u, v = jx, jy
    else:
        inv = 1.0 / rho
        u, v = jx * inv, jy * inv
    if mask is not None and incompressible:
        u = jnp.where(mask, 0.0, u)
        v = jnp.where(mask, 0.0, v)

    s = (u * u + v * v) * (0.5 / cs2)      # |u|^2 / (2 cs^2)
    inv_cs2 = 1.0 / cs2
    half_cs4 = 0.5 / (cs2 * cs2)

    def quad_pair(a):
        t1 = a * inv_cs2
        r = a * a * half_cs4 - s
        return r + t1, r - t1

    q1, q3 = quad_pair(u)
    q2, q4 = quad_pair(v)
    q5, q7 = quad_pair(u + v)
    q8, q6 = quad_pair(u - v)
    q0 = -s

    om = omega
    A = 1.0 - om
    if incompressible:
        # feq_j = w_j (rho + quad_j) (D2Q9i.cl:55-60)
        def relax(f, wj, qj):
            return f * A + (om * wj) * (rho + qj)
    else:
        # feq_j = w_j rho (1 + quad_j) (D2Q9.cl:55-60)
        wr = {}

        def relax(f, wj, qj):
            key = wj
            if key not in wr:
                wr[key] = (om * wj) * rho
            base = wr[key]
            return f * A + base + base * qj

    w0, w1, w2 = 4.0 / 9.0, 1.0 / 9.0, 1.0 / 36.0
    return [
        relax(f0, w0, q0),
        relax(f1, w1, q1), relax(f2, w1, q2),
        relax(f3, w1, q3), relax(f4, w1, q4),
        relax(f5, w2, q5), relax(f6, w2, q6),
        relax(f7, w2, q7), relax(f8, w2, q8),
    ]

