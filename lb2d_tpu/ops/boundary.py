"""Boundary-condition operators for the flow family.

Each function reproduces one of the reference's in-place boundary kernels as a
functional update. The kernels read a per-cell snapshot of all 9 populations
before writing (``D2Q9.cl:187-195``), so every formula below is evaluated on
the *pre-update* ``f`` and applied with disjoint ``.at`` slice writes.

Axis convention: ``f[Q, ny, nx]``; ``x = 0`` is the inlet column,
``x = nx-1`` the outlet, ``y = 0`` south wall, ``y = ny-1`` north wall.

BCs run **after** streaming (``opencl_dim.py:380-387``) and rewrite exactly
the populations a non-wrapping stream cannot supply, which is what makes the
periodic-roll stream in :mod:`lb2d_tpu.ops.stream` equivalent to the
reference's bounds-checked scatter.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.lattice import Lattice, D2Q9

__all__ = [
    "zou_he_pressure_bcs",
    "zou_he_pressure_bcs_incompressible",
    "zou_he_velocity_bcs",
    "zou_he_velocity_inlet_open_outlet",
    "bounce_back_obstacle",
    "zou_he_pressure_masked",
    "noflux_walls_masked",
]


def zou_he_pressure_bcs(
    f: jnp.ndarray, inlet_rho: float, outlet_rho: float
) -> jnp.ndarray:
    """Pressure inlet/outlet + solid top/bottom walls + the 4 corner nodes,
    exactly as ``D2Q9.cl:173-261`` (``move_bcs``).
    """
    dt = f.dtype
    inlet_rho = jnp.asarray(inlet_rho, dt)
    outlet_rho = jnp.asarray(outlet_rho, dt)

    # --- inlet column x=0, interior rows (D2Q9.cl:198-203) ------------------
    s = f[:, 1:-1, 0]  # snapshot, shape [9, ny-2]
    u_in = -((s[0] + s[2] + 2 * s[3] + s[4] + 2 * s[6] + 2 * s[7] - inlet_rho)
             / inlet_rho)
    in1 = s[3] + (2.0 / 3.0) * inlet_rho * u_in
    in5 = -0.5 * s[2] + 0.5 * s[4] + s[7] + (1.0 / 6.0) * u_in * inlet_rho
    in8 = 0.5 * s[2] - 0.5 * s[4] + s[6] + (1.0 / 6.0) * u_in * inlet_rho

    # --- outlet column x=nx-1 (D2Q9.cl:205-210) ------------------------------
    s = f[:, 1:-1, -1]
    u_out = -1.0 + (s[0] + 2 * s[1] + s[2] + s[4] + 2 * s[5] + 2 * s[8]) / outlet_rho
    out3 = s[1] - (2.0 / 3.0) * outlet_rho * u_out
    out6 = -0.5 * s[2] + 0.5 * s[4] + s[8] - (1.0 / 6.0) * u_out * outlet_rho
    out7 = 0.5 * s[2] - 0.5 * s[4] + s[5] - (1.0 / 6.0) * u_out * outlet_rho

    f = f.at[1, 1:-1, 0].set(in1).at[5, 1:-1, 0].set(in5).at[8, 1:-1, 0].set(in8)
    f = f.at[3, 1:-1, -1].set(out3).at[6, 1:-1, -1].set(out6).at[7, 1:-1, -1].set(out7)

    # Walls + corners (D2Q9.cl:212-259) touch only cells disjoint from the
    # inlet/outlet writes above, so applying them second matches the
    # reference's single-snapshot kernel semantics exactly.
    return _walls_and_corners(f, inlet_rho, outlet_rho)


def zou_he_pressure_bcs_incompressible(
    f: jnp.ndarray, inlet_rho: float, outlet_rho: float
) -> jnp.ndarray:
    """He-Luo incompressible variant of :func:`zou_he_pressure_bcs`
    (``D2Q9i.cl:173-261``): inlet/outlet velocities are momenta (no division
    by density); walls and corners coincide with the compressible kernel.
    """
    dt = f.dtype
    inlet_rho = jnp.asarray(inlet_rho, dt)
    outlet_rho = jnp.asarray(outlet_rho, dt)

    # inlet (D2Q9i.cl:194-199)
    s = f[:, 1:-1, 0]
    u_in = -s[0] - s[2] - 2 * s[3] - s[4] - 2 * s[6] - 2 * s[7] + inlet_rho
    in1 = (1.0 / 3.0) * (3 * s[3] + 2 * u_in)
    in5 = (1.0 / 6.0) * (-3 * s[2] + 3 * s[4] + 6 * s[7] + u_in)
    in8 = (1.0 / 6.0) * (3 * s[2] - 3 * s[4] + 6 * s[6] + u_in)

    # outlet (D2Q9i.cl:201-206)
    s = f[:, 1:-1, -1]
    u_out = s[0] + 2 * s[1] + s[2] + s[4] + 2 * s[5] + 2 * s[8] - outlet_rho
    out3 = (1.0 / 3.0) * (3 * s[1] - 2 * u_out)
    out6 = (1.0 / 6.0) * (-3 * s[2] + 3 * s[4] + 6 * s[8] - u_out)
    out7 = (1.0 / 6.0) * (3 * s[2] - 3 * s[4] + 6 * s[5] - u_out)

    f = f.at[1, 1:-1, 0].set(in1).at[5, 1:-1, 0].set(in5).at[8, 1:-1, 0].set(in8)
    f = f.at[3, 1:-1, -1].set(out3).at[6, 1:-1, -1].set(out6).at[7, 1:-1, -1].set(out7)

    # walls + corners are identical to the compressible kernel
    # (D2Q9i.cl:209-257 == D2Q9.cl:212-259); reuse its wall/corner section by
    # re-deriving on the current snapshot, which the reference also does (each
    # work-item touches a single cell, regions are disjoint).
    return _walls_and_corners(f, inlet_rho, outlet_rho)


def _walls_and_corners(f, inlet_rho, outlet_rho):
    """Solid north/south walls + 4 corner nodes (``D2Q9.cl:212-259``)."""
    s = f[:, -1, 1:-1]
    n4 = s[2]
    n8 = 0.5 * (-s[1] + s[3] + 2 * s[6])
    n7 = 0.5 * (s[1] - s[3] + 2 * s[5])
    s_ = f[:, 0, 1:-1]
    s2 = s_[4]
    s6 = 0.5 * (s_[1] - s_[3] + 2 * s_[8])
    s5 = 0.5 * (-s_[1] + s_[3] + 2 * s_[7])

    c = f[:, 0, 0]
    bi = (c[3], c[4], c[7], 0.5 * (-c[0] - 2 * c[3] - 2 * c[4] - 2 * c[7] + inlet_rho))
    c = f[:, -1, 0]
    ti = (c[3], c[2], c[6], 0.5 * (-c[0] - 2 * c[2] - 2 * c[3] - 2 * c[6] + inlet_rho))
    c = f[:, 0, -1]
    bo = (c[1], c[4], c[8], 0.5 * (-c[0] - 2 * c[1] - 2 * c[4] - 2 * c[8] + outlet_rho))
    c = f[:, -1, -1]
    to = (c[1], c[2], c[5], 0.5 * (-c[0] - 2 * c[1] - 2 * c[2] - 2 * c[5] + outlet_rho))

    f = f.at[4, -1, 1:-1].set(n4).at[8, -1, 1:-1].set(n8).at[7, -1, 1:-1].set(n7)
    f = f.at[2, 0, 1:-1].set(s2).at[6, 0, 1:-1].set(s6).at[5, 0, 1:-1].set(s5)
    f = (f.at[1, 0, 0].set(bi[0]).at[2, 0, 0].set(bi[1]).at[5, 0, 0].set(bi[2])
          .at[6, 0, 0].set(bi[3]).at[8, 0, 0].set(bi[3]))
    f = (f.at[1, -1, 0].set(ti[0]).at[4, -1, 0].set(ti[1]).at[8, -1, 0].set(ti[2])
          .at[5, -1, 0].set(ti[3]).at[7, -1, 0].set(ti[3]))
    f = (f.at[3, 0, -1].set(bo[0]).at[2, 0, -1].set(bo[1]).at[6, 0, -1].set(bo[2])
          .at[5, 0, -1].set(bo[3]).at[7, 0, -1].set(bo[3]))
    f = (f.at[3, -1, -1].set(to[0]).at[4, -1, -1].set(to[1]).at[7, -1, -1].set(to[2])
          .at[6, -1, -1].set(to[3]).at[8, -1, -1].set(to[3]))
    return f


def zou_he_velocity_bcs(f: jnp.ndarray, u_w: float, u_e: float) -> jnp.ndarray:
    """Velocity inlet/outlet with periodic top/bottom walls
    (``move_bcs_PeriodicBC_VelocityInlet``, ``D2Q9.cl:263-321``): imposed
    x-velocity ``u_w`` on the west column and ``u_e`` on the east column.

    Divergence from the reference kernel (wrap-compatibility rewrite): the
    reference pairs this BC with a *non-wrapping* scatter, so (a) its
    north/south rows copy the y-incoming populations from the opposite wall
    to emulate the periodic wrap, and (b) the four corner cells receive no
    BC at all (they keep stale pre-move values). Our streaming wraps
    natively, making (a) redundant — the wrap IS the periodic wall — while
    (b) would let outlet populations wrapped around the x-axis feed back
    into the inlet corners (unstable). We therefore drop the y-copies and
    apply the inlet/outlet formulas on the FULL columns, which rewrites
    exactly the x-wrapped populations everywhere.
    """
    dt = f.dtype
    u_w = jnp.asarray(u_w, dt)
    u_e = jnp.asarray(u_e, dt)

    # inlet x=0, full column (D2Q9.cl:291-296 formulas)
    s = f[:, :, 0]
    rho_w = (1.0 / (1.0 - u_w)) * (s[0] + s[2] + s[4] + 2 * (s[3] + s[6] + s[7]))
    in1 = s[3] + (2.0 / 3.0) * rho_w * u_w
    in5 = s[7] - 0.5 * (s[2] - s[4]) + (1.0 / 6.0) * rho_w * u_w
    in8 = s[6] + 0.5 * (s[2] - s[4]) + (1.0 / 6.0) * rho_w * u_w

    # outlet x=nx-1, full column (D2Q9.cl:298-303 formulas)
    s = f[:, :, -1]
    rho_e = (1.0 / (1.0 + u_e)) * (s[0] + s[2] + s[4] + 2 * (s[1] + s[5] + s[8]))
    out3 = s[1] - (2.0 / 3.0) * rho_e * u_e
    out6 = s[5] + 0.5 * (s[2] - s[4]) - (1.0 / 6.0) * rho_e * u_e
    out7 = s[8] - 0.5 * (s[2] - s[4]) - (1.0 / 6.0) * rho_e * u_e

    f = f.at[1, :, 0].set(in1).at[5, :, 0].set(in5).at[8, :, 0].set(in8)
    f = f.at[3, :, -1].set(out3).at[6, :, -1].set(out6).at[7, :, -1].set(out7)
    return f


def zou_he_velocity_inlet_open_outlet(f: jnp.ndarray, u_w: float) -> jnp.ndarray:
    """Zou-He velocity inlet (west) + zero-gradient open outflow (east),
    periodic top/bottom.

    The reference's velocity-velocity pair (``D2Q9.cl:263-321``) is
    *linearly unstable* — its own notebooks blow up within ~150 steps (see
    DIVERGENCES.md #20/#21) — so this is the working formulation of the
    inlet-driven-flow experiments those notebooks attempt: the outlet's
    domain-entering populations are copied from the neighboring column
    (same zero-gradient closure the multicomponent engine uses,
    ``single_component.py`` ``zero_gradient`` BC).
    """
    dt = f.dtype
    u_w = jnp.asarray(u_w, dt)

    s = f[:, :, 0]
    rho_w = (1.0 / (1.0 - u_w)) * (s[0] + s[2] + s[4] + 2 * (s[3] + s[6] + s[7]))
    in1 = s[3] + (2.0 / 3.0) * rho_w * u_w
    in5 = s[7] - 0.5 * (s[2] - s[4]) + (1.0 / 6.0) * rho_w * u_w
    in8 = s[6] + 0.5 * (s[2] - s[4]) + (1.0 / 6.0) * rho_w * u_w
    f = f.at[1, :, 0].set(in1).at[5, :, 0].set(in5).at[8, :, 0].set(in8)
    # outlet: normal-gradient-free copy of the upstream column
    for j in (3, 6, 7):
        f = f.at[j, :, -1].set(f[j, :, -2])
    return f


def bounce_back_obstacle(
    f: jnp.ndarray, mask: jnp.ndarray, lattice: Lattice = D2Q9
) -> jnp.ndarray:
    """Full 8-direction bounce-back inside an obstacle mask
    (``D2Q9.cl:398-433``): where ``mask`` is set, every population is replaced
    by its opposite.

    Args:
      f: populations ``[Q, ny, nx]``.
      mask: boolean/int obstacle mask ``[ny, nx]``.
    """
    flipped = f[jnp.asarray(lattice.opp)]
    return jnp.where(mask.astype(bool)[None], flipped, f)


def zou_he_pressure_masked(st, rowid, laneid, ny, nx, inlet_rho, outlet_rho,
                           incompressible):
    """Masked-select form of :func:`zou_he_pressure_bcs` /
    :func:`zou_he_pressure_bcs_incompressible` (inlet/outlet columns, solid
    walls, 4 corners; ``D2Q9.cl:173-261`` / ``D2Q9i.cl:173-261``) on a list
    of 9 streamed planes. ``rowid``/``laneid`` are *global* cell coordinates
    broadcast over the planes, so the same code serves a whole grid and one
    shard of it (no edge scatters, which GSPMD mispartitions on sharded
    arrays)."""
    s = tuple(st)  # pre-BC snapshot (D2Q9.cl:187-195)

    row_int = (rowid >= 1) & (rowid <= ny - 2)
    lane_int = (laneid >= 1) & (laneid <= nx - 2)
    lane0 = laneid == 0
    laneN = laneid == nx - 1
    row0 = rowid == 0
    rowN = rowid == ny - 1

    if incompressible:
        # D2Q9i.cl:194-206
        u_in = -s[0] - s[2] - 2 * s[3] - s[4] - 2 * s[6] - 2 * s[7] + inlet_rho
        in1 = (1.0 / 3.0) * (3 * s[3] + 2 * u_in)
        in5 = (1.0 / 6.0) * (-3 * s[2] + 3 * s[4] + 6 * s[7] + u_in)
        in8 = (1.0 / 6.0) * (3 * s[2] - 3 * s[4] + 6 * s[6] + u_in)
        u_out = s[0] + 2 * s[1] + s[2] + s[4] + 2 * s[5] + 2 * s[8] - outlet_rho
        out3 = (1.0 / 3.0) * (3 * s[1] - 2 * u_out)
        out6 = (1.0 / 6.0) * (-3 * s[2] + 3 * s[4] + 6 * s[8] - u_out)
        out7 = (1.0 / 6.0) * (3 * s[2] - 3 * s[4] + 6 * s[5] - u_out)
    else:
        # D2Q9.cl:198-210
        u_in = -((s[0] + s[2] + 2 * s[3] + s[4] + 2 * s[6] + 2 * s[7]
                  - inlet_rho) / inlet_rho)
        in1 = s[3] + (2.0 / 3.0) * inlet_rho * u_in
        in5 = -0.5 * s[2] + 0.5 * s[4] + s[7] + (1.0 / 6.0) * u_in * inlet_rho
        in8 = 0.5 * s[2] - 0.5 * s[4] + s[6] + (1.0 / 6.0) * u_in * inlet_rho
        u_out = (-1.0 + (s[0] + 2 * s[1] + s[2] + s[4] + 2 * s[5]
                         + 2 * s[8]) / outlet_rho)
        out3 = s[1] - (2.0 / 3.0) * outlet_rho * u_out
        out6 = -0.5 * s[2] + 0.5 * s[4] + s[8] - (1.0 / 6.0) * u_out * outlet_rho
        out7 = 0.5 * s[2] - 0.5 * s[4] + s[5] - (1.0 / 6.0) * u_out * outlet_rho

    m_in = lane0 & row_int
    m_out = laneN & row_int
    st[1] = jnp.where(m_in, in1, st[1])
    st[5] = jnp.where(m_in, in5, st[5])
    st[8] = jnp.where(m_in, in8, st[8])
    st[3] = jnp.where(m_out, out3, st[3])
    st[6] = jnp.where(m_out, out6, st[6])
    st[7] = jnp.where(m_out, out7, st[7])

    # walls (D2Q9.cl:212-223), identical in both variants
    m_n = rowN & lane_int
    m_s = row0 & lane_int
    st[4] = jnp.where(m_n, s[2], st[4])
    st[8] = jnp.where(m_n, 0.5 * (-s[1] + s[3] + 2 * s[6]), st[8])
    st[7] = jnp.where(m_n, 0.5 * (s[1] - s[3] + 2 * s[5]), st[7])
    st[2] = jnp.where(m_s, s[4], st[2])
    st[6] = jnp.where(m_s, 0.5 * (s[1] - s[3] + 2 * s[8]), st[6])
    st[5] = jnp.where(m_s, 0.5 * (-s[1] + s[3] + 2 * s[7]), st[5])

    # corners (D2Q9.cl:228-259)
    bi = row0 & lane0
    ti = rowN & lane0
    bo = row0 & laneN
    to = rowN & laneN
    bi_d = 0.5 * (-s[0] - 2 * s[3] - 2 * s[4] - 2 * s[7] + inlet_rho)
    ti_d = 0.5 * (-s[0] - 2 * s[2] - 2 * s[3] - 2 * s[6] + inlet_rho)
    bo_d = 0.5 * (-s[0] - 2 * s[1] - 2 * s[4] - 2 * s[8] + outlet_rho)
    to_d = 0.5 * (-s[0] - 2 * s[1] - 2 * s[2] - 2 * s[5] + outlet_rho)
    st[1] = jnp.where(bi, s[3], jnp.where(ti, s[3], st[1]))
    st[2] = jnp.where(bi, s[4], jnp.where(bo, s[4], st[2]))
    st[5] = jnp.where(bi, s[7], jnp.where(ti, ti_d, jnp.where(bo, bo_d, st[5])))
    st[6] = jnp.where(bi, bi_d, jnp.where(bo, s[8], jnp.where(to, to_d, st[6])))
    st[8] = jnp.where(bi, bi_d, jnp.where(ti, s[6], jnp.where(to, to_d, st[8])))
    st[4] = jnp.where(ti, s[2], jnp.where(to, s[2], st[4]))
    st[7] = jnp.where(ti, ti_d, jnp.where(bo, bo_d, jnp.where(to, s[5], st[7])))
    st[3] = jnp.where(bo, s[1], jnp.where(to, s[1], st[3]))
    return st


def noflux_walls_masked(st, rowid, laneid, ny, nx):
    """No-flux walls + corners per field as masked selects
    (``D2Q9_multifield_fisher.cl:184-289``). ``st`` is ``[q][F]`` streamed
    planes; masks use global coordinates so the same code serves full
    arrays and shards. (Masked selects, not ``.at[].set``
    scatters: GSPMD miscompiles edge scatters on y-sharded arrays by
    applying the global row -1 update to every shard's last local row.)"""
    q = len(st)
    F = len(st[0])
    row_int = (rowid >= 1) & (rowid <= ny - 2)
    lane_int = (laneid >= 1) & (laneid <= nx - 2)
    lane0 = laneid == 0
    laneN = laneid == nx - 1
    row0 = rowid == 0
    rowN = rowid == ny - 1
    m_n = rowN & lane_int
    m_s = row0 & lane_int
    m_e = laneN & row_int
    m_w = lane0 & row_int
    ul = rowN & lane0
    ur = rowN & laneN
    br = row0 & laneN
    bl = row0 & lane0
    for p in range(F):
        s = tuple(st[j][p] for j in range(q))
        # north: f7<-f5, f4<-f2, f8<-f6 ; south: f2<-f4, f5<-f7, f6<-f8
        st[7][p] = jnp.where(m_n, s[5], st[7][p])
        st[4][p] = jnp.where(m_n, s[2], st[4][p])
        st[8][p] = jnp.where(m_n, s[6], st[8][p])
        st[2][p] = jnp.where(m_s, s[4], st[2][p])
        st[5][p] = jnp.where(m_s, s[7], st[5][p])
        st[6][p] = jnp.where(m_s, s[8], st[6][p])
        # east: f3<-f1, f6<-f8, f7<-f5 ; west: f1<-f3, f5<-f7, f8<-f6
        st[3][p] = jnp.where(m_e, s[1], st[3][p])
        st[6][p] = jnp.where(m_e, s[8], st[6][p])
        st[7][p] = jnp.where(m_e, s[5], st[7][p])
        st[1][p] = jnp.where(m_w, s[3], st[1][p])
        st[5][p] = jnp.where(m_w, s[7], st[5][p])
        st[8][p] = jnp.where(m_w, s[6], st[8][p])
        # corners (3 populations each)
        st[1][p] = jnp.where(ul | bl, s[3], st[1][p])
        st[4][p] = jnp.where(ul | ur, s[2], st[4][p])
        st[8][p] = jnp.where(ul, s[6], st[8][p])
        st[3][p] = jnp.where(ur | br, s[1], st[3][p])
        st[7][p] = jnp.where(ur, s[5], st[7][p])
        st[2][p] = jnp.where(br | bl, s[4], st[2][p])
        st[6][p] = jnp.where(br, s[8], st[6][p])
        st[5][p] = jnp.where(bl, s[7], st[5][p])
    return st
