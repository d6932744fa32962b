"""Halo exchange for domain-decomposed LB grids.

The reference is single-device (``opencl_dim.py:229-240`` picks
``devices[0]``); scaling the grid beyond one chip is done here by sharding
``f[Q, ny, nx]`` over a 2-D device mesh and exchanging 1-cell-wide halos
with ``jax.lax.ppermute`` each step — the stencil analogue of ring
collectives. Streaming then becomes pure local slicing of the halo-extended
block (no rolls, no wrap), and the global Zou-He boundary is applied with
global-coordinate masks.

Two-phase corner handling: x halos are exchanged first, then y halos of the
*x-extended* rows, so diagonal-neighbor corners arrive in two hops and no
8-neighbor exchange is needed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["exchange_halo_2d", "extend_with_halo"]


def _ring_shift(x, axis_name, direction):
    """ppermute by +-1 along a mesh axis (periodic ring). ``direction=+1``
    sends to the next-higher index, i.e. each shard *receives from the
    previous* shard."""
    n = jax.lax.axis_size(axis_name)
    if n == 1:
        return x
    perm = [(i, (i + direction) % n) for i in range(n)]
    return jax.lax.ppermute(x, axis_name, perm)


def extend_with_halo(f_loc: jnp.ndarray, y_axis: str | None, x_axis: str | None
                     ) -> jnp.ndarray:
    """Extend a local block ``[Q, H, W]`` to ``[Q, H+2, W+2]`` with neighbor
    halos (periodic ring exchange; at global domain edges the wrapped-in data
    corresponds to the periodic wrap and is rewritten by BCs, exactly as in
    the single-device roll-based stream).

    ``y_axis`` / ``x_axis`` are mesh axis names (or None if unsharded along
    that dim, in which case the halo is the local periodic wrap).
    """
    # --- x halos -------------------------------------------------------------
    left_col = f_loc[:, :, -1:]   # my last column -> right neighbor's left halo
    right_col = f_loc[:, :, :1]   # my first column -> left neighbor's right halo
    if x_axis is not None:
        left_halo = _ring_shift(left_col, x_axis, +1)    # from prev x
        right_halo = _ring_shift(right_col, x_axis, -1)  # from next x
    else:
        left_halo, right_halo = left_col, right_col
    fx = jnp.concatenate([left_halo, f_loc, right_halo], axis=2)

    # --- y halos of the x-extended block (carries corners) --------------------
    top_row = fx[:, -1:, :]
    bot_row = fx[:, :1, :]
    if y_axis is not None:
        top_halo = _ring_shift(top_row, y_axis, +1)      # from prev y
        bot_halo = _ring_shift(bot_row, y_axis, -1)      # from next y
    else:
        top_halo, bot_halo = top_row, bot_row
    return jnp.concatenate([top_halo, fx, bot_halo], axis=1)


def exchange_halo_2d(f_loc: jnp.ndarray, y_axis: str | None, x_axis: str | None):
    """Alias kept for API clarity: returns the halo-extended block."""
    return extend_with_halo(f_loc, y_axis, x_axis)
