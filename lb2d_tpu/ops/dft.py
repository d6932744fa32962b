"""Matmul-based 2-D DFT — the partitionable path for spectral solves.

``jnp.fft`` is a single custom call that GSPMD cannot split over a
multi-device mesh, so solves on sharded arrays run the DFT as matmuls
instead: ``X_hat = F_y @ X @ F_x^T`` with ``F[k, n] = exp(-2 pi i k n / N)``.
Complex arithmetic is carried as (real, imag) pairs -> 4 real matmuls per
side, all ``preferred_element_type=float32``, accumulated in full precision.

Cost is ~N multiply-adds per point per axis (an FFT needs ~log N), so this
path is only taken where the FFT cannot run.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["dft_mats", "fft2_mm", "ifft2_mm", "screened_gradients_mm"]


def dft_mats(n: int, inverse: bool = False):
    """(cos, sin) parts of the DFT matrix ``exp(sign * 2 pi i k n / N)``;
    the inverse includes the 1/N normalization (numpy convention).

    Built IN-GRAPH, not as host constants: at 8192^2 each matrix is 268 MB
    and closure-captured constants get baked into the executable (host
    round-trip at lowering + RESOURCE_EXHAUSTED). The phase is computed as
    ``2 pi ((k k') mod n) / n`` with an exact int32 product (k k' < 2^31
    for n <= 2^15) — a plain fp32 ``outer(k, k)`` would lose the phase
    entirely at large n (|ang| up to ~5e4 radians)."""
    if n > 32768:
        raise ValueError(
            f"dft_mats: n={n} > 2^15 overflows the exact int32 phase "
            "product k*k' (the resulting matrix would be silently wrong)")
    k = jax.lax.iota(jnp.int32, n)
    ij = k[:, None] * k[None, :]
    ang = (2.0 * np.pi / n) * (ij % n).astype(jnp.float32)
    sign = 1.0 if inverse else -1.0
    c = jnp.cos(ang)
    s = sign * jnp.sin(ang)
    if inverse:
        c = c / n
        s = s / n
    return c, s


def _cmatmul(ar, ai, br, bi):
    """(ar + i ai) @ (br + i bi) with full-fp32 products.

    ``Precision.HIGHEST`` matters: a reduced-precision default (a single
    bf16 pass, or TF32 on tensor cores) costs the DFT ~3 significant digits
    at 8192^2, and the 4-step factors are skinny, so these matmuls are
    bandwidth-bound and the full-precision passes cost little."""
    mm = lambda a, b: jnp.dot(a, b, preferred_element_type=jnp.float32,
                              precision=jax.lax.Precision.HIGHEST)
    return mm(ar, br) - mm(ai, bi), mm(ar, bi) + mm(ai, br)


def _split_n(n: int) -> tuple[int, int] | None:
    """Factor ``n = n1 * n2`` with ``n1 <= n2`` as close to ``sqrt(n)`` as
    possible — the Bailey 4-step split. None for small or prime-ish n:
    below ~4096 the direct [n x n] DFT matmul is one well-shaped product
    (the split's [n1 x n1] factors are tiny)."""
    if n < 4096:
        return None
    best = None
    n1 = int(np.sqrt(n))
    while n1 >= 16:
        if n % n1 == 0:
            best = (n1, n // n1)
            break
        n1 -= 1
    return best


def _twiddle(n1: int, n2: int, inverse: bool):
    """``W_N^(+-bc)`` for c < n1 (rows), b < n2 (cols); exact int32 phase
    (bc < N so no mod needed)."""
    c = jax.lax.iota(jnp.int32, n1)
    b = jax.lax.iota(jnp.int32, n2)
    bc = c[:, None] * b[None, :]
    ang = (2.0 * np.pi / (n1 * n2)) * bc.astype(jnp.float32)
    sign = 1.0 if inverse else -1.0
    return jnp.cos(ang), sign * jnp.sin(ang)


def _fft1_fast(xr, xi, inverse: bool):
    """Batched 1-D DFT along the LAST axis via the Bailey 4-step
    factorization: with ``n = n1 n2``, index ``m = n2 a + b``,
    ``k = c + n1 d``::

        X[c + n1 d] = sum_b W_N^{bc} W_{n2}^{bd} (sum_a x[n2 a + b] W_{n1}^{ac})

    i.e. a [n1 x n1] matmul, an elementwise twiddle, and a [n2 x n2]
    matmul — ``O(n (n1 + n2))`` instead of ``O(n^2)`` per row (42x fewer
    flops at n = 8192). Falls back to the direct DFT matrix when n
    doesn't factor nicely. The inverse is the forward of the conjugate,
    conjugated and 1/N-scaled."""
    if inverse:
        yr, yi = _fft1_fast(xr, -xi, inverse=False)
        n = xr.shape[-1]
        return yr * (1.0 / n), yi * (-1.0 / n)
    *batch, n = xr.shape
    split = _split_n(n)
    if split is None:
        c, s = dft_mats(n, False)
        # x @ F^T; F symmetric
        return _cmatmul(xr, xi, c, s)
    n1, n2 = split
    m = int(np.prod(batch)) if batch else 1
    # M[a, b] with n = n2 a + b -> reshape rows-major
    Mr = xr.reshape(m, n1, n2)
    Mi = xi.reshape(m, n1, n2)
    F1c, F1s = dft_mats(n1, False)
    F2c, F2s = dft_mats(n2, False)
    # step 1: T1[c, b] = sum_a F1[c, a] M[a, b]  (fold batch into cols)
    M2r = jnp.transpose(Mr, (1, 0, 2)).reshape(n1, m * n2)
    M2i = jnp.transpose(Mi, (1, 0, 2)).reshape(n1, m * n2)
    T1r, T1i = _cmatmul(F1c, F1s, M2r, M2i)
    # step 2: twiddle W_N^{bc}
    twc, tws = _twiddle(n1, n2, False)
    T1r = T1r.reshape(n1, m, n2)
    T1i = T1i.reshape(n1, m, n2)
    T2r = T1r * twc[:, None, :] - T1i * tws[:, None, :]
    T2i = T1r * tws[:, None, :] + T1i * twc[:, None, :]
    # step 3: X_mat[c, d] = sum_b T2[c, b] F2[d, b]  (F2 symmetric)
    T3r = T2r.reshape(n1 * m, n2)
    T3i = T2i.reshape(n1 * m, n2)
    Xr, Xi = _cmatmul(T3r, T3i, F2c, F2s)
    # k = c + n1 d: output laid out [c, m, d] -> [m, d, c] -> [m, n]
    Xr = jnp.transpose(Xr.reshape(n1, m, n2), (1, 2, 0)).reshape(m, n)
    Xi = jnp.transpose(Xi.reshape(n1, m, n2), (1, 2, 0)).reshape(m, n)
    return Xr.reshape(*batch, n), Xi.reshape(*batch, n)


def _apply2d(xr, xi, inverse: bool):
    # last axis, then transpose so the y axis is last, then transpose back
    yr, yi = _fft1_fast(xr, xi, inverse)
    yr, yi = yr.T, yi.T
    zr, zi = _fft1_fast(yr, yi, inverse)
    return zr.T, zi.T


def fft2_mm(xr, xi=None):
    """Forward 2-D DFT of a [ny, nx] field; returns (real, imag)."""
    if xi is None:
        xi = jnp.zeros_like(xr)
    return _apply2d(xr, xi, inverse=False)


def ifft2_mm(xr, xi):
    """Inverse 2-D DFT (1/(ny*nx) normalized); returns (real, imag)."""
    return _apply2d(xr, xi, inverse=True)


# ---------------------------------------------------------------------------
# fused screened-Poisson gradient solve (the config-5 hot path)
# ---------------------------------------------------------------------------
#
# The generic pair above is not matmul bound at 8192^2: most of its time
# goes to reshape-transposes around every pass, unfused twiddles, and 4
# complex passes carrying a zero imaginary plane on the forward. The solver
# below restructures the whole solve around three ideas:
#
# 1. *Transpose-free passes.* A 4-step pass along axis 0 needs NO data
#    transposes: with m = n2 a + b, k = c + n1 d, row-major reshapes give
#    step 1 as ``F1 @ X.reshape(n1, n2 w)`` and step 3 as a dot_general
#    whose natural output layout [d, c, w] flattens to exactly k-order
#    (k = n1 d + c). The axis-1 pass needs a single minor transpose.
# 2. *Real input -> half spectrum.* rho is real, so the y-spectrum is
#    Hermitian: the forward keeps only ky = 0..ny/2 rows (padded to a
#    sublane multiple) — the x-pass, screening, and gradient multipliers
#    all run at half size. Step 1 of the first pass is 2 real matmuls
#    instead of 4.
# 3. *Packed inverse.* Both gradient spectra A = i ax s X, B = i ay s X
#    are Hermitian; after mirror-extending the half spectra (a cheap
#    flip+conj, no matmuls) the single complex inverse of A + iB yields
#    xg + i yg exactly (ifft is conj-free, so packing is exact).
#
# Matmul content: ~3.1 complex-pass equivalents vs 8 for the generic pair.


def _tw_pair(n1: int, n2: int, inverse: bool, transpose: bool = False):
    c, s = _twiddle(n1, n2, inverse)
    if transpose:
        return c.T, s.T
    return c, s


def _dft_axis0(xr, xi, inverse: bool, out_rows: int | None = None):
    """1-D DFT along axis 0 of ``[n, W]`` (transpose-free 4-step).
    ``xi=None`` marks real input (step 1 runs 2 real matmuls).
    ``out_rows`` truncates the output to the first ``out_rows`` k-rows."""
    n, W = xr.shape
    mm = lambda a, b: jnp.dot(a, b, preferred_element_type=jnp.float32,
                              precision=jax.lax.Precision.HIGHEST)
    dg = lambda a, b, ca, cb: jax.lax.dot_general(
        a, b, dimension_numbers=(((ca,), (cb,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST)
    split = _split_n(n)
    if split is None:
        Fc, Fs = dft_mats(n, inverse)
        if out_rows is not None:
            Fc, Fs = Fc[:out_rows], Fs[:out_rows]
        if xi is None:
            return mm(Fc, xr), mm(Fs, xr)
        return (mm(Fc, xr) - mm(Fs, xi), mm(Fc, xi) + mm(Fs, xr))
    n1, n2 = split
    F1c, F1s = dft_mats(n1, inverse)
    F2c, F2s = dft_mats(n2, inverse)
    twc, tws = _tw_pair(n1, n2, inverse)
    if not inverse:
        # X[k = c + n1 d] = sum_b W^{bc} W_{n2}^{bd} sum_a F1[c,a] M[a,b,w]
        M = xr.reshape(n1, n2 * W)
        if xi is None:
            T1r, T1i = mm(F1c, M), mm(F1s, M)
        else:
            Mi = xi.reshape(n1, n2 * W)
            T1r = mm(F1c, M) - mm(F1s, Mi)
            T1i = mm(F1c, Mi) + mm(F1s, M)
        T1r = T1r.reshape(n1, n2, W)
        T1i = T1i.reshape(n1, n2, W)
        tc = twc[:, :, None]
        ts = tws[:, :, None]
        T2r = T1r * tc - T1i * ts
        T2i = T1r * ts + T1i * tc
        # step 3: contract b -> [d, c, w]; flatten = k-order (k = n1 d + c).
        # Truncating to out_rows keeps only d <= (out_rows-1)//n1 rows of
        # F2 — the half-spectrum forward does half the step-3 matmul work.
        if out_rows is not None:
            D = (out_rows - 1) // n1 + 1
            F2c, F2s = F2c[:D], F2s[:D]
        else:
            D = n2
        Xr = dg(F2c, T2r, 1, 1) - dg(F2s, T2i, 1, 1)
        Xi = dg(F2c, T2i, 1, 1) + dg(F2s, T2r, 1, 1)
        Xr = Xr.reshape(D * n1, W)
        Xi = Xi.reshape(D * n1, W)
        if out_rows is not None:
            Xr, Xi = Xr[:out_rows], Xi[:out_rows]
        return Xr, Xi
    # inverse: x[m = n2 a + b] = (1/n) sum_c W_{n1}^{+ac} W^{+bc}
    #          sum_d F2i[b,d] X[d, c, w]
    X_r = xr.reshape(n2, n1, W)
    X_i = xi.reshape(n2, n1, W)
    T1r = dg(F2c, X_r, 1, 0) - dg(F2s, X_i, 1, 0)   # [b, c, w]
    T1i = dg(F2c, X_i, 1, 0) + dg(F2s, X_r, 1, 0)
    tc = twc.T[:, :, None]                           # [b, c, 1]
    ts = tws.T[:, :, None]
    T2r = T1r * tc - T1i * ts
    T2i = T1r * ts + T1i * tc
    Yr = dg(F1c, T2r, 1, 1) - dg(F1s, T2i, 1, 1)     # [a, b, w]
    Yi = dg(F1c, T2i, 1, 1) + dg(F1s, T2r, 1, 1)
    # NO extra 1/n: the inverse factor matrices already carry 1/n1, 1/n2
    return Yr.reshape(n, W), Yi.reshape(n, W)


def _dft_axis1(xr, xi, inverse: bool):
    """1-D DFT along the last axis of ``[H, n]`` (4-step, one minor
    transpose on the [H, n1, n2] output block)."""
    H, n = xr.shape
    mm = lambda a, b: jnp.dot(a, b, preferred_element_type=jnp.float32,
                              precision=jax.lax.Precision.HIGHEST)
    dg = lambda a, b, ca, cb: jax.lax.dot_general(
        a, b, dimension_numbers=(((ca,), (cb,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST)
    split = _split_n(n)
    if split is None:
        Fc, Fs = dft_mats(n, inverse)  # symmetric
        if xi is None:
            out = (mm(xr, Fc), mm(xr, Fs))
        else:
            out = (mm(xr, Fc) - mm(xi, Fs), mm(xr, Fs) + mm(xi, Fc))
        return out  # dft_mats(n, inverse=True) already 1/n-normalized
    n1, n2 = split
    F1c, F1s = dft_mats(n1, inverse)
    F2c, F2s = dft_mats(n2, inverse)
    twc, tws = _tw_pair(n1, n2, inverse)
    M_r = xr.reshape(H, n1, n2)
    M_i = xi.reshape(H, n1, n2) if xi is not None else None
    # step 1: contract a with F1[c, a] -> [h, b, c]
    if M_i is None:
        T1r, T1i = dg(M_r, F1c, 1, 1), dg(M_r, F1s, 1, 1)
    else:
        T1r = dg(M_r, F1c, 1, 1) - dg(M_i, F1s, 1, 1)
        T1i = dg(M_r, F1s, 1, 1) + dg(M_i, F1c, 1, 1)
    tc = twc.T[None, :, :]                           # [1, b, c]
    ts = tws.T[None, :, :]
    T2r = T1r * tc - T1i * ts
    T2i = T1r * ts + T1i * tc
    # step 3: contract b with F2[d, b] -> [h, c, d]; need [h, d, c]
    Xr = dg(T2r, F2c, 1, 1) - dg(T2i, F2s, 1, 1)
    Xi = dg(T2r, F2s, 1, 1) + dg(T2i, F2c, 1, 1)
    Xr = jnp.swapaxes(Xr, 1, 2).reshape(H, n)
    Xi = jnp.swapaxes(Xi, 1, 2).reshape(H, n)
    return Xr, Xi  # inverse factors already 1/n1- and 1/n2-normalized


def _mirror_x(ar):
    """Lane mirror: out[..., kx] = in[..., (nx - kx) % nx]."""
    return jnp.concatenate([ar[..., :1], jnp.flip(ar[..., 1:], axis=-1)],
                           axis=-1)


def screened_gradients_mm(rho, fx, fy, gx, gy, lam2):
    """Screened-Poisson spectral gradients of a REAL field, fused.

    Returns ``(xg, yg)`` with ``xg = Re ifft2(i 2 pi gx * s * fft2(rho))``
    (same for yg along y), ``s = 1 / (lam2 (fx^2 + fy^2) + 1)`` — the
    reference's solve (``spectral_poisson/screened_poisson.py:38-89``)
    without its three separate plans. ``fx``/``fy`` are the 1-D
    cycles-per-box frequency vectors; ``gx``/``gy`` the (Nyquist-zeroed)
    gradient variants.

    Requires even ``ny``. Cost: ~3.1 complex-pass equivalents (see module
    comment); parity with the generic-path solve is ~1e-5 relative.
    """
    ny, nx = rho.shape
    assert ny % 2 == 0, "half-spectrum solve needs even ny"
    hy = ny // 2 + 1
    # 1. forward along y (real input), keep ky = 0..ny/2 (+ pad rows for
    #    sublane alignment; they're sliced away before the mirror)
    hpad = min(-(-hy // 8) * 8, ny)
    Zr, Zi = _dft_axis0(rho, None, inverse=False, out_rows=hpad)
    # 2. forward along x (complex, half rows)
    Xr, Xi = _dft_axis1(Zr, Zi, inverse=False)
    # 3+4. screening + gradient multipliers, mirror-extension, and the
    # A + iB packing in ONE fused stage. With A = i ax s X, B = i ay s X:
    #   head rows (ky = 0..ny/2):  P = A + iB
    #     Pr = -s (ax Xi + ay Xr),  Pi = s (ax Xr - ay Xi)
    #   tail rows (ky > ny/2) are conj(A)[-k] + i conj(B)[-k]; in terms of
    #   the stored half spectrum that is Q at mirrored coordinates with
    #     Qr = s (ay Xr - ax Xi),   Qi = -s (ax Xr + ay Xi)
    # — four half-size outputs straight from (Xr, Xi), never
    # materializing A and B.
    KX = fx[None, :]
    KY = fy[:hpad, None]
    s = 1.0 / (lam2 * (KX * KX + KY * KY) + 1.0)
    ax = (2.0 * np.pi) * gx[None, :] * s
    ay = (2.0 * np.pi) * gy[:hpad, None] * s
    axXr, axXi = ax * Xr, ax * Xi
    ayXr, ayXi = ay * Xr, ay * Xi
    Pr_h = -(axXi + ayXr)
    Pi_h = axXr - ayXi
    Qr = ayXr - axXi
    Qi = -(axXr + ayXi)
    Pr = jnp.concatenate(
        [Pr_h[:hy], _mirror_x(jnp.flip(Qr[1:ny - hy + 1], axis=0))], axis=0)
    Pi = jnp.concatenate(
        [Pi_h[:hy], _mirror_x(jnp.flip(Qi[1:ny - hy + 1], axis=0))], axis=0)
    # 5. packed inverse: x then y (both full complex, transpose-light)
    Wr, Wi = _dft_axis1(Pr, Pi, inverse=True)
    Gr, Gi = _dft_axis0(Wr, Wi, inverse=True)
    return Gr, Gi                                    # xg, yg
