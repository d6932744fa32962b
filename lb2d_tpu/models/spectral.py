"""Spectral screened-Poisson solver via ``jnp.fft`` (replaces gpyfft).

Rebuilds ``spectral_poisson/screened_poisson.py`` (``Screened_Poisson``):
solve ``(1 - lam^2 nabla^2) phi = charge`` in Fourier space with multiplier
``1 / (lam^2 k^2 + 1)`` (``screened_poisson.py:38``) and produce the two
gradient fields via spectral differentiation ``2 pi i k phi_hat``
(``screened_poisson.py:60-84``).

Frequency convention preserved exactly: ``k = L * fftfreq(n, d=dx)`` —
integer cycles-per-box (``screened_poisson.py:26-27``) — and the gradient
multiplier is ``2 pi i k`` *without* the 1/L factor
(``screened_poisson.py:70-71``); consumers absorb the scale
(``screened_poisson_waves.py:353-361``).

The reference runs three separate gpyfft plans with host-side event waits
per solve (``screened_poisson.py:50-88``); here the whole
solve-and-gradients pipeline is one jitted function, so coupled models can
fold it into their step (``jnp.fft`` shards over a mesh when inputs are
sharded).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.dft import fft2_mm, ifft2_mm

__all__ = ["ScreenedPoisson", "screened_poisson_solve", "spectral_method"]


SPECTRAL_METHODS = ("fft", "matmul")


def spectral_method(method: str = "auto") -> str:
    """Resolve the FFT implementation. ``"auto"`` is ``jnp.fft`` (cuFFT on
    the GPU); ``"matmul"`` is the dense DFT of :mod:`lb2d_tpu.ops.dft`,
    which GSPMD can partition, so solves on arrays sharded over a
    multi-device mesh use it."""
    if method == "auto":
        return "fft"
    if method not in SPECTRAL_METHODS:
        raise ValueError(f"unknown spectral method {method!r}; valid: "
                         "'auto', " + ", ".join(map(repr, SPECTRAL_METHODS)))
    return method


@jax.jit
def _solve_fft(charge, rescaling, kx2pi, ky2pi):
    chat = jnp.fft.fft2(charge) * rescaling
    phi = jnp.fft.ifft2(chat)
    xgrad = jnp.fft.ifft2(chat * kx2pi)
    ygrad = jnp.fft.ifft2(chat * ky2pi)
    return phi, xgrad, ygrad


@jax.jit
def _solve_mm(charge_r, charge_i, rescaling, ax, ay):
    """Matmul-DFT path: rescaling real; gradient multipliers ``i * a``
    with ``a = 2 pi k`` carried as the real arrays ax, ay."""
    cr, ci = fft2_mm(charge_r, charge_i)
    cr, ci = cr * rescaling, ci * rescaling
    pr, pi_ = ifft2_mm(cr, ci)
    xr, xi = ifft2_mm(-ax * ci, ax * cr)
    yr, yi = ifft2_mm(-ay * ci, ay * cr)
    return pr + 1j * pi_, xr + 1j * xi, yr + 1j * yi


def _freqs(ny, nx, dx):
    fx = (nx * dx) * np.fft.fftfreq(nx, d=dx)
    fy = (ny * dx) * np.fft.fftfreq(ny, d=dx)
    return fx, fy


def screened_poisson_solve(charge, lam=1.0, dx=1.0, method="auto"):
    """Functional one-shot solve: returns (phi, xgrad, ygrad) as complex
    arrays, ``charge`` indexed ``[y, x]``."""
    ny, nx = charge.shape
    fx, fy = _freqs(ny, nx, dx)
    KX = jnp.asarray(np.broadcast_to(fx[None, :], (ny, nx)), jnp.float32)
    KY = jnp.asarray(np.broadcast_to(fy[:, None], (ny, nx)), jnp.float32)
    rescaling = 1.0 / (lam**2 * (KX**2 + KY**2) + 1.0)
    if spectral_method(method) == "fft":
        return _solve_fft(jnp.asarray(charge, jnp.complex64),
                          rescaling.astype(jnp.complex64),
                          (2j * np.pi) * KX.astype(jnp.complex64),
                          (2j * np.pi) * KY.astype(jnp.complex64))
    c = jnp.asarray(charge)
    cr = jnp.real(c).astype(jnp.float32)
    ci = (jnp.imag(c).astype(jnp.float32) if jnp.iscomplexobj(c)
          else jnp.zeros_like(cr))
    return _solve_mm(cr, ci, rescaling,
                     (2.0 * np.pi) * KX, (2.0 * np.pi) * KY)


class ScreenedPoisson:
    """API mirror of ``Screened_Poisson``. ``charge`` is ``[ny, nx]``
    complex64 (the reference's is (nx, ny) x-major; pass ``xy=True`` to
    accept that layout)."""

    def __init__(self, charge_cpu, lam=1.0, dx=1.0, xy=False, method="auto"):
        c = np.asarray(charge_cpu)
        if xy:
            c = c.T
        self.lam = lam
        self.dx = dx
        self.method = spectral_method(method)
        self.charge = jnp.asarray(c, jnp.complex64)
        ny, nx = self.charge.shape
        fx, fy = _freqs(ny, nx, dx)
        self._KX = jnp.asarray(fx[None, :] + 0 * fy[:, None], jnp.float32)
        self._KY = jnp.asarray(fy[:, None] + 0 * fx[None, :], jnp.float32)
        self.rescaling = (1.0 / (lam**2 * (self._KX**2 + self._KY**2) + 1.0)
                          ).astype(jnp.complex64)
        self.xgrad_rescale = (2j * np.pi * self._KX).astype(jnp.complex64)
        self.ygrad_rescale = (2j * np.pi * self._KY).astype(jnp.complex64)
        self.xgrad = None
        self.ygrad = None

    # -- reference API ---------------------------------------------------------
    def create_grad_fields(self):
        self.xgrad = self.charge + 0
        self.ygrad = self.charge + 0

    def _fft2(self, z):
        if self.method == "fft":
            return jnp.fft.fft2(z)
        zr, zi = fft2_mm(jnp.real(z).astype(jnp.float32),
                         jnp.imag(z).astype(jnp.float32))
        return zr + 1j * zi

    def _ifft2(self, z):
        if self.method == "fft":
            return jnp.fft.ifft2(z)
        zr, zi = ifft2_mm(jnp.real(z).astype(jnp.float32),
                          jnp.imag(z).astype(jnp.float32))
        return zr + 1j * zi

    def fft_and_screen(self):
        """In the reference this leaves ``charge`` holding the *screened
        spectrum* (``screened_poisson.py:50-55``)."""
        self.charge = self._fft2(self.charge) * self.rescaling

    def inverse_fft(self):
        self.charge = self._ifft2(self.charge)

    def update_grad_fields(self):
        """Requires :meth:`fft_and_screen` first (charge = screened spectrum)."""
        self.xgrad = self._ifft2(self.charge * self.xgrad_rescale)
        self.ygrad = self._ifft2(self.charge * self.ygrad_rescale)

    def solve_and_update_grad_fields(self):
        self.fft_and_screen()
        self.update_grad_fields()

    def set_charge(self, charge, xy=False):
        c = jnp.asarray(charge)
        if xy:
            c = c.T
        self.charge = c.astype(jnp.complex64)
