"""Coupled Fisher-wave model tests."""

import numpy as np
import pytest

from lb2d_tpu.models.waves import (
    NoisyAdvectedFisherWave,
    RepellingFisherWave,
    ScreenedFisherWave,
)


def test_noisy_fisher_constants():
    sim = NoisyAdvectedFisherWave(N=20, z=0.1, D=1.0, g=50.0, Nc=10.0,
                                  Lx=0.3, Ly=0.3)
    # noisy_fisher_wave.py:188-207
    assert sim.dim_Gd == pytest.approx(50.0 * 0.01)
    assert sim.lb_Gd == pytest.approx(np.float32(0.5 * sim.delta_t))
    assert sim.lb_Dg == pytest.approx(
        np.float32((0.1 / 10.0) * sim.delta_t / sim.delta_x))
    sim.run(200)
    f, _ = sim.state
    assert np.isfinite(np.asarray(f)).all()
    assert float(np.asarray(f).min()) >= 0.0


def test_screened_fisher_wave_repels():
    """The screened-Poisson velocity points outward from the density blob, so
    the blob spreads faster than pure diffusion; density stays finite and the
    front expands."""
    sim = ScreenedFisherWave(Lx=1.0, Ly=1.0, vc=5.0, lam=0.1, R0=0.2, N=48)
    assert (sim.nx, sim.ny) == (48, 48)
    rho0 = sim.get_fields()["rho"]
    r0_mass = rho0.sum()
    sim.run(300)
    fields = sim.get_fields()
    rho = fields["rho"]
    assert np.isfinite(rho).all()
    assert rho.sum() > r0_mass          # Fisher growth
    # velocity field is radial-outward near the blob: u>0 right of center
    cx = sim.nx // 2
    assert fields["u"][cx + 5, sim.ny // 2] > 0
    assert fields["u"][cx - 5, sim.ny // 2] < 0


def test_screened_fisher_mach_watchdog():
    sim = ScreenedFisherWave(Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2, N=32,
                             check_max_ulb=True)
    ma = sim.mach_number()
    assert 0.0 <= ma < 0.5


def test_redo_initial_condition():
    sim = ScreenedFisherWave(Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2, N=32)
    new_rho = np.zeros((sim.ny, sim.nx), np.float32)
    new_rho[10:20, 10:20] = 1.0
    sim.redo_initial_condition(new_rho)
    rho = sim.get_fields()["rho"]
    assert rho.T[12, 12] == pytest.approx(1.0, abs=1e-5)
    sim.run(10)
    assert np.isfinite(sim.get_fields()["rho"]).all()


def test_repelling_fisher_wave_runs():
    sim = RepellingFisherWave(Lx=1.0, Ly=1.0, E=2.0, R0=0.25, N=24,
                              max_inner_iter=60, inner_tolerance=1e-4)
    rho0 = sim.get_fields()["rho"]
    sim.run(50)
    fields = sim.get_fields()
    assert np.isfinite(fields["rho"]).all()
    assert fields["rho"].sum() > rho0.sum()   # growth
    # repulsive velocity points outward (u is the reference's axis-swapped
    # gradient; just require a nonzero field after the first solves)
    assert np.abs(fields["u"]).max() + np.abs(fields["v"]).max() > 0


def test_dft_bailey_4step_matches_numpy():
    """The Bailey 4-step matmul DFT (n = n1*n2 split) matches np.fft to
    fp32 accuracy, forward and roundtrip, at split and non-split sizes."""
    import jax
    import jax.numpy as jnp
    from lb2d_tpu.ops.dft import fft2_mm, ifft2_mm

    for n in (128, 512, 768):
        rng = np.random.RandomState(0)
        x = rng.rand(n, n).astype(np.float32)
        Xr, Xi = jax.jit(fft2_mm)(jnp.asarray(x))
        ref = np.fft.fft2(x)
        scale = np.abs(ref).max()
        assert np.abs(np.asarray(Xr) - ref.real).max() / scale < 1e-5
        assert np.abs(np.asarray(Xi) - ref.imag).max() / scale < 1e-5
        br, _ = jax.jit(ifft2_mm)(Xr, Xi)
        assert np.abs(np.asarray(br) - x).max() < 1e-4


def test_dft_bailey_4step_split_path_n4096():
    """Exercise the actual n1*n2 Bailey factorization (n >= the 4096
    split threshold) against np.fft on a skinny batch — the 2-D tests
    above all stay below the threshold."""
    import jax
    import jax.numpy as jnp
    from lb2d_tpu.ops.dft import _fft1_fast, _split_n

    n = 4096
    assert _split_n(n) is not None  # really takes the split path
    rng = np.random.RandomState(1)
    x = rng.rand(4, n).astype(np.float32)
    fwd = jax.jit(lambda r, i: _fft1_fast(r, i, inverse=False))
    Xr, Xi = fwd(jnp.asarray(x), jnp.zeros_like(jnp.asarray(x)))
    ref = np.fft.fft(x, axis=-1)
    scale = np.abs(ref).max()
    assert np.abs(np.asarray(Xr) - ref.real).max() / scale < 1e-5
    assert np.abs(np.asarray(Xi) - ref.imag).max() / scale < 1e-5
    inv = jax.jit(lambda r, i: _fft1_fast(r, i, inverse=True))
    br, bi = inv(Xr, Xi)
    assert np.abs(np.asarray(br) - x).max() < 1e-4
    assert np.abs(np.asarray(bi)).max() < 1e-4


def test_screened_velocity_gradient_nyquist_clean():
    """The packed one-transform gradient must equal the reference's
    separate Re(ifft) gradients; with white-noise rho (how config-5
    densities are initialized) an un-zeroed Nyquist bin leaks a
    checkerboard ~5% of gradient amplitude into each axis."""
    import jax.numpy as jnp
    from lb2d_tpu.models.waves import _ScreenedVelocity

    ny = nx = 64  # even: Nyquist bin exists
    rng = np.random.RandomState(7)
    rho = jnp.asarray(rng.rand(ny, nx).astype(np.float32))
    vel = _ScreenedVelocity(ny, nx, lam=1.0, delta_x=1.0 / nx, vc=1.0,
                            ulb=1.0, method="fft")
    u, v = vel(rho)
    # reference form: two separate transforms, real part only, with the
    # Nyquist-derivative convention (odd multiplier -> zero at n/2)
    rescale, ax, ay = vel._fields()
    chat = jnp.fft.fft2(rho.astype(jnp.complex64)) * rescale
    xg = jnp.real(jnp.fft.ifft2(chat * (1j * ax)))
    yg = jnp.real(jnp.fft.ifft2(chat * (1j * ay)))
    np.testing.assert_allclose(np.asarray(u), vel.scale * np.asarray(xg),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(v), vel.scale * np.asarray(yg),
                               atol=1e-6)
    # and the Nyquist rows of the multipliers really are zeroed
    assert float(jnp.abs(vel._gx[nx // 2])) == 0.0
    assert float(jnp.abs(vel._gy[ny // 2])) == 0.0


def test_screened_gradients_mm_matches_numpy():
    """Fused half-spectrum solver (real fwd + packed inverse, transpose-free
    axis-0 passes) == numpy oracle at square and non-square sizes."""
    import jax
    import jax.numpy as jnp
    from lb2d_tpu.ops.dft import screened_gradients_mm

    rng = np.random.RandomState(0)
    for (ny, nx) in ((128, 128), (256, 128), (64, 256)):
        rho = rng.rand(ny, nx).astype(np.float32)
        fx = (np.fft.fftfreq(nx) * nx).astype(np.float32)
        fy = (np.fft.fftfreq(ny) * ny).astype(np.float32)
        gx = fx.copy(); gx[nx // 2] = 0.0
        gy = fy.copy(); gy[ny // 2] = 0.0
        lam2 = np.float32(0.25)
        xg, yg = jax.jit(lambda r: screened_gradients_mm(
            r, jnp.asarray(fx), jnp.asarray(fy), jnp.asarray(gx),
            jnp.asarray(gy), lam2))(jnp.asarray(rho))
        s = 1.0 / (lam2 * (fx[None, :]**2 + fy[:, None]**2) + 1.0)
        chat = np.fft.fft2(rho) * s
        xg_ref = np.real(np.fft.ifft2(chat * (2j * np.pi) * gx[None, :]))
        yg_ref = np.real(np.fft.ifft2(chat * (2j * np.pi) * gy[:, None]))
        sc = max(np.abs(xg_ref).max(), np.abs(yg_ref).max())
        assert np.abs(np.asarray(xg) - xg_ref).max() / sc < 1e-4
        assert np.abs(np.asarray(yg) - yg_ref).max() / sc < 1e-4


def test_screened_velocity_fast_path_matches_fft():
    """_ScreenedVelocity's fused matmul path == its fft path."""
    import jax.numpy as jnp
    from lb2d_tpu.models.waves import _ScreenedVelocity

    ny = nx = 64
    rng = np.random.RandomState(3)
    rho = jnp.asarray(rng.rand(ny, nx).astype(np.float32))
    kw = dict(lam=0.7, delta_x=1.0 / nx, vc=1.3, ulb=0.01)
    v_fft = _ScreenedVelocity(ny, nx, method="fft", **kw)
    v_mm = _ScreenedVelocity(ny, nx, method="matmul", **kw)
    u1, w1 = v_fft(rho)
    u2, w2 = v_mm(rho)
    sc = float(np.abs(np.asarray(u1)).max()) + 1e-12
    assert np.abs(np.asarray(u1) - np.asarray(u2)).max() / sc < 1e-4
    assert np.abs(np.asarray(w1) - np.asarray(w2)).max() / sc < 1e-4


def test_repelling_fisher_reuse_tolerance():
    """Potential reuse: tiny tolerance tracks the exact (always-solve)
    model; huge tolerance freezes the potential after the first solve."""
    kw = dict(Lx=1.0, Ly=1.0, E=2.0, R0=0.25, N=24, max_inner_iter=60,
              inner_tolerance=1e-4)
    exact = RepellingFisherWave(**kw)
    loose = RepellingFisherWave(reuse_tolerance=1e-4, **kw)
    frozen = RepellingFisherWave(reuse_tolerance=1e9, **kw)
    exact.run(30)
    loose.run(30)
    frozen.run(30)
    re_ = exact.get_fields()["rho"]
    rl = loose.get_fields()["rho"]
    sc = np.abs(re_).max()
    # tiny tolerance: fields stay close to exact over the horizon
    assert np.abs(re_ - rl).max() / sc < 5e-3, np.abs(re_ - rl).max() / sc
    # huge tolerance: the very first step solves (rho_ref starts at -1,
    # drift is large), afterwards the potential never updates
    pu_after_1 = RepellingFisherWave(reuse_tolerance=1e9, **kw)
    pu_after_1.run(1)
    np.testing.assert_array_equal(np.asarray(frozen.state[2]),
                                  np.asarray(pu_after_1.state[2]))


def test_repelling_fisher_tracking_mode():
    """Tracking mode (inner_per_step=k): the potential is converged once
    at init, then follows the wave with k fixed inner iterations per outer
    step. Drift vs the exact (converge-every-step) nested solve stays
    bounded over the horizon, and a larger budget tracks tighter."""
    kw = dict(Lx=1.0, Ly=1.0, E=2.0, R0=0.25, N=24, max_inner_iter=200,
              inner_tolerance=1e-5)
    exact = RepellingFisherWave(**kw)
    track1 = RepellingFisherWave(inner_per_step=1, **kw)
    track4 = RepellingFisherWave(inner_per_step=4, **kw)
    exact.run(40)
    track1.run(40)
    track4.run(40)
    re_ = exact.get_fields()["rho"]
    sc = np.abs(re_).max()
    d1 = np.abs(re_ - track1.get_fields()["rho"]).max() / sc
    d4 = np.abs(re_ - track4.get_fields()["rho"]).max() / sc
    assert d1 < 5e-3, d1
    assert d4 < 2e-3, d4
    assert d4 <= d1 + 1e-7, (d1, d4)
    # modes are mutually exclusive
    import pytest
    with pytest.raises(AssertionError):
        RepellingFisherWave(inner_per_step=1, reuse_tolerance=1e-4, **kw)


