"""Native C++ CPU backend (the Cython-extension counterpart).

The reference ships a compiled CPU path (``cython_dim.pyx`` built by
``setup.py:8-10``) alongside its pure-Python and device paths; this module is
its equivalent here: ``lb_d2q9.cpp`` compiled on demand with the system g++
(``-O3 -fopenmp``) and driven through ctypes — no pybind11 dependency.

Use :func:`native_run` for raw stepping or ``PipeFlow(backend="native")``
through the model API. Verified against the XLA oracle in
``tests/test_native.py``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

__all__ = ["build", "native_run", "is_available"]

_SRC = os.path.join(os.path.dirname(__file__), "lb_d2q9.cpp")
_LIB = None
_BUILD_ERR = None


def build(force: bool = False):
    """Compile (once) and load the shared library. Returns the ctypes CDLL."""
    global _LIB, _BUILD_ERR
    if _LIB is not None and not force:
        return _LIB
    cache_dir = os.path.join(tempfile.gettempdir(), "lb2d_tpu_native")
    os.makedirs(cache_dir, exist_ok=True)
    so_path = os.path.join(cache_dir, "lb_d2q9.so")
    if force or not os.path.exists(so_path) or (
            os.path.getmtime(so_path) < os.path.getmtime(_SRC)):
        cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
               _SRC, "-o", so_path]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            _BUILD_ERR = getattr(e, "stderr", str(e))
            raise RuntimeError(f"native build failed: {_BUILD_ERR}") from e
    lib = ctypes.CDLL(so_path)
    lib.lb2d_run.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.lb2d_run.restype = None
    _LIB = lib
    return lib


def is_available() -> bool:
    try:
        build()
        return True
    except RuntimeError:
        return False


def native_run(f, n_steps, *, omega, inlet_rho, outlet_rho,
               incompressible=False, mask=None):
    """Advance ``f [9, ny, nx] float32`` by ``n_steps`` on the CPU.

    Returns a new array (the input is not modified). ``mask`` is an optional
    int32 obstacle mask [ny, nx].
    """
    lib = build()
    f = np.ascontiguousarray(np.asarray(f), dtype=np.float32).copy()
    q, ny, nx = f.shape
    assert q == 9
    tmp = np.empty_like(f)
    if mask is not None:
        mask = np.ascontiguousarray(np.asarray(mask), dtype=np.int32)
        assert mask.shape == (ny, nx)
        mask_ptr = mask.ctypes.data_as(ctypes.c_void_p)
    else:
        mask_ptr = None
    lib.lb2d_run(
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        tmp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mask_ptr, ny, nx,
        np.float32(omega), np.float32(inlet_rho), np.float32(outlet_rho),
        int(bool(incompressible)), int(n_steps),
    )
    return f
