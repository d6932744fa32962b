"""Multi-host (multi-process) runtime initialization.

The reference is strictly single-process/single-device
(``opencl_dim.py:229-240`` picks ``devices[0]``); SURVEY.md §2.4 names
``jax.distributed`` collectives as the scaling answer beyond one process.
This module is that entry point: initialize the JAX distributed runtime,
build a global ``("y", "x")`` mesh over every device in the job, and hand
back the same mesh object every sharded surface in
:mod:`lb2d_tpu.parallel.sharded` already consumes — the sharded programs
are SPMD over *global* devices, so nothing else changes between one
process and many.

Single-process environments (including the CI dry run) use
``num_processes=1``, which skips the coordinator handshake entirely.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["init_distributed", "global_mesh", "is_initialized"]

_initialized = False


def is_initialized() -> bool:
    return _initialized


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None) -> None:
    """Initialize the multi-process JAX runtime (no-op for 1 process).

    Mirrors ``jax.distributed.initialize``: every process in the job calls
    this before any computation, with the same ``coordinator_address``
    (host:port of process 0) and its own ``process_id``; nothing infers
    them from the environment. After this, ``jax.devices()`` enumerates
    every device in the job and the sharded models run unchanged over a
    :func:`global_mesh`.
    """
    global _initialized
    if num_processes in (None, 1) and coordinator_address is None:
        # single-process: nothing to coordinate; mark initialized so
        # callers can treat the two paths uniformly
        _initialized = True
        return
    if "cpu" in str(jax.config.jax_platforms or ""):
        # CPU multi-process jobs (the 2-process parity test) need a real
        # cross-process collectives backend; gloo ships with jaxlib.
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    _initialized = True


def global_mesh(shape: tuple[int, int] | None = None) -> Mesh:
    """A ``("y", "x")`` mesh over every device in the (possibly
    multi-process) job, factored as square as possible unless ``shape`` is
    given. Devices keep enumeration order along y first, so each process's
    addressable shards are contiguous grid rows and y-halo exchanges cross
    process boundaries only at shard seams."""
    devices = jax.devices()
    n = len(devices)
    if shape is None:
        my = int(np.floor(np.sqrt(n)))
        while n % my:
            my -= 1
        shape = (n // my, my)
    assert shape[0] * shape[1] == n, (shape, n)
    return Mesh(np.asarray(devices).reshape(shape), ("y", "x"))
