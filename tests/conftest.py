"""Test configuration: force an 8-virtual-device CPU platform.

The tests run on the CPU; sharding tests exercise the multi-device code
paths on a virtual host-device mesh exactly as ``dryrun_multichip`` does.
The platform is set through ``jax.config`` after import (whatever
``JAX_PLATFORMS`` says), and ``XLA_FLAGS`` before the lazy CPU backend
initializes. Tests that need a card carry the ``gpu`` marker and decide
inside a fixture whether one is present.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
