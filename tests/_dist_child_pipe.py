"""Two-process distributed-execution child.

Spawned (twice) by ``test_sharding.py::test_distributed_two_process_parity``
and by ``__graft_entry__.dryrun_multichip``: each process owns 4 virtual CPU
devices; ``init_distributed`` joins them through a localhost coordinator into
one 8-device job, and :class:`ShardedPipeFlow` runs over the global
``("y", "x")`` mesh unchanged — the multi-process story of SURVEY §2.4
executed for real (the reference is single-process: ``dimensionless/opencl_dim.py:
239-240`` picks ``devices[0]``).

argv: process_id coordinator_port num_steps
"""

import json
import os
import sys

# 4 local devices per process (the parent's 8-device XLA_FLAGS is replaced;
# the env var is read when the lazy CPU backend first initializes).
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
PID, PORT, STEPS = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from lb2d_tpu.parallel.distributed import (  # noqa: E402
    global_mesh,
    init_distributed,
)

init_distributed(coordinator_address=f"localhost:{PORT}",
                 num_processes=2, process_id=PID)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())
assert len(jax.local_devices()) == 4, len(jax.local_devices())

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from lb2d_tpu.parallel.sharded import ShardedPipeFlow  # noqa: E402

mesh = global_mesh(shape=(8, 1))
sim = ShardedPipeFlow(mesh=mesh, N=15, pipe_length=1.5 * 30.5 / 15,
                      diameter=1.5, rho=10.0, viscosity=5.0,
                      pressure_grad=-100.0)
sim.run(STEPS)

# Replicate the diagnostics so every process can read them: a global mass
# scalar and the x- and direction-summed f profile (a [ny] vector — catches
# any spatial mis-assembly a scalar would hide).
rep = jax.jit(lambda f: (jnp.sum(f), jnp.sum(f, axis=(0, 2))),
              out_shardings=NamedSharding(mesh, P()))(sim.state)
mass, prof = float(rep[0]), np.asarray(rep[1])
assert np.isfinite(prof).all()
print("RESULT " + json.dumps({
    "pid": PID, "ndev": len(jax.devices()), "nproc": jax.process_count(),
    "backend": sim.backend, "mass": mass, "prof": prof.tolist()}),
    flush=True)
