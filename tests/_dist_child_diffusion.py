"""Two-process distributed-execution child — the GSPMD family path.

Spawned (twice) by
``test_sharding.py::test_distributed_two_process_kernel_parity``: each
process owns 4 virtual CPU devices; ``init_distributed`` joins them into one
8-device job, and :class:`ShardedDiffusion` runs the family's XLA step under
GSPMD, so the rolls' halo collective-permutes cross a real PROCESS boundary
(the sibling ``_dist_child_pipe.py`` covers the ``shard_map`` flow path).

argv: process_id coordinator_port num_steps
"""

import json
import os
import sys

# 4 local devices per process (see _dist_child_pipe.py for why this works)
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

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from lb2d_tpu.models.diffusion import ReactionAdvectionDiffusion  # noqa: E402
from lb2d_tpu.parallel.sharded import ShardedDiffusion  # noqa: E402

mesh = global_mesh(shape=(8, 1))
base = ReactionAdvectionDiffusion(N=254, z=0.1, D=0.005, vx=1.0, vy=0.5,
                                  vc=1.0, Lx=0.101, Ly=0.101, g=1.0)
assert (base.ny, base.nx) == (256, 256), (base.ny, base.nx)
sim = ShardedDiffusion(base, mesh=mesh)
sim.run(STEPS)

# Replicated diagnostics every process can read: global mass + the x- and
# direction-summed profile (a [ny] vector catches spatial mis-assembly).
rep = jax.jit(lambda f: (jnp.sum(f), jnp.sum(f, axis=(0, 2))),
              out_shardings=NamedSharding(mesh, P()))(sim.state)
mass, prof = float(rep[0]), np.asarray(rep[1])
assert np.isfinite(prof).all()
print("RESULT " + json.dumps({
    "pid": PID, "ndev": len(jax.devices()), "nproc": jax.process_count(),
    "mass": mass, "prof": prof.tolist()}),
    flush=True)
