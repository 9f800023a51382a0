"""Subprocess body for the 2-process jax.distributed test.

Usage: python _dist_worker.py <process_id> <port>

Each of the two processes owns 2 virtual CPU devices (4 global). Steps:
1. initialize_distributed against the shared coordinator,
2. create_hybrid_mesh with the process boundary as the host axis,
3. reduce a globally-sharded array (gloo all-reduce) and check the value,
4. run a sharded multistrain ensemble solve (the library's flagship
   batch-axis sharding) from host-local shards to a replicated summary,
   and compare against the same ensemble solved unsharded in-process.

Prints WORKER_OK as the last line on success; any assertion or crash
leaves it absent (the parent test asserts on it).
"""

import os
import sys

pid, port = int(sys.argv[1]), sys.argv[2]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_cpu_collectives_implementation", "gloo")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental import multihost_utils  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from dynode_tpu import simulate  # noqa: E402
from dynode_tpu.config import SolverParams  # noqa: E402
from dynode_tpu.models.multistrain import (  # noqa: E402
    multistrain_config,
    multistrain_initial_state,
    multistrain_ode,
    multistrain_odeparams,
)
from dynode_tpu.parallel.distributed import (  # noqa: E402
    create_hybrid_mesh,
    initialize_distributed,
)

assert initialize_distributed(
    coordinator_address=f"localhost:{port}", num_processes=2, process_id=pid
)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 4, jax.devices()

mesh = create_hybrid_mesh(("host", "chain"))  # groups by process_index
assert mesh.shape == {"host": 2, "chain": 2}, mesh.shape
assert all(
    d.process_index == h for h, row in enumerate(mesh.devices) for d in row
)

# --- 1. global reduction over a process-spanning sharded array ------------
local = np.arange(8.0).reshape(4, 2)[2 * pid : 2 * pid + 2]
xg = multihost_utils.host_local_array_to_global_array(
    local, mesh, P(("host", "chain"))
)
total = jax.jit(lambda a: jnp.sum(a * a))(xg)
assert abs(float(total) - 140.0) < 1e-9, float(total)

# --- 2. sharded ensemble solve: batch axis across BOTH processes ---------
B = 16  # global ensemble width; each process holds B//2 members
cfg = multistrain_config(solver_params=SolverParams(constant_step_size=0.5))
base = multistrain_odeparams(cfg)
y0 = multistrain_initial_state(cfg)
sp = cfg.parameters.solver_params

scales_global = np.linspace(0.9, 1.1, B)
scales_local = scales_global[pid * (B // 2) : (pid + 1) * (B // 2)]
sg = multihost_utils.host_local_array_to_global_array(
    scales_local, mesh, P(("host", "chain"))
)


def solve_one(scale):
    sol = simulate(
        multistrain_ode, 20, y0,
        base.replace(beta=base.beta * scale), sp,
        sub_save_indices=(4,),
    )
    return sol.ys[4][-1]  # final cumulative incidence (A, K)


@jax.jit
def summary(scales):
    finals = jax.vmap(solve_one)(scales)  # (B, A, K) sharded on B
    return jnp.sum(finals, axis=0)  # replicated (A, K)


got = np.asarray(summary(sg))  # replicated -> addressable everywhere

# unsharded single-process reference on local CPU devices
want = np.asarray(
    jax.jit(lambda s: jnp.sum(jax.vmap(solve_one)(s), axis=0))(
        jnp.asarray(scales_global)
    )
)
np.testing.assert_allclose(got, want, rtol=1e-12)

print(f"[p{pid}] WORKER_OK", flush=True)
