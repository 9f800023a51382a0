"""Multi-host scaffolding: single-host no-op + hybrid-mesh layout.

Real cross-host behavior needs several hosts; what CAN be pinned on the
8-virtual-device CPU harness is the contract: ``initialize_distributed``
no-ops cleanly on one host, and ``create_hybrid_mesh`` produces a
correctly-shaped named mesh (degenerate single-host case, and the
host-major device order when we force a 2-host split) that actually
shards a program.
"""

import jax
import jax.numpy as jnp
import numpy as np

from dynode_tpu.parallel import (
    create_hybrid_mesh,
    initialize_distributed,
    shard_batch,
)


def test_initialize_distributed_single_host_noop():
    assert initialize_distributed() is False
    assert jax.process_count() == 1  # untouched


def test_hybrid_mesh_single_slice_degenerates():
    mesh = create_hybrid_mesh(("host", "chain"))
    assert mesh.axis_names == ("host", "chain")
    assert mesh.devices.shape == (1, len(jax.devices()))


def test_hybrid_mesh_runs_a_sharded_program():
    n = len(jax.devices())
    mesh = create_hybrid_mesh(("host", "chain"))
    x = jnp.arange(4 * n, dtype=jnp.float32).reshape(4 * n, 1)
    xs = jax.device_put(x, shard_batch(mesh, "chain"))
    y = jax.jit(lambda a: (a * 2).sum(axis=1))(xs)
    np.testing.assert_allclose(np.asarray(y), np.asarray(x[:, 0] * 2))


def test_hybrid_mesh_forced_two_slice_split():
    # stand in for 2 hosts on the virtual-device harness: the host axis
    # must become the mesh's leading blocks (host-major device order)
    devs = jax.devices()
    if len(devs) < 4:
        import pytest

        pytest.skip("needs >= 4 devices")
    mesh = create_hybrid_mesh(("host", "chain"), num_hosts=2, devices=devs)
    assert mesh.devices.shape == (2, len(devs) // 2)
    flat = list(mesh.devices.ravel())
    assert len(set(flat)) == len(devs)
