"""Mesh construction and batch-sharding helpers.

The reference has no distributed layer at all (SURVEY.md section 2.8: no
pmap/pjit/mesh anywhere). The scaling axes of this domain are
*ensemble width* (vmapped parameter draws) and *chain count* (vectorized NUTS
chains); both are embarrassingly-parallel batch axes, so the entire
communication story is GSPMD: we annotate the batch axis with a
``NamedSharding`` and XLA partitions the one big program across the
devices with no hand-written collectives.

Conventions:
- mesh axes are named (e.g. ``("chain",)`` or ``("chain", "ensemble")``)
- a batched computation shards its leading axis over one named mesh axis via
  :func:`shard_batch`, leaving everything else replicated.
"""

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec


def default_device_count() -> int:
    """Number of visible JAX devices."""
    return len(jax.devices())


def create_mesh(
    axis_names: Sequence[str] = ("chain",),
    axis_sizes: Optional[Tuple[int, ...]] = None,
    devices=None,
) -> Mesh:
    """Build a named device mesh.

    Parameters
    ----------
    axis_names : sequence of str
        Mesh axis names, e.g. ``("chain",)`` or ``("chain", "ensemble")``.
    axis_sizes : tuple of int, optional
        Size per axis. Defaults to all devices on the first axis. A ``-1``
        entry is inferred from the device count (like a reshape).
    devices : optional explicit device list (defaults to ``jax.devices()``).
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if axis_sizes is None:
        axis_sizes = (n,) + (1,) * (len(axis_names) - 1)
    sizes = list(axis_sizes)
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    assert int(np.prod(sizes)) == n, (
        f"mesh axis sizes {sizes} must multiply to the device count {n}"
    )
    dev_array = np.asarray(devices).reshape(sizes)
    return Mesh(dev_array, tuple(axis_names))


def shard_batch(mesh: Mesh, axis_name: str = "chain") -> NamedSharding:
    """Sharding that splits an array's leading axis over ``axis_name``."""
    return NamedSharding(mesh, PartitionSpec(axis_name))


def ensemble_sharding(mesh: Mesh, axis_name: str = "ensemble") -> NamedSharding:
    """Alias of :func:`shard_batch` for ensemble axes (readability)."""
    return shard_batch(mesh, axis_name)


def replicated(mesh: Mesh) -> NamedSharding:
    """Sharding that replicates an array on every device of the mesh."""
    return NamedSharding(mesh, PartitionSpec())


def host_batch(mesh: Mesh, batch: int, axis_name: str) -> int:
    """Round ``batch`` up to a multiple of the mesh axis size.

    Sharded batch axes must divide evenly across devices; callers pad their
    parameter stacks to this size (extra lanes are free throughput).
    """
    size = mesh.shape[axis_name]
    return -(-batch // size) * size


def device_put_sharded_tree(tree, sharding: NamedSharding):
    """``jax.device_put`` every leaf of a pytree with the given sharding."""
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sharding), tree)


def jit_donated(fn, donate_argnums=(0,), **jit_kwargs):
    """``jax.jit`` with buffer donation where the backend honors it.

    Donation aliases an input buffer to an output (free HBM headroom for
    iterated programs: MCMC chunk carries, warm ensemble loops -- on wide
    banks the carry is the dominant live allocation). CPU ignores
    donation and warns per call, so this helper only requests it off
    the CPU; semantics are identical either way, callers just must not
    reuse a donated argument after the call.
    """
    if jax.default_backend() != "cpu":
        return jax.jit(fn, donate_argnums=donate_argnums, **jit_kwargs)
    return jax.jit(fn, **jit_kwargs)


__all__ = [
    "create_mesh",
    "default_device_count",
    "shard_batch",
    "ensemble_sharding",
    "replicated",
    "host_batch",
    "device_put_sharded_tree",
    "jit_donated",
]
