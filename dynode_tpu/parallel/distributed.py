"""Multi-host scaffolding: ``jax.distributed`` + host-aware meshes.

Single-host meshes (``parallel/mesh.py``) cover the cards of one machine,
which NVLink joins all to all. Scaling past one host needs two more
pieces, both thin by design because GSPMD does the heavy lifting:

1. **Runtime initialization** — ``jax.distributed.initialize()`` so every
   process sees the global device set. :func:`initialize_distributed`
   wraps it idempotently and no-ops on a single host, so the same entry
   script runs unchanged on a laptop, one machine, or a cluster. Nothing
   discovers a GPU cluster automatically: pass ``coordinator_address``,
   ``num_processes`` and ``process_id``.
2. **Host-aware mesh layout** — between hosts, traffic moves over the
   network, far slower than NVLink inside a host. A mesh must therefore
   keep axes with heavy communication INSIDE a host and put only
   embarrassingly-parallel axes (chains, ensemble members, SVI starts —
   everything this framework shards) across hosts.
   :func:`create_hybrid_mesh` builds exactly that split, grouping devices
   by ``process_index``.

For this domain every sharded axis is a batch axis (SURVEY.md section 2.8:
chain banks, ensemble width, multi-start SVI), so the cross-host story is
the best case: zero cross-host collectives in the hot loop; only the final
posterior/summary reductions cross hosts. The reference itself has no
distributed layer at all (no pmap/pjit/mesh anywhere in
CDCgov/DynODE/src) — this module is the counterpart SURVEY section 2.8
item 3 calls for (mesh construction, axis naming, donation live in
``mesh.py``; process bootstrap and cross-host layout here).
"""

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

_INITIALIZED = False


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
) -> bool:
    """Idempotent ``jax.distributed.initialize`` wrapper.

    Call once at program start in EVERY process of a multi-host deployment
    (before any jax computation), with the coordinator's address (e.g.
    ``"localhost:<port>"`` on one machine), the process count and this
    process's id. Without arguments on a single process (or when already
    initialized) this is a no-op returning False.

    Returns True iff a multi-process runtime was (or already had been)
    initialized by this call.
    """
    global _INITIALIZED
    if _INITIALIZED:
        return True
    if num_processes is None and coordinator_address is None:
        # single-host shortcut: nothing to coordinate
        if jax.process_count() == 1:
            return False
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            **kwargs,
        )
        _INITIALIZED = True
        return True
    except RuntimeError as e:  # already initialized by the launcher
        if "already" in str(e).lower():
            _INITIALIZED = True
            return True
        raise


def create_hybrid_mesh(
    axis_names: Sequence[str] = ("host", "chain"),
    host_axis: str = "host",
    num_hosts: Optional[int] = None,
    devices=None,
) -> Mesh:
    """Mesh whose ``host_axis`` spans hosts and the rest span each host.

    Devices are grouped by ``process_index`` (one process per host);
    ``num_hosts`` defaults to the number of processes that own
    ``devices`` (1 on a single host, where this is a plain
    :func:`create_mesh` with a size-1 ``host_axis``). The last non-host
    axis gets all devices of each host; other non-host axes have size 1.
    Passing ``num_hosts`` splits the device list into that many contiguous
    blocks instead (a stand-in for hosts on one machine).

    Shard ONLY embarrassingly-parallel batch axes over ``host_axis``:
    chains (``MCMC(mesh=...)``), ensemble members, SVI starts. Model/state
    axes must stay inside a host — this framework never shards them.
    """
    if devices is None:
        devices = jax.devices()
    # host-major; a stable sort keeps each host's own device order
    devices = sorted(devices, key=lambda d: d.process_index)
    if num_hosts is None:
        num_hosts = len({d.process_index for d in devices})
    if host_axis not in axis_names:
        raise ValueError(f"host_axis {host_axis!r} not in {axis_names}")
    n = len(devices)
    if n % num_hosts:
        raise ValueError(f"{n} devices do not split over {num_hosts} hosts")
    shape = [num_hosts if a == host_axis else 1 for a in axis_names]
    inner = [k for k, a in enumerate(axis_names) if a != host_axis]
    if inner:
        shape[inner[-1]] = n // num_hosts
    return Mesh(np.asarray(devices).reshape(shape), tuple(axis_names))


__all__ = ["initialize_distributed", "create_hybrid_mesh"]
