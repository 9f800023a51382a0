"""Multi-device (mesh) wrappers for the whole-solve ensemble kernels.

Ensemble members are embarrassingly parallel, so the scale-out story for
the whole-solve integrators is ``shard_map`` over the mesh's member axis:
the member axis of every rows-layout array is split across devices and
each device runs the single-device solve on its local shard. No
collectives are needed -- the save buffers come back sharded the same way,
and downstream reductions (ensemble means, quantiles) run on the sharded
buffers with XLA inserting the cross-device reduce. The XLA engines scale
through GSPMD sharding instead (``simulate_ensemble(mesh=)``,
``parallel/mesh.py``).

Numerics:

- constant-step solves are member-math invariant to both the device split
  and the block width (each member is one thread for the whole solve), so
  a sharded solve is bit-identical to the single-device solve.
- the ADAPTIVE integrators share one dt chain per member block, so
  controller decisions depend on which members share a block. Pass an
  explicit ``block_b`` that divides the per-device batch to make the
  device split preserve block boundaries (bit-identical again); otherwise
  results agree only to the solve tolerance. The SEIP adaptive solve
  shares one chain per device.

On CPU devices (for example a virtual multi-device mesh) the entry points
take their ``lax`` route, which shard_map partitions like any other JAX
program.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from .generic_pallas import (
    ensemble_solve_kernel,
    ensemble_solve_kernel_adaptive,
)

__all__ = [
    "ensemble_solve_kernel_sharded",
    "ensemble_solve_kernel_adaptive_sharded",
    "seip_ensemble_solve_sharded",
    "seip_ensemble_solve_adaptive_sharded",
]


def _check_batch(batch: int, mesh: Mesh, axis_name: str) -> int:
    n_dev = mesh.shape[axis_name]
    if batch % n_dev:
        raise ValueError(
            f"ensemble width {batch} must divide over the {n_dev}-device "
            f"'{axis_name}' mesh axis"
        )
    return n_dev


def _static(kwargs) -> tuple:
    """Forwarded keyword arguments as a hashable jit key."""
    return tuple(sorted(
        (k, tuple(v) if isinstance(v, list) else v) for k, v in kwargs.items()
    ))


def _shard_members(fn, mesh, in_specs, out_specs, *args):
    # no collectives inside. check_vma stays off: the Pallas call declares
    # no varying-axes type on its outputs, and the lax routes' loop carries
    # start replicated (y0 broadcast, the scalar t/dt chain) and become
    # shard-varying once they meet member data
    return jax.shard_map(
        fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )(*args)


# Each wrapper is one jitted program keyed on its static configuration, so
# a repeated call reuses the compiled program: an un-jitted shard_map
# re-lowers its body (and recompiles the kernel) on every call.
@functools.partial(
    jax.jit,
    static_argnames=("solve", "rhs", "mesh", "axis_name", "out_specs",
                     "kwargs"),
)
def _rows_sharded_jit(y0_rows, p_rows, *, solve, rhs, mesh, axis_name,
                      out_specs, kwargs):
    return _shard_members(
        lambda y_loc, p_loc: solve(rhs, y_loc, p_loc, **dict(kwargs)),
        mesh, (P(None, axis_name), P(None, axis_name)), out_specs,
        y0_rows, p_rows,
    )


def _rows_sharded(solve, rhs, y0_rows, p_rows, mesh, axis_name, out_specs,
                  kwargs):
    y0_rows = jnp.asarray(y0_rows, jnp.float32)
    batch = y0_rows.shape[1]
    _check_batch(batch, mesh, axis_name)
    if p_rows is None:
        p_rows = jnp.zeros((0, batch), jnp.float32)
    return _rows_sharded_jit(
        y0_rows, jnp.asarray(p_rows, jnp.float32), solve=solve, rhs=rhs,
        mesh=mesh, axis_name=axis_name, out_specs=out_specs,
        kwargs=_static(kwargs),
    )


def ensemble_solve_kernel_sharded(
    rhs: Callable,
    y0_rows: jnp.ndarray,
    p_rows: jnp.ndarray | None = None,
    *,
    mesh: Mesh,
    axis_name: str = "ensemble",
    **kwargs,
):
    """:func:`ensemble_solve_kernel` with members sharded over a mesh axis.

    ``y0_rows``/``p_rows`` are the usual ``(R, B)``/``(P, B)`` rows arrays
    with ``B`` divisible by the mesh axis size; each device runs the
    whole-solve integrator on its ``B / n_devices`` member shard. Returns
    the ``(n_saves, rows, B)`` save buffer sharded along its member axis.
    All keyword arguments of the single-device entry are forwarded.
    """
    return _rows_sharded(
        ensemble_solve_kernel, rhs, y0_rows, p_rows, mesh, axis_name,
        P(None, None, axis_name), kwargs,
    )


def ensemble_solve_kernel_adaptive_sharded(
    rhs: Callable,
    y0_rows: jnp.ndarray,
    p_rows: jnp.ndarray | None = None,
    *,
    mesh: Mesh,
    axis_name: str = "ensemble",
    **kwargs,
):
    """:func:`ensemble_solve_kernel_adaptive` sharded over a mesh axis.

    Returns ``(saves, stats)`` exactly like the single-device entry; the
    per-block ``stats`` arrays concatenate each device's blocks along
    the block axis (device-major order). For bit-identical results across
    mesh widths pass ``block_b`` dividing the per-device batch (module
    docstring: the lockstep dt chain is per block).
    """
    return _rows_sharded(
        ensemble_solve_kernel_adaptive, rhs, y0_rows, p_rows, mesh,
        axis_name, (P(None, None, axis_name), P(axis_name)), kwargs,
    )


@functools.partial(
    jax.jit, static_argnames=("solve", "mesh", "axis_name", "kwargs")
)
def _seip_sharded_jit(y0, params, beta_scales, *, solve, mesh, axis_name,
                      kwargs):
    def local_solve(scales_loc):
        return solve(y0, params, scales_loc, **dict(kwargs))

    # every saved compartment comes back (T, *shape, B) member-last and
    # every stats array (1,) per device; read the ranks off an abstract eval
    shapes = jax.eval_shape(
        local_solve, jax.ShapeDtypeStruct(beta_scales.shape, beta_scales.dtype)
    )
    out_specs = jax.tree.map(
        lambda sd: P(*([None] * (len(sd.shape) - 1)), axis_name), shapes
    )
    return _shard_members(
        local_solve, mesh, (P(*([None] * (beta_scales.ndim - 1)), axis_name),),
        out_specs, beta_scales,
    )


def _seip_sharded(solve, y0, params, beta_scales, mesh, axis_name, kwargs):
    beta_scales = jnp.asarray(beta_scales)
    _check_batch(beta_scales.shape[-1], mesh, axis_name)
    return _seip_sharded_jit(
        y0, params, beta_scales, solve=solve, mesh=mesh, axis_name=axis_name,
        kwargs=_static(kwargs),
    )


def seip_ensemble_solve_sharded(
    y0,
    params,
    beta_scales,
    *,
    mesh: Mesh,
    axis_name: str = "ensemble",
    **kwargs,
):
    """:func:`~dynode_tpu.ops.seip.seip_ensemble_solve` over a mesh.

    ``beta_scales`` (``(B,)`` or ``(L, B)``) is sharded along its member
    axis; ``y0``/``params`` are shared by every member. Returns member-last
    saves sharded along the member axis, bit-identical to the
    single-device solve (each member is solved on its own).
    """
    from .seip import seip_ensemble_solve

    return _seip_sharded(
        seip_ensemble_solve, y0, params, beta_scales, mesh, axis_name, kwargs
    )


def seip_ensemble_solve_adaptive_sharded(
    y0,
    params,
    beta_scales,
    *,
    mesh: Mesh,
    axis_name: str = "ensemble",
    **kwargs,
):
    """Adaptive SEIP solve over a mesh (lockstep BS3(2), error-controlled).

    Same contract as :func:`seip_ensemble_solve_sharded`; returns
    ``(outs, stats)`` like the single-device entry, with the ``(1,)``
    stats arrays concatenated device-major. Each device runs its own
    lockstep dt chain over its members, so results agree with the
    single-device solve to the solve tolerance.
    """
    from .seip import seip_ensemble_solve_adaptive

    return _seip_sharded(
        seip_ensemble_solve_adaptive, y0, params, beta_scales, mesh,
        axis_name, kwargs,
    )
