"""Multi-device shard_map wrappers for the whole-solve kernels.

On the 8-virtual-CPU-device mesh the entry points take their lax route,
so most of these tests validate the partitioning logic (in/out specs,
member-axis splits, stats concatenation) that the GPU path uses; the
interpret-mode cases run the Pallas kernel itself inside ``shard_map`` --
the contract ``chip_smoke.py --four`` checks on four cards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dynode_tpu.ops import (
    ensemble_solve_kernel,
    ensemble_solve_kernel_adaptive,
    ensemble_solve_kernel_adaptive_sharded,
    ensemble_solve_kernel_sharded,
    seip_ensemble_solve_sharded,
)
from dynode_tpu.parallel import create_mesh


def _sir_rows(batch):
    """Well-conditioned proportion-scale SIR rows workload."""
    y0 = jnp.stack([
        jnp.full((batch,), 0.9),
        jnp.full((batch,), 0.1),
        jnp.zeros((batch,)),
    ])
    p = jnp.stack([
        jnp.linspace(0.5, 1.5, batch),   # beta
        jnp.full((batch,), 0.3),         # gamma
    ])

    def rhs(y, p, t):
        s, i, r = y
        beta, gamma = p
        inf = beta * s * i
        rec = gamma * i
        return [-inf, inf - rec, rec]

    return rhs, y0, p


def test_const_kernel_sharded_bit_identical():
    mesh = create_mesh(("ensemble",))
    rhs, y0, p = _sir_rows(64)
    single = ensemble_solve_kernel(rhs, y0, p, duration=20.0, dt=0.5)
    shard = ensemble_solve_kernel_sharded(
        rhs, y0, p, mesh=mesh, duration=20.0, dt=0.5
    )
    assert shard.shape == single.shape
    np.testing.assert_array_equal(np.asarray(single), np.asarray(shard))


def test_const_kernel_sharded_save_rows_and_dtype():
    mesh = create_mesh(("ensemble",))
    rhs, y0, p = _sir_rows(32)
    shard = ensemble_solve_kernel_sharded(
        rhs, y0, p, mesh=mesh, duration=10.0, dt=0.5,
        save_rows=(2,), save_dtype=jnp.bfloat16,
    )
    single = ensemble_solve_kernel(
        rhs, y0, p, duration=10.0, dt=0.5,
        save_rows=(2,), save_dtype=jnp.bfloat16,
    )
    assert shard.dtype == jnp.bfloat16 and shard.shape == (11, 1, 32)
    np.testing.assert_array_equal(np.asarray(single), np.asarray(shard))


def test_adaptive_kernel_sharded_matches_tolerance():
    mesh = create_mesh(("ensemble",))
    rhs, y0, p = _sir_rows(64)
    kw = dict(duration=20.0, rtol=1e-4, atol=1e-6, steps_per_save=16)
    shard, st = ensemble_solve_kernel_adaptive_sharded(
        rhs, y0, p, mesh=mesh, **kw
    )
    single, st1 = ensemble_solve_kernel_adaptive(rhs, y0, p, **kw)
    # per-shard lockstep blocks must not run out of budget
    assert int(jnp.asarray(st["exhausted_intervals"]).sum()) == 0
    assert int(jnp.asarray(st1["exhausted_intervals"]).sum()) == 0
    # stats concatenate one entry per device-local block (8 devices)
    assert st["exhausted_intervals"].shape == (8,)
    # different block partitions -> same answer to solve tolerance
    np.testing.assert_allclose(
        np.asarray(shard), np.asarray(single), rtol=0, atol=5e-4
    )


def test_sharded_batch_must_divide_mesh():
    mesh = create_mesh(("ensemble",))
    rhs, y0, p = _sir_rows(30)  # 30 % 8 != 0
    with pytest.raises(ValueError, match="divide"):
        ensemble_solve_kernel_sharded(
            rhs, y0, p, mesh=mesh, duration=5.0, dt=0.5
        )


def test_seip_sharded_bit_identical():
    from dynode_tpu.config import SolverParams
    from dynode_tpu.models.seip import (
        seip_config,
        seip_initial_state,
        seip_odeparams,
    )
    from dynode_tpu.ops.seip import seip_ensemble_solve

    mesh = create_mesh(("ensemble",))
    cfg = seip_config(solver_params=SolverParams(constant_step_size=0.5))
    base = seip_odeparams(cfg)
    y0 = seip_initial_state(cfg)
    scales = jnp.linspace(0.9, 1.1, 16)
    kw = dict(duration=3, dt=0.5, save=(3,))
    ref = seip_ensemble_solve(y0, base, scales, **kw)
    got = seip_ensemble_solve_sharded(y0, base, scales, mesh=mesh, **kw)
    assert len(got) == len(ref)
    np.testing.assert_array_equal(np.asarray(ref[0]), np.asarray(got[0]))


def test_seip_adaptive_sharded_matches_tolerance():
    from dynode_tpu.config import SolverParams
    from dynode_tpu.models.seip import (
        seip_config,
        seip_initial_state,
        seip_odeparams,
    )
    from dynode_tpu.ops import seip_ensemble_solve_adaptive_sharded
    from dynode_tpu.ops.seip import seip_ensemble_solve_adaptive

    mesh = create_mesh(("ensemble",))
    cfg = seip_config(solver_params=SolverParams(constant_step_size=0.5))
    base = seip_odeparams(cfg)
    y0 = seip_initial_state(cfg)
    scales = jnp.linspace(0.9, 1.1, 16)
    kw = dict(duration=3, rtol=1e-4, atol=1e-3, save=(3,),
              steps_per_save=16)
    ref_outs, ref_stats = seip_ensemble_solve_adaptive(y0, base, scales, **kw)
    got_outs, got_stats = seip_ensemble_solve_adaptive_sharded(
        y0, base, scales, mesh=mesh, **kw
    )
    assert int(jnp.asarray(got_stats["exhausted_intervals"]).sum()) == 0
    # one stats entry per device-local block (8 devices, 1 block each)
    assert got_stats["exhausted_intervals"].shape == (8,)
    np.testing.assert_allclose(
        np.asarray(got_outs[0], dtype=np.float64),
        np.asarray(ref_outs[0], dtype=np.float64),
        rtol=5e-3, atol=1e-6,
    )


@pytest.mark.parametrize("adaptive", [False, True])
def test_kernel_sharded_interpret_bit_identical(adaptive):
    """The Pallas kernel inside shard_map equals the single-device kernel
    when the block divides the per-device batch (adaptive: the device
    split then preserves every block's dt chain)."""
    mesh = create_mesh(("ensemble",))
    rhs, y0, p = _sir_rows(256)
    if adaptive:
        solve, solve_sharded = (
            ensemble_solve_kernel_adaptive,
            ensemble_solve_kernel_adaptive_sharded,
        )
        kw = dict(duration=6.0, rtol=1e-4, atol=1e-6)
    else:
        solve, solve_sharded = (
            ensemble_solve_kernel, ensemble_solve_kernel_sharded,
        )
        kw = dict(duration=6.0, dt=0.5)
    kw.update(block_b=32, interpret=True)
    single = solve(rhs, y0, p, **kw)
    shard = solve_sharded(rhs, y0, p, mesh=mesh, **kw)
    for a, b in zip(jax.tree.leaves(single), jax.tree.leaves(shard)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_result_is_actually_sharded():
    """The save buffer must come back sharded over the mesh, not gathered."""
    mesh = create_mesh(("ensemble",))
    rhs, y0, p = _sir_rows(64)
    shard = ensemble_solve_kernel_sharded(
        rhs, y0, p, mesh=mesh, duration=5.0, dt=0.5
    )
    spec = shard.sharding.spec
    assert spec[-1] == "ensemble", spec
