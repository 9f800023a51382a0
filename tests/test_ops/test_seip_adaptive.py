"""Adaptive (lockstep-dt) SEIP ensemble solve: contract tests.

``seip_ensemble_solve_adaptive`` is the pure-JAX lockstep BS3(2) solve
(one dt chain over the ensemble); these tests pin its accuracy against a
dense-grid RK4 oracle and the budget-exhaustion / save-selection / dtype
contracts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dynode_tpu.config import SolverParams
from dynode_tpu.models.seip import (
    seip_config,
    seip_initial_state,
    seip_odeparams,
)
from dynode_tpu.ops.seip import (
    seip_ensemble_solve_adaptive,
    seip_solve_reference,
)


@pytest.fixture(scope="module")
def setup():
    cfg = seip_config(
        seasonal_vaccination=True,
        solver_params=SolverParams(constant_step_size=0.5),
    )
    p = seip_odeparams(cfg)
    y0 = seip_initial_state(cfg)
    scales = jnp.asarray([0.9, 1.0, 1.1], jnp.float32)
    return p, y0, scales


def test_adaptive_tracks_dense_oracle(setup):
    p, y0, scales = setup
    outs, stats = seip_ensemble_solve_adaptive(
        y0, p, scales, duration=30, rtol=1e-5, atol=1e-5
    )
    assert int(np.asarray(stats["exhausted_intervals"]).sum()) == 0
    # the controller really adapts: more than one accepted step per save
    # interval on average, and at least one step size change happened
    assert int(np.asarray(stats["n_accepted"]).sum()) > 35
    ref = seip_solve_reference(y0, p, scales, duration=30, dt=0.01)
    for o, r in zip(outs, ref):
        o = np.asarray(o, np.float64)
        r = np.asarray(r, np.float64)
        assert np.isfinite(o).all()
        rel = np.max(np.abs(o - r)) / np.max(np.abs(r))
        assert rel < 1e-3, rel


def test_tolerance_scales_step_count(setup):
    p, y0, scales = setup
    _, loose = seip_ensemble_solve_adaptive(
        y0, p, scales, duration=30, rtol=1e-3, atol=1e-2
    )
    _, tight = seip_ensemble_solve_adaptive(
        y0, p, scales, duration=30, rtol=1e-6, atol=1e-6,
        steps_per_save=32,
    )
    assert int(np.asarray(tight["n_accepted"]).sum()) > 2 * int(
        np.asarray(loose["n_accepted"]).sum()
    )


def test_budget_exhaustion_is_loud_and_recovers(setup):
    p, y0, scales = setup
    outs, stats = seip_ensemble_solve_adaptive(
        y0, p, scales, duration=10, rtol=1e-6, atol=1e-6, steps_per_save=1
    )
    bad = int(np.asarray(stats["exhausted_intervals"]).sum())
    assert bad > 0
    s = np.asarray(outs[0])
    nan_days = [
        t for t in range(s.shape[0]) if not np.isfinite(s[t]).all()
    ]
    # exhausted intervals emit NaN saves (loud), day 0 is always the
    # initial state, and the flag count matches the NaN days
    assert nan_days and 0 not in nan_days
    assert len(nan_days) == bad


def test_save_selection_packing_and_dtype(setup):
    p, y0, scales = setup
    full, _ = seip_ensemble_solve_adaptive(
        y0, p, scales, duration=5, rtol=1e-4, atol=1e-3
    )
    c_only, _ = seip_ensemble_solve_adaptive(
        y0, p, scales, duration=5, rtol=1e-4, atol=1e-3, save=(3,)
    )
    assert len(full) == 4 and len(c_only) == 1
    np.testing.assert_array_equal(np.asarray(c_only[0]), np.asarray(full[3]))

    bf, _ = seip_ensemble_solve_adaptive(
        y0, p, scales, duration=5, rtol=1e-4, atol=1e-3, save=(3,),
        save_dtype=jnp.bfloat16,
    )
    assert bf[0].dtype == jnp.bfloat16
    np.testing.assert_allclose(
        np.asarray(bf[0], np.float32),
        np.asarray(full[3], np.float32),
        rtol=1e-2,
        atol=1e-2,
    )


def test_duration_must_be_save_multiple(setup):
    p, y0, scales = setup
    with pytest.raises(ValueError):
        seip_ensemble_solve_adaptive(
            y0, p, scales, duration=10.5, save_every=1.0
        )
