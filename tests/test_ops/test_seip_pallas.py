"""SEIP constant-step ensemble solve (XLA on every platform).

``seip_ensemble_solve`` is the RK4 lax.scan reference; these tests pin it
against the production ``seip_ode`` RHS solved by the generic engine (same
model family, independent time integration) and check save selection,
save dtype and mass conservation. ``chip_smoke.py`` repeats the engine
comparison on a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np

from dynode_tpu import simulate
from dynode_tpu.config import SolverParams
from dynode_tpu.models.seip import (
    seip_config,
    seip_initial_state,
    seip_ode,
    seip_odeparams,
)
from dynode_tpu.ops.seip import seip_ensemble_solve, seip_solve_reference


def test_selective_save_subsets_full_solve():
    cfg = seip_config(
        seasonal_vaccination=True,
        solver_params=SolverParams(constant_step_size=0.5),
    )
    p = seip_odeparams(cfg)
    y0 = seip_initial_state(cfg)
    scales = jnp.asarray([0.95, 1.05], dtype=jnp.float32)
    full = seip_ensemble_solve(y0, p, scales, duration=10)
    c_only = seip_ensemble_solve(y0, p, scales, duration=10, save=(3,))
    assert len(full) == 4 and len(c_only) == 1
    np.testing.assert_array_equal(np.asarray(c_only[0]), np.asarray(full[3]))
    s_i = seip_ensemble_solve(y0, p, scales, duration=10, save=(2, 0))
    np.testing.assert_array_equal(np.asarray(s_i[0]), np.asarray(full[0]))
    np.testing.assert_array_equal(np.asarray(s_i[1]), np.asarray(full[2]))


def test_bf16_saves_round_the_f32_solve():
    # save_dtype only rounds the MATERIALIZED saves; state math stays f32
    cfg = seip_config(
        seasonal_vaccination=True,
        solver_params=SolverParams(constant_step_size=0.5),
    )
    p = seip_odeparams(cfg)
    y0 = seip_initial_state(cfg)
    scales = jnp.asarray([0.95, 1.05], dtype=jnp.float32)
    (c32,) = seip_ensemble_solve(y0, p, scales, duration=10, save=(3,))
    (c16,) = seip_ensemble_solve(
        y0, p, scales, duration=10, save=(3,), save_dtype=jnp.bfloat16
    )
    assert c16.dtype == jnp.bfloat16 and c16.shape == c32.shape
    a32 = np.asarray(c32, np.float64)
    a16 = np.asarray(c16.astype(jnp.float32), np.float64)
    denom = np.maximum(np.abs(a32), 1.0)
    assert float(np.max(np.abs(a16 - a32) / denom)) < 8e-3  # bf16 grid


def test_save_validation():
    import pytest

    cfg = seip_config(solver_params=SolverParams(constant_step_size=0.5))
    p = seip_odeparams(cfg)
    y0 = seip_initial_state(cfg)
    for bad in ((), (4,), (-1, 2)):
        with pytest.raises(ValueError, match="save"):
            seip_ensemble_solve(y0, p, jnp.ones(2), duration=2, save=bad)


def test_reference_matches_generic_engine():
    cfg = seip_config(
        seasonal_vaccination=True,
        solver_params=SolverParams(constant_step_size=0.25),
    )
    p = seip_odeparams(cfg)
    y0 = seip_initial_state(cfg)
    scales = jnp.asarray([0.9, 1.0, 1.1, 1.05], dtype=jnp.float32)

    outs = seip_solve_reference(y0, p, scales, duration=40, dt=0.25)
    # generic engine (Tsit5 constant dt) member-by-member
    for b, sc in enumerate(np.asarray(scales)):
        sol = simulate(
            seip_ode,
            40,
            tuple(jnp.asarray(c, jnp.result_type(float)) for c in y0),
            p.replace(beta=p.beta * float(sc)),
            cfg.parameters.solver_params,
        )
        for ref_arr, comp in zip(outs, sol.ys):
            a = np.asarray(ref_arr[..., b])
            bb = np.asarray(comp)
            # RK4 vs Tsit5 at the same dt: both inside the dt^4 envelope
            np.testing.assert_allclose(a, bb, rtol=5e-4, atol=0.05)


def test_reference_conserves_mass():
    cfg = seip_config(
        seasonal_vaccination=True,
        solver_params=SolverParams(constant_step_size=0.5),
    )
    p = seip_odeparams(cfg)
    y0 = seip_initial_state(cfg)
    scales = jnp.ones((2,), jnp.float32)
    S, E, I, C = seip_solve_reference(y0, p, scales, duration=100, dt=0.5)
    living = (
        np.asarray(S).sum(axis=(1, 2, 3, 4))
        + np.asarray(E).sum(axis=(1, 2, 3, 4))
        + np.asarray(I).sum(axis=(1, 2, 3, 4))
    )
    np.testing.assert_allclose(
        living, np.broadcast_to(living[0], living.shape), rtol=1e-5
    )
