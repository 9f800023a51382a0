"""Equivalence harness for the generic lane-major ensemble transform.

``ensemble_rhs`` must mechanically reproduce what the hand-written
batch-last RHS variants (models/multistrain.py, models/seip.py) do by hand,
and ``simulate_ensemble(layout="lane_major")`` must agree member-for-member
with the batch-leading layout — the framework contract is that USER-authored
RHS functions (SURVEY.md §1: the framework never owns the ODE equations) get
the batch-last layout without hand-porting.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dynode_tpu import simulate
from dynode_tpu.config import SolverParams
from dynode_tpu.models.multistrain import (
    multistrain_config,
    multistrain_initial_state,
    multistrain_ode,
    multistrain_odeparams,
)
from dynode_tpu.simulation import (
    ensemble_rhs,
    ensemble_state,
    simulate_ensemble,
)

BATCH = 8


@pytest.fixture(scope="module")
def setup():
    cfg = multistrain_config(
        solver_params=SolverParams(constant_step_size=0.5)
    )
    base = multistrain_odeparams(cfg)
    y0 = multistrain_initial_state(cfg)
    scales = jnp.linspace(0.85, 1.2, BATCH)
    params_batch = jax.vmap(
        lambda s: base.replace(beta=base.beta * s)
    )(scales)
    return cfg, base, y0, params_batch


class TestLaneMajorEquivalence:
    def test_lane_major_matches_batch_leading_constant_step(self, setup):
        cfg, base, y0, params_batch = setup
        sol_lead = simulate_ensemble(
            multistrain_ode, 30, y0, params_batch,
            cfg.parameters.solver_params,
        )
        sol_lane = simulate_ensemble(
            multistrain_ode, 30, y0, params_batch,
            cfg.parameters.solver_params, layout="lane_major",
        )
        for y_lead, y_lane in zip(sol_lead.ys, sol_lane.ys):
            # leading layout: (B, T, ...); lane-major: (T, ..., B)
            np.testing.assert_allclose(
                np.moveaxis(np.asarray(y_lane), -1, 0),
                np.asarray(y_lead),
                rtol=1e-6,
                atol=1e-8,
            )

    def test_lane_major_adaptive_matches_per_member_solves(self, setup):
        _, base, y0, params_batch = setup
        sp = SolverParams(step_budget=512)
        sol_lane = simulate_ensemble(
            multistrain_ode, 30, y0, params_batch, sp, layout="lane_major"
        )
        assert int(sol_lane.result) == 0
        # adaptive lane-major shares one dt chain; each member must still be
        # a tolerance-accurate solution of its own ODE
        for member in (0, BATCH - 1):
            p = jax.tree_util.tree_map(lambda leaf: leaf[member], params_batch)
            sol_one = simulate(multistrain_ode, 30, y0, p, sp)
            for y_lane, y_one in zip(sol_lane.ys, sol_one.ys):
                np.testing.assert_allclose(
                    np.asarray(y_lane[..., member]),
                    np.asarray(y_one),
                    rtol=5e-4,
                    atol=1e-5,
                )

    def test_ensemble_rhs_matches_hand_written_variant(self, setup):
        from dynode_tpu.models.multistrain import (
            multistrain_ensemble_params,
            multistrain_ensemble_state,
            multistrain_ode_ensemble,
        )

        _, base, y0, params_batch = setup
        scales = jnp.linspace(0.85, 1.2, BATCH)
        y0b = multistrain_ensemble_state(y0, BATCH)
        p_hand = multistrain_ensemble_params(base, scales)
        g_hand = multistrain_ode_ensemble(0.0, y0b, p_hand)
        g_auto = ensemble_rhs(multistrain_ode)(0.0, y0b, params_batch)
        for a, b in zip(g_hand, g_auto):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-9
            )

    def test_ensemble_state_layout(self, setup):
        _, _, y0, _ = setup
        y0b = ensemble_state(y0, BATCH)
        for orig, b in zip(y0, y0b):
            assert b.shape == orig.shape + (BATCH,)
            np.testing.assert_array_equal(np.asarray(b[..., 3]), np.asarray(orig))

    def test_param_axes_none_shares_params(self, setup):
        _, base, y0, _ = setup
        y0b = ensemble_state(y0, BATCH)
        g_shared = ensemble_rhs(multistrain_ode, param_axes=None)(
            0.0, y0b, base
        )
        g_single = multistrain_ode(0.0, y0, base)
        for gb, g1 in zip(g_shared, g_single):
            np.testing.assert_allclose(
                np.asarray(gb[..., 0]), np.asarray(g1), rtol=1e-6, atol=1e-9
            )

    def test_unknown_layout_raises(self, setup):
        cfg, _, y0, params_batch = setup
        with pytest.raises(ValueError, match="unknown ensemble layout"):
            simulate_ensemble(
                multistrain_ode, 5, y0, params_batch,
                cfg.parameters.solver_params, layout="column_major",
            )

    def test_signature_check_survives_wrapper(self, setup):
        cfg, base, y0, _ = setup
        y0b = ensemble_state(y0, BATCH)
        wrapped = ensemble_rhs(multistrain_ode)

        class WrongParams:
            pass

        with pytest.raises(AssertionError, match="expects"):
            simulate(
                wrapped, 5, y0b, WrongParams(),
                cfg.parameters.solver_params,
            )
