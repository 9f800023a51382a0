"""Per-strain per-member transmission scales through the SEIP solvers.

The production fit samples one transmission scale PER STRAIN
(examples/seip_fit.py::model), so posterior-predictive forecasting needs
the solvers to accept (L, B) scale banks: ``beta_scales`` is (B,) or
(L, B) everywhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dynode_tpu import simulate
from dynode_tpu.config import SolverParams
from dynode_tpu.models.seip import (
    seip_config,
    seip_ensemble_params,
    seip_initial_state,
    seip_ode,
    seip_odeparams,
)
from dynode_tpu.ops.seip import (
    seip_ensemble_solve,
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
    return cfg, p, y0


def test_ensemble_params_accepts_both_shapes(setup):
    _, p, _ = setup
    L = p.beta.shape[0]
    shared = jnp.asarray([0.9, 1.1])
    per_strain = jnp.broadcast_to(shared[None, :], (L, 2))
    pa = seip_ensemble_params(p, shared)
    pb = seip_ensemble_params(p, per_strain)
    assert pa.beta.shape == (L, 2)
    np.testing.assert_array_equal(np.asarray(pa.beta), np.asarray(pb.beta))


def test_shared_row_equals_broadcast_bank(setup):
    # (B,) input must solve identically to the explicit (L, B) broadcast
    _, p, y0 = setup
    L = p.beta.shape[0]
    shared = jnp.asarray([0.9, 1.0, 1.1])
    bank = jnp.broadcast_to(shared[None, :], (L, 3))
    a = seip_ensemble_solve(y0, p, shared, duration=8)
    b = seip_ensemble_solve(y0, p, bank, duration=8)
    for ca, cb in zip(a, b):
        np.testing.assert_array_equal(np.asarray(ca), np.asarray(cb))


def test_per_strain_member_matches_scaled_beta_solve(setup):
    # member b of an (L, B) bank == an independent solve with
    # beta * scales[:, b], integrated by the generic engine (different
    # integrator => tolerance-level agreement, same as the shared-scale
    # pin in test_seip_pallas.py)
    cfg, p, y0 = setup
    L = p.beta.shape[0]
    key = jax.random.PRNGKey(0)
    bank = 1.0 + 0.15 * jax.random.normal(key, (L, 4))
    outs = seip_ensemble_solve(y0, p, bank, duration=12)
    member = 2
    p_m = p.replace(beta=p.beta * bank[:, member])
    sol = simulate(
        seip_ode, 12, y0, p_m, cfg.parameters.solver_params
    )
    for c_ens, c_ref in zip(outs, sol.ys):
        a = np.asarray(c_ens[..., member])
        b = np.asarray(c_ref)
        scale = np.abs(b).max()
        np.testing.assert_allclose(a, b, atol=2e-3 * scale, rtol=0)


def test_per_strain_scales_change_their_strain(setup):
    # scaling strain l's transmission must move strain-l infections and
    # leave a bank sharing the other strains' scales close elsewhere
    _, p, y0 = setup
    L = p.beta.shape[0]
    base = jnp.ones((L, 2))
    bumped = base.at[0, 1].set(1.5)
    outs = seip_ensemble_solve(y0, p, bumped, duration=15, save=(2,))
    i_comp = np.asarray(outs[0])  # (T, A, J, K, L, B)
    # strain 0 infections at final day: member 1 (bumped) >> member 0
    i0 = i_comp[-1, ..., 0, :].sum(axis=tuple(range(i_comp.ndim - 3)))
    assert i0[1] > 1.5 * i0[0], (i0[0], i0[1])


def test_adaptive_reference_per_strain_broadcast_equivalence(setup):
    _, p, y0 = setup
    L = p.beta.shape[0]
    shared = jnp.asarray([0.95, 1.05])
    bank = jnp.broadcast_to(shared[None, :], (L, 2))
    a, stats_a = seip_ensemble_solve_adaptive(
        y0, p, shared, duration=6, rtol=1e-4, atol=1e-3
    )
    b, stats_b = seip_ensemble_solve_adaptive(
        y0, p, bank, duration=6, rtol=1e-4, atol=1e-3
    )
    assert int(np.asarray(stats_a["exhausted_intervals"]).sum()) == 0
    for ca, cb in zip(a, b):
        np.testing.assert_array_equal(np.asarray(ca), np.asarray(cb))


def test_solve_reference_rejects_wrong_leading_dim(setup):
    _, p, y0 = setup
    L = p.beta.shape[0]
    bad = jnp.ones((L + 1, 2))
    with pytest.raises((ValueError, TypeError)):
        # beta (L,) * scale (L+1,) cannot broadcast
        jax.block_until_ready(
            seip_solve_reference(y0, p, bad, duration=2)
        )
