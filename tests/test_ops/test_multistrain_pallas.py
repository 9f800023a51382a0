"""The multistrain model on the whole-solve ensemble integrator.

The rows form of the model (``models.multistrain.MultistrainRowsRHS``) is
checked against the generic adaptive ODE engine through the ``lax``
reference, and the Triton kernel (interpret mode on CPU) against that
reference. ``chip_smoke.py`` runs the same comparison compiled on a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dynode_tpu.models.multistrain as mp
from dynode_tpu import simulate
from dynode_tpu.config import SolverParams
from dynode_tpu.models.multistrain import (
    multistrain_config,
    multistrain_initial_state,
    multistrain_ode,
    multistrain_odeparams,
)
from dynode_tpu.ops import ensemble_solve_kernel, ensemble_solve_kernel_reference


@pytest.fixture(scope="module")
def setup():
    cfg = multistrain_config(solver_params=SolverParams(step_budget=512))
    p = multistrain_odeparams(cfg)
    y0 = multistrain_initial_state(cfg)
    return cfg, p, y0


def _solve(y0, p, *, batch, duration, dt, beta=None, n_age=2, n_strain=3,
           **kw):
    """Pack, solve with the rows RHS, return the packed (T, R, B) saves."""
    beta = p.beta if beta is None else beta
    solve = ensemble_solve_kernel if kw else ensemble_solve_kernel_reference
    return solve(
        mp.MultistrainRowsRHS.from_params(p),
        mp.pack_state(y0, batch, n_age, n_strain),
        mp.pack_params(beta, p.sigma, p.gamma, p.omega, batch, n_strain),
        duration=duration, dt=dt, **kw,
    )


def test_pack_unpack_roundtrip(setup):
    _, _, y0 = setup
    packed = mp.pack_state(y0, 8)
    assert packed.shape == (mp.n_state_rows(), 8)
    s, e, i, r, c = mp.unpack_saves(packed[None])
    np.testing.assert_allclose(np.asarray(s[0, 3]), np.asarray(y0[0]), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(i[0, 5]), np.asarray(y0[2]), rtol=1e-6)


def test_lane_major_reference_matches_engine(setup):
    cfg, p, y0 = setup
    saves = _solve(y0, p, batch=4, duration=100.0, dt=0.25)
    s, e, i, r, c = mp.unpack_saves(saves)
    ref = simulate(multistrain_ode, 100, y0, p, cfg.parameters.solver_params)
    np.testing.assert_allclose(
        np.asarray(c[:, 0]),
        np.asarray(ref.ys[4]),
        rtol=5e-4,
        atol=1e-3,
    )


def test_per_member_parameters_differ(setup):
    _, p, y0 = setup
    B = 4
    scales = jnp.array([0.8, 1.0, 1.2, 1.4])
    beta = p.beta[None, :] * scales[:, None]
    saves = _solve(y0, p, beta=beta, batch=B, duration=100.0, dt=0.5)
    _, _, _, _, c = mp.unpack_saves(saves)
    finals = np.asarray(c[-1].sum(axis=(1, 2)))
    assert finals[0] < finals[1] < finals[2] < finals[3]


def test_pallas_kernel_interpret_matches_reference(setup):
    _, p, y0 = setup
    out = _solve(y0, p, batch=128, duration=3.0, dt=1.0, block_b=128,
                 interpret=True)
    ref = _solve(y0, p, batch=128, duration=3.0, dt=1.0)
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(ref), atol=2e-6, rtol=1e-5
    )


def test_generalized_dims_reference():
    """The lane-major solver generalizes beyond the 2x3 benchmark shape."""
    import jax

    from dynode_tpu.models.multistrain import (
        multistrain_config as cfg_fn,
        multistrain_initial_state as init_fn,
        multistrain_odeparams as params_fn,
    )

    cfg = cfg_fn(
        r0s=(2.0, 2.5), infectious_periods=(7.0, 6.0),
        latent_periods=(3.0, 2.5), waning_periods=(60.0, 80.0),
        strain_names=("A", "B"),
        age_names=("young", "mid", "old"),
        age_demographics=(0.4, 0.4, 0.2),
    )
    p = params_fn(cfg)
    y0 = init_fn(cfg)
    saves = _solve(y0, p, batch=4, duration=50.0, dt=0.5, n_age=3,
                   n_strain=2)
    s, e, i, r, c = mp.unpack_saves(saves, n_age=3, n_strain=2)
    assert s.shape == (51, 4, 3) and c.shape == (51, 4, 3, 2)
    ref = simulate(multistrain_ode, 50, y0, p, cfg.parameters.solver_params)
    np.testing.assert_allclose(
        np.asarray(c[:, 0]), np.asarray(ref.ys[4]), rtol=5e-4, atol=1e-3
    )


def test_lane_major_xla_ensemble_matches_scalar():
    """The batch-last XLA RHS (no Pallas) equals the scalar RHS."""
    from dynode_tpu.models.multistrain import (
        multistrain_ensemble_params,
        multistrain_ensemble_state,
        multistrain_ode_ensemble,
    )

    cfg = multistrain_config(solver_params=SolverParams(constant_step_size=0.5))
    p = multistrain_odeparams(cfg)
    y0 = multistrain_initial_state(cfg)
    pb = multistrain_ensemble_params(p, jnp.array([1.0, 0.8, 1.2]))
    y0b = multistrain_ensemble_state(y0, 3)
    solb = simulate(
        multistrain_ode_ensemble, 100, y0b, pb, cfg.parameters.solver_params
    )
    sol1 = simulate(multistrain_ode, 100, y0, p, cfg.parameters.solver_params)
    for a, b in zip(solb.ys, sol1.ys):
        np.testing.assert_allclose(
            np.asarray(a[..., 0]), np.asarray(b), rtol=1e-9, atol=1e-9
        )


def test_auto_block_b_interpret_matches_reference(setup):
    """block_b=None routes through launch_config and stays member-exact."""
    _, p, y0 = setup
    out = _solve(y0, p, batch=512, duration=10.0, dt=0.5, interpret=True)
    ref = _solve(y0, p, batch=512, duration=10.0, dt=0.5)
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(ref), rtol=2e-5, atol=1e-4
    )


def test_rows_rhs_is_hashable_by_value(setup):
    """Equal models share one compiled program (the RHS is a jit key)."""
    _, p, _ = setup
    a = mp.MultistrainRowsRHS.from_params(p)
    b = mp.MultistrainRowsRHS.from_params(p)
    assert a == b and hash(a) == hash(b)
    assert (a.n_age, a.n_strain) == (2, 3)
    assert a != mp.MultistrainRowsRHS(a.contact, 2, 2)
