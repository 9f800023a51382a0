"""Forecast utilities: posterior resampling + on-device ensemble quantiles.

Ensemble-scale analog of the reference's project-forward-with-Predictive step
(/root/reference/examples/sir_infer_parameters.py:157-183).
"""

import jax
import jax.numpy as jnp
import numpy as np

from dynode_tpu.infer import member_quantiles, resample_draws


def test_resample_draws_bootstrap_and_thin():
    draws = jnp.arange(10.0)[:, None] * jnp.ones((10, 3))
    key = jax.random.PRNGKey(0)
    wide = resample_draws(draws, 64, key)
    assert wide.shape == (64, 3)
    # every member is an exact posterior draw
    assert set(np.asarray(wide[:, 0]).tolist()) <= set(range(10))
    thin = resample_draws(draws, 7, key)
    assert thin.shape == (7, 3)
    # without replacement below N: all members distinct
    assert len(set(np.asarray(thin[:, 0]).tolist())) == 7


def test_member_quantiles_matches_numpy_and_packed_layout():
    key = jax.random.PRNGKey(1)
    member_last = jax.random.normal(key, (5, 2, 2048))  # (T, A, B)
    qs = (0.05, 0.5, 0.95)
    got = member_quantiles(member_last, qs)  # default: member-last
    want = np.quantile(np.asarray(member_last), qs, axis=-1)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-6)

    # members split over two axes (any order): quantiles are
    # member-permutation-invariant, so both axes flatten into one
    split = jnp.moveaxis(member_last.reshape(5, 2, 256, 8), -1, 1)
    got_split = member_quantiles(split, qs, member_axes=(1, -1))
    np.testing.assert_allclose(np.asarray(got_split), want, atol=1e-6)


def test_member_quantiles_bf16_saves_compute_in_f32():
    x = jnp.linspace(0.0, 1.0, 512, dtype=jnp.bfloat16)[None, :]
    q = member_quantiles(x, (0.5,), member_axes=-1)
    assert q.dtype == jnp.float32
    assert abs(float(q[0, 0]) - 0.5) < 0.01
