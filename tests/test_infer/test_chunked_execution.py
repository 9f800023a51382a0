"""Host-chunked MCMC execution must be draw-for-draw identical to monolithic.

``steps_per_call`` bounds each device program's runtime;
chunks are padded to one fixed length with masked no-op transitions so each
phase compiles exactly ONE program — a remainder-sized chunk would recompile
the full NUTS program (a compile that can dominate a short run). Padding and
slicing must not change a single draw.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dynode_tpu.dist as dist
from dynode_tpu.infer import MCMC, NUTS, handlers

DATA = jnp.asarray(np.random.default_rng(0).normal(1.5, 1.0, 64))


def _model(obs=None):
    mu = handlers.sample("mu", dist.Normal(0.0, 10.0))
    sd = handlers.sample("sd", dist.LogNormal(0.0, 1.0))
    handlers.sample("obs", dist.Normal(mu, sd), obs=obs)


def _run(steps_per_call):
    m = MCMC(
        NUTS(_model, dense_mass=True),
        num_warmup=33,  # deliberately not a multiple of any chunk size
        num_samples=20,
        num_chains=3,
        progress_bar=False,
        steps_per_call=steps_per_call,
    )
    m.run(jax.random.PRNGKey(5), obs=DATA)
    return m


@pytest.fixture(scope="module")
def monolithic():
    return _run(None)


@pytest.mark.parametrize("spc", [7, 16, 64])
def test_chunked_matches_monolithic(monolithic, spc):
    a = monolithic.get_samples(group_by_chain=True)
    b = _run(spc).get_samples(group_by_chain=True)
    assert set(a) == set(b)
    for k in a:
        assert a[k].shape == b[k].shape
        np.testing.assert_allclose(
            np.asarray(a[k]), np.asarray(b[k]), rtol=1e-12
        )


def test_chunked_extra_fields_sliced_to_num_samples(monolithic):
    m = _run(7)  # 20 samples in chunks of 7 -> padded final chunk
    ef = m.get_extra_fields(group_by_chain=True)
    for k, v in ef.items():
        if k == "step_size":
            assert v.shape == (3,)
        else:
            assert v.shape[:2] == (3, 20), (k, v.shape)


class TestStuckChainRescue:
    """_rescue_stuck_chains re-seats collapsed-eps / non-finite chains."""

    def _mcmc(self, **kw):
        return MCMC(
            NUTS(_model),
            num_warmup=10,
            num_samples=10,
            num_chains=8,
            steps_per_call=10,
            **kw,
        )

    def _fake(self, D=2):
        from dynode_tpu.infer.hmc import HMCState

        C = 8
        key = jax.random.PRNGKey(0)
        state = HMCState(
            z=jnp.arange(C * D, dtype=float).reshape(C, D),
            potential=jnp.ones(C),
            grad=jnp.zeros((C, D)),
            energy=jnp.ones(C),
            accept_prob=jnp.zeros(C),
            num_steps=jnp.zeros(C, jnp.int32),
            diverging=jnp.zeros(C, bool),
            rng_key=jax.random.split(key, C),
        )
        inv_mass = jnp.broadcast_to(jnp.eye(D), (C, D, D))
        chol = inv_mass
        eps = jnp.full((C,), 0.5)
        return state, inv_mass, chol, eps

    def test_collapsed_eps_reseated(self):
        m = self._mcmc()
        state, inv_mass, chol, eps = self._fake()
        eps = eps.at[3].set(1e-9)  # chain 3 froze in warmup
        s2, im2, ch2, eps2 = m._rescue_stuck_chains(state, inv_mass, chol, eps)
        assert m._n_rescued == 1
        assert float(eps2[3]) == pytest.approx(0.5)
        # position copied from a healthy donor, but rng_key kept
        assert not bool(jnp.all(s2.z[3] == state.z[3]))
        np.testing.assert_array_equal(
            np.asarray(s2.rng_key[3]), np.asarray(state.rng_key[3])
        )

    def test_nonfinite_potential_reseated(self):
        m = self._mcmc()
        state, inv_mass, chol, eps = self._fake()
        state = state._replace(potential=state.potential.at[5].set(jnp.nan))
        s2, *_ = m._rescue_stuck_chains(state, inv_mass, chol, eps)
        assert m._n_rescued == 1
        assert bool(jnp.isfinite(s2.potential[5]))

    def test_healthy_bank_untouched(self):
        m = self._mcmc()
        state, inv_mass, chol, eps = self._fake()
        s2, im2, ch2, eps2 = m._rescue_stuck_chains(state, inv_mass, chol, eps)
        assert m._n_rescued == 0
        np.testing.assert_array_equal(np.asarray(s2.z), np.asarray(state.z))

    def test_disable_flag(self):
        m = self._mcmc(rescue_stuck_chains=False)
        state, inv_mass, chol, eps = self._fake()
        eps = eps.at[3].set(1e-9)
        _, _, _, eps2 = m._rescue_stuck_chains(state, inv_mass, chol, eps)
        assert float(eps2[3]) == pytest.approx(1e-9)
