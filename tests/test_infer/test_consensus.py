"""MCMC.run(consensus_check=k): the productized cross-sub-bank sanity check.

Chains are independent, so disjoint sub-banks of a healthy run estimate the
same posterior to within Monte-Carlo error; a systematic divergence flags a
corrupted run. These tests pin: healthy runs pass silently, injected bias warns
loudly, and the guard rails on ``k`` raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dynode_tpu.dist as dist
from dynode_tpu.infer import MCMC, NUTS, handlers

DATA = jnp.asarray(np.random.default_rng(3).normal(0.7, 1.0, 64))


def _model(obs=None):
    mu = handlers.sample("mu", dist.Normal(0.0, 10.0))
    handlers.sample("obs", dist.Normal(mu, 1.0), obs=obs)


@pytest.fixture(scope="module")
def fitted():
    m = MCMC(
        NUTS(_model),
        num_warmup=50,
        num_samples=50,
        num_chains=8,
        progress_bar=False,
    )
    import warnings

    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        m.run(jax.random.PRNGKey(0), obs=DATA, consensus_check=2)
    assert not [w for w in record if "consensus" in str(w.message)]
    return m


def test_healthy_run_passes(fitted):
    assert fitted.consensus_report is not None
    assert set(fitted.consensus_report) == {"mu"}
    assert 0.0 <= fitted.consensus_report["mu"] < 4.0


def test_injected_bias_warns(fitted):
    # shift half the bank's draws by far more than Monte-Carlo error --
    # the corruption signature the check exists to catch
    biased = dict(fitted._samples)
    mu = np.asarray(biased["mu"]).copy()
    mu[: mu.shape[0] // 2] += 10.0
    orig = fitted._samples
    fitted._samples = {"mu": jnp.asarray(mu)}
    try:
        with pytest.warns(UserWarning, match="consensus check FAILED"):
            report = fitted._consensus_check(2)
    finally:
        fitted._samples = orig
    assert report["mu"] > 4.0


def test_vector_site_elementwise():
    m = MCMC(
        NUTS(lambda: handlers.sample("v", dist.Normal(jnp.zeros(3), 1.0))),
        num_warmup=40,
        num_samples=40,
        num_chains=8,
        progress_bar=False,
    )
    m.run(jax.random.PRNGKey(1), consensus_check=4)
    assert m.consensus_report["v"] < 4.0


def test_guard_rails(fitted):
    with pytest.raises(ValueError, match="k >= 2"):
        fitted._consensus_check(1)
    with pytest.raises(ValueError, match="at least"):
        fitted._consensus_check(5)  # 8 chains cannot give 5 sub-banks of 2


def test_no_report_without_flag():
    m = MCMC(
        NUTS(_model),
        num_warmup=10,
        num_samples=10,
        num_chains=2,
        progress_bar=False,
    )
    m.run(jax.random.PRNGKey(2), obs=DATA)
    assert m.consensus_report is None
