"""ChEES-HMC kernel: adaptation machinery + posterior recovery.

The reference's sampler surface is numpyro NUTS
(/root/reference/src/dynode/infer/inference.py:149-162); ChEES is this
repo's wide-bank addition (infer/chees.py). These tests pin (a) the
Halton jitter sequence, (b) the bank Welford merge against a direct
covariance, (c) conjugate-posterior recovery through the shared MCMC
runner in every execution mode (monolithic, chunked, warm-start, mesh),
and (d) that trajectory-length adaptation actually engages (learned
T >> eps on a correlated target, where single-step proposals mix slowly).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dynode_tpu.dist as dist
from dynode_tpu.infer import MCMC, ChEES, handlers
from dynode_tpu.infer.chees import _halton, welford_update_bank
from dynode_tpu.infer.diagnostics import effective_sample_size
from dynode_tpu.infer.hmc import welford_covariance, welford_init

np.random.seed(0)
DATA = jnp.asarray(np.random.randn(128) + 0.7)
XBAR = float(np.mean(np.asarray(DATA)))


def toy_model(obs=None):
    mu = handlers.sample("mu", dist.Normal(0.0, 1.0))
    sigma = handlers.sample("sigma", dist.LogNormal(0.0, 0.5))
    handlers.sample("x", dist.Normal(mu, sigma), obs=obs)


def test_halton_is_base2_van_der_corput():
    got = [float(_halton(jnp.int32(i))) for i in range(8)]
    assert got == [0.5, 0.25, 0.75, 0.125, 0.625, 0.375, 0.875, 0.0625]


@pytest.mark.parametrize("dense", [False, True])
def test_welford_bank_merge_matches_direct_covariance(dense):
    rng = np.random.default_rng(3)
    batches = [rng.normal(size=(16, 4)) for _ in range(5)]
    w = welford_init(4, dense, jnp.float64)
    for b in batches:
        w = welford_update_bank(w, jnp.asarray(b))
    all_x = np.concatenate(batches, axis=0)
    # undo the shrinkage regularization to compare raw covariances
    n = all_x.shape[0]
    shrink = n / (n + 5.0)
    est = (np.asarray(welford_covariance(w)) - 1e-3 * (1 - shrink) * (
        np.eye(4) if dense else 1.0
    )) / shrink
    want = np.cov(all_x, rowvar=False) if dense else all_x.var(axis=0, ddof=1)
    np.testing.assert_allclose(est, want, rtol=1e-8, atol=1e-10)


@pytest.fixture(scope="module")
def chees_run():
    m = MCMC(
        ChEES(toy_model), num_warmup=300, num_samples=300, num_chains=16
    )
    m.run(jax.random.PRNGKey(0), obs=DATA)
    return m


def test_chees_posterior_close_to_conjugate(chees_run):
    mu = np.asarray(chees_run.get_samples()["mu"])
    expected = XBAR * 128 / 129  # conjugate posterior mean (sigma ~ 1)
    assert abs(mu.mean() - expected) < 0.03
    assert 0.06 < mu.std() < 0.13


def test_chees_shapes_and_extras(chees_run):
    flat = chees_run.get_samples()
    assert flat["mu"].shape == (16 * 300,)
    by_chain = chees_run.get_samples(group_by_chain=True)
    assert by_chain["mu"].shape == (16, 300)
    ex = chees_run.get_extra_fields(group_by_chain=True)
    for k in ("accept_prob", "num_steps", "diverging", "potential_energy"):
        assert ex[k].shape == (16, 300), k
    # lockstep invariant: every chain takes the SAME number of leapfrog
    # steps each iteration (the whole point of the kernel)
    ns = np.asarray(ex["num_steps"])
    assert (ns == ns[:1]).all()
    assert ex["step_size"].shape == (16,)


def test_chees_trajectory_adaptation_engages():
    """On a correlated Gaussian the learned trajectory must exceed one
    leapfrog step (single-step chains mix catastrophically slowly there)."""
    rho = 0.9
    cov = jnp.asarray([[1.0, rho], [rho, 1.0]])

    def corr_model():
        handlers.sample(
            "x",
            dist.MultivariateNormal(jnp.zeros(2), jnp.linalg.cholesky(cov)),
        )

    m = MCMC(ChEES(corr_model), num_warmup=400, num_samples=400,
             num_chains=32)
    m.run(jax.random.PRNGKey(1))
    inv_mass, chol, eps, traj = m._tuned
    assert float(traj) > 1.5 * float(eps)
    x = np.asarray(m.get_samples()["x"])
    got_cov = np.cov(x, rowvar=False)
    np.testing.assert_allclose(got_cov, [[1, rho], [rho, 1]], atol=0.25)
    # wide-bank ESS should be healthy, not one stuck chain's worth
    xc = np.asarray(m.get_samples(group_by_chain=True)["x"])
    ess = min(
        effective_sample_size(xc[..., 0]), effective_sample_size(xc[..., 1])
    )
    assert ess > 500


def test_chees_chunked_and_mesh(eight_device_mesh=None):
    from dynode_tpu.parallel import create_mesh

    mesh = create_mesh(("chain",))
    m = MCMC(
        ChEES(toy_model),
        num_warmup=128,
        num_samples=96,
        num_chains=16,
        steps_per_call=50,
        mesh=mesh,
        chain_axis="chain",
    )
    m.run(jax.random.PRNGKey(2), obs=DATA)
    mu = np.asarray(m.get_samples()["mu"])
    assert mu.shape == (16 * 96,)
    assert abs(mu.mean() - XBAR * 128 / 129) < 0.05


def test_chees_warm_start_continues():
    m1 = MCMC(ChEES(toy_model), num_warmup=200, num_samples=50,
              num_chains=8)
    m1.run(jax.random.PRNGKey(3), obs=DATA)
    ws = m1.warm_start_state()
    m2 = MCMC(ChEES(toy_model), num_warmup=0, num_samples=200, num_chains=8)
    m2.run(jax.random.PRNGKey(4), obs=DATA, warm_start=ws)
    mu = np.asarray(m2.get_samples()["mu"])
    assert mu.shape == (8 * 200,)
    assert abs(mu.mean() - XBAR * 128 / 129) < 0.04
    assert mu.std() > 0.05  # actually moving, not frozen


def test_chees_fixed_trajectory_and_step_size():
    m = MCMC(
        ChEES(
            toy_model,
            step_size=0.1,
            adapt_step_size=False,
            trajectory_length=0.8,
        ),
        num_warmup=100,
        num_samples=200,
        num_chains=8,
    )
    m.run(jax.random.PRNGKey(5), obs=DATA)
    ex = m.get_extra_fields(group_by_chain=True)
    ns = np.asarray(ex["num_steps"])
    # n_steps = ceil(u * 0.8 / 0.1) with u the Halton fraction: in [1, 8]
    assert ns.min() >= 1 and ns.max() <= 8
    mu = np.asarray(m.get_samples()["mu"])
    assert abs(mu.mean() - XBAR * 128 / 129) < 0.06
