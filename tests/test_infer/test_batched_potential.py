"""NUTS(batched_potential_fn=...): the chain-batched potential path.

The custom_vmap wrapper must (a) hand every vectorized-chain potential
evaluation to the user's batched function, (b) return per-chain values and
gradients identical to the generic model-derived potential, and (c) yield
the same posterior. This is the mechanism behind lane-major (chain-last)
NUTS: the batched function may transpose to batch-last layouts internally
for the ensemble-layout speedup.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dynode_tpu.dist as dist
from dynode_tpu.infer import MCMC, NUTS, handlers
from dynode_tpu.infer.mcmc import _as_custom_vmap_potential
from dynode_tpu.infer.util import (
    flatten_potential,
    get_model_trace,
    get_transforms,
    make_potential_fn,
)

DATA = jnp.asarray(np.random.default_rng(3).normal(1.5, 0.8, 64))


def _model(obs=None):
    mu = handlers.sample("mu", dist.Normal(0.0, 10.0))
    sd = handlers.sample("sd", dist.LogNormal(0.0, 1.0))
    handlers.sample("obs", dist.Normal(mu, sd), obs=obs)


def _batched_pot(zb):
    """Hand-written chain-batched potential, exact same semantics as the
    generic make_potential_fn path (flat order [mu, sd_unconstrained])."""
    mu, u = zb[:, 0], zb[:, 1]
    sd = jnp.exp(u)
    lp = dist.Normal(0.0, 10.0).log_prob(mu)
    lp += dist.LogNormal(0.0, 1.0).log_prob(sd) + u  # + log|d sd/du|
    lp += dist.Normal(mu[:, None], sd[:, None]).log_prob(DATA[None, :]).sum(
        axis=1
    )
    return -lp


class TestBatchedPotentialValues:
    def test_matches_generic_potential_and_grad(self):
        tr = get_model_trace(_model, jax.random.PRNGKey(0), obs=DATA)
        transforms = get_transforms(tr)
        flat_pot, _, _ = flatten_potential(
            make_potential_fn(_model, (), {"obs": DATA}, transforms),
            {"mu": jnp.asarray(1.0), "sd": jnp.asarray(0.2)},
        )
        zb = jnp.asarray([[1.0, 0.2], [0.5, -0.3], [2.0, 0.0]])
        ref_pe = jax.vmap(flat_pot)(zb)
        ref_g = jax.vmap(jax.grad(flat_pot))(zb)
        wrapped = _as_custom_vmap_potential(_batched_pot)
        pe, g = jax.vmap(wrapped)(zb)
        np.testing.assert_allclose(np.asarray(pe), np.asarray(ref_pe), rtol=1e-9)
        np.testing.assert_allclose(np.asarray(g), np.asarray(ref_g), rtol=1e-8)

    def test_unbatched_call_works(self):
        wrapped = _as_custom_vmap_potential(_batched_pot)
        pe, g = wrapped(jnp.asarray([1.0, 0.2]))
        assert pe.shape == () and g.shape == (2,)
        assert bool(jnp.isfinite(pe))


class TestBatchedPotentialMCMC:
    @pytest.mark.parametrize("spc", [None, 16])
    def test_posterior_matches_generic_path(self, spc):
        def run(batched):
            m = MCMC(
                NUTS(
                    _model,
                    dense_mass=True,
                    center_potential=False,
                    batched_potential_fn=_batched_pot if batched else None,
                ),
                num_warmup=150,
                num_samples=200,
                num_chains=4,
                progress_bar=False,
                steps_per_call=spc,
            )
            m.run(jax.random.PRNGKey(7), obs=DATA)
            return m.get_samples()

        a, b = run(False), run(True)
        assert set(a) == set(b)
        for k in a:
            assert float(jnp.mean(b[k])) == pytest.approx(
                float(jnp.mean(a[k])), abs=3e-2
            ), k
        # and both recover the data mean
        assert float(jnp.mean(b["mu"])) == pytest.approx(
            float(jnp.mean(DATA)), abs=0.1
        )
