"""Cross-run executable cache (infer/mcmc.py _EXEC_CACHE).

Without it, every MCMC.run builds fresh closures, so a warm 4096-chain
ChEES run re-traces and re-compiles its programs and spends most of its
wall time there rather than on the device. The cache reuses trace-derived
objects and jitted phase programs keyed on kernel config, run shape, and
the IDENTITY of the model and array arguments. These tests pin:

- repeat runs reuse the same jitted programs (no re-jit),
- a *different* obs array is a miss AND the posterior follows the new
  data (no stale compiled constants),
- an equal-valued copy is still a miss (identity keying, by design),
- a fresh MCMC instance with the same model/args/config hits the cache.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dynode_tpu.dist as dist
from dynode_tpu.infer import MCMC, NUTS, ChEES, handlers
from dynode_tpu.infer.mcmc import _EXEC_CACHE


def model(obs=None):
    mu = handlers.sample("mu", dist.Normal(0.0, 10.0))
    handlers.sample("obs", dist.Normal(mu, 1.0), obs=obs)


def _mcmc(kernel_cls, **kw):
    kern = (
        ChEES(model, max_num_steps=64)
        if kernel_cls is ChEES
        else NUTS(model, max_tree_depth=5)
    )
    return MCMC(
        kern,
        num_warmup=50,
        num_samples=50,
        num_chains=16,
        progress_bar=False,
        **kw,
    )


@pytest.fixture(autouse=True)
def _clear_cache():
    _EXEC_CACHE.clear()
    yield
    _EXEC_CACHE.clear()


@pytest.mark.parametrize("kernel_cls", [NUTS, ChEES])
@pytest.mark.parametrize("steps_per_call", [None, 25])
def test_second_run_reuses_compiled_programs(kernel_cls, steps_per_call):
    if kernel_cls is ChEES and steps_per_call is None:
        pass  # monolithic ChEES is also a real path; keep it
    obs = jnp.full((8,), 3.0)
    mcmc = _mcmc(kernel_cls, steps_per_call=steps_per_call)
    mcmc.run(jax.random.PRNGKey(0), obs=obs)
    assert len(_EXEC_CACHE) == 1
    entry = next(iter(_EXEC_CACHE.values()))
    jit_ids = {k: id(v) for k, v in entry["jits"].items()}
    pot_id = id(entry["pot_and_grad"])
    assert jit_ids  # at least one phase program was cached

    mcmc.run(jax.random.PRNGKey(1), obs=obs)
    assert len(_EXEC_CACHE) == 1
    entry2 = next(iter(_EXEC_CACHE.values()))
    assert id(entry2["pot_and_grad"]) == pot_id
    assert {k: id(v) for k, v in entry2["jits"].items()} == jit_ids
    post = float(np.asarray(mcmc.get_samples()["mu"]).mean())
    assert abs(post - 3.0) < 0.5


@pytest.mark.parametrize("kernel_cls", [NUTS, ChEES])
def test_new_obs_array_is_not_served_stale_programs(kernel_cls):
    # THE correctness hazard: obs is baked into the compiled potential as
    # a constant, so a cache hit on different data would silently sample
    # the old posterior. Different array object => miss => new programs.
    mcmc = _mcmc(kernel_cls, steps_per_call=25)
    mcmc.run(jax.random.PRNGKey(0), obs=jnp.full((8,), 3.0))
    m1 = float(np.asarray(mcmc.get_samples()["mu"]).mean())
    mcmc.run(jax.random.PRNGKey(0), obs=jnp.full((8,), -4.0))
    m2 = float(np.asarray(mcmc.get_samples()["mu"]).mean())
    assert len(_EXEC_CACHE) == 2
    assert abs(m1 - 3.0) < 0.5 and abs(m2 + 4.0) < 0.5


def test_equal_valued_copy_is_still_a_miss():
    # identity keying by design: value-hashing big device arrays per run
    # would cost more than it saves, and repeated fits pass the same object
    obs = jnp.full((8,), 3.0)
    mcmc = _mcmc(NUTS, steps_per_call=25)
    mcmc.run(jax.random.PRNGKey(0), obs=obs)
    mcmc.run(jax.random.PRNGKey(1), obs=jnp.array(obs))
    assert len(_EXEC_CACHE) == 2


def test_fresh_instance_same_model_and_args_hits_cache():
    obs = jnp.full((8,), 3.0)
    _mcmc(NUTS, steps_per_call=25).run(jax.random.PRNGKey(0), obs=obs)
    entry = next(iter(_EXEC_CACHE.values()))
    jit_ids = {k: id(v) for k, v in entry["jits"].items()}
    m2 = _mcmc(NUTS, steps_per_call=25)
    m2.run(jax.random.PRNGKey(1), obs=obs)
    assert len(_EXEC_CACHE) == 1
    entry2 = next(iter(_EXEC_CACHE.values()))
    assert {k: id(v) for k, v in entry2["jits"].items()} == jit_ids
    assert abs(float(np.asarray(m2.get_samples()["mu"]).mean()) - 3.0) < 0.5


def test_config_change_is_a_miss():
    obs = jnp.full((8,), 3.0)
    _mcmc(NUTS, steps_per_call=25).run(jax.random.PRNGKey(0), obs=obs)
    _mcmc(NUTS, steps_per_call=None).run(jax.random.PRNGKey(0), obs=obs)
    assert len(_EXEC_CACHE) == 2


def test_mesh_sharded_run_caches_and_is_distinct_from_unsharded():
    # mesh identity is part of the key: a sharded bank must not be served
    # an unsharded program (or vice versa), and repeat sharded runs reuse
    # the same jits (jax re-specializes per input sharding internally)
    from dynode_tpu.parallel import create_mesh

    obs = jnp.full((8,), 3.0)
    mesh = create_mesh(("chains",))
    m_unsharded = _mcmc(NUTS, steps_per_call=25)
    m_unsharded.run(jax.random.PRNGKey(0), obs=obs)
    m_sharded = _mcmc(NUTS, steps_per_call=25, mesh=mesh, chain_axis="chains")
    m_sharded.run(jax.random.PRNGKey(0), obs=obs)
    assert len(_EXEC_CACHE) == 2
    jit_ids = {
        k: id(v)
        for k, v in list(_EXEC_CACHE.values())[-1]["jits"].items()
    }
    m_sharded.run(jax.random.PRNGKey(1), obs=obs)
    assert len(_EXEC_CACHE) == 2
    entry2 = list(_EXEC_CACHE.values())[-1]
    assert {k: id(v) for k, v in entry2["jits"].items()} == jit_ids
    # identical seed => identical draws, sharded or not (chains are
    # independent and individually keyed)
    a = np.asarray(m_unsharded.get_samples(group_by_chain=True)["mu"])
    m_sharded.run(jax.random.PRNGKey(0), obs=obs)
    b = np.asarray(m_sharded.get_samples(group_by_chain=True)["mu"])
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
