"""The headline workload: 10k scenario trajectories + many-chain NUTS fit.

A scenario ensemble as a user-facing workflow: sample parameter draws from
priors, simulate all of them in one program (the whole-solve Triton kernel
on a GPU, its lax.scan reference on the CPU), then fit strain transmission
multipliers to synthetic observations with a wide bank of vectorized NUTS
chains (optionally sharded over a device mesh).
"""

import _bootstrap

import jax
import jax.numpy as jnp
import numpy as np

import dynode_tpu.dist as dist
from dynode_tpu import simulate
from dynode_tpu.config import SolverParams
from dynode_tpu.infer import MCMC, NUTS, handlers
from dynode_tpu.models.multistrain import (
    MultistrainRowsRHS,
    multistrain_config,
    multistrain_initial_state,
    multistrain_ode,
    multistrain_odeparams,
    pack_params,
    pack_state,
    unpack_saves,
)
from dynode_tpu.ops import ensemble_solve_kernel

FAST = _bootstrap.fast_mode()
ENSEMBLE = 256 if FAST else 4096
DURATION = 50 if FAST else 200
WARMUP = 30 if FAST else 150
SAMPLES = 30 if FAST else 150
CHAINS = 4 if FAST else 64

if __name__ == "__main__":
    config = multistrain_config(
        solver_params=SolverParams(constant_step_size=0.5)
    )
    base = multistrain_odeparams(config)
    y0 = multistrain_initial_state(config)

    # ---- 1) scenario ensemble: prior-sampled trajectories -----------------
    key = jax.random.PRNGKey(0)
    prior = dist.TruncatedNormal(loc=1.0, scale=0.15, low=0.6, high=1.6)
    r0_scales = prior.sample(key, (ENSEMBLE,))
    beta = base.beta[None, :] * r0_scales[:, None]
    saves = ensemble_solve_kernel(
        MultistrainRowsRHS.from_params(base),
        pack_state(y0, ENSEMBLE),
        pack_params(beta, base.sigma, base.gamma, base.omega, ENSEMBLE),
        duration=float(DURATION), dt=0.5,
    )
    s, e, i, r, c = unpack_saves(saves)
    peak_day = jnp.argmax(jnp.diff(c.sum(axis=(2, 3)), axis=0), axis=0)
    print(
        f"scenario ensemble: {ENSEMBLE} trajectories; "
        f"epidemic peak day 5%/50%/95% = "
        f"{np.percentile(np.asarray(peak_day), [5, 50, 95])}"
    )

    # ---- 2) many-chain NUTS fit against synthetic observations ------------
    sp = config.parameters.solver_params

    fit_days = 50 if FAST else 100

    def forward(scales):
        p = base.replace(beta=base.beta * scales)
        return simulate(multistrain_ode, fit_days, y0, p, sp).ys[-1]

    true_scales = jnp.array([1.1, 0.95, 1.05])
    obs = jax.random.poisson(
        jax.random.PRNGKey(1),
        jnp.maximum(jnp.diff(forward(true_scales), axis=0), 1e-6),
    )

    def model(obs_data=None):
        scales = handlers.sample(
            "r0_scales",
            dist.TruncatedNormal(
                loc=jnp.ones(3), scale=0.3 * jnp.ones(3), low=0.5, high=2.0
            ),
        )
        incidence = jnp.maximum(jnp.diff(forward(scales), axis=0), 1e-6)
        handlers.sample("obs", dist.Poisson(incidence), obs=obs_data)

    mcmc = MCMC(
        NUTS(model, dense_mass=True, max_tree_depth=6),
        num_warmup=WARMUP,
        num_samples=SAMPLES,
        num_chains=CHAINS,      # wide vectorized chain bank
        steps_per_call=16,      # bound each device program's runtime
        progress_bar=True,
    )
    mcmc.run(jax.random.PRNGKey(2), obs_data=obs)
    post = mcmc.get_samples()["r0_scales"]
    print("posterior mean r0 scales:", np.asarray(post.mean(axis=0)).round(3),
          "(true", np.asarray(true_scales), ")")
    mcmc.print_summary()
