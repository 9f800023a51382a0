"""Fit the production SEIP model with a wide ChEES-HMC chain bank.

The full production loop on the heavyweight tensor model (age x immune
history x vaccination x waning x strain): synthesize Poisson-noised
incidence from known per-strain transmission scales, fit them with
``MCMCProcess(sampler="chees")`` -- every leapfrog differentiates through
the constant-step SEIP solve -- and plot the posterior fit against the
data. ChEES (docs/inference.md) is the wide-bank sampler: all chains take
the same number of leapfrog steps per iteration with cross-chain
adaptation, the right shape for hundreds-to-thousands of vectorized
chains on one device.

Reference counterpart: examples/sir_infer_parameters.py's
simulate -> noise -> fit loop (/root/reference/examples/
sir_infer_parameters.py:92-116), scaled up to the model family the
reference only documents (ode_model.md).
"""

import _bootstrap  # noqa: F401  (repo-root sys.path shim)

import matplotlib

matplotlib.use("Agg")
import jax
import jax.numpy as jnp
import matplotlib.pyplot as plt
import numpy as np

import dynode_tpu.dist as dist
from dynode_tpu import MCMCProcess, simulate
from dynode_tpu.config import SolverParams
from dynode_tpu.infer import handlers
from dynode_tpu.models.seip import (
    seip_config,
    seip_initial_state,
    seip_ode,
    seip_odeparams,
)

FAST = _bootstrap.fast_mode()
# the second strain's transmission scale is only identified if the fit
# window covers its introduction + growth phase, so the smoke-test (FAST)
# configuration shrinks the introduction day along with the window
FIT_DAYS = 30 if FAST else 100
INTRO_DAY = 10.0 if FAST else 60.0
NUM_CHAINS = 4 if FAST else 256
NUM_WARMUP = 16 if FAST else 100
NUM_SAMPLES = 16 if FAST else 100

from dynode_tpu.config import Strain  # noqa: E402

_MAX_VAX = 2
_strains = [
    Strain(
        strain_name="alpha",
        r0=2.2,
        infectious_period=7.0,
        exposed_to_infectious=3.6,
        vaccine_efficacy={
            k: min(0.35 * k, 0.8) for k in range(_MAX_VAX + 2)
        },
    ),
    Strain(
        strain_name="delta",
        r0=3.0,
        infectious_period=7.0,
        exposed_to_infectious=3.6,
        vaccine_efficacy={
            k: min(0.30 * k, 0.7) for k in range(_MAX_VAX + 2)
        },
        is_introduced=True,
        introduction_time=INTRO_DAY,
        introduction_percentage=0.02,
        introduction_scale=5.0,
    ),
]

config = seip_config(
    strains=_strains,
    seasonal_vaccination=True,
    solver_params=SolverParams(constant_step_size=0.5),
)
base = seip_odeparams(config)
y0 = seip_initial_state(config)
sp = config.parameters.solver_params
n_strains = base.beta.shape[0]
TRUE_SCALES = jnp.linspace(1.1, 0.9, n_strains)


def incidence_curve(scales, days):
    """Daily all-ages incidence from per-strain transmission scaling."""
    p = base.replace(beta=base.beta * scales)
    sol = simulate(seip_ode, days, y0, p, sp, sub_save_indices=(3,))
    cum = jnp.sum(sol.ys[3], axis=(1, 2, 3))  # (days+1, A)
    return jnp.maximum(jnp.diff(cum, axis=0), 1e-6)


def model(obs_data=None):
    scales = handlers.sample(
        "beta_scales",
        dist.TruncatedNormal(
            loc=jnp.ones(n_strains),
            scale=0.2 * jnp.ones(n_strains),
            low=0.5,
            high=1.8,
        ),
    )
    handlers.sample(
        "obs", dist.Poisson(incidence_curve(scales, FIT_DAYS)), obs=obs_data
    )


if __name__ == "__main__":
    obs = jax.random.poisson(
        jax.random.PRNGKey(0), incidence_curve(TRUE_SCALES, FIT_DAYS)
    ).astype(jnp.result_type(float))

    proc = MCMCProcess(
        numpyro_model=model,
        num_warmup=NUM_WARMUP,
        num_samples=NUM_SAMPLES,
        num_chains=NUM_CHAINS,
        nuts_max_tree_depth=6,  # unused by chees; required field
        sampler="chees",
        nuts_kwargs={"max_num_steps": 16 if FAST else 64},
        mcmc_kwargs={"steps_per_call": NUM_WARMUP},
        progress_bar=not FAST,
    )
    proc.infer(obs_data=obs)
    samples = proc.get_samples()["beta_scales"]
    post_mean = np.asarray(samples).mean(axis=0)
    post_std = np.asarray(samples).std(axis=0)
    print("true scales:     ", np.round(np.asarray(TRUE_SCALES), 3))
    print("posterior mean:  ", np.round(post_mean, 3))
    print("posterior std:   ", np.round(post_std, 4))

    # posterior-fit plot: data dots + posterior-mean curve per age group
    fit = np.asarray(incidence_curve(jnp.asarray(post_mean), FIT_DAYS))
    t = np.arange(1, FIT_DAYS + 1)
    fig, ax = plt.subplots(figsize=(8, 4))
    for a in range(fit.shape[1]):
        ax.plot(t, np.asarray(obs)[:, a], ".", ms=3, alpha=0.5)
        ax.plot(t, fit[:, a], lw=1.5, label=f"age {a} (posterior mean)")
    ax.set_xlabel("day")
    ax.set_ylabel("daily incidence")
    ax.set_title(
        f"SEIP fit: {NUM_CHAINS} ChEES chains x "
        f"({NUM_WARMUP}+{NUM_SAMPLES}) draws"
    )
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig("seip_fit.png", dpi=120)
    print("saved seip_fit.png")
