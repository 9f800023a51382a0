"""Posterior-predictive forecast of the production SEIP model.

The full production loop, end to end: fit per-strain transmission scales
with a ChEES bank (reusing examples/seip_fit.py's model), bootstrap the
posterior draws to an ensemble width, run EVERY member through the
adaptive SEIP ensemble solve past the fitted window, and reduce to
forecast bands ON-DEVICE (the quantile summary is a few KB; member
trajectories never leave the device).

This is the ensemble-scale analog of the reference's project-forward step
-- numpyro ``Predictive`` replays after the fit
(CDCgov/DynODE/examples/sir_infer_parameters.py:157-183).
``dynode_tpu.infer.Predictive`` remains the general-model path.
"""

import _bootstrap  # noqa: F401  (repo-root sys.path shim)

import matplotlib

matplotlib.use("Agg")
import jax
import jax.numpy as jnp
import matplotlib.pyplot as plt
import numpy as np

from dynode_tpu.infer import member_quantiles, resample_draws
from dynode_tpu.ops import seip_ensemble_solve_adaptive

# the fit problem (model, config, synthetic data) is seip_fit's; import it
# so the two examples cannot drift apart
import seip_fit as fit

FAST = _bootstrap.fast_mode()
HORIZON = 15 if FAST else 60  # days past the fitted window
# forecast ensemble width: the production size on a GPU, small on the CPU
WIDTH = 16 if FAST else (32768 if jax.default_backend() == "gpu" else 1024)
QS = (0.05, 0.25, 0.5, 0.75, 0.95)


def main():
    key = jax.random.PRNGKey(0)
    obs = jax.random.poisson(
        key, fit.incidence_curve(fit.TRUE_SCALES, fit.FIT_DAYS)
    ).astype(jnp.result_type(float))

    proc = fit.MCMCProcess(
        numpyro_model=fit.model,
        num_warmup=fit.NUM_WARMUP,
        num_samples=fit.NUM_SAMPLES,
        num_chains=fit.NUM_CHAINS,
        nuts_max_tree_depth=6,
        sampler="chees",
        nuts_kwargs={"max_num_steps": 16 if FAST else 64},
        mcmc_kwargs={"steps_per_call": fit.NUM_WARMUP},
        progress_bar=False,
    )
    proc.infer(obs_data=obs)
    draws = jnp.asarray(proc.get_samples()["beta_scales"])  # (N, L)
    print(
        f"posterior: {draws.shape[0]} draws, mean "
        f"{np.round(np.asarray(draws.mean(axis=0)), 3)}"
    )

    # ---- bootstrap to the ensemble width; forecast every member ---------
    bank = resample_draws(draws, WIDTH, jax.random.PRNGKey(1)).T  # (L, W)
    total_days = fit.FIT_DAYS + HORIZON
    outs, stats = seip_ensemble_solve_adaptive(
        fit.y0,
        fit.base,
        bank.astype(jnp.float32),
        duration=float(total_days),
        rtol=1e-4,
        atol=1e-3,
        save=(3,),  # cumulative-infections compartment only
    )
    assert int(np.asarray(stats["exhausted_intervals"]).sum()) == 0

    # ---- on-device reduction: daily all-ages incidence -> quantiles -----
    c = outs[0]  # member-last (T, A, J, K, L, W)
    cum = jnp.sum(c, axis=(1, 2, 3, 4), dtype=jnp.float32)  # (T, W)
    inc = jnp.diff(cum, axis=0)
    bands = np.asarray(member_quantiles(inc, QS))
    print(f"forecast bands {bands.shape} from {WIDTH} members")

    # ---- plot: observed window + forecast bands --------------------------
    t_obs = np.arange(1, fit.FIT_DAYS + 1)
    t_all = np.arange(1, total_days + 1)
    obs_total = np.asarray(obs).sum(axis=1)
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(t_obs, obs_total, ".", ms=4, color="k", label="observed")
    ax.fill_between(
        t_all, bands[0], bands[-1], alpha=0.2, label="90% band"
    )
    ax.fill_between(t_all, bands[1], bands[-2], alpha=0.3, label="50% band")
    ax.plot(t_all, bands[2], lw=1.5, label="median")
    ax.axvline(fit.FIT_DAYS, ls="--", lw=1, color="gray")
    ax.set_xlabel("day")
    ax.set_ylabel("daily incidence (all ages)")
    ax.set_title(
        f"SEIP posterior-predictive forecast: {WIDTH} members, adaptive "
        f"ensemble solve"
    )
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig("seip_forecast.png", dpi=120)
    print("saved seip_forecast.png")

    # sanity: the median must track the data inside the fitted window
    med_fit = bands[2][: fit.FIT_DAYS]
    corr = np.corrcoef(med_fit, obs_total)[0, 1]
    print(f"median-vs-data correlation in fit window: {corr:.3f}")
    assert corr > 0.8, corr


if __name__ == "__main__":
    main()
