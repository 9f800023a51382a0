"""Fit benchmark: ESS/s of the 3-scale multistrain SEIRS fit on one GPU.

Fits the strain R0 multipliers of the 2-age x 3-strain SEIRS model to
synthetic Poisson incidence with a wide bank of vectorized chains compiled
into one program, and reports min-across-parameters effective samples per
second for NUTS and ChEES, plus the multi-start SVI rate. Each fit runs
twice: the second (warm) run reuses the compiled programs and is the one
timed.

Run ``python bench_nuts.py`` on a machine with an NVIDIA GPU; it fails
without one. Prints the card and its power limit, then one JSON line.
"""

import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import dynode_tpu.dist as dist
from dynode_tpu import simulate
from dynode_tpu.config import SolverParams
from dynode_tpu.infer import MCMC, NUTS, ChEES, handlers
from dynode_tpu.infer.diagnostics import effective_sample_size
from dynode_tpu.models.multistrain import (
    multistrain_config,
    multistrain_initial_state,
    multistrain_ode,
    multistrain_odeparams,
)

DURATION = 100
NUM_WARMUP = 200
NUM_SAMPLES = 200
NUM_CHAINS = 4096
# In a lockstep vectorized bank every transition costs the MAX leapfrogs
# across all chains, so the wide-bank optimum is SHORT trajectories x MANY
# chains; depth 3 keeps min ESS essentially unchanged on this posterior
# while depth 2 collapses it (too-short trajectories).
MAX_TREE_DEPTH = 3
CHEES_NUM_SAMPLES = 400


def build_model():
    """(model, forward) of the 3-scale fit; constant-step potential."""
    cfg = multistrain_config(
        solver_params=SolverParams(constant_step_size=0.5)
    )
    base = multistrain_odeparams(cfg)
    y0 = multistrain_initial_state(cfg)
    sp = cfg.parameters.solver_params

    def forward(r0_scales):
        p = base.replace(beta=base.beta * r0_scales)
        sol = simulate(multistrain_ode, DURATION, y0, p, sp)
        return sol.ys[-1]  # cumulative incidence timeseries (T, A, K)

    def model(obs=None):
        scales = handlers.sample(
            "r0_scales",
            dist.TruncatedNormal(
                loc=jnp.ones(3), scale=0.3 * jnp.ones(3), low=0.5, high=2.0
            ),
        )
        c = forward(scales)
        incidence = jnp.maximum(jnp.diff(c, axis=0), 1e-6)
        handlers.sample("obs_incidence", dist.Poisson(incidence), obs=obs)

    return model, forward


def make_workload():
    """(model, obs, true_scales): synthetic data from known scales."""
    model, forward = build_model()
    true_scales = jnp.array([1.1, 0.95, 1.05])
    c = forward(true_scales)
    key = jax.random.PRNGKey(0)
    obs = jax.random.poisson(key, jnp.maximum(jnp.diff(c, axis=0), 1e-6))
    return model, obs, true_scales


def fit_cold_warm(kernel, obs, num_samples, num_chains=NUM_CHAINS):
    """Cold then warm run; returns (warm wall, cold wall, mcmc)."""
    mcmc = MCMC(
        kernel,
        num_warmup=NUM_WARMUP,
        num_samples=num_samples,
        num_chains=num_chains,
        progress_bar=False,
    )
    t0 = time.perf_counter()
    mcmc.run(jax.random.PRNGKey(0), obs=obs)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    mcmc.run(jax.random.PRNGKey(1), obs=obs)
    return time.perf_counter() - t0, cold, mcmc


def ess_per_sec(name, mcmc, wall, cold, true_scales):
    arr = np.asarray(
        mcmc.get_samples(group_by_chain=True)["r0_scales"], dtype=np.float64
    )
    ess = min(effective_sample_size(arr[:, :, k]) for k in range(arr.shape[-1]))
    ef = mcmc.get_extra_fields()
    post_mean = arr.reshape(-1, 3).mean(axis=0)
    drift = float(np.max(np.abs(post_mean - np.asarray(true_scales))))
    print(
        f"[bench_nuts] {name}: {arr.shape[0]} chains x {arr.shape[1]} draws "
        f"warm {wall:.1f}s (cold {cold:.1f}s incl. compile); min ESS "
        f"{ess:.0f} -> {ess / wall:.0f} ESS/s; divergences "
        f"{int(np.asarray(ef['diverging']).sum())}; mean leapfrogs "
        f"{float(np.asarray(ef['num_steps']).mean()):.1f}; stuck "
        f"{int((arr.std(axis=1).max(axis=-1) < 1e-5).sum())}; posterior "
        f"means {np.round(post_mean, 3)} (true {np.asarray(true_scales)})",
        file=sys.stderr,
    )
    # a posterior that drifted from the generating values voids the row
    return ess / wall if drift <= 0.05 else 0.0


def bench_svi(model, obs, true_scales, num_starts=1024, num_steps=300):
    """Multi-start SVI bank: ELBO-steps/s (warm, median of 3 re-fits)."""
    from dynode_tpu.infer.predictive import Predictive
    from dynode_tpu.infer.svi import (
        SVI, Adam, AutoMultivariateNormal, Trace_ELBO,
    )

    guide = AutoMultivariateNormal(model)
    svi = SVI(model, guide, Adam(step_size=0.1), Trace_ELBO())

    def once(seed):
        t0 = time.perf_counter()
        res = svi.run_multistart(
            jax.random.PRNGKey(seed), num_steps=num_steps,
            num_starts=num_starts, obs=obs,
        )
        jax.block_until_ready(res.final_elbos)
        return time.perf_counter() - t0, res

    cold, res = once(70)
    walls = []
    for seed in (71, 72, 73):
        w, res = once(seed)
        walls.append(w)
    warm = float(np.median(walls))
    samples = Predictive(guide, params=res.params, num_samples=2000)(
        jax.random.PRNGKey(99), obs=obs
    )
    post = np.asarray(samples["r0_scales"], dtype=np.float64).reshape(-1, 3)
    err = float(np.max(np.abs(post.mean(axis=0) - np.asarray(true_scales))))
    rate = num_starts * num_steps / warm
    print(
        f"[bench_nuts] SVI multi-start: {num_starts} starts x {num_steps} "
        f"steps warm {warm:.1f}s (cold {cold:.1f}s) -> {rate:,.0f} "
        f"ELBO-steps/s; posterior max err {err:.3f} (gate 0.05)",
        file=sys.stderr,
    )
    return rate if err <= 0.05 else 0.0


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench_nuts: no GPU found (platform {dev.platform!r})")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip(), flush=True)

    import dynode_tpu

    dynode_tpu.enable_compilation_cache()
    model, obs, true_scales = make_workload()
    wall, cold, mcmc = fit_cold_warm(
        NUTS(model, dense_mass=True, max_tree_depth=MAX_TREE_DEPTH),
        obs, NUM_SAMPLES,
    )
    nuts = ess_per_sec("NUTS", mcmc, wall, cold, true_scales)
    wall, cold, mcmc = fit_cold_warm(ChEES(model), obs, CHEES_NUM_SAMPLES)
    chees = ess_per_sec("ChEES", mcmc, wall, cold, true_scales)
    svi = bench_svi(model, obs, true_scales)
    print(json.dumps({
        "metric": "multistrain_seirs_mcmc_ess_per_sec",
        "value": round(max(nuts, chees), 3),
        "unit": "ESS/s",
        "nuts_ess_per_sec": round(nuts, 3),
        "chees_ess_per_sec": round(chees, 3),
        "svi_elbo_steps_per_sec": round(svi, 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
