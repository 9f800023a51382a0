"""Bank-scale SVI: a vmapped multi-start bank, mesh-shardable over devices.

The reference runs SVI as ONE Adam trajectory from one init
(/root/reference/src/dynode/infer/inference.py:244-302) -- the standard
failure mode is an ELBO local optimum it silently falls into. On an
accelerator the fix is nearly free: run hundreds of independently-initialized optimizations
as a single vmapped program (starts fill the chip the way chain width does
for MCMC), rank the finished guides by a multi-particle ELBO, and keep the
winner. ``SVIProcess(num_starts=..., svi_mesh=...)`` wires the same thing
through the reference-parity process API.

This demo fits the flagship SIR posterior (the workload of
examples/sir_infer_parameters.py) with a 64-start bank and prints the
spread of final ELBOs across starts -- a free multi-modality diagnostic a
single-init fit never sees.
"""

import _bootstrap  # noqa: F401  (repo-root sys.path shim)

import jax
import jax.numpy as jnp
import numpy as np

import dynode_tpu.dist as dist
from dynode_tpu import SVIProcess
from dynode_tpu.parallel import create_mesh
from sir_age_stratified import get_config as get_static_config
from sir_age_stratified import run_simulation
from sir_infer_parameters import get_config, model

if __name__ == "__main__":
    FAST = _bootstrap.fast_mode()
    tf_fit = 50 if FAST else 100
    num_starts = 4 if FAST else 64
    num_iters = 80 if FAST else 500

    # synthetic data from the fixed-parameter model
    config_static = get_static_config()
    solution = run_simulation(config_static, tf=tf_fit)
    incidence = jnp.diff(solution.ys[config_static.idx.r], axis=0)

    # shard the start axis over every available device (8 virtual CPU
    # devices in the test harness; the cards of a multi-GPU host)
    mesh = None
    if len(jax.devices()) > 1 and num_starts % len(jax.devices()) == 0:
        mesh = create_mesh(("start",))

    proc = SVIProcess(
        numpyro_model=model,
        num_iterations=num_iters,
        num_samples=200,
        num_starts=num_starts,
        init_jitter=1.0,
        svi_mesh=mesh,
        progress_bar=True,
    )
    proc.infer(config=get_config(), tf=tf_fit, obs_data=incidence)

    res = proc._inference_state
    elbos = np.asarray(res.final_elbos)
    print(
        f"{num_starts} starts: best ELBO {elbos.max():.2f} "
        f"(start {int(res.best_idx)}), worst {elbos.min():.2f}, "
        f"spread {elbos.max() - elbos.min():.2f} nats"
    )
    samples = proc.get_samples()
    r0 = np.asarray(samples["strains_0_r0"])
    ip = np.asarray(samples["strains_0_infectious_period"])
    print(f"posterior r0: {r0.mean():.4f} +- {r0.std():.4f} (true 2.0)")
    print(f"posterior infectious_period: {ip.mean():.4f} +- {ip.std():.4f} (true 7.0)")

    # ------------------------------------------------------------------
    # hand the fitted guide to the exact sampler: SVI-initialized ChEES
    # (Pathfinder-style). The guide's draws are the chain positions and
    # its covariance is the mass matrix, so the bank samples with ZERO
    # warmup transitions -- the one-shot production recipe when a fit
    # must also be exact (docs/inference.md "SVI-initialized MCMC").
    # ------------------------------------------------------------------
    from dynode_tpu.infer import MCMC, ChEES, chees_warm_start_from_guide

    n_chains = 32 if FAST else 256
    n_draws = 8 if FAST else 24
    warm = chees_warm_start_from_guide(
        proc._inferer.guide,
        res.params,
        num_chains=n_chains,
        rng_key=jax.random.PRNGKey(7),
    )
    mcmc = MCMC(
        ChEES(model),
        num_warmup=0,
        num_samples=n_draws,
        num_chains=n_chains,
        progress_bar=False,
    )
    mcmc.run(
        jax.random.PRNGKey(8),
        config=get_config(),
        tf=tf_fit,
        obs_data=incidence,
        warm_start=warm,
    )
    post = mcmc.get_samples(group_by_chain=True)
    burn = 2 if FAST else 4  # guide-distributed starts: short burn-in
    r0_mc = np.asarray(post["strains_0_r0"], dtype=np.float64)[:, burn:]
    print(
        f"SVI-init ChEES (0 warmup): r0 {r0_mc.mean():.4f} +- "
        f"{r0_mc.std():.4f} (true 2.0)"
    )
