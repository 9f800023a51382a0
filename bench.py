"""Benchmark: multistrain SEIRS and SEIP ensemble trajectories/s on one GPU.

Rows, each the median of 3 warm repeats with the compile excluded:

- the whole-solve Triton kernel on the multistrain SEIRS model (2 ages x 3
  strains, 26 state rows, 200 days, daily saves of the 6
  cumulative-incidence rows) at B=655,360, constant step (Tsit5, dt 0.5)
  and adaptive (BS3, rtol 1e-4), each gated against the ``lax`` reference;
- the plain-XLA paths on the same model: batch-leading
  ``jit(vmap(simulate))`` at constant step and adaptive, and the
  member-last adaptive save-grid engine;
- the production SEIP model (640 floats per member) through
  ``seip_ensemble_solve[_adaptive]`` at B=32,768;
- ChEES ESS/s on the 3-scale multistrain fit (``bench_nuts.py``).

Run ``python bench.py`` on a machine with an NVIDIA GPU; it fails without
one. Prints the card and its power limit, one line per row on stderr, and
a compact JSON line last.
"""

import json
import statistics
import subprocess
import sys
import time

import jax
import jax.numpy as jnp

from dynode_tpu import simulate
from dynode_tpu.config import SolverParams
from dynode_tpu.models import multistrain as ms
from dynode_tpu.ops import (
    ensemble_solve_kernel,
    ensemble_solve_kernel_adaptive,
    ensemble_solve_kernel_reference,
)

DURATION = 200.0
DT = 0.5
ROWS_WIDTH = 655_360  # the rows kernel, observable-row saves
XLA_WIDTH = 79_872  # the plain-XLA multistrain paths
SEIP_WIDTH = 32_768


def _note(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _median_rate(name, fn, n, repeats=3):
    """Trajectories/s: median of ``repeats`` warm calls (compiled first)."""
    jax.block_until_ready(fn(0))
    walls = []
    for rep in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(rep + 1))
        walls.append(time.perf_counter() - t0)
    med = statistics.median(walls)
    _note(f"{name}: {n / med:,.0f} traj/s (median {med * 1e3:.2f} ms, "
          f"spread {(max(walls) - min(walls)) / med:.3f})")
    return n / med


def _draws(n, seed):
    return jax.random.uniform(
        jax.random.PRNGKey(seed), (n,), minval=0.8, maxval=1.25
    )


def _multistrain():
    cfg = ms.multistrain_config(
        solver_params=SolverParams(
            step_budget=448,
            ode_solver_rel_tolerance=1e-5,
            ode_solver_abs_tolerance=1e-3,  # f32-scaled (see README)
        )
    )
    return cfg, ms.multistrain_odeparams(cfg), ms.multistrain_initial_state(cfg)


def bench_rows(base, y0, n=ROWS_WIDTH):
    """The whole-solve kernel, constant and adaptive, observable saves."""
    rhs = ms.MultistrainRowsRHS.from_params(base)
    rows = ms.n_state_rows()
    obs = tuple(range(rows - 6, rows))
    y_rows = ms.pack_state(y0, n)

    def p_rows(seed):
        beta = base.beta[None, :] * _draws(n, seed)[:, None]
        return ms.pack_params(beta, base.sigma, base.gamma, base.omega, n)

    # gate: the kernel against the lax reference on a 16,384-member slice
    m = 16_384
    got = ensemble_solve_kernel(
        rhs, y_rows[:, :m], p_rows(0)[:, :m], duration=DURATION, dt=DT,
        save_rows=obs,
    )
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda y, p: ensemble_solve_kernel_reference(
            rhs, y, p, duration=DURATION, dt=DT
        )[:, list(obs)])(y_rows[:, :m], p_rows(0)[:, :m])
    rel = float(jnp.max(jnp.abs(got - want)) / jnp.max(jnp.abs(want)))
    if rel > 1e-5:
        raise RuntimeError(f"rows kernel gate failed: rel {rel:.2e}")
    const = _median_rate(
        f"rows kernel, constant step, B={n}",
        lambda s: ensemble_solve_kernel(
            rhs, y_rows, p_rows(s), duration=DURATION, dt=DT, save_rows=obs
        ), n,
    )

    def adaptive(seed):
        saves, stats = ensemble_solve_kernel_adaptive(
            rhs, y_rows, p_rows(seed), duration=DURATION, rtol=1e-4,
            atol=1e-6, save_rows=obs,
        )
        return saves, stats["exhausted_intervals"]

    _, bad = adaptive(0)
    if int(jnp.sum(bad)):
        raise RuntimeError(f"adaptive kernel exhausted {int(jnp.sum(bad))}")
    adapt = _median_rate(f"rows kernel, adaptive, B={n}", adaptive, n)
    return {"rows_kernel_gate_rel_err": rel,
            "traj_per_sec_rows_kernel": round(const, 1),
            "traj_per_sec_rows_kernel_adaptive": round(adapt, 1)}


def bench_xla_multistrain(cfg, base, y0, n=XLA_WIDTH):
    """The plain-XLA multistrain paths (no kernel)."""
    sp_const = SolverParams(constant_step_size=DT)
    sp_adapt = cfg.parameters.solver_params

    def one(scale, sp):
        p = base.replace(beta=base.beta * scale)
        sol = simulate(ms.multistrain_ode, DURATION, y0, p, sp,
                       sub_save_indices=(4,))
        return sol.ys[4], sol.result

    lead = jax.jit(jax.vmap(lambda s: one(s, sp_const)))
    lead_adapt = jax.jit(jax.vmap(lambda s: one(s, sp_adapt)))
    y0b = ms.multistrain_ensemble_state(y0, n)
    sp_lane = sp_adapt.model_copy(update={"steps_per_save": 8})

    @jax.jit
    def lane(scales):
        pb = ms.multistrain_ensemble_params(base, scales)
        sol = simulate(ms.multistrain_ode_ensemble, DURATION, y0b, pb, sp_lane)
        return sol.ys[-1], sol.result

    out = {}
    for key, fn in (("batch_leading", lead),
                    ("xla_adaptive_vmap", lead_adapt),
                    ("lane_adaptive", lane)):
        if int(jnp.sum(fn(_draws(n, 0))[1] != 0)):
            raise RuntimeError(f"{key}: solver budget exhausted")
        out[f"traj_per_sec_{key}"] = round(_median_rate(
            f"{key}, B={n}", lambda s, fn=fn: fn(_draws(n, s))[0], n
        ), 1)
    return out


def bench_seip(n=SEIP_WIDTH):
    """Production SEIP through the XLA ensemble solvers, C-only saves."""
    from dynode_tpu.models.seip import (
        seip_config,
        seip_initial_state,
        seip_odeparams,
    )
    from dynode_tpu.ops import seip_ensemble_solve, seip_ensemble_solve_adaptive

    cfg = seip_config(
        seasonal_vaccination=True,
        solver_params=SolverParams(constant_step_size=DT),
    )
    base = seip_odeparams(cfg)
    y0 = seip_initial_state(cfg)

    def scales(seed):
        return jax.random.uniform(
            jax.random.PRNGKey(seed), (n,), minval=0.85, maxval=1.2
        )

    const = jax.jit(lambda s: seip_ensemble_solve(
        y0, base, s, duration=DURATION, dt=DT, save=(3,)
    )[0])
    adapt = jax.jit(lambda s: seip_ensemble_solve_adaptive(
        y0, base, s, duration=DURATION, rtol=1e-4, atol=1e-3, save=(3,)
    ))
    bad = int(jnp.sum(adapt(scales(0))[1]["exhausted_intervals"]))
    if bad:
        raise RuntimeError(f"SEIP adaptive exhausted {bad} intervals")
    return {
        "seip_traj_per_sec": round(_median_rate(
            f"SEIP constant step, B={n}", lambda s: const(scales(s)), n
        ), 1),
        "seip_traj_per_sec_adaptive": round(_median_rate(
            f"SEIP adaptive, B={n}", lambda s: adapt(scales(s))[0], n
        ), 1),
    }


def bench_chees():
    """ChEES ESS/s on the 3-scale fit (4096 chains, 200+400, warm)."""
    import bench_nuts
    from dynode_tpu.infer import ChEES

    model, obs, true_scales = bench_nuts.make_workload()
    wall, cold, mcmc = bench_nuts.fit_cold_warm(
        ChEES(model), obs, bench_nuts.CHEES_NUM_SAMPLES
    )
    return {"ess_per_sec": round(
        bench_nuts.ess_per_sec("ChEES", mcmc, wall, cold, true_scales), 1
    )}


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: no GPU found (platform {dev.platform!r})")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(card, flush=True)

    import dynode_tpu

    dynode_tpu.enable_compilation_cache()
    cfg, base, y0 = _multistrain()
    result = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                         "count": len(jax.devices())}, "card": card}
    result.update(bench_rows(base, y0))
    result.update(bench_xla_multistrain(cfg, base, y0))
    result.update(bench_seip())
    result.update(bench_chees())
    result["metric"] = "multistrain_seirs_trajectories_per_sec"
    result["value"] = result["traj_per_sec_rows_kernel"]
    result["unit"] = "traj/s"
    print(json.dumps({k: (round(v, 8) if isinstance(v, float) else v)
                      for k, v in result.items()}))


if __name__ == "__main__":
    main()
