"""Smoke test of the main path on one NVIDIA GPU.

Run from the root of a checkout:

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the sharded path only

Phases (one card), each compared with the repo's plain reference:

1. device: JAX must report a GPU; the card's name and power limit are read
   by ``nvidia-smi`` (a child process that does not touch JAX);
2. rows engine: the multistrain SEIRS model (2 ages x 3 strains, 26 state
   rows, 200 days) at B=655,360 through ``ops.ensemble_solve_kernel``
   (Tsit5, constant step) and ``ops.ensemble_solve_kernel_adaptive``
   (BS3, rtol 1e-4) on the Triton route, against the ``lax`` reference,
   with the kernel-vs-XLA times;
3. SEIP: the production SEIP model (4 ages x 2 strains, 640 floats per
   member) through ``seip_ensemble_solve[_adaptive]`` at B=32,768, 200
   days, C-only saves: 16 members against ``simulate(seip_ode)`` at tight
   tolerance, mass conservation, traj/s and the compiled memory analysis;
4. fit: ``MCMCProcess(sampler="chees")`` (4096 chains, 200+200),
   ``MCMCProcess(sampler="nuts")`` (1024 chains, 50+50, depth 3) and
   ``SVIProcess`` (1024 starts x 200 steps) on the 3-scale multistrain fit.

``--four`` runs the sharded rows engine over a 4-card mesh against the
one-card result, and ChEES with its bank sharded over 4 cards against the
one-card posterior. Any failed check raises: the script then exits
non-zero and prints no result line. The last line of a passing run is
``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def _card():
    """``name, power.limit`` of the card, from nvidia-smi (no JAX)."""
    if shutil.which("nvidia-smi") is None:
        return "nvidia-smi not found"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip() or out.stderr.strip()


def _require(ok, msg):
    if not ok:
        raise RuntimeError(f"CHECK FAILED: {msg}")


def _say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def _timed(fn, *args, reps=3):
    """(output, first-call seconds incl. compile, median warm seconds)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        walls.append(time.perf_counter() - t0)
    return out, first, statistics.median(walls)


def _rate(phase, name, batch, first, wall):
    _say(phase, f"{name}: {batch / wall:,.0f} traj/s (median {wall * 1e3:.2f} "
                f"ms of 3, first call {first:.1f} s incl. compile)")


def _rel(a, b):
    """max |a - b| over max |b| (state-magnitude relative error)."""
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    return float(jnp.max(jnp.abs(a - b)) / jnp.max(jnp.abs(b)))


# ---------------------------------------------------------------------------
# 2. rows engine
# ---------------------------------------------------------------------------

ROWS_B = 655_360
DAYS = 200.0


def _rows_problem(batch):
    from dynode_tpu.config import SolverParams
    from dynode_tpu.models import multistrain as ms

    cfg = ms.multistrain_config(
        solver_params=SolverParams(constant_step_size=0.5)
    )
    base = ms.multistrain_odeparams(cfg)
    y0 = ms.multistrain_initial_state(cfg)
    scales = jax.random.uniform(
        jax.random.PRNGKey(0), (batch,), minval=0.8, maxval=1.25
    )
    beta = base.beta[None, :] * scales[:, None]
    rows = ms.n_state_rows()
    return dict(
        cfg=cfg, base=base, y0=y0, scales=scales,
        rhs=ms.MultistrainRowsRHS.from_params(base),
        y_rows=ms.pack_state(y0, batch),
        p_rows=ms.pack_params(beta, base.sigma, base.gamma, base.omega, batch),
        # the cumulative-incidence rows: what a fit observes
        obs=tuple(range(rows - 6, rows)),
    )


def phase_rows():
    from dynode_tpu import simulate
    from dynode_tpu.models.multistrain import multistrain_ode
    from dynode_tpu.ops import (
        ensemble_solve_kernel,
        ensemble_solve_kernel_adaptive,
        ensemble_solve_kernel_adaptive_reference,
        ensemble_solve_kernel_reference,
        kernel_route,
    )

    ph = "rows"
    _require(kernel_route() == "triton", f"route is {kernel_route()!r}")
    pr = _rows_problem(ROWS_B)
    rhs, yr, prow, obs = pr["rhs"], pr["y_rows"], pr["p_rows"], pr["obs"]
    _say(ph, f"multistrain SEIRS, {yr.shape[0]} state rows, {DAYS:.0f} days, "
             f"B={ROWS_B:,}, saves of the {len(obs)} cumulative-incidence rows")

    # constant step, Tsit5, dt=0.5
    kern, kf, kw = _timed(
        lambda y, p: ensemble_solve_kernel(
            rhs, y, p, duration=DAYS, dt=0.5, save_rows=obs
        ), yr, prow,
    )
    _rate(ph, "Triton kernel, constant step (tsit5)", ROWS_B, kf, kw)
    with jax.default_matmul_precision("highest"):
        ref_fn = jax.jit(lambda y, p: ensemble_solve_kernel_reference(
            rhs, y, p, duration=DAYS, dt=0.5
        )[:, list(obs)])
        ref, rf, rw = _timed(ref_fn, yr, prow)
        _rate(ph, "XLA lax.scan reference, constant step", ROWS_B, rf, rw)

        sp = pr["cfg"].parameters.solver_params
        base, y0 = pr["base"], pr["y0"]

        def one(scale):
            p = base.replace(beta=base.beta * scale)
            return simulate(
                multistrain_ode, DAYS, y0, p, sp, sub_save_indices=(4,)
            ).ys[4]

        vm, vf, vw = _timed(jax.jit(jax.vmap(one)), pr["scales"])
        _rate(ph, "XLA jit(vmap(simulate)), constant step", ROWS_B, vf, vw)
    # Same tableau, same f32 operations: only FMA contraction and the
    # order the compilers pick can differ, so the kernel must match the
    # reference to 1e-5 of the state's magnitude.
    err = _rel(kern, ref)
    _say(ph, f"kernel vs lax reference: max rel err {err:.3e} (limit 1e-5)")
    _require(err <= 1e-5, f"constant-step kernel rel err {err}")
    # simulate() is an independent code path (same Tsit5 tableau)
    vm = jnp.moveaxis(vm.reshape(ROWS_B, vm.shape[1], -1), 0, -1)
    err_v = _rel(vm, ref)
    _say(ph, f"vmap(simulate) vs lax reference: {err_v:.3e} (limit 1e-4)")
    _require(err_v <= 1e-4, f"vmap(simulate) rel err {err_v}")
    _say(ph, f"kernel speedup: {rw / kw:.1f}x over the lax.scan reference, "
             f"{vw / kw:.1f}x over jit(vmap(simulate))")
    del kern, ref, vm

    # adaptive, BS3(2), rtol 1e-4, lockstep dt per block of members
    akw = dict(duration=DAYS, rtol=1e-4, atol=1e-6)
    (ak, stats), af, aw = _timed(
        lambda y, p: ensemble_solve_kernel_adaptive(
            rhs, y, p, save_rows=obs, **akw
        ), yr, prow,
    )
    _rate(ph, "Triton kernel, adaptive (bosh3, rtol 1e-4)", ROWS_B, af, aw)
    bad = int(jnp.sum(stats["exhausted_intervals"]))
    attempts = int(jnp.sum(stats["n_accepted"] + stats["n_rejected"]))
    _say(ph, f"adaptive kernel: {stats['n_accepted'].shape[0]} blocks, "
             f"{attempts / stats['n_accepted'].shape[0]:.1f} attempts per "
             f"block, {bad} exhausted intervals")
    _require(bad == 0, f"{bad} exhausted intervals")
    with jax.default_matmul_precision("highest"):
        aref_fn = jax.jit(lambda y, p: ensemble_solve_kernel_adaptive_reference(
            rhs, y, p, **akw
        )[0][:, list(obs)])
        aref, arf, arw = _timed(aref_fn, yr, prow)
        _rate(ph, "XLA adaptive lax reference (one block)", ROWS_B, arf, arw)
        # a tight constant-step solve of the first 16,384 members (whole
        # blocks, so the kernel's decisions for them are the ones checked)
        m = 16_384
        tight = jax.jit(lambda y, p: ensemble_solve_kernel_reference(
            rhs, y, p, duration=DAYS, dt=0.05
        )[:, list(obs)])(yr[:, :m], prow[:, :m])
    # rtol 1e-4 per step, accumulated over ~200 days of steps: the saves
    # must agree with the tight solve to 1e-3 of the state's magnitude
    # (as test_adaptive_reference_matches_tight_constant holds the reference)
    err_a = _rel(ak[..., :m], tight)
    err_ar = _rel(aref[..., :m], tight)
    _say(ph, f"adaptive kernel vs tight constant step: {err_a:.3e}; adaptive "
             f"lax reference vs tight: {err_ar:.3e} (limit 1e-3)")
    _require(err_a <= 1e-3, f"adaptive kernel rel err {err_a}")
    _require(err_ar <= 1e-3, f"adaptive reference rel err {err_ar}")
    _say(ph, f"adaptive kernel speedup: {arw / aw:.1f}x over the lax "
             "reference")


# ---------------------------------------------------------------------------
# 3. SEIP
# ---------------------------------------------------------------------------

SEIP_B = 32_768


def phase_seip():
    from dynode_tpu import simulate
    from dynode_tpu.config import SolverParams
    from dynode_tpu.models.seip import (
        seip_config,
        seip_initial_state,
        seip_ode,
        seip_odeparams,
    )
    from dynode_tpu.ops import seip_ensemble_solve, seip_ensemble_solve_adaptive

    ph = "seip"
    cfg = seip_config(
        seasonal_vaccination=True,
        solver_params=SolverParams(constant_step_size=0.5),
    )
    base = seip_odeparams(cfg)
    y0 = seip_initial_state(cfg)
    n_float = sum(int(np.size(c)) for c in y0)
    scales = jax.random.uniform(
        jax.random.PRNGKey(1), (SEIP_B,), minval=0.85, maxval=1.2
    )
    _say(ph, f"production SEIP, {n_float} floats per member, B={SEIP_B:,}, "
             f"{DAYS:.0f} days, C-only saves")

    const = jax.jit(lambda s: seip_ensemble_solve(
        y0, base, s, duration=DAYS, dt=0.5, save=(3,)
    )[0])
    t0 = time.perf_counter()
    compiled = const.lower(scales).compile()
    _say(ph, f"constant-step program compiled in {time.perf_counter() - t0:.1f}"
             f" s; memory_analysis: {compiled.memory_analysis()}")
    c_big, cf, cw = _timed(compiled, scales)
    _rate(ph, "XLA seip_ensemble_solve (RK4, dt 0.5)", SEIP_B, cf, cw)
    adapt = jax.jit(lambda s: seip_ensemble_solve_adaptive(
        y0, base, s, duration=DAYS, rtol=1e-4, atol=1e-3, save=(3,)
    ))
    (a_big, stats), af, aw = _timed(adapt, scales)
    _rate(ph, "XLA seip_ensemble_solve_adaptive (BS3, rtol 1e-4)", SEIP_B,
          af, aw)
    bad = int(jnp.sum(stats["exhausted_intervals"]))
    _say(ph, f"adaptive: {int(stats['n_accepted'][0])} accepted, "
             f"{int(stats['n_rejected'][0])} rejected, {bad} exhausted")
    _require(bad == 0, f"SEIP adaptive exhausted {bad} intervals")

    # 16 members against simulate(seip_ode) with tight adaptive Tsit5
    m = 16
    tight_sp = SolverParams(
        ode_solver_rel_tolerance=1e-6, ode_solver_abs_tolerance=1e-4,
        step_budget=4096,
    )
    with jax.default_matmul_precision("highest"):
        def one(sc):
            sol = simulate(seip_ode, DAYS, y0, base.replace(beta=base.beta * sc),
                           tight_sp, sub_save_indices=(3,))
            return sol.ys[3], sol.result

        ref, res = jax.jit(jax.vmap(one))(scales[:m])
        ref = jnp.moveaxis(ref, 0, -1)  # member-last
        full = seip_ensemble_solve(y0, base, scales[:m], duration=DAYS)
    _require(int(jnp.sum(res != 0)) == 0, "tight reference solve failed")
    # RK4 at dt 0.5 against tight Tsit5: truncation plus f32 rounding,
    # measured ~1e-6 of C's magnitude; 1e-4 leaves room for reduction order
    err_c = _rel(c_big[..., :m], ref)
    # adaptive rtol 1e-4 accumulated over 200 days (as the rows engine)
    err_a = _rel(a_big[0][..., :m], ref)
    err_16 = _rel(full[3], ref)
    _say(ph, f"vs simulate(seip_ode) tight: constant {err_c:.3e} (limit "
             f"1e-4), 16-member solve {err_16:.3e} (limit 1e-4), adaptive "
             f"{err_a:.3e} (limit 1e-3)")
    _require(err_c <= 1e-4 and err_16 <= 1e-4, f"SEIP const {err_c} {err_16}")
    _require(err_a <= 1e-3, f"SEIP adaptive {err_a}")
    living = sum(
        jnp.sum(c, axis=tuple(range(1, c.ndim - 1))) for c in full[:3]
    )  # S + E + I per (day, member)
    drift = float(jnp.max(jnp.abs(living / living[0] - 1.0)))
    _say(ph, f"mass conservation: max relative drift of S+E+I {drift:.3e} "
             "(limit 1e-5)")
    _require(drift <= 1e-5, f"SEIP mass drift {drift}")


# ---------------------------------------------------------------------------
# 4. fit
# ---------------------------------------------------------------------------


def _posterior(samples):
    arr = np.asarray(samples["r0_scales"], dtype=np.float64)
    return arr  # (chains, draws, 3)


def _chees(model, obs, true, mcmc_kwargs=None, tag="ChEES"):
    from dynode_tpu.infer import MCMCProcess
    from dynode_tpu.infer.diagnostics import effective_sample_size

    proc = MCMCProcess(
        numpyro_model=model, num_warmup=200, num_samples=200,
        num_chains=4096, nuts_max_tree_depth=3, sampler="chees",
        progress_bar=False, mcmc_kwargs=mcmc_kwargs or {},
    )
    t0 = time.perf_counter()
    mcmc = proc.infer(obs=obs, consensus_check=4)
    wall = time.perf_counter() - t0
    arr = _posterior(proc.get_samples(group_by_chain=True))
    ess = np.array([effective_sample_size(arr[..., k]) for k in range(3)])
    mean = arr.reshape(-1, 3).mean(axis=0)
    stuck = int((arr.std(axis=1).max(axis=-1) < 1e-5).sum())
    z = max(mcmc.consensus_report.values())
    rel = np.abs(mean / true - 1.0)
    _say("fit", f"{tag}: 4096 chains x (200+200) in {wall:.1f} s incl. "
                f"compile; min ESS {ess.min():.0f}; posterior means "
                f"{np.round(mean, 4)} (true {true}); max rel {rel.max():.4f} "
                f"(limit 0.02); stuck {stuck}; consensus z {z:.2f} (limit 4)")
    _require(np.all(np.isfinite(arr)), f"{tag}: non-finite draws")
    _require(rel.max() <= 0.02, f"{tag}: posterior mean off by {rel.max()}")
    _require(stuck == 0, f"{tag}: {stuck} stuck chains")
    _require(z < 4.0, f"{tag}: consensus z {z}")
    sem = arr.reshape(-1, 3).std(axis=0) / np.sqrt(ess)
    return mean, sem


def phase_fit():
    from bench_nuts import make_workload
    from dynode_tpu.infer import MCMCProcess, SVIProcess

    model, obs, true = make_workload()
    true = np.asarray(true)
    _chees(model, obs, true)

    proc = MCMCProcess(
        numpyro_model=model, num_warmup=50, num_samples=50, num_chains=1024,
        nuts_max_tree_depth=3, sampler="nuts", progress_bar=False,
    )
    t0 = time.perf_counter()
    mcmc = proc.infer(obs=obs)
    wall = time.perf_counter() - t0
    arr = _posterior(proc.get_samples(group_by_chain=True))
    mean = arr.reshape(-1, 3).mean(axis=0)
    div = int(np.asarray(mcmc.get_extra_fields()["diverging"]).sum())
    rel = np.abs(mean / true - 1.0)
    _say("fit", f"NUTS: 1024 chains x (50+50), depth 3, in {wall:.1f} s incl. "
                f"compile; posterior means {np.round(mean, 4)}; max rel "
                f"{rel.max():.4f} (limit 0.05); {div} divergences")
    _require(np.all(np.isfinite(arr)), "NUTS: non-finite draws")
    _require(rel.max() <= 0.05, f"NUTS: posterior mean off by {rel.max()}")

    svi = SVIProcess(
        numpyro_model=model, num_iterations=200, num_samples=1000,
        num_starts=1024, progress_bar=False,
    )
    t0 = time.perf_counter()
    svi.infer(obs=obs)
    wall = time.perf_counter() - t0
    result = svi._inference_state
    losses = np.asarray(result.losses)
    finite = float(np.isfinite(np.asarray(result.final_elbos)).mean())
    mean = np.asarray(svi.get_samples()["r0_scales"]).reshape(-1, 3).mean(0)
    _say("fit", f"SVI: 1024 starts x 200 steps in {wall:.1f} s incl. "
                f"compile; best start -ELBO {losses[0]:.1f} -> "
                f"{losses[-1]:.1f}; {finite:.1%} of starts finite; "
                f"posterior means {np.round(mean, 4)}")
    _require(np.all(np.isfinite(losses)), "SVI: non-finite loss")
    _require(losses[-1] < losses[0], "SVI: ELBO did not improve")
    _require(np.abs(mean / true - 1.0).max() <= 0.05, "SVI: posterior off")


# ---------------------------------------------------------------------------
# --four: the sharded path against one card
# ---------------------------------------------------------------------------


def phase_four():
    from jax.sharding import Mesh

    from bench_nuts import make_workload
    from dynode_tpu.ops import (
        ensemble_solve_kernel,
        ensemble_solve_kernel_adaptive,
        ensemble_solve_kernel_adaptive_sharded,
        ensemble_solve_kernel_sharded,
    )

    ph = "four"
    devices = jax.devices()
    _require(len(devices) == 4, f"--four needs 4 cards, found {len(devices)}")
    mesh = Mesh(np.asarray(devices), ("ensemble",))
    pr = _rows_problem(ROWS_B)
    rhs, yr, prow, obs = pr["rhs"], pr["y_rows"], pr["p_rows"], pr["obs"]
    kw = dict(duration=DAYS, dt=0.5, save_rows=obs)
    one, of, ow = _timed(lambda y, p: ensemble_solve_kernel(rhs, y, p, **kw),
                         yr, prow)
    four, ff, fw = _timed(
        lambda y, p: ensemble_solve_kernel_sharded(rhs, y, p, mesh=mesh, **kw),
        yr, prow,
    )
    _rate(ph, "constant step, 1 card", ROWS_B, of, ow)
    _rate(ph, "constant step, 4 cards", ROWS_B, ff, fw)
    same = bool(jnp.array_equal(one, four))
    _say(ph, f"constant step: 4-card saves bit-identical to 1 card: {same}")
    _require(same, "sharded constant-step saves differ")
    # 128-member blocks divide the 163,840 members per card, so every
    # block keeps its members and its dt chain
    akw = dict(duration=DAYS, rtol=1e-4, atol=1e-6, save_rows=obs, block_b=128)
    (a1, s1), af1, aw1 = _timed(
        lambda y, p: ensemble_solve_kernel_adaptive(rhs, y, p, **akw), yr, prow
    )
    (a4, s4), af4, aw4 = _timed(
        lambda y, p: ensemble_solve_kernel_adaptive_sharded(
            rhs, y, p, mesh=mesh, **akw
        ), yr, prow,
    )
    _rate(ph, "adaptive, 1 card", ROWS_B, af1, aw1)
    _rate(ph, "adaptive, 4 cards", ROWS_B, af4, aw4)
    same = bool(jnp.array_equal(a1, a4)) and all(
        bool(jnp.array_equal(s1[k], s4[k])) for k in s1
    )
    _say(ph, f"adaptive: 4-card saves and stats identical to 1 card: {same}")
    _require(same, "sharded adaptive solve differs")
    del one, four, a1, a4

    from dynode_tpu.parallel import create_mesh

    model, obs_data, true = make_workload()
    true = np.asarray(true)
    m1, se1 = _chees(model, obs_data, true, tag="ChEES 1 card")
    m4, se4 = _chees(
        model, obs_data, true, tag="ChEES bank sharded over 4 cards",
        mcmc_kwargs={"mesh": create_mesh(("chain",))},
    )
    z = float(np.max(np.abs(m1 - m4) / np.sqrt(se1 ** 2 + se4 ** 2)))
    _say(ph, f"ChEES 4-card vs 1-card posterior means: max z {z:.2f} "
             "(limit 4)")
    _require(z < 4.0, f"4-card posterior differs from 1-card (z {z})")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--four", action="store_true",
        help="run only the 4-card sharded path and its 1-card comparison",
    )
    args = parser.parse_args()

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke: JAX found no GPU (platform {dev.platform!r})")
    _say("device", f"{dev.device_kind} x {len(jax.devices())}; jax "
                   f"{jax.__version__}")
    print(_card(), flush=True)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import dynode_tpu

    dynode_tpu.enable_compilation_cache()
    t0 = time.perf_counter()
    if args.four:
        phase_four()
    else:
        for phase in (phase_rows, phase_seip, phase_fit):
            t = time.perf_counter()
            phase()
            _say("time", f"{phase.__name__} took {time.perf_counter() - t:.1f} s")
    _say("time", f"all phases: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))


if __name__ == "__main__":
    main()
