"""NUTS kernel + MCMC runner with vectorized, mesh-shardable chains.

API mirrors the numpyro surface the reference exercises
(src/dynode/infer/inference.py:149-169): ``MCMC(NUTS(model, dense_mass=True,
max_tree_depth=..., init_strategy=...), num_warmup, num_samples, num_chains)``
then ``.run(rng_key, **model_kwargs)`` / ``.get_samples(group_by_chain)``.

Differences from numpyro's host-loop design:
- chains are a **vmapped batch axis inside one jitted program** (warmup scan +
  sampling scan), not host processes; pass ``mesh=`` to shard the chain axis
  over devices via GSPMD (the collective-free data parallelism of this
  domain -- SURVEY.md section 2.8).
- the entire run (warmup windows, dual averaging, mass estimation, sampling)
  compiles once; there is no per-iteration Python.
"""

import math
import warnings
from collections import OrderedDict
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from jax.flatten_util import ravel_pytree

from ..parallel import create_mesh, jit_donated, shard_batch
from . import handlers
from .chees import ChEES, make_chees_parts
from .hmc import (
    build_warmup_schedule,
    chol_of_inv,
    da_init,
    da_update,
    find_reasonable_step_size,
    init_state,
    nuts_transition,
    welford_covariance,
    welford_init,
    welford_update,
)
from .util import (
    constrain_sample,
    flatten_potential,
    get_model_trace,
    get_transforms,
    init_to_median,
    initialize_latents,
    latent_sites,
    make_potential_fn,
    observed_logprob_centers,
    unconstrain_sample,
)


def _as_custom_vmap_potential(batched_pot):
    """Per-chain (pe, grad) view of a natively chain-batched potential.

    The NUTS transition is written per-chain and vmapped over the bank;
    a plain vmap would batch the potential's *internals* with the chain
    axis leading (tiny model tensors -> poorly filled vector units). This
    wrapper's custom_vmap rule intercepts every batched call and hands the
    full (chains, D) block to ``batched_pot`` instead, which is free to
    transpose to lane-major internally. One jax.vjp shares the forward
    pass between values and per-chain gradients (chains are independent,
    so the pullback of ones gives each chain its own gradient).
    """
    from jax.custom_batching import custom_vmap

    def batched_pot_and_grad(zb):
        pe, vjp = jax.vjp(batched_pot, zb)
        (g,) = vjp(jnp.ones_like(pe))
        return pe, g

    @custom_vmap
    def pot_and_grad(z):
        pe, g = batched_pot_and_grad(z[None])
        return pe[0], g[0]

    @pot_and_grad.def_vmap
    def _rule(axis_size, in_batched, zb):  # noqa: ARG001
        return batched_pot_and_grad(zb), (True, True)

    return pot_and_grad


_EXEC_CACHE: "OrderedDict[tuple, dict]" = OrderedDict()
_EXEC_CACHE_SIZE = 8


def _kernel_token(kern) -> tuple:
    """Hashable fingerprint of everything a kernel bakes into its programs."""
    common = (
        type(kern).__name__,
        kern.dense_mass,
        kern.target_accept_prob,
        id(kern.init_strategy),
        kern.step_size,
        kern.adapt_step_size,
        kern.adapt_mass_matrix,
        kern.center_potential,
        id(kern.batched_potential_fn)
        if kern.batched_potential_fn is not None
        else None,
    )
    if isinstance(kern, ChEES):
        return common + (
            kern.trajectory_length, kern.max_num_steps, kern.adapt_lr
        )
    return common + (kern.max_tree_depth,)


def _leaf_fingerprint(x):
    """Cheap content tag for an array leaf: shape/dtype + strided probe.

    Host numpy arrays are the stale-hit hazard of identity keying -- an
    in-place mutation keeps ``id(x)`` while the values a cached program
    compiled in are gone. The probe (8 strided elements + first/last) is
    O(1) and catches realistic mutations; ``jax.Array``s are immutable so
    identity alone proves their contents.
    """
    if isinstance(x, np.ndarray):
        flat = x.reshape(-1)
        if flat.size == 0:
            return (x.shape, x.dtype.str, b"")
        stride = max(1, flat.size // 8)
        probe = np.concatenate([flat[::stride][:8], flat[-1:]])
        return (x.shape, x.dtype.str, probe.tobytes())
    return None


def _exec_cache_entry(key: tuple, model, leaves, pinned) -> dict:
    """Fetch-or-create the cross-run executable cache entry for ``key``.

    Without it, every ``MCMC.run`` builds fresh closures, so a "warm"
    4096-chain ChEES run re-traces and re-compiles its 4 bank programs and
    spends most of its wall time there rather than on the device: even the second
    run of the identical fit missed the in-process jit cache entirely.
    This registry keys trace-derived objects (transforms, centers, the
    flattened potential) and the jitted phase programs on everything that
    is baked into them -- kernel configuration, run shape, and the
    IDENTITY of the model, of every array argument, and of the kernel's
    callable configuration (``init_strategy``, ``batched_potential_fn`` --
    ``pinned``). Arrays are closed over as compiled constants, so
    value-equality is not enough to prove reuse safe, and identity is what
    repeated fits in a session actually pass. Entries hold strong
    references to every keyed object both to pin their ids against
    recycling and to double-check hits with ``is``; numpy leaves
    additionally carry a content fingerprint so an in-place mutation
    (same id, new values) is a loud miss instead of a stale posterior.
    """
    fps = [_leaf_fingerprint(x) for x in leaves]
    entry = _EXEC_CACHE.get(key)
    if (
        entry is not None
        and entry["model"] is model
        and len(entry["leaves"]) == len(leaves)
        and all(a is b for a, b in zip(entry["leaves"], leaves))
        and len(entry["pinned"]) == len(pinned)
        and all(a is b for a, b in zip(entry["pinned"], pinned))
    ):
        if entry["fps"] == fps:
            _EXEC_CACHE.move_to_end(key)
            return entry
        warnings.warn(
            "MCMC executable cache: an array argument was mutated in "
            "place since the cached run (same object identity, different "
            "contents) -- recompiling. Pass a fresh array instead of "
            "mutating, or this run pays full compile cost every time.",
            stacklevel=3,
        )
    entry = {
        "model": model,
        "leaves": list(leaves),
        "pinned": list(pinned),
        "fps": fps,
        "jits": {},
    }
    _EXEC_CACHE[key] = entry
    _EXEC_CACHE.move_to_end(key)
    while len(_EXEC_CACHE) > _EXEC_CACHE_SIZE:
        _EXEC_CACHE.popitem(last=False)
    return entry


class NUTS:
    """No-U-Turn sampler kernel configuration for a model callable."""

    def __init__(
        self,
        model: Callable,
        *,
        dense_mass: bool = True,
        max_tree_depth: int = 10,
        target_accept_prob: float = 0.8,
        init_strategy: Callable = init_to_median,
        step_size: Optional[float] = None,
        adapt_step_size: bool = True,
        adapt_mass_matrix: bool = True,
        center_potential: bool = True,
        batched_potential_fn: Optional[Callable] = None,
        **_ignored,
    ):
        self.model = model
        self.dense_mass = dense_mass
        self.max_tree_depth = max_tree_depth
        self.target_accept_prob = target_accept_prob
        self.init_strategy = init_strategy
        self.step_size = step_size
        self.adapt_step_size = adapt_step_size
        self.adapt_mass_matrix = adapt_mass_matrix
        #: optional natively chain-batched potential: ``fn(z_batch) -> pe``
        #: maps a (chains, D) block of UNCONSTRAINED flat latents to
        #: (chains,) potential energies, and must implement exactly the
        #: semantics of the model-derived potential (negative log-joint
        #: including jacobian corrections; centering is its own business).
        #: NUTS only ever *calls* the potential, so the vectorized chain
        #: bank routes every evaluation through this function via a
        #: custom_vmap rule -- letting the user lay the chain axis out
        #: lane-major (batch-LAST) inside an ODE solve for the full
        #: ensemble-layout speedup (see simulation.ensemble_rhs). The
        #: ``model`` is still used for tracing/site naming/transforms/inits;
        #: equivalence vs the generic path is asserted in
        #: tests/test_infer/test_batched_potential.py.
        self.batched_potential_fn = batched_potential_fn
        #: subtract fixed per-datapoint reference log-probs from observed
        #: sites before summing: shifts the potential by a constant (the
        #: posterior is unchanged) but keeps float32 energy differences free
        #: of catastrophic cancellation on large datasets. Note that the
        #: collected ``potential_energy``/``energy`` extras carry the shift.
        self.center_potential = center_potential


class MCMC:
    """Run NUTS chains as one compiled, vectorized (optionally sharded) program."""

    def __init__(
        self,
        kernel: NUTS,
        *,
        num_warmup: int,
        num_samples: int,
        num_chains: int = 1,
        chain_method: str = "vectorized",
        progress_bar: bool = False,
        mesh=None,
        chain_axis: str = "chain",
        steps_per_call: Optional[int] = None,
        rescue_stuck_chains: bool = True,
    ):
        # NOTE: no **kwargs catch-all -- a misspelled option raises a
        # TypeError instead of silently changing semantics (reference users
        # reach this signature through MCMCProcess.mcmc_kwargs,
        # /root/reference/src/dynode/infer/inference.py:127-131)
        if chain_method not in ("vectorized", "sequential", "parallel"):
            raise ValueError(
                f"unknown chain_method {chain_method!r}: expected "
                "'vectorized' (one vmapped bank, the default), "
                "'parallel' (mesh-sharded vectorized bank), or "
                "'sequential' (host loop, one chain at a time)"
            )
        self.kernel = kernel
        self.num_warmup = int(num_warmup)
        self.num_samples = int(num_samples)
        self.num_chains = int(num_chains)
        self.chain_method = chain_method
        self.progress_bar = progress_bar
        self.mesh = mesh
        self.chain_axis = chain_axis
        #: when set, warmup/sampling run in host-chunked jit calls of this
        #: many transitions each (bounds each program's device runtime and
        #: lets the host rescue stuck chains between chunks)
        self.steps_per_call = steps_per_call
        #: re-seat chains that exit warmup with collapsed step sizes or
        #: non-finite potentials (chunked execution; see
        #: :meth:`_rescue_stuck_chains`)
        self.rescue_stuck_chains = rescue_stuck_chains
        self._n_rescued = 0
        self._samples: Optional[Dict[str, jax.Array]] = None
        self._extra_fields: Optional[Dict[str, jax.Array]] = None
        self._transforms = None
        self._unravel = None
        self._model_args: tuple = ()
        self._model_kwargs: dict = {}
        self.last_state = None
        self._tuned = None  # per-chain (inv_mass, chol, eps) after adaptation
        #: per-site max sub-bank z-scores from ``run(consensus_check=k)``
        self.consensus_report: Optional[Dict[str, float]] = None

    # -- single-chain program (vmapped below) -------------------------------

    def _chain_fn(self, pot_and_grad, D, dtype, warm: bool = False):
        """Single-program per-chain runner (vmapped by the caller).

        Delegates to the :meth:`_parts` building blocks; ``warm=True``
        returns a sampling-only runner for chained inference.
        """
        init_chain, warm_segment, sample_segment = self._parts(
            pot_and_grad, D, dtype
        )
        in_slow, win_end = build_warmup_schedule(self.num_warmup)
        flags = jnp.stack(
            [
                jnp.asarray(in_slow),
                jnp.asarray(win_end),
                jnp.ones_like(jnp.asarray(in_slow)),
            ],
            axis=-1,
        )
        dummy = jnp.arange(self.num_samples)

        def run_warm(state, inv_mass, chol, eps_final):
            state, collected = sample_segment(
                state, inv_mass, chol, eps_final, dummy
            )
            collected["step_size"] = eps_final
            return state, (inv_mass, chol, eps_final), collected

        if warm:
            return run_warm

        def run(z0, rng_key):
            carry = init_chain(z0, rng_key)
            if self.num_warmup > 0:
                carry = warm_segment(carry, flags)
            state, da, wf, inv_mass, chol = carry
            # exp(log_eps_avg) is correct whether or not step-size adaptation
            # ran: da_init seeds the average with the fixed or searched eps,
            # and with adapt_step_size=False it never moves (a direct
            # jnp.asarray(kernel.step_size) here raised on None when the user
            # relied on the automatic search with adaptation off)
            eps_final = jnp.exp(da.log_eps_avg)
            return run_warm(state, inv_mass, chol, eps_final)

        return run

    # -- chunked execution: bound the on-chip runtime of each jit call -------
    # (single multi-minute XLA programs can trip device watchdogs; chunking
    # at the host level costs one dispatch per `steps_per_call` transitions)

    def _parts(self, pot_and_grad, D, dtype):
        kern = self.kernel
        max_depth = kern.max_tree_depth
        target = kern.target_accept_prob

        def init_chain(z0, rng_key):
            state = init_state(pot_and_grad, z0, rng_key)
            if kern.dense_mass:
                inv_mass = jnp.eye(D, dtype=dtype)
            else:
                inv_mass = jnp.ones((D,), dtype=dtype)
            chol = chol_of_inv(inv_mass)
            key = state.rng_key
            if kern.step_size is not None:
                eps0 = jnp.asarray(kern.step_size, dtype=dtype)
            else:
                key, k_eps = jax.random.split(key)
                eps0 = find_reasonable_step_size(
                    pot_and_grad, inv_mass, chol, state, k_eps
                )
            state = state._replace(rng_key=key)
            return (
                state,
                da_init(eps0),
                welford_init(D, kern.dense_mass, dtype),
                inv_mass,
                chol,
            )

        def warmup_step(carry, flags):
            # flags = (slow, end, active); active=0 marks a padding step
            # (chunked execution pads every chunk to a fixed length so only
            # ONE warmup program is ever compiled -- a remainder-sized chunk
            # would otherwise trigger a full recompile)
            slow, end, active = flags

            def do(carry):
                state, da, wf, inv_mass, chol = carry
                eps = (
                    jnp.exp(da.log_eps)
                    if kern.adapt_step_size
                    else jnp.exp(da.log_eps_avg)
                )
                state = nuts_transition(
                    pot_and_grad, inv_mass, chol, eps, max_depth, state
                )
                if kern.adapt_step_size:
                    da = da_update(da, state.accept_prob, target=target)
                if kern.adapt_mass_matrix:
                    wf = jax.lax.cond(
                        slow,
                        lambda w: welford_update(w, state.z),
                        lambda w: w,
                        wf,
                    )

                    def refresh(args):
                        state, da, wf, inv_mass, chol = args
                        inv_new = welford_covariance(wf)
                        chol_new = chol_of_inv(inv_new)
                        if not kern.adapt_step_size:
                            # step-size adaptation is off: keep the pinned
                            # (or init-searched) eps -- re-searching here
                            # would silently override a step size the user
                            # explicitly turned adaptation off to protect
                            # (ChEES's refresh has the same guard)
                            return (
                                state,
                                da,
                                welford_init(D, kern.dense_mass, dtype),
                                inv_new,
                                chol_new,
                            )
                        # re-search a reasonable step size under the NEW
                        # metric (skipping this lets chains whose step size
                        # collapsed in a bad window death-spiral: tiny eps ->
                        # no movement -> degenerate next covariance ->
                        # tinier eps)
                        key, k_eps = jax.random.split(state.rng_key)
                        eps_new = find_reasonable_step_size(
                            pot_and_grad, inv_new, chol_new, state, k_eps
                        )
                        return (
                            state._replace(rng_key=key),
                            da_init(eps_new),
                            welford_init(D, kern.dense_mass, dtype),
                            inv_new,
                            chol_new,
                        )

                    state, da, wf, inv_mass, chol = jax.lax.cond(
                        end, refresh, lambda a: a, (state, da, wf, inv_mass, chol)
                    )
                return (state, da, wf, inv_mass, chol)

            carry = jax.lax.cond(active, do, lambda c: c, carry)
            return carry, None

        def warm_segment(carry, flags_chunk):
            carry, _ = jax.lax.scan(warmup_step, carry, flags_chunk)
            return carry

        def sample_segment(state, inv_mass, chol, eps_final, dummy):
            def body(st, _):
                st = nuts_transition(
                    pot_and_grad, inv_mass, chol, eps_final, max_depth, st
                )
                out = {
                    "z": st.z,
                    "potential_energy": st.potential,
                    "energy": st.energy,
                    "accept_prob": st.accept_prob,
                    "num_steps": st.num_steps,
                    "diverging": st.diverging,
                }
                return st, out

            return jax.lax.scan(body, state, dummy)

        return init_chain, warm_segment, sample_segment

    def _padded_warmup_flags(self, n: int):
        """(slow, window-end, active) warmup flags padded to whole chunks.

        Padding with active=0 no-op steps makes every chunk the SAME
        program (one compile); a remainder-sized final chunk would
        recompile the entire sampler program (a compile that can
        dominate small runs). Shared by the
        per-chain (NUTS) and bank (ChEES) chunked runners.
        """
        in_slow, win_end = build_warmup_schedule(self.num_warmup)
        flags = np.stack(
            [in_slow, win_end, np.ones_like(in_slow)], axis=-1
        )
        n_chunks = -(-self.num_warmup // n) if self.num_warmup else 0
        pad = n_chunks * n - self.num_warmup
        if pad:
            flags = np.concatenate(
                [flags, np.zeros((pad, 3), dtype=flags.dtype)], axis=0
            )
        return flags, n_chunks

    def _run_chunked(self, pot_and_grad, D, dtype, z0s, chain_keys):
        n = int(self.steps_per_call)
        jits = self._exec["jits"]
        if "nuts_chunked" not in jits:
            init_chain, warm_segment, sample_segment = self._parts(
                pot_and_grad, D, dtype
            )
            # donate the chunk carry / chain state: on wide banks it is the
            # dominant live allocation, and each chunk call consumes the
            # previous chunk's output (never reused on the host)
            jits["nuts_chunked"] = (
                jax.jit(jax.vmap(init_chain)),
                jit_donated(jax.vmap(warm_segment, in_axes=(0, None))),
                jit_donated(
                    jax.vmap(sample_segment, in_axes=(0, 0, 0, 0, None))
                ),
            )
        init_jit, warm_jit, sample_jit = jits["nuts_chunked"]
        carry = init_jit(z0s, chain_keys)

        flags, n_chunks = self._padded_warmup_flags(n)
        for start in range(0, n_chunks * n, n):
            chunk = jnp.asarray(flags[start : start + n])
            carry = warm_jit(carry, chunk)
            carry = jax.block_until_ready(carry)

        state, da, wf, inv_mass, chol = carry
        # exp(log_eps_avg) works for both adaptation modes (see _chain_fn):
        # with adapt_step_size=False it stays pinned at the fixed/searched
        # eps, and never raises on kernel.step_size=None
        eps_final = jnp.exp(da.log_eps_avg)

        state, inv_mass, chol, eps_final = self._rescue_stuck_chains(
            state, inv_mass, chol, eps_final
        )

        # fixed-size sampling chunks (single compiled program); the last
        # chunk may overshoot num_samples -- extra valid draws are sliced
        # off below (cheaper than compiling a second remainder program)
        dummy = jnp.arange(n)
        chunks = []
        for _start in range(0, self.num_samples, n):
            state, out = sample_jit(state, inv_mass, chol, eps_final, dummy)
            state = jax.block_until_ready(state)
            chunks.append(out)
        collected = jax.tree_util.tree_map(
            lambda *xs: jnp.concatenate(xs, axis=1)[:, : self.num_samples],
            *chunks,
        )
        collected["step_size"] = eps_final
        return state, (inv_mass, chol, eps_final), collected

    def _rescue_stuck_chains(self, state, inv_mass, chol, eps_final):
        """Re-seat born-dead chains on healthy tuned parameters.

        At very wide chain banks (4096+) a handful of chains can exit
        warmup with a collapsed step size or a non-finite potential --
        every warmup-robustness fix lowers the rate, but the tail risk
        scales with chain count, and ONE frozen chain craters min-ESS via
        the between-chain variance term. Since every chain targets the
        same posterior, re-seating a bad chain on the cross-chain median
        step size, a healthy donor's mass matrix, and the donor's position
        is statistically safe: any (eps, mass) pair gives a valid NUTS
        kernel, and the position is just a fresh init drawn from a
        converged chain. Runs on the host between the warmup and sampling
        programs (chunked execution only); disable with
        ``MCMC(rescue_stuck_chains=False)``.
        """
        if not self.rescue_stuck_chains or self.num_chains < 4:
            return state, inv_mass, chol, eps_final
        eps = np.asarray(jax.device_get(eps_final))
        pot = np.asarray(jax.device_get(state.potential))
        log_eps = np.log(np.maximum(eps, 1e-300))
        med = np.median(log_eps)
        bad = (log_eps < med - np.log(50.0)) | ~np.isfinite(pot)
        if not bad.any():
            return state, inv_mass, chol, eps_final
        healthy = np.where(~bad)[0]
        if healthy.size == 0:
            return state, inv_mass, chol, eps_final
        n_bad = int(bad.sum())
        # donor per bad chain: cycle through healthy chains deterministically
        donors = healthy[np.arange(n_bad) % healthy.size]
        bad_idx = jnp.asarray(np.where(bad)[0])
        donor_idx = jnp.asarray(donors)

        def reseat(arr):
            return arr.at[bad_idx].set(arr[donor_idx])

        # keep each bad chain's own rng_key so re-seated chains decorrelate
        # from their donors on the first transition
        state = state._replace(
            z=reseat(state.z),
            potential=reseat(state.potential),
            grad=reseat(state.grad),
            energy=reseat(state.energy),
        )
        inv_mass = reseat(inv_mass)
        chol = reseat(chol)
        eps_final = eps_final.at[bad_idx].set(
            jnp.asarray(np.exp(np.median(log_eps[healthy])), eps_final.dtype)
        )
        if self.progress_bar:
            print(
                f"[dynode_tpu.MCMC] re-seated {n_bad} stuck chain(s) on "
                "healthy tuned parameters after warmup"
            )
        self._n_rescued = n_bad
        return state, inv_mass, chol, eps_final

    # -- ChEES bank execution (shared-trajectory jittered HMC) ---------------

    def _run_chees(self, pot_and_grad, D, dtype, z0s, key_run, warm_start=None):
        """Run a ChEES kernel: ONE bank-level program, not a per-chain vmap.

        All adaptation (step size, mass matrix, trajectory length) pools
        statistics ACROSS the chain axis each iteration, so chains cannot be
        independent vmapped programs -- the bank is the unit of execution.
        Chunking semantics match :meth:`_run_chunked` (fixed-size padded
        chunks, one compile per phase).
        """
        kern = self.kernel
        if self.num_chains < 8 and kern.trajectory_length is None:
            # ChEES trajectory adaptation is a CROSS-CHAIN estimator: with
            # one chain the centered gradient terms are identically zero
            # (the trajectory silently never leaves its init) and with a
            # handful of chains the gradient is extremely noisy
            warnings.warn(
                f"ChEES with num_chains={self.num_chains} (< 8): trajectory "
                "adaptation pools statistics across chains and is "
                "ineffective for narrow banks (with 1 chain it never moves "
                "from its initialization). Use a wide bank, pass a fixed "
                "trajectory_length, or switch to the NUTS kernel.",
                stacklevel=3,
            )
        jits = self._exec["jits"]
        if "chees" not in jits:
            init_bank, warm_segment, sample_segment = make_chees_parts(
                kern, pot_and_grad, D, dtype
            )
            # donated chunk carry / bank state: see nuts_chunked note
            jits["chees"] = (
                jax.jit(init_bank),
                jit_donated(warm_segment),
                jit_donated(sample_segment),
            )
        init_jit, warm_jit, sample_jit = jits["chees"]
        if self.steps_per_call:
            n_warm = n_samp = int(self.steps_per_call)
        else:
            # monolithic mode: one chunk per phase, each sized exactly (a
            # shared max() here would run (and discard) up to
            # num_warmup - num_samples extra sampling transitions)
            n_warm = max(self.num_warmup, 1)
            n_samp = max(self.num_samples, 1)

        if warm_start is not None:
            state, (inv_mass, chol, eps, traj) = warm_start
            # re-evaluate the energy at the saved positions under THIS run's
            # potential: the centering constants (observed_logprob_centers)
            # depend on the rng-traced latents, so the saved potential values
            # are shifted by a run-specific constant -- comparing energies
            # across that shift rejects every proposal
            pe, grad = self._exec["check"](state.z)
            state = state._replace(potential=pe, grad=grad, rng_key=key_run)
            # sample_jit donates the bank state; deep-copy so donation can
            # never invalidate the caller's saved warm_start arrays
            state = jax.tree_util.tree_map(jnp.array, state)
        else:
            carry = init_jit(z0s, key_run)
            flags, n_chunks = self._padded_warmup_flags(n_warm)
            for start in range(0, n_chunks * n_warm, n_warm):
                chunk = jnp.asarray(flags[start : start + n_warm])
                carry = warm_jit(carry, chunk)
                carry = jax.block_until_ready(carry)
            state, da, ts, wf, inv_mass, chol = carry
            # exp(log_eps_avg) is correct whether or not step-size
            # adaptation ran: da_init seeds the average with the fixed or
            # searched eps, and with adapt_step_size=False it never moves
            # (a direct jnp.asarray(kern.step_size) here crashed when the
            # user relied on the automatic search with adaptation off)
            eps = jnp.exp(da.log_eps_avg)
            if kern.trajectory_length is not None:
                traj = jnp.asarray(kern.trajectory_length, dtype=dtype)
            else:
                traj = jnp.maximum(jnp.exp(ts.log_t_avg), eps)

        dummy = jnp.arange(n_samp)
        chunks = []
        for _start in range(0, self.num_samples, n_samp):
            state, out = sample_jit(state, inv_mass, chol, eps, traj, dummy)
            state = jax.block_until_ready(state)
            chunks.append(out)
        collected = jax.tree_util.tree_map(
            lambda *xs: jnp.concatenate(xs, axis=0)[: self.num_samples],
            *chunks,
        )
        # bank scans collect (draws, chains, ...); downstream expects
        # chains-leading
        collected = {k: jnp.moveaxis(v, 0, 1) for k, v in collected.items()}
        collected["step_size"] = jnp.full((self.num_chains,), eps, dtype)
        return state, (inv_mass, chol, eps, traj), collected

    # -- public API ----------------------------------------------------------

    def run(self, rng_key, *args, warm_start=None, consensus_check=None, **kwargs):
        """Trace the model, adapt, and sample; all chains in one program.

        ``warm_start``: a value from :meth:`warm_start_state` of a previous
        run -- skips warmup entirely and continues sampling from the saved
        per-chain states with the saved mass matrices and step sizes
        (chained inference).

        Model args/kwargs are cached by IDENTITY across runs (exec cache):
        pass the same objects to reuse compiled programs. numpy arrays
        additionally carry a content fingerprint, so mutating one in
        place between runs triggers a loud recompile (never a stale
        posterior) -- prefer passing a fresh array.

        ``consensus_check``: split the chain bank into this many sub-banks
        after sampling and compare their posterior means against the
        combined Monte-Carlo standard errors -- a cheap sanity check that
        the bank was not corrupted. Warns loudly when any site's
        sub-bank means diverge by more than 4 combined SEs; the per-site
        max z-scores are stored on :attr:`consensus_report`.
        """
        if "rng_key" in kwargs and not isinstance(rng_key, jax.Array):
            raise ValueError("pass rng_key positionally or as first arg")
        if warm_start is not None:
            # loud kernel-compatibility check: NUTS warm starts carry a
            # 3-tuple of tuned params, ChEES a bank-level 4-tuple (see
            # warm_start_state) -- unpacking the wrong one used to fail
            # deep inside the runner with an opaque arity error
            _, tuned = warm_start
            want = 4 if isinstance(self.kernel, ChEES) else 3
            if len(tuned) != want:
                raise ValueError(
                    "warm_start kernel mismatch: the saved tuned-parameter "
                    f"tuple has {len(tuned)} entries but a "
                    f"{type(self.kernel).__name__} kernel expects {want} "
                    "(NUTS saves (inv_mass, chol, step_size); ChEES saves "
                    "(inv_mass, chol, step_size, trajectory)). Re-create "
                    "the warm start with the same kernel type."
                )
            # loud bank-width check: a mismatched state runs to completion
            # with wrong-shaped, mislabeled outputs (collected step_size /
            # consensus_check use self.num_chains)
            saved_chains = warm_start[0].z.shape[0]
            if saved_chains != self.num_chains:
                raise ValueError(
                    f"warm_start width mismatch: the saved state holds "
                    f"{saved_chains} chains but this MCMC is configured "
                    f"with num_chains={self.num_chains}. Use a matching "
                    "num_chains (or rebuild the warm start, e.g. "
                    "chees_warm_start_from_guide(..., num_chains=...))."
                )
        if self.chain_method == "parallel":
            # numpyro's "parallel" = one host process per chain (pmap). The
            # equivalent here is the mesh-sharded vectorized bank:
            # identical math, GSPMD splits the chain axis across devices.
            n_dev = len(jax.devices())
            if (
                self.mesh is None
                and n_dev > 1
                and self.num_chains % n_dev == 0
            ):
                self.mesh = create_mesh((self.chain_axis,))
            if self.mesh is not None:
                warnings.warn(
                    "chain_method='parallel' runs as a mesh-sharded "
                    "vectorized chain bank on this backend (same posterior; "
                    "chains are split across devices via GSPMD rather than "
                    "host pmap)",
                    stacklevel=2,
                )
            else:
                warnings.warn(
                    "chain_method='parallel' fell back to a plain vectorized "
                    f"(unsharded) chain bank: {n_dev} device(s) visible and "
                    f"num_chains={self.num_chains} must be divisible by the "
                    "device count for the mesh-sharded layout",
                    stacklevel=2,
                )
        elif self.chain_method == "sequential":
            if isinstance(self.kernel, ChEES):
                raise ValueError(
                    "ChEES adapts across the whole chain bank each "
                    "transition; chain_method='sequential' cannot express "
                    "it -- use 'vectorized'"
                )
            if warm_start is not None or self.steps_per_call is not None:
                raise ValueError(
                    "chain_method='sequential' does not compose with "
                    "warm_start or steps_per_call; use 'vectorized'"
                )
        self._model_args = args
        self._model_kwargs = kwargs
        model = self.kernel.model

        # cross-run executable cache: everything below (trace, transforms,
        # centers, flattened potential, jitted phase programs) is baked
        # into compiled constants, so it can be reused verbatim whenever
        # the kernel config, run shape, and the identity of the model and
        # every array argument match (see _exec_cache_entry). Centers are
        # rng-derived constants -- reusing a previous run's shifts every
        # potential by the same per-site constant, which chains and
        # diagnostics are invariant to.
        leaves, treedef = jax.tree_util.tree_flatten((args, kwargs))
        cache_key = (
            id(model),
            _kernel_token(self.kernel),
            self.num_warmup,
            self.num_samples,
            self.num_chains,
            self.steps_per_call,
            self.chain_method,
            id(self.mesh),
            self.chain_axis,
            treedef,
            tuple(id(x) for x in leaves),
        )
        pinned = (self.kernel.init_strategy, self.kernel.batched_potential_fn)
        self._exec = _exec_cache_entry(cache_key, model, leaves, pinned)

        key_struct, key_init, key_run = jax.random.split(rng_key, 3)
        if "pot_and_grad" not in self._exec:
            tr = get_model_trace(model, key_struct, *args, **kwargs)
            if not latent_sites(tr):
                raise ValueError("model has no latent sample sites to infer")
            transforms = get_transforms(tr)
            centers = (
                observed_logprob_centers(tr)
                if self.kernel.center_potential
                else None
            )
            init_strategy = self.kernel.init_strategy

            def _flat_init(key):
                c_constrained = initialize_latents(tr, key, init_strategy)
                c_unconstrained = unconstrain_sample(
                    transforms, c_constrained
                )
                return ravel_pytree(c_unconstrained)[0]

            # one example init builds the unravel closure and the flat
            # potential; the per-chain inits are ONE vmapped program (the
            # old 1-chain-per-Python-iteration loop was seconds of host
            # dispatch at 4096 chains)
            c0 = initialize_latents(tr, key_struct, init_strategy)
            u0 = unconstrain_sample(transforms, c0)
            flat_pot, _, unravel = flatten_potential(
                make_potential_fn(
                    model, args, kwargs, transforms, centers=centers
                ),
                u0,
            )
            if self.kernel.batched_potential_fn is not None:
                pot_and_grad = _as_custom_vmap_potential(
                    self.kernel.batched_potential_fn
                )
            else:
                pot_and_grad = jax.value_and_grad(flat_pot)
            self._exec.update(
                tr=tr,
                transforms=transforms,
                unravel=unravel,
                pot_and_grad=pot_and_grad,
                flat_init_bank=jax.jit(jax.vmap(_flat_init)),
                check=jax.jit(jax.vmap(pot_and_grad)),
            )
        transforms = self._exec["transforms"]
        self._transforms = transforms
        self._unravel = unravel = self._exec["unravel"]
        pot_and_grad = self._exec["pot_and_grad"]
        flat_init_bank = self._exec["flat_init_bank"]
        check = self._exec["check"]

        if warm_start is not None:
            # warm-started runs never use fresh inits: the saved per-chain
            # states are the starting points, so skip the init bank AND its
            # finite-potential validation sweep (each costs a full batched
            # potential evaluation -- real latency on amortized re-fits)
            z0s = None
            _state0 = warm_start[0]
            D = _state0.z.shape[-1]
            dtype = _state0.z.dtype
        else:
            # per-chain inits (constrained -> unconstrained -> flat)
            init_keys = jax.random.split(key_init, self.num_chains)
            z0s = flat_init_bank(init_keys)
            D = z0s.shape[-1]
            dtype = z0s.dtype

            # reject non-finite starting points (extreme prior draws can sit
            # in regions where the solve blows up -> a chain born dead);
            # redraw up to 20 times per bad chain,
            # numpyro-find_valid_initial_params style
            redraw_key = key_init
            # validate-then-redraw: 21 validations bracket 20 redraw rounds,
            # so the final round's redraws are re-checked before giving up.
            for _attempt in range(21):
                pe0, g0 = check(z0s)
                ok = jnp.isfinite(pe0) & jnp.all(jnp.isfinite(g0), axis=-1)
                n_bad = int(jnp.sum(~ok))
                if not n_bad:
                    break
                if _attempt == 20:
                    bad = [int(i) for i in jnp.where(~ok)[0]]
                    raise RuntimeError(
                        "could not find finite initial potentials/gradients "
                        f"for all chains after 20 redraws (bad chains: {bad})"
                    )
                # full-width redraw, keep only the bad rows: reuses the one
                # compiled init program instead of compiling a ragged
                # len(bad)-sized one per attempt
                redraw_key, sub = jax.random.split(redraw_key)
                z_new = flat_init_bank(jax.random.split(sub, self.num_chains))
                z0s = jnp.where(ok[:, None], z0s, z_new)

        chain_keys = jax.random.split(key_run, self.num_chains)

        if self.progress_bar:
            print(
                f"[dynode_tpu.MCMC] compiling+running {self.num_chains} "
                f"chain(s) x ({self.num_warmup} warmup + "
                f"{self.num_samples} samples)..."
            )
        if isinstance(self.kernel, ChEES):
            if self.mesh is not None and z0s is not None:
                sharding = shard_batch(self.mesh, self.chain_axis)
                z0s = jax.device_put(z0s, sharding)
            self.last_state, self._tuned, collected = self._run_chees(
                pot_and_grad, D, dtype, z0s, key_run, warm_start=warm_start
            )
        elif warm_start is not None:
            prev_state, (inv_mass, chol, eps) = warm_start
            # same centering-shift hazard as the ChEES warm start above:
            # re-anchor the saved states on this run's potential function
            pe, grad = check(prev_state.z)
            prev_state = prev_state._replace(
                potential=pe, grad=grad, rng_key=chain_keys
            )
            if "nuts_warmstart" not in self._exec["jits"]:
                run_warm = self._chain_fn(pot_and_grad, D, dtype, warm=True)
                self._exec["jits"]["nuts_warmstart"] = jax.jit(
                    jax.vmap(run_warm)
                )
            self.last_state, self._tuned, collected = self._exec["jits"][
                "nuts_warmstart"
            ](prev_state, inv_mass, chol, eps)
        elif self.steps_per_call is not None:
            if self.mesh is not None:
                sharding = shard_batch(self.mesh, self.chain_axis)
                z0s = jax.device_put(z0s, sharding)
                chain_keys = jax.device_put(chain_keys, sharding)
            self.last_state, self._tuned, collected = self._run_chunked(
                pot_and_grad, D, dtype, z0s, chain_keys
            )
        elif self.chain_method == "sequential":
            # one chain at a time on the host; all chains share one compiled
            # per-chain program (numpyro "sequential" semantics -- results
            # match the vectorized bank chain-for-chain since chains are
            # independent and keyed individually)
            if "nuts_sequential" not in self._exec["jits"]:
                self._exec["jits"]["nuts_sequential"] = jax.jit(
                    self._chain_fn(pot_and_grad, D, dtype)
                )
            run_chain = self._exec["jits"]["nuts_sequential"]
            outs = [
                jax.block_until_ready(run_chain(z0s[i], chain_keys[i]))
                for i in range(self.num_chains)
            ]
            self.last_state, self._tuned, collected = jax.tree_util.tree_map(
                lambda *xs: jnp.stack(xs), *outs
            )
        else:
            if "nuts_monolithic" not in self._exec["jits"]:
                self._exec["jits"]["nuts_monolithic"] = jax.jit(
                    jax.vmap(self._chain_fn(pot_and_grad, D, dtype))
                )
            run_all = self._exec["jits"]["nuts_monolithic"]
            if self.mesh is not None:
                sharding = shard_batch(self.mesh, self.chain_axis)
                z0s = jax.device_put(z0s, sharding)
                chain_keys = jax.device_put(chain_keys, sharding)
            self.last_state, self._tuned, collected = run_all(z0s, chain_keys)
        z = collected.pop("z")  # (chains, samples, D)
        self._collect(z, collected)
        if consensus_check:
            self.consensus_report = self._consensus_check(int(consensus_check))
        if self.progress_bar:
            div = int(jnp.sum(self._extra_fields["diverging"]))
            print(f"[dynode_tpu.MCMC] done; divergences={div}")
        return self

    def _consensus_check(self, k: int):
        """Compare posterior means across ``k`` disjoint sub-banks.

        Chains are independent given the seed, so sub-bank means must agree
        to within Monte-Carlo error; a systematic divergence indicates a
        corrupted run rather than sampling noise. For
        each site and element, each sub-bank contributes
        ``(mean, var/ESS)``; pairs are compared via
        ``z = |mean_i - mean_j| / sqrt(sem_i^2 + sem_j^2)`` and the max z
        per site is returned. z > 4 triggers a warning recommending a
        re-run. O(sites x elements x k x draws log draws) on the host.
        """
        from .diagnostics import effective_sample_size

        if k < 2:
            raise ValueError("consensus_check needs k >= 2 sub-banks")
        if self.num_chains < 2 * k:
            raise ValueError(
                f"consensus_check={k} needs at least {2 * k} chains "
                f"(got {self.num_chains}) so every sub-bank has >= 2"
            )
        report = {}
        flagged = []
        for name, v in self._samples.items():
            arr = np.asarray(jax.device_get(v), dtype=np.float64)
            flat = arr.reshape(arr.shape[0], arr.shape[1], -1)
            groups = np.array_split(np.arange(arr.shape[0]), k)
            max_z = 0.0
            for e in range(flat.shape[-1]):
                stats = []
                for g in groups:
                    x = flat[g, :, e]
                    ess = max(effective_sample_size(x), 1.0)
                    stats.append((float(x.mean()), float(x.var(ddof=1)) / ess))
                for i in range(k):
                    for j in range(i + 1, k):
                        dm = abs(stats[i][0] - stats[j][0])
                        se = math.sqrt(stats[i][1] + stats[j][1])
                        if se > 0.0:
                            max_z = max(max_z, dm / se)
                        elif dm > 0.0:
                            max_z = float("inf")
            report[name] = max_z
            if max_z > 4.0:
                flagged.append((name, max_z))
        if flagged:
            detail = ", ".join(f"{n}: z={z:.1f}" for n, z in flagged)
            warnings.warn(
                f"consensus check FAILED ({detail}): sub-bank posterior "
                "means diverge beyond Monte-Carlo error. The run may be "
                "corrupted; re-run "
                "with a fresh seed before trusting this posterior.",
                stacklevel=3,
            )
        return report

    def _collect(self, z, extras):
        unravel = self._unravel
        uparams = jax.vmap(jax.vmap(unravel))(z)
        samples = {
            name: self._transforms[name](u) for name, u in uparams.items()
        }
        self._samples = samples
        self._extra_fields = extras
        # loud diagnostics for frozen chains (a stuck chain silently wrecks
        # ESS; better to hear about it than to read it off a flat traceplot)
        if self.num_samples >= 4:
            z_np = np.asarray(jax.device_get(z))  # (chains, draws, D)
            spread = z_np.std(axis=1).max(axis=-1)  # per-chain max-coord std
            stuck = np.where(spread < 1e-8)[0]
            if stuck.size:
                import warnings

                warnings.warn(
                    f"{stuck.size} of {self.num_chains} chains produced "
                    f"(near-)constant samples (chains {stuck[:10].tolist()}"
                    f"{'...' if stuck.size > 10 else ''}); their draws are "
                    "not exploring the posterior. Check warmup diagnostics "
                    "or re-run with different seeds.",
                    stacklevel=3,
                )

    def get_samples(self, group_by_chain: bool = False) -> Dict[str, jax.Array]:
        """Posterior samples per site: (C*S, ...) or (C, S, ...) arrays."""
        assert self._samples is not None, "run() first"
        if group_by_chain:
            return dict(self._samples)
        return {
            k: v.reshape((-1,) + v.shape[2:]) for k, v in self._samples.items()
        }

    def get_extra_fields(self, group_by_chain: bool = False):
        """Per-draw sampler statistics (``diverging``, ``num_steps``, ...)."""
        assert self._extra_fields is not None, "run() first"
        if group_by_chain:
            return dict(self._extra_fields)
        out = {}
        for k, v in self._extra_fields.items():
            if v.ndim >= 2:
                out[k] = v.reshape((-1,) + v.shape[2:])
            else:
                out[k] = v
        return out

    def deterministic_samples(self) -> Dict[str, jax.Array]:
        """Replay the model per posterior draw to collect deterministic sites.

        One vmapped model re-execution over all draws (same cost profile as
        numpyro's postprocessing of deterministic sites).
        """
        samples = self.get_samples(group_by_chain=False)
        model = self.kernel.model
        args, kwargs = self._model_args, self._model_kwargs

        def replay(draw):
            with handlers.trace() as tr, handlers.seed(jax.random.PRNGKey(0)), \
                    handlers.substitute(draw):
                model(*args, **kwargs)
            return {
                name: site["value"]
                for name, site in tr.items()
                if site["type"] == "deterministic"
            }

        probe = replay({k: v[0] for k, v in samples.items()})
        if not probe:
            return {}
        return jax.vmap(replay)(samples)

    def warm_start_state(self):
        """The resumable sampler state: ``(last_state, tuned_params)``.

        For a NUTS kernel: ``(per-chain HMCState, (inv_mass, chol,
        step_size))``. For a ChEES kernel: ``(ChEESBankState, (inv_mass,
        chol, step_size, trajectory))`` -- bank-level, 4 tuned entries.
        ``run()`` raises a "warm_start kernel mismatch" error if a saved
        state is fed to an MCMC configured with the other kernel type.

        Pass to a later ``run(..., warm_start=...)`` to continue sampling
        without re-running warmup (the reference keeps ``last_state`` "for
        chained inference of subsequent inferers" --
        src/dynode/infer/inference.py:50-53 -- this is the working version).
        """
        assert self.last_state is not None, "run() first"
        return self.last_state, self._tuned

    def print_summary(self):
        """Print a per-site posterior summary (mean/std/quantiles/ESS/r_hat).
        """
        from .diagnostics import summary

        stats = summary(self.get_samples(group_by_chain=True))
        for name, row in stats.items():
            print(name, row)


__all__ = ["NUTS", "MCMC"]
