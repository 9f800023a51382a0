"""ChEES-HMC: jittered fixed-length HMC with cross-chain adaptation.

Rationale. Vectorized NUTS banks run chains in lockstep, so every
transition costs the MAX tree size across the bank -- at 4096 chains the
whole bank waits for its deepest tree every draw (see CLAUDE.md perf notes).
ChEES-HMC (Hoffman, Radul & Sountsov, "An Adaptive-MCMC Scheme for Setting
Trajectory Lengths in Hamiltonian Monte Carlo", AISTATS 2021) replaces the
per-chain U-turn recursion with ONE shared trajectory length, learned by
maximizing the Change-in-the-Estimator-of-the-Expected-Square criterion

    ChEES(T) = (1/4) E[ (||x' - E x'||^2 - ||x - E x||^2)^2 ]

whose gradient is estimated *across the chain bank* each iteration -- wide
banks are not just tolerated but REQUIRED for the estimator, making this the
natural sampler for the wide-bank regime where chains are a vector axis. Every
chain takes exactly the same number of leapfrog steps per iteration
(trajectory jittered by a shared Halton scalar to preserve ergodicity), so a
bank transition is a dense lockstep program with zero padding waste, and the
bank pays the *learned mean* trajectory, not the max.

All adaptation is cross-chain: one dual-averaged step size from the pooled
accept statistic, one mass matrix from pooled (window x chains) Welford
moments -- thousands of chains give covariance estimates per window that a
single NUTS chain needs its whole warmup to reach.

Reference parity note: the reference's inference surface is numpyro NUTS
(/root/reference/src/dynode/infer/inference.py:149-162); ChEES is an
addition for the wide-bank regime, exposed through the same
``MCMC(kernel, ...)`` runner (infer/mcmc.py).
"""

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from .hmc import (
    MAX_DELTA_ENERGY,
    WelfordState,
    chol_of_inv,
    da_init,
    da_update,
    welford_covariance,
    welford_init,
)
from .util import init_to_median


class ChEES:
    """ChEES-HMC kernel configuration (drop-in kernel for ``MCMC``).

    Parameters mirror :class:`NUTS` where they share meaning; the
    NUTS-specific tree controls are replaced by trajectory-length
    adaptation knobs:

    - ``max_num_steps``: hard cap on leapfrog steps per transition (the
      compiled while-loop bound).
    - ``trajectory_length``: fixed integration time; when ``None`` (default)
      it is learned during warmup via Adam on the ChEES criterion.
    - ``adapt_lr``: Adam learning rate for log-trajectory-length (paper
      default 0.025).
    - ``target_accept_prob`` defaults to 0.651, the optimal acceptance rate
      for jittered-HMC MH transitions (vs 0.8 for NUTS multinomial).
    """

    def __init__(
        self,
        model: Callable,
        *,
        dense_mass: bool = False,
        target_accept_prob: float = 0.651,
        init_strategy: Callable = init_to_median,
        step_size: Optional[float] = None,
        adapt_step_size: bool = True,
        adapt_mass_matrix: bool = True,
        trajectory_length: Optional[float] = None,
        max_num_steps: int = 1024,
        adapt_lr: float = 0.025,
        center_potential: bool = True,
        batched_potential_fn: Optional[Callable] = None,
        **_ignored,
    ):
        self.model = model
        self.dense_mass = dense_mass
        self.target_accept_prob = target_accept_prob
        self.init_strategy = init_strategy
        self.step_size = step_size
        self.adapt_step_size = adapt_step_size
        self.adapt_mass_matrix = adapt_mass_matrix
        self.trajectory_length = trajectory_length
        self.max_num_steps = int(max_num_steps)
        self.adapt_lr = adapt_lr
        self.center_potential = center_potential
        self.batched_potential_fn = batched_potential_fn


# ---------------------------------------------------------------------------
# bank-level mass-matrix algebra ((C, D) batches, shared metric)
# ---------------------------------------------------------------------------


def velocity_bank(inv_mass, r):
    """M^{-1} r for a (C, D) momentum bank (inv_mass shared)."""
    if inv_mass.ndim == 1:
        return inv_mass * r
    return r @ inv_mass  # inv_mass symmetric

def kinetic_bank(inv_mass, r):
    """Per-chain kinetic energy of the momentum bank."""
    return 0.5 * jnp.sum(r * velocity_bank(inv_mass, r), axis=-1)


def sample_momentum_bank(inv_mass, chol_inv, key, shape, dtype):
    """r ~ N(0, M) rows; chol_inv as in hmc.sample_momentum, shared."""
    eps = jax.random.normal(key, shape, dtype)
    if inv_mass.ndim == 1:
        return eps / chol_inv
    return jax.scipy.linalg.solve_triangular(
        chol_inv.T, eps.T, lower=False
    ).T


def _halton(i):
    """Base-2 radical inverse (van der Corput) of i+1, in (0, 1).

    Deterministic low-discrepancy jitter for the shared trajectory length
    (ChEES paper section 4): adjacent iterations get well-spread fractions,
    which both preserves ergodicity and lowers the variance of the
    trajectory-gradient estimator vs iid uniforms.
    """
    v = (i + 1).astype(jnp.uint32)
    v = ((v >> 1) & jnp.uint32(0x55555555)) | ((v & jnp.uint32(0x55555555)) << 1)
    v = ((v >> 2) & jnp.uint32(0x33333333)) | ((v & jnp.uint32(0x33333333)) << 2)
    v = ((v >> 4) & jnp.uint32(0x0F0F0F0F)) | ((v & jnp.uint32(0x0F0F0F0F)) << 4)
    v = ((v >> 8) & jnp.uint32(0x00FF00FF)) | ((v & jnp.uint32(0x00FF00FF)) << 8)
    v = (v >> 16) | (v << 16)
    return v.astype(jnp.float32) * jnp.float32(2.0**-32)


# ---------------------------------------------------------------------------
# one bank transition
# ---------------------------------------------------------------------------


class ChEESBankState(NamedTuple):
    """Carry of the vectorized ChEES transition (the whole chain bank)."""
    z: jax.Array  # (C, D)
    potential: jax.Array  # (C,)
    grad: jax.Array  # (C, D)
    energy: jax.Array  # (C,)
    accept_prob: jax.Array  # (C,)
    num_steps: jax.Array  # (C,) int32 (shared value broadcast per chain)
    diverging: jax.Array  # (C,) bool
    iter_idx: jax.Array  # () int32 -- global Halton index
    rng_key: jax.Array  # single bank key


class _TransitionAux(NamedTuple):
    z_prop: jax.Array  # (C, D) trajectory endpoints (pre-MH)
    v_end: jax.Array  # (C, D) endpoint velocities M^{-1} r
    p_accept: jax.Array  # (C,)
    jitter: jax.Array  # () the Halton fraction used
    n_steps: jax.Array  # () int32


def init_bank_state(pot_and_grad_bank, z0s, rng_key) -> ChEESBankState:
    """Initial bank state (potential + gradient) at the given positions."""
    pe, grad = pot_and_grad_bank(z0s)
    C = z0s.shape[0]
    zerosC = jnp.zeros((C,), z0s.dtype)
    return ChEESBankState(
        z=z0s,
        potential=pe,
        grad=grad,
        energy=pe,
        accept_prob=zerosC,
        num_steps=jnp.zeros((C,), jnp.int32),
        diverging=jnp.zeros((C,), bool),
        iter_idx=jnp.int32(0),
        rng_key=rng_key,
    )


def chees_transition(
    pot_and_grad_bank,
    inv_mass,
    chol_inv,
    eps,
    traj_len,
    max_num_steps: int,
    state: ChEESBankState,
):
    """One jittered-HMC transition for the whole bank (lockstep L steps)."""
    dtype = state.z.dtype
    key, k_mom, k_acc = jax.random.split(state.rng_key, 3)
    r0 = sample_momentum_bank(inv_mass, chol_inv, k_mom, state.z.shape, dtype)
    energy0 = state.potential + kinetic_bank(inv_mass, r0)

    u = _halton(state.iter_idx).astype(dtype)
    n_steps = jnp.clip(
        jnp.ceil(u * traj_len / eps).astype(jnp.int32), 1, max_num_steps
    )

    def cond(carry):
        return carry[0] < n_steps

    def body(carry):
        i, z, r, pe, g = carry
        r_half = r - 0.5 * eps * g
        z = z + eps * velocity_bank(inv_mass, r_half)
        pe, g = pot_and_grad_bank(z)
        r = r_half - 0.5 * eps * g
        return i + 1, z, r, pe, g

    _, z_end, r_end, pe_end, g_end = jax.lax.while_loop(
        cond, body, (jnp.int32(0), state.z, r0, state.potential, state.grad)
    )

    energy1 = pe_end + kinetic_bank(inv_mass, r_end)
    energy1 = jnp.where(jnp.isnan(energy1), jnp.inf, energy1)
    delta = energy1 - energy0
    p_accept = jnp.minimum(1.0, jnp.exp(-delta))
    diverging = delta > MAX_DELTA_ENERGY

    accept = jax.random.uniform(k_acc, p_accept.shape, dtype) < p_accept
    acc = accept[:, None]
    new_state = ChEESBankState(
        z=jnp.where(acc, z_end, state.z),
        potential=jnp.where(accept, pe_end, state.potential),
        grad=jnp.where(acc, g_end, state.grad),
        energy=energy0,
        accept_prob=p_accept,
        num_steps=jnp.full_like(state.num_steps, n_steps),
        diverging=diverging,
        iter_idx=state.iter_idx + 1,
        rng_key=key,
    )
    aux = _TransitionAux(
        z_prop=z_end,
        v_end=velocity_bank(inv_mass, r_end),
        p_accept=p_accept,
        jitter=u,
        n_steps=n_steps,
    )
    return new_state, aux


# ---------------------------------------------------------------------------
# ChEES criterion gradient + Adam on log-trajectory-length
# ---------------------------------------------------------------------------


def chees_rate_grad(z_old, aux: _TransitionAux):
    """Estimated d ChEES / d t at t = jitter * T, averaged over the bank.

    Per the paper (eq. 10): weight each chain's term by its acceptance
    probability; the endpoint velocity is dx'/dt.
    """
    # divergent proposals carry inf/nan endpoints with ~zero weight; mask
    # them BEFORE the bank means (0 * inf = nan would otherwise poison the
    # Adam state permanently)
    finite = jnp.all(
        jnp.isfinite(aux.z_prop) & jnp.isfinite(aux.v_end), axis=-1
    )
    fw = finite.astype(z_old.dtype)
    n_ok = jnp.maximum(jnp.sum(fw), 1.0)
    z_prop = jnp.where(finite[:, None], aux.z_prop, 0.0)
    v_end = jnp.where(finite[:, None], aux.v_end, 0.0)
    xo = z_old - jnp.mean(z_old, axis=0)
    xp = z_prop - jnp.sum(z_prop, axis=0) / n_ok
    a = jnp.sum(xp * xp, axis=-1) - jnp.sum(xo * xo, axis=-1)
    per_chain = fw * a * jnp.sum(xp * v_end, axis=-1)
    w = aux.p_accept / jnp.maximum(jnp.sum(fw * aux.p_accept), 1e-6)
    return jnp.sum(jnp.where(finite, w * per_chain, 0.0))


class TrajAdaptState(NamedTuple):
    """Adam carry for log-trajectory-length (ChEES criterion) adaptation."""
    log_t: jax.Array  # current log trajectory length
    log_t_avg: jax.Array  # trailing (iterate-averaged) value
    m: jax.Array  # Adam first moment
    v: jax.Array  # Adam second moment
    step: jax.Array


def traj_adapt_init(t0):
    """Fresh trajectory-adaptation state centered on ``t0``."""
    log_t = jnp.log(t0)
    z = jnp.zeros_like(log_t)
    return TrajAdaptState(log_t, log_t, z, z, z)


def traj_adapt_update(
    ts: TrajAdaptState, grad_log_t, lr=0.025, b1=0.9, b2=0.999, kappa=0.75
):
    """Adam ASCENT step on log T, with DA-style iterate averaging."""
    grad_log_t = jnp.where(jnp.isfinite(grad_log_t), grad_log_t, 0.0)
    step = ts.step + 1.0
    m = b1 * ts.m + (1.0 - b1) * grad_log_t
    v = b2 * ts.v + (1.0 - b2) * grad_log_t**2
    mhat = m / (1.0 - b1**step)
    vhat = v / (1.0 - b2**step)
    log_t = ts.log_t + lr * mhat / (jnp.sqrt(vhat) + 1e-8)
    w = step**-kappa
    log_t_avg = w * log_t + (1.0 - w) * ts.log_t_avg
    return TrajAdaptState(log_t, log_t_avg, m, v, step)


# ---------------------------------------------------------------------------
# pooled (cross-chain) adaptation helpers
# ---------------------------------------------------------------------------


def welford_update_bank(w: WelfordState, zb):
    """Fold a whole (C, D) bank of observations into a Welford state.

    Chan-et-al parallel merge of the bank's batch moments -- one call per
    warmup iteration replaces C sequential updates.
    """
    C = zb.shape[0]
    n_new = w.n + C
    mean_b = jnp.mean(zb, axis=0)
    delta = mean_b - w.mean
    mean = w.mean + delta * (C / n_new)
    centered = zb - mean_b
    if w.m2.ndim == 2:
        m2_b = centered.T @ centered
        cross = jnp.outer(delta, delta)
    else:
        m2_b = jnp.sum(centered * centered, axis=0)
        cross = delta * delta
    m2 = w.m2 + m2_b + cross * (w.n * C / n_new)
    return WelfordState(mean, m2, n_new)


def find_reasonable_step_size_bank(
    pot_and_grad_bank, inv_mass, chol_inv, state: ChEESBankState, key
):
    """Double/halve a SHARED eps until the bank-mean 1-leapfrog accept
    probability crosses 0.5 (bank version of hmc.find_reasonable_step_size)."""
    dtype = state.z.dtype

    def accept_prob(eps, k):
        r0 = sample_momentum_bank(inv_mass, chol_inv, k, state.z.shape, dtype)
        e0 = state.potential + kinetic_bank(inv_mass, r0)
        r_half = r0 - 0.5 * eps * state.grad
        z1 = state.z + eps * velocity_bank(inv_mass, r_half)
        pe1, g1 = pot_and_grad_bank(z1)
        r1 = r_half - 0.5 * eps * g1
        e1 = pe1 + kinetic_bank(inv_mass, r1)
        e1 = jnp.where(jnp.isnan(e1), jnp.inf, e1)
        return jnp.mean(jnp.minimum(1.0, jnp.exp(e0 - e1)))

    key, k0 = jax.random.split(key)
    eps0 = jnp.ones((), dtype)
    p0 = accept_prob(eps0, k0)
    going_up = p0 > 0.5

    def cond(carry):
        eps, i, key, crossed = carry
        return (~crossed) & (i < 64)

    def body(carry):
        eps, i, key, _ = carry
        eps_new = jnp.where(going_up, eps * 2.0, eps * 0.5)
        key, k = jax.random.split(key)
        p = accept_prob(eps_new, k)
        crossed = jnp.where(going_up, p <= 0.5, p >= 0.5)
        return eps_new, i + 1, key, crossed

    eps, _, key, _ = jax.lax.while_loop(
        cond, body, (eps0, jnp.int32(0), key, jnp.asarray(False))
    )
    return eps


# ---------------------------------------------------------------------------
# warmup / sampling program parts (bank-level; consumed by MCMC._run_chees)
# ---------------------------------------------------------------------------


def make_chees_parts(kernel: ChEES, pot_and_grad, D: int, dtype):
    """(init_bank, warm_segment, sample_segment) bank-level building blocks.

    ``pot_and_grad`` is the per-chain (pe, grad) function from MCMC.run
    (plain value_and_grad or the custom_vmap chain-batched wrapper); the
    bank view is its vmap, which the custom_vmap rule intercepts for
    natively batched potentials.
    """
    pot_and_grad_bank = jax.vmap(pot_and_grad)
    max_steps = kernel.max_num_steps
    target = kernel.target_accept_prob
    lr = kernel.adapt_lr

    def init_bank(z0s, rng_key):
        state = init_bank_state(pot_and_grad_bank, z0s, rng_key)
        if kernel.dense_mass:
            inv_mass = jnp.eye(D, dtype=dtype)
        else:
            inv_mass = jnp.ones((D,), dtype=dtype)
        chol = chol_of_inv(inv_mass)
        key = state.rng_key
        if kernel.step_size is not None:
            eps0 = jnp.asarray(kernel.step_size, dtype=dtype)
        else:
            key, k_eps = jax.random.split(key)
            eps0 = find_reasonable_step_size_bank(
                pot_and_grad_bank, inv_mass, chol, state, k_eps
            )
        state = state._replace(rng_key=key)
        if kernel.trajectory_length is not None:
            t0 = jnp.asarray(kernel.trajectory_length, dtype=dtype)
        else:
            # start at 8 leapfrogs rather than the paper's 1: Adam on log-T
            # moves at most ~lr nats/iteration, so with a sharp posterior
            # (tiny eps) and a short warmup the paper init cannot climb the
            # several nats to the optimum in time (seen on the SEIP fit:
            # T stuck ~0.5x optimal after 100 iterations). Overshooting is
            # cheap to adapt away; undershooting wrecks mixing.
            t0 = 8.0 * eps0
        return (
            state,
            da_init(eps0),
            traj_adapt_init(t0),
            welford_init(D, kernel.dense_mass, dtype),
            inv_mass,
            chol,
        )

    def warmup_step(carry, flags):
        slow, end, active = flags

        def do(carry):
            state, da, ts, wf, inv_mass, chol = carry
            eps = (
                jnp.exp(da.log_eps)
                if kernel.adapt_step_size
                else jnp.exp(da.log_eps_avg)
            )
            traj = jnp.maximum(jnp.exp(ts.log_t), eps)
            z_old = state.z
            state, aux = chees_transition(
                pot_and_grad_bank, inv_mass, chol, eps, traj, max_steps, state
            )
            if kernel.adapt_step_size:
                da = da_update(da, jnp.mean(aux.p_accept), target=target)
            if kernel.trajectory_length is None:
                # d/d logT = (dt/d logT) * d/dt = (u * T) * chees_rate_grad
                g = chees_rate_grad(z_old, aux) * aux.jitter * traj
                ts = traj_adapt_update(ts, g, lr=lr)
                # keep T within the integrable range for the current eps
                hi = jnp.log(eps * max_steps)
                lo = jnp.log(eps)
                ts = ts._replace(
                    log_t=jnp.clip(ts.log_t, lo, hi),
                    log_t_avg=jnp.clip(ts.log_t_avg, lo, hi),
                )
            if kernel.adapt_mass_matrix:
                wf = jax.lax.cond(
                    slow,
                    lambda w: welford_update_bank(w, state.z),
                    lambda w: w,
                    wf,
                )

                def refresh(args):
                    state, da, ts, wf, inv_mass, chol = args
                    inv_new = welford_covariance(wf)
                    chol_new = chol_of_inv(inv_new)
                    if not kernel.adapt_step_size:
                        # the user pinned eps: keep it (re-searching here
                        # would silently run the rest of warmup at a step
                        # size they explicitly chose away from)
                        return (
                            state,
                            da,
                            ts,
                            welford_init(D, kernel.dense_mass, dtype),
                            inv_new,
                            chol_new,
                        )
                    key, k_eps = jax.random.split(state.rng_key)
                    eps_new = find_reasonable_step_size_bank(
                        pot_and_grad_bank, inv_new, chol_new,
                        state._replace(rng_key=key), k_eps,
                    )
                    # the metric changed: restart step-size averaging around
                    # the re-searched eps; trajectory length carries over
                    # UNCHANGED. (A "metric-aware" rescale of log T by the
                    # step-size change was tried and measurably backfires:
                    # the reference step size at refresh time is a transient
                    # dual-averaging iterate, so the shift pumps T
                    # multiplicatively at every window -- observed 15x
                    # trajectory blow-up on the multistrain fit. Adam
                    # re-converges T under the new
                    # metric instead.)
                    return (
                        state._replace(rng_key=key),
                        da_init(eps_new),
                        ts,
                        welford_init(D, kernel.dense_mass, dtype),
                        inv_new,
                        chol_new,
                    )

                state, da, ts, wf, inv_mass, chol = jax.lax.cond(
                    end, refresh, lambda a: a,
                    (state, da, ts, wf, inv_mass, chol),
                )
            return (state, da, ts, wf, inv_mass, chol)

        carry = jax.lax.cond(active, do, lambda c: c, carry)
        return carry, None

    def warm_segment(carry, flags_chunk):
        carry, _ = jax.lax.scan(warmup_step, carry, flags_chunk)
        return carry

    def sample_segment(state, inv_mass, chol, eps, traj, dummy):
        def body(st, _):
            st, aux = chees_transition(
                pot_and_grad_bank, inv_mass, chol, eps, traj, max_steps, st
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

    return init_bank, warm_segment, sample_segment


__all__ = [
    "ChEES",
    "ChEESBankState",
    "chees_transition",
    "chees_rate_grad",
    "make_chees_parts",
    "init_bank_state",
    "welford_update_bank",
    "find_reasonable_step_size_bank",
    "traj_adapt_init",
    "traj_adapt_update",
    "TrajAdaptState",
]
