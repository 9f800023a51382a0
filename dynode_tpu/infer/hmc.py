"""Iterative multinomial NUTS with windowed warmup adaptation.

A from-scratch, vectorization-first No-U-Turn sampler equivalent to the numpyro NUTS
configuration the reference uses (dense mass matrix, multinomial sampling,
target accept 0.8 -- reference: src/dynode/infer/inference.py:149-162):

- **All lax control flow**: the doubling loop is a ``lax.while_loop``; each
  2^depth-leapfrog subtree is built iteratively with a *binary-counter merge
  stack* of size max_tree_depth (no recursion), so whole chains jit into one
  XLA program and vmap into lockstep batched chains shardable over a mesh.
- **Generalized U-turn criterion** on momentum sums (direction-symmetric, the
  same check numpyro/Stan use), checked at every power-of-two merge.
- **Warmup**: Stan-style windows (fast / doubling-slow / fast) with Welford
  covariance estimation (dense or diagonal mass) and dual-averaging step-size
  adaptation, restarted at each mass-matrix update.

Gradients of the potential flow through the ODE engine's checkpointed scan,
so one NUTS leapfrog = one forward + one adjoint solve, all fused.
"""

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

MAX_DELTA_ENERGY = 1000.0


# ---------------------------------------------------------------------------
# mass matrix algebra (diag if inv.ndim == 1, dense if 2)
# ---------------------------------------------------------------------------


def velocity(inv_mass, r):
    """M^{-1} r."""
    if inv_mass.ndim == 1:
        return inv_mass * r
    return inv_mass @ r


def kinetic_energy(inv_mass, r):
    """Momentum kinetic energy under the inverse mass matrix."""
    return 0.5 * jnp.dot(r, velocity(inv_mass, r))


def sample_momentum(inv_mass, chol_inv, key, dtype):
    """r ~ N(0, M) where M = inv_mass^{-1}."""
    eps = jax.random.normal(key, jnp.shape(chol_inv)[:1], dtype=dtype)
    if inv_mass.ndim == 1:
        return eps / chol_inv  # chol_inv = sqrt(diag(inv_mass))
    # chol_inv = L with inv_mass = L L^T  ->  r = L^{-T} eps
    return jax.scipy.linalg.solve_triangular(chol_inv.T, eps, lower=False)


def chol_of_inv(inv_mass):
    """Cholesky factor used to draw momenta for the given mass matrix."""
    if inv_mass.ndim == 1:
        return jnp.sqrt(inv_mass)
    return jnp.linalg.cholesky(inv_mass)


def is_turning(inv_mass, r_left, r_right, r_sum):
    """Generalized U-turn criterion on the momentum sum (direction-symmetric)."""
    r_sum_c = r_sum - 0.5 * (r_left + r_right)
    at_left = jnp.dot(velocity(inv_mass, r_left), r_sum_c) <= 0
    at_right = jnp.dot(velocity(inv_mass, r_right), r_sum_c) <= 0
    return at_left | at_right


# ---------------------------------------------------------------------------
# leapfrog
# ---------------------------------------------------------------------------


class IntegratorState(NamedTuple):
    """Leapfrog carry: position, momentum, potential, gradient."""
    z: jax.Array
    r: jax.Array
    potential: jax.Array
    grad: jax.Array


def leapfrog(pot_and_grad: Callable, inv_mass, eps, state: IntegratorState):
    """One leapfrog step of the Hamiltonian integrator."""
    r_half = state.r - 0.5 * eps * state.grad
    z_new = state.z + eps * velocity(inv_mass, r_half)
    pe_new, grad_new = pot_and_grad(z_new)
    r_new = r_half - 0.5 * eps * grad_new
    return IntegratorState(z_new, r_new, pe_new, grad_new)


# ---------------------------------------------------------------------------
# iterative subtree construction (binary-counter merge stack)
# ---------------------------------------------------------------------------


class _Stack(NamedTuple):
    r_left: jax.Array  # (L, D) momentum at each open subtree's left edge
    r_right: jax.Array  # (L, D)
    r_sum: jax.Array  # (L, D)
    log_w: jax.Array  # (L,)
    prop_z: jax.Array  # (L, D) multinomial proposal within each subtree
    prop_pe: jax.Array  # (L,)
    prop_grad: jax.Array  # (L, D)


def _ctz(i):
    """Count trailing zeros of a positive int32 (values <= 2^24: exact)."""
    low = jnp.bitwise_and(i, -i).astype(jnp.float32)
    return jnp.round(jnp.log2(low)).astype(jnp.int32)


def _build_subtree(
    pot_and_grad,
    inv_mass,
    eps_signed,
    depth,
    edge: IntegratorState,
    energy0,
    key,
    max_depth: int,
):
    """Take 2^depth leapfrogs from ``edge``, merging with U-turn checks.

    Returns (stack-bottom entry, far-end state, valid, diverging, sum_accept,
    n_leaves, key). ``valid`` is False when the subtree turned or diverged,
    in which case the caller must discard it (standard NUTS semantics).
    """
    D = edge.z.shape[0]
    dtype = edge.z.dtype
    L = max_depth + 1
    stack = _Stack(
        r_left=jnp.zeros((L, D), dtype),
        r_right=jnp.zeros((L, D), dtype),
        r_sum=jnp.zeros((L, D), dtype),
        log_w=jnp.zeros((L,), dtype),
        prop_z=jnp.zeros((L, D), dtype),
        prop_pe=jnp.zeros((L,), dtype),
        prop_grad=jnp.zeros((L, D), dtype),
    )
    n_leaf = jnp.left_shift(jnp.int32(1), depth)

    def cond(carry):
        i, sp, stack, cur, turning, diverging, sum_acc, key = carry
        return (i < n_leaf) & ~turning & ~diverging

    def body(carry):
        i, sp, stack, cur, turning, diverging, sum_acc, key = carry
        new = leapfrog(pot_and_grad, inv_mass, eps_signed, cur)
        energy = new.potential + kinetic_energy(inv_mass, new.r)
        energy = jnp.where(jnp.isnan(energy), jnp.inf, energy)
        delta = energy - energy0
        diverging = delta > MAX_DELTA_ENERGY
        sum_acc = sum_acc + jnp.minimum(1.0, jnp.exp(-delta))
        i = i + 1

        # push the leaf
        stack = _Stack(
            r_left=stack.r_left.at[sp].set(new.r),
            r_right=stack.r_right.at[sp].set(new.r),
            r_sum=stack.r_sum.at[sp].set(new.r),
            log_w=stack.log_w.at[sp].set(-delta),
            prop_z=stack.prop_z.at[sp].set(new.z),
            prop_pe=stack.prop_pe.at[sp].set(new.potential),
            prop_grad=stack.prop_grad.at[sp].set(new.grad),
        )
        sp = sp + 1

        # binary-counter merges: after leaf i, merge ctz(i) times
        n_merges = _ctz(i)

        def merge(j, mcarry):
            sp, stack, turning, key = mcarry
            do = j < n_merges
            ai = sp - 2  # older (left-in-integration-order) subtree
            bi = sp - 1  # newer
            r_sum_m = stack.r_sum[ai] + stack.r_sum[bi]
            turn_m = is_turning(
                inv_mass, stack.r_left[ai], stack.r_right[bi], r_sum_m
            )
            log_w_m = jnp.logaddexp(stack.log_w[ai], stack.log_w[bi])
            key, sub = jax.random.split(key)
            take_b = jax.random.uniform(sub, dtype=dtype) < jnp.exp(
                stack.log_w[bi] - log_w_m
            )

            def pick(arr):
                return jnp.where(take_b, arr[bi], arr[ai])

            merged = _Stack(
                r_left=stack.r_left[ai],
                r_right=stack.r_right[bi],
                r_sum=r_sum_m,
                log_w=log_w_m,
                prop_z=pick(stack.prop_z),
                prop_pe=pick(stack.prop_pe),
                prop_grad=pick(stack.prop_grad),
            )

            def write(arr, val):
                return jnp.where(do, arr.at[ai].set(val), arr)

            stack = _Stack(
                r_left=write(stack.r_left, merged.r_left),
                r_right=write(stack.r_right, merged.r_right),
                r_sum=write(stack.r_sum, merged.r_sum),
                log_w=write(stack.log_w, merged.log_w),
                prop_z=write(stack.prop_z, merged.prop_z),
                prop_pe=write(stack.prop_pe, merged.prop_pe),
                prop_grad=write(stack.prop_grad, merged.prop_grad),
            )
            sp = jnp.where(do, sp - 1, sp)
            turning = turning | (do & turn_m)
            return sp, stack, turning, key

        sp, stack, turning, key = jax.lax.fori_loop(
            0, max_depth + 1, merge, (sp, stack, turning, key)
        )
        return (i, sp, stack, new, turning, diverging, sum_acc, key)

    i0 = jnp.int32(0)
    sp0 = jnp.int32(0)
    carry = (i0, sp0, stack, edge, jnp.asarray(False), jnp.asarray(False),
             jnp.zeros((), dtype), key)
    i, sp, stack, far, turning, diverging, sum_acc, key = jax.lax.while_loop(
        cond, body, carry
    )
    valid = (~turning) & (~diverging)
    entry = jax.tree_util.tree_map(lambda a: a[0], stack)
    return entry, far, valid, diverging, sum_acc, i, key


# ---------------------------------------------------------------------------
# one NUTS transition
# ---------------------------------------------------------------------------


class HMCState(NamedTuple):
    """Per-chain NUTS carry across transitions."""
    z: jax.Array
    potential: jax.Array
    grad: jax.Array
    energy: jax.Array
    accept_prob: jax.Array
    num_steps: jax.Array
    diverging: jax.Array
    rng_key: jax.Array


def init_state(pot_and_grad, z0, rng_key) -> HMCState:
    """Initial HMC state (potential and gradient evaluated) at ``z``."""
    pe, grad = pot_and_grad(z0)
    zero = jnp.zeros((), z0.dtype)
    return HMCState(
        z=z0,
        potential=pe,
        grad=grad,
        energy=pe,
        accept_prob=zero,
        num_steps=jnp.zeros((), jnp.int32),
        diverging=jnp.asarray(False),
        rng_key=rng_key,
    )


def nuts_transition(
    pot_and_grad,
    inv_mass,
    chol_inv,
    step_size,
    max_depth: int,
    state: HMCState,
) -> HMCState:
    """One NUTS transition: iterative tree doubling with multinomial sampling.
    """
    dtype = state.z.dtype
    key, k_mom = jax.random.split(state.rng_key)
    r0 = sample_momentum(inv_mass, chol_inv, k_mom, dtype)
    energy0 = state.potential + kinetic_energy(inv_mass, r0)
    start = IntegratorState(state.z, r0, state.potential, state.grad)

    def cond(carry):
        depth = carry[0]
        turning, diverging = carry[8], carry[9]
        return (depth < max_depth) & ~turning & ~diverging

    def body(carry):
        (depth, minus, plus, r_sum, log_w, prop_z, prop_pe, prop_grad,
         turning, diverging, sum_acc, n_leaves, key) = carry
        key, k_dir, k_bias, k_sub = jax.random.split(key, 4)
        go_right = jax.random.bernoulli(k_dir)
        edge = jax.tree_util.tree_map(
            lambda p, m: jnp.where(go_right, p, m), plus, minus
        )
        eps_signed = jnp.where(go_right, step_size, -step_size)
        entry, far, valid, div_s, sum_a, nl, key = _build_subtree(
            pot_and_grad, inv_mass, eps_signed, depth, edge, energy0, key,
            max_depth,
        )
        sum_acc = sum_acc + sum_a
        n_leaves = n_leaves + nl
        diverging = diverging | div_s

        # biased progressive sampling toward the new subtree
        take_new = (
            jax.random.uniform(k_bias, dtype=dtype)
            < jnp.exp(entry.log_w - log_w)
        ) & valid
        prop_z = jnp.where(take_new, entry.prop_z, prop_z)
        prop_pe = jnp.where(take_new, entry.prop_pe, prop_pe)
        prop_grad = jnp.where(take_new, entry.prop_grad, prop_grad)
        log_w = jnp.where(valid, jnp.logaddexp(log_w, entry.log_w), log_w)

        upd = valid & go_right
        plus = jax.tree_util.tree_map(
            lambda f, p: jnp.where(upd, f, p), far, plus
        )
        upd_m = valid & ~go_right
        minus = jax.tree_util.tree_map(
            lambda f, m: jnp.where(upd_m, f, m), far, minus
        )
        r_sum_new = r_sum + entry.r_sum
        turn_glob = is_turning(inv_mass, minus.r, plus.r, r_sum_new)
        turning = ~valid | (valid & turn_glob)
        r_sum = jnp.where(valid, r_sum_new, r_sum)
        return (depth + 1, minus, plus, r_sum, log_w, prop_z, prop_pe,
                prop_grad, turning, diverging, sum_acc, n_leaves, key)

    zero = jnp.zeros((), dtype)
    carry = (
        jnp.int32(0), start, start, r0, zero, state.z, state.potential,
        state.grad, jnp.asarray(False), jnp.asarray(False), zero,
        jnp.int32(0), key,
    )
    (depth, _, _, _, _, prop_z, prop_pe, prop_grad, _, diverging, sum_acc,
     n_leaves, key) = jax.lax.while_loop(cond, body, carry)

    accept_prob = sum_acc / jnp.maximum(n_leaves, 1).astype(dtype)
    return HMCState(
        z=prop_z,
        potential=prop_pe,
        grad=prop_grad,
        energy=energy0,
        accept_prob=accept_prob,
        num_steps=n_leaves,
        diverging=diverging,
        rng_key=key,
    )


# ---------------------------------------------------------------------------
# step-size search + dual averaging + Welford (warmup adaptation)
# ---------------------------------------------------------------------------


def find_reasonable_step_size(pot_and_grad, inv_mass, chol_inv, state, key):
    """Double/halve eps until the 1-leapfrog accept prob crosses 0.5."""
    dtype = state.z.dtype

    def accept_prob(eps, k):
        r0 = sample_momentum(inv_mass, chol_inv, k, dtype)
        st = IntegratorState(state.z, r0, state.potential, state.grad)
        new = leapfrog(pot_and_grad, inv_mass, eps, st)
        e0 = st.potential + kinetic_energy(inv_mass, r0)
        e1 = new.potential + kinetic_energy(inv_mass, new.r)
        e1 = jnp.where(jnp.isnan(e1), jnp.inf, e1)
        return jnp.exp(e0 - e1)

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


class DAState(NamedTuple):
    """Dual-averaging carry for step-size adaptation."""
    log_eps: jax.Array
    log_eps_avg: jax.Array
    h_avg: jax.Array
    t: jax.Array
    mu: jax.Array


def da_init(eps):
    """Fresh dual-averaging state anchored at ``mu = log(10 * eps0)``."""
    log_eps = jnp.log(eps)
    return DAState(
        log_eps=log_eps,
        log_eps_avg=log_eps,
        h_avg=jnp.zeros_like(log_eps),
        t=jnp.zeros_like(log_eps),
        mu=jnp.log(10.0 * eps),
    )


def da_update(da: DAState, accept_prob, target=0.8, gamma=0.05, t0=10.0, kappa=0.75):
    """Dual-averaging update toward the target acceptance statistic."""
    t = da.t + 1.0
    h_avg = (1.0 - 1.0 / (t + t0)) * da.h_avg + (target - accept_prob) / (t + t0)
    log_eps = da.mu - jnp.sqrt(t) / gamma * h_avg
    # bound adaptation to +-3 nats around the window's anchor (mu = log(10 e0)
    # -> e0 * [10/e^3, 10*e^3]): a run of f32-noise rejections early in a
    # window can otherwise collapse eps so far the chain freezes permanently
    log_eps = jnp.clip(log_eps, da.mu - 3.0 - jnp.log(10.0), da.mu + 3.0)
    w = t**-kappa
    log_eps_avg = w * log_eps + (1.0 - w) * da.log_eps_avg
    return DAState(log_eps, log_eps_avg, h_avg, t, da.mu)


class WelfordState(NamedTuple):
    """Streaming (co)variance accumulator carry."""
    mean: jax.Array
    m2: jax.Array  # (D,) or (D, D)
    n: jax.Array


def welford_init(D, dense, dtype):
    """Zeroed Welford accumulator (diagonal or dense)."""
    m2 = jnp.zeros((D, D), dtype) if dense else jnp.zeros((D,), dtype)
    return WelfordState(jnp.zeros((D,), dtype), m2, jnp.zeros((), dtype))


def welford_update(w: WelfordState, x):
    """Fold one sample into the Welford accumulator."""
    n = w.n + 1.0
    delta = x - w.mean
    mean = w.mean + delta / n
    delta2 = x - mean
    if w.m2.ndim == 2:
        m2 = w.m2 + jnp.outer(delta, delta2)
    else:
        m2 = w.m2 + delta * delta2
    return WelfordState(mean, m2, n)


def welford_covariance(w: WelfordState):
    """Regularized covariance estimate (Stan's shrinkage toward 1e-3 I)."""
    n = jnp.maximum(w.n, 2.0)
    cov = w.m2 / (n - 1.0)
    shrink = n / (n + 5.0)
    if w.m2.ndim == 2:
        eye = jnp.eye(w.m2.shape[0], dtype=w.m2.dtype)
        return shrink * cov + 1e-3 * (1.0 - shrink) * eye
    return shrink * cov + 1e-3 * (1.0 - shrink)


def build_warmup_schedule(num_warmup: int) -> Tuple[np.ndarray, np.ndarray]:
    """(is_in_slow_window, is_window_end) flags per warmup step (Stan scheme)."""
    in_slow = np.zeros(num_warmup, dtype=bool)
    window_end = np.zeros(num_warmup, dtype=bool)
    if num_warmup < 20:
        return in_slow, window_end
    if num_warmup >= 150:
        init_buf, term_buf, first_window = 75, 50, 25
    else:
        init_buf = int(0.15 * num_warmup)
        term_buf = int(0.1 * num_warmup)
        first_window = num_warmup - init_buf - term_buf
    pos = init_buf
    window = first_window
    slow_end = num_warmup - term_buf
    while pos < slow_end:
        end = pos + window
        if end + 2 * window > slow_end:
            end = slow_end  # absorb the remainder into the final window
        in_slow[pos:end] = True
        window_end[end - 1] = True
        pos = end
        window *= 2
    return in_slow, window_end


__all__ = [
    "IntegratorState",
    "HMCState",
    "init_state",
    "nuts_transition",
    "leapfrog",
    "velocity",
    "kinetic_energy",
    "sample_momentum",
    "chol_of_inv",
    "is_turning",
    "find_reasonable_step_size",
    "DAState",
    "da_init",
    "da_update",
    "WelfordState",
    "welford_init",
    "welford_update",
    "welford_covariance",
    "build_warmup_schedule",
    "MAX_DELTA_ENERGY",
]
