"""Ensemble solves of the production SEIP model (XLA on every platform).

Each member of the production SEIP model holds 640 floats, and an adaptive
step keeps about five such groups live (~12.8 KB per member). A GPU thread
has at most 255 registers (~1 KB), and a block's 227 KB of shared memory
holds ~17 members -- too narrow a block to fill the card. So there is no
whole-solve kernel for this model: both entry points below run plain JAX
(a batch-leading ``vmap`` of an RK4 ``lax.scan`` for the constant step, a
member-last lockstep BS3(2) controller for the adaptive solve), and XLA
compiles them for whichever device is present.

Reference counterpart: the model the reference only documents
(CDCgov/DynODE/ode_model.md:15-232); RHS semantics are
``models/seip.py::seip_ode``.
"""

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

_BS3_ERR_ORDER = 3.0

__all__ = [
    "seip_ensemble_solve",
    "seip_ensemble_solve_adaptive",
    "seip_solve_reference",
    "seip_solve_adaptive_reference",
]


def _check_save(save) -> Tuple[int, ...]:
    save = tuple(sorted(set(int(i) for i in save)))
    if not save or not all(0 <= i < 4 for i in save):
        raise ValueError(f"save must pick among compartments 0..3, got {save}")
    return save


@functools.partial(
    jax.jit, static_argnames=("n_steps", "stride", "dt", "save")
)
def _rk4_ensemble(y0, params, scales, *, n_steps, stride, dt, save):
    from ..models.seip import seip_ode

    def solve_one(scale):
        # scale: () shared or (L,) per-strain -- both broadcast into beta
        p = params.replace(beta=params.beta * scale)

        def rk4(y, t):
            k1 = seip_ode(t, y, p)
            y2 = tuple(a + 0.5 * dt * b for a, b in zip(y, k1))
            k2 = seip_ode(t + 0.5 * dt, y2, p)
            y3 = tuple(a + 0.5 * dt * b for a, b in zip(y, k2))
            k3 = seip_ode(t + 0.5 * dt, y3, p)
            y4 = tuple(a + dt * b for a, b in zip(y, k3))
            k4 = seip_ode(t + dt, y4, p)
            return tuple(
                a + (dt / 6.0) * (b1 + 2 * b2 + 2 * b3 + b4)
                for a, b1, b2, b3, b4 in zip(y, k1, k2, k3, k4)
            )

        def outer(y, i):
            def inner(yy, j):
                return rk4(yy, (i * stride + j) * dt), None

            y, _ = jax.lax.scan(inner, y, jnp.arange(stride))
            return y, tuple(y[c] for c in save)

        _, saves = jax.lax.scan(outer, y0, jnp.arange(n_steps // stride))
        return tuple(
            jnp.concatenate([y0[c][None], s], axis=0)
            for c, s in zip(save, saves)
        )

    # member axis is the LAST axis in both accepted scale shapes
    return jax.vmap(
        solve_one, in_axes=-1, out_axes=tuple([-1] * len(save))
    )(scales)


def seip_solve_reference(
    y0, params, beta_scales, *, duration, dt=0.5, save_every=1.0,
    save=(0, 1, 2, 3),
):
    """RK4 ``lax.scan`` over a batch-leading ``vmap`` of members.

    ``beta_scales`` is ``(B,)`` (one scale for every strain) or ``(L, B)``
    (one per strain). Returns member-last saves ``(T, *compartment, B)``
    for the compartments in ``save`` (ascending indices into (S, E, I, C));
    unsaved compartments are never stacked.
    """
    fdt = jnp.result_type(float)  # f64 under x64 (CPU tests), else f32
    return _rk4_ensemble(
        tuple(jnp.asarray(c, fdt) for c in y0), params,
        jnp.asarray(beta_scales, fdt),
        n_steps=int(round(duration / dt)),
        stride=int(round(save_every / dt)), dt=float(dt),
        save=_check_save(save),
    )


def seip_ensemble_solve(
    y0,
    params,
    beta_scales,
    *,
    duration: float,
    dt: float = 0.5,
    save_every: float = 1.0,
    save: Tuple[int, ...] = (0, 1, 2, 3),
    save_dtype=jnp.float32,
):
    """Solve a B-wide SEIP ensemble at constant step (classic RK4).

    ``beta_scales``: per-member transmission scaling -- ``(B,)`` applies
    one scale to every strain; ``(L, B)`` scales each strain independently
    (the shape of the production fit's posterior draws, which
    posterior-predictive forecasting feeds straight in,
    examples/seip_forecast.py). Returns member-last saves for the
    compartments in ``save`` (ascending indices into (S, E, I, C)), each
    shaped ``(T, *compartment_shape, B)``. Restricting ``save`` matters at
    width: full-4 daily saves are 640 floats x 201 saves per member.
    ``save_dtype=jnp.bfloat16`` rounds the returned saves (the solve stays
    f32).
    """
    outs = seip_solve_reference(
        y0, params, beta_scales, duration=duration, dt=dt,
        save_every=save_every, save=_check_save(save),
    )
    return tuple(o.astype(save_dtype) for o in outs)


def seip_solve_adaptive_reference(
    y0, params, beta_scales, *, duration, save_every=1.0, rtol=1e-4,
    atol=1e-3, dt0=None, steps_per_save=8, save=(0, 1, 2, 3),
):
    """Lockstep BS3(2) over the member-last ensemble (one dt chain).

    dt is shared by the WHOLE ensemble: the controller norm is the max
    over members of each member's scaled RMS error, so every member meets
    the tolerance and dt follows the currently stiffest one. dt is clamped
    to land EXACTLY on each save point (an accepted clamped step keeps the
    natural dt, a rejected one shrinks from the clamped size -- the grid
    engine's semantics, ode/integrate.py). More than ``steps_per_save``
    attempts in one save interval (the first interval gets max(4x, 32) for
    the dt0 ramp) emits NaN saves until the chain catches up, counted in
    ``exhausted_intervals`` -- the SolverParams.step_budget contract.
    Returns ``(outs, stats)`` with ``(1,)``-shaped stats arrays.
    """
    fdt = jnp.result_type(float)
    outs, bad, na, nr = _bs3_lockstep(
        tuple(jnp.asarray(c, fdt) for c in y0), params,
        jnp.asarray(beta_scales, fdt),
        n_saves=int(round(duration / save_every)) + 1,
        save_every=float(save_every), rtol=float(rtol), atol=float(atol),
        dt0=float(save_every / 8.0 if dt0 is None else dt0),
        steps_per_save=int(steps_per_save), save=_check_save(save),
    )
    stats = {
        "exhausted_intervals": bad,
        "n_accepted": na,
        "n_rejected": nr,
    }
    return outs, stats


@functools.partial(
    jax.jit,
    static_argnames=("n_saves", "save_every", "rtol", "atol", "dt0",
                     "steps_per_save", "save"),
)
def _bs3_lockstep(y0, params, scales, *, n_saves, save_every, rtol, atol,
                  dt0, steps_per_save, save):
    from ..models.seip import (
        seip_ensemble_params,
        seip_ensemble_state,
        seip_ode_ensemble,
    )

    B = scales.shape[-1]
    fdt = scales.dtype
    p = seip_ensemble_params(params, scales)
    y0e = seip_ensemble_state(y0, B)
    k = steps_per_save
    k_first = max(4 * k, 32)
    eps = 1e-6 * max(save_every, 1.0)
    n_elems = sum(int(np.prod(c.shape[:-1])) for c in y0e)
    n_ax = len(y0e[0].shape) - 1

    def rhs(t, y):
        return seip_ode_ensemble(t, y, p)

    def attempt(s_end, carry):
        t, dt_next, y, na, nr = carry
        remaining = s_end - t
        dt = jnp.minimum(dt_next, remaining)
        landing = dt >= remaining - eps
        k1 = rhs(t, y)
        y2 = tuple(a + (0.5 * dt) * b for a, b in zip(y, k1))
        k2 = rhs(t + 0.5 * dt, y2)
        y3 = tuple(a + (0.75 * dt) * b for a, b in zip(y, k2))
        k3 = rhs(t + 0.75 * dt, y3)
        ynew = tuple(
            a + dt * ((2.0 / 9.0) * b1 + (1.0 / 3.0) * b2 + (4.0 / 9.0) * b3)
            for a, b1, b2, b3 in zip(y, k1, k2, k3)
        )
        k4 = rhs(t + dt, ynew)
        sq = jnp.zeros((B,), fdt)
        for a, b1, b2, b3, b4, yn in zip(y, k1, k2, k3, k4, ynew):
            e = dt * (
                (5.0 / 72.0) * b1
                - (1.0 / 12.0) * b2
                - (1.0 / 9.0) * b3
                + (1.0 / 8.0) * b4
            )
            sc = atol + rtol * jnp.maximum(jnp.abs(a), jnp.abs(yn))
            r = e / sc
            sq = sq + jnp.sum(r * r, axis=tuple(range(n_ax)))
        norm = jnp.max(jnp.sqrt(sq / n_elems))
        ok = jnp.isfinite(norm)
        safe = jnp.maximum(norm, jnp.asarray(1e-30, fdt))
        factor = jnp.clip(0.9 * safe ** (-1.0 / _BS3_ERR_ORDER), 0.2, 10.0)
        factor = jnp.where(ok, factor, jnp.asarray(0.2, fdt))
        acc = ok & (norm <= 1.0)
        dt_new = jnp.where(landing & acc, dt_next, dt * factor)
        y = tuple(jnp.where(acc, a, b) for a, b in zip(ynew, y))
        t = jnp.where(acc, jnp.where(landing, s_end, t + dt), t)
        return (t, dt_new, y, na + acc.astype(jnp.int32),
                nr + (~acc).astype(jnp.int32))

    def interval(carry, s_end, kk):
        # stop at the save point: a further attempt would change nothing
        def cond(state):
            n, c = state
            return (n < kk) & (s_end - c[0] > eps)

        def body(state):
            n, c = state
            return n + 1, attempt(s_end, c)

        _, carry = jax.lax.while_loop(cond, body, (jnp.int32(0), carry))
        reached = carry[0] >= s_end - eps
        emit = tuple(
            jnp.where(reached, carry[2][c], jnp.full_like(carry[2][c], jnp.nan))
            for c in save
        )
        return carry, reached, emit

    zero = jnp.zeros((), jnp.int32)
    carry = (jnp.asarray(0.0, fdt), jnp.asarray(dt0, fdt), y0e, zero, zero)
    carry, reached1, emit1 = interval(
        carry, jnp.asarray(save_every, fdt), k_first
    )

    def scan_body(state, s_end):
        carry, bad = state
        carry, reached, emit = interval(carry, s_end, k)
        return (carry, bad + (~reached).astype(jnp.int32)), emit

    s_ends = jnp.arange(2, n_saves, dtype=fdt) * save_every
    (carry, bad), emits = jax.lax.scan(
        scan_body, (carry, (~reached1).astype(jnp.int32)), s_ends
    )
    outs = tuple(
        jnp.concatenate([y0e[c][None], e1[None], es], axis=0)
        for c, e1, es in zip(save, emit1, emits)
    )
    return outs, bad[None], carry[3][None], carry[4][None]


def seip_ensemble_solve_adaptive(
    y0,
    params,
    beta_scales,
    *,
    duration: float,
    save_every: float = 1.0,
    rtol: float = 1e-4,
    atol: float = 1e-3,
    dt0: float = None,
    steps_per_save: int = 8,
    save: Tuple[int, ...] = (0, 1, 2, 3),
    save_dtype=jnp.float32,
):
    """Adaptive (lockstep-dt) SEIP ensemble: BS3(2) with an I-controller.

    The reference's DEFAULT solve mode is adaptive
    (CDCgov/DynODE/src/dynode/config/params.py:36-47). See
    :func:`seip_solve_adaptive_reference` for the controller contract.
    ``atol`` defaults to 1e-3 -- the f32-scaled value for ~1e3-scale
    compartment populations (f64-calibrated defaults make the f32
    controller thrash).

    Returns ``(outs, stats)``: ``outs`` as in :func:`seip_ensemble_solve`;
    ``stats`` has ``(1,)`` int32 arrays ``exhausted_intervals`` (save
    intervals whose attempt budget ran out -- their saves are NaN; nonzero
    means raise ``steps_per_save``), ``n_accepted``, ``n_rejected``.
    """
    save = _check_save(save)
    n_saves = int(round(duration / save_every)) + 1
    if abs((n_saves - 1) * save_every - duration) > 1e-6 * max(duration, 1.0):
        raise ValueError("duration must be a multiple of save_every")
    outs, stats = seip_solve_adaptive_reference(
        y0, params, beta_scales, duration=duration, save_every=save_every,
        rtol=rtol, atol=atol, dt0=dt0, steps_per_save=steps_per_save,
        save=save,
    )
    return tuple(o.astype(save_dtype) for o in outs), stats
