"""The bounded-scan integrator: one differentiable XLA program per solve.

Replaces ``diffrax.diffeqsolve`` (reference: src/dynode/simulation/odes.py:133-144)
with a design for compiled, vectorized solves:

- **Bounded two-level scan**: the adaptive while-loop becomes a
  ``lax.scan`` over ``n_chunks`` chunks of ``K`` steps each (``K ~
  sqrt(budget)``), with ``jax.checkpoint`` on the chunk body. Reverse-mode AD
  therefore works out of the box (NUTS differentiates through the solve,
  reference call stack SURVEY.md section 3.2) with O(sqrt(budget)) live
  state instead of O(budget).
- **Frozen-step-sequence gradients**: step-size-controller factors are
  ``stop_gradient``-ed, so gradients are those of the discrete solution with
  the accepted step sequence held fixed (standard discretize-then-optimize;
  the controller's parameter sensitivity is O(tol)).
- **Rejected/finished steps are zero-length segments**: the scan always runs
  ``budget`` iterations; once t reaches t1 a ``lax.cond`` skips the stage
  math (a real branch when unbatched, a select under vmap).
- **Dense output as a vectorized post-pass**: accepted segments live in a
  contiguous (budget, state) buffer; save times are located with one
  ``searchsorted``, then each is evaluated by taking ONE fresh solver step
  of size ``s - t_start`` from the stored segment start (a single vmapped
  batch over all save points). Re-stepping is accurate to the solver's own
  order, preserves linear invariants (mass conservation) exactly, and
  reproduces segment endpoints bitwise.
- **Kahan-compensated time accumulation** keeps the t grid accurate in
  float32 without requiring x64.
- **Internally jitted**: the core is a module-level jit with hashable static
  config (RHS identity, solver, controller, budget), so repeated solves --
  and solves nested inside NUTS/vmap/pjit -- hit the compile cache.
"""

import math
from functools import partial
from typing import Any, Optional

import jax
import jax.numpy as jnp

from .controllers import (
    AbstractStepSizeController,
    ConstantStepSize,
    PIDController,
    rms_error_norm,
)
from .saveat import SaveAt
from .solution import RESULT_MAX_STEPS, RESULT_SUCCESS, Solution
from .solvers import AbstractSolver, ODETerm

#: default cap on the compiled step budget when the caller passes a huge
#: ``max_steps`` (the reference defaults to 1e6 as an error cap, not a real
#: expected step count -- src/dynode/config/params.py:51-55).
DEFAULT_STEP_BUDGET = 4096


def _tree_select(pred, a, b):
    return jax.tree_util.tree_map(lambda x, y: jnp.where(pred, x, y), a, b)


def _kahan_update(y, comp, inc):
    """Compensated ``y += inc`` with carried per-leaf compensation ``comp``.

    Classic Kahan: fold the running compensation into the increment before
    adding, then recover the bits ``fl(y + inc_c)`` dropped. Keeps the state
    accumulation at double-word precision across thousands of f32 steps --
    the accumulated-roundoff term of the global error drops from
    O(n_steps * eps * |y|) to O(eps * |y|), leaving truncation + per-step
    RHS-argument noise (SolverParams.compensated_summation).
    """
    inc_c = jax.tree_util.tree_map(lambda i, c: i + c, inc, comp)
    y_new = jax.tree_util.tree_map(lambda a, b: a + b, y, inc_c)
    comp_new = jax.tree_util.tree_map(
        lambda a, an, b: (a - an) + b, y, y_new, inc_c
    )
    return y_new, comp_new


def _unwrap_pid(controller) -> Optional[PIDController]:
    inner = controller
    while hasattr(inner, "controller"):
        inner = inner.controller
    return inner if isinstance(inner, PIDController) else None


def _static_float(x):
    try:
        return float(x)
    except Exception:
        return None


def _uniform_grid_info(save_ts, t0, t1):
    """``n_intervals`` when ``save_ts`` is a concrete uniform grid spanning
    [t0, t1], else None. Traced grids (shape-dynamic callers) fall back to
    the buffered engine."""
    import numpy as _np

    if isinstance(save_ts, jax.core.Tracer):
        return None
    st0, st1 = _static_float(t0), _static_float(t1)
    if st0 is None or st1 is None:
        return None
    ts = _np.asarray(save_ts)
    if ts.ndim != 1 or ts.shape[0] < 2:
        return None
    n_int = ts.shape[0] - 1
    span = st1 - st0
    if span <= 0:
        return None
    expected = st0 + span * _np.arange(ts.shape[0]) / n_int
    tol = 1e-6 * max(abs(span), 1.0)
    if (
        abs(ts[0] - st0) > tol
        or abs(ts[-1] - st1) > tol
        or _np.max(_np.abs(ts - expected)) > tol
    ):
        return None
    return n_int


@partial(
    jax.jit,
    static_argnames=(
        "term",
        "solver",
        "controller",
        "subs_fn",
        "budget",
        "chunk",
        "compensated",
    ),
)
def _solve(
    term: ODETerm,
    solver: AbstractSolver,
    controller: AbstractStepSizeController,
    subs_fn,
    budget: int,
    chunk: int,
    compensated: bool,
    t0_arr,
    t1_arr,
    dt0,
    y0,
    args,
    save_ts,
) -> Solution:
    fdtype = t0_arr.dtype
    n_chunks = budget // chunk
    adaptive = controller.adaptive

    f0 = term.vf(t0_arr, y0, args)
    dt_init = jax.lax.stop_gradient(
        jnp.asarray(
            controller.init_dt(term, solver, t0_arr, t1_arr, y0, f0, args, dt0),
            dtype=fdtype,
        )
    )

    pid = _unwrap_pid(controller)
    jump_ts = getattr(controller, "jump_ts", None)
    if jump_ts is not None and len(jump_ts) > 0:
        jump_grid = jnp.asarray(
            tuple(jump_ts) + (float("inf"),), dtype=fdtype
        )
    else:
        jump_grid = None

    span = t1_arr - t0_arr
    t1_eps = jnp.asarray(1e-8, dtype=fdtype) * jnp.maximum(jnp.abs(span), 1.0)
    zero_i = jnp.zeros((), dtype=jnp.int32)

    def do_step(carry):
        t, t_comp, y, yc, f, dt_next, na, nr = carry
        dt_allowed = t1_arr - t
        if jump_grid is not None:
            nj = jump_grid[jnp.searchsorted(jump_grid[:-1], t, side="right")]
            # step to *just below* the jump so no RK stage evaluates on the
            # post-jump side of the discontinuity (diffrax's prevbefore trick)
            jump_edge = jnp.nextafter(nj, jnp.asarray(-jnp.inf, dtype=fdtype))
            dt_to_jump = jump_edge - t
            dt_allowed = jnp.minimum(dt_allowed, dt_to_jump)
        else:
            nj = None
        # freeze the step sequence for reverse-mode AD: gradients are those
        # of the discrete solution on the accepted grid (exact in constant
        # mode; O(tol) controller sensitivity is deliberately dropped)
        dt_used = jax.lax.stop_gradient(jnp.minimum(dt_next, dt_allowed))
        jumping = (dt_used >= dt_to_jump) if nj is not None else jnp.asarray(False)

        if compensated:
            inc, err, f1 = solver.step_inc(term, t, dt_used, y, args, f0=f)
            y1, yc1 = _kahan_update(y, yc, inc)
        else:
            y1, err, f1 = solver.step(term, t, dt_used, y, args, f0=f)
            yc1 = yc

        if adaptive and pid is not None:
            norm = rms_error_norm(err, y, y1, pid.rtol, pid.atol)
            accept, factor = controller.adapt(norm, dt_used, solver)
            factor = jax.lax.stop_gradient(factor)
            dt_new = dt_used * factor
            clamp = getattr(controller, "clamp_dt", None)
            if clamp is not None:
                dt_new = clamp(dt_new)
        else:
            accept = jnp.asarray(True)
            dt_new = dt_next

        # Kahan-compensated t += dt_used on acceptance
        inc = jnp.where(accept, dt_used, jnp.zeros_like(dt_used))
        yk = inc - t_comp
        t_new = t + yk
        t_comp_new = (t_new - t) - yk

        made_jump = jumping & accept
        t_end_prehop = t_new  # segment end as seen by the save grid
        if nj is not None:
            # hop the discontinuity: resume integration just after the jump
            t_new = jnp.where(
                made_jump, jnp.nextafter(nj, jnp.asarray(jnp.inf, dtype=fdtype)), t_new
            )
            t_comp_new = jnp.where(made_jump, jnp.zeros_like(t_comp_new), t_comp_new)

        y_next = _tree_select(accept, y1, y)
        yc_next = _tree_select(accept, yc1, yc)
        if solver.fsal:
            f_next = _tree_select(accept, f1, f)
            if nj is not None:
                # the FSAL stage was evaluated pre-jump; refresh it on the
                # post-jump side so the next step sees the new vector field
                f_fresh = term.vf(t_new, y_next, args)
                f_next = _tree_select(made_jump, f_fresh, f_next)
        else:
            f_next = f
        na = na + accept.astype(jnp.int32)
        nr = nr + (~accept).astype(jnp.int32)
        new_carry = (t_new, t_comp_new, y_next, yc_next, f_next, dt_new, na, nr)
        # emit (true segment start, pre-hop segment end, end state): resteps
        # for the save grid must start on the correct side of any jump
        return new_carry, (t, t_end_prehop, y_next)

    def skip_step(carry):
        t, _, y, *_ = carry
        return carry, (t, t, y)

    def body(carry, _):
        t = carry[0]
        done = t >= t1_arr - t1_eps
        return jax.lax.cond(done, skip_step, do_step, carry)

    def chunk_fn(carry, _):
        return jax.lax.scan(body, carry, None, length=chunk)

    yc0 = jax.tree_util.tree_map(jnp.zeros_like, y0) if compensated else ()
    carry0 = (
        t0_arr,
        jnp.zeros((), dtype=fdtype),
        y0,
        yc0,
        f0,
        dt_init,
        zero_i,
        zero_i,
    )
    if n_chunks > 1:
        carry_final, outs = jax.lax.scan(
            jax.checkpoint(chunk_fn), carry0, None, length=n_chunks
        )
        t_starts, t_ends, y_ends = outs
        t_starts = t_starts.reshape(budget)
        t_ends = t_ends.reshape(budget)
        y_ends = jax.tree_util.tree_map(
            lambda leaf: leaf.reshape((budget,) + leaf.shape[2:]), y_ends
        )
    else:
        carry_final, (t_starts, t_ends, y_ends) = chunk_fn(carry0, None)

    t_final = carry_final[0]
    na, nr = carry_final[6], carry_final[7]
    reached = t_final >= t1_arr - t1_eps
    result = jnp.where(reached, RESULT_SUCCESS, RESULT_MAX_STEPS).astype(
        jnp.int32
    )

    # ---- dense output: locate each save time's segment, then *re-step* ----
    # Each save time s in (ta, tb] is evaluated by taking ONE fresh RK step
    # of size (s - ta) from the stored segment start (ta, ya). This is a
    # single fully-batched vmapped solver step over all save points (no
    # sequential dependency), is accurate to the solver's own order (cubic
    # Hermite would cap dense output at 4th order), preserves linear
    # invariants (mass conservation) exactly, and reproduces segment
    # endpoints bitwise (same stage arithmetic as the accepted step).
    y_starts = jax.tree_util.tree_map(
        lambda ends, first: jnp.concatenate([first[None], ends[:-1]], axis=0),
        y_ends,
        y0,
    )

    seg = jnp.clip(jnp.searchsorted(t_ends, save_ts, side="left"), 0, budget - 1)
    ta = t_starts[seg]
    ya = jax.tree_util.tree_map(lambda leaf: leaf[seg], y_starts)

    def restep(t_a, y_a, s):
        dt_q = jnp.maximum(s - t_a, 0.0)
        y_q, _, _ = solver.step(term, t_a, dt_q, y_a, args, f0=None)
        return y_q

    ys = jax.vmap(restep)(ta, ya, save_ts)

    unreached = save_ts > t_final + t1_eps

    def mask_unreached(leaf):
        extra = (1,) * (leaf.ndim - 1)
        flag = unreached.reshape(unreached.shape[:1] + extra)
        return jnp.where(flag, jnp.full_like(leaf, jnp.nan), leaf)

    ys = jax.tree_util.tree_map(mask_unreached, ys)

    if subs_fn is not None:
        ys = jax.vmap(lambda t, y: subs_fn(t, y, args))(save_ts, ys)

    stats = {
        "num_accepted": na,
        "num_rejected": nr,
        "num_steps": na + nr,
        "step_budget": jnp.asarray(budget, dtype=jnp.int32),
    }
    return Solution(
        t0=t0_arr, t1=t1_arr, ts=save_ts, ys=ys, stats=stats, result=result
    )


@partial(
    jax.jit,
    static_argnames=(
        "term",
        "solver",
        "controller",
        "subs_fn",
        "k_per_interval",
        "n_saves",
        "budget",
        "compensated",
    ),
)
def _solve_adaptive_grid(
    term: ODETerm,
    solver: AbstractSolver,
    controller: AbstractStepSizeController,
    subs_fn,
    k_per_interval: int,
    n_saves: int,
    budget: int,
    compensated: bool,
    t0_arr,
    dt0,
    y0,
    args,
    save_ts,
) -> Solution:
    """Adaptive stepping bounded by the save grid: direct emission, no buffer.

    The round-2 two-phase design (:func:`_solve`) emits every step's full
    state into a ``(budget, state)`` segment buffer; at ensemble width that
    device-memory write traffic alone (~state x width bytes per step)
    flattens throughput as the ensemble widens.

    This path restructures one adaptive solve as an outer scan over save
    INTERVALS, each running ``k_per_interval`` bounded PID steps whose dt is
    clamped so the last step lands *exactly* on the save point. The save
    value is then the solver's own accepted state -- no dense-output
    machinery at all: no segment buffer, no searchsorted, no batched
    gather, no re-stepping. The only HBM output traffic is the save grid
    the caller asked for, exactly like the constant-step direct path.

    Trade-offs vs :func:`_solve` (both kept; ``diffeqsolve`` routes):
    - dt is capped at the save spacing (irrelevant when saves are daily and
      natural steps are sub-day, the reference's default regime --
      src/dynode/simulation/odes.py:148-156 builds daily grids);
    - the step budget is per-interval (``k_per_interval``) rather than
      global; an interval that exhausts it leaves NaN saves from that save
      point until the member catches up, and poisons ``result`` (loud,
      same contract as the buffered path);
    - only uniform save grids spanning [t0, t1] qualify (checked by the
      caller).
    """
    fdtype = t0_arr.dtype
    f0 = term.vf(t0_arr, y0, args)
    dt_init = jax.lax.stop_gradient(
        jnp.asarray(
            controller.init_dt(
                term, solver, t0_arr, save_ts[-1], y0, f0, args, dt0
            ),
            dtype=fdtype,
        )
    )
    pid = _unwrap_pid(controller)
    jump_ts = getattr(controller, "jump_ts", None)
    if jump_ts is not None and len(jump_ts) > 0:
        jump_grid = jnp.asarray(tuple(jump_ts) + (float("inf"),), dtype=fdtype)
    else:
        jump_grid = None

    spacing = (save_ts[-1] - save_ts[0]) / (n_saves - 1)
    seg_eps = jnp.asarray(1e-6, dtype=fdtype) * jnp.maximum(
        jnp.abs(spacing), 1.0
    )
    zero_i = jnp.zeros((), dtype=jnp.int32)

    def do_step(carry, s_end):
        t, t_comp, y, yc, f, dt_next, na, nr = carry
        dt_to_end = s_end - t
        dt_allowed = dt_to_end
        if jump_grid is not None:
            nj = jump_grid[jnp.searchsorted(jump_grid[:-1], t, side="right")]
            jump_edge = jnp.nextafter(nj, jnp.asarray(-jnp.inf, dtype=fdtype))
            dt_to_jump = jump_edge - t
            dt_allowed = jnp.minimum(dt_allowed, dt_to_jump)
        else:
            nj = None
        dt_used = jax.lax.stop_gradient(jnp.minimum(dt_next, dt_allowed))
        landing = dt_used >= dt_to_end - seg_eps
        jumping = (
            (dt_used >= dt_to_jump) if nj is not None else jnp.asarray(False)
        )

        if compensated:
            inc, err, f1 = solver.step_inc(term, t, dt_used, y, args, f0=f)
            y1, yc1 = _kahan_update(y, yc, inc)
        else:
            y1, err, f1 = solver.step(term, t, dt_used, y, args, f0=f)
            yc1 = yc

        if pid is not None:
            norm = rms_error_norm(err, y, y1, pid.rtol, pid.atol)
            accept, factor = controller.adapt(norm, dt_used, solver)
            factor = jax.lax.stop_gradient(factor)
            # an ACCEPTED grid/jump-clamped step says nothing about the
            # controller's natural dt (it was artificially short), so keep
            # dt_next unchanged; a REJECTED one must still shrink from the
            # clamped size or the retry would clamp to the same dt forever
            keep_natural = (landing | jumping) & accept
            dt_new = jnp.where(keep_natural, dt_next, dt_used * factor)
            clamp = getattr(controller, "clamp_dt", None)
            if clamp is not None:
                dt_new = clamp(dt_new)
        else:
            accept = jnp.asarray(True)
            dt_new = dt_next

        inc = jnp.where(accept, dt_used, jnp.zeros_like(dt_used))
        yk = inc - t_comp
        t_new = t + yk
        t_comp_new = (t_new - t) - yk
        # snap exactly onto the save point / hop the jump on acceptance;
        # a jump COINCIDING with a save point takes the landing path (the
        # snapped t sits on the post-jump side) but must still refresh the
        # FSAL stage below -- its accepted step evaluated pre-jump
        landed = landing & accept
        made_jump = jumping & accept
        t_new = jnp.where(landed, s_end, t_new)
        if nj is not None:
            t_new = jnp.where(
                made_jump & ~landed,
                jnp.nextafter(nj, jnp.asarray(jnp.inf, dtype=fdtype)),
                t_new,
            )
        t_comp_new = jnp.where(
            landed | made_jump, jnp.zeros_like(t_comp_new), t_comp_new
        )

        y_next = _tree_select(accept, y1, y)
        yc_next = _tree_select(accept, yc1, yc)
        if solver.fsal:
            f_next = _tree_select(accept, f1, f)
            if nj is not None:
                f_fresh = term.vf(t_new, y_next, args)
                f_next = _tree_select(made_jump, f_fresh, f_next)
        else:
            f_next = f
        na = na + accept.astype(jnp.int32)
        nr = nr + (~accept).astype(jnp.int32)
        return (t_new, t_comp_new, y_next, yc_next, f_next, dt_new, na, nr)

    def make_interval(k_steps):
        def interval(carry, s_end):
            def body(c, _):
                # stop on interval completion OR global budget exhaustion
                # (the budget keeps the reference's loud max_steps contract
                # -- src/dynode/config/params.py:51-55 -- even though the
                # compiled scan shape is k_per_interval * n_intervals)
                done = (c[0] >= s_end - seg_eps) | (c[6] + c[7] >= budget)
                return jax.lax.cond(
                    done, lambda cc: cc, lambda cc: do_step(cc, s_end), c
                ), None

            carry, _ = jax.lax.scan(body, carry, None, length=k_steps)
            t = carry[0]
            reached = t >= s_end - seg_eps
            y = carry[2]
            emit = subs_fn(s_end, y, args) if subs_fn is not None else y
            emit = jax.tree_util.tree_map(
                lambda leaf: jnp.where(
                    reached, leaf, jnp.full_like(leaf, jnp.nan)
                ),
                emit,
            )
            return carry, (emit, reached)

        return interval

    yc0 = jax.tree_util.tree_map(jnp.zeros_like, y0) if compensated else ()
    carry0 = (
        t0_arr,
        jnp.zeros((), dtype=fdtype),
        y0,
        yc0,
        f0,
        dt_init,
        zero_i,
        zero_i,
    )
    # the FIRST interval ramps dt up from the conservative automatic
    # initial step (the controller grows at most factormax=10x per accepted
    # step), so it structurally needs more iterations than steady state --
    # run it outside the scan with its own larger bound
    k_first = max(2 * k_per_interval, 16)
    first_int = make_interval(k_first)
    if n_saves > 8:
        first_int = jax.checkpoint(first_int)
    carry1, (emit1, reached1) = first_int(carry0, save_ts[1])

    interval = make_interval(k_per_interval)
    interval_fn = jax.checkpoint(interval) if n_saves > 8 else interval
    carry_final, (ys_tail, reached_tail) = jax.lax.scan(
        interval_fn, carry1, save_ts[2:]
    )
    na, nr = carry_final[6], carry_final[7]
    result = jnp.where(
        reached1 & jnp.all(reached_tail), RESULT_SUCCESS, RESULT_MAX_STEPS
    ).astype(jnp.int32)

    first = subs_fn(t0_arr, y0, args) if subs_fn is not None else y0
    ys = jax.tree_util.tree_map(
        lambda head, e1, tail: jnp.concatenate(
            [head[None], e1[None], tail], axis=0
        ),
        first,
        emit1,
        ys_tail,
    )
    stats = {
        "num_accepted": na,
        "num_rejected": nr,
        "num_steps": na + nr,
        # the true compiled per-member step capacity: the first interval
        # runs outside the scan with its own larger bound k_first, the
        # remaining n_saves-2 intervals get k_per_interval each, and the
        # global budget still cuts off work inside every interval
        "step_budget": jnp.asarray(
            min(budget, k_first + k_per_interval * (n_saves - 2)),
            dtype=jnp.int32,
        ),
    }
    return Solution(
        t0=t0_arr,
        t1=save_ts[-1],
        ts=save_ts,
        ys=ys,
        stats=stats,
        result=result,
    )


@partial(
    jax.jit,
    static_argnames=(
        "term", "solver", "subs_fn", "stride", "n_saves", "compensated"
    ),
)
def _solve_constant_direct(
    term: ODETerm,
    solver: AbstractSolver,
    subs_fn,
    stride: int,
    n_saves: int,
    compensated: bool,
    t0_arr,
    dt,
    y0,
    args,
    save_ts,
) -> Solution:
    """Fixed-dt fast path: save directly every ``stride`` steps.

    No step buffer, no post-hoc interpolation -- the nested scan emits
    (already SubSaveAt-masked) states exactly on the save grid, so the only
    HBM output traffic is the data the caller asked for. This is the right
    execution shape for large-state ensembles (e.g. SEIP) where the generic
    buffered path's (budget x state) segment buffer dominates bandwidth.
    """
    fdtype = t0_arr.dtype
    f0 = term.vf(t0_arr, y0, args)

    def inner(carry, _):
        t, y, yc, f = carry
        if compensated:
            inc, _, f1 = solver.step_inc(term, t, dt, y, args, f0=f)
            y1, yc1 = _kahan_update(y, yc, inc)
        else:
            y1, _, f1 = solver.step(term, t, dt, y, args, f0=f)
            yc1 = yc
        f1 = f1 if solver.fsal else f
        return (t + dt, y1, yc1, f1), None

    def outer(carry, _):
        carry, _ = jax.lax.scan(inner, carry, None, length=stride)
        t, y, _, _ = carry
        emit = subs_fn(t, y, args) if subs_fn is not None else y
        return carry, emit

    outer_fn = jax.checkpoint(outer) if n_saves > 8 else outer
    yc0 = jax.tree_util.tree_map(jnp.zeros_like, y0) if compensated else ()
    carry0 = (t0_arr, y0, yc0, f0)
    _, ys_tail = jax.lax.scan(outer_fn, carry0, None, length=n_saves - 1)

    first = subs_fn(t0_arr, y0, args) if subs_fn is not None else y0
    ys = jax.tree_util.tree_map(
        lambda head, tail: jnp.concatenate([head[None], tail], axis=0),
        first,
        ys_tail,
    )
    n_steps = jnp.asarray(stride * (n_saves - 1), dtype=jnp.int32)
    stats = {
        "num_accepted": n_steps,
        "num_rejected": jnp.zeros((), jnp.int32),
        "num_steps": n_steps,
        "step_budget": n_steps,
    }
    return Solution(
        t0=t0_arr,
        t1=save_ts[-1],
        ts=save_ts,
        ys=ys,
        stats=stats,
        result=jnp.zeros((), jnp.int32),
    )


def diffeqsolve(
    term,
    solver: AbstractSolver,
    t0,
    t1,
    dt0,
    y0,
    args: Any = None,
    *,
    saveat: Optional[SaveAt] = None,
    stepsize_controller: Optional[AbstractStepSizeController] = None,
    max_steps: int = DEFAULT_STEP_BUDGET,
    step_budget: Optional[int] = None,
    checkpoint_every: Optional[int] = None,
    steps_per_save: Optional[int] = None,
    compensated_summation: bool = False,
) -> Solution:
    """Integrate ``term`` from t0 to t1 and return saved states on a grid.

    Parameters mirror the subset of diffrax's signature the reference uses;
    ``step_budget`` additionally bounds the *compiled* scan length (defaults
    to ``min(max_steps, 4096)``) -- exceeding it sets ``result`` to
    ``RESULT_MAX_STEPS`` and NaN-fills unreached save times.

    Adaptive solves whose save grid is uniform and spans [t0, t1] run on the
    save-grid-bounded engine (:func:`_solve_adaptive_grid`): adaptive PID
    steps landing exactly on each save point, direct emission, zero segment
    buffer -- the ensemble-throughput path. ``steps_per_save`` bounds the
    per-interval step count there (default: derived from the global
    budget); non-uniform grids fall back to the buffered two-phase engine.
    """
    if callable(term) and not isinstance(term, ODETerm):
        term = ODETerm(term)
    if stepsize_controller is None:
        stepsize_controller = ConstantStepSize()

    leaves = jax.tree_util.tree_leaves(y0)
    fdtype = jnp.result_type(*[leaf.dtype for leaf in leaves])
    if not jnp.issubdtype(fdtype, jnp.floating):
        fdtype = jnp.result_type(float)
    y0 = jax.tree_util.tree_map(lambda leaf: jnp.asarray(leaf, dtype=fdtype), y0)

    t0_arr = jnp.asarray(t0, dtype=fdtype)
    t1_arr = jnp.asarray(t1, dtype=fdtype)

    # ---- save grid ---------------------------------------------------------
    if saveat is None:
        save_ts = jnp.stack([t0_arr, t1_arr])
        subs_fn = None
    elif saveat.subs is not None:
        save_ts = jnp.asarray(saveat.subs.ts, dtype=fdtype)
        subs_fn = saveat.subs.fn
    else:
        save_ts = jnp.asarray(saveat.ts, dtype=fdtype)
        subs_fn = None

    # ---- step budget (static) ----------------------------------------------
    adaptive = stepsize_controller.adaptive
    if not adaptive:
        st0, st1, sdt = _static_float(t0), _static_float(t1), _static_float(dt0)
        if st0 is not None and st1 is not None and sdt is not None:
            budget = max(int(math.ceil((st1 - st0) / sdt - 1e-9)), 1)
            # fast path: when the fixed dt exactly tiles a uniform save grid,
            # save directly during the scan (no step buffer / interpolation)
            n_pts = int(save_ts.shape[0])
            if n_pts >= 2:
                spacing = (st1 - st0) / (n_pts - 1)
                stride_f = spacing / sdt
                stride = int(round(stride_f))
                if (
                    stride >= 1
                    and abs(stride_f - stride) < 1e-9
                    and abs(stride * (n_pts - 1) * sdt - (st1 - st0)) < 1e-9
                ):
                    return _solve_constant_direct(
                        term,
                        solver,
                        subs_fn,
                        stride,
                        n_pts,
                        bool(compensated_summation),
                        t0_arr,
                        jnp.asarray(sdt, dtype=fdtype),
                        y0,
                        args,
                        save_ts,
                    )
        else:
            budget = step_budget or min(int(max_steps), DEFAULT_STEP_BUDGET)
    else:
        budget = step_budget or min(int(max_steps), DEFAULT_STEP_BUDGET)
        # save-grid-bounded fast path: uniform grid spanning [t0, t1].
        # Grid landing caps dt at the save spacing, so the engine needs at
        # least one step per interval (plus the first-interval dt ramp); a
        # budget below that is only satisfiable by the buffered engine's
        # free multi-interval steps (e.g. coarse budgets on settling
        # systems), which also keeps tiny-budget exhaustion semantics.
        grid = _uniform_grid_info(save_ts, t0, t1)
        if grid is not None and grid >= 3 and budget >= grid + 17:
            n_pts = grid + 1
            if steps_per_save is not None:
                k = max(int(steps_per_save), 2)
            else:
                # generous default: adaptive step density is non-uniform in
                # time (epidemic peaks, seasonal pulses), so the per-interval
                # bound gets headroom over the mean; the GLOBAL budget still
                # caps total work, and un-taken iterations are a real branch
                # when the solve is not vmapped
                k = max(-(-(5 * budget) // (4 * grid)) + 2, 6)
            return _solve_adaptive_grid(
                term,
                solver,
                stepsize_controller,
                subs_fn,
                k,
                n_pts,
                budget,
                bool(compensated_summation),
                t0_arr,
                None if dt0 is None else jnp.asarray(dt0, dtype=fdtype),
                y0,
                args,
                save_ts,
            )

    if checkpoint_every is None:
        if budget <= 128:
            chunk = budget
        else:
            chunk = 1 << max(1, (int(math.isqrt(budget)) - 1).bit_length())
            chunk = min(chunk, budget)
    else:
        chunk = min(checkpoint_every, budget)
    n_chunks = -(-budget // chunk)
    budget = n_chunks * chunk

    dt0_arr = None if dt0 is None else jnp.asarray(dt0, dtype=fdtype)
    return _solve(
        term,
        solver,
        stepsize_controller,
        subs_fn,
        budget,
        chunk,
        bool(compensated_summation),
        t0_arr,
        t1_arr,
        dt0_arr,
        y0,
        args,
        save_ts,
    )


__all__ = ["diffeqsolve", "DEFAULT_STEP_BUDGET"]
