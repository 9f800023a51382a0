"""``simulate()``: the single forward-integration entry point.

Semantics match the reference wrapper (src/dynode/simulation/odes.py:35-198):
runtime array/type checks, constant-vs-adaptive controller selection from
``SolverParams``, ``jump_ts`` discontinuity clipping, a daily (or
``save_step``-strided) save grid including t=0 and t=tf, and
``sub_save_indices`` masking that replaces unsaved compartments with empty
``(T, 0)`` arrays. The backend is ``dynode_tpu.ode.diffeqsolve`` -- one
bounded, checkpointed, differentiable XLA program per solve.
"""

from functools import lru_cache
from inspect import getfullargspec
from typing import Optional, Tuple, get_type_hints

import jax
import jax.numpy as jnp
from jax import Array  # noqa: F401 (re-exported type checks)

from ..config import SolverParams
from ..ode import (
    ClipStepSizeController,
    ConstantStepSize,
    PIDController,
    SaveAt,
    Solution,
    SubSaveAt,
    diffeqsolve,
)
from ..struct import pytree_dataclass
from ..typing import CompartmentState, ODE_Eqns


@pytree_dataclass
class AbstractODEParams:
    """Base pytree of vectorized RHS parameters.

    Models subclass this (via ``@pytree_dataclass``) to hold strain-flattened
    tensors, contact matrices, etc.; static index namespaces go in
    ``static_fieldnames`` (reference: src/dynode/simulation/odes.py:25-32,
    examples/seirs_multi_strain_age_stratified.py:177-184).
    """


def simulate(
    ode: ODE_Eqns,
    duration_days: int,
    initial_state: CompartmentState,
    ode_parameters: AbstractODEParams,
    solver_parameters: SolverParams,
    sub_save_indices: Optional[Tuple[int, ...]] = None,
    save_step: int = 1,
) -> Solution:
    """Solve ``ode`` for ``duration_days`` and return daily saved states.

    Parameters
    ----------
    ode : callable(t, state, params) -> gradients
        The RHS; traced once and compiled into the solve program.
    duration_days : int | float
        Final integration time (t0 is always 0).
    initial_state : CompartmentState
        Tuple of jax arrays, one per compartment.
    ode_parameters : AbstractODEParams
        Vectorized parameter pytree; its concrete type must match the RHS's
        third-argument type hint (guards against model/params mismatches).
    solver_parameters : SolverParams
        Solver, tolerances, step policy, discontinuities.
    sub_save_indices : tuple[int, ...], optional
        Indices of compartments to materialize; others come back as
        ``(T, 0)`` empty arrays.
    save_step : int
        Save every ``save_step`` days (1 = daily).

    Returns
    -------
    Solution
        ``sol.ys``: tuple of ``(duration//save_step + 1, *shape)`` arrays
        including t=0 and t=duration; ``sol.ts``: the save times.
    """
    if any(not isinstance(c, Array) for c in initial_state):
        raise TypeError(
            "Please pass jax.numpy.array instead of np.array to ODEs"
        )
    # guard: the params object must be the type the RHS was written for
    hints = get_type_hints(ode)
    params_arg = getfullargspec(ode).args[2]
    expected = hints.get(params_arg)
    if expected is not None:
        assert type(ode_parameters) is expected, (
            f"passed {type(ode_parameters)} ode parameters, but your ODE "
            f"model expects {expected}"
        )
    assert isinstance(duration_days, (int, float)), (
        "tf must be of type int or float"
    )

    t0 = 0.0
    if solver_parameters.constant_step_size > 0.0:
        controller = ConstantStepSize()
        dt0 = solver_parameters.constant_step_size
    else:
        jumps = (
            jnp.array(solver_parameters.discontinuity_points)
            if len(solver_parameters.discontinuity_points) > 0
            else None
        )
        controller = ClipStepSizeController(
            PIDController(
                rtol=solver_parameters.ode_solver_rel_tolerance,
                atol=solver_parameters.ode_solver_abs_tolerance,
            ),
            jump_ts=jumps,
        )
        dt0 = None

    return diffeqsolve(
        ode,
        solver_parameters.solver_method,
        t0,
        duration_days,
        dt0,
        tuple(initial_state),
        args=ode_parameters,
        stepsize_controller=controller,
        saveat=build_saveat(t0, duration_days, save_step, sub_save_indices),
        max_steps=int(solver_parameters.max_steps),
        step_budget=solver_parameters.step_budget,
        steps_per_save=solver_parameters.steps_per_save,
        compensated_summation=solver_parameters.compensated_summation,
    )


def build_saveat(
    start: float,
    stop: int,
    step: int = 1,
    sub_save_indices: Optional[Tuple[int, ...]] = None,
) -> SaveAt:
    """Daily (or strided) save grid, optionally masking compartments.

    ``save_times = linspace(start, stop, stop//step + 1)`` exactly as the
    reference builds it (src/dynode/simulation/odes.py:148-198); when
    ``sub_save_indices`` is given, unsaved compartments are replaced with
    empty arrays so ``sol.ys`` keeps its tuple arity.
    """
    if step <= 0:
        step = 1
    save_times = jnp.linspace(start, stop, int(stop // step) + 1)
    if sub_save_indices is None:
        return SaveAt(ts=save_times)
    mask = _sub_save_mask(tuple(int(i) for i in sub_save_indices))
    return SaveAt(subs=SubSaveAt(ts=save_times, fn=mask))


@lru_cache(maxsize=None)
def _sub_save_mask(sub_save_indices: Tuple[int, ...]):
    """Cached mask fn so repeated solves share the integrator's jit cache."""

    def mask(t, y, args):
        return tuple(
            y[i] if i in sub_save_indices else jnp.zeros((0,), dtype=y[i].dtype)
            for i in range(len(y))
        )

    return mask


def ensemble_state(
    initial_state: CompartmentState, batch: int
) -> CompartmentState:
    """Broadcast one initial state to lane-major layout: each compartment
    gains a TRAILING ensemble axis, ``(*dims, batch)``."""
    return tuple(
        jnp.broadcast_to(a[..., None], a.shape + (batch,))
        for a in initial_state
    )


def ensemble_rhs(ode: ODE_Eqns, param_axes=0) -> ODE_Eqns:
    """Mechanically rewrite a scalar RHS to the lane-major (batch-last)
    ensemble layout.

    Putting the ensemble axis LAST makes it the innermost, contiguous
    dimension of every state array. Which layout is faster depends on the
    model: on the small multistrain model XLA flattens the
    batch-leading layout's elementwise ops across the whole batch anyway
    -- measure both layouts for your model (bench.py reports all paths).
    This wrapper gives any user-authored RHS the batch-last layout
    without hand-porting:

    ``ensemble_rhs(ode)(t, state_b, params_b)`` where every ``state_b``
    compartment carries a trailing ensemble axis (:func:`ensemble_state`)
    and every traced leaf of ``params_b`` carries the axis given by
    ``param_axes`` (default: leading, matching
    :func:`simulate_ensemble`'s convention; use a pytree of axes for mixed
    shared/per-member parameters, ``None`` = shared).

    Under one :func:`simulate` call the whole ensemble shares a single
    adaptive step-size chain (the error norm spans the batch, so dt tracks
    the stiffest member -- every member is solved at full accuracy, some at
    smaller steps than they need). With ``constant_step_size`` the result
    is member-for-member identical to the batch-leading layout.
    """
    if param_axes == 0:
        # stable identity for the common case so repeated
        # simulate(ensemble_rhs(ode), ...) calls hit the engine's jit cache
        return _ensemble_rhs_cached(ode)
    return _build_ensemble_rhs(ode, param_axes)


@lru_cache(maxsize=128)
def _ensemble_rhs_cached(ode):
    return _build_ensemble_rhs(ode, 0)


def _build_ensemble_rhs(ode, param_axes):
    batched = jax.vmap(ode, in_axes=(None, -1, param_axes), out_axes=-1)

    def rhs(t, state, params):
        return batched(t, state, params)

    # preserve the params type hint so simulate()'s runtime signature check
    # keeps validating user mistakes through the wrapper
    try:
        hints = get_type_hints(ode)
        spec = getfullargspec(ode)
        if len(spec.args) >= 3 and spec.args[2] in hints:
            rhs.__annotations__["params"] = hints[spec.args[2]]
    except Exception:
        pass
    return rhs


def simulate_ensemble(
    ode: ODE_Eqns,
    duration_days: int,
    initial_state: CompartmentState,
    ode_parameters_batch: AbstractODEParams,
    solver_parameters: SolverParams,
    sub_save_indices: Optional[Tuple[int, ...]] = None,
    save_step: int = 1,
    mesh=None,
    axis_name: str = "ensemble",
    layout: str = "batch_leading",
    donate: bool = False,
) -> Solution:
    """Vectorize :func:`simulate` over a batch of parameter pytrees.

    ``ode_parameters_batch`` carries a leading batch axis on every traced
    leaf (static fields stay unbatched). The whole ensemble compiles into
    one XLA program; pass ``mesh=`` to shard the batch axis across devices
    (GSPMD data parallelism -- no collectives needed).

    ``donate=True`` donates the parameter batch's buffers to the solve
    (on backends that honor donation) -- free HBM headroom when the batch
    is regenerated per call (e.g. fresh prior draws each scenario round).
    Do not reuse ``ode_parameters_batch`` after a donated call.

    ``layout`` selects the on-device data layout:

    - ``"batch_leading"`` (default): ``vmap(simulate)`` with the ensemble
      axis in front; every member gets its own adaptive dt chain.
      ``ys``/``stats``/``result`` gain a LEADING batch axis.
    - ``"lane_major"``: the ensemble axis is placed LAST, innermost and
      contiguous (see :func:`ensemble_rhs` for when this wins;
      measure both). One shared dt chain; ``ys`` gain a TRAILING batch
      axis and ``result``/``stats`` are ensemble-wide scalars.
    """
    if any(not isinstance(c, Array) for c in initial_state):
        raise TypeError(
            "Please pass jax.numpy.array instead of np.array to ODEs"
        )
    if layout not in ("batch_leading", "lane_major"):
        raise ValueError(f"unknown ensemble layout: {layout!r}")

    if mesh is not None:
        from ..parallel import shard_batch

        sharding = shard_batch(mesh, axis_name)
        ode_parameters_batch = jax.tree_util.tree_map(
            lambda leaf: jax.device_put(leaf, sharding), ode_parameters_batch
        )

    if layout == "lane_major":
        batch = jax.tree_util.tree_leaves(ode_parameters_batch)[0].shape[0]
        y0b = ensemble_state(initial_state, batch)
        solve_lane = lambda params: simulate(  # noqa: E731
            ensemble_rhs(ode),
            duration_days,
            y0b,
            params,
            solver_parameters,
            sub_save_indices=sub_save_indices,
            save_step=save_step,
        )
        if donate:
            from ..parallel import jit_donated

            return jit_donated(solve_lane)(ode_parameters_batch)
        return solve_lane(ode_parameters_batch)

    def solve_one(params):
        return simulate(
            ode,
            duration_days,
            initial_state,
            params,
            solver_parameters,
            sub_save_indices=sub_save_indices,
            save_step=save_step,
        )

    if donate:
        from ..parallel import jit_donated

        return jit_donated(jax.vmap(solve_one))(ode_parameters_batch)
    return jax.jit(jax.vmap(solve_one))(ode_parameters_batch)


def tune_step_budget(
    ode: ODE_Eqns,
    duration_days: int,
    initial_state: CompartmentState,
    ode_parameters: AbstractODEParams,
    solver_parameters: SolverParams,
    *,
    headroom: float = 1.5,
    probe_budget: int = 4096,
) -> SolverParams:
    """Pilot-solve to measure the real step count, then shrink ``step_budget``.

    An adaptive solve compiles to a fixed-length scan; iterations past
    completion are masked no-ops, so a tight budget is the main throughput
    lever for big vmapped ensembles. Returns a copy of ``solver_parameters``
    with ``step_budget`` set to ``headroom x`` the measured (accepted +
    rejected) step count, rounded up to a multiple of 64.
    """
    probe = solver_parameters.model_copy(update={"step_budget": probe_budget})
    sol = simulate(ode, duration_days, initial_state, ode_parameters, probe)
    steps = int(jax.device_get(jnp.max(sol.stats["num_steps"])))
    budget = max(64, int(-(-int(steps * headroom) // 64) * 64))
    return solver_parameters.model_copy(update={"step_budget": budget})


__all__ = [
    "AbstractODEParams",
    "simulate",
    "simulate_ensemble",
    "ensemble_rhs",
    "ensemble_state",
    "build_saveat",
    "tune_step_budget",
]
