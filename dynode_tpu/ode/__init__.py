"""ODE engine: explicit Runge-Kutta solvers in one XLA program.

In-repo replacement for the reference's diffrax dependency
(reference: src/dynode/simulation/odes.py:8-18). Design goals:

- **One XLA program per solve**: the adaptive time loop is a bounded,
  two-level ``lax.scan`` (chunks x steps) with ``jax.checkpoint`` on each
  chunk, so the whole solve jits, vmaps over parameter ensembles, shards
  over a device mesh, and reverse-differentiates (NUTS gradients flow
  through it) with O(sqrt(budget)) memory.
- **Decoupled stepping and saving**: accepted steps append to a contiguous
  (budget, state) buffer; dense output on the save grid is a *vectorized*
  post-pass (searchsorted + cubic Hermite), not per-step scatter. This keeps
  the hot loop free of gather/scatter and makes saving O(T) batched work.
- **diffrax-compatible semantics** for the pieces the reference uses:
  Tsit5/Dopri5/Bosh3/Euler solvers, PID (I-) step control with the same
  default gains, ``jump_ts`` discontinuity clipping, constant-step mode,
  ``SaveAt``/``SubSaveAt`` grids, and ``max_steps``.
"""

from .controllers import (
    AbstractStepSizeController,
    ClipStepSizeController,
    ConstantStepSize,
    PIDController,
)
from .implicit import AbstractImplicitSolver, ImplicitEuler, TRBDF2
from .integrate import diffeqsolve
from .saveat import SaveAt, SubSaveAt
from .solution import RESULT_MAX_STEPS, RESULT_SUCCESS, Solution
from .solvers import (
    AbstractSolver,
    Bosh3,
    Dopri5,
    Euler,
    Heun,
    ODETerm,
    Tsit5,
)

__all__ = [
    "diffeqsolve",
    "ODETerm",
    "AbstractSolver",
    "Euler",
    "Heun",
    "Bosh3",
    "Tsit5",
    "Dopri5",
    "AbstractImplicitSolver",
    "ImplicitEuler",
    "TRBDF2",
    "AbstractStepSizeController",
    "ConstantStepSize",
    "PIDController",
    "ClipStepSizeController",
    "SaveAt",
    "SubSaveAt",
    "Solution",
    "RESULT_SUCCESS",
    "RESULT_MAX_STEPS",
]
