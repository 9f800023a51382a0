"""Simulation layer: the `simulate()` entry point over the in-repo ODE engine.

(reference: src/dynode/simulation/__init__.py:3-8)
"""

from .odes import (
    AbstractODEParams,
    build_saveat,
    ensemble_rhs,
    ensemble_state,
    simulate,
    simulate_ensemble,
    tune_step_budget,
)

__all__ = [
    "simulate",
    "simulate_ensemble",
    "ensemble_rhs",
    "ensemble_state",
    "build_saveat",
    "AbstractODEParams",
    "tune_step_budget",
]
