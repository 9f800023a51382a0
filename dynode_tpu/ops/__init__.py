"""Whole-solve ensemble integrators.

``generic_pallas`` integrates an ensemble of any small-state model written
in the rows idiom inside one Pallas program per block of members: the
state stays on chip for every RK stage of every step, and device memory
sees only the save grid. :func:`kernel_route` is the one place that picks
the compiled Triton kernel (GPU) or the ``lax`` reference (CPU).

``seip`` solves the production SEIP model's ensembles with XLA: at 640
floats per member its working set does not fit one GPU thread's registers.

``sharded`` spreads either over the member axis of a device mesh.
"""

from .generic_pallas import (
    ensemble_solve_kernel,
    ensemble_solve_kernel_adaptive,
    ensemble_solve_kernel_adaptive_reference,
    ensemble_solve_kernel_reference,
    kernel_route,
    launch_config,
    pack_rows,
    unpack_rows,
)
from .seip import seip_ensemble_solve, seip_ensemble_solve_adaptive
from .sharded import (
    ensemble_solve_kernel_adaptive_sharded,
    ensemble_solve_kernel_sharded,
    seip_ensemble_solve_adaptive_sharded,
    seip_ensemble_solve_sharded,
)

__all__ = [
    "ensemble_solve_kernel_sharded",
    "ensemble_solve_kernel_adaptive_sharded",
    "seip_ensemble_solve",
    "seip_ensemble_solve_adaptive",
    "seip_ensemble_solve_sharded",
    "seip_ensemble_solve_adaptive_sharded",
    "ensemble_solve_kernel",
    "ensemble_solve_kernel_adaptive",
    "ensemble_solve_kernel_adaptive_reference",
    "ensemble_solve_kernel_reference",
    "kernel_route",
    "launch_config",
    "pack_rows",
    "unpack_rows",
]
