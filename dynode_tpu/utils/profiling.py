"""Profiling and solver-observability helpers.

The reference has no profiler story (SURVEY.md section 5); on an accelerator the
standard tooling is ``jax.profiler`` traces viewed in TensorBoard/Perfetto.
This module wraps it plus small solver-statistics helpers surfaced from the
ODE engine's ``Solution.stats``.
"""

import contextlib
import time
from typing import Dict

import jax
import numpy as np


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/dynode_tpu_trace"):
    """Capture a jax profiler trace around a block.

    View with ``tensorboard --logdir <log_dir>`` or upload the .pb to
    ui.perfetto.dev.
    """
    with jax.profiler.trace(log_dir):
        yield
    print(f"[dynode_tpu.profiling] trace written to {log_dir}")


@contextlib.contextmanager
def wall_timer(label: str = "block"):
    """Print wall time of a block (blocks on any jax arrays you pass out)."""
    t0 = time.perf_counter()
    yield
    print(f"[dynode_tpu.profiling] {label}: {time.perf_counter() - t0:.3f}s")


def solver_stats(solution) -> Dict[str, float]:
    """Summarize a Solution's step statistics (works on batched solves)."""
    stats = {}
    for key, val in solution.stats.items():
        arr = np.asarray(jax.device_get(val))
        stats[key] = float(arr.max()) if arr.ndim else float(arr)
    budget = stats.get("step_budget", 0)
    if budget:
        stats["budget_utilization"] = stats["num_steps"] / budget
    arr = np.asarray(jax.device_get(solution.result))
    stats["num_failed"] = float((arr != 0).sum())
    return stats


def assert_solved(solution):
    """Raise if any solve in a (possibly batched) Solution exhausted its budget."""
    failed = int(np.asarray(jax.device_get(solution.result) != 0).sum())
    if failed:
        raise RuntimeError(
            f"{failed} solve(s) exhausted the step budget; raise "
            "SolverParams.step_budget or loosen tolerances "
            f"(stats: {solver_stats(solution)})"
        )


__all__ = ["trace", "wall_timer", "solver_stats", "assert_solved"]
