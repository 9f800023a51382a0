"""Record compartment snapshots as deterministic trace sites.

Behavioral contract shared with the reference
(src/dynode/infer/checkpointing.py:12-47): final-timestep sites are named
``final_timestep_{compartment}``, dated sites ``{Y_m_d}_timestep_{compartment}``,
and dates outside the solved range are skipped without error. "Checkpointing"
here means observability -- named sites in the inference trace at chosen
dates -- not solver-state resume (sampler state lives in
``InferenceProcess._inference_state`` for warm restarts).

Implementation: the requested dates are resolved to save-grid
indices up front and all snapshots of one solve are taken as a single
``jnp.take`` gather along the time axis per compartment (one fused slice op
under jit, instead of a python-level ``ys[idx][day]`` load per date x
compartment), then fanned out to their named sites.
"""

import datetime
from typing import List, Sequence, Tuple

import jax.numpy as jnp

from ..config import SimulationConfig
from ..ode import Solution
from ..utils import date_to_sim_day
from . import handlers


def _snapshot_plan(
    config: SimulationConfig,
    n_saved: int,
    save_final_timesteps: bool,
    compartment_save_dates: Sequence[datetime.date],
) -> Tuple[List[str], List[int]]:
    """Resolve the request to parallel (site-prefix, save-grid-index) lists.

    Out-of-range dates are dropped here (the silent-skip contract); the
    final timestep is just one more gather row at index ``n_saved - 1``.
    """
    prefixes: List[str] = []
    rows: List[int] = []
    if save_final_timesteps:
        prefixes.append("final_timestep")
        rows.append(n_saved - 1)
    init_date = config.initializer.initialize_date
    for date in compartment_save_dates:
        day = date_to_sim_day(date, init_date)
        if 0 <= day < n_saved:
            prefixes.append(date.strftime("%Y_%m_%d") + "_timestep")
            rows.append(day)
    return prefixes, rows


def checkpoint_compartment_sizes(
    config: SimulationConfig,
    solution: Solution,
    save_final_timesteps: bool = True,
    compartment_save_dates: List[datetime.date] = [],
):
    """Record compartment sizes at key dates for later debugging."""
    assert solution.ys is not None, (
        "cannot checkpoint: the solve produced no saved states "
        "(solution.ys is None)"
    )
    n_saved = len(solution.ys[0])
    prefixes, rows = _snapshot_plan(
        config, n_saved, save_final_timesteps, compartment_save_dates
    )
    if not rows:
        return
    day_index = jnp.asarray(rows)
    for name, idx in vars(config.idx).items():
        snapshots = jnp.take(solution.ys[idx], day_index, axis=0)
        for site, snap in zip(prefixes, snapshots):
            handlers.deterministic(f"{site}_{name}", snap)


__all__ = ["checkpoint_compartment_sizes"]
