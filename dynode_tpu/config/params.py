"""Parameter containers: SolverParams, TransmissionParams, Params.

(reference: src/dynode/config/params.py:24-164). ``SolverParams`` points at
the in-repo ODE engine instead of diffrax; ``step_budget`` is the one
addition over the reference: it bounds the *compiled* scan length of an adaptive
solve (see dynode_tpu/ode/integrate.py) independently of the ``max_steps``
error cap the reference exposes.
"""

from typing import List, Optional, Union

from jax.typing import ArrayLike
from pydantic import (
    BaseModel,
    ConfigDict,
    Field,
    NonNegativeFloat,
    PositiveFloat,
    PositiveInt,
    field_validator,
    model_validator,
)

from ..dist import Distribution
from ..ode import AbstractSolver, Tsit5
from .links import DeterministicParameter
from .strains import Strain


class SolverParams(BaseModel):
    """How the ODE engine integrates: solver, tolerances, step policy."""

    model_config = ConfigDict(arbitrary_types_allowed=True)

    solver_method: AbstractSolver = Field(
        default_factory=Tsit5,
        description="Explicit RK solver; Tsit5 is a good non-stiff default "
        "(same default as the reference, src/dynode/config/params.py:28-35).",
    )
    ode_solver_rel_tolerance: PositiveFloat = Field(
        default=1e-5,
        description="Relative tolerance for the adaptive step controller.",
    )
    ode_solver_abs_tolerance: PositiveFloat = Field(
        default=1e-6,
        description="Absolute tolerance for the adaptive step controller.",
    )
    max_steps: PositiveInt = Field(
        default=int(1e6),
        description="Hard cap on solver steps before the solve is flagged "
        "as failed (result=RESULT_MAX_STEPS; unreached saves are NaN).",
    )
    constant_step_size: NonNegativeFloat = Field(
        default=0,
        description="If non-zero, integrate with this fixed dt instead of "
        "adaptive stepping.",
    )
    discontinuity_points: List[float] = Field(
        default_factory=list,
        description="Sim-days where the RHS gradient jumps; adaptive steps "
        "are clipped to land exactly on these points.",
    )
    step_budget: Optional[PositiveInt] = Field(
        default=None,
        description="Not in the reference: compiled scan length for adaptive solves "
        "(defaults to min(max_steps, 4096)). The solve is ONE bounded XLA "
        "program; iterations after completion are masked no-ops, so pick a "
        "budget ~1.5x the expected accepted+rejected step count for best "
        "throughput. See dynode_tpu.simulation.tune_step_budget.",
    )
    steps_per_save: Optional[PositiveInt] = Field(
        default=None,
        description="Not in the reference: per-save-interval step bound for the "
        "save-grid-bounded adaptive engine (uniform save grids only). "
        "Defaults to max(ceil(1.25 * step_budget / n_intervals) + 2, 6) -- "
        "headroom over the mean because adaptive step density is "
        "non-uniform in time; the first interval gets twice this bound "
        "(min 16) to ramp dt up from the conservative automatic initial "
        "step. Raise it when a solve needs many adaptive steps inside a "
        "single save interval (exhaustion NaN-fills that save and flags "
        "result, loudly). The global step_budget still caps total work.",
    )
    compensated_summation: bool = Field(
        default=False,
        description="Not in the reference: Kahan-compensated (double-word) state "
        "accumulation in the RK update. In f32 the accumulated roundoff of "
        "thousands of steps dominates tight tolerances; compensation "
        "removes the O(n_steps) term for ~1 extra add-chain per step, "
        "making reference-grade atol reachable on-chip without x64 (see "
        "docs/simulation.md tolerance envelope).",
    )


class TransmissionParams(BaseModel):
    """Strains + cross-immunity matrix + arbitrary model-specific extras.

    ``extra="allow"`` makes this an open parameter bag: models attach contact
    matrices, waning periods, seasonality blocks, etc.
    (reference: src/dynode/config/params.py:70-155, examples/seirs.py:59-65).
    """

    model_config = ConfigDict(arbitrary_types_allowed=True, extra="allow")

    strain_interactions: dict[
        str,
        dict[
            str,
            Union[NonNegativeFloat, ArrayLike, Distribution, DeterministicParameter],
        ],
    ]
    strains: List[Strain]

    @field_validator("strains", mode="before")
    @classmethod
    def _strains_nonempty(cls, strains):
        if not strains:
            raise ValueError("strains field must contain at least one Strain.")
        return strains

    @model_validator(mode="after")
    def _interactions_cover_all_strains(self):
        names = [s.strain_name for s in self.strains]
        assert set(names) == set(self.strain_interactions.keys()), (
            f"first dimension of strain_interactions must contain all strain "
            f"names as keys. Found {list(self.strain_interactions.keys())}"
            f"but expected {names}."
        )
        for outer, inner in self.strain_interactions.items():
            assert set(names) == set(inner.keys()), (
                f"strain_interactions[{outer}] interactions must contain "
                f"all strains as keys, including itself, "
                f"found {list(inner.keys())}, expected {names}."
            )
        return self

    @field_validator("strains", mode="after")
    @classmethod
    def _optional_fields_consistent(cls, strains):
        intro_ages = [s.introduction_ages for s in strains if s.is_introduced]
        assert all(x == intro_ages[0] for x in intro_ages), (
            "currently DynODE requires all strains have matching introduction_ages."
        )
        for field_name in ("exposed_to_infectious", "vaccine_efficacy"):
            present = [getattr(s, field_name) is not None for s in strains]
            if any(present) and not all(present):
                raise AssertionError(
                    f"if {field_name} is set within one strain it must be "
                    "set in all of them."
                )
        return strains


class Params(BaseModel):
    """Top-level parameter container: solver + transmission."""

    model_config = ConfigDict(arbitrary_types_allowed=True)
    solver_params: SolverParams
    transmission_params: TransmissionParams


__all__ = ["SolverParams", "TransmissionParams", "Params"]
