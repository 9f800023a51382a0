"""dynode_tpu: a compartmental-ODE scenario engine in JAX.

A from-scratch rebuild of the capabilities of CDCgov/DynODE
(reference: CDCgov/DynODE/src/dynode/__init__.py:1-9) built for wide
ensembles and wide chain banks on an accelerator (an NVIDIA GPU):

- The ODE engine (``dynode_tpu.ode``) compiles an entire adaptive solve into a
  single XLA program via a bounded, checkpointed ``lax.scan`` so it is
  reverse-mode differentiable (NUTS gradients flow through the solver) and
  vmappable over thousands of parameter draws.
- The inference engine (``dynode_tpu.infer``) is a self-contained numpyro-like
  probabilistic layer: distributions, effect handlers, iterative NUTS with
  windowed warmup adaptation, SVI with autoguides, and Predictive replay --
  with chains run as a vectorized batch axis shardable over a device mesh.
- ``dynode_tpu.parallel`` owns device-mesh construction and sharding helpers
  (chain/ensemble axes) -- the counterpart of the reference's
  (nonexistent) distributed backend.
- ``dynode_tpu.ops`` holds the whole-solve ensemble integrators: a Pallas
  kernel (Triton route) that keeps every member's state on chip for the
  whole solve, and the XLA ensemble solves of the production SEIP model.

The public surface is a superset of the reference's top-level exports
(reference: src/dynode/__init__.py) so model code ports with an import swap
(or verbatim via the ``dynode`` alias package).
"""

from . import (
    config,
    dist,
    infer,
    ode,
    parallel,
    simulation,
    utils,
)
from .config import (
    AgeBin,
    Bin,
    Compartment,
    DeterministicParameter,
    Dimension,
    DiscretizedPositiveIntBin,
    FullStratifiedImmuneHistoryDimension,
    ImmuneHistoryDimension,
    Initializer,
    LastStrainImmuneHistoryDimension,
    Params,
    PlaceholderSample,
    SamplePlaceholderError,
    SimulationConfig,
    SolverParams,
    Strain,
    TransmissionParams,
    VaccinationDimension,
    WaneBin,
    WaneDimension,
    get_dynode_init_date_flag,
    set_dynode_init_date_flag,
    simulation_day,
)
from .infer import (
    InferenceProcess,
    MCMCProcess,
    SVIProcess,
    checkpoint_compartment_sizes,
    resolve_deterministic,
    sample_distributions,
    sample_then_resolve,
)
from .simulation import (
    AbstractODEParams,
    simulate,
    simulate_ensemble,
)
from .struct import pytree_dataclass
from .typing import (
    CompartmentGradients,
    CompartmentState,
    CompartmentTimeseries,
    DynodeName,
    ObservedData,
    ODE_Eqns,
    UnitIntervalFloat,
)
from .utils import (
    CustomLogFormatter,
    base_equation,
    conditional_knots,
    date_to_epi_week,
    date_to_sim_day,
    drop_keys_with_substring,
    enable_compilation_cache,
    evaluate_cubic_spline,
    flatten_list_parameters,
    identify_distribution_indexes,
    log_decorator,
    logger,
    sim_day_to_date,
    sim_day_to_epiweek,
    use_logging,
    vectorize_objects,
)

__version__ = "0.1.0"

_LAZY_VIS = (
    "plot_violin_plots",
    "plot_prior_distributions",
    "plot_mcmc_chains",
    "plot_checkpoint_inference_correlation_pairs",
    "plot_model_overview_subplot_matplotlib",
)


def __getattr__(name):
    # plot functions (and the `log` module alias the reference exports)
    # resolve lazily so headless jobs never import matplotlib
    if name in _LAZY_VIS:
        return getattr(utils, name)
    if name == "log":
        from .utils import log as _log_module

        return _log_module
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "config",
    "dist",
    "infer",
    "ode",
    "parallel",
    "simulation",
    "utils",
    "SimulationConfig",
    "Initializer",
    "Compartment",
    "Strain",
    "Dimension",
    "VaccinationDimension",
    "ImmuneHistoryDimension",
    "FullStratifiedImmuneHistoryDimension",
    "LastStrainImmuneHistoryDimension",
    "WaneDimension",
    "Bin",
    "WaneBin",
    "DiscretizedPositiveIntBin",
    "AgeBin",
    "Params",
    "SolverParams",
    "TransmissionParams",
    "simulation_day",
    "set_dynode_init_date_flag",
    "get_dynode_init_date_flag",
    "PlaceholderSample",
    "SamplePlaceholderError",
    "DeterministicParameter",
    "sample_then_resolve",
    "resolve_deterministic",
    "sample_distributions",
    "InferenceProcess",
    "MCMCProcess",
    "SVIProcess",
    "checkpoint_compartment_sizes",
    "simulate",
    "simulate_ensemble",
    "AbstractODEParams",
    "pytree_dataclass",
    "CompartmentState",
    "CompartmentGradients",
    "DynodeName",
    "CompartmentTimeseries",
    "UnitIntervalFloat",
    "ObservedData",
    "ODE_Eqns",
    "log",
    "use_logging",
    "log_decorator",
    "CustomLogFormatter",
    "logger",
    "sim_day_to_date",
    "sim_day_to_epiweek",
    "date_to_sim_day",
    "date_to_epi_week",
    "vectorize_objects",
    "flatten_list_parameters",
    "drop_keys_with_substring",
    "identify_distribution_indexes",
    "evaluate_cubic_spline",
    "base_equation",
    "conditional_knots",
    "plot_violin_plots",
    "plot_prior_distributions",
    "plot_mcmc_chains",
    "plot_checkpoint_inference_correlation_pairs",
    "plot_model_overview_subplot_matplotlib",
]
