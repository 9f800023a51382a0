"""Bayesian inference engine: handlers, NUTS, SVI, Predictive, diagnostics.

Public surface covers the reference's ``dynode.infer``
(reference: src/dynode/infer/__init__.py:3-19) plus the underlying engine
pieces the reference imported from numpyro (MCMC/NUTS/SVI/Predictive/
init strategies/autoguides), all implemented in-repo for wide vectorized banks.
"""

from . import diagnostics, handlers
from .checkpointing import checkpoint_compartment_sizes
from .diagnostics import (
    effective_sample_size,
    ess_bulk,
    ess_tail,
    hdi,
    mcse_mean,
    split_rhat,
    summary,
)
from .idata import InferenceData, from_dynode
from .model_comparison import (
    ELPDData,
    compare,
    loo,
    loo_pit,
    psislw,
    waic,
)
from .inference import InferenceProcess, MCMCProcess, SVIProcess
from .chees import ChEES
from .mcmc import MCMC, NUTS
from .forecast import member_quantiles, resample_draws
from .predictive import Predictive, log_likelihood
from .reparam import LocScaleReparam, TransformReparam
from .sample import (
    resolve_deterministic,
    sample_distributions,
    sample_then_resolve,
)
from .state_io import (
    load_mcmc_warm_start,
    load_pytree,
    save_mcmc,
    save_pytree,
)
from .svi import (
    SVI,
    Adam,
    AutoDelta,
    chees_warm_start_from_guide,
    AutoGuide,
    AutoMultivariateNormal,
    AutoNormal,
    ClippedAdam,
    SVIMultiStartResult,
    SVIRunResult,
    SVIState,
    Trace_ELBO,
)
from .util import (
    init_to_mean,
    init_to_median,
    init_to_sample,
    init_to_uniform,
    init_to_value,
    log_density,
)

# primitive aliases so model code reads like the reference's numpyro calls
sample = handlers.sample
deterministic = handlers.deterministic
param = handlers.param
plate = handlers.plate
factor = handlers.factor

__all__ = [
    "handlers",
    "diagnostics",
    "sample",
    "deterministic",
    "param",
    "plate",
    "factor",
    "LocScaleReparam",
    "TransformReparam",
    "sample_then_resolve",
    "resolve_deterministic",
    "sample_distributions",
    "InferenceProcess",
    "MCMCProcess",
    "SVIProcess",
    "checkpoint_compartment_sizes",
    "MCMC",
    "NUTS",
    "ChEES",
    "SVI",
    "SVIState",
    "SVIRunResult",
    "SVIMultiStartResult",
    "Trace_ELBO",
    "Adam",
    "ClippedAdam",
    "AutoGuide",
    "AutoNormal",
    "AutoMultivariateNormal",
    "AutoDelta",
    "chees_warm_start_from_guide",
    "Predictive",
    "member_quantiles",
    "resample_draws",
    "log_likelihood",
    "init_to_median",
    "init_to_mean",
    "init_to_sample",
    "init_to_uniform",
    "init_to_value",
    "log_density",
    "InferenceData",
    "from_dynode",
    "loo",
    "loo_pit",
    "waic",
    "compare",
    "psislw",
    "ELPDData",
    "save_pytree",
    "load_pytree",
    "save_mcmc",
    "load_mcmc_warm_start",
    "effective_sample_size",
    "ess_bulk",
    "ess_tail",
    "mcse_mean",
    "split_rhat",
    "hdi",
    "summary",
]
