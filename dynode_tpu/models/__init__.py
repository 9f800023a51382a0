"""Prebuilt model families: configs, initializers, and fused RHS functions.

The reference keeps its models in examples/ and a private DynODE-Models repo
(reference: CHANGELOG.md:120-122); dynode_tpu additionally ships the common
compartmental families as library code so benchmarks, tests, and users share
one well-optimized implementation. All RHS functions are written as batched
tensor ops (einsum over age/strain axes) rather than per-strain Python loops
so they vectorize over ensembles and compile to a few fused kernels.
"""

from .seirs import (
    SEIRSParams,
    seirs_config,
    seirs_ode,
    seirs_seasonal_config,
    seirs_seasonal_ode,
)
from .seip import (
    SEIPParams,
    seip_config,
    seip_initial_state,
    seip_ode,
    seip_odeparams,
)
from .sir import SIRParams, sir_age_config, sir_config, sir_ode
from .multistrain import (
    MultiStrainParams,
    multistrain_config,
    multistrain_initial_state,
    multistrain_ode,
    multistrain_odeparams,
)

__all__ = [
    "SIRParams",
    "sir_config",
    "sir_age_config",
    "sir_ode",
    "SEIRSParams",
    "seirs_config",
    "seirs_ode",
    "seirs_seasonal_config",
    "seirs_seasonal_ode",
    "MultiStrainParams",
    "multistrain_config",
    "multistrain_initial_state",
    "multistrain_ode",
    "multistrain_odeparams",
    "SEIPParams",
    "seip_config",
    "seip_initial_state",
    "seip_ode",
    "seip_odeparams",
]
