"""JAX-native probability distributions (no numpyro dependency).

The reference delegates distributions to numpyro
(reference: src/dynode/config/strains.py:8, infer/sample.py:11). dynode_tpu
ships its own minimal, fully jittable distribution library: every
log-density/sampling path is a pure JAX function that fuses into the
surrounding XLA program. (The SVI driver separately uses optax for its
optimizers -- the inference layer's only extra dependency.)
"""

from . import constraints, transforms
from .constraints import Constraint
from .continuous import (
    Beta,
    Dirichlet,
    Cauchy,
    Exponential,
    Gamma,
    HalfCauchy,
    HalfNormal,
    LogNormal,
    MultivariateNormal,
    Normal,
    StudentT,
    TruncatedNormal,
    Uniform,
)
from .discrete import (
    BetaBinomial,
    ZeroInflatedDistribution,
    ZeroInflatedNegativeBinomial,
    ZeroInflatedPoisson,
    Bernoulli,
    Binomial,
    Categorical,
    Multinomial,
    NegativeBinomial,
    Poisson,
)
from .distribution import (
    Delta,
    Unit,
    Distribution,
    ExpandedDistribution,
    TransformedDistribution,
)
from .transforms import (
    AffineTransform,
    StickBreakingTransform,
    ComposeTransform,
    ExpTransform,
    IdentityTransform,
    SigmoidTransform,
    Transform,
    biject_to,
)

__all__ = [
    "constraints",
    "transforms",
    "Constraint",
    "Distribution",
    "TransformedDistribution",
    "Delta",
    "Unit",
    "Normal",
    "LogNormal",
    "HalfNormal",
    "Cauchy",
    "HalfCauchy",
    "StudentT",
    "Uniform",
    "Exponential",
    "Gamma",
    "Beta",
    "TruncatedNormal",
    "MultivariateNormal",
    "Poisson",
    "Bernoulli",
    "Categorical",
    "Multinomial",
    "Dirichlet",
    "ExpandedDistribution",
    "StickBreakingTransform",
    "Binomial",
    "NegativeBinomial",
    "BetaBinomial",
    "ZeroInflatedDistribution",
    "ZeroInflatedPoisson",
    "ZeroInflatedNegativeBinomial",
    "Transform",
    "IdentityTransform",
    "AffineTransform",
    "ExpTransform",
    "SigmoidTransform",
    "ComposeTransform",
    "biject_to",
]
