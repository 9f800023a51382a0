"""Shared type vocabulary for dynode_tpu configs and models.

Mirrors the reference type layer (reference: src/dynode/typing/typing.py:11-39)
with the same aliases and name-validation semantics.
"""

from typing import Annotated, Any, Callable, Tuple, Union

import jax
from annotated_types import Ge, Le
from pydantic import BeforeValidator

#: One jax array per compartment; each array shaped by the compartment's dims.
CompartmentState = Tuple[jax.Array, ...]
#: Same tuple-of-arrays shape as CompartmentState, holding d/dt gradients.
CompartmentGradients = Tuple[jax.Array, ...]
#: CompartmentState with a leading time axis on every array.
CompartmentTimeseries = CompartmentState

#: A float statically constrained to [0, 1].
UnitIntervalFloat = Annotated[float, Ge(0.0), Le(1.0)]

#: RHS contract: f(t, state, params) -> gradients, traced under jit.
ODE_Eqns = Callable[
    [jax.typing.ArrayLike, CompartmentState, Any],
    CompartmentGradients,
]

ObservedData = Union[Tuple[jax.Array, ...], jax.Array]


def _verify_name(name: str) -> str:
    """Reject names with leading digits, spaces, or non-alnum/underscore chars."""
    if name[0].isnumeric():
        raise ValueError(f"invalid name {name!r}: leading digit")
    if " " in name:
        raise ValueError(f"invalid name {name!r}: contains spaces")
    if not all(ch.isalnum() or ch == "_" for ch in name):
        raise ValueError(
            f"invalid name {name!r}: only alphanumerics/underscores allowed"
        )
    return name


#: A string identifier usable as an attribute name (no spaces/leading digits).
DynodeName = Annotated[str, BeforeValidator(_verify_name)]

__all__ = [
    "CompartmentState",
    "CompartmentGradients",
    "CompartmentTimeseries",
    "UnitIntervalFloat",
    "ODE_Eqns",
    "ObservedData",
    "DynodeName",
]
