"""Distribution base class and TransformedDistribution.

API intentionally mirrors the numpyro surface the reference exercises
(reference: src/dynode/infer/sample.py:72-76 samples Distribution objects;
examples/sir_infer_parameters.py:47-58 builds TransformedDistribution priors)
so configs written against the reference port with an import swap.
"""

from typing import Tuple

import jax
import jax.numpy as jnp

from . import constraints as C
from .transforms import Transform


class Distribution:
    """Base class for all dynode_tpu distributions.

    Subclasses implement :meth:`sample` and :meth:`log_prob` as pure JAX
    functions of their (possibly batched) parameters, plus a ``support``
    constraint used for bijection to unconstrained space during inference.
    """

    support: C.Constraint = C.real

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        """Shape of independent parameter batches."""
        return getattr(self, "_batch_shape", ())

    @property
    def event_shape(self) -> Tuple[int, ...]:
        """Shape of a single atomic event."""
        return getattr(self, "_event_shape", ())

    def shape(self, sample_shape=()) -> Tuple[int, ...]:
        """``sample_shape + batch_shape + event_shape``."""
        return tuple(sample_shape) + self.batch_shape + self.event_shape

    def sample(self, key: jax.Array, sample_shape=()) -> jax.Array:
        """Draw samples with ``key``; shape ``sample_shape + shape()``."""
        raise NotImplementedError

    def log_prob(self, value) -> jax.Array:
        """Elementwise log-density of ``value``."""
        raise NotImplementedError

    @property
    def mean(self):
        """Mean of the distribution."""
        raise NotImplementedError

    @property
    def variance(self):
        """Variance of the distribution."""
        raise NotImplementedError

    def __call__(self, key, sample_shape=()):
        return self.sample(key, sample_shape)

    def expand(self, batch_shape):
        """Broadcast this distribution to a larger batch shape."""
        return ExpandedDistribution(self, tuple(batch_shape))

    def _broadcast_batch_shape(self, *params) -> Tuple[int, ...]:
        shape: Tuple[int, ...] = ()
        for p in params:
            shape = jnp.broadcast_shapes(shape, jnp.shape(p))
        return shape


class ExpandedDistribution(Distribution):
    """A base distribution broadcast over a larger batch shape."""

    def __init__(self, base_dist: Distribution, batch_shape):
        self.base_dist = base_dist
        self._batch_shape = tuple(batch_shape)
        self._event_shape = base_dist.event_shape
        self.support = base_dist.support

    def sample(self, key, sample_shape=()):
        # the base's own batch dims align with the tail of the expanded
        # shape; draw only the leading expansion and broadcast the rest
        """Draw samples with ``key``; shape ``sample_shape + shape()``."""
        lead = self._batch_shape[
            : len(self._batch_shape) - len(self.base_dist.batch_shape)
        ]
        draws = self.base_dist.sample(key, tuple(sample_shape) + lead)
        target = tuple(sample_shape) + self._batch_shape + self._event_shape
        return jnp.broadcast_to(draws, target)

    def log_prob(self, value):
        """Elementwise log-density of ``value``."""
        return self.base_dist.log_prob(value)

    @property
    def mean(self):
        """Mean of the distribution."""
        return jnp.broadcast_to(
            self.base_dist.mean, self._batch_shape + self._event_shape
        )


class TransformedDistribution(Distribution):
    """Distribution of ``transform(x)`` for ``x ~ base_distribution``.

    ``log_prob(y) = base.log_prob(f^-1(y)) - log|det df/dx|(f^-1(y))``.
    """

    def __init__(self, base_distribution: Distribution, transforms):
        self.base_dist = base_distribution
        if isinstance(transforms, Transform):
            transforms = [transforms]
        self.transforms = list(transforms)
        from .transforms import push_constraint

        support = base_distribution.support
        for t in self.transforms:
            support = push_constraint(support, t)
        self.support = support
        self._batch_shape = base_distribution.batch_shape
        self._event_shape = base_distribution.event_shape

    def sample(self, key, sample_shape=()):
        """Draw samples with ``key``; shape ``sample_shape + shape()``."""
        x = self.base_dist.sample(key, sample_shape)
        for t in self.transforms:
            x = t(x)
        return x

    def log_prob(self, value):
        """Elementwise log-density of ``value``."""
        value = jnp.asarray(value)
        # walk backwards to the base space, accumulating jacobian corrections
        y = value
        log_det = jnp.zeros_like(y, dtype=jnp.result_type(float))
        for t in reversed(self.transforms):
            x = t.inv(y)
            log_det = log_det + t.log_abs_det_jacobian(x, y)
            y = x
        return self.base_dist.log_prob(y) - log_det

    @property
    def mean(self):
        # only exact for affine-only transform chains; used by init heuristics.
        """Mean of the distribution."""
        x = self.base_dist.mean
        for t in self.transforms:
            x = t(x)
        return x


class Unit(Distribution):
    """Zero-size distribution carrying an arbitrary log-factor.

    The vehicle for ``handlers.factor`` (numpyro Unit semantics):
    ``sample`` returns an empty array and ``log_prob`` ignores the value
    and returns ``log_factor``, so arbitrary terms join the joint density
    through an ordinary observed sample site.
    """

    support = C.real

    def __init__(self, log_factor):
        self.log_factor = jnp.asarray(log_factor)
        self._batch_shape = jnp.shape(self.log_factor)
        self._event_shape = (0,)

    def sample(self, key, sample_shape=()):
        """Return the empty value (no randomness; shape ``(*batch, 0)``)."""
        return jnp.empty(
            tuple(sample_shape) + self.batch_shape + (0,),
            dtype=self.log_factor.dtype,
        )

    def log_prob(self, value):
        """The stored ``log_factor`` (ignores ``value``)."""
        return self.log_factor


class Delta(Distribution):
    """Point mass at ``value`` with an optional extra log-density term.

    Used by autoguides to emit transformed latent sites whose density is
    accounted against the underlying flat latent (the ``log_density`` carries
    the negative jacobian correction), mirroring numpyro's Delta mechanics.

    ``event_dim`` marks the trailing ``event_dim`` axes of ``value`` as event
    dimensions: ``log_prob`` broadcasts ``log_density`` over the *batch*
    shape only, so a scalar jacobian correction attached to a vector latent
    is counted exactly once when the trace sums site log-probs (not once per
    element).
    """

    def __init__(self, value, log_density=0.0, event_dim=0):
        self.value = value
        self._log_density = log_density
        self.event_dim = int(event_dim)
        shape = jnp.shape(value)
        if self.event_dim > len(shape):
            raise ValueError(
                f"event_dim {event_dim} exceeds value rank {len(shape)}"
            )
        split = len(shape) - self.event_dim
        self._batch_shape = shape[:split]
        self._event_shape = shape[split:]

    def sample(self, key, sample_shape=()):
        """Return the fixed ``value`` broadcast to the sample shape."""
        return jnp.broadcast_to(
            self.value, tuple(sample_shape) + jnp.shape(self.value)
        )

    def log_prob(self, value):
        """``log_density`` broadcast over the batch shape only."""
        batch = jnp.shape(value)[: jnp.ndim(value) - self.event_dim]
        return jnp.broadcast_to(
            jnp.asarray(self._log_density, dtype=jnp.result_type(float)),
            batch,
        )

    @property
    def mean(self):
        """The point-mass location."""
        return self.value


__all__ = ["Distribution", "TransformedDistribution", "Delta"]
