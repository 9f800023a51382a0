"""Bijective transforms between constrained and unconstrained space.

Used both for ``TransformedDistribution`` (the reference's priors use
``numpyro.distributions.TransformedDistribution`` with ``AffineTransform`` --
reference: examples/sir_infer_parameters.py:47-58) and for NUTS/SVI
reparameterization onto unconstrained R^n via :func:`biject_to`.

All forward/inverse/jacobian functions are elementwise pure-jnp -- they fuse
into the surrounding XLA program.
"""

import jax.numpy as jnp

from . import constraints as C


class Transform:
    """An invertible elementwise map with a tractable log|det J|."""

    #: constraint describing the image of the transform (its codomain)
    codomain: C.Constraint = C.real

    def __call__(self, x):
        raise NotImplementedError

    def inv(self, y):
        """Apply the inverse transform (subclasses implement)."""
        raise NotImplementedError

    def log_abs_det_jacobian(self, x, y):
        """log |dy/dx| evaluated elementwise at x (y = self(x) supplied to reuse work)."""
        raise NotImplementedError


class IdentityTransform(Transform):
    """No-op transform (``y = x``)."""
    codomain = C.real

    def __call__(self, x):
        return x

    def inv(self, y):
        """Apply the inverse transform."""
        return y

    def log_abs_det_jacobian(self, x, y):
        """``log|det J|`` of the forward map at ``(x, y)``."""
        return jnp.zeros_like(jnp.asarray(x))


class AffineTransform(Transform):
    """y = loc + scale * x."""

    def __init__(self, loc, scale, domain: C.Constraint = C.real):
        self.loc = loc
        self.scale = scale
        self.domain = domain
        # map the domain constraint through the affine map so downstream
        # code (e.g. NUTS bijections) sees the true support.
        if isinstance(domain, C._UnitInterval):
            self.codomain = C.Interval(loc, loc + scale)
        elif isinstance(domain, C.Interval):
            self.codomain = C.Interval(
                loc + scale * domain.low, loc + scale * domain.high
            )
        elif isinstance(domain, (C._Positive, C._Nonnegative)):
            self.codomain = C.GreaterThan(loc)
        else:
            self.codomain = C.real

    def __call__(self, x):
        return self.loc + self.scale * x

    def inv(self, y):
        """Apply the inverse transform."""
        return (y - self.loc) / self.scale

    def log_abs_det_jacobian(self, x, y):
        """``log|det J|`` of the forward map at ``(x, y)``."""
        return jnp.broadcast_to(
            jnp.log(jnp.abs(jnp.asarray(self.scale, dtype=jnp.result_type(float)))),
            jnp.shape(x),
        )


class ExpTransform(Transform):
    """y = exp(x); bijection R -> (0, inf)."""

    codomain = C.positive

    def __call__(self, x):
        return jnp.exp(x)

    def inv(self, y):
        """Apply the inverse transform."""
        return jnp.log(y)

    def log_abs_det_jacobian(self, x, y):
        """``log|det J|`` of the forward map at ``(x, y)``."""
        return jnp.asarray(x)


class SigmoidTransform(Transform):
    """y = sigmoid(x); bijection R -> (0, 1)."""

    codomain = C.unit_interval

    def __call__(self, x):
        return 1.0 / (1.0 + jnp.exp(-x))

    def inv(self, y):
        """Apply the inverse transform."""
        return jnp.log(y) - jnp.log1p(-y)

    def log_abs_det_jacobian(self, x, y):
        # log sigmoid'(x) = log(y) + log(1-y) = -softplus(-x) - softplus(x)
        """``log|det J|`` of the forward map at ``(x, y)``."""
        x = jnp.asarray(x)
        return -jnp.logaddexp(0.0, -x) - jnp.logaddexp(0.0, x)


class StickBreakingTransform(Transform):
    """Bijection R^{K-1} -> simplex^K (numpyro's stick-breaking convention).

    ``z_i = sigmoid(x_i - log(K-1-i))``; ``p_i = z_i * remaining_i``.
    """

    codomain = C.simplex

    def __call__(self, x):
        k = x.shape[-1] + 1
        offsets = jnp.log(jnp.arange(k - 1, 0, -1, dtype=x.dtype))
        z = 1.0 / (1.0 + jnp.exp(-(x - offsets)))
        z1m_cumprod = jnp.cumprod(1.0 - z, axis=-1)
        head = z * jnp.concatenate(
            [jnp.ones_like(z[..., :1]), z1m_cumprod[..., :-1]], axis=-1
        )
        return jnp.concatenate([head, z1m_cumprod[..., -1:]], axis=-1)

    def inv(self, p):
        """Apply the inverse transform."""
        k = p.shape[-1]
        p_head = p[..., :-1]
        remaining = 1.0 - jnp.concatenate(
            [jnp.zeros_like(p_head[..., :1]), jnp.cumsum(p_head, axis=-1)[..., :-1]],
            axis=-1,
        )
        z = p_head / remaining
        offsets = jnp.log(jnp.arange(k - 1, 0, -1, dtype=p.dtype))
        return jnp.log(z) - jnp.log1p(-z) + offsets

    def log_abs_det_jacobian(self, x, y):
        # sum_i [log remaining_i + log z_i + log(1 - z_i)], reduced over the
        # event axis (the transform is multivariate)
        """``log|det J|`` of the forward map at ``(x, y)``."""
        k = x.shape[-1] + 1
        offsets = jnp.log(jnp.arange(k - 1, 0, -1, dtype=x.dtype))
        t = x - offsets
        log_z = -jnp.logaddexp(0.0, -t)
        log_1mz = -jnp.logaddexp(0.0, t)
        z1m_cumprod = jnp.cumsum(log_1mz, axis=-1)
        log_remaining = jnp.concatenate(
            [jnp.zeros_like(t[..., :1]), z1m_cumprod[..., :-1]], axis=-1
        )
        return jnp.sum(log_z + log_1mz + log_remaining, axis=-1)


class ComposeTransform(Transform):
    """Apply a sequence of transforms left to right."""

    def __init__(self, parts):
        self.parts = list(parts)
        self.codomain = self.parts[-1].codomain if self.parts else C.real

    def __call__(self, x):
        for p in self.parts:
            x = p(x)
        return x

    def inv(self, y):
        """Apply the inverse transform."""
        for p in reversed(self.parts):
            y = p.inv(y)
        return y

    def log_abs_det_jacobian(self, x, y):
        """``log|det J|`` of the forward map at ``(x, y)``."""
        total = 0.0
        for p in self.parts:
            x_next = p(x)
            total = total + p.log_abs_det_jacobian(x, x_next)
            x = x_next
        return total


def push_constraint(constraint: C.Constraint, transform: Transform) -> C.Constraint:
    """Image of ``constraint`` under a monotone ``transform``.

    Used to compute a TransformedDistribution's support from its base
    distribution's support (e.g. Beta + Affine(1.5, 1) -> Interval(1.5, 2.5)).
    """
    if isinstance(transform, IdentityTransform):
        return constraint
    if isinstance(transform, ComposeTransform):
        for part in transform.parts:
            constraint = push_constraint(constraint, part)
        return constraint
    if isinstance(transform, ExpTransform):
        import math

        if isinstance(constraint, C.Interval):
            return C.Interval(math.exp(constraint.low), math.exp(constraint.high))
        if isinstance(constraint, C._UnitInterval):
            return C.Interval(1.0, math.e)
        return C.positive
    if isinstance(transform, SigmoidTransform):
        return C.unit_interval
    if isinstance(transform, AffineTransform):
        loc, scale = transform.loc, transform.scale
        try:
            scale_f = float(scale)
            loc_f = float(loc)
        except TypeError:
            return C.real  # array-valued affine: fall back to unconstrained

        def aff(x):
            return loc_f + scale_f * x

        if isinstance(constraint, C._UnitInterval):
            lo, hi = aff(0.0), aff(1.0)
            return C.Interval(min(lo, hi), max(lo, hi))
        if isinstance(constraint, C.Interval):
            lo, hi = aff(constraint.low), aff(constraint.high)
            return C.Interval(min(lo, hi), max(lo, hi))
        if isinstance(constraint, (C._Positive, C._Nonnegative)):
            return C.GreaterThan(loc_f) if scale_f > 0 else C.LessThan(loc_f)
        if isinstance(constraint, C.GreaterThan):
            b = aff(constraint.low)
            return C.GreaterThan(b) if scale_f > 0 else C.LessThan(b)
        if isinstance(constraint, C.LessThan):
            b = aff(constraint.high)
            return C.LessThan(b) if scale_f > 0 else C.GreaterThan(b)
        return C.real
    return transform.codomain


def biject_to(constraint: C.Constraint) -> Transform:
    """Return a bijection from unconstrained R onto ``constraint``'s region.

    This is what maps NUTS's unconstrained sample space back onto each
    latent site's support (softplus-free, matching numpyro's exp/sigmoid
    choices so posteriors are comparable draw-for-draw).
    """
    if isinstance(constraint, (C._Positive, C._Nonnegative)):
        return ExpTransform()
    if isinstance(constraint, C._UnitInterval):
        return SigmoidTransform()
    if isinstance(constraint, C.Interval):
        return ComposeTransform(
            [
                SigmoidTransform(),
                AffineTransform(
                    constraint.low,
                    constraint.high - constraint.low,
                    domain=C.unit_interval,
                ),
            ]
        )
    if isinstance(constraint, C.GreaterThan):
        return ComposeTransform(
            [ExpTransform(), AffineTransform(constraint.low, 1.0, domain=C.positive)]
        )
    if isinstance(constraint, C.LessThan):
        return ComposeTransform(
            [ExpTransform(), AffineTransform(constraint.high, -1.0, domain=C.positive)]
        )
    if isinstance(constraint, C._Simplex):
        return StickBreakingTransform()
    if isinstance(constraint, C._Real):
        return IdentityTransform()
    raise ValueError(f"no bijection registered for constraint {constraint!r}")


__all__ = [
    "Transform",
    "IdentityTransform",
    "AffineTransform",
    "ExpTransform",
    "SigmoidTransform",
    "ComposeTransform",
    "biject_to",
    "push_constraint",
]
