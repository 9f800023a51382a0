"""Posterior-predictive forecasting at ensemble-kernel scale.

The reference's flagship workflow ends by projecting forward: fit, then
replay the model over the posterior draws without observed data
(/root/reference/examples/sir_infer_parameters.py:157-183, numpyro
``Predictive``). :class:`dynode_tpu.infer.Predictive` reproduces that
surface (vmapped replays through the XLA engines); this module is the
ensemble-scale path for the case that dominates production forecasting --
thousands of forward ODE solves differing only in sampled parameters:

1. :func:`resample_draws` bootstraps a posterior sample bank to an
   ensemble width,
2. the ``ops`` ensemble solvers run the forward ensemble
   (``seip_ensemble_solve[_adaptive]`` take per-strain per-member scale
   draws directly; any rows-RHS model goes through
   ``ops.ensemble_solve_kernel``),
3. :func:`member_quantiles` reduces the ensemble to forecast bands
   ON-DEVICE, so member-resolved trajectories never cross to the host;
   quantile summaries are a few KB.

``examples/seip_forecast.py`` chains the production pieces end to end
(ChEES fit -> ensemble forecast -> bands).
"""

from typing import Sequence, Tuple, Union

import jax
import jax.numpy as jnp

__all__ = ["resample_draws", "member_quantiles"]


def resample_draws(draws, width: int, key) -> jnp.ndarray:
    """Bootstrap posterior draws to an ensemble ``width``.

    ``draws``: ``(N, ...)`` array of posterior draws (first axis = draw).
    Returns ``(width, ...)`` sampled with replacement. Resampling with
    replacement keeps every member an exact draw from the posterior (the
    forecast ensemble is then a valid posterior-predictive sample bank),
    unlike tiling, which silently reweights when ``width % N != 0``. When
    ``width <= N`` a without-replacement thinning keeps members distinct.
    """
    draws = jnp.asarray(draws)
    n = draws.shape[0]
    if width <= n:
        idx = jax.random.choice(
            key, n, shape=(width,), replace=False
        )
    else:
        idx = jax.random.choice(key, n, shape=(width,), replace=True)
    return jnp.take(draws, idx, axis=0)


def member_quantiles(
    x: jnp.ndarray,
    qs: Union[Sequence[float], jnp.ndarray],
    member_axes: Union[int, Tuple[int, ...]] = -1,
) -> jnp.ndarray:
    """On-device ensemble quantiles over the member axes.

    ``x`` is any ensemble output whose member dimension(s) sit on
    ``member_axes`` -- by default the last axis, the ``ops`` solvers'
    member-last layout. Several axes are flattened into one member axis
    (quantiles do not depend on member order).

    Returns ``(len(qs), *kept_dims)`` in f32. Math runs in f32 even for
    bf16 saves (sorting bf16 directly would quantize the band edges).
    Keep the result on device or fetch it -- it is summary-sized.
    """
    if isinstance(member_axes, int):
        member_axes = (member_axes,)
    axes = tuple(a % x.ndim for a in member_axes)
    # move member axes last, flatten, one quantile reduction
    kept = tuple(i for i in range(x.ndim) if i not in axes)
    xt = jnp.transpose(x, kept + axes)
    m = 1
    for a in axes:
        m *= x.shape[a]
    xt = xt.reshape(xt.shape[: len(kept)] + (m,)).astype(jnp.float32)
    qs = jnp.asarray(qs, jnp.float32)
    return jnp.quantile(xt, qs, axis=-1)

