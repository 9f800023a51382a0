"""Predictive replay and pointwise log-likelihood.

API parity with the numpyro pieces the reference exercises
(examples/sir_infer_parameters.py:157-183 and
src/dynode/infer/inference.py:208-241): ``Predictive(model,
posterior_samples=...)``, ``Predictive(model, num_samples=...)`` (prior),
``Predictive(guide, params=..., num_samples=...)`` (variational posterior),
and ``Predictive(model, guide=..., params=..., num_samples=...)``.

Replays are vmapped over the draw axis -- one compiled program evaluates the
model (including its ODE solve) for all draws in parallel, which is exactly
the ensemble-parallel shape accelerators want.
"""

import contextlib
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp

from . import handlers


def _collect_sites(tr, skip_names, exclude_deterministic):
    out = {}
    for name, site in tr.items():
        if name in skip_names:
            continue
        if site["type"] == "sample":
            out[name] = site["value"]
        elif site["type"] == "deterministic" and not exclude_deterministic:
            out[name] = site["value"]
    return out


class Predictive:
    """Vectorized forward replay of a model (and/or guide) over draws."""

    def __init__(
        self,
        model: Optional[Callable] = None,
        posterior_samples: Optional[Dict[str, Any]] = None,
        *,
        guide: Optional[Callable] = None,
        params: Optional[Dict[str, Any]] = None,
        num_samples: Optional[int] = None,
        return_sites=None,
        exclude_deterministic: bool = True,
        parallel: bool = True,
        uncondition_observed: bool = False,
    ):
        # positional-model call style: Predictive(guide, params=..., num_samples=...)
        if model is not None and guide is None and params is not None:
            guide, model = model, None
        if guide is not None and posterior_samples is not None:
            # the guide would silently shadow the posterior rows (draw_latents
            # prefers it); numpyro rejects the combination too
            raise ValueError(
                "Predictive: pass EITHER posterior_samples (MCMC replay) OR "
                "guide=/params= (variational predictive), not both"
            )
        self.model = model
        self.guide = guide
        self.params = params or {}
        self.posterior_samples = posterior_samples
        self.return_sites = return_sites
        self.exclude_deterministic = exclude_deterministic
        #: vmap all draws into one program (the default) or,
        #: with parallel=False, run draws sequentially via lax.map --
        #: same results, O(1 draw) peak memory (numpyro's semantics)
        self.parallel = parallel
        #: resample observed sites instead of echoing their data back
        #: (numpyro contract is to echo; True gives genuine posterior-
        #: predictive replicates without re-calling with obs=None)
        self.uncondition_observed = uncondition_observed
        if posterior_samples is not None:
            sizes = {jnp.shape(v)[0] for v in posterior_samples.values()}
            assert len(sizes) == 1, "posterior sample sites disagree on count"
            self.num_samples = sizes.pop()
        else:
            assert num_samples is not None, (
                "need posterior_samples or num_samples"
            )
            self.num_samples = int(num_samples)

    def __call__(self, rng_key, *args, **kwargs) -> Dict[str, Any]:
        keys = jax.random.split(rng_key, self.num_samples)

        def draw_latents(key, posterior_draw):
            """Get the latent dict for one replay (guide draw or posterior row)."""
            if self.guide is not None:
                with handlers.trace() as gtr, handlers.seed(key), \
                        handlers.substitute(self.params):
                    self.guide(*args, **kwargs)
                return {
                    name: site["value"]
                    for name, site in gtr.items()
                    if site["type"] == "sample" and not site["is_observed"]
                }
            return posterior_draw or {}

        def replay(key, posterior_draw):
            k_guide, k_model = jax.random.split(key)
            latents = draw_latents(k_guide, posterior_draw)
            if self.model is None:
                # guide-only predictive: return the guide's sites
                return {k: v for k, v in latents.items()}
            unc = (
                handlers.uncondition()
                if self.uncondition_observed
                else contextlib.nullcontext()
            )
            with handlers.trace() as tr, handlers.seed(k_model), \
                    handlers.substitute(latents), unc:
                self.model(*args, **kwargs)
            out = _collect_sites(
                tr, skip_names=set(latents), exclude_deterministic=self.exclude_deterministic
            )
            if self.return_sites is not None:
                out = {
                    k: v
                    for k, v in (
                        list(out.items()) + [(n, tr[n]["value"]) for n in tr]
                    )
                    if k in self.return_sites
                }
            return out

        if self.posterior_samples is not None:
            if self.parallel:
                return jax.vmap(replay)(keys, self.posterior_samples)
            return jax.lax.map(
                lambda kd: replay(*kd), (keys, self.posterior_samples)
            )
        if self.parallel:
            return jax.vmap(lambda k: replay(k, None))(keys)
        return jax.lax.map(lambda k: replay(k, None), keys)


def log_likelihood(
    model: Callable,
    posterior_samples: Dict[str, Any],
    *args,
    **kwargs,
) -> Dict[str, jax.Array]:
    """Pointwise log p(obs | draw) for every observed site, vmapped over draws.

    ``posterior_samples`` must cover EVERY stochastic latent: a missing
    site would silently be drawn from its prior with a constant key
    (identical across draws), conditioning the whole matrix on one
    arbitrary prior draw -- garbage elpd/loo rankings with no symptom.
    Such sites raise instead. (Sites whose value is recomputed
    deterministically -- reparam'd Deltas -- consume no key and are fine.)
    """

    def single(draw):
        with handlers.trace() as tr, handlers.seed(jax.random.PRNGKey(0)), \
                handlers.substitute(draw):
            model(*args, **kwargs)
        fresh = [
            name
            for name, site in tr.items()
            if site["type"] == "sample"
            and not site["is_observed"]
            and name not in draw
            and site.get("rng_key") is not None
        ]
        if fresh:
            raise ValueError(
                f"log_likelihood: latent site(s) {fresh} are not in "
                "posterior_samples and were drawn fresh from the prior -- "
                "the pointwise likelihood would be conditioned on one "
                "arbitrary draw. Pass posterior values for every latent "
                "(get_samples() of the fit, unfiltered)."
            )
        return {
            name: handlers.weighted_log_prob(site)
            for name, site in tr.items()
            if site["type"] == "sample" and site["is_observed"]
        }

    return jax.vmap(single)(posterior_samples)


__all__ = ["Predictive", "log_likelihood"]
