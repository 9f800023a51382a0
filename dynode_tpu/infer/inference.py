"""InferenceProcess / MCMCProcess / SVIProcess: the user-facing fit drivers.

Field-for-field parity with the reference process classes
(src/dynode/infer/inference.py:29-405), running on the in-repo NUTS/SVI
engines instead of numpyro. ``to_arviz()`` returns the in-repo
:class:`~dynode_tpu.infer.idata.InferenceData` (same group layout arviz uses).
"""

from typing import Any, Callable, Dict, Optional, Type

import jax
from jax import Array
from jax.random import PRNGKey
from pydantic import BaseModel, ConfigDict, Field, PositiveInt, PrivateAttr

from . import handlers
from .idata import InferenceData, from_dynode
from .mcmc import MCMC, NUTS
from .predictive import Predictive, log_likelihood
from .svi import (
    SVI,
    Adam,
    AutoGuide,
    AutoMultivariateNormal,
    SVIMultiStartResult,
    SVIRunResult,
    Trace_ELBO,
)
from .util import init_to_median


class InferenceProcess(BaseModel):
    """Abstract driver fitting a model callable to data."""

    model_config = ConfigDict(arbitrary_types_allowed=True)

    numpyro_model: Callable = Field(
        description="Model callable: initializes state, samples/resolves "
        "parameters, simulates, optionally scores observed data, and "
        "returns the generated Solution."
    )
    inference_prngkey: Array = Field(default_factory=lambda: PRNGKey(8675314))

    _inference_complete: bool = PrivateAttr(default=False)
    _inferer: Optional[Any] = PrivateAttr(default=None)
    # final sampler/optimizer state, retained for chained inference
    _inference_state: Optional[Any] = PrivateAttr(default=None)
    # model kwargs from infer(), replayed for Predictive
    _inferer_kwargs: Optional[dict] = PrivateAttr(default_factory=dict)
    _infer_calls: int = PrivateAttr(default=0)

    def infer(self, **kwargs):
        """Run inference (abstract; subclasses implement)."""
        raise NotImplementedError(
            "Inference process not implemented, please use a subclass."
        )

    def get_samples(self, group_by_chain=False, exclude_deterministic=True):
        """Posterior samples (abstract; subclasses implement)."""
        raise NotImplementedError(
            "get_samples() process not implemented, please use a subclass."
        )

    def to_arviz(self) -> InferenceData:
        """Convert results to :class:`InferenceData` (abstract)."""
        raise NotImplementedError(
            "to_arviz not implemented for abstract InferenceProcess, use subclass"
        )

    def _require_complete(self):
        if not self._inference_complete:
            raise AssertionError(
                "Inference process not completed, please call infer() first."
            )


def _enable_compile_cache():
    """Turn on the on-disk XLA executable cache for a fit.

    Every ``infer()`` on an accelerator opts into JAX's persistent
    compilation cache, so a fit in a fresh process loads its compiled
    programs instead of recompiling them. Idempotent; a no-op on the CPU
    so test runs don't touch disk; ``DYNODE_COMPILATION_CACHE=0`` is the
    operator kill-switch (read inside the helper).
    """
    if jax.default_backend() != "cpu":
        from ..utils.compilation_cache import enable_compilation_cache

        enable_compilation_cache()


class MCMCProcess(InferenceProcess):
    """NUTS-based fitting with vectorized (mesh-shardable) chains."""

    num_samples: PositiveInt
    num_warmup: PositiveInt
    num_chains: PositiveInt
    nuts_max_tree_depth: PositiveInt
    nuts_init_strategy: Callable = init_to_median
    mcmc_kwargs: dict = Field(
        default_factory=dict,
        description="Extra kwargs to MCMC (e.g. mesh=, chain_axis=).",
    )
    nuts_kwargs: dict = Field(
        default_factory=dict,
        description="Extra kwargs to the NUTS kernel (e.g. dense_mass=False).",
    )
    sampler: str = Field(
        default="nuts",
        description=(
            "'nuts' (reference parity: numpyro-NUTS semantics) or 'chees' "
            "(wide-bank jittered HMC with cross-chain trajectory "
            "adaptation; best for num_chains >> num_devices). "
            "nuts_kwargs are forwarded to either kernel."
        ),
    )
    progress_bar: bool = True

    def infer(self, warm_start=None, **kwargs) -> MCMC:
        """Fit with the configured kernel; extra kwargs go to the model.

        ``warm_start``: a value from :meth:`warm_start_state` of a previous
        process (or ``MCMC.warm_start_state()`` /
        :func:`~dynode_tpu.infer.chees_warm_start_from_guide`) — the
        chained-inference path the reference keeps ``last_state`` for
        (reference: src/dynode/infer/inference.py:50-53). Warmup is
        skipped entirely; ``num_warmup`` is ignored for this run.

        Repeated ``infer()`` calls on one process fold a call counter into
        ``inference_prngkey`` (first call uses the key untouched — exact
        reference parity): chained segments must consume FRESH transition
        randomness, or segment k+1 would replay segment k's momentum /
        accept / jitter draws and pooled-chain draws would be correlated.
        When chaining across *separate* process objects instead, give each
        its own ``inference_prngkey`` — two default-keyed warm segments
        would otherwise share a transition stream.
        """
        _enable_compile_cache()
        if self.sampler == "chees":
            from .chees import ChEES

            kernel = ChEES(
                self.numpyro_model,
                init_strategy=self.nuts_init_strategy,
                **self.nuts_kwargs,
            )
        elif self.sampler == "nuts":
            nuts_kwargs = dict(dense_mass=True)
            nuts_kwargs.update(self.nuts_kwargs)
            kernel = NUTS(
                self.numpyro_model,
                max_tree_depth=self.nuts_max_tree_depth,
                init_strategy=self.nuts_init_strategy,
                **nuts_kwargs,
            )
        else:
            raise ValueError(
                f"unknown sampler {self.sampler!r}; use 'nuts' or 'chees'"
            )
        inferer = MCMC(
            kernel,
            num_warmup=self.num_warmup,
            num_samples=self.num_samples,
            num_chains=self.num_chains,
            progress_bar=self.progress_bar,
            **self.mcmc_kwargs,
        )
        key = (
            self.inference_prngkey
            if self._infer_calls == 0
            else jax.random.fold_in(self.inference_prngkey, self._infer_calls)
        )
        self._infer_calls += 1
        inferer.run(key, warm_start=warm_start, **kwargs)
        self._inference_complete = True
        self._inferer = inferer
        self._inference_state = inferer.last_state
        self._inferer_kwargs = kwargs
        return inferer

    def warm_start_state(self):
        """Resumable sampler state for a later ``infer(warm_start=...)``
        (chained inference across processes; see ``MCMC.warm_start_state``
        and ``infer.state_io`` for the on-disk version)."""
        self._require_complete()
        assert isinstance(self._inferer, MCMC)
        return self._inferer.warm_start_state()

    def get_samples(
        self, group_by_chain=False, exclude_deterministic=True
    ) -> Dict[str, Array]:
        """Posterior samples: (chains*samples, ...) or (chains, samples, ...)."""
        self._require_complete()
        assert isinstance(self._inferer, MCMC)
        samples = self._inferer.get_samples(group_by_chain=group_by_chain)
        if not exclude_deterministic:
            det = self._inferer.deterministic_samples()
            if group_by_chain:
                det = {
                    k: v.reshape(
                        (self.num_chains, self.num_samples) + v.shape[1:]
                    )
                    for k, v in det.items()
                }
            samples = {**samples, **det}
        return samples

    def to_arviz(self) -> InferenceData:
        """Posterior/prior/predictive/log-lik/observed as InferenceData.

        Group parity with the reference's ``az.from_numpyro`` export
        (reference: src/dynode/infer/inference.py:208-241), which also
        attaches pointwise ``log_likelihood`` (feeding ``az.loo``/
        ``az.waic`` — here :func:`~dynode_tpu.infer.loo` /
        :func:`~dynode_tpu.infer.waic`) and ``observed_data``.
        """
        self._require_complete()
        assert isinstance(self._inferer, MCMC)
        # uncondition_observed: resample observed sites so the group holds
        # genuine replicates usable for PPC/loo_pit. (The reference replays
        # with the observation kwargs still set, so ITS group echoes the
        # data back -- an az.from_numpyro quirk, not a useful behavior.)
        posterior_predictive = Predictive(
            self.numpyro_model,
            posterior_samples=self.get_samples(),
            uncondition_observed=True,
        )(
            rng_key=self.inference_prngkey,
            **self._inferer_kwargs,
        )
        prior = Predictive(
            self.numpyro_model,
            num_samples=self.num_samples,
            uncondition_observed=True,
        )(
            rng_key=self.inference_prngkey,
            **self._inferer_kwargs,
        )
        ll = log_likelihood(
            self.numpyro_model,
            self.get_samples(),
            **self._inferer_kwargs,
        )
        with handlers.trace() as tr, handlers.seed(self.inference_prngkey):
            self.numpyro_model(**self._inferer_kwargs)
        observed = {
            name: site["value"]
            for name, site in tr.items()
            if site["type"] == "sample" and site["is_observed"]
        }
        return from_dynode(
            posterior=self.get_samples(group_by_chain=True),
            posterior_predictive=posterior_predictive,
            prior=prior,
            sample_stats=self._inferer.get_extra_fields(group_by_chain=True),
            log_likelihood=ll,
            observed_data=observed,
        )


class SVIProcess(InferenceProcess):
    """Variational fitting with an autoguide (full-rank Gaussian by default)."""

    model_config = ConfigDict(arbitrary_types_allowed=True)

    num_iterations: PositiveInt = Field(
        description="Number of ELBO optimization steps."
    )
    num_samples: PositiveInt = Field(
        description="Posterior draws generated by get_samples() after a fit."
    )
    guide_class: Type[AutoGuide] = AutoMultivariateNormal
    guide_init_strategy: Callable = init_to_median
    optimizer: Any = Field(
        default_factory=lambda: Adam(step_size=0.1),
        description="SVI optimizer (Adam/ClippedAdam or any optax transform).",
    )
    progress_bar: bool = True
    guide_kwargs: dict = Field(default_factory=dict)
    num_starts: PositiveInt = Field(
        default=1,
        description="Independent jittered-init SVI runs executed as ONE "
        "vmapped program (mesh-shardable via svi_mesh=); >1 defends "
        "against ELBO local optima and fills the device the way chain width "
        "does for MCMC. get_samples() draws from the best-ELBO start.",
    )
    svi_mesh: Any = Field(
        default=None,
        description="Optional jax.sharding.Mesh to shard the start axis "
        "of a multi-start run across devices (starts are independent; "
        "the program is collective-free).",
    )
    init_jitter: float = Field(
        default=1.0,
        description="Stddev of the per-start Gaussian jitter applied to "
        "unconstrained guide loc inits in a multi-start run.",
    )

    def infer(self, **kwargs) -> SVI:
        """Fit with SVI; extra kwargs go to the model callable."""
        _enable_compile_cache()
        guide = self.guide_class(
            self.numpyro_model,
            init_loc_fn=self.guide_init_strategy,
            **self.guide_kwargs,
        )
        inferer = SVI(
            model=self.numpyro_model,
            guide=guide,
            optim=self.optimizer,
            loss=Trace_ELBO(),
        )
        if self.num_starts > 1:
            self._inference_state = inferer.run_multistart(
                self.inference_prngkey,
                num_steps=self.num_iterations,
                num_starts=int(self.num_starts),
                init_jitter=self.init_jitter,
                mesh=self.svi_mesh,
                progress_bar=self.progress_bar,
                **kwargs,
            )
        else:
            svi_state = inferer.init(self.inference_prngkey, **kwargs)
            self._inference_state = inferer.run(
                self.inference_prngkey,
                num_steps=self.num_iterations,
                init_state=svi_state,
                progress_bar=self.progress_bar,
                **kwargs,
            )
        self._inference_complete = True
        self._inferer = inferer
        self._inferer_kwargs = kwargs
        return inferer

    def get_samples(
        self, _: bool = False, exclude_deterministic: bool = True
    ) -> Dict[str, Array]:
        """Draw ``num_samples`` from the fitted variational posterior."""
        self._require_complete()
        assert isinstance(
            self._inference_state, (SVIRunResult, SVIMultiStartResult)
        )
        assert isinstance(self._inferer, SVI)
        predictive = Predictive(
            self._inferer.guide,
            params=self._inference_state.params,
            num_samples=self.num_samples,
        )
        samples = predictive(self.inference_prngkey, **self._inferer_kwargs)
        if not exclude_deterministic:
            det_predictive = Predictive(
                model=self._inferer.model,
                guide=self._inferer.guide,
                params=self._inference_state.params,
                num_samples=self.num_samples,
                exclude_deterministic=False,
            )
            det = det_predictive(self.inference_prngkey, **self._inferer_kwargs)
            samples = {**samples, **det}
        return {
            name: value
            for name, value in samples.items()
            if not name.startswith("_auto")
        }

    def to_arviz(self) -> InferenceData:
        """Prior + posterior-predictive + pointwise log-likelihood."""
        self._require_complete()
        samples = self.get_samples()
        # resample observed sites (see MCMCProcess.to_arviz note)
        posterior_predictive = Predictive(
            self.numpyro_model,
            posterior_samples=samples,
            uncondition_observed=True,
        )(
            rng_key=self.inference_prngkey,
            **self._inferer_kwargs,
        )
        prior = Predictive(
            self.numpyro_model,
            num_samples=self.num_iterations,
            uncondition_observed=True,
        )(
            rng_key=self.inference_prngkey,
            **self._inferer_kwargs,
        )
        ll = log_likelihood(
            self.numpyro_model, samples, **self._inferer_kwargs
        )
        return from_dynode(
            posterior={k: jax.numpy.asarray(v)[None] for k, v in samples.items()},
            posterior_predictive=posterior_predictive,
            prior=prior,
            log_likelihood=ll,
        )


__all__ = ["InferenceProcess", "MCMCProcess", "SVIProcess"]
