"""Stochastic variational inference: Trace_ELBO, autoguides, optax optimizers.

API parity with the numpyro pieces the reference uses
(src/dynode/infer/inference.py:244-302): ``SVI(model, guide, optim,
Trace_ELBO())`` with ``AutoMultivariateNormal(model, init_loc_fn=
init_to_median)`` and ``Adam(step_size=0.1)``; ``svi.init(key, **kwargs)``
then ``svi.run(key, num_steps, init_state)`` returning an ``SVIRunResult``.

The whole optimization is one ``lax.scan`` inside jit -- per-step Python
overhead is zero, and the ELBO gradient differentiates through the ODE
engine's checkpointed scan like any other JAX function.
"""

from typing import Any, Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax

from ..dist import Delta, MultivariateNormal, Normal
from ..dist.transforms import biject_to
from . import handlers
from .util import (
    get_model_trace,
    init_to_median,
    initialize_latents,
    latent_sites,
    log_density,
)


class SVIState(NamedTuple):
    """Optimizer + RNG carry of an SVI run."""
    params: Dict[str, Any]
    opt_state: Any
    rng_key: jax.Array


class SVIRunResult(NamedTuple):
    """Final state and per-step loss trace of :meth:`SVI.run`."""
    params: Dict[str, Any]
    state: SVIState
    losses: jax.Array


class SVIMultiStartResult(NamedTuple):
    """Result of :meth:`SVI.run_multistart`.

    ``params`` holds the winning start's parameters (drop-in for
    ``SVIRunResult.params``); the ``all_*`` fields keep the full bank for
    multi-modality diagnostics (a bimodal final-ELBO histogram means the
    guide found distinct optima).
    """

    params: Dict[str, Any]
    losses: jax.Array  # (num_steps,) winning start's loss trace
    best_idx: jax.Array  # ()
    final_elbos: jax.Array  # (num_starts,) multi-particle final -loss
    all_params: Dict[str, Any]  # (num_starts, ...) per-start final params
    all_losses: jax.Array  # (num_starts, num_steps)


class Adam:
    """optax.adam with numpyro's ``Adam(step_size=...)`` constructor shape."""

    def __init__(self, step_size: float = 1e-3, **kwargs):
        self.step_size = step_size
        self.optax_optimizer = optax.adam(step_size, **kwargs)


class ClippedAdam:
    """Adam with global-norm gradient clipping."""

    def __init__(self, step_size: float = 1e-3, clip_norm: float = 10.0, **kwargs):
        self.step_size = step_size
        self.optax_optimizer = optax.chain(
            optax.clip_by_global_norm(clip_norm), optax.adam(step_size, **kwargs)
        )


def _as_optax(optim):
    if hasattr(optim, "optax_optimizer"):
        return optim.optax_optimizer
    return optim  # assume a raw optax GradientTransformation


class Trace_ELBO:
    """Single-sample (or multi-particle) reparameterized ELBO."""

    def __init__(self, num_particles: int = 1):
        self.num_particles = num_particles

    def loss(self, rng_key, params, model, guide, *args, **kwargs):
        """Monte-Carlo ELBO loss (negative evidence lower bound) estimate."""
        def particle(key):
            with handlers.trace() as guide_tr, handlers.seed(key), \
                    handlers.substitute(params):
                guide(*args, **kwargs)
            log_q = jnp.zeros((), dtype=jnp.result_type(float))
            latent_values = {}
            for name, site in guide_tr.items():
                if site["type"] == "sample" and not site["is_observed"]:
                    log_q = log_q + jnp.sum(
                        handlers.weighted_log_prob(site)
                    )
                    latent_values[name] = site["value"]
            log_p, _ = log_density(model, args, kwargs, latent_values)
            return log_q - log_p  # negative ELBO

        if self.num_particles == 1:
            return particle(rng_key)
        keys = jax.random.split(rng_key, self.num_particles)
        return jnp.mean(jax.vmap(particle)(keys))


# ---------------------------------------------------------------------------
# autoguides
# ---------------------------------------------------------------------------


class AutoGuide:
    """Base: discovers the model's latent structure on first trace."""

    def __init__(self, model, *, prefix: str = "auto", init_loc_fn=init_to_median):
        self.model = model
        self.prefix = prefix
        self.init_loc_fn = init_loc_fn
        self._ready = False

    def _setup(self, *args, **kwargs):
        if self._ready:
            return
        tr = get_model_trace(self.model, jax.random.PRNGKey(0), *args, **kwargs)
        sites = latent_sites(tr)
        if not sites:
            raise ValueError("model has no latent sites for the guide")
        self._transforms = {n: biject_to(s["fn"].support) for n, s in sites.items()}
        init_constrained = initialize_latents(
            tr, jax.random.PRNGKey(0), self.init_loc_fn
        )
        init_unconstrained = {
            n: self._transforms[n].inv(v) for n, v in init_constrained.items()
        }
        from jax.flatten_util import ravel_pytree

        self._init_flat, self._unravel = ravel_pytree(init_unconstrained)
        self._dim = self._init_flat.shape[0]
        self._ready = True

    def _emit_sites(self, z_flat):
        """Emit each model latent as a Delta site carrying -ldj."""
        uparams = self._unravel(z_flat)
        out = {}
        for name, u in uparams.items():
            t = self._transforms[name]
            c = t(u)
            ldj = jnp.sum(t.log_abs_det_jacobian(u, c))
            # event_dim=c.ndim: the scalar -ldj must enter the ELBO exactly
            # once per site, not broadcast over every element of c
            # (ADVICE r1: non-scalar latents otherwise optimize -ldj*size(c)).
            out[name] = handlers.sample(
                name, Delta(c, log_density=-ldj, event_dim=jnp.ndim(c))
            )
        return out

    def __call__(self, *args, **kwargs):
        raise NotImplementedError


def _softplus(x):
    return jnp.logaddexp(x, 0.0)


def _softplus_inv(y):
    return jnp.log(jnp.expm1(y))


class AutoMultivariateNormal(AutoGuide):
    """Full-rank Gaussian posterior in unconstrained space (reference default:
    src/dynode/infer/inference.py:258).

    The raw ``*_scale_tril`` parameter is unconstrained; the guide maps it to
    a valid lower-Cholesky factor (softplus on the diagonal, strict lower
    triangle elsewhere) so gradient updates cannot break positive-definiteness.
    """

    init_scale: float = 0.1

    def _scale_tril_from_params(self, params):
        """raw param -> the lower-Cholesky factor the guide samples with.

        The single source of truth for the raw->tril mapping: ``__call__``
        and :func:`chees_warm_start_from_guide` both use it, so a future
        reparameterization cannot silently diverge between fitting and the
        SVI->MCMC handoff.
        """
        raw = params[f"{self.prefix}_scale_tril"]
        return jnp.tril(raw, -1) + jnp.diag(_softplus(jnp.diagonal(raw)))

    def __call__(self, *args, **kwargs):
        self._setup(*args, **kwargs)
        dtype = self._init_flat.dtype
        loc = handlers.param(f"{self.prefix}_loc", self._init_flat)
        raw_init = jnp.diag(
            jnp.full((self._dim,), _softplus_inv(jnp.asarray(self.init_scale)), dtype)
        )
        raw = handlers.param(f"{self.prefix}_scale_tril", raw_init)
        scale_tril = self._scale_tril_from_params(
            {f"{self.prefix}_scale_tril": raw}
        )
        z = handlers.sample("_auto_latent", MultivariateNormal(loc, scale_tril))
        return self._emit_sites(z)


class AutoNormal(AutoGuide):
    """Mean-field Gaussian posterior in unconstrained space."""

    def _scale_from_params(self, params):
        """raw param -> per-dim scales (shared by __call__ and the
        SVI->MCMC handoff; see AutoMultivariateNormal._scale_tril_from_params)."""
        return jnp.exp(jnp.asarray(params[f"{self.prefix}_log_scale"]))

    def __call__(self, *args, **kwargs):
        self._setup(*args, **kwargs)
        loc = handlers.param(f"{self.prefix}_loc", self._init_flat)
        log_scale = handlers.param(
            f"{self.prefix}_log_scale",
            jnp.full((self._dim,), jnp.log(0.1), dtype=self._init_flat.dtype),
        )
        z = handlers.sample(
            "_auto_latent",
            Normal(
                loc,
                self._scale_from_params(
                    {f"{self.prefix}_log_scale": log_scale}
                ),
            ),
        )
        return self._emit_sites(z)


class AutoDelta(AutoGuide):
    """MAP point estimate (a Delta guide in unconstrained space)."""

    def __call__(self, *args, **kwargs):
        self._setup(*args, **kwargs)
        loc = handlers.param(f"{self.prefix}_loc", self._init_flat)
        z = handlers.sample("_auto_latent", Delta(loc))
        return self._emit_sites(z)


#: alias for numpyro's AutoContinuous base (reference type annotations)
AutoContinuous = AutoGuide


# ---------------------------------------------------------------------------
# SVI driver
# ---------------------------------------------------------------------------


class SVI:
    """Stochastic variational inference driver (numpyro-style API: init/update/run).
    """
    def __init__(self, model, guide, optim, loss: Optional[Trace_ELBO] = None):
        self.model = model
        self.guide = guide
        self.optim = _as_optax(optim)
        self.loss = loss or Trace_ELBO()
        #: compiled multi-start banks, identity-keyed (see run_multistart)
        self._multistart_cache: Dict[Any, Any] = {}

    def init(self, rng_key, **model_kwargs) -> SVIState:
        """Trace the guide to discover params; build the optimizer state."""
        args = model_kwargs.pop("_args", ())
        with handlers.trace() as tr, handlers.seed(rng_key):
            self.guide(*args, **model_kwargs)
        params = {
            name: site["value"]
            for name, site in tr.items()
            if site["type"] == "param"
        }
        opt_state = self.optim.init(params)
        return SVIState(params=params, opt_state=opt_state, rng_key=rng_key)

    def update(self, state: SVIState, *args, **kwargs):
        """One ELBO gradient step (jittable)."""
        key, sub = jax.random.split(state.rng_key)

        def neg_elbo(params):
            return self.loss.loss(
                sub, params, self.model, self.guide, *args, **kwargs
            )

        loss_val, grads = jax.value_and_grad(neg_elbo)(state.params)
        updates, opt_state = self.optim.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return SVIState(params, opt_state, key), loss_val

    def run(
        self,
        rng_key,
        num_steps: int,
        init_state: Optional[SVIState] = None,
        progress_bar: bool = False,
        **model_kwargs,
    ) -> SVIRunResult:
        """Optimize for ``num_steps`` inside one compiled lax.scan."""
        args = model_kwargs.pop("_args", ())
        state = init_state if init_state is not None else self.init(
            rng_key, **dict(model_kwargs)
        )
        if progress_bar:
            print(f"[dynode_tpu.SVI] compiling+running {num_steps} steps...")

        def step(state, _):
            state, loss_val = self.update(state, *args, **model_kwargs)
            return state, loss_val

        state, losses = jax.jit(
            lambda s: jax.lax.scan(step, s, None, length=int(num_steps))
        )(state)
        if progress_bar:
            print(f"[dynode_tpu.SVI] final loss {float(losses[-1]):.4f}")
        return SVIRunResult(params=state.params, state=state, losses=losses)

    def get_params(self, state: SVIState):
        """Constrained parameter values from an :class:`SVIState`."""
        return state.params

    def run_multistart(
        self,
        rng_key,
        num_steps: int,
        num_starts: int,
        *,
        init_jitter: float = 1.0,
        final_particles: int = 16,
        mesh=None,
        batch_axis: str = "start",
        progress_bar: bool = False,
        **model_kwargs,
    ) -> SVIMultiStartResult:
        """Run ``num_starts`` independent SVI optimizations in ONE program.

        Bank-scale SVI: the whole bank (per-start jittered inits, the full
        Adam scan, and a multi-particle final-ELBO evaluation) is a single
        jitted ``vmap`` over the start axis -- ELBO steps across starts
        fill the chip the way chain width does for MCMC. Pass ``mesh=`` to
        shard the start axis over devices via GSPMD (starts are
        independent, so the program is collective-free).

        Per-start diversity: every ``*_loc`` parameter is jittered by
        ``init_jitter``-scaled Gaussian noise in unconstrained space
        (start 0 keeps the un-jittered init strategy); non-loc parameters
        (scale factors) are shared at their init values. Winner selection
        re-evaluates each start's final ELBO with ``final_particles``
        fresh particles -- the running one-particle loss is too noisy to
        rank near-tied optima.

        The reference surface this scales up:
        /root/reference/src/dynode/infer/inference.py:244-405 (one Adam
        run, one init). Multi-start is the standard defense against ELBO
        local optima, which single-init SVI silently falls into.

        Repeat calls with the same bank shape and the same model argument
        OBJECTS reuse the compiled program (identity-keyed like the MCMC
        exec cache -- infer/mcmc.py; ``base.params``, the jitter/step/eval
        keys, and ``init_jitter`` are traced inputs, so fresh seeds and
        re-inits hit the cache). A different obs array object is a
        deliberate miss: model args are compiled-in constants.
        """
        args = model_kwargs.pop("_args", ())
        base = self.init(rng_key, _args=args, **model_kwargs)
        key_jit, key_run, key_eval = jax.random.split(rng_key, 3)

        kw_items = tuple(sorted(model_kwargs.items(), key=lambda kv: kv[0]))
        cache_key = (
            int(num_steps),
            int(num_starts),
            int(final_particles),
            tuple(id(a) for a in args),
            tuple((k, id(v)) for k, v in kw_items),
        )
        entry = self._multistart_cache.get(cache_key)
        # identity double-check: a GC'd object's id can be recycled
        if entry is not None and not (
            all(a is b for a, b in zip(entry["args"], args))
            and all(
                v is model_kwargs[k] for k, v in entry["kwargs"].items()
            )
        ):
            entry = None
        if entry is None:

            def jitter_params(base_params, key, jitter):
                out = {}
                for name, v in base_params.items():
                    if name.endswith("_loc"):
                        key, sub = jax.random.split(key)
                        out[name] = v + jitter * jax.random.normal(
                            sub, v.shape, v.dtype
                        )
                    else:
                        out[name] = v
                return out

            def one_start(base_params, jitter, key_init, key_steps, keep_base):
                params0 = jax.tree_util.tree_map(
                    lambda a, b: jnp.where(keep_base, a, b),
                    base_params,
                    jitter_params(base_params, key_init, jitter),
                )
                state = SVIState(params0, self.optim.init(params0), key_steps)

                def step(state, _):
                    state, loss_val = self.update(state, *args, **model_kwargs)
                    return state, loss_val

                state, losses = jax.lax.scan(
                    step, state, None, length=int(num_steps)
                )
                return state.params, losses

            def final_elbo(params, key):
                keys = jax.random.split(key, final_particles)
                losses = jax.vmap(
                    lambda k: self.loss.loss(
                        k, params, self.model, self.guide, *args,
                        **model_kwargs
                    )
                )(keys)
                return -jnp.mean(losses)

            def bank(base_params, jitter, init_keys, step_keys, eval_keys):
                keep = jnp.arange(num_starts) == 0  # start 0 = unjittered
                params_all, losses_all = jax.vmap(
                    lambda ki, ks, kb: one_start(
                        base_params, jitter, ki, ks, kb
                    )
                )(init_keys, step_keys, keep)
                elbos = jax.vmap(final_elbo)(params_all, eval_keys)
                return params_all, losses_all, elbos

            entry = {
                "fn": jax.jit(bank),
                "args": tuple(args),
                "kwargs": dict(kw_items),
            }
            self._multistart_cache[cache_key] = entry

        init_keys = jax.random.split(key_jit, num_starts)
        step_keys = jax.random.split(key_run, num_starts)
        eval_keys = jax.random.split(key_eval, num_starts)
        if mesh is not None:
            from ..parallel import shard_batch

            sharding = shard_batch(mesh, batch_axis)
            init_keys = jax.device_put(init_keys, sharding)
            step_keys = jax.device_put(step_keys, sharding)
            eval_keys = jax.device_put(eval_keys, sharding)
        if progress_bar:
            print(
                f"[dynode_tpu.SVI] compiling+running {num_starts} starts x "
                f"{num_steps} steps..."
            )
        params_all, losses_all, elbos = entry["fn"](
            base.params,
            jnp.asarray(init_jitter, jnp.result_type(float)),
            init_keys,
            step_keys,
            eval_keys,
        )
        # non-finite ELBOs (diverged starts) must never win
        elbos_ranked = jnp.where(jnp.isfinite(elbos), elbos, -jnp.inf)
        best = jnp.argmax(elbos_ranked)
        best_params = jax.tree_util.tree_map(lambda v: v[best], params_all)
        if progress_bar:
            print(
                f"[dynode_tpu.SVI] best start {int(best)}: "
                f"ELBO {float(elbos[best]):.4f}"
            )
        return SVIMultiStartResult(
            params=best_params,
            losses=losses_all[best],
            best_idx=best,
            final_elbos=elbos,
            all_params=params_all,
            all_losses=losses_all,
        )


# ---------------------------------------------------------------------------
# SVI-initialized MCMC (Pathfinder-style warm starts)
# ---------------------------------------------------------------------------


def chees_warm_start_from_guide(
    guide: AutoGuide,
    params: Dict[str, jax.Array],
    num_chains: int,
    rng_key: jax.Array,
    *,
    step_size: Optional[float] = None,
    trajectory_length: Optional[float] = None,
    init_jitter: float = 0.0,
):
    """Build an ``MCMC.run(warm_start=)`` value for a ChEES kernel from a
    fitted autoguide — SVI-initialized MCMC in the Pathfinder spirit
    (Zhang et al. 2022: cheap variational fit -> posterior-shaped inits +
    metric for the exact sampler).

    A multi-start SVI bank is one compiled program (``bench_nuts.py``
    reports ``svi_elbo_steps_per_sec``), and its winning guide hands the sampler
    everything warmup exists to learn: chain positions are drawn from the
    guide, the (inverse) mass matrix is the guide covariance — so the
    mass-normalized posterior is ~isotropic and the default trajectory
    length pi/2 is the Gaussian-optimal quarter period — and the default
    step size follows the D^(-1/4) optimal-scaling rule. The returned
    value plugs into ``MCMC(ChEES(model), num_warmup=0, ...).run(...,
    warm_start=...)``; the run re-anchors potentials/gradients itself, and
    ChEES transitions are exact MH regardless of these choices, so a poor
    guide costs efficiency, never correctness. Discard the first few
    draws as burn-in when the guide fit is uncertain (the chains start
    guide-distributed, not posterior-distributed), and keep
    ``consensus_check=`` on for production fits.

    ``params``: the fitted parameter dict (``SVIRunResult.params`` /
    ``SVIMultiStartResult.params``). ``init_jitter``: extra N(0, jitter)
    noise on the unconstrained draws (required for :class:`AutoDelta`,
    whose point guide otherwise starts every chain identically).
    """
    from .chees import ChEESBankState

    if not guide._ready:
        raise ValueError(
            "guide has no latent structure yet: fit it first (SVI.run / "
            "run_multistart traces it)"
        )
    loc = jnp.asarray(params[f"{guide.prefix}_loc"])
    dtype = loc.dtype
    d = loc.shape[0]
    k_draw, k_jit, k_state = jax.random.split(rng_key, 3)
    eps_n = jax.random.normal(k_draw, (num_chains, d), dtype)
    if isinstance(guide, AutoMultivariateNormal):
        scale_tril = guide._scale_tril_from_params(params)
        z = loc[None, :] + eps_n @ scale_tril.T
        inv_mass = scale_tril @ scale_tril.T  # guide covariance, dense
        chol_inv = scale_tril  # chol(inv_mass): exactly hmc.sample_momentum's
    elif isinstance(guide, AutoNormal):
        scale = guide._scale_from_params(params)
        z = loc[None, :] + scale[None, :] * eps_n
        inv_mass = scale**2  # diag
        chol_inv = scale
    elif isinstance(guide, AutoDelta):
        if init_jitter <= 0.0:
            raise ValueError(
                "AutoDelta is a point guide: pass init_jitter > 0 so the "
                "bank's chains do not all start at the identical MAP point"
            )
        z = jnp.broadcast_to(loc[None, :], (num_chains, d))
        inv_mass = jnp.ones((d,), dtype)  # no covariance information
        chol_inv = jnp.ones((d,), dtype)
    else:
        raise TypeError(
            f"unsupported guide type {type(guide).__name__}: expected "
            "AutoMultivariateNormal, AutoNormal, or AutoDelta"
        )
    if init_jitter > 0.0:
        z = z + init_jitter * jax.random.normal(k_jit, z.shape, dtype)
    # optimal-scaling default in mass-normalized coordinates (the guide
    # metric whitens the posterior): eps ~ 1.65 D^(-1/4), leapfrog-stable
    # (< 2) for every D. AutoDelta carries no covariance, so its identity
    # mass does NOT whiten -- the only scale the caller asserted is
    # init_jitter, so the default shrinks by it (pass step_size for
    # anything better).
    if step_size is not None:
        eps_val = step_size
    else:
        eps_val = min(1.65 * d**-0.25, 1.9)
        if isinstance(guide, AutoDelta):
            eps_val *= init_jitter
    eps = jnp.asarray(eps_val, dtype)
    traj = jnp.asarray(
        trajectory_length
        if trajectory_length is not None
        else jnp.pi / 2.0,
        dtype,
    )
    traj = jnp.maximum(traj, eps)
    zerosC = jnp.zeros((num_chains,), dtype)
    state = ChEESBankState(
        z=z.astype(dtype),
        # potential/grad are placeholders: MCMC.run's warm-start path
        # re-evaluates both under the run's own (centered) potential before
        # the first transition (infer/mcmc.py::_run_chees)
        potential=zerosC,
        grad=jnp.zeros((num_chains, d), dtype),
        energy=zerosC,
        accept_prob=zerosC,
        num_steps=jnp.zeros((num_chains,), jnp.int32),
        diverging=jnp.zeros((num_chains,), bool),
        iter_idx=jnp.int32(0),
        rng_key=k_state,
    )
    return state, (inv_mass, chol_inv, eps, traj)


__all__ = [
    "SVI",
    "SVIState",
    "SVIRunResult",
    "SVIMultiStartResult",
    "Trace_ELBO",
    "Adam",
    "ClippedAdam",
    "AutoGuide",
    "AutoContinuous",
    "AutoNormal",
    "AutoMultivariateNormal",
    "AutoDelta",
    "chees_warm_start_from_guide",
]
