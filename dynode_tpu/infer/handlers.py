"""Minimal effect-handler system: sample/deterministic/param primitives.

A compact reimplementation of the numpyro handler pattern the reference
depends on (reference: docs/source/markdown/backend-libraries.md:72, tests
use ``numpyro.handlers.trace``/``seed``/``substitute`` --
tests/test_infer/test_sample.py:49-94). Models are ordinary Python callables
containing :func:`sample` / :func:`deterministic` calls; handlers are context
managers stacked around model execution:

- ``seed(rng_seed=...)``: provides (and splits) PRNG keys per site.
- ``trace()``: records every site (name, fn, value, observed flag).
- ``substitute(data=...)``: forces named sites to given values.
- ``condition(data=...)``: like substitute but marks sites observed.
- ``plate(name, size, dim=...)``: batch of conditionally independent draws
  (the reference's users write ``numpyro.plate`` models -- its utils
  flatten plated samples, /root/reference/src/dynode/utils/utils.py:45-61).
- ``mask(mask=...)`` / ``scale(scale=...)``: zero out (missing data) or
  temper enclosed sites' log-density contributions.

Everything here happens at Python trace time; handler overhead never appears
in the compiled XLA program.
"""

from collections import OrderedDict
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..dist import Distribution

_STACK: list = []


class Messenger:
    """Base handler: a context manager that rewrites site messages."""

    def __enter__(self):
        _STACK.append(self)
        return self

    def __exit__(self, exc_type, exc_value, tb):
        assert _STACK and _STACK[-1] is self
        _STACK.pop()

    def process_message(self, msg: Dict[str, Any]) -> None:
        """Mutate ``msg`` before the site's default behavior runs."""

    def postprocess_message(self, msg: Dict[str, Any]) -> None:
        """Observe the finished ``msg`` (e.g. to record it)."""


class seed(Messenger):
    """Provide fresh PRNG keys to sites that need one."""

    def __init__(self, rng_seed=0):
        if isinstance(rng_seed, int):
            self.rng_key = jax.random.PRNGKey(rng_seed)
        else:
            self.rng_key = rng_seed

    def process_message(self, msg):
        """Apply this handler's effect to an incoming site message."""
        if msg["type"] == "sample" and msg["rng_key"] is None and msg["value"] is None:
            self.rng_key, site_key = jax.random.split(self.rng_key)
            msg["rng_key"] = site_key


class trace(Messenger):
    """Record every site into an OrderedDict (``with trace() as tr:``)."""

    def __init__(self):
        self.sites: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()

    def __enter__(self):
        super().__enter__()
        self.sites = OrderedDict()
        return self.sites

    def postprocess_message(self, msg):
        """Observe/record the finalized site message."""
        name = msg["name"]
        if name in self.sites:
            raise ValueError(f"duplicate site name {name!r} in one model trace")
        self.sites[name] = dict(msg)

    def get_trace(self, model, *args, **kwargs):
        """Run ``model`` under this handler, returning the recorded sites."""
        with self as sites:
            model(*args, **kwargs)
        return sites


class substitute(Messenger):
    """Force named sample/param sites to the provided values."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        self.data = data or {}

    def process_message(self, msg):
        """Apply this handler's effect to an incoming site message."""
        if msg["type"] in ("sample", "param") and msg["value"] is None:
            if msg["name"] in self.data:
                msg["value"] = self.data[msg["name"]]


class condition(Messenger):
    """Force named sample sites to values AND mark them observed."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        self.data = data or {}

    def process_message(self, msg):
        """Apply this handler's effect to an incoming site message."""
        if msg["type"] == "sample" and msg["name"] in self.data:
            msg["value"] = self.data[msg["name"]]
            msg["is_observed"] = True


class block(Messenger):
    """Hide inner sites from handlers stacked *outside* this one.

    Used around internal model traces (guide setup, log-density evaluation,
    predictive replay) so their sites don't leak into a user's surrounding
    trace -- same role as numpyro.handlers.block.
    """

    def __init__(self, hide_fn=None):
        self.hide_fn = hide_fn or (lambda msg: True)


class reparam(Messenger):
    """Rewrite sample sites through reparameterization strategies.

    ``config`` maps site names to strategies (see
    :mod:`dynode_tpu.infer.reparam`): the strategy draws auxiliary
    site(s) -- e.g. ``{name}_decentered`` -- and the original site
    becomes a zero-density Delta at the deterministically recomputed
    value, so inference runs in the auxiliary geometry (non-centered
    hierarchical models, base-space sampling of transformed priors).
    The auxiliary sites inherit enclosing plates/substitutions because
    they are ordinary :func:`sample` calls.
    """

    def __init__(self, config: Dict[str, Any]):
        self.config = dict(config)

    def process_message(self, msg):
        """Apply this handler's effect to an incoming site message."""
        if msg["type"] != "sample" or msg["is_observed"]:
            return
        strategy = self.config.get(msg["name"])
        if strategy is None or msg.get("_reparam_done"):
            return
        new_fn, value = strategy(msg["name"], msg["fn"])
        msg["fn"] = new_fn
        msg["value"] = value
        msg["_reparam_done"] = True


class do(Messenger):
    """Pearl-style intervention on sample sites (numpyro.handlers.do parity).

    ``with do(data={"r0": 2.5}):`` severs the edge from the site ``r0``
    into its children: every downstream consumer of the site's return
    value receives the intervention value instead of the stochastic draw,
    while the original stochastic site is still executed under its own
    name (sampled / substituted / inferred exactly as without ``do``) so
    the joint density over latents is unchanged. This is the scenario
    counterfactual the reference's users run by hand (fit a posterior,
    then replay forward with a policy-pinned parameter): combine a fitted
    :class:`~dynode_tpu.infer.predictive.Predictive` with ``do`` to
    answer "what would incidence have been had r0 been 2.5?".

    Mechanics mirror numpyro's: the intervened message is rewritten to a
    no-density site named ``{name}__do`` recording the intervention (here
    a ``deterministic`` site -- numpyro uses an observed stopped sample
    site; both contribute zero density and land in the trace), and the
    untouched original message is replayed through the full handler stack.
    With nested ``do`` handlers intervening on the same site, the
    innermost wins.
    """

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        self.data = dict(data or {})

    def process_message(self, msg):
        """Apply this handler's effect to an incoming site message."""
        if msg["type"] != "sample" or msg.get("_do_original"):
            return
        if msg["name"] not in self.data:
            return
        # Replay the undisturbed stochastic node under its original name.
        # A FRESH message (not a copy of the in-flight, partially-handled
        # one): inner handlers re-run on it, so shared mutable state
        # (cond_indep_stack) is rebuilt rather than aliased.
        orig = {
            "type": "sample",
            "name": msg["name"],
            "fn": msg["fn"],
            "value": msg["value"] if msg["is_observed"] else None,
            "is_observed": msg["is_observed"],
            "rng_key": msg["rng_key"],
            "sample_shape": msg.get("sample_shape", ()),
            "_do_original": True,
        }
        _apply_stack(orig)
        # The in-flight message becomes the intervention carrier.
        msg["type"] = "deterministic"
        msg["name"] = msg["name"] + "__do"
        msg["fn"] = None
        msg["value"] = self.data[orig["name"]]
        msg["is_observed"] = False
        msg["rng_key"] = None


class uncondition(Messenger):
    """Make observed sample sites latent again (pyro.poutine.uncondition).

    Inside this handler every ``sample(..., obs=data)`` statement draws a
    FRESH value from its distribution instead of returning the data --
    the building block for genuine posterior-predictive replicates
    (:class:`~dynode_tpu.infer.predictive.Predictive` with
    ``uncondition_observed=True``): replaying a model with its original
    observation kwargs still passed would otherwise just echo the data
    back (an observed site's value IS the data -- numpyro contract).
    The original observation is kept on the message as
    ``_observed_value`` for introspection.

    Nest INSIDE :class:`seed` (``with seed(...): with uncondition(): ...``
    or the equivalent single ``with`` clause order): handlers run
    innermost-first, and seed only keys sites whose value is still unset,
    so an uncondition stacked *outside* seed clears the value after seed
    already skipped the site — the sample then fails with a
    missing-rng_key error.
    """

    def process_message(self, msg):
        """Apply this handler's effect to an incoming site message."""
        if msg["type"] == "sample" and msg["is_observed"]:
            obs_shape = jnp.shape(msg["value"])
            fn = msg["fn"]
            # a likelihood often broadcasts scalar params against the data
            # (sample("x", Normal(mu, 1), obs=series)); the replicate must
            # keep the data's layout, so expand the fn to the observed
            # batch shape before the fresh draw
            batch_obs = obs_shape[: len(obs_shape) - len(fn.event_shape)]
            target = np.broadcast_shapes(batch_obs, fn.batch_shape)
            if tuple(target) != tuple(fn.batch_shape):
                msg["fn"] = fn.expand(target)
            msg["_observed_value"] = msg["value"]
            msg["value"] = None
            msg["is_observed"] = False


class mask(Messenger):
    """Mask log-density contributions of enclosed sample sites.

    numpyro.handlers.mask parity: where the (boolean, broadcastable)
    mask is False the site's elementwise log-prob contributes ZERO to
    the joint -- the standard missing-data idiom for surveillance series
    with reporting gaps. Sampling draws are unaffected. Nested masks
    compose with logical AND.
    """

    def __init__(self, mask):
        self.mask = mask

    def process_message(self, msg):
        """Apply this handler's effect to an incoming site message."""
        if msg["type"] == "sample":
            m = jnp.asarray(self.mask, dtype=bool)
            prev = msg.get("mask")
            msg["mask"] = m if prev is None else jnp.logical_and(prev, m)


class scale(Messenger):
    """Scale log-density contributions of enclosed sample sites.

    numpyro.handlers.scale parity: multiplies each enclosed site's
    log-prob by a positive factor (likelihood tempering, importance
    reweighting). Nested scales multiply.
    """

    def __init__(self, scale):
        self.scale = scale

    def process_message(self, msg):
        """Apply this handler's effect to an incoming site message."""
        if msg["type"] == "sample":
            msg["scale"] = msg.get("scale", 1.0) * self.scale


def _feasible_value(fn, value):
    """An always-in-support fill for masked-out entries (numpyro's
    ``feasible_like`` role): ``biject_to(support)(0)`` lands inside any
    continuous support; discrete/count supports (where biject_to has no
    bijector) all admit 0."""
    try:
        from ..dist.transforms import biject_to

        t = biject_to(fn.support)
        return jnp.broadcast_to(
            t(jnp.zeros((), dtype=jnp.result_type(value, jnp.float32))),
            jnp.shape(value),
        ).astype(jnp.result_type(value))
    except Exception:
        return jnp.zeros_like(value)


def weighted_log_prob(site, center=None):
    """A sample site's elementwise log-prob with mask/scale applied.

    ``center`` (optional per-element constants, see
    :func:`~dynode_tpu.infer.util.log_density`) is subtracted before
    weighting; since mask and scale are fixed for a given model, the
    shift stays a constant of the density either way.

    Masked entries never reach ``log_prob`` (double-where): the value is
    first replaced with an in-support fill, then the log-prob is zeroed.
    A single where would leave the FORWARD density finite but poison the
    GRADIENT when masked entries hold NaN (where's VJP zeroes the
    cotangent, and 0 * d(log_prob(NaN)) = NaN) -- so NaN-encoded
    reporting gaps are safe observation placeholders.
    """
    value = site["value"]
    m = site.get("mask")
    if m is not None:
        value = jnp.where(m, value, _feasible_value(site["fn"], value))
    lp = site["fn"].log_prob(value)
    if center is not None:
        lp = lp - center
    if m is not None:
        lp = jnp.where(m, lp, jnp.zeros((), dtype=lp.dtype))
    s = site.get("scale")
    if s is not None:
        lp = lp * s
    return lp


class plate(Messenger):
    """Batch dimension of conditionally independent sample draws.

    ``with plate("strain", 3):`` gives every enclosed sample site an extra
    batch dimension of size 3 (independent draws; log-probs sum over it in
    the joint, which is exactly how the flat sum in
    :func:`~dynode_tpu.infer.util.log_density` treats batch dims). Nested
    plates stack dims right-to-left; ``dim=`` (negative, counting from the
    right of the batch shape) pins a dimension explicitly -- numpyro.plate
    semantics, which the reference's model-authoring docs assume (its
    ``flatten_list_parameters`` exists to post-process plated samples,
    /root/reference/src/dynode/utils/utils.py:45-61).

    Data subsampling (``subsample_size < size``) is not implemented: the
    reference never subsamples, and on an accelerator the full-data likelihood is the
    fast path (one fused reduction; gather-based minibatching would add
    host round-trips for no win at epi-model data sizes).
    """

    def __init__(self, name: str, size: int, subsample_size=None, dim=None):
        if int(size) <= 0:
            raise ValueError(f"plate {name!r} needs a positive size, got {size}")
        if subsample_size is not None and subsample_size != size:
            raise NotImplementedError(
                "plate subsampling is not supported (the full-data "
                "likelihood is the fast path); use subsample_size=None"
            )
        if dim is not None and dim >= 0:
            raise ValueError(f"plate dim must be negative, got {dim}")
        self.name = name
        self.size = int(size)
        self.dim = dim
        self._explicit_dim = dim is not None

    def __enter__(self):
        occupied = {p.dim for p in _STACK if isinstance(p, plate)}
        if self._explicit_dim:
            if self.dim in occupied:
                raise ValueError(
                    f"plate {self.name!r}: dim {self.dim} is already taken "
                    "by an enclosing plate"
                )
        else:
            d = -1
            while d in occupied:
                d -= 1
            self.dim = d
        return super().__enter__()

    def __exit__(self, exc_type, exc_value, tb):
        super().__exit__(exc_type, exc_value, tb)
        if not self._explicit_dim:
            self.dim = None

    def process_message(self, msg):
        """Apply this handler's effect to an incoming site message."""
        if msg["type"] == "sample":
            msg.setdefault("cond_indep_stack", []).append(
                (self.name, self.size, self.dim)
            )


def _expand_for_plates(msg) -> None:
    """Broadcast a sample site's distribution over its enclosing plates."""
    stack = msg.get("cond_indep_stack")
    fn = msg["fn"]
    if not stack or not isinstance(fn, Distribution):
        return
    ndim = max(-d for (_, _, d) in stack)
    plate_shape = [1] * ndim
    for _, size, d in stack:
        plate_shape[d] = size
    target = jnp.broadcast_shapes(tuple(plate_shape), fn.batch_shape)
    if target != fn.batch_shape:
        msg["fn"] = fn.expand(target)


def _active_handlers(msg):
    """Handlers that see ``msg``, innermost-first.

    Walk outward from the innermost handler; the first ``block`` whose
    ``hide_fn`` hides this message stops the walk, so everything stacked
    outside it sees nothing. A block that does NOT hide the message is
    transparent for it, but handlers beyond it are still subject to any
    *outer* blocks' own hide_fns (a selective inner block must not
    disable an outer hide-all block -- that outer block exists precisely
    so internal sites cannot leak into a user's surrounding trace).
    """
    active = []
    for i in range(len(_STACK) - 1, -1, -1):
        h = _STACK[i]
        if isinstance(h, block) and h.hide_fn(msg):
            break
        active.append(h)
    return active


def _apply_stack(msg: Dict[str, Any]) -> Dict[str, Any]:
    active = _active_handlers(msg)  # innermost-first
    # innermost handlers get the first say (e.g. an inner substitute wins)
    for handler in active:
        handler.process_message(msg)

    if msg["type"] == "sample":
        _expand_for_plates(msg)
    if msg["type"] == "sample" and msg["value"] is None:
        if msg["is_observed"]:
            raise RuntimeError("observed sample site lost its value")
        if msg["rng_key"] is None:
            raise ValueError(
                f"site {msg['name']!r} needs an rng_key: run the model under "
                "handlers.seed(...) or pass rng_key= to sample(). (If "
                "handlers.uncondition made this site latent, nest it INSIDE "
                "handlers.seed -- seed runs innermost-first and skips sites "
                "whose value is still set.)"
            )
        msg["value"] = msg["fn"].sample(
            msg["rng_key"], msg.get("sample_shape", ())
        )
    if msg["type"] == "param" and msg["value"] is None:
        msg["value"] = msg["init_value"]

    # outermost-last for postprocess (trace handlers record finished sites)
    for handler in reversed(active):
        handler.postprocess_message(msg)
    return msg


def sample(
    name: str,
    fn: Distribution,
    obs=None,
    rng_key=None,
    sample_shape=(),
):
    """Declare a random variable (or observe data against a likelihood).

    Site-name semantics match numpyro's ``numpyro.sample`` as the reference
    uses it (src/dynode/infer/sample.py:72-76).
    """
    if not _STACK and obs is None:
        if rng_key is None:
            raise ValueError(
                f"sample site {name!r} called outside an inference context "
                "without an rng_key"
            )
        return fn.sample(rng_key, sample_shape)
    msg = {
        "type": "sample",
        "name": name,
        "fn": fn,
        "value": obs,
        "is_observed": obs is not None,
        "rng_key": rng_key,
        "sample_shape": tuple(sample_shape),
    }
    return _apply_stack(msg)["value"]


def factor(name: str, log_factor):
    """Add an arbitrary term to the joint log-density (numpyro.factor).

    Implemented as an observed sample site over a :class:`~..dist.Unit`
    distribution whose ``log_prob`` is the factor itself.
    """
    from ..dist.distribution import Unit

    unit = Unit(log_factor)
    sample(name, unit, obs=unit.sample(None))


def deterministic(name: str, value):
    """Record a derived value as a named trace site (no density)."""
    if not _STACK:
        return value
    msg = {
        "type": "deterministic",
        "name": name,
        "fn": None,
        "value": value,
        "is_observed": False,
        "rng_key": None,
    }
    return _apply_stack(msg)["value"]


def param(name: str, init_value=None):
    """Declare a learnable parameter site (used by SVI guides)."""
    if not _STACK:
        return init_value
    msg = {
        "type": "param",
        "name": name,
        "fn": None,
        "value": None,
        "init_value": init_value,
        "is_observed": False,
        "rng_key": None,
    }
    return _apply_stack(msg)["value"]


__all__ = [
    "Messenger",
    "seed",
    "trace",
    "substitute",
    "condition",
    "block",
    "do",
    "uncondition",
    "plate",
    "mask",
    "scale",
    "reparam",
    "weighted_log_prob",
    "sample",
    "factor",
    "deterministic",
    "param",
]
