"""Implicit (ESDIRK) solvers for stiff compartmental systems.

The reference accepts any ``diffrax.AbstractSolver`` -- including implicit
ones -- in ``SolverParams.solver_method``
(/root/reference/src/dynode/config/params.py:28-35); this module supplies
the in-repo stiff capability: L-stable singly-diagonally-implicit RK
schemes driven by a simplified Newton iteration.

Design decisions:

- **One Jacobian per step, one LU per distinct diagonal**: simplified
  Newton evaluates ``J = df/dy`` once at the step start (``jax.jacfwd`` --
  forward mode, cheap at compartmental state sizes) and factors
  ``I - dt*g*J`` once per distinct diagonal entry; ESDIRK tableaus reuse the
  same ``g`` on every implicit stage, so each step does exactly ONE dense
  factorization regardless of stage count.
- **Fixed-trip Newton** (``lax.fori_loop``, default 6 iterations): no
  data-dependent control flow, so steps stay reverse-differentiable (the
  engine's checkpointed scan backprops through the unrolled iterations --
  the implicit-function gradient to Newton's converged fixed point) and
  vmap across an ensemble stays lockstep. A diverged Newton yields NaN,
  which the PID controller rejects (``nan <= 1.0`` is False), shrinking dt.
- **Pytree-flattening boundary**: the dense linear algebra runs on the
  raveled state vector; the integrator keeps seeing pytrees.

Both solvers are stiffly accurate (last stage row == b), so the final
stage derivative IS ``f(t1, y1)`` and the engine's FSAL carry applies.
"""

import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.flatten_util import ravel_pytree

from .solvers import AbstractSolver, ODETerm


class AbstractImplicitSolver(AbstractSolver):
    """ESDIRK base: explicit first stage, shared diagonal ``g`` after.

    Subclasses define the explicit-RK tableau attributes of
    :class:`AbstractSolver` (``c``, strictly-lower ``a``, ``b``, ``e``)
    plus ``diag``: the per-stage diagonal entries (0.0 marks an explicit
    stage).
    """

    diag: Tuple[float, ...]
    newton_iters: int = 6

    def step_inc(self, term: ODETerm, t, dt, y, args, f0=None):
        # difference fallback: implicit stages solve for y1 directly, so the
        # raw increment is not separately available; compensated summation
        # degrades gracefully (Sterbenz-exact for small steps) rather than
        # being refused for stiff solvers
        """Increment form via difference (implicit stages solve for ``y1``)."""
        y1, err, f1 = self.step(term, t, dt, y, args, f0=f0)
        inc = jax.tree_util.tree_map(lambda a, b: a - b, y1, y)
        return inc, err, f1

    def step(self, term: ODETerm, t, dt, y, args, f0=None):
        """One ESDIRK step: simplified-Newton stage solves + embedded error."""
        yflat, unravel = ravel_pytree(y)
        n = yflat.shape[0]
        dtype = yflat.dtype

        def fvec(s, zflat):
            return ravel_pytree(term.vf(s, unravel(zflat), args))[0]

        # simplified Newton: one Jacobian at the step start, shared by all
        # stages; one LU per distinct diagonal value
        jac = jax.jacfwd(lambda z: fvec(t, z))(yflat)
        eye = jnp.eye(n, dtype=dtype)
        lu_cache = {}

        ks = []
        for i in range(self.stages):
            ti = t + self.c[i] * dt
            pred = yflat
            if i >= 1:
                for j, aij in enumerate(self.a[i - 1]):
                    if aij != 0.0:
                        pred = pred + (dt * aij) * ks[j]
            g = float(self.diag[i])
            if g == 0.0:
                if i == 0 and f0 is not None:
                    k = ravel_pytree(f0)[0]
                else:
                    k = fvec(ti, pred)
            else:
                if g not in lu_cache:
                    lu_cache[g] = jax.scipy.linalg.lu_factor(
                        eye - (dt * g) * jac
                    )
                lu = lu_cache[g]
                k0 = ks[-1] if ks else fvec(t, yflat)
                dtg = dt * g

                def newton(_, k, ti=ti, pred=pred, lu=lu, dtg=dtg):
                    resid = k - fvec(ti, pred + dtg * k)
                    return k - jax.scipy.linalg.lu_solve(lu, resid)

                k = jax.lax.fori_loop(0, self.newton_iters, newton, k0)
            ks.append(k)

        y1 = yflat
        for j, bj in enumerate(self.b):
            if bj != 0.0:
                y1 = y1 + (dt * bj) * ks[j]
        if self.e is not None:
            errflat = jnp.zeros_like(yflat)
            for j, ej in enumerate(self.e):
                if ej != 0.0:
                    errflat = errflat + (dt * ej) * ks[j]
            err = unravel(errflat)
        else:
            err = None
        f1 = unravel(ks[-1]) if self.fsal else None
        return unravel(y1), err, f1


class ImplicitEuler(AbstractImplicitSolver):
    """Backward Euler 1(1), L-stable, stiffly accurate.

    The embedded estimate is the implicit-vs-explicit Euler difference
    ``dt*(k_impl - k_expl)`` = O(dt^2), the standard cheap estimator for a
    first-order implicit method.
    """

    c = np.array([0.0, 1.0])
    a = ((0.0,),)
    diag = (0.0, 1.0)
    b = (0.0, 1.0)
    e = (-1.0, 1.0)
    order = 1
    err_order = 2
    fsal = True


def _trbdf2_tableau():
    """TR-BDF2 as a 3-stage stiffly-accurate ESDIRK (gamma = 2 - sqrt(2)).

    Stage 2 is one trapezoidal half-step to t + gamma*dt; stage 3 is the
    BDF2 corrector to t + dt. The embedded weights solve the 3rd-order
    quadrature conditions (Vandermonde at nodes c = [0, gamma, 1]), giving
    an O(dt^3)-different companion for the error estimate.
    """
    gamma = 2.0 - math.sqrt(2.0)
    d = gamma / 2.0
    w = math.sqrt(2.0) / 4.0
    c = np.array([0.0, gamma, 1.0])
    a = ((d,), (w, w))
    diag = (0.0, d, d)
    b = (w, w, d)
    # bhat: sum bhat = 1, sum bhat*c = 1/2, sum bhat*c^2 = 1/3
    vander = np.vander(c, increasing=True).T  # rows: c^0, c^1, c^2
    bhat = np.linalg.solve(vander, np.array([1.0, 1.0 / 2.0, 1.0 / 3.0]))
    e = tuple(float(bi - bh) for bi, bh in zip(b, bhat))
    return c, a, diag, b, e


_TRBDF2_C, _TRBDF2_A, _TRBDF2_DIAG, _TRBDF2_B, _TRBDF2_E = _trbdf2_tableau()


class TRBDF2(AbstractImplicitSolver):
    """TR-BDF2 2(3): L-stable one-step ESDIRK, the workhorse stiff solver.

    Trapezoidal rule to ``t + (2-sqrt(2))*dt`` then BDF2 to ``t + dt``
    (Bank et al. 1985 composite scheme in its ESDIRK form). Use for
    compartmental models with fast transients (rapid waning chains,
    near-equilibrium seasonal forcing) where Tsit5's stability limit --
    not accuracy -- pins the step size.
    """

    c = _TRBDF2_C
    a = _TRBDF2_A
    diag = _TRBDF2_DIAG
    b = _TRBDF2_B
    e = _TRBDF2_E
    order = 2
    err_order = 3
    fsal = True


__all__ = ["AbstractImplicitSolver", "ImplicitEuler", "TRBDF2"]
