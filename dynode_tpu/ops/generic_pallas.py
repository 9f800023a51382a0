"""Whole-solve ensemble integrator for a user rows-RHS.

Each ensemble member keeps its state on chip for the entire solve: one
Pallas program (on the ``backend="triton"`` route) owns a power-of-two
block of members, holds every state row as a register vector, steps
through time with a ``fori_loop`` inside the kernel, and writes only the
save grid to device memory. XLA's ``lax.scan`` over the same math launches
kernels at every step and sends the state through device memory at every
stage; keeping it resident is what the kernel is for.

The rows contract:

    def rhs(y: list[Array], p: list[Array], t: Array) -> list[Array]

``y`` is a list of R state rows, each a ``(block,)`` f32 vector over the
members; ``p`` a list of P parameter rows; ``t`` a scalar. Structure
dimensions (ages, strains, compartments) are *Python loops over rows*;
only the ensemble axis is vectorized (``models.multistrain.MultistrainRowsRHS``
is a complete example). Two constraints come from tracing the RHS into a
kernel:

- the RHS must not capture traced *arrays* from the closure (Python
  scalars are fine); per-member or shared array parameters go in
  ``p_rows``,
- no data-dependent Python control flow (it is traced once per stage).

Which implementation runs is decided in one place, :func:`kernel_route`:
the compiled Triton kernel on a GPU, the ``lax`` reference (the same math
as one ``lax.scan``) on the CPU, and an error anywhere else. Tests run the
kernel on the CPU with ``interpret=True``.

Reference parity: this replaces the reference's diffrax ``diffeqsolve``
constant-step path for ensemble workloads
(CDCgov/DynODE/src/dynode/simulation/odes.py:133);
``ensemble_solve_kernel_adaptive`` covers its DEFAULT (adaptive) solve
mode with a per-block lockstep controller.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..ode.solvers import Bosh3, Tsit5

__all__ = [
    "ensemble_solve_kernel",
    "ensemble_solve_kernel_adaptive",
    "ensemble_solve_kernel_adaptive_reference",
    "ensemble_solve_kernel_reference",
    "kernel_route",
    "launch_config",
    "pack_rows",
    "unpack_rows",
]

# classic RK4 (diagonal tableau)
_RK4_A = ((0.5,), (0.0, 0.5), (0.0, 0.0, 1.0))
_RK4_B = (1 / 6, 1 / 3, 1 / 3, 1 / 6)
_RK4_C = (0.0, 0.5, 0.5, 1.0)

#: method -> (a, b, c, n_stages); FSAL schemes are truncated to the stages
#: that contribute to the constant-step update (Tsit5's 7th / Bosh3's 4th
#: stage has b == 0 and only feeds the embedded error estimate)
_METHODS = {
    "tsit5": (Tsit5.a, Tsit5.b, tuple(float(x) for x in Tsit5.c), 6),
    "bosh3": (Bosh3.a, Bosh3.b, tuple(float(x) for x in Bosh3.c), 3),
    "rk4": (_RK4_A, _RK4_B, _RK4_C, 4),
}

#: adaptive method -> (a, b, e, c, n_stages, err_order); both are FSAL
#: pairs (last stage = f(t+dt, y_new), b[last] == 0, feeds only the
#: embedded error). bosh3 is the default: 3 RHS evals per steady-state
#: attempt with the FSAL carry.
_ADAPTIVE_METHODS = {
    "tsit5": (Tsit5.a, Tsit5.b, Tsit5.e,
              tuple(float(x) for x in Tsit5.c), 7, float(Tsit5.err_order)),
    "bosh3": (Bosh3.a, Bosh3.b, Bosh3.e,
              tuple(float(x) for x in Bosh3.c), 4, float(Bosh3.err_order)),
}


# ---------------------------------------------------------------------------
# the selection point and the launch rule
# ---------------------------------------------------------------------------


def kernel_route(platform: str | None = None) -> str:
    """How an ``ops`` whole-solve entry point runs on ``platform``.

    ``"triton"`` (the compiled Pallas kernel) on ``"gpu"``; ``"lax"`` (the
    reference, which is the CPU implementation) on ``"cpu"``. Any other
    platform is an error: there is no silent fallback. ``platform``
    defaults to ``jax.default_backend()``.
    """
    platform = jax.default_backend() if platform is None else platform
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return "lax"
    raise ValueError(
        f"no whole-solve route for platform {platform!r}; "
        "supported: 'gpu' (Triton kernel), 'cpu' (lax)"
    )


#: members per Pallas program and warps per program. Each member is one
#: thread: a program of ``block_b`` members runs ``block_b // 32`` warps, so
#: every state row is one register per thread and no thread holds two
#: members' stages (Tsit5 on 26 rows already keeps ~240 floats live).
DEFAULT_BLOCK_B = 128


def launch_config(batch: int, block_b: int | None = None) -> tuple[int, int]:
    """``(block_b, num_warps)`` for a ``batch``-wide solve.

    ``block_b`` must be a power of two (Triton's block rule); None picks
    :data:`DEFAULT_BLOCK_B`, or the next power of two at or above ``batch``
    when the whole ensemble is smaller than one block. A batch that is not
    a multiple of ``block_b`` is padded by the entry points.
    """
    if block_b is None:
        block_b = min(DEFAULT_BLOCK_B, max(32, 1 << (batch - 1).bit_length()))
    block_b = int(block_b)
    if block_b < 1 or block_b & (block_b - 1):
        raise ValueError(f"block_b must be a power of two, got {block_b}")
    return block_b, max(1, min(8, block_b // 32))


def _pad_members(x, padded: int):
    """Pad the member (last) axis to ``padded`` by repeating the last member.

    A copy of an existing member leaves every block's max error norm -- and
    so the adaptive controller's decisions -- unchanged.
    """
    extra = padded - x.shape[-1]
    if not extra:
        return x
    return jnp.concatenate(
        [x, jnp.broadcast_to(x[..., -1:], (*x.shape[:-1], extra))], axis=-1
    )


# ---------------------------------------------------------------------------
# pytree <-> rows packing helpers
# ---------------------------------------------------------------------------


def pack_rows(leaves: Sequence[jnp.ndarray], batch: int):
    """Member-last leaves ``(*struct, B)`` -> packed ``(R, B)`` + spec.

    Leaves with no batch axis (shared across members) are broadcast.
    Returns ``(packed, spec)`` where ``spec`` is the per-leaf struct-shape
    list consumed by :func:`unpack_rows`.
    """
    rows, spec = [], []
    for leaf in leaves:
        leaf = jnp.asarray(leaf, jnp.float32)
        if leaf.ndim == 0 or leaf.shape[-1] != batch:
            leaf = jnp.broadcast_to(leaf[..., None], (*leaf.shape, batch))
        struct = leaf.shape[:-1]
        spec.append(struct)
        rows.append(leaf.reshape(-1, batch))
    return jnp.concatenate(rows, axis=0), tuple(spec)


def unpack_rows(packed: jnp.ndarray, spec) -> list[jnp.ndarray]:
    """Inverse of :func:`pack_rows`; accepts ``(R, B)`` or ``(T, R, B)``."""
    out, off = [], 0
    lead = packed.shape[:-2]
    batch = packed.shape[-1]
    for struct in spec:
        size = int(np.prod(struct, dtype=int)) if struct else 1
        blk = packed[..., off : off + size, :]
        out.append(blk.reshape(*lead, *struct, batch))
        off += size
    return out


# ---------------------------------------------------------------------------
# one RK step on rows (shared by kernel and reference -- single math source)
# ---------------------------------------------------------------------------


def _rk_step_rows(rhs, y, p, t, dt, a, b, c, n_stages):
    n_rows = len(y)
    ks = []
    for stage in range(n_stages):
        if stage == 0:
            y_stage = y
        else:
            coeffs = a[stage - 1]
            y_stage = [
                y[r]
                + dt
                * sum(
                    coeffs[j] * ks[j][r]
                    for j in range(stage)
                    if coeffs[j] != 0.0
                )
                for r in range(n_rows)
            ]
        ks.append(rhs(y_stage, p, t + c[stage] * dt))
    return [
        y[r] + dt * sum(b[j] * ks[j][r] for j in range(n_stages) if b[j] != 0.0)
        for r in range(n_rows)
    ]


def _rk_embedded_step_rows(rhs, y, p, t, dt, a, b, e, c, n_stages, f0):
    """One embedded FSAL RK attempt on rows: (y_new, err_rows, k_last).

    ``f0`` is the first stage ``f(t, y)``, carried by the caller: after an
    ACCEPT the returned ``k_last`` (evaluated at ``y_new``) IS the next
    attempt's first stage, and after a REJECT ``(t, y)`` are unchanged so
    the old first stage is still exact (First Same As Last). A steady-state
    BS3 attempt therefore costs 3 RHS evaluations, not 4.
    """
    n_rows = len(y)
    n_sub = n_stages - 1
    ks = [list(f0)]
    for stage in range(1, n_sub):
        coeffs = a[stage - 1]
        y_stage = [
            y[r]
            + dt
            * sum(coeffs[j] * ks[j][r] for j in range(stage) if coeffs[j] != 0.0)
            for r in range(n_rows)
        ]
        ks.append(rhs(y_stage, p, t + c[stage] * dt))
    y_new = [
        y[r] + dt * sum(b[j] * ks[j][r] for j in range(n_sub) if b[j] != 0.0)
        for r in range(n_rows)
    ]
    k_last = list(rhs(y_new, p, t + c[n_stages - 1] * dt))
    ks.append(k_last)
    err = [
        dt * sum(e[j] * ks[j][r] for j in range(n_stages) if e[j] != 0.0)
        for r in range(n_rows)
    ]
    return y_new, err, k_last


def _check_save_rows(save_rows, n_rows):
    """Normalize/validate a ``save_rows`` selection to a static tuple."""
    if save_rows is None:
        return tuple(range(n_rows))
    rows = tuple(int(r) for r in save_rows)
    if not rows:
        raise ValueError("save_rows must select at least one row")
    for r in rows:
        if not 0 <= r < n_rows:
            raise ValueError(
                f"save_rows index {r} out of range for {n_rows} state rows"
            )
    return rows


def _check_rows(y0_rows, p_rows):
    y0_rows = jnp.asarray(y0_rows, jnp.float32)
    if y0_rows.ndim != 2:
        raise ValueError(f"y0_rows must be (R, B), got {y0_rows.shape}")
    if p_rows is None:
        p_rows = jnp.zeros((0, y0_rows.shape[1]), jnp.float32)
    return y0_rows, jnp.asarray(p_rows, jnp.float32)


def _pallas(kernel, y0_rows, p_rows, out_shapes, out_specs, *, block_b,
            num_warps, interpret):
    """Launch ``kernel`` over member blocks on the Triton route."""
    n_rows, batch = y0_rows.shape
    # a program loads parameter rows one at a time; an empty parameter
    # array still needs a (dummy) row to have a block
    if p_rows.shape[0] == 0:
        p_rows = jnp.zeros((1, batch), jnp.float32)
    return pl.pallas_call(
        kernel,
        out_shape=out_shapes,
        grid=(batch // block_b,),
        in_specs=[
            pl.BlockSpec((n_rows, block_b), lambda i: (0, i)),
            pl.BlockSpec((p_rows.shape[0], block_b), lambda i: (0, i)),
        ],
        out_specs=out_specs,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps),
        interpret=interpret,
        name="dynode_whole_solve",
    )(y0_rows, p_rows)


# ---------------------------------------------------------------------------
# constant step
# ---------------------------------------------------------------------------


def _solve_kernel(
    y_ref, p_ref, out_ref, *, rhs, n_rows, n_params, dt, t0, n_outer,
    save_stride, tableau, save_rows,
):
    a, b, c, n_stages = tableau
    p = [p_ref[r, :] for r in range(n_params)]

    def save(slot, rows):
        for j, r in enumerate(save_rows):
            pltriton.store(out_ref.at[slot, j, :], rows[r].astype(out_ref.dtype))

    def inner(_, carry):
        rows, t = carry
        rows = _rk_step_rows(rhs, list(rows), p, t, dt, a, b, c, n_stages)
        return tuple(rows), t + dt

    def outer(slot, carry):
        carry = jax.lax.fori_loop(0, save_stride, inner, carry)
        save(slot, carry[0])
        return carry

    y = tuple(y_ref[r, :] for r in range(n_rows))
    save(0, y)
    jax.lax.fori_loop(1, n_outer + 1, outer, (y, jnp.float32(t0)))


@functools.partial(
    jax.jit,
    static_argnames=("rhs", "dt", "n_steps", "save_stride", "block_b",
                     "num_warps", "method", "t0", "save_dtype", "save_rows",
                     "interpret"),
)
def _solve_pallas(
    y0_rows, p_rows, *, rhs, dt, n_steps, save_stride, block_b, num_warps,
    method, t0, save_dtype, save_rows, interpret=False,
):
    n_rows, batch = y0_rows.shape
    padded = -(-batch // block_b) * block_b
    n_outer = n_steps // save_stride
    kernel = functools.partial(
        _solve_kernel, rhs=rhs, n_rows=n_rows, n_params=p_rows.shape[0],
        dt=dt, t0=t0, n_outer=n_outer, save_stride=save_stride,
        tableau=_METHODS[method], save_rows=save_rows,
    )
    n_save = len(save_rows)
    out = _pallas(
        kernel, _pad_members(y0_rows, padded), _pad_members(p_rows, padded),
        jax.ShapeDtypeStruct((n_outer + 1, n_save, padded), save_dtype),
        pl.BlockSpec((n_outer + 1, n_save, block_b), lambda i: (0, 0, i)),
        block_b=block_b, num_warps=num_warps, interpret=interpret,
    )
    return out if padded == batch else out[..., :batch]


def ensemble_solve_kernel(
    rhs: Callable,
    y0_rows: jnp.ndarray,
    p_rows: jnp.ndarray | None = None,
    *,
    duration: float,
    dt: float,
    save_every: float = 1.0,
    block_b: int | None = None,
    method: str = "tsit5",
    t0: float = 0.0,
    save_dtype=jnp.float32,
    save_rows: Sequence[int] | None = None,
    interpret: bool = False,
):
    """Constant-step whole-solve ensemble integrator for a user rows-RHS.

    Parameters
    ----------
    rhs: ``rhs(y_rows, p_rows, t) -> dy_rows`` in the rows idiom (module
        docstring). Traced once per RK stage. Pass the same (hashable)
        object on every call: it is part of the compiled program's key.
    y0_rows: ``(R, B)`` f32 initial state (use :func:`pack_rows`).
    p_rows: ``(P, B)`` f32 parameter rows, or None.
    duration, dt, save_every: uniform save grid; ``duration/dt`` and
        ``save_every/dt`` must be whole.
    block_b: members per Pallas program, a power of two; None applies
        :func:`launch_config`. Member math does not depend on it.
    method: ``"tsit5"`` (default, matches SolverParams), ``"bosh3"``,
        ``"rk4"``.
    save_dtype: dtype of the save buffer; ``jnp.bfloat16`` halves the
        ``(n_saves, rows, B)`` buffer (the solve stays f32; only the
        stored saves are rounded).
    save_rows: row indices to save (any order; default all R rows). The
        output buffer bounds the widest ensemble that fits in device
        memory, so saving only the observable rows (e.g. the
        cumulative-incidence rows of a fit) widens it.
    interpret: run the Pallas kernel in interpret mode on any platform
        (how the CPU tests exercise it). Otherwise :func:`kernel_route`
        chooses the compiled kernel (GPU) or the ``lax`` reference (CPU).

    Returns ``(n_saves, len(save_rows), B)`` saves in ``save_dtype``, rows
    in ``save_rows`` order (:func:`unpack_rows` for the full-rows case).
    """
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}; one of {list(_METHODS)}")
    y0_rows, p_rows = _check_rows(y0_rows, p_rows)
    n_rows, batch = y0_rows.shape
    n_steps = int(round(duration / dt))
    save_stride = int(round(save_every / dt))
    if abs(n_steps * dt - duration) > 1e-9 * max(1.0, abs(duration)):
        raise ValueError("duration must be a whole number of dt steps")
    if n_steps % save_stride:
        raise ValueError("save_every must divide duration into whole strides")
    save_rows = _check_save_rows(save_rows, n_rows)
    block_b, num_warps = launch_config(batch, block_b)

    if not interpret and kernel_route() == "lax":
        full = _reference_jit(
            rhs=rhs, y0_rows=y0_rows, p_rows=p_rows, duration=duration,
            dt=dt, save_every=save_every, method=method, t0=t0,
        )
        return full[:, list(save_rows), :].astype(save_dtype)
    return _solve_pallas(
        y0_rows, p_rows, rhs=rhs, dt=float(dt), n_steps=n_steps,
        save_stride=save_stride, block_b=block_b, num_warps=num_warps,
        method=method, t0=float(t0), save_dtype=jnp.dtype(save_dtype).name,
        save_rows=save_rows, interpret=bool(interpret),
    )


def ensemble_solve_kernel_reference(
    rhs, y0_rows, p_rows=None, *, duration, dt, save_every=1.0,
    method="tsit5", t0=0.0,
):
    """The kernel's computation as one ``lax.scan`` over save strides."""
    a, b, c, n_stages = _METHODS[method]
    y0_rows, p_rows = _check_rows(y0_rows, p_rows)
    n_rows = y0_rows.shape[0]
    p = [p_rows[r] for r in range(p_rows.shape[0])]
    n_steps = int(round(duration / dt))
    save_stride = int(round(save_every / dt))
    n_outer = n_steps // save_stride

    def inner(carry, _):
        rows, t = carry
        rows = _rk_step_rows(rhs, list(rows), p, t, dt, a, b, c, n_stages)
        return (tuple(rows), t + dt), None

    def outer(carry, _):
        carry, _ = jax.lax.scan(inner, carry, None, length=save_stride)
        return carry, jnp.stack(carry[0], axis=0)

    y = tuple(y0_rows[r] for r in range(n_rows))
    _, saves = jax.lax.scan(
        outer, (y, jnp.float32(t0)), None, length=n_outer
    )
    return jnp.concatenate([y0_rows[None], saves], axis=0)


#: the CPU route: one compiled program per configuration (the reference
#: itself re-traces its scans on every un-jitted call)
_reference_jit = jax.jit(
    ensemble_solve_kernel_reference,
    static_argnames=("rhs", "duration", "dt", "save_every", "method", "t0"),
)


# ---------------------------------------------------------------------------
# adaptive (lockstep-dt) variant
# ---------------------------------------------------------------------------
#
# dt is LOCKSTEP PER MEMBER BLOCK: each Pallas program carries one scalar
# (t, dt) chain, the controller norm is the max over the block of each
# member's scaled RMS error (so every member satisfies the tolerance and the
# block's dt is set by its currently stiffest member), and dt is clamped to
# land EXACTLY on each save point with the grid engine's semantics
# (ode/integrate.py): an ACCEPTED clamped step keeps the natural dt, a
# REJECTED one shrinks from the clamped size. Blocks run in parallel and in
# no order, and nothing passes between them. Budget exhaustion (more than
# steps_per_save attempts in one save interval; the FIRST interval gets
# max(4x, 32) for the dt0 ramp + initial transient) emits NaN saves until
# the block catches up and is counted in the returned stats -- the
# SolverParams.step_budget contract. The reference runs the same code with
# the whole ensemble as one block.


def _make_interval(rhs, p, tableau, *, rtol, atol, eps):
    """``interval(carry, s_end, k) -> (carry, reached)``: up to ``k``
    attempts toward the save point ``s_end``, shared by kernel and reference.

    ``carry = (t, dt, y_rows, f0_rows, n_accepted, n_rejected)``. The loop
    stops as soon as the block reaches ``s_end``; an attempt past that point
    would change nothing.
    """
    a, b, e, c, n_stages, err_order = tableau
    f32 = jnp.float32
    i32 = jnp.int32

    def attempt(s_end, carry):
        t, dt_next, y, f0, na, nr = carry
        remaining = s_end - t
        dt_used = jnp.minimum(dt_next, remaining)
        landing = dt_used >= remaining - eps
        y_new, err, k_last = _rk_embedded_step_rows(
            rhs, list(y), p, t, dt_used, a, b, e, c, n_stages, f0
        )
        sq = None
        for r in range(len(y)):
            sc = atol + rtol * jnp.maximum(jnp.abs(y[r]), jnp.abs(y_new[r]))
            q = err[r] / sc
            sq = q * q if sq is None else sq + q * q
        norm = jnp.max(jnp.sqrt(sq * (1.0 / len(y))))
        ok = jnp.isfinite(norm)
        safe = jnp.maximum(norm, jnp.asarray(1e-30, f32))
        # norm**(-1/err_order) via exp/log
        factor = jnp.clip(
            0.9 * jnp.exp(jnp.log(safe) * (-1.0 / err_order)), 0.2, 10.0
        )
        factor = jnp.where(ok, factor, jnp.asarray(0.2, f32))
        acc = ok & (norm <= 1.0)
        # an ACCEPTED save-clamped step says nothing about the natural dt
        # (it was artificially short): keep dt_next; a REJECTED one must
        # shrink from the clamped size (grid-engine semantics)
        dt_new = jnp.where(landing & acc, dt_next, dt_used * factor)
        y = tuple(jnp.where(acc, yn, yo) for yn, yo in zip(y_new, y))
        # on ACCEPT the FSAL carry becomes k_last (f at y_new)
        f0 = tuple(jnp.where(acc, kn, fo) for kn, fo in zip(k_last, f0))
        t = jnp.where(acc, jnp.where(landing, s_end, t + dt_used), t)
        return (t, dt_new, y, f0, na + acc.astype(i32),
                nr + (~acc).astype(i32))

    def interval(carry, s_end, k):
        def cond(state):
            n, carry = state
            return (n < k) & (s_end - carry[0] > eps)

        def body(state):
            n, carry = state
            return n + 1, attempt(s_end, carry)

        _, carry = jax.lax.while_loop(cond, body, (jnp.int32(0), carry))
        return carry, carry[0] >= s_end - eps

    return interval


def _adaptive_start(rhs, y, p, *, t0, dt0):
    """Initial carry: the FSAL stage f(t0, y0) is evaluated once up front."""
    z = jnp.zeros((), jnp.int32)
    t0 = jnp.asarray(t0, jnp.float32)
    f0 = tuple(rhs(list(y), p, t0))
    return (t0, jnp.asarray(dt0, jnp.float32), tuple(y), f0, z, z)


def _adaptive_grid(duration, save_every, steps_per_save, dt0):
    n_saves = int(round(duration / save_every)) + 1
    k_first = max(4 * int(steps_per_save), 32)
    dt0 = float(save_every / 8.0 if dt0 is None else dt0)
    eps = 1e-6 * max(float(save_every), 1.0)
    return n_saves, k_first, dt0, eps


def _solve_kernel_adaptive(
    y_ref, p_ref, out_ref, flag_ref, *, rhs, n_rows, n_params, n_saves,
    save_every, steps_per_save, k_first, rtol, atol, dt0, eps, t0, tableau,
    save_rows,
):
    f32 = jnp.float32
    p = [p_ref[r, :] for r in range(n_params)]
    interval = _make_interval(
        rhs, p, tableau, rtol=rtol, atol=atol, eps=eps
    )

    def save(slot, rows, reached):
        for j, r in enumerate(save_rows):
            v = jnp.where(reached, rows[r], jnp.full_like(rows[r], jnp.nan))
            pltriton.store(out_ref.at[slot, j, :], v.astype(out_ref.dtype))

    y = tuple(y_ref[r, :] for r in range(n_rows))
    save(0, y, True)
    carry = _adaptive_start(rhs, y, p, t0=t0, dt0=dt0)
    carry, reached = interval(carry, jnp.asarray(t0 + save_every, f32), k_first)
    save(1, carry[2], reached)

    def outer(s, state):
        carry, bad = state
        s_end = t0 + s.astype(f32) * save_every
        carry, reached = interval(carry, s_end, steps_per_save)
        save(s, carry[2], reached)
        return carry, bad + (~reached).astype(jnp.int32)

    carry, bad = jax.lax.fori_loop(
        2, n_saves, outer, (carry, (~reached).astype(jnp.int32))
    )
    flag_ref[0] = bad
    flag_ref[1] = carry[4]
    flag_ref[2] = carry[5]


@functools.partial(
    jax.jit,
    static_argnames=("rhs", "duration", "save_every", "steps_per_save",
                     "rtol", "atol", "dt0", "block_b", "num_warps", "method",
                     "t0", "save_dtype", "save_rows", "interpret"),
)
def _solve_pallas_adaptive(
    y0_rows, p_rows, *, rhs, duration, save_every, steps_per_save, rtol,
    atol, dt0, block_b, num_warps, method, t0, save_dtype, save_rows,
    interpret=False,
):
    n_rows, batch = y0_rows.shape
    padded = -(-batch // block_b) * block_b
    n_saves, k_first, dt0, eps = _adaptive_grid(
        duration, save_every, steps_per_save, dt0
    )
    kernel = functools.partial(
        _solve_kernel_adaptive, rhs=rhs, n_rows=n_rows,
        n_params=p_rows.shape[0], n_saves=n_saves, save_every=save_every,
        steps_per_save=steps_per_save, k_first=k_first, rtol=rtol,
        atol=atol, dt0=dt0, eps=eps, t0=t0,
        tableau=_ADAPTIVE_METHODS[method], save_rows=save_rows,
    )
    n_save = len(save_rows)
    nb = padded // block_b
    out, flags = _pallas(
        kernel, _pad_members(y0_rows, padded), _pad_members(p_rows, padded),
        [
            jax.ShapeDtypeStruct((n_saves, n_save, padded), save_dtype),
            jax.ShapeDtypeStruct((nb, 4), jnp.int32),
        ],
        [
            pl.BlockSpec((n_saves, n_save, block_b), lambda i: (0, 0, i)),
            pl.BlockSpec((None, 4), lambda i: (i, 0)),
        ],
        block_b=block_b, num_warps=num_warps, interpret=interpret,
    )
    return (out if padded == batch else out[..., :batch]), flags


def ensemble_solve_kernel_adaptive(
    rhs: Callable,
    y0_rows: jnp.ndarray,
    p_rows: jnp.ndarray | None = None,
    *,
    duration: float,
    save_every: float = 1.0,
    rtol: float = 1e-4,
    atol: float = 1e-6,
    dt0: float | None = None,
    steps_per_save: int = 8,
    block_b: int | None = None,
    method: str = "bosh3",
    save_dtype=jnp.float32,
    t0: float = 0.0,
    save_rows: Sequence[int] | None = None,
    interpret: bool = False,
):
    """Adaptive (lockstep-dt) whole-solve ensemble integrator for a rows-RHS.

    The adaptive analog of :func:`ensemble_solve_kernel` -- the reference's
    DEFAULT solve mode is adaptive
    (CDCgov/DynODE/src/dynode/config/params.py:36-47). Embedded
    Bogacki-Shampine 3(2) (default; 3 RHS evals per steady-state attempt
    with the FSAL carry) or Tsitouras 5(4) with an I-controller; dt shared
    across each block of ``block_b`` members and driven by the block's max
    per-member scaled RMS error; clamped to land exactly on each save point
    (see the comment above :func:`_make_interval` for the full contract).

    ``atol`` defaults to 1e-6 -- scaled for O(1) states (proportions). For
    ~1e3-scale populations use atol=1e-3: f64-calibrated defaults make the
    f32 controller thrash (CLAUDE.md).

    Returns ``(saves, stats)``: saves ``(n_saves, len(save_rows), B)`` in
    ``save_dtype`` (NaN rows where a block's attempt budget ran out);
    ``stats`` has per-block int32 arrays ``exhausted_intervals`` (nonzero
    means raise ``steps_per_save``), ``n_accepted``, ``n_rejected``. The
    CPU route runs :func:`ensemble_solve_kernel_adaptive_reference` (one
    block of all B members); ``interpret`` as in
    :func:`ensemble_solve_kernel`. Controller decisions depend on which
    members share a block, so results agree with another ``block_b`` only
    to the solve tolerance.
    """
    if method not in _ADAPTIVE_METHODS:
        raise ValueError(
            f"unknown method {method!r}; one of {list(_ADAPTIVE_METHODS)}"
        )
    y0_rows, p_rows = _check_rows(y0_rows, p_rows)
    n_rows, batch = y0_rows.shape
    n_saves = int(round(duration / save_every)) + 1
    if abs((n_saves - 1) * save_every - duration) > 1e-9 * max(
        1.0, abs(duration)
    ):
        raise ValueError("duration must be a whole number of save intervals")
    if n_saves < 2:
        raise ValueError("duration must cover at least one save interval")
    save_rows = _check_save_rows(save_rows, n_rows)
    block_b, num_warps = launch_config(batch, block_b)

    if not interpret and kernel_route() == "lax":
        saves, stats = _adaptive_reference_jit(
            rhs=rhs, y0_rows=y0_rows, p_rows=p_rows, duration=duration,
            save_every=save_every, rtol=rtol, atol=atol, dt0=dt0,
            steps_per_save=steps_per_save, method=method, t0=t0,
        )
        return saves[:, list(save_rows), :].astype(save_dtype), stats
    saves, flags = _solve_pallas_adaptive(
        y0_rows, p_rows, rhs=rhs, duration=float(duration),
        save_every=float(save_every), steps_per_save=int(steps_per_save),
        rtol=float(rtol), atol=float(atol),
        dt0=None if dt0 is None else float(dt0), block_b=block_b,
        num_warps=num_warps, method=method, t0=float(t0),
        save_dtype=jnp.dtype(save_dtype).name, save_rows=save_rows,
        interpret=bool(interpret),
    )
    stats = {
        "exhausted_intervals": flags[:, 0],
        "n_accepted": flags[:, 1],
        "n_rejected": flags[:, 2],
    }
    return saves, stats


def ensemble_solve_kernel_adaptive_reference(
    rhs, y0_rows, p_rows=None, *, duration, save_every=1.0, rtol=1e-4,
    atol=1e-6, dt0=None, steps_per_save=8, method="bosh3", t0=0.0,
):
    """Pure-JAX lockstep reference (one block of all members).

    Same code as the kernel -- shared scalar dt over the WHOLE ensemble,
    max-of-member-RMS controller norm, save-point clamping, per-interval
    attempt budgets -- so with ``block_b == batch`` the kernel makes
    identical controller decisions. Returns ``(saves, stats)`` with
    ``(1,)``-shaped stats arrays (one block).
    """
    y0_rows, p_rows = _check_rows(y0_rows, p_rows)
    n_rows = y0_rows.shape[0]
    p = [p_rows[r] for r in range(p_rows.shape[0])]
    n_saves, k_first, dt0, eps = _adaptive_grid(
        duration, save_every, steps_per_save, dt0
    )
    f32 = jnp.float32
    interval = _make_interval(
        rhs, p, _ADAPTIVE_METHODS[method], rtol=rtol, atol=atol, eps=eps
    )

    def emit(rows, reached):
        rows = jnp.stack(rows, axis=0)
        return jnp.where(reached, rows, jnp.full_like(rows, jnp.nan))

    y = tuple(y0_rows[r] for r in range(n_rows))
    carry = _adaptive_start(rhs, y, p, t0=t0, dt0=dt0)
    carry, reached1 = interval(carry, jnp.asarray(t0 + save_every, f32), k_first)
    first = emit(carry[2], reached1)

    def outer(state, s):
        carry, bad = state
        carry, reached = interval(carry, t0 + s * save_every, steps_per_save)
        return (carry, bad + (~reached).astype(jnp.int32)), emit(
            carry[2], reached
        )

    (carry, bad), rest = jax.lax.scan(
        outer, (carry, (~reached1).astype(jnp.int32)),
        jnp.arange(2, n_saves, dtype=f32),
    )
    saves = jnp.concatenate([y0_rows[None], first[None], rest], axis=0)
    stats = {
        "exhausted_intervals": bad[None],
        "n_accepted": carry[4][None],
        "n_rejected": carry[5][None],
    }
    return saves, stats


_adaptive_reference_jit = jax.jit(
    ensemble_solve_kernel_adaptive_reference,
    static_argnames=("rhs", "duration", "save_every", "rtol", "atol", "dt0",
                     "steps_per_save", "method", "t0"),
)
