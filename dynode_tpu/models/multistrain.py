"""Multi-strain age-stratified SEIRS: the flagship benchmark workload.

Workload parity with the reference's
examples/seirs_multi_strain_age_stratified.py (same compartments s/e/i/r/c,
same defaults), but the RHS is written as one batched einsum over the
(age, strain) tensor instead of a per-strain Python loop -- the whole
force-of-infection computation is a single ``C @ (i/N)`` contraction. The
rows form at the end of this module feeds the whole-solve ensemble
integrator (``ops.ensemble_solve_kernel``).
"""

import dataclasses
from datetime import date
from types import SimpleNamespace
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (
    Bin,
    Compartment,
    Dimension,
    Initializer,
    Params,
    SimulationConfig,
    SolverParams,
    Strain,
    TransmissionParams,
)
from ..simulation import AbstractODEParams
from ..struct import pytree_dataclass
from ..typing import CompartmentState
from ..utils import vectorize_objects


@pytree_dataclass(static_fieldnames=("idx",))
class MultiStrainParams(AbstractODEParams):
    """ODE parameter pytree of the multi-strain SEIRS model."""
    beta: jnp.ndarray  # (K,)
    sigma: jnp.ndarray  # (K,)
    gamma: jnp.ndarray  # (K,)
    omega: jnp.ndarray  # (K,)
    contact_matrix: jnp.ndarray  # (A, A)
    idx: Optional[SimpleNamespace] = None


def multistrain_ode(t, state: CompartmentState, p: MultiStrainParams):
    """Batched-tensor RHS: foi[a,k] = beta[k] * (C @ (i/N))[a,k].

    state: s (A,), e/i/r/c (A, K).
    """
    s, e, i, r, c = state
    n_age = s + e.sum(axis=-1) + i.sum(axis=-1) + r.sum(axis=-1)
    infectious_frac = i / n_age[:, None]  # (A, K)
    # full-f32 contraction: on a GPU an f32 matmul may run in TF32 (about
    # three decimal digits) unless a precision is set; these A x A
    # contractions are tiny, so HIGHEST costs nothing
    foi = p.beta[None, :] * jnp.matmul(
        p.contact_matrix, infectious_frac, precision=jax.lax.Precision.HIGHEST
    )  # (A, K)
    new_inf = foi * s[:, None]  # (A, K)
    ds = -new_inf.sum(axis=-1) + (p.omega * r).sum(axis=-1)
    de = new_inf - p.sigma * e
    di = p.sigma * e - p.gamma * i
    dr = p.gamma * i - p.omega * r
    dc = new_inf
    return (ds, de, di, dr, dc)


class MultiStrainInitializer(Initializer):
    """Distributes initial infections across strains proportional to r0."""

    s0_prop: float = 0.99
    i0_prop: float = 0.01
    age_demographics: Sequence[float] = (0.75, 0.25)

    def get_initial_state(self, config: SimulationConfig, **kwargs) -> CompartmentState:
        """Initial (S, E, I, R, C) compartments from demographics and seeds."""
        demo = jnp.asarray(self.age_demographics)
        s0 = self.population_size * self.s0_prop * demo
        e0 = jnp.zeros(config.get_compartment("e").shape)
        r0s = jnp.asarray(
            vectorize_objects(
                config.parameters.transmission_params.strains, target="r0"
            )
        )
        dominance = r0s / jnp.sum(r0s)
        i0 = self.population_size * self.i0_prop * demo[:, None] * dominance
        r0 = jnp.zeros(config.get_compartment("r").shape)
        c0 = jnp.zeros(config.get_compartment("c").shape)
        return (s0, e0, i0, r0, c0)


def multistrain_config(
    r0s=(2.0, 2.5, 1.8),
    infectious_periods=(7.0, 6.0, 8.0),
    latent_periods=(3.0, 2.5, 4.0),
    waning_periods=(60.0, 80.0, 50.0),
    strain_names=("A", "B", "C"),
    age_names=("young", "old"),
    age_demographics=(0.75, 0.25),
    contact_matrix=None,
    solver_params: Optional[SolverParams] = None,
) -> SimulationConfig:
    """Age x strain SEIRS+C config, generalized to any strain/age count."""
    strains = [
        Strain(
            strain_name=name,
            r0=r0s[k],
            infectious_period=infectious_periods[k],
            exposed_to_infectious=latent_periods[k],
        )
        for k, name in enumerate(strain_names)
    ]
    age_dim = Dimension(name="age", bins=[Bin(name=a) for a in age_names])
    strain_dim = Dimension(
        name="strain", bins=[Bin(name=s.strain_name) for s in strains]
    )
    if contact_matrix is None:
        a = len(age_names)
        contact_matrix = jnp.full((a, a), 0.3) + 0.4 * jnp.eye(a)
    interactions = {
        s1: {s2: 1.0 for s2 in strain_names} for s1 in strain_names
    }
    return SimulationConfig(
        compartments=[
            Compartment(name="s", dimensions=[age_dim]),
            Compartment(name="e", dimensions=[age_dim, strain_dim]),
            Compartment(name="i", dimensions=[age_dim, strain_dim]),
            Compartment(name="r", dimensions=[age_dim, strain_dim]),
            Compartment(name="c", dimensions=[age_dim, strain_dim]),
        ],
        initializer=MultiStrainInitializer(
            description="age x strain SEIRS initializer",
            initialize_date=date(2022, 2, 11),
            population_size=1000,
            age_demographics=age_demographics,
        ),
        parameters=Params(
            solver_params=solver_params or SolverParams(step_budget=512),
            transmission_params=TransmissionParams(
                strains=strains,
                strain_interactions=interactions,
                contact_matrix=jnp.asarray(contact_matrix),
                waning_period=tuple(waning_periods),
            ),
        ),
    )


def multistrain_odeparams(config: SimulationConfig) -> MultiStrainParams:
    """Vectorize a (possibly sampled) config into strain-axis tensors."""
    tp = config.parameters.transmission_params
    r0s = jnp.asarray(vectorize_objects(tp.strains, target="r0"))
    inf_p = jnp.asarray(vectorize_objects(tp.strains, target="infectious_period"))
    lat_p = jnp.asarray(
        vectorize_objects(tp.strains, target="exposed_to_infectious")
    )
    return MultiStrainParams(
        beta=r0s / inf_p,
        sigma=1.0 / lat_p,
        gamma=1.0 / inf_p,
        omega=1.0 / jnp.asarray(tp.waning_period),
        contact_matrix=tp.contact_matrix,
        idx=config.idx,
    )


def multistrain_initial_state(config: SimulationConfig) -> CompartmentState:
    """Initial compartment tuple for a ``multistrain_config`` config."""
    return config.initializer.get_initial_state(config)


# ---------------------------------------------------------------------------
# lane-major ensemble variant: batch axis LAST. Which layout is faster
# depends on the model and the device (bench.py measures both; see
# simulation.ensemble_rhs). Kept as the template for ensemble_rhs
# equivalence tests and the NUTS batched-potential path.
# ---------------------------------------------------------------------------


def multistrain_ensemble_state(y0: CompartmentState, batch: int) -> CompartmentState:
    """Broadcast a single initial state to (..., batch)."""
    import jax.numpy as _jnp

    return tuple(
        _jnp.broadcast_to(a[..., None], a.shape + (batch,)) for a in y0
    )


def multistrain_ensemble_params(
    base: MultiStrainParams, beta_scales: jnp.ndarray
) -> MultiStrainParams:
    """Per-member transmission scaling: beta becomes (K, B)."""
    return base.replace(beta=base.beta[:, None] * beta_scales[None, :])


def multistrain_ode_ensemble(t, state: CompartmentState, p: MultiStrainParams):
    """Fused multi-strain RHS over a trailing ensemble axis.

    state: s (A, B), e/i/r/c (A, K, B); ``p.beta`` is (K, B).
    """
    s, e, i, r, c = state
    n_age = s + e.sum(axis=1) + i.sum(axis=1) + r.sum(axis=1)  # (A, B)
    infectious_frac = i / n_age[:, None, :]  # (A, K, B)
    mixed = jnp.einsum(
        "ab,bkx->akx", p.contact_matrix, infectious_frac,
        precision=jax.lax.Precision.HIGHEST,
    )
    foi = p.beta[None, :, :] * mixed  # (A, K, B)
    new_inf = foi * s[:, None, :]
    ds = -new_inf.sum(axis=1) + (p.omega[:, None] * r).sum(axis=1)
    de = new_inf - p.sigma[:, None] * e
    di = p.sigma[:, None] * e - p.gamma[:, None] * i
    dr = p.gamma[:, None] * i - p.omega[:, None] * r
    return (ds, de, di, dr, new_inf)


# ---------------------------------------------------------------------------
# rows form for the whole-solve ensemble integrator (ops.ensemble_solve_kernel):
# the state is R = A + 4*A*K rows (s, then e/i/r/c in (age, strain) order),
# each row one (B,) vector over the members; the parameters are 4*K rows
# (beta, sigma, gamma, omega per strain).
# ---------------------------------------------------------------------------


def n_state_rows(n_age: int = 2, n_strain: int = 3) -> int:
    """Rows of the packed multistrain state: s (A) + e/i/r/c (A*K each)."""
    return n_age + 4 * n_age * n_strain


def rhs_rows(y, contact, beta, sigma, gamma, omega, n_age, n_strain):
    """d/dt of the packed state on lists of (B,) rows.

    ``beta``/... are lists of K (B,) rows; ``contact`` is a nested tuple of
    Python floats (a kernel must not capture traced arrays). Same model as
    :func:`multistrain_ode`.
    """
    ak = n_age * n_strain
    s = [y[a] for a in range(n_age)]
    e = [y[n_age + idx] for idx in range(ak)]
    i = [y[n_age + ak + idx] for idx in range(ak)]
    r = [y[n_age + 2 * ak + idx] for idx in range(ak)]

    inv_n = []
    for a in range(n_age):
        tot = s[a]
        for k in range(n_strain):
            idx = a * n_strain + k
            tot = tot + e[idx] + i[idx] + r[idx]
        inv_n.append(1.0 / tot)

    d = [None] * n_state_rows(n_age, n_strain)
    ds = [jnp.zeros_like(s[0]) for _ in range(n_age)]
    for a in range(n_age):
        for k in range(n_strain):
            idx = a * n_strain + k
            mixed = jnp.zeros_like(s[0])
            for b in range(n_age):
                mixed = mixed + contact[a][b] * i[b * n_strain + k] * inv_n[b]
            new_inf = beta[k] * mixed * s[a]
            e_out = sigma[k] * e[idx]
            i_out = gamma[k] * i[idx]
            r_out = omega[k] * r[idx]
            ds[a] = ds[a] - new_inf + r_out
            d[n_age + idx] = new_inf - e_out  # de
            d[n_age + ak + idx] = e_out - i_out  # di
            d[n_age + 2 * ak + idx] = i_out - r_out  # dr
            d[n_age + 3 * ak + idx] = new_inf  # dc
    for a in range(n_age):
        d[a] = ds[a]
    return d


@dataclasses.dataclass(frozen=True)
class MultistrainRowsRHS:
    """The multistrain model as a rows-RHS ``rhs(y, p, t)``.

    Hashable by value, so equal models share one compiled whole-solve
    program. ``p`` holds the :func:`pack_params` rows.
    """

    contact: tuple
    n_age: int = 2
    n_strain: int = 3

    @classmethod
    def from_params(cls, params: MultiStrainParams):
        """Build from a :class:`MultiStrainParams` (host-fetches contact)."""
        contact = np.asarray(jax.device_get(params.contact_matrix))
        return cls(
            contact=tuple(tuple(float(v) for v in row) for row in contact),
            n_age=contact.shape[0],
            n_strain=int(np.shape(params.beta)[-1]),
        )

    def __call__(self, y, p, t):
        k = self.n_strain
        return rhs_rows(
            y, self.contact, p[:k], p[k:2 * k], p[2 * k:3 * k],
            p[3 * k:4 * k], self.n_age, k,
        )


def pack_state(
    y0: CompartmentState, batch: int, n_age: int = 2, n_strain: int = 3
) -> jnp.ndarray:
    """(s (A,), e/i/r/c (A,K)) -> packed (R, B) with the state broadcast."""
    flat = jnp.concatenate([jnp.reshape(c, -1) for c in y0])
    d = n_state_rows(n_age, n_strain)
    if flat.shape[0] != d:
        raise ValueError(
            f"state does not match {n_age} ages x {n_strain} strains"
        )
    return jnp.broadcast_to(flat[:, None], (d, batch)).astype(jnp.float32)


def pack_params(beta, sigma, gamma, omega, batch: int, n_strain: int = 3):
    """Per-strain rates (each (K,) or (B, K)) -> packed (4*K, B) rows."""

    def rows(x):
        x = jnp.asarray(x, dtype=jnp.float32)
        if x.ndim == 1:
            x = jnp.broadcast_to(x[None, :], (batch, n_strain))
        return x.T  # (K, B)

    return jnp.concatenate([rows(beta), rows(sigma), rows(gamma), rows(omega)])


def unpack_saves(saves: jnp.ndarray, n_age: int = 2, n_strain: int = 3):
    """(T, R, B) packed saves -> (s, e, i, r, c), each (T, B, ...)."""
    T, _, B = saves.shape
    s = saves[:, :n_age, :].transpose(0, 2, 1)  # (T, B, A)
    blocks = []
    off = n_age
    ak = n_age * n_strain
    for _ in range(4):
        blk = saves[:, off : off + ak, :]
        blocks.append(blk.reshape(T, n_age, n_strain, B).transpose(0, 3, 1, 2))
        off += ak
    e, i, r, c = blocks
    return s, e, i, r, c


__all__ = [
    "MultiStrainParams",
    "multistrain_ode",
    "MultiStrainInitializer",
    "multistrain_config",
    "multistrain_odeparams",
    "multistrain_initial_state",
    "MultistrainRowsRHS",
    "n_state_rows",
    "pack_params",
    "pack_state",
    "rhs_rows",
    "unpack_saves",
]
