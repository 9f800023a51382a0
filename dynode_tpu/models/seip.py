"""SEIP: the production respiratory-disease model (age x immune-history x
vaccination x waning x strain).

Implements the full model the reference documents but does not ship as code
(reference: ode_model.md:1-233; disease code lives in the private
DynODE-Models repo, CHANGELOG.md:120-122):

- S[a, j, k, m]: age x immune-history x vax-dose x waning-stage
- E/I/C[a, j, k, l]: age x immune-history x vax-dose x strain
- layered immunity: cross-immunity chi x vaccine efficacy nu, scaled by
  waning-bin base protections, floored at a minimum homologous immunity
  (ode_model.md:176-232)
- recovery routes I -> S[m=0] through the bitwise-OR immune-history
  transition eta(j, l) = j | 2^l (ode_model.md:100-118)
- time-varying vaccination uptake via cubic splines
  (utils/splines.py), with per-dose saturation min(nu N_a / S_k, 1)
- seasonal-vaccination reset phi(t) = sin^1000(2 pi (t+tau)/730) moving the
  top dose tier back one tier (ode_model.md:86-98)
- external strain introductions as normal-shaped pulses of infectious
  population with an age mask (config Strain introduction_* fields)
- sinusoidal seasonal transmission forcing

Everything is batched tensor algebra (einsums over the 4-D/5-D state), so
the RHS vectorizes over ensembles and fuses into a few XLA kernels;
the eta scatter is a precomputed one-hot contraction, not a gather loop.
"""

import math
from datetime import date
from types import SimpleNamespace
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (
    AgeBin,
    Bin,
    Compartment,
    Dimension,
    FullStratifiedImmuneHistoryDimension,
    Initializer,
    Params,
    SimulationConfig,
    SolverParams,
    Strain,
    TransmissionParams,
    VaccinationDimension,
    WaneDimension,
)
from ..simulation import AbstractODEParams
from ..struct import pytree_dataclass
from ..typing import CompartmentState
from ..utils import evaluate_cubic_spline, vectorize_objects


@pytree_dataclass(static_fieldnames=("idx", "seasonal_vaccination"))
class SEIPParams(AbstractODEParams):
    """Vectorized SEIP RHS parameters (strain-flattened tensors)."""

    beta: jnp.ndarray  # (L,)
    sigma: jnp.ndarray  # (L,)
    gamma: jnp.ndarray  # (L,)
    contact: jnp.ndarray  # (A, A)
    pop: jnp.ndarray  # (A,) age-group populations N_a
    # seasonal transmission forcing: beta * (1 + amp * cos(2pi (t-peak)/365))
    season_amp: jnp.ndarray
    season_peak: jnp.ndarray
    # external introductions (zeros when not introduced)
    intro_time: jnp.ndarray  # (L,)
    intro_scale: jnp.ndarray  # (L,)
    intro_perc: jnp.ndarray  # (L,)
    intro_age_mask: jnp.ndarray  # (L, A)
    # vaccination uptake splines (age x dose)
    vax_knots: jnp.ndarray  # (A, K+1, n_knots)
    vax_base_coeffs: jnp.ndarray  # (A, K+1, 4)
    vax_knot_coeffs: jnp.ndarray  # (A, K+1, n_knots)
    seasonal_vax_tau: jnp.ndarray
    # waning
    omega: jnp.ndarray  # (M,) exit rate per waning bin (last = 0)
    base_protection: jnp.ndarray  # (M,)
    # immunity structure
    chi: jnp.ndarray  # (L, J) cross-immunity of history j vs strain l
    vax_eff: jnp.ndarray  # (L, K+1)
    hist_mask: jnp.ndarray  # (L, J) 1 if history j contains strain l
    min_homologous: jnp.ndarray
    eta_onehot: jnp.ndarray  # (J, L, J) recovery scatter j,l -> eta(j,l)
    idx: Optional[SimpleNamespace] = None
    seasonal_vaccination: bool = False


# full-f32 contractions: on a GPU an f32 einsum/matmul may run in TF32
# (about three decimal digits) unless a precision is set, and that rounding
# accumulates over a solve. These contractions are tiny (4x4-ish), so
# HIGHEST costs nothing measurable.
_PREC = jax.lax.Precision.HIGHEST


def _phi_seasonal(t, tau):
    """sin^1000 pulse around the vaccination-season change (ode_model.md:86-98)."""
    s = jnp.sin(2.0 * jnp.pi * (t + tau) / 730.0)
    return s**1000


def seip_ode(t, state: CompartmentState, p: SEIPParams):
    """Fused SEIP right-hand side over (S, E, I, C).

    Compartment-flow increments are built as zero-padded full-shape adds
    (pure dataflow) rather than ``.at[slice].add`` scatters: XLA's scatter
    lowering can materialize operand copies (see seip_ode_scatter, kept as
    the equivalence reference).
    """
    S, E, I, C = state  # S: (A,J,K,M); E/I/C: (A,J,K,L)
    K = S.shape[2]
    M = S.shape[3]

    # ---- force of infection ----------------------------------------------
    season = 1.0 + p.season_amp * jnp.cos(
        2.0 * jnp.pi * (t - p.season_peak) / 365.0
    )
    # external infectious population: normal pulse * age mask * pop
    pulse = (
        p.intro_perc
        * jnp.exp(-0.5 * ((t - p.intro_time) / p.intro_scale) ** 2)
        / (p.intro_scale * math.sqrt(2.0 * math.pi))
    )  # (L,)
    external = pulse[:, None] * p.intro_age_mask * p.pop[None, :]  # (L, A)
    infectious = jnp.sum(I, axis=(1, 2)) + external.T  # (A, L)
    mixed = jnp.matmul(p.contact, infectious, precision=_PREC)  # (A, L)
    lam = (p.beta[None, :] * season / p.pop[:, None]) * mixed  # (A, L)

    # ---- layered immunity (ode_model.md:176-232) -------------------------
    # initial immunity from history x vaccination
    ii = 1.0 - (1.0 - p.chi[:, :, None]) * (1.0 - p.vax_eff[:, None, :])
    # ii: (L, J, K) -> waned by bin base protections, floored at homologous
    wib = ii[..., None] * p.base_protection  # (L, J, K, M)
    fi = (p.min_homologous * p.hist_mask)[:, :, None, None]  # (L, J, 1, 1)
    wi = wib + (1.0 - wib) * fi  # (L, J, K, M)
    escape = 1.0 - wi  # susceptibility multiplier

    # exposures[a,j,k,m,l] = lam[a,l] * escape[l,j,k,m] * S[a,j,k,m];
    # both reductions distribute over the elementwise product, so contract
    # directly instead of materializing the rank-5 exposure tensor (the
    # dominant HBM traffic of the RHS at ensemble width)
    new_exposed = (
        lam[:, None, None, :]
        * jnp.einsum("ljkm,ajkm->ajkl", escape, S, precision=_PREC)
    )  # (A,J,K,L): sum over m
    dS = -jnp.einsum("al,ljkm->ajkm", lam, escape, precision=_PREC) * S  # sum over l
    dE = new_exposed - p.sigma * E
    dI = p.sigma * E - p.gamma * I
    dC = new_exposed

    # ---- recovery through the immune-history transition ------------------
    recovered = p.gamma * I  # (A,J,K,L)
    rec_to_hist = jnp.einsum("ajkl,jlh->ahk", recovered, p.eta_onehot, precision=_PREC)
    dS = dS + _pad_axis(rec_to_hist[..., None], 3, 0, M - 1)  # at m=0

    # ---- vaccination uptake (splines, saturated per dose tier) -----------
    nu = evaluate_cubic_spline(
        t, p.vax_knots, p.vax_base_coeffs, p.vax_knot_coeffs
    )  # (A, K+1)
    nu = jnp.clip(nu, 0.0, None)
    s_by_dose = S.sum(axis=(1, 3))  # (A, K)
    rate = jnp.minimum(nu * p.pop[:, None] / jnp.maximum(s_by_dose, 1e-8), 1.0)
    # doses k < K: move (all waning stages) to (k+1, m=0)
    out_lower = rate[:, None, :-1, None] * S[:, :, :-1, :]  # (A,J,K-1,M)
    dS = dS - _pad_axis(out_lower, 2, 0, 1)
    dS = dS + _pad_axis(
        _pad_axis(out_lower.sum(axis=-1)[..., None], 3, 0, M - 1), 2, 1, 0
    )
    # top tier K: boosting recycles waned (m>0) back to m=0
    out_top = rate[:, None, -1, None] * S[:, :, -1, 1:]  # (A,J,M-1)
    dS = dS - _pad_axis(_pad_axis(out_top[:, :, None, :], 3, 1, 0), 2, K - 1, 0)
    dS = dS + _pad_axis(
        _pad_axis(out_top.sum(axis=-1)[:, :, None, None], 3, 0, M - 1),
        2, K - 1, 0,
    )

    # ---- seasonal vaccination reset (top tier -> previous tier) ----------
    if p.seasonal_vaccination:
        phi = _phi_seasonal(t, p.seasonal_vax_tau)

        def season_shift(X):
            shift = phi * X[:, :, -1, ...]
            pair = jnp.stack([shift, -shift], axis=2)  # (A,J,2,...)
            return _pad_axis(pair, 2, K - 2, 0)

        dS = dS + season_shift(S)
        dE = dE + season_shift(E)
        dI = dI + season_shift(I)

    # ---- waning chain m -> m+1 -------------------------------------------
    wane_out = p.omega * S  # (A,J,K,M); omega[-1] == 0
    dS = dS - wane_out
    dS = dS + _pad_axis(wane_out[..., :-1], 3, 1, 0)

    return (dS, dE, dI, dC)


def seip_ode_scatter(t, state: CompartmentState, p: SEIPParams):
    """Original ``.at[slice].add`` form of :func:`seip_ode`.

    Kept as the equivalence reference for the pad-based default (the two
    must be the same vector field; tests/test_dynamics/test_seip.py) and
    for measuring XLA's scatter lowering in bench_seip.py.
    """
    S, E, I, C = state  # S: (A,J,K,M); E/I/C: (A,J,K,L)

    season = 1.0 + p.season_amp * jnp.cos(
        2.0 * jnp.pi * (t - p.season_peak) / 365.0
    )
    pulse = (
        p.intro_perc
        * jnp.exp(-0.5 * ((t - p.intro_time) / p.intro_scale) ** 2)
        / (p.intro_scale * math.sqrt(2.0 * math.pi))
    )  # (L,)
    external = pulse[:, None] * p.intro_age_mask * p.pop[None, :]  # (L, A)
    infectious = jnp.sum(I, axis=(1, 2)) + external.T  # (A, L)
    mixed = jnp.matmul(p.contact, infectious, precision=_PREC)  # (A, L)
    lam = (p.beta[None, :] * season / p.pop[:, None]) * mixed  # (A, L)

    ii = 1.0 - (1.0 - p.chi[:, :, None]) * (1.0 - p.vax_eff[:, None, :])
    wib = ii[..., None] * p.base_protection  # (L, J, K, M)
    fi = (p.min_homologous * p.hist_mask)[:, :, None, None]  # (L, J, 1, 1)
    escape = 1.0 - (wib + (1.0 - wib) * fi)

    new_exposed = (
        lam[:, None, None, :]
        * jnp.einsum("ljkm,ajkm->ajkl", escape, S, precision=_PREC)
    )  # (A,J,K,L)
    dS = -jnp.einsum("al,ljkm->ajkm", lam, escape, precision=_PREC) * S
    dE = new_exposed - p.sigma * E
    dI = p.sigma * E - p.gamma * I
    dC = new_exposed

    recovered = p.gamma * I  # (A,J,K,L)
    rec_to_hist = jnp.einsum("ajkl,jlh->ahk", recovered, p.eta_onehot, precision=_PREC)
    dS = dS.at[..., 0].add(rec_to_hist)

    nu = evaluate_cubic_spline(
        t, p.vax_knots, p.vax_base_coeffs, p.vax_knot_coeffs
    )
    nu = jnp.clip(nu, 0.0, None)
    s_by_dose = S.sum(axis=(1, 3))
    rate = jnp.minimum(nu * p.pop[:, None] / jnp.maximum(s_by_dose, 1e-8), 1.0)
    out_lower = rate[:, None, :-1, None] * S[:, :, :-1, :]
    dS = dS.at[:, :, :-1, :].add(-out_lower)
    dS = dS.at[:, :, 1:, 0].add(out_lower.sum(axis=-1))
    out_top = rate[:, None, -1, None] * S[:, :, -1, 1:]
    dS = dS.at[:, :, -1, 1:].add(-out_top)
    dS = dS.at[:, :, -1, 0].add(out_top.sum(axis=-1))

    if p.seasonal_vaccination:
        phi = _phi_seasonal(t, p.seasonal_vax_tau)
        dS = dS.at[:, :, -1, :].add(-phi * S[:, :, -1, :])
        dS = dS.at[:, :, -2, :].add(phi * S[:, :, -1, :])
        dE = dE.at[:, :, -1, :].add(-phi * E[:, :, -1, :])
        dE = dE.at[:, :, -2, :].add(phi * E[:, :, -1, :])
        dI = dI.at[:, :, -1, :].add(-phi * I[:, :, -1, :])
        dI = dI.at[:, :, -2, :].add(phi * I[:, :, -1, :])

    wane_out = p.omega * S
    dS = dS - wane_out
    dS = dS.at[..., 1:].add(wane_out[..., :-1])

    return (dS, dE, dI, dC)


# ---------------------------------------------------------------------------
# config factory
# ---------------------------------------------------------------------------


class SEIPInitializer(Initializer):
    """Fully-susceptible, unvaccinated, fresh-immunity start + seed infections."""

    age_demographics: Sequence[float] = (0.25, 0.35, 0.25, 0.15)
    i0_prop: float = 1e-3

    def get_initial_state(self, config: SimulationConfig, **kwargs) -> CompartmentState:
        """Initial (S, E, I, C) with layered immune-history strata."""
        s_shape = config.get_compartment("s").shape
        e_shape = config.get_compartment("e").shape
        A, J, K, M = s_shape
        L = e_shape[-1]
        demo = jnp.asarray(self.age_demographics)
        pop = self.population_size * demo
        S = jnp.zeros(s_shape)
        S = S.at[:, 0, 0, 0].set(pop * (1.0 - self.i0_prop))
        I = jnp.zeros(e_shape)
        # seed infections in naive/unvaccinated across non-introduced strains
        strains = config.parameters.transmission_params.strains
        seed_mask = jnp.asarray(
            [0.0 if s.is_introduced else 1.0 for s in strains]
        )
        seed_mask = seed_mask / jnp.maximum(seed_mask.sum(), 1.0)
        I = I.at[:, 0, 0, :].set(pop[:, None] * self.i0_prop * seed_mask[None, :])
        E = jnp.zeros(e_shape)
        C = jnp.zeros(e_shape)
        return (S, E, I, C)


def seip_config(
    strains: Optional[List[Strain]] = None,
    n_age: int = 4,
    max_vaccinations: int = 2,
    seasonal_vaccination: bool = False,
    waning_times=(70.0, 70.0, 70.0, math.inf),
    waning_protections=(1.0, 0.94, 0.83, 0.6),
    age_edges=(0, 18, 50, 65, 99),
    age_demographics=(0.25, 0.35, 0.25, 0.15),
    population_size: int = 100_000,
    contact_matrix=None,
    season_amp: float = 0.15,
    season_peak: float = 0.0,
    vaccination_season_change_day: float = 100.0,
    solver_params: Optional[SolverParams] = None,
) -> SimulationConfig:
    """Build the full SEIP SimulationConfig (all dimension types in play)."""
    if strains is None:
        strains = [
            Strain(
                strain_name="alpha",
                r0=2.2,
                infectious_period=7.0,
                exposed_to_infectious=3.6,
                vaccine_efficacy={k: min(0.35 * k, 0.8) for k in range(max_vaccinations + 1 + int(seasonal_vaccination))},
            ),
            Strain(
                strain_name="delta",
                r0=3.0,
                infectious_period=7.0,
                exposed_to_infectious=3.6,
                vaccine_efficacy={k: min(0.30 * k, 0.7) for k in range(max_vaccinations + 1 + int(seasonal_vaccination))},
                is_introduced=True,
                introduction_time=60.0,
                introduction_percentage=0.02,
                introduction_scale=5.0,
            ),
        ]
    names = [s.strain_name for s in strains]
    interactions = {
        a: {b: (1.0 if a == b else 0.7) for b in names} for a in names
    }

    age_dim = Dimension(
        name="age",
        bins=[
            AgeBin(age_edges[i], age_edges[i + 1] - (0 if i == n_age - 1 else 1))
            for i in range(n_age)
        ],
    )
    hist_dim = FullStratifiedImmuneHistoryDimension(strains, name="hist")
    vax_dim = VaccinationDimension(
        max_ordinal_vaccinations=max_vaccinations,
        seasonal_vaccination=seasonal_vaccination,
    )
    wane_dim = WaneDimension(
        waiting_times=list(waning_times),
        base_protections=list(waning_protections),
    )
    strain_dim = Dimension(
        name="strain", bins=[Bin(name=n) for n in names]
    )

    if contact_matrix is None:
        contact_matrix = jnp.full((n_age, n_age), 0.2) + 0.8 * jnp.eye(n_age) / n_age

    tp = TransmissionParams(
        strains=strains,
        strain_interactions=interactions,
        contact_matrix=jnp.asarray(contact_matrix),
        season_amp=season_amp,
        season_peak=season_peak,
        min_homologous_immunity=0.9,
        vaccination_season_change_day=vaccination_season_change_day,
    )
    return SimulationConfig(
        compartments=[
            Compartment(name="s", dimensions=[age_dim, hist_dim, vax_dim, wane_dim]),
            Compartment(name="e", dimensions=[age_dim, hist_dim, vax_dim, strain_dim]),
            Compartment(name="i", dimensions=[age_dim, hist_dim, vax_dim, strain_dim]),
            Compartment(name="c", dimensions=[age_dim, hist_dim, vax_dim, strain_dim]),
        ],
        initializer=SEIPInitializer(
            description="SEIP naive-population initializer",
            initialize_date=date(2022, 2, 11),
            population_size=population_size,
            age_demographics=age_demographics,
        ),
        parameters=Params(
            solver_params=solver_params or SolverParams(step_budget=1024),
            transmission_params=tp,
        ),
    )


def _full_hist_members(n_strains: int):
    """Strain-membership bitmask per FullStratified history bin, in the
    dimension's bin order (none, singles, pairs, ...)."""
    from itertools import combinations

    members = [frozenset()]
    for size in range(1, n_strains + 1):
        members.extend(frozenset(c) for c in combinations(range(n_strains), size))
    return members


def seip_odeparams(
    config: SimulationConfig,
    vax_spline_knots=None,
    vax_spline_base_coeffs=None,
    vax_spline_knot_coeffs=None,
    daily_vax_rate: float = 2e-3,
) -> SEIPParams:
    """Vectorize a (possibly sampled) SEIP config into RHS tensors.

    When spline coefficients are omitted, a constant ``daily_vax_rate``
    uptake is encoded as a degenerate spline (a-term only).
    """
    tp = config.parameters.transmission_params
    strains = tp.strains
    L = len(strains)
    s_comp = config.get_compartment("s")
    A, J, K_plus_1, M = s_comp.shape

    r0s = jnp.asarray(vectorize_objects(strains, target="r0"))
    inf_p = jnp.asarray(vectorize_objects(strains, target="infectious_period"))
    lat_p = jnp.asarray(
        vectorize_objects(strains, target="exposed_to_infectious")
    )

    # introductions (zeros when not introduced)
    def _stack(values):
        # values may be plain floats or traced samples; stack keeps gradients
        return jnp.stack([jnp.asarray(v, dtype=jnp.result_type(float)) for v in values])

    intro_time = _stack(
        [s.introduction_time if s.is_introduced else 0.0 for s in strains]
    )
    intro_scale = _stack(
        [
            s.introduction_scale
            if (s.is_introduced and s.introduction_scale is not None)
            else 1.0
            for s in strains
        ]
    )
    intro_perc = _stack(
        [
            s.introduction_percentage
            if (s.is_introduced and s.introduction_percentage is not None)
            else 0.0
            for s in strains
        ]
    )
    masks = []
    for s in strains:
        if s.introduction_ages_mask_vector is not None:
            masks.append(s.introduction_ages_mask_vector)
        else:
            masks.append([1] * A if s.is_introduced else [0] * A)
    intro_age_mask = jnp.asarray(masks, dtype=jnp.result_type(float))

    # immune-history structure
    members = _full_hist_members(L)
    assert len(members) == J, (
        "seip_odeparams requires a FullStratifiedImmuneHistoryDimension"
    )
    chi = np.zeros((L, J))
    hist_mask = np.zeros((L, J))
    names = [s.strain_name for s in strains]
    for j, mem in enumerate(members):
        for l_idx in range(L):
            if not mem:
                continue
            chi[l_idx, j] = max(
                tp.strain_interactions[names[l_idx]][names[m]] for m in mem
            )
            if l_idx in mem:
                hist_mask[l_idx, j] = 1.0
    # eta: recovery from (history j, strain l) lands in history j | {l}
    eta = np.zeros((J, L, J))
    index_of = {mem: j for j, mem in enumerate(members)}
    for j, mem in enumerate(members):
        for l_idx in range(L):
            eta[j, l_idx, index_of[frozenset(mem | {l_idx})]] = 1.0

    # vaccine efficacy (L, K+1)
    vax_eff = np.zeros((L, K_plus_1))
    for l_idx, s in enumerate(strains):
        if s.vaccine_efficacy:
            for dose, eff in s.vaccine_efficacy.items():
                if dose < K_plus_1:
                    vax_eff[l_idx, dose] = eff

    # waning
    wane_bins = s_comp.dimensions[3].bins
    omega = jnp.asarray(
        [0.0 if math.isinf(b.waiting_time) else 1.0 / b.waiting_time for b in wane_bins]
    )
    base_protection = jnp.asarray([b.base_protection for b in wane_bins])

    # vaccination splines
    if vax_spline_base_coeffs is None:
        base_coeffs = np.zeros((A, K_plus_1, 4))
        base_coeffs[:, :-1, 0] = daily_vax_rate  # constant uptake for k < K
        vax_spline_base_coeffs = jnp.asarray(base_coeffs)
        vax_spline_knots = jnp.zeros((A, K_plus_1, 1))
        vax_spline_knot_coeffs = jnp.zeros((A, K_plus_1, 1))

    init = config.initializer
    pop = jnp.asarray(init.age_demographics) * init.population_size

    tau = 182.5 - float(getattr(tp, "vaccination_season_change_day", 100.0))
    vax_dim = s_comp.dimensions[2]
    seasonal = bool(getattr(vax_dim, "seasonal_vaccination", False))

    return SEIPParams(
        beta=r0s / inf_p,
        sigma=1.0 / lat_p,
        gamma=1.0 / inf_p,
        contact=tp.contact_matrix,
        pop=pop,
        season_amp=jnp.asarray(getattr(tp, "season_amp", 0.0)),
        season_peak=jnp.asarray(getattr(tp, "season_peak", 0.0)),
        intro_time=intro_time,
        intro_scale=intro_scale,
        intro_perc=intro_perc,
        intro_age_mask=intro_age_mask,
        vax_knots=vax_spline_knots,
        vax_base_coeffs=vax_spline_base_coeffs,
        vax_knot_coeffs=vax_spline_knot_coeffs,
        seasonal_vax_tau=jnp.asarray(tau),
        omega=omega,
        base_protection=base_protection,
        chi=jnp.asarray(chi),
        vax_eff=jnp.asarray(vax_eff),
        hist_mask=jnp.asarray(hist_mask),
        min_homologous=jnp.asarray(
            getattr(tp, "min_homologous_immunity", 0.9)
        ),
        eta_onehot=jnp.asarray(eta),
        idx=config.idx,
        seasonal_vaccination=seasonal,
    )


def seip_initial_state(config: SimulationConfig) -> CompartmentState:
    """Initial compartment tuple for a ``seip_config`` config."""
    return config.initializer.get_initial_state(config)


# ---------------------------------------------------------------------------
# lane-major ensemble variant: batch axis LAST
# ---------------------------------------------------------------------------
# vmap-style batch-leading layouts put SEIP's tiny trailing dims (wane=4,
# strain=2) on the innermost (vectorized) dimensions -- a poorly filled
# vector unit. Writing the ensemble with an explicit trailing batch axis puts
# the 1000+-wide ensemble on the innermost, contiguous dimension instead,
# expressed in plain XLA (ops.seip_ensemble_solve runs this form).


def seip_ensemble_state(y0: CompartmentState, batch: int) -> CompartmentState:
    """Broadcast a single initial state to (..., batch)."""
    return tuple(
        jnp.broadcast_to(a[..., None], a.shape + (batch,)) for a in y0
    )


def seip_ensemble_params(base: SEIPParams, beta_scales: jnp.ndarray) -> SEIPParams:
    """Per-member transmission scaling: beta becomes (L, B).

    ``beta_scales`` is ``(B,)`` (one scale shared across strains) or
    ``(L, B)`` (per-strain scales -- the shape of the production fit's
    posterior draws, examples/seip_fit.py)."""
    scales = jnp.asarray(beta_scales)
    if scales.ndim == 1:
        scales = scales[None, :]
    return base.replace(beta=base.beta[:, None] * scales)


def seip_ode_ensemble_scatter(t, state: CompartmentState, p: SEIPParams):
    """``.at[slice].add`` form of :func:`seip_ode_ensemble` (equivalence
    reference + scatter-lowering benchmark; the pad-based default below
    avoids the scatter lowering).

    state: S (A,J,K,M,B); E/I/C (A,J,K,L,B). ``p.beta`` is (L, B); all other
    parameters are shared across the ensemble.
    """
    S, E, I, C = state

    season = 1.0 + p.season_amp * jnp.cos(
        2.0 * jnp.pi * (t - p.season_peak) / 365.0
    )
    pulse = (
        p.intro_perc
        * jnp.exp(-0.5 * ((t - p.intro_time) / p.intro_scale) ** 2)
        / (p.intro_scale * math.sqrt(2.0 * math.pi))
    )  # (L,)
    external = pulse[:, None] * p.intro_age_mask * p.pop[None, :]  # (L, A)
    infectious = jnp.sum(I, axis=(1, 2)) + external.T[..., None]  # (A, L, B)
    mixed = jnp.einsum("ac,clb->alb", p.contact, infectious, precision=_PREC)  # (A, L, B)
    lam = (p.beta[None, :, :] * season / p.pop[:, None, None]) * mixed

    ii = 1.0 - (1.0 - p.chi[:, :, None]) * (1.0 - p.vax_eff[:, None, :])
    wib = ii[..., None] * p.base_protection  # (L, J, K, M)
    fi = (p.min_homologous * p.hist_mask)[:, :, None, None]
    escape = 1.0 - (wib + (1.0 - wib) * fi)  # (L, J, K, M)

    # contract without materializing the rank-6 (A,J,K,M,L,B) exposure
    # tensor -- see the scalar RHS note
    new_exposed = (
        lam[:, None, None, :, :]
        * jnp.einsum("ljkm,ajkmb->ajklb", escape, S, precision=_PREC)
    )  # (A,J,K,L,B): sum over m
    dS = -jnp.einsum("alb,ljkm->ajkmb", lam, escape, precision=_PREC) * S  # sum over l
    dE = new_exposed - p.sigma[:, None] * E
    dI = p.sigma[:, None] * E - p.gamma[:, None] * I
    dC = new_exposed

    recovered = p.gamma[:, None] * I  # (A,J,K,L,B)
    rec_to_hist = jnp.einsum("ajklb,jlh->ahkb", recovered, p.eta_onehot, precision=_PREC)
    dS = dS.at[:, :, :, 0, :].add(rec_to_hist)

    nu = evaluate_cubic_spline(
        t, p.vax_knots, p.vax_base_coeffs, p.vax_knot_coeffs
    )  # (A, K)
    nu = jnp.clip(nu, 0.0, None)
    s_by_dose = S.sum(axis=(1, 3))  # (A, K, B)
    rate = jnp.minimum(
        nu[:, :, None] * p.pop[:, None, None] / jnp.maximum(s_by_dose, 1e-8),
        1.0,
    )  # (A, K, B)
    out_lower = rate[:, None, :-1, None, :] * S[:, :, :-1, :, :]
    dS = dS.at[:, :, :-1, :, :].add(-out_lower)
    dS = dS.at[:, :, 1:, 0, :].add(out_lower.sum(axis=3))
    out_top = rate[:, None, -1, None, :] * S[:, :, -1, 1:, :]
    dS = dS.at[:, :, -1, 1:, :].add(-out_top)
    dS = dS.at[:, :, -1, 0, :].add(out_top.sum(axis=2))

    if p.seasonal_vaccination:
        phi = _phi_seasonal(t, p.seasonal_vax_tau)
        dS = dS.at[:, :, -1, :, :].add(-phi * S[:, :, -1, :, :])
        dS = dS.at[:, :, -2, :, :].add(phi * S[:, :, -1, :, :])
        dE = dE.at[:, :, -1, :, :].add(-phi * E[:, :, -1, :, :])
        dE = dE.at[:, :, -2, :, :].add(phi * E[:, :, -1, :, :])
        dI = dI.at[:, :, -1, :, :].add(-phi * I[:, :, -1, :, :])
        dI = dI.at[:, :, -2, :, :].add(phi * I[:, :, -1, :, :])

    wane_out = p.omega[:, None] * S  # omega broadcast over (..., M, B)
    dS = dS - wane_out
    dS = dS.at[:, :, :, 1:, :].add(wane_out[:, :, :, :-1, :])

    return (dS, dE, dI, dC)


def _pad_axis(x, axis, before, after):
    """Zero-pad ``x`` along one axis (static widths)."""
    pads = [(0, 0)] * x.ndim
    pads[axis] = (before, after)
    return jnp.pad(x, pads)


def seip_ode_ensemble(t, state: CompartmentState, p: SEIPParams):
    """Fused SEIP RHS over a trailing ensemble axis (scatter-free).

    state: S (A,J,K,M,B); E/I/C (A,J,K,L,B). ``p.beta`` is (L, B); all
    other parameters are shared across the ensemble. Every compartment-flow
    increment is a zero-padded full-shape add rather than ``.at[].add``:
    XLA's scatter lowering can materialize operand copies, while pads
    are pure dataflow that fuses into the elementwise graph. Equivalence vs the
    scatter form is pinned in tests/test_dynamics/test_seip.py.
    """
    S, E, I, C = state
    M = S.shape[3]
    K = S.shape[2]

    season = 1.0 + p.season_amp * jnp.cos(
        2.0 * jnp.pi * (t - p.season_peak) / 365.0
    )
    pulse = (
        p.intro_perc
        * jnp.exp(-0.5 * ((t - p.intro_time) / p.intro_scale) ** 2)
        / (p.intro_scale * math.sqrt(2.0 * math.pi))
    )  # (L,)
    external = pulse[:, None] * p.intro_age_mask * p.pop[None, :]  # (L, A)
    infectious = jnp.sum(I, axis=(1, 2)) + external.T[..., None]  # (A, L, B)
    mixed = jnp.einsum("ac,clb->alb", p.contact, infectious, precision=_PREC)  # (A, L, B)
    lam = (p.beta[None, :, :] * season / p.pop[:, None, None]) * mixed

    ii = 1.0 - (1.0 - p.chi[:, :, None]) * (1.0 - p.vax_eff[:, None, :])
    wib = ii[..., None] * p.base_protection  # (L, J, K, M)
    fi = (p.min_homologous * p.hist_mask)[:, :, None, None]
    escape = 1.0 - (wib + (1.0 - wib) * fi)  # (L, J, K, M)

    new_exposed = (
        lam[:, None, None, :, :]
        * jnp.einsum("ljkm,ajkmb->ajklb", escape, S, precision=_PREC)
    )  # (A,J,K,L,B)
    dS = -jnp.einsum("alb,ljkm->ajkmb", lam, escape, precision=_PREC) * S
    dE = new_exposed - p.sigma[:, None] * E
    dI = p.sigma[:, None] * E - p.gamma[:, None] * I
    dC = new_exposed

    recovered = p.gamma[:, None] * I  # (A,J,K,L,B)
    rec_to_hist = jnp.einsum("ajklb,jlh->ahkb", recovered, p.eta_onehot, precision=_PREC)
    # place at wane bin 0: (A,J,K,B) -> (A,J,K,1,B) zero-padded to M
    dS = dS + _pad_axis(rec_to_hist[:, :, :, None, :], 3, 0, M - 1)

    nu = evaluate_cubic_spline(
        t, p.vax_knots, p.vax_base_coeffs, p.vax_knot_coeffs
    )  # (A, K)
    nu = jnp.clip(nu, 0.0, None)
    s_by_dose = S.sum(axis=(1, 3))  # (A, K, B)
    rate = jnp.minimum(
        nu[:, :, None] * p.pop[:, None, None] / jnp.maximum(s_by_dose, 1e-8),
        1.0,
    )  # (A, K, B)
    out_lower = rate[:, None, :-1, None, :] * S[:, :, :-1, :, :]
    dS = dS - _pad_axis(out_lower, 2, 0, 1)
    dS = dS + _pad_axis(
        _pad_axis(out_lower.sum(axis=3)[:, :, :, None, :], 3, 0, M - 1),
        2, 1, 0,
    )
    out_top = rate[:, None, -1, None, :] * S[:, :, -1, 1:, :]  # (A,J,M-1,B)
    dS = dS - _pad_axis(
        _pad_axis(out_top[:, :, None, :, :], 3, 1, 0), 2, K - 1, 0
    )
    dS = dS + _pad_axis(
        _pad_axis(out_top.sum(axis=2)[:, :, None, None, :], 3, 0, M - 1),
        2, K - 1, 0,
    )

    if p.seasonal_vaccination:
        phi = _phi_seasonal(t, p.seasonal_vax_tau)

        def season_shift(X):
            # -phi*X at dose K-1, +phi*X at dose K-2, zeros elsewhere
            shift = phi * X[:, :, -1, ...]
            pair = jnp.stack([shift, -shift], axis=2)  # (A,J,2,...)
            return _pad_axis(pair, 2, K - 2, 0)

        dS = dS + season_shift(S)
        dE = dE + season_shift(E)
        dI = dI + season_shift(I)

    wane_out = p.omega[:, None] * S
    dS = dS - wane_out
    dS = dS + _pad_axis(wane_out[:, :, :, :-1, :], 3, 1, 0)

    return (dS, dE, dI, dC)


__all__ = [
    "SEIPParams",
    "seip_ode",
    "seip_ode_scatter",
    "seip_ode_ensemble",
    "seip_ode_ensemble_scatter",
    "seip_ensemble_state",
    "seip_ensemble_params",
    "SEIPInitializer",
    "seip_config",
    "seip_odeparams",
    "seip_initial_state",
]
