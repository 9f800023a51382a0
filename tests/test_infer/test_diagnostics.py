"""Diagnostics against known-answer cases.

ESS on iid draws ~= n; on AR(1) with autocorrelation rho the asymptotic
ESS is n * (1 - rho) / (1 + rho); rank-normalized bulk ESS must be robust
to monotone reparameterization (heavy tails); tail ESS must flag a chain
whose extremes never move; mcse_mean ~= sd/sqrt(n) for iid draws.
"""

import numpy as np

from dynode_tpu.infer.diagnostics import (
    effective_sample_size,
    ess_bulk,
    ess_tail,
    hdi,
    mcse_mean,
    split_rhat,
    summary,
)

RNG = np.random.default_rng(0)


def _ar1(rho, m=4, n=4000):
    x = np.empty((m, n))
    x[:, 0] = RNG.standard_normal(m)
    innov = RNG.standard_normal((m, n)) * np.sqrt(1 - rho**2)
    for t in range(1, n):
        x[:, t] = rho * x[:, t - 1] + innov[:, t]
    return x


def test_ess_iid_close_to_n():
    x = RNG.standard_normal((4, 2000))
    for fn in (effective_sample_size, ess_bulk):
        ess = fn(x)
        assert 0.75 * x.size < ess < 1.35 * x.size, (fn.__name__, ess)


def test_ess_ar1_matches_theory():
    rho = 0.7
    x = _ar1(rho)
    want = x.size * (1 - rho) / (1 + rho)
    got = effective_sample_size(x)
    assert 0.6 * want < got < 1.5 * want, (got, want)
    got_bulk = ess_bulk(x)
    assert 0.6 * want < got_bulk < 1.5 * want, (got_bulk, want)


def test_ess_bulk_invariant_under_monotone_transform():
    """exp() blows up the tails; plain ESS moves, rank-normalized doesn't."""
    x = _ar1(0.5, m=4, n=2000)
    bulk_raw = ess_bulk(x)
    bulk_exp = ess_bulk(np.exp(3.0 * x))
    assert abs(bulk_exp - bulk_raw) / bulk_raw < 0.05  # ranks are identical


def test_ess_tail_flags_sticky_extremes():
    """Chains that explore the bulk but get STUCK whenever they reach a
    tail (long runs at |x| > 1.2) -- bulk mixing looks plausible while the
    tails are barely resolved."""
    rng = np.random.default_rng(7)
    healthy = rng.standard_normal((4, 1000))
    assert ess_tail(healthy) > 0.3 * healthy.size
    sick = healthy.copy()
    for c in range(4):
        for t in range(1, 1000):
            if abs(sick[c, t - 1]) > 1.2 and rng.random() < 0.97:
                sick[c, t] = sick[c, t - 1]
    assert ess_tail(sick) < 0.05 * sick.size
    assert ess_tail(sick) < ess_bulk(sick)


def test_ess_nan_on_constant_series():
    const = np.full((4, 500), 2.0)
    assert np.isnan(effective_sample_size(const))
    # a frozen chain puts a mass point at the extreme: tail ESS goes NaN
    rng = np.random.default_rng(3)
    sick = rng.standard_normal((4, 1000))
    sick[0, :] = 5.0
    assert np.isnan(ess_tail(sick))


def test_mcse_mean_iid():
    x = RNG.standard_normal((4, 4000))
    want = x.std(ddof=1) / np.sqrt(x.size)
    got = mcse_mean(x)
    assert 0.7 * want < got < 1.4 * want


def test_split_rhat_detects_drift():
    good = RNG.standard_normal((4, 1000))
    assert split_rhat(good) < 1.01
    drift = good + np.linspace(0, 3, 1000)[None, :]
    assert split_rhat(drift) > 1.2


def test_hdi_contains_mass():
    x = RNG.standard_normal(20000)
    low, high = hdi(x, 0.9)
    frac = np.mean((x >= low) & (x <= high))
    assert 0.88 < frac < 0.92
    assert abs(low + 1.645) < 0.1 and abs(high - 1.645) < 0.1


def test_summary_has_new_columns():
    s = summary({"theta": RNG.standard_normal((4, 500, 2))})
    assert set(s) == {"theta_0", "theta_1"}
    row = s["theta_0"]
    for col in ("mean", "std", "n_eff", "ess_bulk", "ess_tail",
                "mcse_mean", "r_hat"):
        assert col in row, col
        assert np.isfinite(row[col]), col


def test_summary_mean_immune_to_f32_accumulation():
    """Host-side f64 accumulation regression (round-4 discovery).

    numpy's strided-axis mean over millions of NEAR-CONSTANT float32
    draws accumulates naively; once the partial sum is ~2^23x the addend
    every add rounds to a coarse grid and the mean is biased several
    percent toward round numbers. A real 4096x1600 ChEES bank centered
    at 1.106 reported an f32 overall mean of 1.035 -- a 'posterior
    drifting toward the prior' that was THIS artifact, not corruption
    (per-chain f64 means were all at the posterior). summary() must
    accumulate in f64.
    """
    rng = np.random.default_rng(0)
    base = np.array([1.1063, 0.9486, 1.0474])
    arr = (base + rng.normal(0, 0.003, (2048, 1600, 3))).astype(np.float32)
    # the naive f32 STRIDED-axis mean IS visibly biased at this size
    # (full contiguous reductions use pairwise summation and stay
    # accurate -- the hazard is specifically axis-0 means over plated
    # columns, the exact shape of posterior-mean reporting). If numpy
    # ever fixes strided accumulation this guard tells us the regression
    # test lost its teeth.
    naive = arr.reshape(-1, 3).mean(axis=0)
    assert np.max(np.abs(naive - base)) > 5e-3
    stats = summary({"x": arr})
    for k in range(3):
        s = stats[f"x_{k}"]
        assert abs(s["mean"] - base[k]) < 5e-4, (k, s["mean"])
        assert abs(s["std"] - 0.003) < 2e-4
