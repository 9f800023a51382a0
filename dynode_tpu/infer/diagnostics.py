"""MCMC diagnostics: effective sample size, split-Rhat, HDI, summaries.

Standalone replacements for the arviz/numpyro diagnostics the reference
leans on for fit assessment (reference exports fits via arviz --
src/dynode/infer/inference.py:208-241). ESS uses Geyer's initial monotone
positive sequence over FFT autocovariances; Rhat is rank-free split-Rhat.
"""

from typing import Dict

import numpy as np


def _autocovariance(x: np.ndarray) -> np.ndarray:
    """Biased autocovariance per chain via FFT. x: (chains, draws)."""
    n = x.shape[-1]
    x = x - x.mean(axis=-1, keepdims=True)
    size = 2 ** int(np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(x, size, axis=-1)
    acov = np.fft.irfft(f * np.conjugate(f), size, axis=-1)[..., :n]
    return np.real(acov) / n


def effective_sample_size(x: np.ndarray) -> float:
    """ESS of a (chains, draws) scalar-parameter array (Geyer 1992 / Stan)."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[None, :]
    m, n = x.shape
    if n < 4:
        return float(m * n)
    acov = _autocovariance(x)  # (m, n)
    chain_var = acov[:, 0] * n / (n - 1.0)
    mean_var = np.mean(chain_var)
    var_plus = mean_var * (n - 1.0) / n
    if m > 1:
        var_plus += np.var(x.mean(axis=1), ddof=1)
    if var_plus <= 0.0:
        # a zero-variance (constant) series carries no sampling
        # information -- ESS is undefined (arviz convention: NaN)
        return float("nan")

    rho_hat = np.zeros(n)
    rho_hat[0] = 1.0
    # Geyer pairs: keep adding while the pair sums stay positive & monotone
    t = 1
    last_pair = None
    while t + 1 < n:
        pair = (
            1.0
            - (mean_var - np.mean(acov[:, t])) / var_plus
            + 1.0
            - (mean_var - np.mean(acov[:, t + 1])) / var_plus
        )
        if pair < 0:
            break
        if last_pair is not None:
            pair = min(pair, last_pair)
        last_pair = pair
        rho_hat[t] = 1.0 - (mean_var - np.mean(acov[:, t])) / var_plus
        rho_hat[t + 1] = 1.0 - (mean_var - np.mean(acov[:, t + 1])) / var_plus
        t += 2
    tau = 1.0 + 2.0 * np.sum(rho_hat[1:t])
    return float(m * n / max(tau, 1e-12))


def _split_chains(x: np.ndarray) -> np.ndarray:
    """(chains, draws) -> (2*chains, draws//2) split halves."""
    m, n = x.shape
    half = n // 2
    return np.concatenate([x[:, :half], x[:, half : 2 * half]], axis=0)


def _rank_normalize(x: np.ndarray) -> np.ndarray:
    """Fractional ranks across ALL draws -> standard-normal quantiles.

    The Vehtari et al. (2021) transform that makes ESS/Rhat robust to
    heavy tails and nonlinear scale: rank over the pooled sample, map
    rank r to Phi^-1((r - 3/8) / (N + 1/4)).
    """
    from scipy.special import ndtri  # local: scipy is a test/diag dep only

    shape = x.shape
    flat = x.ravel()
    ranks = np.empty_like(flat)
    ranks[np.argsort(flat, kind="stable")] = np.arange(1, flat.size + 1)
    return ndtri((ranks - 0.375) / (flat.size + 0.25)).reshape(shape)


def ess_bulk(x: np.ndarray) -> float:
    """Rank-normalized split-chain bulk ESS (Vehtari et al. 2021).

    Robust where the plain :func:`effective_sample_size` is fooled:
    heavy-tailed posteriors and location-drifting chains. The arviz
    ``ess(method="bulk")`` analog.
    """
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[None, :]
    if x.shape[-1] < 4:
        return float(x.size)
    return effective_sample_size(_rank_normalize(_split_chains(x)))


def ess_tail(x: np.ndarray, prob: float = 0.9) -> float:
    """Tail ESS: min ESS of the 5%/95% quantile indicators (arviz analog).

    Measures how well the chain resolves the distribution *tails* --
    a bank can have huge bulk ESS yet poorly-mixed extremes (exactly the
    failure mode of a stuck or step-size-collapsed chain).
    """
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[None, :]
    if x.shape[-1] < 4:
        return float(x.size)
    lo, hi = (1.0 - prob) / 2.0, 1.0 - (1.0 - prob) / 2.0
    xs = _split_chains(x)
    out = []
    for q in (lo, hi):
        ind = (xs <= np.quantile(xs, q)).astype(np.float64)
        out.append(effective_sample_size(ind))
    # a NaN side means a degenerate (constant) tail indicator -- a mass
    # point at the extreme value; propagate the NaN loudly
    return float(np.min(out))


def mcse_mean(x: np.ndarray) -> float:
    """Monte-Carlo standard error of the posterior mean: sd / sqrt(ESS)."""
    x = np.asarray(x, dtype=np.float64)
    ess = ess_bulk(x)
    return float(x.std(ddof=1) / np.sqrt(max(ess, 1e-12)))


def split_rhat(x: np.ndarray) -> float:
    """Split-Rhat of a (chains, draws) scalar-parameter array."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[None, :]
    m, n = x.shape
    half = n // 2
    if half < 2:
        return float("nan")
    splits = np.concatenate([x[:, :half], x[:, half : 2 * half]], axis=0)
    sm, sn = splits.shape
    chain_means = splits.mean(axis=1)
    chain_vars = splits.var(axis=1, ddof=1)
    w = chain_vars.mean()
    b = sn * chain_means.var(ddof=1)
    var_plus = (sn - 1.0) / sn * w + b / sn
    return float(np.sqrt(var_plus / max(w, 1e-300)))


def hdi(samples: np.ndarray, prob: float = 0.9) -> np.ndarray:
    """Highest-density interval of a 1-D sample array -> [low, high]."""
    x = np.sort(np.asarray(samples).ravel())
    n = len(x)
    span = max(int(np.floor(prob * n)), 1)
    widths = x[span:] - x[: n - span]
    i = int(np.argmin(widths)) if len(widths) else 0
    return np.array([x[i], x[min(i + span, n - 1)]])


def summary(
    samples_by_chain: Dict[str, np.ndarray], prob: float = 0.9
) -> Dict[str, Dict[str, float]]:
    """Per-site summary (flattening plated sites): mean/std/hdi/ess/rhat.

    Expects (chains, draws, *plate) arrays.
    """
    out: Dict[str, Dict[str, float]] = {}
    for name, arr in samples_by_chain.items():
        arr = np.asarray(arr)
        if arr.ndim < 2:
            arr = arr.reshape(1, -1)
        plate_shape = arr.shape[2:]
        for idx in np.ndindex(*plate_shape) if plate_shape else [()]:
            # f64 accumulation is NOT optional: numpy's strided-axis mean
            # over millions of NEAR-CONSTANT f32 draws accumulates naively,
            # and once the partial sum is ~2^23x the addend each add rounds
            # to a coarse grid -- a 4096x1600 bank's mean came out 1.034
            # for draws centered at 1.106 (6% systematic bias toward round
            # numbers -- enough to look like a posterior drifting toward
            # the prior).
            sub = np.asarray(
                arr[(slice(None), slice(None)) + idx], dtype=np.float64
            )
            key = name + ("_" + "_".join(map(str, idx)) if idx else "")
            low, high = hdi(sub, prob)
            out[key] = {
                "mean": float(sub.mean()),
                "std": float(sub.std()),
                f"hdi_{prob:.0%}_low": float(low),
                f"hdi_{prob:.0%}_high": float(high),
                "n_eff": effective_sample_size(sub),
                "ess_bulk": ess_bulk(sub),
                "ess_tail": ess_tail(sub),
                "mcse_mean": mcse_mean(sub),
                "r_hat": split_rhat(sub),
            }
    return out


__all__ = [
    "effective_sample_size",
    "ess_bulk",
    "ess_tail",
    "mcse_mean",
    "split_rhat",
    "hdi",
    "summary",
]
