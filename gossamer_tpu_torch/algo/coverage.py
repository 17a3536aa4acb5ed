"""Coverage-model estimation over count histograms (host copy of
``gossamer_tpu/algo/coverage.py``).

The reference fits a mixture model (error spike + Poisson-ish coverage
peaks) with Levenberg-Marquardt (``src/EstimateGraphStatistics.{hh,cc}``,
``src/LevenbergMarquardt.cc``) to infer trim cutoffs and expected
coverage.  We implement the two consumers:

* :func:`estimate_trim_cutoff` — default cutoff for ``trim-graph``;
* :func:`estimate_coverage` — expected coverage for the threaders
  (``GossCmdThreadPairs.cc:763-787``).

The estimator here finds the valley between the error component and the
main coverage mode of the weighted histogram, which reproduces the
reference's behavior on well-behaved libraries without the LM machinery;
the fit can be swapped in behind the same API.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CoverageModel:
    """Fitted mixture: mix*Poisson(lam) errors + (1-mix)*Normal(mean, std)
    signal (``EstimateGraphStatistics.cc:28-58`` ``kmerModel``)."""

    mix: float
    lam: float
    mean: float
    std: float
    chi_sq: float
    dof: int

    def fits(self) -> bool:
        from scipy.stats import chi2

        if self.dof <= 0 or not np.isfinite(self.chi_sq):
            return False
        return self.chi_sq < chi2.ppf(0.99, self.dof)

    def coverage(self) -> float:
        return self.mean

    def trim_point(self, good_rhomer_cutoff: float = 0.0001) -> int:
        """``calculateEstimates`` (``EstimateGraphStatistics.cc:188-207``)."""
        from scipy.stats import norm

        left = norm.cdf(0, self.mean, self.std)
        cutoff = norm.ppf(good_rhomer_cutoff + left, self.mean, self.std)
        return int(max(cutoff, 0.0))


def fit_coverage_model(
    mult: np.ndarray, freq: np.ndarray, outlier_limit: float = 0.999
) -> CoverageModel | None:
    """Levenberg-Marquardt fit of the reference's histogram mixture.

    Mirrors ``CleanedUpData`` (``EstimateGraphStatistics.cc:85-138``):
    needs >= 50 distinct multiplicities, normalizes mass to 1000, drops
    the outlier tail, seeds [0.5, 1.0, maxx/2, maxx/4].
    """
    if len(mult) < 50:
        return None
    from scipy.optimize import least_squares
    from scipy.stats import norm, poisson

    total = float(freq.sum())
    scale = 1000.0 / total
    order = np.argsort(mult)
    x = mult[order].astype(np.float64)
    y = freq[order].astype(np.float64) * scale
    cum = np.cumsum(freq[order])
    cutoff_idx = int(np.searchsorted(cum, total * outlier_limit + 0.99)) + 1
    x = x[:cutoff_idx]
    y = y[:cutoff_idx]
    if len(x) < 10:
        return None
    maxx = x.max()

    def model(p):
        mix, lam, mean, std = p
        if std <= 0 or lam <= 0 or not (0 <= mix <= 1) or mean < 0:
            return np.full_like(x, 1e6)
        mass0 = mix * poisson.pmf(0, lam) + (1 - mix) * norm.pdf(0, mean, std)
        s = 1000.0 / max(1.0 - mass0, 1e-9)
        return s * (mix * poisson.pmf(x, lam) + (1 - mix) * norm.pdf(x, mean, std))

    p0 = np.array([0.5, 1.0, maxx * 0.5, maxx * 0.25])
    try:
        res = least_squares(lambda p: model(p) - y, p0, method="lm",
                            max_nfev=2000)
    except Exception:
        return None
    mix, lam, mean, std = res.x
    f = model(res.x)
    chi = float(np.sum((y - f) ** 2 / np.maximum(f, 1e-9)))
    return CoverageModel(float(mix), float(lam), float(mean), float(abs(std)),
                         chi, len(x) - 4)


def _dense_hist(mult: np.ndarray, freq: np.ndarray, limit: int = 10000):
    if len(mult) == 0:
        return np.zeros(1, dtype=np.float64)
    m = int(min(mult.max(), limit))
    h = np.zeros(m + 1, dtype=np.float64)
    sel = mult <= m
    h[mult[sel].astype(np.int64)] = freq[sel]
    return h


def estimate_coverage(mult: np.ndarray, freq: np.ndarray) -> int:
    """Expected rho-mer coverage: LM mixture fit when it converges
    (reference ``EstimateCoverageOnly``), histogram-mode fallback."""
    model = fit_coverage_model(mult, freq)
    if model is not None and model.fits() and model.mean > 1:
        return max(int(round(model.mean)), 1)
    h = _dense_hist(mult, freq)
    if len(h) <= 2:
        return max(int(mult[np.argmax(freq)]) if len(mult) else 1, 1)
    # skip the error spike: find first local minimum, then the max after it
    valley = _first_valley(h)
    mode = valley + int(np.argmax(h[valley:]))
    return max(mode, 1)


def estimate_trim_cutoff(mult: np.ndarray, freq: np.ndarray) -> int:
    """Default trim cutoff: LM-model trim point when the fit converges
    (``EstimateGraphStatistics::estimateTrimPoint``), valley fallback."""
    model = fit_coverage_model(mult, freq)
    if model is not None and model.fits():
        tp = model.trim_point()
        if tp >= 1:
            return tp
    h = _dense_hist(mult, freq)
    if len(h) <= 2:
        return 2
    valley = _first_valley(h)
    return max(int(valley), 2)


def _first_valley(h: np.ndarray) -> int:
    i = 1
    n = len(h)
    while i + 1 < n and h[i + 1] <= h[i]:
        i += 1
    return i if i + 1 < n else 1
