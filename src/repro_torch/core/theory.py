"""Empirical checks of the paper's theorems.

The port of ``repro/core/theory.py`` (numpy on the host, with
``variance_trace`` running its seeds through the port's `sweep`):

- Theorem 1/3 (convergence in expectation): regret R[X]/T computed from the
  per-clock view losses must decay like O(1/sqrt(T)).
- Theorem 5 (convergence in probability): the deviation bound depends on the
  staleness moments (μ_γ, σ_γ); both sides' ingredients are computed here.
- Theorem 2/6 (decreasing variance): Var_t of the iterate across independent
  seeds must decrease as the algorithm approaches the optimum.
"""
from __future__ import annotations

import numpy as np

from ..psrun.validate import _np
from .consistency import ConsistencyConfig
from .ps import PSApp


def regret_curve(loss_view, loss_star: float) -> np.ndarray:
    """R[X]/T over clocks: mean excess loss of the noisy views.

    ``loss_view[t]`` plays the role of f_t(x̃_t); ``loss_star`` approximates
    f(x*)/T (per-clock optimal loss).
    """
    excess = _np(loss_view).astype(np.float64) - loss_star
    return np.cumsum(excess) / (np.arange(len(excess)) + 1.0)


def sqrt_decay_fit(curve, skip: int = 10) -> float:
    """Fit curve[t] ~ a / sqrt(t); returns the fitted exponent from a
    log-log regression (should be <= ~-0.3 for O(T^{-1/2})-style decay)."""
    curve = _np(curve)
    t = np.arange(len(curve), dtype=np.float64) + 1.0
    t, y = t[skip:], np.maximum(np.asarray(curve[skip:], np.float64), 1e-12)
    A = np.stack([np.log(t), np.ones_like(t)], -1)
    coef, *_ = np.linalg.lstsq(A, np.log(y), rcond=None)
    return float(coef[0])


def variance_trace(app: PSApp, cfg: ConsistencyConfig, n_clocks: int,
                   n_seeds: int = 8) -> np.ndarray:
    """Var_t = Σ_i E[x̃_{t,i}²] − E[x̃_{t,i}]² across seeds (paper Thm 2/6).

    Runs ``n_seeds`` independent simulations through `sweep` and returns
    the summed component-wise variance of worker-0's view at every clock.
    """
    from .sweep import sweep

    res = sweep(app, [cfg], n_clocks, seeds=n_seeds, record_views=True)
    views = _np(res.traces[0].views0).astype(np.float64)     # [S, T, d]
    return views.var(axis=0).sum(axis=-1)                    # [T]


def theorem5_bound(T: int, s: int, P: int, eta: float, L: float, F: float,
                   mu_gamma: float, sigma_gamma: float, tau: float) -> dict:
    """Evaluate both sides of Theorem 5's tail bound for given constants.

    Returns the deviation threshold (the 1/sqrt(T)(ηL² + F²/η + 2ηL²μ_γ)
    term) and the exponential tail probability for deviation ``tau``.
    """
    thresh = (eta * L**2 + F**2 / eta + 2 * eta * L**2 * mu_gamma) / np.sqrt(T)
    eta_bar = eta**2 * L**4 * (np.log(T) + 1.0) / T
    denom = (2 * eta_bar * sigma_gamma
             + (2.0 / 3) * eta * L**2 * (2 * s + 1) * P * tau)
    tail = float(np.exp(-T * tau**2 / max(denom, 1e-12)))
    return {"threshold": float(thresh), "tail_prob": tail,
            "eta_bar": float(eta_bar)}
