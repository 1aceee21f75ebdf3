"""Convergence-theory utilities (validating the paper's Theorems 1-3);
counterpart of ``repro.core.theory`` (numpy only).

These are used by the validation tests and benchmarks to check that measured
behavior matches the paper's predicted rates and error balls.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "error_ball_radius",
    "fit_loglog_rate",
    "theoretical_rate_exponent",
    "max_constant_stepsize",
]


def error_ball_radius(alpha: float, grad_bound: float, beta: float) -> float:
    """Theorem 1 consensus error ball: alpha * D / (1 - beta)."""
    return alpha * grad_bound / (1.0 - beta)


def max_constant_stepsize(lambda_n: float, lipschitz: float) -> float:
    """Theorem 2 step-size condition: alpha < (1 + lambda_N(W)) / L."""
    return (1.0 + lambda_n) / lipschitz


def theoretical_rate_exponent(gamma: float, eta: float) -> float:
    """Rate exponent for E||grad||^2 ~ k^{-r}.

    Constant step (eta=0):   r = min(1, gamma)  until the error ball
    (Remark 2).  Diminishing: o(1/k^{1-eta}) (Theorem 3) -> r = 1 - eta.
    """
    if eta == 0.0:
        return min(1.0, gamma)
    return 1.0 - eta


def fit_loglog_rate(values: np.ndarray, start_frac: float = 0.2,
                    end_frac: float = 1.0) -> float:
    """Fit r in values[k] ~ C * k^{-r} over a window by log-log regression.

    Returns the positive decay exponent r (negative slope).
    """
    values = np.asarray(values, dtype=np.float64)
    n = len(values)
    lo, hi = int(n * start_frac), int(n * end_frac)
    ks = np.arange(1, n + 1, dtype=np.float64)[lo:hi]
    vs = np.clip(values[lo:hi], 1e-300, None)
    slope, _ = np.polyfit(np.log(ks), np.log(vs), 1)
    return float(-slope)
