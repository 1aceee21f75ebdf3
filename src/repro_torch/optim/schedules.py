"""Learning-rate schedules (counterpart of ``repro.optim.schedules``).

Each schedule maps the 1-based step to a float computed in float32, as the
reference computes it on the device.  ``inverse_power_schedule`` is the
paper's alpha_k = alpha0 / k^eta (eta = 0 -> constant; eta = 1/2 is
Theorem 3's fastest admissible diminishing rate).
"""
from __future__ import annotations

import numpy as np

__all__ = ["constant_schedule", "inverse_power_schedule",
           "cosine_warmup_schedule"]

_f32 = np.float32


def constant_schedule(lr: float):
    return lambda step: float(_f32(lr))


def inverse_power_schedule(alpha0: float, eta: float = 0.5):
    """alpha_k = alpha0 / max(1, k)^eta — paper step-size rule."""
    def f(step):
        k = np.maximum(_f32(1.0), _f32(step))
        return float(_f32(alpha0) / k ** _f32(eta))
    return f


def cosine_warmup_schedule(peak: float, warmup: int, total: int,
                           floor_frac: float = 0.1):
    def f(step):
        s = _f32(step)
        if s < warmup:
            return float(_f32(peak) * s / _f32(max(warmup, 1)))
        t = np.clip((s - _f32(warmup)) / _f32(max(total - warmup, 1)),
                    _f32(0.0), _f32(1.0))
        return float(_f32(peak) * (_f32(floor_frac) + _f32(1 - floor_frac)
                                   * _f32(0.5) * (_f32(1) + np.cos(
                                       _f32(np.pi) * t))))
    return f
