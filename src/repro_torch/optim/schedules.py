"""Learning-rate schedules (counterpart of ``repro.optim.schedules``).

Each schedule maps the 1-based step to the float32 value the reference
computes under ``jit`` (``core.f32``): XLA turns ``alpha0 / k**eta`` into
``alpha0 * pow(k, -eta)`` and each division by a constant into a product
with its float32 reciprocal, and contracts a product and a sum into a
fused multiply-add.  ``inverse_power_schedule`` is the paper's
alpha_k = alpha0 / k^eta (eta = 0 -> constant; eta = 1/2 is Theorem 3's
fastest admissible diminishing rate).
"""
from __future__ import annotations

import numpy as np

from ..core.f32 import cosf, f32, fma, over_power, recip

__all__ = ["constant_schedule", "inverse_power_schedule",
           "cosine_warmup_schedule"]


def constant_schedule(lr: float):
    return lambda step: float(f32(lr))


def inverse_power_schedule(alpha0: float, eta: float = 0.5):
    """alpha_k = alpha0 / max(1, k)^eta — paper step-size rule."""
    def f(step):
        return float(over_power(alpha0, max(f32(1.0), f32(step)), eta))
    return f


def cosine_warmup_schedule(peak: float, warmup: int, total: int,
                           floor_frac: float = 0.1):
    # peak * s / warmup compiles to s * (peak * (1 / warmup)), folded in
    # float32; (s - warmup) / span to (s + (-warmup)) * (1 / span)
    warm_rate = f32(f32(peak) * recip(max(warmup, 1)))
    inv_span = recip(max(total - warmup, 1))

    def f(step):
        s = f32(step)
        if s < warmup:
            return float(f32(s * warm_rate))
        t = min(max(f32((s + f32(-warmup)) * inv_span), f32(0.0)),
                f32(1.0))
        c = cosf(f32(f32(np.pi) * t))
        # (1 + cos) * 0.45 + floor_frac is one fused multiply-add
        mix = fma(f32(c + f32(1.0)), (1 - floor_frac) * 0.5, floor_frac)
        return float(f32(mix * f32(peak)))
    return f
