"""Plain PyTorch versions of the int8 wire kernels (the parity oracles).

Counterparts of ``repro.kernels.ref``.  Every arithmetic step is one
correctly-rounded float32 operation in the reference's order, so on any
device these give the same bits as the CUDA kernels (which spell the same
operations with ``__fdiv_rn``/``__fmul_rn``/``__fadd_rn``).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["quantize_blocks_ref", "dequant_combine_ref", "combine_core",
           "INV_127"]

#: float32(1/127), the adaptive-scale multiplier.  The reference multiplies
#: by this reciprocal rather than dividing by 127; its bit pattern is
#: 0x3C010204, which the CUDA kernel spells literally.
INV_127 = float(np.float32(1.0 / 127.0))


def quantize_blocks_ref(y: torch.Tensor, noise: torch.Tensor,
                        fixed_step: float | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stochastic int8 quantization of ``(n, block)`` rows.

    adaptive (``fixed_step`` None): per-row scale = max(|y|, 1e-30) *
    f32(1/127) (never clips); fixed: every row's scale is ``fixed_step``
    (clips at +-127).  code = floor(y/scale) + (noise < frac(y/scale)).
    Returns (codes int8 (n, block), scales f32 (n, 1)).
    """
    y32 = y.to(torch.float32)
    if fixed_step is None:
        absmax = y32.abs().amax(dim=-1, keepdim=True)
        scales = torch.clamp_min(absmax, float(np.float32(1e-30))) * INV_127
    else:
        scales = torch.full((y.shape[0], 1), float(np.float32(fixed_step)),
                            dtype=torch.float32, device=y.device)
    s = y32 / scales
    lo = torch.floor(s)
    frac = s - lo
    q = lo + (noise < frac).to(torch.float32)
    codes = torch.clamp(q, -127.0, 127.0).to(torch.int8)
    return codes, scales


def combine_core(d_self, d_l, d_r, x_tilde, m_agg, w_self: float,
                 w_side: float, deamp: float):
    """The receive-side update every codec shares, on decoded values::

        x_tilde' = x_tilde + deamp * d_self
        m_agg'   = m_agg + (w_side * deamp) * (d_l + d_r)
        combined = w_self * x_tilde' + m_agg'

    The scalar weights are rounded to float32 first and ``w_side * deamp``
    is one float32 product, as in the reference's left-to-right evaluation.
    """
    w_self32 = float(np.float32(w_self))
    deamp32 = float(np.float32(deamp))
    side = float(np.float32(w_side) * np.float32(deamp))
    x_t = x_tilde + deamp32 * d_self
    m = m_agg + side * (d_l + d_r)
    combined = w_self32 * x_t + m
    return x_t, m, combined


def dequant_combine_ref(codes_self, scale_self, codes_left, scale_left,
                        codes_right, scale_right, x_tilde, m_agg,
                        w_self: float, w_side: float, deamp: float):
    """Fused de-amplify + x_tilde integration + ring combine of int8 codes
    and their scales: ``combine_core`` on ``codes * scale``."""
    return combine_core(codes_self.to(torch.float32) * scale_self,
                        codes_left.to(torch.float32) * scale_left,
                        codes_right.to(torch.float32) * scale_right,
                        x_tilde, m_agg, w_self, w_side, deamp)
