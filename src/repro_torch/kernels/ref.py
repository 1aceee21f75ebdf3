"""Plain PyTorch versions of the int8 wire kernels and of the flash-decode
kernel (the parity oracles).

Counterparts of ``repro.kernels.ref``.  In the wire oracles every
arithmetic step is one correctly-rounded float32 operation in the
reference's order, so on any device they give the same bits as the CUDA
kernels (which spell the same operations with
``__fdiv_rn``/``__fmul_rn``/``__fadd_rn``).  ``gqa_decode_ref`` is the
reference's arithmetic in one pass over the cache; the CUDA kernel sums in
another order and agrees to float32 rounding.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["quantize_blocks_ref", "dequant_combine_ref", "combine_core",
           "gqa_decode_ref", "INV_127"]

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


def gqa_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   valid: torch.Tensor, softcap: float | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token GQA flash-decode partials over a cache shard.

    q: (b, kvh, g, hd); k/v: (b, S, kvh, hd); valid: (S,) bool.  Returns
    (m, l, acc) — (b, kvh, g), (b, kvh, g), (b, kvh, g, hd), float32 — for
    a log-sum-exp combine: masked scores are -1e30 and their ``p`` is 0,
    so a row with no valid position gives l = 0 and acc = 0."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhgd,bkhd->bhgk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = valid[None, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, -1e30))   # not -inf
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgk,bkhd->bhgd", p, v.to(torch.float32))
    return m, l, acc
