"""Unbiased stochastic compression operators (paper Definition 1);
counterpart of ``repro.core.compression``.

Every operator ``C`` here satisfies  C(z) = z + eps_z  with  E[eps_z] = 0 and
E[eps_z^2] <= sigma^2  per element.  Operators work on stacked node vectors
``z`` of shape ``(..., P)``: each row along the last axis is one node's
message, compressed on its own (the reference ``vmap``s over nodes).

The randomness comes from the caller: a stochastic operator takes a tensor
``u`` of uniforms in [0, 1) of shape ``uniform_shape(z.shape)``, and every
Bernoulli draw is ``u < p``, which is what the reference's
``jax.random.bernoulli(key, p)`` computes from ``jax.random.uniform(key)``.
``consensus.run`` draws ``u`` with a ``torch.Generator`` on the tensors'
device; the parity tests pass the reference's own draws.

Arithmetic follows the reference as compiled: a division by a constant is
a product with its float32 reciprocal, so the adaptive int8 scale is
``max|z| * f32(1/127)``, the scale kernel #3 computes.

``Int8BlockQuantizer`` at ``block == 512`` quantizes through
``kernels.quantize.quantize_blocks``: one launch of the hand-written kernel
over every node's blocks on a CUDA tensor, its plain version on a CPU
tensor.  Other block widths compute the same expression in PyTorch on
either device, as the reference computes plain ``jnp`` there.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import quantize as Q
from .f32 import f32, recip

__all__ = [
    "Compressor",
    "IdentityCompressor",
    "RandomizedRounding",
    "QuantizationSparsifier",
    "TernaryCompressor",
    "Int8BlockQuantizer",
    "by_name",
]


class Compressor:
    """Base interface. Subclasses are frozen dataclasses (hashable, static)."""

    #: nominal bits per element on the wire (for bytes accounting)
    wire_bits: float = 32.0

    def uniform_shape(self, shape) -> tuple[int, ...] | None:
        """Shape of the uniforms ``apply`` takes for ``z`` of ``shape``
        (None: the operator is deterministic)."""
        return tuple(shape)

    def apply(self, z: torch.Tensor, u: torch.Tensor | None) -> torch.Tensor:
        """Compress-then-decompress: returns z + eps (unbiased)."""
        raise NotImplementedError

    def sigma2(self, z=None) -> float:
        """Per-element variance bound sigma^2 (may depend on scale of z)."""
        raise NotImplementedError

    def wire_bytes(self, n_elements: int) -> float:
        return self.wire_bits * n_elements / 8.0


def _absmax(z: torch.Tensor) -> float:
    return float(z.abs().max())


@dataclasses.dataclass(frozen=True)
class IdentityCompressor(Compressor):
    wire_bits: float = 32.0

    def uniform_shape(self, shape):
        return None

    def apply(self, z, u=None):
        del u
        return z

    def sigma2(self, z=None):
        return 0.0


@dataclasses.dataclass(frozen=True)
class RandomizedRounding(Compressor):
    """Stochastic rounding to the uniform grid {i * delta}.

    [C(z)] = floor(z/d)*d + d * Bernoulli(frac(z/d));  E[C(z)] = z and
    Var <= delta^2/4 per element (worst case at frac = 1/2).
    Paper Examples 1 and 2 (Example 2 is delta = 1).  Codes travel as
    int16 (paper Section V): the grid index is clamped to +-32767 and the
    clamp fraction is reported by ``encode``.
    """

    delta: float = 1.0
    wire_bits: float = 16.0
    CODE_MAX = 32767

    def _grid_codes(self, z, u):
        s = z.to(torch.float32) * float(recip(f32(self.delta)))
        lo = torch.floor(s)
        return lo + (u < s - lo).to(torch.float32)

    def apply(self, z, u):
        q = torch.clamp(self._grid_codes(z, u), -self.CODE_MAX, self.CODE_MAX)
        return (q * float(f32(self.delta))).to(z.dtype)

    def codes(self, z, u):
        """int16 wire codes, clamped:
        ``decode(codes(z, u)) == apply(z, u)``."""
        q = self._grid_codes(z, u)
        return torch.clamp(q, -self.CODE_MAX, self.CODE_MAX).to(torch.int16)

    def encode(self, z, u):
        """(codes int16, meta) with ``meta['overflow_frac']`` the fraction
        of grid indices outside the int16 range (clamped)."""
        q = self._grid_codes(z, u)
        overflow = (q.abs() > self.CODE_MAX).to(torch.float32).mean()
        codes = torch.clamp(q, -self.CODE_MAX, self.CODE_MAX).to(torch.int16)
        return codes, {"overflow_frac": overflow}

    def decode(self, codes):
        return codes.to(torch.float32) * float(f32(self.delta))

    def sigma2(self, z=None):
        return self.delta**2 / 4.0


@dataclasses.dataclass(frozen=True)
class QuantizationSparsifier(Compressor):
    """Paper Example 3: push |z| up to the next level w.p. z/level, else 0.

    Uniform m-level partition of the ball B(0, M): a_i = i*M/m. For
    a_i <= |z| < a_{i+1}:  C(z) = sign(z)*a_{i+1} w.p. |z|/a_{i+1}, else 0.
    Unbiased; produces many exact zeros => sparse wire encoding.
    """

    m_levels: int = 16
    big_m: float = 1.0
    wire_bits: float = 8.0

    def _spacing(self) -> np.float32:
        return f32(self.big_m / self.m_levels)

    def _signed_levels(self, z, u):
        """Signed level index in [-m, m] (0 = dropped): the wire alphabet."""
        a = self._spacing()
        mag = z.to(torch.float32).abs()
        level = torch.clamp(torch.ceil(mag * float(recip(a))),
                            max=float(self.m_levels)).clamp(min=1.0)
        upper = level * float(a)
        p_keep = torch.where(upper > 0, mag / upper, 0.0)
        return torch.sign(z) * level * (u < p_keep).to(torch.float32)

    def apply(self, z, u):
        return (self._signed_levels(z, u) * float(self._spacing())).to(
            z.dtype)

    def encode(self, z, u):
        """(codes, meta): signed level indices [-m, m], int8 when m fits,
        else int16; ``decode(encode(z, u)) == apply(z, u)``."""
        dtype = torch.int8 if self.m_levels <= 127 else torch.int16
        codes = self._signed_levels(z, u).to(dtype)
        sparsity = (codes == 0).to(torch.float32).mean()
        return codes, {"overflow_frac": torch.zeros((), device=z.device),
                       "sparsity": sparsity}

    def decode(self, codes):
        return codes.to(torch.float32) * float(self._spacing())

    def sigma2(self, z=None):
        return self.big_m**2 / 4.0


@dataclasses.dataclass(frozen=True)
class TernaryCompressor(Compressor):
    """TernGrad (paper ref [26]): C(z) = s * sign(z) * Bernoulli(|z|/s).

    s = max|z| of each node's vector is transmitted once; codes are 2-bit
    ternary.
    """

    wire_bits: float = 2.0

    def _ternary(self, z, u):
        """(codes in {-1, 0, +1} f32, per-node scale s = max|z|)."""
        z = z.to(torch.float32)
        s = torch.clamp_min(z.abs().amax(dim=-1, keepdim=True),
                            float(f32(1e-30)))
        keep = u < z.abs() / s
        return torch.sign(z) * keep.to(torch.float32), s

    def apply(self, z, u):
        codes, s = self._ternary(z, u)
        return (s * codes).to(z.dtype)

    def encode(self, z, u):
        """(codes int8 in {-1, 0, +1}, scale f32 (..., 1), meta);
        ``decode(encode(z, u)) == apply(z, u)``."""
        codes, s = self._ternary(z, u)
        sparsity = (codes == 0).to(torch.float32).mean()
        return codes.to(torch.int8), s, {
            "overflow_frac": torch.zeros((), device=z.device),
            "sparsity": sparsity}

    def decode(self, codes, scale):
        return scale * codes.to(torch.float32)

    def sigma2(self, z=None):
        if z is None:
            return float("inf")  # scale-dependent
        return _absmax(torch.as_tensor(z))**2 / 4.0


@dataclasses.dataclass(frozen=True)
class Int8BlockQuantizer(Compressor):
    """Production wire format: stochastic int8 codes + per-block fp32 scale.

    mode='adaptive': scale_b = max|z_b| * f32(1/127) per block b (never
        overflows; noise is *relative*).
    mode='fixed':    scale = ``step`` (grid is constant; amplification by
        k^gamma genuinely divides the effective noise — paper-faithful).
        Codes are clamped to [-127, 127]; ``encode`` reports the fraction
        clamped.

    Each node's vector is zero padded to whole blocks.  Wire cost: 8
    bits/element + 32 bits/block.
    """

    block: int = 512
    mode: str = "adaptive"  # 'adaptive' | 'fixed'
    step: float = 1e-3      # grid step for mode='fixed'

    def __post_init__(self):
        if self.mode not in ("adaptive", "fixed"):
            raise ValueError(f"mode must be 'adaptive' or 'fixed', got "
                             f"{self.mode!r}")

    @property
    def wire_bits(self) -> float:  # type: ignore[override]
        return 8.0 + 32.0 / self.block

    def n_blocks(self, n: int) -> int:
        return math.ceil(n / self.block)

    def uniform_shape(self, shape):
        *lead, n = shape
        return (*lead, self.n_blocks(n), self.block)

    def _blocks(self, z: torch.Tensor) -> torch.Tensor:
        """(..., P) -> (..., n_blocks, block) float32, zero padded."""
        n = z.shape[-1]
        pad = self.n_blocks(n) * self.block - n
        flat = z.to(torch.float32)
        if pad:
            flat = F.pad(flat, (0, pad))
        return flat.reshape(*z.shape[:-1], self.n_blocks(n), self.block)

    def _quantize(self, blocks: torch.Tensor, u: torch.Tensor):
        """Codes and scales of every node's blocks in one call: kernel #3
        at the kernel's block width, the same expression elsewhere."""
        rows = blocks.reshape(-1, self.block)
        noise = u.reshape(-1, self.block)
        step = self.step if self.mode == "fixed" else None
        if self.block == Q.BLOCK:
            codes, scales = Q.quantize_blocks(rows.contiguous(),
                                              noise.contiguous(), step)
        else:
            codes, scales = Q.quantize_blocks_plain(rows, noise, step)
        return (codes.reshape(blocks.shape),
                scales.reshape(*blocks.shape[:-1], 1))

    def encode(self, z, u):
        """Returns (codes int8 (..., n_blocks, block), scales f32
        (..., n_blocks, 1), meta)."""
        blocks = self._blocks(z)
        codes, scales = self._quantize(blocks, u)
        s = blocks / scales
        lo = torch.floor(s)
        q = lo + (u.reshape(blocks.shape) < s - lo).to(torch.float32)
        overflow = (q.abs() > 127.0).to(torch.float32).mean()
        return codes, scales, {"orig_shape": tuple(z.shape),
                               "n": z.shape[-1], "overflow_frac": overflow}

    def decode(self, codes, scales, meta):
        flat = (codes.to(torch.float32) * scales).reshape(
            *codes.shape[:-2], -1)
        return flat[..., :meta["n"]].reshape(meta["orig_shape"])

    def apply(self, z, u):
        codes, scales = self._quantize(self._blocks(z), u)
        meta = {"orig_shape": tuple(z.shape), "n": z.shape[-1]}
        return self.decode(codes, scales, meta).to(z.dtype)

    def sigma2(self, z=None):
        if self.mode == "fixed":
            return self.step**2 / 4.0
        if z is None:
            return float("inf")  # relative; bounded by (max|z|/127)^2/4
        s = _absmax(torch.as_tensor(z)) / 127.0
        return s**2 / 4.0


def by_name(name: str, **kw) -> Compressor:
    reg = {
        "identity": IdentityCompressor,
        "randomized_rounding": RandomizedRounding,
        "sparsifier": QuantizationSparsifier,
        "ternary": TernaryCompressor,
        "int8": Int8BlockQuantizer,
    }
    if name not in reg:
        raise KeyError(f"unknown compressor {name!r}; have {sorted(reg)}")
    return reg[name](**kw)
