"""Float32 scalar arithmetic as the reference's compiled programs do it.

The reference evaluates its step sizes, grid steps and schedules under
``jit``, and XLA rewrites some of that arithmetic before it runs:

* ``x ** g`` with a Python exponent ``g`` that is a whole number is
  ``lax.integer_pow``: products by binary exponentiation, no ``pow``;
* ``c / x ** g`` with a constant ``c`` becomes ``c * pow(x, -g)`` (XLA's
  algebraic simplifier), and ``pow(x, -0.5)`` becomes ``rsqrt(x)``;
* a division by a constant becomes a product with its float32
  reciprocal;
* ``pow`` and ``cos`` are the C library's ``powf`` and ``cosf``;
* in a fused loop, ``a * b + c`` is contracted to one fused multiply-add.

The functions here give the same float32 values on the host, so the port's
scalars (and so its wire bytes, whose fixed-mode scale is such a scalar)
equal the reference's.  One rewrite cannot be followed: XLA's CPU
``rsqrt`` is an approximation that differs from the correctly rounded
reciprocal square root by one ulp for about 13% of arguments; the port
takes the correctly rounded value, and the parity tests predict the steps
where the two differ.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from fractions import Fraction

import numpy as np

__all__ = ["f32", "recip", "power", "over_power", "powf", "cosf", "fma"]

f32 = np.float32


@functools.lru_cache(maxsize=None)
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for name, n_args in (("powf", 2), ("cosf", 1)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_float] * n_args
        fn.restype = ctypes.c_float
    return lib


def powf(x, y) -> np.float32:
    """The C library's float32 ``pow``, XLA's CPU ``power``."""
    return f32(_libm().powf(float(f32(x)), float(f32(y))))


def cosf(x) -> np.float32:
    """The C library's float32 ``cos``, XLA's CPU ``cosine``."""
    return f32(_libm().cosf(float(f32(x))))


def fma(a, b, c) -> np.float32:
    """float32 ``a * b + c`` rounded once (a fused multiply-add)."""
    exact = Fraction(float(f32(a))) * Fraction(float(f32(b))) \
        + Fraction(float(f32(c)))
    near = f32(float(exact))        # within one float32 ulp of ``exact``
    best = near
    for cand in (np.nextafter(near, f32(-np.inf)),
                 np.nextafter(near, f32(np.inf))):
        d_c, d_b = abs(Fraction(float(cand)) - exact), \
            abs(Fraction(float(best)) - exact)
        if d_c < d_b or (d_c == d_b and int(cand.view(np.int32)) % 2 == 0):
            best = cand
    return f32(best)


def recip(n) -> np.float32:
    """float32(1 / n): what ``x / n`` multiplies by once compiled."""
    return f32(1.0 / float(n))


def _integer_pow(x: np.float32, n: int) -> np.float32:
    """``lax.integer_pow``: square-and-multiply, one float32 product each."""
    if n == 0:
        return f32(1.0)
    acc, y = None, abs(n)
    while y > 0:
        if y & 1:
            acc = x if acc is None else f32(acc * x)
        y >>= 1
        if y > 0:
            x = f32(x * x)
    return f32(f32(1.0) / acc) if n < 0 else acc


def _whole(g: float) -> bool:
    return float(g).is_integer()


def power(x, g: float) -> np.float32:
    """The compiled ``x ** g`` for a float32 ``x`` only known at run time
    (a traced value) and a Python exponent ``g``."""
    x = f32(x)
    if _whole(g):
        return _integer_pow(x, int(g))
    return powf(x, g)


def over_power(c: float, x, g: float) -> np.float32:
    """The compiled ``c / x ** g`` for a constant ``c`` and a float32 ``x``
    only known at run time: a true division by the product for a whole
    ``g``, else ``c * rsqrt(x)`` (g = 0.5) or ``c * pow(x, -g)``."""
    x = f32(x)
    if _whole(g):
        return f32(f32(c) / _integer_pow(x, int(g)))
    if f32(g) == f32(0.5):
        return f32(f32(c) * f32(1.0 / math.sqrt(float(x))))
    return f32(f32(c) * powf(x, -f32(g)))
