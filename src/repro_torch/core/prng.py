"""The reference's counter-based PRNG on the host: Threefry-2x32.

The fault models draw every drop, deadline, resync and failure decision
from ``PRNGKey(seed)`` folded with integers, then one ``uniform`` draw
(``core.faults``).  The masks must be the reference's bit for bit, so this
module computes the same function with numpy ``uint32`` arithmetic:

* ``threefry2x32(key, (x0, x1))`` — 20 rounds, rotations (13, 15, 26, 6)
  and (17, 29, 16, 24), key parity ``0x1BD11BDA``, a key injection every
  4 rounds;
* ``prng_key(seed)`` — ``(0, seed mod 2**32)``: the reference runs with
  64-bit types off, so a seed is taken as a 32-bit integer and its high
  word is 0;
* ``fold_in(key, d)`` — ``threefry2x32(key, (0, d mod 2**32))``;
* ``random_bits(key, shape)`` — per element of flat index ``i``,
  ``x0 ^ x1`` of ``threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))`` (the
  partitionable layout of the reference's version);
* ``uniform(key, shape)`` — float32 ``bitcast((bits >> 9) | 0x3F800000)
  - 1`` in [0, 1).

A key is a pair of words: Python ints, or ``uint32`` arrays for a batch
of keys (``fold_in`` with an array of data gives one, and ``uniform`` of
such a batch at ``shape=()`` draws one value per key).  Draws are numpy
arrays (a 0-dim float32 array for one key at ``shape=()``).
"""
from __future__ import annotations

import numpy as np

__all__ = ["threefry2x32", "prng_key", "fold_in", "random_bits", "uniform",
           "fold_chain"]

_MASK = 0xFFFFFFFF
_PARITY = np.uint32(0x1BD11BDA)
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _words(v) -> np.ndarray:
    """An int or an integer array as ``uint32`` words (mod 2**32)."""
    return (np.asarray(v, dtype=np.int64) & _MASK).astype(np.uint32)


def threefry2x32(key, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of the counter words ``(x0, x1)`` under ``key``, all
    broadcast together: the two ``uint32`` output words."""
    k0, k1 = _words(key[0]), _words(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = _words(x0), _words(x1)
    with np.errstate(over="ignore"):
        x0, x1 = np.broadcast_arrays(x0 + ks[0], x1 + ks[1])
        x0, x1 = x0.copy(), x1.copy()
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 += x1
                x1 = _rotl(x1, r)
                x1 ^= x0
            x0 += ks[(i + 1) % 3]
            x1 += ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """The key of ``seed``: ``(0, seed mod 2**32)``."""
    return (0, int(seed) & _MASK)


def fold_in(key, data):
    """A new key from ``key`` and the integer ``data`` (taken mod 2**32,
    as a 32-bit integer is); with array words or data, a batch of keys."""
    y0, y1 = threefry2x32(key, 0, data)
    if y0.ndim == 0:
        return (int(y0), int(y1))
    return (y0, y1)


def fold_chain(seed: int, *data: int) -> tuple[int, int]:
    """``fold_in(... fold_in(prng_key(seed), data[0]) ..., data[-1])``."""
    key = prng_key(seed)
    for d in data:
        key = fold_in(key, d)
    return key


def random_bits(key, shape=()) -> np.ndarray:
    """32 random bits per element of ``shape`` (``uint32``); a batch of
    keys at ``shape=()`` gives one word per key."""
    if shape == ():
        y0, y1 = threefry2x32(key, 0, 0)
        return y0 ^ y1
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(_MASK)).astype(np.uint32)
    y0, y1 = threefry2x32(key, hi, lo)
    return (y0 ^ y1).reshape(shape)


def uniform(key, shape=()) -> np.ndarray:
    """float32 uniforms in [0, 1) of ``shape`` (one per key of a batch at
    ``shape=()``)."""
    bits = random_bits(key, shape)
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | one).view(np.float32)
    return floats - np.float32(1.0)
