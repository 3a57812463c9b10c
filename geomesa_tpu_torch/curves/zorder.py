"""Z-order (Morton) bit interleaving, vectorized over numpy uint64.

The reference delegates interleaving to the external ``sfcurve`` library
(Z3SFC.scala:22 imports ``org.locationtech.sfcurve.zorder.{Z3, ZRange}``);
this is a from-scratch magic-number implementation of the same math:

- Z2: 2 dims x 31 bits -> 62-bit key (Z2SFC.scala:15 uses precision 31)
- Z3: 3 dims x 21 bits -> 63-bit key (Z3SFC.scala:22 uses precision 21)

Host-side only: z keys are *build and plan time* artifacts (sorting, range
decomposition).  The device scan compares two-float coordinates and
(day, ms) times directly, so 64-bit keys never reach the device.
"""

from __future__ import annotations

import numpy as np

__all__ = ["z2_split", "z2_combine", "z2_encode", "z2_decode", "z3_split", "z3_combine", "z3_encode",
           "z3_decode", "Z2_BITS", "Z3_BITS", "Z2_MAX", "Z3_MAX"]

Z2_BITS = 31   # bits per dimension
Z3_BITS = 21
Z2_MAX = (1 << (2 * Z2_BITS)) - 1  # max z2 key value
Z3_MAX = (1 << (3 * Z3_BITS)) - 1


def _u64(x) -> np.ndarray:
    return np.asarray(x).astype(np.uint64)


def z2_split(x) -> np.ndarray:
    """Spread the low 31 bits of each value to even bit positions."""
    x = _u64(x) & np.uint64(0x7FFFFFFF)
    x = (x ^ (x << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    x = (x ^ (x << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    x = (x ^ (x << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    x = (x ^ (x << np.uint64(2))) & np.uint64(0x3333333333333333)
    x = (x ^ (x << np.uint64(1))) & np.uint64(0x5555555555555555)
    return x


def z2_combine(z) -> np.ndarray:
    """Inverse of z2_split: gather the even bits into the low 31."""
    x = _u64(z) & np.uint64(0x5555555555555555)
    x = (x ^ (x >> np.uint64(1))) & np.uint64(0x3333333333333333)
    x = (x ^ (x >> np.uint64(2))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    x = (x ^ (x >> np.uint64(4))) & np.uint64(0x00FF00FF00FF00FF)
    x = (x ^ (x >> np.uint64(8))) & np.uint64(0x0000FFFF0000FFFF)
    x = (x ^ (x >> np.uint64(16))) & np.uint64(0x00000000FFFFFFFF)
    return x.astype(np.int64)


def z2_encode(x, y) -> np.ndarray:
    """Interleave two 31-bit ints into a 62-bit z2 key (x gets bit 0)."""
    return z2_split(x) | (z2_split(y) << np.uint64(1))


def z2_decode(z):
    """z2 key(s) -> the (x, y) normalized ints (int64)."""
    z = _u64(z)
    return z2_combine(z), z2_combine(z >> np.uint64(1))


def z3_split(x) -> np.ndarray:
    """Spread the low 21 bits of each value to every 3rd bit position."""
    x = _u64(x) & np.uint64(0x1FFFFF)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def z3_combine(z) -> np.ndarray:
    """Inverse of z3_split: gather every 3rd bit into the low 21."""
    x = _u64(z) & np.uint64(0x1249249249249249)
    x = (x ^ (x >> np.uint64(2))) & np.uint64(0x10C30C30C30C30C3)
    x = (x ^ (x >> np.uint64(4))) & np.uint64(0x100F00F00F00F00F)
    x = (x ^ (x >> np.uint64(8))) & np.uint64(0x1F0000FF0000FF)
    x = (x ^ (x >> np.uint64(16))) & np.uint64(0x1F00000000FFFF)
    x = (x ^ (x >> np.uint64(32))) & np.uint64(0x1FFFFF)
    return x.astype(np.int64)


def z3_encode(x, y, t) -> np.ndarray:
    """Interleave three 21-bit ints into a 63-bit z3 key (x gets bit 0)."""
    return (z3_split(x) | (z3_split(y) << np.uint64(1))
            | (z3_split(t) << np.uint64(2)))


def z3_decode(z):
    """z3 key(s) -> the (x, y, t) normalized ints (int64)."""
    z = _u64(z)
    return (z3_combine(z), z3_combine(z >> np.uint64(1)),
            z3_combine(z >> np.uint64(2)))
