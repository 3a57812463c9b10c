"""Bit-normalization of doubles onto integer grids.

Mirrors the semantics of the reference's ``NormalizedDimension``
(geomesa-z3/.../curve/NormalizedDimension.scala:14,74): a value in
``[min, max]`` maps to an int in ``[0, 2^precision - 1]`` via
``floor((x - min) * bins / (max - min))`` with the upper bound clamped to
``maxIndex``; denormalization returns the *center* of the bin.

Host side uses float64 numpy (normalization is ingest/plan-time work);
the z keys it feeds are planning artifacts that never reach the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "NormalizedDimension",
    "normalized_lon",
    "normalized_lat",
    "normalized_time",
]


@dataclasses.dataclass(frozen=True)
class NormalizedDimension:
    """Maps doubles in [min, max] to ints in [0, 2**precision - 1]."""

    min: float
    max: float
    precision: int

    def __post_init__(self) -> None:
        if not (0 < self.precision < 32):
            raise ValueError("precision (bits) must be in [1, 31]")

    @property
    def bins(self) -> int:
        return 1 << self.precision

    @property
    def max_index(self) -> int:
        return self.bins - 1

    def normalize(self, x):
        """Vectorized normalize; accepts scalars or numpy arrays.

        Values ``>= max`` clamp to ``max_index`` (the reference does the
        same; out-of-range low values are the caller's responsibility —
        see ``lenient`` handling in the SFC classes).
        """
        x = np.asarray(x, dtype=np.float64)
        normalizer = self.bins / (self.max - self.min)
        prod = np.floor((x - self.min) * normalizer)
        # NaN (null coordinates) maps to bin 0 explicitly — the old
        # NaN->int cast produced the same value via truncation but with
        # a RuntimeWarning and int-cast UB semantics
        out = np.where(np.isnan(prod), 0.0, prod).astype(np.int64)
        # float rounding can push in-bounds values just below max up to
        # `bins`; clamp rather than wrap (int32 overflow would silently
        # produce a wrong z key for points at the domain edge)
        out = np.minimum(out, self.max_index)
        return out.astype(np.int32)

    def denormalize(self, i):
        """Vectorized bin-center denormalization."""
        i = np.asarray(i, dtype=np.int64)
        denorm = (self.max - self.min) / self.bins
        i = np.minimum(i, self.max_index)
        return self.min + (i.astype(np.float64) + 0.5) * denorm

    def in_bounds(self, x) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        return (x >= self.min) & (x <= self.max)

    def clamp(self, x):
        return np.clip(np.asarray(x, dtype=np.float64), self.min, self.max)


def normalized_lon(precision: int) -> NormalizedDimension:
    return NormalizedDimension(-180.0, 180.0, precision)


def normalized_lat(precision: int) -> NormalizedDimension:
    return NormalizedDimension(-90.0, 90.0, precision)


def normalized_time(precision: int, max_offset: float) -> NormalizedDimension:
    return NormalizedDimension(0.0, max_offset, precision)
