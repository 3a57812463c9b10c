"""Floating-point error-band helpers shared by the f32 device kernels.

Device kernels compute in f32 and stay exact in f64 terms by pairing a
conservative error band with a host recheck of in-band rows (the
two-tier contract of analytics/join.py and scan/gscan.py).
"""

from __future__ import annotations

import numpy as np

__all__ = ["f32_band"]


def f32_band(r: float, coord_span: float) -> tuple[float, float]:
    """Conservative f32 error band for d2 = dx^2 + dy^2 around r^2.

    Returns (r2_hi, r2_lo): pairs with f32 d2 <= r2_lo are definitely
    within r in f64 terms; pairs with f32 d2 > r2_hi are definitely
    outside; the rest need a host f64 recheck. `coord_span` bounds the
    coordinate magnitudes (360 for degrees).
    """
    r2 = r * r
    eps = float(np.finfo(np.float32).eps)
    # The band only has to be valid for pairs whose f32 d2 lands NEAR
    # r^2, and for those |dx| and |dy| are bounded by ~r, not by the
    # coordinate span. Per-coordinate f64->f32 rounding plus the f32
    # subtraction give |dx_f32 - dx| <= E with E ~ eps*span/2 (two
    # half-ulp roundings of span/2-sized values + one ulp on the
    # difference); E = eps*span leaves slack. Then
    #   |d2_f32 - d2| <= 2(|dx|+|dy|)E + 2E^2 + 4 eps B^2
    # with |dx|,|dy| <= B = sqrt(r2 + err), solved by one fixed-point
    # iteration from B = r (which handles r ~ 0, where B ~ sqrt(2)*E).
    E = eps * coord_span
    err = 4.0 * r * E + 2.0 * E * E + 4.0 * eps * r2
    B = float(np.sqrt(r2 + err))
    err = 4.0 * B * E + 2.0 * E * E + 4.0 * eps * B * B
    return r2 + err, max(r2 - err, 0.0)
