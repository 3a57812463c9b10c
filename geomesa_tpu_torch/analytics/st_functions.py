"""Vectorized spatial functions over point columns (the JAX package's
analytics/st_functions.py, the part that point schemas use)."""

from __future__ import annotations

import numpy as np

from ..geometry import Geometry

__all__ = ["contains_points"]


def contains_points(g: Geometry, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Vectorized geometry-contains-points, boundary-inclusive, in exact
    float64 (the ST_Contains hot form) for a Polygon or MultiPolygon."""
    if not hasattr(g, "contains_points"):
        raise TypeError(f"contains_points of a {g.geom_type} belongs to the "
                        f"extent-geometry slice of the PyTorch port")
    return g.contains_points(x, y)
