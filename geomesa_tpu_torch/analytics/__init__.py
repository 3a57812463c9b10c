"""Spatial functions of the port: the ST_* library over the geometry
model (``st_functions``), with the vectorized point-column forms."""

from .st_functions import contains_points, distance_points

__all__ = ["contains_points", "distance_points"]
