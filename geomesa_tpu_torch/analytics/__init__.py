"""Spatial functions of the port: only what point schemas' exact
predicates need so far (the exact recheck of the point-in-polygon
kernel's band rows)."""

from .st_functions import contains_points

__all__ = ["contains_points"]
