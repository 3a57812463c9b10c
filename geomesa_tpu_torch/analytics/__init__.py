"""Analytics of the port: the ST_* library over the geometry model
(``st_functions``), the spatial joins and KNN on the device (``join``),
spatial partitioning (``partitioning``), the tube builder (``tube``) and
the WPS-style processes (``processes``)."""

from . import st_functions
from .join import contains_join, dwithin_join, knn
from .processes import (exterior_ring_process, idl_safe_geom_process,
                        knn_process, length_spheroid_process,
                        minmax_process, num_points_process,
                        point_n_process, proximity_process,
                        translate_process, tube_select_process,
                        unique_process)
from .st_functions import (contains_points, distance_points,
                           st_antimeridian_safe_geom, st_idl_safe_geom,
                           st_length_spheroid)
from .tube import TubeBuilder, tube_select_mask

__all__ = ["st_functions", "contains_join", "dwithin_join", "knn",
           "exterior_ring_process", "idl_safe_geom_process",
           "knn_process", "length_spheroid_process", "minmax_process",
           "num_points_process", "point_n_process",
           "proximity_process", "translate_process",
           "tube_select_process", "unique_process",
           "st_antimeridian_safe_geom", "st_idl_safe_geom",
           "st_length_spheroid", "TubeBuilder", "tube_select_mask",
           "contains_points", "distance_points"]
