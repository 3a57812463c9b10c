"""Space-filling curves on the host (numpy): bit normalization, z-order
interleaving, time binning, z-range decomposition, and the XZ curves of
extent geometries (``xz``). Z and XZ keys are planning artifacts; the
device scans never see them."""

from .normalize import NormalizedDimension, normalized_lat, normalized_lon, normalized_time
from .timebin import TimePeriod, bins_of_interval, max_offset, to_binned
from .zorder import Z2_BITS, Z3_BITS, z2_encode, z3_decode, z3_encode
from .zranges import DEFAULT_MAX_RANGES, merge_ranges, zranges
from .sfc import Z2SFC, Z3SFC, z2sfc, z3sfc

__all__ = [
    "NormalizedDimension", "normalized_lat", "normalized_lon", "normalized_time",
    "TimePeriod", "bins_of_interval", "max_offset", "to_binned",
    "Z2_BITS", "Z3_BITS", "z2_encode", "z3_decode", "z3_encode",
    "DEFAULT_MAX_RANGES", "merge_ranges", "zranges",
    "Z2SFC", "Z3SFC", "z2sfc", "z3sfc",
]
