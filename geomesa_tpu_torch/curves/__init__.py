"""Space-filling curves on the host: bit normalization, z-order
interleaving, time binning, z-range decomposition, the legacy z3 curve
of index version 1 (``legacy``), and the XZ curves of extent geometries
(``xz``). The lenient encoders, the DAY/WEEK binning and the range
decomposition run in the package's native host library (``native``);
the rest is numpy. Z and XZ keys are planning artifacts; the device
scans never see them."""

from .normalize import NormalizedDimension, normalized_lat, normalized_lon, normalized_time
from .timebin import TimePeriod, bins_of_interval, max_offset, to_binned
from .zorder import Z2_BITS, Z3_BITS, z2_decode, z2_encode, z3_decode, z3_encode
from .zranges import DEFAULT_MAX_RANGES, merge_ranges, zranges
from .sfc import Z2SFC, Z3SFC, z2sfc, z3sfc
from .legacy import LegacyZ3SFC, legacy_z3sfc

__all__ = [
    "NormalizedDimension", "normalized_lat", "normalized_lon", "normalized_time",
    "TimePeriod", "bins_of_interval", "max_offset", "to_binned",
    "Z2_BITS", "Z3_BITS", "z2_decode", "z2_encode", "z3_decode", "z3_encode",
    "DEFAULT_MAX_RANGES", "merge_ranges", "zranges",
    "Z2SFC", "Z3SFC", "z2sfc", "z3sfc", "LegacyZ3SFC", "legacy_z3sfc",
]
