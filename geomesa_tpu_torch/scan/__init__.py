"""Device scans: the two-float column layout of point schemas
(zscan.py), the extent tristate and point-in-polygon (gscan.py), the
attribute residual (residual.py), the aggregations (aggregations.py),
the hand-written kernels behind them (kernels.py, csrc/*.cu) and the
micro-batching admission queue in front of the store (batcher.py)."""

from .kernels import launches, reset_launches
from .zscan import (BatchedScanQuery, ScanData, ScanQuery, batch_hit_rows,
                    boundary_candidates, build_scan_data, exact_patch,
                    extend_scan_data, make_query, patch_hit_rows, scan_count,
                    scan_data_from_numpy, scan_mask, scan_mask_at,
                    scan_mask_batch, split_two_float, stack_queries)

__all__ = ["BatchedScanQuery", "ScanData", "ScanQuery", "batch_hit_rows",
           "boundary_candidates", "build_scan_data", "exact_patch",
           "extend_scan_data", "launches", "make_query", "patch_hit_rows",
           "reset_launches", "scan_count", "scan_data_from_numpy",
           "scan_mask", "scan_mask_at", "scan_mask_batch", "split_two_float",
           "stack_queries"]
