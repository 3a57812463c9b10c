"""SQL surface: SELECT with ST_* predicates over datastores.

The geomesa-spark-sql analog (see parser.py / engine.py for the
STContainsRule / SpatialJoinStrategy mapping). WHERE pushes down into
the store's planner and scan kernels; joins run on the store's device
through the join kernels of analytics/join.py; grouping and the
aggregates reduce on the host."""

from .engine import SqlEngine, SqlResult
from .parser import SqlError, parse_sql

__all__ = ["SqlEngine", "SqlResult", "parse_sql", "SqlError"]
