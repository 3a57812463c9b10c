"""Canonical plan keys for the materialized pushdown cache.

The cache's identity contract is ``(type_name, plan key, version)``: two
requests share an entry iff their canonical keys match. The key comes
from the re-parseable ECQL stringification of ``filters/ast.py`` (every
node's ``__str__`` re-parses to an equal tree, so whitespace, case and
numeric-literal variants of one filter collapse to one string) plus the
pushdown kind and its parameters.

Each ``*_key`` helper returns ``(filter_ast, key)``: the caller passes
the normalized AST down to the compute, so the cached compute and a later
recompute evaluate the identical plan.
"""

from __future__ import annotations

from ..filters import ast
from ..filters.ecql import parse_ecql

__all__ = ["canonical_filter", "density_key", "stats_key", "bin_key",
           "arrow_key"]


def canonical_filter(ecql) -> tuple[ast.Filter, str]:
    """Normalize an ECQL filter (string, AST, or None) to
    ``(AST, canonical string)``. ``None`` means match-all (the stats and
    BIN surfaces' convention) and canonicalizes to INCLUDE."""
    if ecql is None:
        flt = parse_ecql("INCLUDE")
    elif isinstance(ecql, ast.Filter):
        flt = ecql
    else:
        flt = parse_ecql(str(ecql))
    return flt, str(flt)


def density_key(ecql, bbox, width: int, height: int,
                weight_attr: str | None = None) -> tuple[ast.Filter, str]:
    """Density-surface plan key: filter + bbox + grid shape + weight."""
    flt, fstr = canonical_filter(ecql)
    bb = ",".join(repr(float(v)) for v in bbox)
    return flt, (f"density|{int(width)}x{int(height)}|{bb}"
                 f"|w={weight_attr}|{fstr}")


def stats_key(ecql, stat_spec: str) -> tuple[ast.Filter, str]:
    """Stat-sketch plan key: filter + the stat spec string."""
    flt, fstr = canonical_filter(ecql)
    return flt, f"stats|{str(stat_spec).strip()}|{fstr}"


def bin_key(ecql, track: str | None = None, label: str | None = None,
            sort: bool = False) -> tuple[ast.Filter, str]:
    """BIN-record plan key: filter + track/label columns + sort flag."""
    flt, fstr = canonical_filter(ecql)
    return flt, f"bin|t={track}|l={label}|s={bool(sort)}|{fstr}"


def arrow_key(ecql, sort_by: str | None = None) -> tuple[ast.Filter, str]:
    """Arrow-IPC plan key: filter + sort column."""
    flt, fstr = canonical_filter(ecql)
    return flt, f"arrow|sort={sort_by}|{fstr}"
