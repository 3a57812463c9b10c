"""Standing-filter compiler: ECQL AST -> device-loadable bound summary.

The continuous-query matcher (scan/standing.py) evaluates the WHOLE
registered filter population against every ingest batch in one fused
``rows x filters`` kernel. That kernel only speaks rectangles: bbox
envelopes over the default point geometry, one inclusive epoch-millis
interval over the default date attribute, and one numeric interval per
tracked attribute. This module walks a parsed filter once at
registration time and projects it onto that vocabulary, mirroring the
conservative-mask + exact-patch split proven in scan/zscan.py:

- the compiled bounds are a SOUND over-approximation — every row the
  filter truly matches falls inside them (extraction helpers treat
  unsupported nodes, ``Not``, and OR'd structure as unconstrained, and
  unions/intersections only widen), so the device mask never drops a
  true match;
- ``residual`` marks filters whose semantics the summary does NOT
  capture exactly (LIKE, string equality, OR trees, polygon predicates,
  IS NULL, fid filters, ...). Their device survivors are re-checked
  with the full ``filters.evaluate`` oracle; non-residual filters need
  only the cheap vectorized f64 recheck in ``exact_match`` (which also
  absorbs the kernel's widened-f32 bound slack);
- ``never`` marks provably-empty filters (EXCLUDE, disjoint ANDed
  boxes/intervals) — matched against nothing, no residual work.

Exactness contract: for any filter and batch,
``hits = candidates[exact_match(...)]`` (non-residual) or
``candidates[evaluate(...)]`` (residual) equals
``np.flatnonzero(evaluate(filter, batch))`` whenever ``candidates`` is
a superset of the true match rows. tests/test_geofence.py enforces it
differentially against random filter populations; the port's
tests/test_torch_geofence.py holds this module's fields equal to the
JAX package's on the same filters.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import ast
from .evaluate import evaluate
from .helper import (extract_attribute_bounds, extract_geometries,
                     extract_intervals, to_millis)

__all__ = ["AttrBound", "CompiledFilter", "compile_filter", "numeric_attrs",
           "exact_match", "exact_hits", "NUMERIC_TYPES"]

# attribute types the fused kernel tracks as one f64 interval each
NUMERIC_TYPES = ("Integer", "Long", "Double", "Float")


def numeric_attrs(sft) -> list[str]:
    """Schema attributes the standing kernel carries as device columns,
    in schema order (the kernel's attribute axis layout)."""
    return [a.name for a in sft.attributes if a.type.name in NUMERIC_TYPES]


@dataclasses.dataclass(frozen=True)
class AttrBound:
    """One numeric attribute's interval; None = unbounded side. The
    inclusivity flags matter only on the exact host recheck — the
    device compare is inclusive over widened bounds either way."""
    lo: float | None
    lo_inc: bool
    hi: float | None
    hi_inc: bool


@dataclasses.dataclass(frozen=True)
class CompiledFilter:
    """Device-compilable projection of one standing filter."""
    geom_attr: str | None        # point geometry the boxes apply to
    dtg_attr: str | None         # date attribute the interval applies to
    boxes: tuple                 # ((xmin, ymin, xmax, ymax) f64, ...)
    spatial_any: bool            # no spatial constraint: pass all rows
    interval: tuple | None       # (lo_ms|None, hi_ms|None) inclusive
    attr_bounds: dict            # {attr name: AttrBound}
    residual: bool               # summary is conservative, not exact
    never: bool                  # provably empty: matches nothing

    @property
    def n_boxes(self) -> int:
        return len(self.boxes)


def _is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _bbox_in_world(f: ast.BBox) -> bool:
    """True when extraction is the identity (no IDL split, no world
    clip) so the envelope test equals the evaluator's raw compares."""
    return (-180.0 <= f.xmin <= f.xmax <= 180.0
            and -90.0 <= f.ymin <= f.ymax <= 90.0)


def _expressible(f: ast.Filter, geom_attr, dtg_attr, nums) -> bool:
    """True when the compiled summary reproduces the filter EXACTLY: a
    conjunction of in-world bboxes on the point geometry, temporal
    predicates on the default date, and single-interval numeric bounds.
    Anything else (OR/NOT trees, strings, polygons, ...) is residual."""
    if isinstance(f, ast.Include):
        return True
    if isinstance(f, ast.And):
        return all(_expressible(c, geom_attr, dtg_attr, nums)
                   for c in f.children)
    if isinstance(f, ast.BBox):
        return f.prop == geom_attr and _bbox_in_world(f)
    if isinstance(f, (ast.During, ast.Before, ast.After, ast.TEquals)):
        return f.prop == dtg_attr
    if isinstance(f, ast.Compare):
        return (f.prop in nums and f.op != ast.CompareOp.NE
                and _is_number(f.value))
    if isinstance(f, ast.Between):
        return (f.prop in nums and _is_number(f.lo) and _is_number(f.hi))
    if isinstance(f, ast.InList):
        return (f.prop in nums and len(f.values) == 1
                and _is_number(f.values[0]))
    return False


def _interval_envelope(fv) -> tuple | None:
    """OR'd date Bounds -> one inclusive (lo_ms, hi_ms) envelope (a
    superset — exact only when the extraction was a single interval).
    Exclusive bounds shift by 1 ms, which is exact at millisecond
    resolution."""
    lo_env: int | None = None
    hi_env: int | None = None
    lo_open = hi_open = False
    for b in fv.values:
        if not b.lower.is_bounded:
            lo_open = True
        else:
            lo = to_millis(b.lower.value) + (0 if b.lower.inclusive else 1)
            lo_env = lo if lo_env is None else min(lo_env, lo)
        if not b.upper.is_bounded:
            hi_open = True
        else:
            hi = to_millis(b.upper.value) - (0 if b.upper.inclusive else 1)
            hi_env = hi if hi_env is None else max(hi_env, hi)
    return (None if lo_open else lo_env, None if hi_open else hi_env)


def _attr_envelope(fv) -> AttrBound:
    """OR'd numeric Bounds -> one envelope AttrBound. With multiple
    bounds the inclusivity loosens to True (widening is sound; the
    caller marks the filter residual in that case)."""
    single = len(fv.values) == 1
    lo_env: float | None = None
    hi_env: float | None = None
    lo_inc = hi_inc = True
    lo_open = hi_open = False
    for b in fv.values:
        if not b.lower.is_bounded:
            lo_open = True
        else:
            v = float(b.lower.value)
            if lo_env is None or v < lo_env:
                lo_env = v
                lo_inc = b.lower.inclusive if single else True
        if not b.upper.is_bounded:
            hi_open = True
        else:
            v = float(b.upper.value)
            if hi_env is None or v > hi_env:
                hi_env = v
                hi_inc = b.upper.inclusive if single else True
    return AttrBound(None if lo_open else lo_env, lo_inc,
                     None if hi_open else hi_env, hi_inc)


def compile_filter(f: ast.Filter, sft) -> CompiledFilter:
    """Project one parsed filter onto the standing-kernel vocabulary."""
    geom_attr = sft.geom_field if sft.is_points else None
    dtg_attr = sft.dtg_field
    nums = set(numeric_attrs(sft))
    never = isinstance(f, ast.Exclude)
    exact = never or _expressible(f, geom_attr, dtg_attr, nums)

    # spatial: envelopes of the extracted (OR'd) geometries
    boxes: tuple = ()
    spatial_any = True
    if geom_attr is not None and not never:
        fv = extract_geometries(f, geom_attr)
        if fv.disjoint:
            never = True
        elif fv.values:
            spatial_any = False
            out = []
            for g in fv.values:
                e = g.envelope
                out.append((float(e.xmin), float(e.ymin),
                            float(e.xmax), float(e.ymax)))
            boxes = tuple(out)

    # temporal: one inclusive millis envelope over the dtg attribute
    interval = None
    if dtg_attr is not None and not never:
        fv = extract_intervals(f, dtg_attr)
        if fv.disjoint:
            never = True
        elif fv.values:
            interval = _interval_envelope(fv)
            if len(fv.values) > 1:
                exact = False
            if interval == (None, None):
                interval = None

    # numeric attributes: one envelope interval each
    attr_bounds: dict = {}
    if not never:
        for name in sorted(nums):
            fv = extract_attribute_bounds(f, name)
            if fv.disjoint:
                never = True
                break
            if not fv.values:
                continue
            if any(not (_is_number(b.lower.value) or not b.lower.is_bounded)
                   or not (_is_number(b.upper.value) or not b.upper.is_bounded)
                   for b in fv.values):
                # non-numeric literal leaked into a numeric attribute's
                # bounds: skip the constraint (sound) and force residual
                exact = False
                continue
            ab = _attr_envelope(fv)
            if len(fv.values) > 1:
                exact = False
            if ab.lo is not None or ab.hi is not None:
                attr_bounds[name] = ab

    if never:
        return CompiledFilter(geom_attr, dtg_attr, (), True, None, {},
                              residual=False, never=True)
    return CompiledFilter(geom_attr, dtg_attr, boxes, spatial_any,
                          interval, attr_bounds,
                          residual=not exact, never=False)


def exact_match(cf: CompiledFilter, batch, rows: np.ndarray) -> np.ndarray:
    """Exact f64/i64 verdict of the compiled summary for ``rows``
    (candidate row indices into ``batch``). For non-residual filters
    this IS the filter's semantics; it also strips the widened-bound
    false positives the device mask admits."""
    m = len(rows)
    if cf.never:
        return np.zeros(m, dtype=bool)
    ok = np.ones(m, dtype=bool)
    if not cf.spatial_any and cf.geom_attr is not None:
        col = batch.col(cf.geom_attr)
        x, y = col.x[rows], col.y[rows]
        hit = np.zeros(m, dtype=bool)
        for xmin, ymin, xmax, ymax in cf.boxes:
            hit |= (x >= xmin) & (x <= xmax) & (y >= ymin) & (y <= ymax)
        ok &= hit & col.valid[rows]
    if cf.interval is not None and cf.dtg_attr is not None:
        col = batch.col(cf.dtg_attr)
        ms = col.millis[rows]
        lo, hi = cf.interval
        if lo is not None:
            ok &= ms >= lo
        if hi is not None:
            ok &= ms <= hi
        ok &= col.valid[rows]
    for name, ab in cf.attr_bounds.items():
        col = batch.col(name)
        vals = col.values[rows]
        if ab.lo is not None:
            ok &= (vals >= ab.lo) if ab.lo_inc else (vals > ab.lo)
        if ab.hi is not None:
            ok &= (vals <= ab.hi) if ab.hi_inc else (vals < ab.hi)
        ok &= col.valid[rows]
    return ok


def exact_hits(cf: CompiledFilter, f: ast.Filter, batch,
               candidates: np.ndarray) -> np.ndarray:
    """Candidate rows -> exact hit rows: the one patch-step shared by
    every caller of the standing kernel. Residual filters re-run the
    full evaluator on just the surviving candidate rows; compiled-exact
    filters take the cheap vectorized recheck."""
    if cf.never or not len(candidates):
        return candidates[:0]
    if cf.residual:
        keep = evaluate(f, batch.take(candidates))
    else:
        keep = exact_match(cf, batch, candidates)
    return candidates[keep]
