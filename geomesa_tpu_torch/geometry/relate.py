"""DE-9IM topological relationships.

The reference gets `relate` and the derived predicates (touches,
crosses, overlaps, equals, covers) from JTS's full topology graph
(geomesa-spark-sql ST_Relate -> JTS RelateOp). This is an independent
implementation on the split-and-classify scheme:

1. decompose each geometry into *carriers* — points (dim 0), segments
   (dim 1 interiors / dim 2 ring boundaries) — plus the mod-2 boundary
   point set for lines;
2. split every segment of A at its intersections with B's segments (and
   vice versa), so no piece crosses the other geometry's boundary;
3. classify each piece midpoint / split point / boundary point against
   the other geometry (Interior / Boundary / Exterior) and max the
   piece dimension into the matching matrix cell;
4. area-vs-area cells (II / IE / EI for polygons) follow from which
   side of a boundary piece lies where, with a representative interior
   point as the shared-boundary fallback (equal or nested polygons).

Exactness bounds: classification uses the same f64 orientation tests as
the rest of the geometry module — coordinates well below f64 epsilon of
each other can misclassify, the usual non-robust-arithmetic caveat.

Matrix order is JTS's: II IB IE / BI BB BE / EI EB EE over rows = A's
interior/boundary/exterior, columns = B's.
"""

from __future__ import annotations

import numpy as np

from .base import (Geometry, LineString, MultiLineString, MultiPoint,
                   MultiPolygon, Point, Polygon, _on_segment,
                   _ring_contains)

__all__ = ["relate", "relate_matches", "touches", "crosses", "overlaps",
           "topo_equals", "covers", "covered_by", "interior_point"]

_EPS = 1e-12


# -- decomposition ---------------------------------------------------------

def _dim(g: Geometry) -> int:
    if isinstance(g, (Point, MultiPoint)):
        return 0
    if isinstance(g, (LineString, MultiLineString)):
        return 1
    return 2


def _points_of(g) -> list[tuple[float, float]]:
    if isinstance(g, Point):
        return [(float(g.x), float(g.y))]
    return [(float(p.x), float(p.y)) for p in g.parts]


def _lines_of(g) -> list[np.ndarray]:
    if isinstance(g, LineString):
        return [g.coords]
    return [p.coords for p in g.parts]


def _rings_of(g) -> list[np.ndarray]:
    if isinstance(g, Polygon):
        return [g.shell] + list(g.holes)
    out = []
    for p in g.parts:
        out.extend([p.shell] + list(p.holes))
    return out


def _segments(coords_list) -> list[tuple]:
    segs = []
    for c in coords_list:
        for i in range(len(c) - 1):
            a, b = c[i], c[i + 1]
            if a[0] != b[0] or a[1] != b[1]:
                segs.append((float(a[0]), float(a[1]),
                             float(b[0]), float(b[1])))
    return segs


def _line_boundary(g) -> set:
    """Mod-2 rule over ALL parts: endpoints used an odd number of times
    are boundary (a shared junction of two lines is interior)."""
    counts: dict[tuple, int] = {}
    for c in _lines_of(g):
        if len(c) < 2:
            continue
        if (c[0][0], c[0][1]) == (c[-1][0], c[-1][1]):
            continue  # closed ring: no boundary
        for p in ((float(c[0][0]), float(c[0][1])),
                  (float(c[-1][0]), float(c[-1][1]))):
            counts[p] = counts.get(p, 0) + 1
    return {p for p, k in counts.items() if k % 2 == 1}


# -- point location --------------------------------------------------------

def _on_any_segment(segs, x, y) -> bool:
    for (x0, y0, x1, y1) in segs:
        if bool(_on_segment(np.float64(x0), np.float64(y0),
                            np.float64(x1), np.float64(y1),
                            np.float64(x), np.float64(y))):
            return True
    return False


def _locate(g: Geometry, x: float, y: float) -> str:
    """'I' / 'B' / 'E' location of the point in g's topology."""
    if isinstance(g, (Point, MultiPoint)):
        for (px, py) in _points_of(g):
            if px == x and py == y:
                return "I"
        return "E"
    if isinstance(g, (LineString, MultiLineString)):
        if not _on_any_segment(_segments(_lines_of(g)), x, y):
            return "E"
        return "B" if (x, y) in _line_boundary(g) else "I"
    # polygonal
    polys = [g] if isinstance(g, Polygon) else list(g.parts)
    on_ring = False
    for p in polys:
        if _on_any_segment(_segments([p.shell] + list(p.holes)), x, y):
            on_ring = True
            continue
        if bool(p.contains_points(np.float64(x), np.float64(y))):
            return "I"
    return "B" if on_ring else "E"


def interior_point(g) -> tuple[float, float] | None:
    """A point strictly inside a polygonal geometry (scanline between
    crossing pairs; centroid fast path)."""
    polys = [g] if isinstance(g, Polygon) else list(g.parts)
    for p in polys:
        if p.is_empty or p.area == 0:
            continue
        c = p.centroid
        if _locate(p, float(c.x), float(c.y)) == "I":
            return (float(c.x), float(c.y))
        ys = np.unique(np.concatenate(
            [r[:, 1] for r in [p.shell] + list(p.holes)]))
        for j in range(len(ys) - 1):
            ymid = (ys[j] + ys[j + 1]) / 2.0
            xs = []
            for r in [p.shell] + list(p.holes):
                y0, y1 = r[:-1, 1], r[1:, 1]
                x0, x1 = r[:-1, 0], r[1:, 0]
                m = ((y0 <= ymid) & (y1 > ymid)) | ((y1 <= ymid)
                                                    & (y0 > ymid))
                if m.any():
                    t = (ymid - y0[m]) / (y1[m] - y0[m])
                    xs.extend((x0[m] + t * (x1[m] - x0[m])).tolist())
            xs.sort()
            for a, b in zip(xs[::2], xs[1::2]):
                if b - a > _EPS:
                    xm = (a + b) / 2.0
                    if _locate(p, xm, ymid) == "I":
                        return (xm, ymid)
    return None


# -- segment splitting -----------------------------------------------------

def _split_params(ax0, ay0, ax1, ay1, segs_b,
                  pts_b=()) -> list[float]:
    """Parameters t in (0, 1) where segment a meets any segment of b
    (proper crossings, endpoint touches, collinear overlap ends) or
    passes through an isolated point of b."""
    ts: list[float] = []
    adx, ady = ax1 - ax0, ay1 - ay0
    alen2 = adx * adx + ady * ady
    if alen2 == 0:
        return ts
    for (px, py) in pts_b:
        if bool(_on_segment(np.float64(ax0), np.float64(ay0),
                            np.float64(ax1), np.float64(ay1),
                            np.float64(px), np.float64(py))):
            t = ((px - ax0) * adx + (py - ay0) * ady) / alen2
            if _EPS < t < 1 - _EPS:
                ts.append(float(t))
    for (bx0, by0, bx1, by1) in segs_b:
        bdx, bdy = bx1 - bx0, by1 - by0
        denom = adx * bdy - ady * bdx
        if denom != 0:
            # proper / touching intersection of the supporting lines
            t = ((bx0 - ax0) * bdy - (by0 - ay0) * bdx) / denom
            u = ((bx0 - ax0) * ady - (by0 - ay0) * adx) / denom
            if -_EPS <= t <= 1 + _EPS and -_EPS <= u <= 1 + _EPS:
                if _EPS < t < 1 - _EPS:
                    ts.append(float(t))
        else:
            # parallel: collinear overlap contributes b's endpoints
            cross = (bx0 - ax0) * ady - (by0 - ay0) * adx
            if abs(cross) > _EPS * max(1.0, alen2):
                continue
            for (px, py) in ((bx0, by0), (bx1, by1)):
                t = ((px - ax0) * adx + (py - ay0) * ady) / alen2
                if _EPS < t < 1 - _EPS:
                    ts.append(float(t))
    return ts


def _pieces(segs_a, segs_b, pts_b=()):
    """Split A's segments at B intersections (and at B's isolated
    points); yield (midx, midy) per piece, every split point, and the
    original shared vertices (carrier endpoints — a touch exactly at a
    vertex produces no in-segment split, so vertices classify
    separately)."""
    mids, cuts, verts = [], [], []
    for (x0, y0, x1, y1) in segs_a:
        ts = sorted(set([0.0, 1.0] + _split_params(x0, y0, x1, y1,
                                                   segs_b, pts_b)))
        for t0, t1 in zip(ts[:-1], ts[1:]):
            tm = (t0 + t1) / 2.0
            mids.append((x0 + tm * (x1 - x0), y0 + tm * (y1 - y0)))
        for t in ts[1:-1]:
            cuts.append((x0 + t * (x1 - x0), y0 + t * (y1 - y0)))
        verts.append((x0, y0))
        verts.append((x1, y1))
    return mids, cuts, verts


# -- the matrix ------------------------------------------------------------

_IDX = {"I": 0, "B": 1, "E": 2}


class _Matrix:
    def __init__(self):
        self.m = [[-1] * 3 for _ in range(3)]  # -1 = F

    def up(self, row: str, col: str, d: int):
        r, c = _IDX[row], _IDX[col]
        if d > self.m[r][c]:
            self.m[r][c] = d

    def __str__(self):
        return "".join("F" if v < 0 else str(v)
                       for row in self.m for v in row)


def _classify_into(mat: _Matrix, g_other: Geometry, row: str,
                   mids, cuts, dim_piece: int, transpose: bool):
    """Pieces of region `row` of one geometry located against the
    other; `transpose` swaps (row, col) for the B-against-A pass."""
    for (x, y) in mids:
        loc = _locate(g_other, x, y)
        if transpose:
            mat.up(loc, row, dim_piece)
        else:
            mat.up(row, loc, dim_piece)
    for (x, y) in cuts:
        loc = _locate(g_other, x, y)
        if transpose:
            mat.up(loc, row, 0)
        else:
            mat.up(row, loc, 0)


def relate(a: Geometry, b: Geometry) -> str:
    """The DE-9IM matrix of a vs b as a 9-character string."""
    mat = _Matrix()
    mat.up("E", "E", 2)
    da, db = _dim(a), _dim(b)
    a_empty, b_empty = a.is_empty, b.is_empty
    if a_empty or b_empty:
        if not b_empty:
            mat.up("E", "I", db)
            mat.up("E", "B", db - 1 if db else -1)
            if db == 1 and _line_boundary(b):
                mat.up("E", "B", 0)
        if not a_empty:
            mat.up("I", "E", da)
            if da == 1 and _line_boundary(a):
                mat.up("B", "E", 0)
            if da == 2:
                mat.up("B", "E", 1)
        return str(mat)

    segs_a = (_segments(_lines_of(a)) if da == 1
              else _segments(_rings_of(a)) if da == 2 else [])
    segs_b = (_segments(_lines_of(b)) if db == 1
              else _segments(_rings_of(b)) if db == 2 else [])

    pts_a = _points_of(a) if da == 0 else ()
    pts_b = _points_of(b) if db == 0 else ()

    # pass 1: A's carriers against B
    if da == 0:
        for (x, y) in _points_of(a):
            mat.up("I", _locate(b, x, y), 0)
    else:
        mids, cuts, verts = _pieces(segs_a, segs_b, pts_b)
        row = "I" if da == 1 else "B"
        if da == 1:
            bnd = _line_boundary(a)
            cuts = cuts + [v for v in verts if v not in bnd]
            for (x, y) in bnd:
                mat.up("B", _locate(b, x, y), 0)
        else:
            cuts = cuts + verts  # ring vertices are boundary points
        _classify_into(mat, b, row, mids, cuts, 1, transpose=False)

    # pass 2: B's carriers against A (fills columns incl. the E row)
    if db == 0:
        for (x, y) in _points_of(b):
            mat.up(_locate(a, x, y), "I", 0)
    else:
        mids, cuts, verts = _pieces(segs_b, segs_a, pts_a)
        col = "I" if db == 1 else "B"
        if db == 1:
            bnd = _line_boundary(b)
            cuts = cuts + [v for v in verts if v not in bnd]
            for (x, y) in bnd:
                mat.up(_locate(a, x, y), "B", 0)
        else:
            cuts = cuts + verts
        _classify_into(mat, a, col, mids, cuts, 1, transpose=True)

    # area cells: a boundary piece strictly inside the other polygon
    # has that polygon's interior on both of ITS sides
    if da == 2:
        # B's view of A's interior
        if db == 2:
            if mat.m[1][0] > -1:      # B(A) piece met I(B)
                mat.up("I", "I", 2)
                mat.up("E", "I", 2)
            if mat.m[1][2] > -1:      # B(A) piece met E(B)
                mat.up("I", "E", 2)
            if mat.m[0][1] > -1:      # B(B) piece met I(A)
                mat.up("I", "I", 2)
                mat.up("I", "E", 2)
            if mat.m[2][1] > -1:      # B(B) piece met E(A)
                mat.up("E", "I", 2)
            # shared-boundary fallback (equal / nested polygons)
            if mat.m[0][0] < 2:
                ip = interior_point(a)
                if ip is not None:
                    loc = _locate(b, *ip)
                    # Int(A)∩Bnd(B) is a subset of a boundary — at most
                    # 1-dimensional; only the I/E columns can carry 2
                    mat.up("I", loc, 2 if loc != "B" else 1)
                ipb = interior_point(b)
                if ipb is not None:
                    loc = _locate(a, *ipb)
                    if loc == "I":
                        mat.up("I", "I", 2)
                    elif loc == "E":
                        mat.up("E", "I", 2)
        else:
            # lower-dimensional B can never cover a 2-D interior
            mat.up("I", "E", 2)
            if db == 1 and mat.m[0][0] < 0:
                # line piece through I(A) classified in pass 2 already;
                # nothing to do — entry stays as computed
                pass
    if db == 2 and da < 2:
        mat.up("E", "I", 2)
    if da == 2 and db == 2:
        # boundaries always leave SOMETHING exterior on a bounded plane
        pass
    return str(mat)


def relate_matches(matrix: str, pattern: str) -> bool:
    """JTS IntersectionMatrix.matches: 'T' = any non-F, '*' = any,
    'F'/'0'/'1'/'2' exact."""
    for mchar, pchar in zip(matrix, pattern):
        if pchar == "*":
            continue
        if pchar == "T":
            if mchar == "F":
                return False
        elif mchar != pchar:
            return False
    return True


# -- derived predicates (SQLSpatialFunctions semantics via JTS) ------------

def touches(a: Geometry, b: Geometry) -> bool:
    m = relate(a, b)
    return any(relate_matches(m, p)
               for p in ("FT*******", "F**T*****", "F***T****"))


def crosses(a: Geometry, b: Geometry) -> bool:
    m = relate(a, b)
    da, db = _dim(a), _dim(b)
    if da < db:
        return relate_matches(m, "T*T******")
    if da > db:
        return relate_matches(m, "T*****T**")
    if da == 1 and db == 1:
        return m[0] == "0"
    return False


def overlaps(a: Geometry, b: Geometry) -> bool:
    m = relate(a, b)
    da, db = _dim(a), _dim(b)
    if da != db:
        return False
    if da == 1:
        return relate_matches(m, "1*T***T**")
    return relate_matches(m, "T*T***T**")


def topo_equals(a: Geometry, b: Geometry) -> bool:
    return relate_matches(relate(a, b), "T*F**FFF*")


def covers(a: Geometry, b: Geometry) -> bool:
    m = relate(a, b)
    return any(relate_matches(m, p)
               for p in ("T*****FF*", "*T****FF*", "***T**FF*",
                         "****T*FF*"))


def covered_by(a: Geometry, b: Geometry) -> bool:
    return covers(b, a)
