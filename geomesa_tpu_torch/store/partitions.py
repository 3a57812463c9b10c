"""Partition schemes for the filesystem store.

Mirrors the reference's fs partition schemes
(fs/storage/common/PartitionScheme.scala:99): DateTimeScheme (daily /
hourly / monthly / julian directory trees), Z2Scheme (z-curve cell
dirs), and CompositeScheme (scheme products). A scheme maps each
feature to a partition name at write time and a filter to the covering
partition-name set at plan time (partition pruning IS the fs store's
query planning, fs/FsQueryPlanning.scala).

Partition names are directory names under a type's ``data/``, and are
byte-equal to the JAX package's for every scheme, so a root written by
either package is read by the other. A scheme names each distinct
bucket once (a day, an hour, a z2 cell) and hands the names out to the
rows by index, rather than formatting a string a row; ``partition_groups``
gives the writer those names with the row index, so rows group without
a sort of their strings.
"""

from __future__ import annotations

import itertools

import numpy as np

from ..curves import z2_encode
from ..features.batch import FeatureBatch, PointColumn
from ..features.sft import SimpleFeatureType
from ..filters import ast
from ..filters.helper import extract_geometries, extract_intervals

__all__ = ["PartitionScheme", "DateTimeScheme", "Z2Scheme",
           "CompositeScheme", "scheme_from_config", "AttributeScheme"]

MS_HOUR = 3_600_000
MS_DAY = 86_400_000


class PartitionScheme:
    """Maps rows -> partition names and filters -> covering names."""

    name: str

    # a scheme defines one of the two row methods; each is the other's
    # default

    def partition_for_rows(self, sft: SimpleFeatureType,
                           batch: FeatureBatch) -> np.ndarray:
        names, inverse = self.partition_groups(sft, batch)
        return names[inverse]

    def partition_groups(self, sft: SimpleFeatureType, batch: FeatureBatch
                         ) -> tuple[np.ndarray, np.ndarray]:
        """(distinct partition names, sorted; each row's index into
        them): ``names[inverse]`` is ``partition_for_rows``."""
        names, inverse = np.unique(self.partition_for_rows(sft, batch),
                                   return_inverse=True)
        return names, inverse.ravel()

    def covering_partitions(self, sft: SimpleFeatureType,
                            f: ast.Filter) -> list[str] | None:
        """Partition names possibly matching the filter, or None when
        the scheme cannot prune (= all partitions)."""
        raise NotImplementedError

    def to_config(self) -> dict:
        raise NotImplementedError


class DateTimeScheme(PartitionScheme):
    """Time-directory partitions (PartitionScheme.scala:190).

    Formats: 'daily' -> yyyy/MM/dd, 'hourly' -> yyyy/MM/dd/HH,
    'monthly' -> yyyy/MM, 'julian-daily' -> yyyy/DDD.
    """

    FORMATS = ("daily", "hourly", "monthly", "julian-daily")

    def __init__(self, fmt: str = "daily", dtg: str | None = None):
        if fmt not in self.FORMATS:
            raise ValueError(f"unknown datetime format {fmt!r}")
        self.fmt = fmt
        self.dtg = dtg
        self.name = f"datetime:{fmt}"

    def _names_for_millis(self, ms: np.ndarray) -> np.ndarray:
        dt = np.asarray(ms, np.int64).astype("datetime64[ms]")
        years = dt.astype("datetime64[Y]")
        y = (years.astype(np.int64) + 1970).astype("U4")
        months = dt.astype("datetime64[M]")
        m = np.char.zfill(((months.astype(np.int64) % 12) + 1).astype("U2"), 2)
        if self.fmt == "monthly":
            return np.char.add(np.char.add(y, "/"), m)
        days = dt.astype("datetime64[D]")
        if self.fmt == "julian-daily":
            doy = ((days - years.astype("datetime64[D]"))
                   .astype(np.int64) + 1).astype("U3")
            return np.char.add(np.char.add(y, "/"), np.char.zfill(doy, 3))
        dom = np.char.zfill(
            ((days - months.astype("datetime64[D]")).astype(np.int64) + 1
             ).astype("U2"), 2)
        ymd = np.char.add(np.char.add(np.char.add(np.char.add(y, "/"), m), "/"), dom)
        if self.fmt == "daily":
            return ymd
        hh = np.char.zfill(((np.asarray(ms, np.int64) // MS_HOUR) % 24
                            ).astype("U2"), 2)
        return np.char.add(np.char.add(ymd, "/"), hh)

    def partition_groups(self, sft, batch):
        dtg = self.dtg or sft.dtg_field
        ms = np.asarray(batch.col(dtg).millis, np.int64)
        # every name is a function of the row's hour (hourly) or day:
        # format each distinct bucket's first millisecond once (days of
        # one month share a monthly name, so the names dedupe too)
        step = MS_HOUR if self.fmt == "hourly" else MS_DAY
        buckets, inverse = np.unique(ms // step, return_inverse=True)
        names, of_bucket = np.unique(self._names_for_millis(buckets * step),
                                     return_inverse=True)
        return names, of_bucket.ravel()[inverse.ravel()]

    def covering_partitions(self, sft, f):
        dtg = self.dtg or sft.dtg_field
        if dtg is None:
            return None
        iv = extract_intervals(f, dtg)
        if iv.disjoint:
            return []
        if not iv or any(not (b.lower.is_bounded and b.upper.is_bounded)
                         for b in iv):
            return None
        step = {"hourly": MS_HOUR}.get(self.fmt, MS_DAY)
        names: set[str] = set()
        for b in iv:
            lo = int(b.lower.value) if not isinstance(b.lower.value, str) \
                else int(np.datetime64(str(b.lower.value).rstrip("Z"), "ms").astype(np.int64))
            hi = int(b.upper.value) if not isinstance(b.upper.value, str) \
                else int(np.datetime64(str(b.upper.value).rstrip("Z"), "ms").astype(np.int64))
            if hi < lo:
                continue
            if (hi - lo) // step > 100_000:
                return None  # too wide to enumerate; fall back to all
            ts = np.arange((lo // step) * step, hi + 1, step, dtype=np.int64)
            names.update(self._names_for_millis(ts).tolist())
        return sorted(names)

    def to_config(self):
        return {"scheme": "datetime", "format": self.fmt, "dtg": self.dtg}


class Z2Scheme(PartitionScheme):
    """Z2-cell partitions (PartitionScheme.scala:262): the leading
    2*bits bits of the z2 key, as zero-padded decimal dir names."""

    def __init__(self, bits: int = 4, geom: str | None = None):
        self.bits = bits
        self.geom = geom
        self.name = f"z2:{bits}"
        self._digits = len(str((1 << (2 * bits)) - 1))

    def _cell_of(self, x, y) -> np.ndarray:
        z = z2_encode(self._norm(x, 180.0), self._norm(y, 90.0))
        return (z >> np.uint64(62 - 2 * self.bits)).astype(np.int64)

    def _norm(self, v, half: float) -> np.ndarray:
        v = np.clip(np.asarray(v, np.float64), -half, half)
        n = np.floor((v + half) / (2 * half) * (1 << 31)).astype(np.int64)
        return np.minimum(n, (1 << 31) - 1).astype(np.int64)

    def partition_groups(self, sft, batch):
        geom = self.geom or sft.geom_field
        col = batch.col(geom)
        if isinstance(col, PointColumn):
            x, y = col.x, col.y
        else:
            x = (col.bounds[:, 0] + col.bounds[:, 2]) / 2
            y = (col.bounds[:, 1] + col.bounds[:, 3]) / 2
        # distinct cells are distinct names, in the same (zero-padded) order
        cells, inverse = np.unique(self._cell_of(x, y), return_inverse=True)
        names = np.char.zfill(cells.astype(f"U{self._digits}"), self._digits)
        return names, inverse.ravel()

    def covering_partitions(self, sft, f):
        geom = self.geom or sft.geom_field
        if geom is None:
            return None
        geoms = extract_geometries(f, geom)
        if geoms.disjoint:
            return []
        if not geoms:
            return None
        cells: set[int] = set()
        side = 1 << self.bits
        for g in geoms:
            env = g.envelope
            x0 = int(np.clip((env.xmin + 180) / 360 * side, 0, side - 1))
            x1 = int(np.clip((env.xmax + 180) / 360 * side, 0, side - 1))
            y0 = int(np.clip((env.ymin + 90) / 180 * side, 0, side - 1))
            y1 = int(np.clip((env.ymax + 90) / 180 * side, 0, side - 1))
            for cx in range(x0, x1 + 1):
                for cy in range(y0, y1 + 1):
                    z = int(z2_encode(np.int64(cx) << np.int64(31 - self.bits),
                                      np.int64(cy) << np.int64(31 - self.bits)))
                    cells.add(z >> (62 - 2 * self.bits))
        return [str(c).zfill(self._digits) for c in sorted(cells)]

    def to_config(self):
        return {"scheme": "z2", "bits": self.bits, "geom": self.geom}


class AttributeScheme(PartitionScheme):
    """Partition by an attribute's value (the reference supports
    attribute partitioning in later versions; useful for e.g. per-day
    source splits)."""

    def __init__(self, attribute: str):
        self.attribute = attribute
        self.name = f"attr:{attribute}"

    def partition_for_rows(self, sft, batch):
        col = batch.col(self.attribute)
        return np.array([str(col.value(i)) for i in range(batch.n)])

    def covering_partitions(self, sft, f):
        from ..filters.helper import extract_attribute_bounds
        bounds = extract_attribute_bounds(f, self.attribute)
        if bounds.disjoint:
            return []
        if not bounds:
            return None
        names = []
        for b in bounds:
            if b.is_equality:
                names.append(str(b.lower.value))
            else:
                return None
        return sorted(set(names))

    def to_config(self):
        return {"scheme": "attribute", "attribute": self.attribute}


class CompositeScheme(PartitionScheme):
    """Product of schemes: names join with '/' (PartitionScheme.scala
    CompositeScheme)."""

    def __init__(self, schemes: list[PartitionScheme]):
        self.schemes = schemes
        self.name = "composite:" + "+".join(s.name for s in schemes)

    def partition_groups(self, sft, batch):
        # the product of the schemes' groups, a pair of indices at a time
        # (so a key stays under rows * names), each distinct name joined once
        groups = [s.partition_groups(sft, batch) for s in self.schemes]
        names, inverse = groups[0]
        for more, of_row in groups[1:]:
            pairs, inverse = np.unique(
                inverse.astype(np.int64) * len(more) + of_row,
                return_inverse=True)
            names = np.char.add(
                np.char.add(names[pairs // len(more)].astype(str), "/"),
                more[pairs % len(more)].astype(str))
            inverse = inverse.ravel()
        names, of_pair = np.unique(names, return_inverse=True)
        return names, of_pair.ravel()[inverse]

    def covering_partitions(self, sft, f):
        per = [s.covering_partitions(sft, f) for s in self.schemes]
        if any(p == [] for p in per):
            return []
        if any(p is None for p in per):
            # cannot enumerate the product when one side is unpruned
            return None
        return ["/".join(combo) for combo in itertools.product(*per)]

    def to_config(self):
        return {"scheme": "composite",
                "schemes": [s.to_config() for s in self.schemes]}


def scheme_from_config(cfg: dict) -> PartitionScheme:
    kind = cfg["scheme"]
    if kind == "datetime":
        return DateTimeScheme(cfg.get("format", "daily"), cfg.get("dtg"))
    if kind == "z2":
        return Z2Scheme(cfg.get("bits", 4), cfg.get("geom"))
    if kind == "attribute":
        return AttributeScheme(cfg["attribute"])
    if kind == "composite":
        return CompositeScheme([scheme_from_config(c) for c in cfg["schemes"]])
    raise ValueError(f"unknown partition scheme: {kind}")
