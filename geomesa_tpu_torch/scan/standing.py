"""Standing-filter set: 100k registered geofences matched on the card.

The inverse of the batched ad-hoc scan: there the data is resident and
queries arrive; here the FILTERS are resident (compiled to stacked
bound tables by filters/compile.py) and data arrives as ingest batches.
Every create batch is matched against the whole filter population by
the standing kernels (csrc/standing.cu, the JAX package's
``_standing_mask``, ``_mask_total`` and ``_flat_nonzero``): a slot grid
built on the card from the tables (``kernels.standing_grid``, rebuilt
only after the tables change) sends each row to the slots whose boxes
reach its 1-degree cell and to the everywhere slots; a count pass a
chunk of rows, one prefix over the slots, a write pass a chunk and a
sort of each slot's segment (``kernels.standing_pairs``) give
filter-major, row-ascending ids, so the host sees per-filter hit lists
sized by actual matches, not rows*filters.

Incrementality is the whole point of a STANDING set:

- per-filter tables are capacity-padded to a power of two; ``register``
  writes a slot of the host tables and marks it dirty, and the next
  dispatch uploads every dirty slot in one indexed copy a table, in
  place (``unregister`` tombstones the slot through the alive table).
  Neither changes any device shape: churn within the cap keeps every
  device table's storage (its ``data_ptr``). A rebuild happens only
  when the cap or the per-filter box width grows (amortized doubling);
- ingest rows go through in chunks of a fixed size (``_chunk_rows``),
  so a set has a handful of shape classes, (filter cap, box width,
  attribute count, chunk), over a workload's whole life. The plan-key
  counters (``cache_hits``/``cache_misses``, ``cq.device.plan_cache.*``)
  count them, as the JAX package counts its traces.

Exactness mirrors zscan's conservative-mask + exact-patch split: the
kernel compares two-float pairs against slightly WIDENED bounds (a
guaranteed superset of the f64 predicate), and each filter's surviving
candidates take a host patch (``exact_hits``) — the vectorized f64
recheck for compiled-exact filters, the full ``filters.evaluate`` for
residual ones (LIKE, polygons, OR trees). Either way the final hit set
is id-exact against the evaluator.

The set's tables live on ``device`` (the store's). A dispatch reports
its shape-class probe and its matching's seconds and transfer bytes to
``obs.runtime`` (domain ``standing``) and runs under the stall watchdog
(``dispatch.cq``), beside the ``cq.device.*`` metrics.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..filters.compile import (CompiledFilter, compile_filter, exact_hits,
                               numeric_attrs)
from ..metrics import metrics
from ..utils.device import resolve_device
from ..utils.properties import SystemProperty
from . import kernels
from .zscan import MILLIS_PER_DAY, _split_time, next_pow2, split_two_float

__all__ = ["StandingFilterSet", "STANDING_MIN_CAP", "CQ_DEVICE_MAX_CELLS"]

# starting filter capacity (pow2); the set doubles from here on demand
STANDING_MIN_CAP = 64

# mask-cell budget per kernel launch, as the JAX package defines it:
# dispatch chunks ingest rows so cap*chunk never exceeds this many cells
# (there a launch's mask; here it bounds the rows a launch takes), and
# every chunk shares one shape
CQ_DEVICE_MAX_CELLS = SystemProperty("geomesa.cq.device.max.cells",
                                     str(1 << 27))

# values are clamped into +/-_F32_SAFE before the two-float split so
# overflow-to-inf can never poison the lo residual with NaN; the clamp
# is monotone, so superset-ness survives (host recheck restores f64)
_F32_SAFE = 1.0e38

# widened-bound slack: relative 1e-11 dominates the ~2^-47 relative
# error of a two-float pair by three orders of magnitude, guaranteeing
# the device compare never drops a true f64 match; the slack's false
# positives die in the host recheck
_WIDEN_REL = 1e-11

# catch-all day range: filters with no time constraint carry an
# interval spanning all representable days, so the kernel needs no
# per-filter time_any flag
_TIME_ALL = (-(2 ** 30), 0, 2 ** 30, MILLIS_PER_DAY)

# the device tables, in the kernel's argument order
_TABLES = ("_boxes", "_box_valid", "_box_any", "_times", "_attrs",
           "_attr_any", "_alive")


def _clamp(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, dtype=np.float64)
    return np.clip(a, -_F32_SAFE, _F32_SAFE)


def _widen_lo(v: float) -> float:
    return v - (abs(v) + 1.0) * _WIDEN_REL


def _widen_hi(v: float) -> float:
    return v + (abs(v) + 1.0) * _WIDEN_REL


# a box (xmin, ymin, xmax, ymax): which bounds widen down, and the
# order of the table's (hi, lo) pairs
_BOX_MINS = np.array([True, True, False, False])
_BOX_ORDER = [0, 2, 1, 3]


class StandingFilterSet:
    """The registered filter population for one feature type, compiled
    to capacity-padded tables on ``device``, plus the dispatch that
    matches an ingest batch against all of it."""

    def __init__(self, sft, registry=metrics, min_cap: int = STANDING_MIN_CAP,
                 device=None):
        self.sft = sft
        self.device = resolve_device(device)
        self.geom_attr = sft.geom_field if sft.is_points else None
        self.dtg_attr = sft.dtg_field
        self.attr_names = numeric_attrs(sft)
        self._registry = registry
        self._lock = threading.RLock()
        self._cap = max(next_pow2(max(min_cap, 1)), 1)
        self._k = 1                       # boxes per filter (pow2)
        self._slots: dict[str, int] = {}  # name -> slot
        self._free: list[int] = []        # tombstoned slots, reusable
        self._high = 0                    # high-water slot count
        self._filters: list = []          # slot -> (name, ast, compiled)
        self._alloc_host()
        self._dev: list | None = None     # lazy device tables
        self._dirty: set[int] = set()     # slots the device tables lack
        self._grid = None                 # the tables' slot grid, lazy
        # shape-class observability (scan/batcher.py pattern): a probed
        # key already seen means the dispatch reuses a shape
        self._plan_keys: set[tuple] = set()
        self.cache_hits = 0
        self.cache_misses = 0
        # host-clock seconds of the last dispatch's stages
        self.last_split: dict = {}

    # -- storage ----------------------------------------------------------

    def _alloc_host(self):
        f, k, a = self._cap, self._k, len(self.attr_names)
        self._boxes = np.zeros((f, k, 8), dtype=np.float32)
        self._box_valid = np.zeros((f, k), dtype=bool)
        self._box_any = np.zeros(f, dtype=bool)
        self._times = np.zeros((f, 4), dtype=np.int32)
        self._attrs = np.zeros((f, a, 4), dtype=np.float32)
        self._attr_any = np.zeros((f, a), dtype=bool)
        self._alive = np.zeros(f, dtype=bool)

    def device_tables(self) -> list:
        """The seven device tables (boxes, box_valid, box_any, times,
        attrs, attr_any, alive), uploaded on first use; afterwards the
        dirty slots are copied into them in place, one indexed copy a
        table, so their storage never moves within the cap. Either drops
        the slot grid, which the next match rebuilds."""
        if self._dev is None:
            self._dev = [torch.from_numpy(getattr(self, t)).to(self.device)
                         for t in _TABLES]
            self._dirty.clear()
            self._grid = None
        elif self._dirty:
            self._grid = None
            idx = np.fromiter(sorted(self._dirty), dtype=np.int64)
            didx = torch.from_numpy(idx).to(self.device)
            for d, t in zip(self._dev, _TABLES):
                d[didx] = torch.from_numpy(getattr(self, t)[idx]).to(
                    self.device)
            self._dirty.clear()
        return self._dev

    def _encode(self, cf: CompiledFilter):
        """CompiledFilter -> one row of each per-filter array (widened
        two-float bounds, catch-all defaults). The bounds are clamped,
        widened and split as arrays, one split a filter: the same IEEE
        operations as a split of each bound alone."""
        k, a = self._k, len(self.attr_names)
        boxes = np.zeros((k, 8), dtype=np.float32)
        box_valid = np.zeros(k, dtype=bool)
        box_any = cf.spatial_any and not cf.never
        nb = len(cf.boxes)
        if nb:
            # (nb, 4) xmin, ymin, xmax, ymax: the mins widened down, the
            # maxes up, then laid out (xmin, xmax, ymin, ymax) as
            # (hi, lo) pairs
            b = _clamp(np.asarray(cf.boxes, dtype=np.float64))
            slack = (np.abs(b) + 1.0) * _WIDEN_REL
            hi, lo = split_two_float(np.where(_BOX_MINS, b - slack,
                                              b + slack))
            boxes[:nb, 0::2] = hi[:, _BOX_ORDER]
            boxes[:nb, 1::2] = lo[:, _BOX_ORDER]
            box_valid[:nb] = True
        times = np.asarray(_TIME_ALL, dtype=np.int32)
        if cf.interval is not None:
            lo, hi = cf.interval
            # Python's floor // and % split pre-1970 millis as the rows'
            # numpy floor division does (_split_time)
            lod, lom = (_TIME_ALL[0], _TIME_ALL[1]) if lo is None \
                else (lo // MILLIS_PER_DAY, lo % MILLIS_PER_DAY)
            hid, him = (_TIME_ALL[2], _TIME_ALL[3]) if hi is None \
                else (hi // MILLIS_PER_DAY, hi % MILLIS_PER_DAY)
            times = np.asarray((lod, lom, hid, him), dtype=np.int32)
        attrs = np.zeros((a, 4), dtype=np.float32)
        attr_any = np.ones(a, dtype=bool)
        bounded, ends = [], []
        for j, name in enumerate(self.attr_names):
            ab = cf.attr_bounds.get(name)
            if ab is None:
                continue
            bounded.append(j)
            ends.append((-_F32_SAFE if ab.lo is None
                         else _widen_lo(float(_clamp(ab.lo))),
                         _F32_SAFE if ab.hi is None
                         else _widen_hi(float(_clamp(ab.hi)))))
        if bounded:
            hi, lo = split_two_float(np.asarray(ends, dtype=np.float64))
            attr_any[bounded] = False
            attrs[bounded, 0::2] = hi
            attrs[bounded, 1::2] = lo
        if cf.never:
            # dead on arrival: no box, no box_any -> spatial never passes
            box_valid[:] = False
            box_any = False
        return boxes, box_valid, box_any, times, attrs, attr_any

    def _write_slot(self, slot: int, row, alive: bool):
        boxes, box_valid, box_any, times, attrs, attr_any = row
        self._boxes[slot] = boxes
        self._box_valid[slot] = box_valid
        self._box_any[slot] = box_any
        self._times[slot] = times
        self._attrs[slot] = attrs
        self._attr_any[slot] = attr_any
        self._alive[slot] = alive
        if self._dev is not None:
            self._dirty.add(slot)

    def _grow(self, cap: int | None = None, k: int | None = None):
        """Amortized-doubling rebuild: the live filters move, in slot
        order, to the first slots of fresh host tables (their encoded
        rows copied; a wider box table pads them with unused boxes), and
        the device tables re-upload lazily."""
        self._cap = max(self._cap, next_pow2(max(cap or 0, 1)))
        self._k = max(self._k, next_pow2(max(k or 0, 1)))
        keep = [slot for slot, e in enumerate(self._filters)
                if e[0] is not None]
        old = {t: getattr(self, t) for t in _TABLES}
        live = [self._filters[slot] for slot in keep]
        self._alloc_host()
        self._dev = None
        self._dirty.clear()
        self._free = []
        self._filters = live
        self._slots = {e[0]: slot for slot, e in enumerate(live)}
        self._high = len(live)
        n = len(live)
        for t in _TABLES:
            rows = old[t][keep]
            if t in ("_boxes", "_box_valid"):
                getattr(self, t)[:n, :rows.shape[1]] = rows
            else:
                getattr(self, t)[:n] = rows

    def _append(self, name: str, f, cf: CompiledFilter):
        if self._free:
            slot = self._free.pop()
            self._filters[slot] = (name, f, cf)
        else:
            slot = self._high
            if slot >= self._cap:
                self._grow(cap=self._cap * 2)
                self._append(name, f, cf)
                return
            self._high += 1
            self._filters.append((name, f, cf))
        self._slots[name] = slot
        self._write_slot(slot, self._encode(cf), alive=not cf.never)

    # -- registration ------------------------------------------------------

    def register(self, name: str, f, compiled: CompiledFilter | None = None):
        """Compile + append one standing filter. Within the padded cap
        this is a write of one host slot — no shape changes."""
        with self._lock:
            if name in self._slots:
                raise ValueError(f"standing filter {name!r} exists")
            cf = compiled if compiled is not None \
                else compile_filter(f, self.sft)
            if cf.n_boxes > self._k:
                self._grow(k=cf.n_boxes)
            self._append(name, f, cf)
            self._gauges()
            return cf

    def unregister(self, name: str) -> bool:
        """Tombstone a filter: alive goes False in place, the slot is
        reused by the next register. Never reshapes."""
        with self._lock:
            slot = self._slots.pop(name, None)
            if slot is None:
                return False
            self._filters[slot] = (None, None, None)
            self._free.append(slot)
            self._alive[slot] = False
            if self._dev is not None:
                self._dirty.add(slot)
            self._gauges()
            return True

    def __len__(self) -> int:
        with self._lock:
            return len(self._slots)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._slots

    # -- dispatch ----------------------------------------------------------

    def _rows_host(self, batch):
        """Ingest batch -> host row arrays (two-float coords, split
        times, two-float attributes (n, A)), unchunked and unpadded. Null
        coords/attrs are NaN and never match constrained filters, while
        unconstrained dimensions pass via box_any/attr_any/catch-all."""
        n = batch.n
        if self.geom_attr is not None:
            col = batch.col(self.geom_attr)
            xhi, xlo = split_two_float(_clamp(col.x))
            yhi, ylo = split_two_float(_clamp(col.y))
        else:
            xhi = xlo = yhi = ylo = np.zeros(n, dtype=np.float32)
        if self.dtg_attr is not None:
            col = batch.col(self.dtg_attr)
            tday, tms = _split_time(np.where(col.valid, col.millis, 0))
        else:
            tday = tms = np.zeros(n, dtype=np.int32)
        a = len(self.attr_names)
        avhi = np.zeros((n, a), dtype=np.float32)
        avlo = np.zeros((n, a), dtype=np.float32)
        for j, name in enumerate(self.attr_names):
            col = batch.col(name)
            vals = _clamp(np.where(col.valid,
                                   col.values.astype(np.float64), np.nan))
            vhi, vlo = split_two_float(vals)
            avhi[:, j] = vhi
            avlo[:, j] = vlo
        return (np.asarray(xhi, dtype=np.float32),
                np.asarray(xlo, dtype=np.float32),
                np.asarray(yhi, dtype=np.float32),
                np.asarray(ylo, dtype=np.float32),
                tday.astype(np.int32), tms.astype(np.int32),
                avhi, avlo)

    def _rows_device(self, rows, n_pad: int):
        """The host row arrays padded to ``n_pad`` rows and uploaded once:
        six columns, and the attributes attribute-major (A, n_pad), so a
        chunk is a view of each (``_chunk_views``)."""
        out = []
        for a in rows[:6]:
            buf = np.zeros(n_pad, dtype=a.dtype)
            buf[:len(a)] = a
            out.append(torch.from_numpy(buf).to(self.device))
        for a in rows[6:]:
            buf = np.zeros((a.shape[1], n_pad), dtype=np.float32)
            buf[:, :a.shape[0]] = a.T
            out.append(torch.from_numpy(buf).to(self.device))
        return out

    @staticmethod
    def _chunk_views(dev_rows, start: int, chunk: int):
        return ([c[start:start + chunk] for c in dev_rows[:6]]
                + [a[:, start:start + chunk] for a in dev_rows[6:]])

    def _chunk_rows(self, n: int) -> int:
        """Rows per kernel launch: the largest pow2 keeping cap*chunk
        under the cell budget, clamped to the padded batch size."""
        cells = max(CQ_DEVICE_MAX_CELLS.as_int() or (1 << 27), 1)
        q = max(cells // max(self._cap, 1), 1)
        chunk = 1 << (q.bit_length() - 1)
        return min(chunk, next_pow2(max(n, 1)))

    def _probe_plan_cache(self, key: tuple):
        hit = key in self._plan_keys
        if hit:
            self.cache_hits += 1
        else:
            self._plan_keys.add(key)
            self.cache_misses += 1
        self._registry.counter("cq.device.plan_cache.hit" if hit
                               else "cq.device.plan_cache.miss")
        from ..obs.runtime import runtime
        runtime.note_plan_probe("standing", key, hit)

    def _match(self, dev_rows, tables, n: int, chunk: int):
        """(rows int64 host, counts int64[cap] host): every (filter, row)
        candidate of the batch, filter-major and row-ascending, and each
        filter's count. The slot grid is built first where the tables
        changed; then a count launch a chunk (the counts accumulate on
        the card), the slots' prefix (one sync, the pairs' total), a
        write launch a chunk and one sort; ids and counts come to the
        host once."""
        if self._grid is None:
            self._grid = kernels.standing_grid(tables)
        chunks = [(self._chunk_views(dev_rows, start, chunk),
                   min(chunk, n - start), start)
                  for start in range(0, n, chunk)]
        rows, counts, _ = kernels.standing_pairs(chunks, tables, self._grid)
        return (rows.cpu().numpy().astype(np.int64),
                counts.cpu().numpy().astype(np.int64))

    def dispatch(self, batch) -> dict[str, np.ndarray]:
        """Match one ingest batch against every registered filter:
        {filter name: sorted hit row indices}, id-exact vs the
        ``filters.evaluate`` oracle. Rows stream through the kernel in
        fixed-size chunks (CQ_DEVICE_MAX_CELLS bounds cap*chunk).
        ``last_split`` keeps the host-clock seconds of its stages: row
        prep, uploads (rows and dirty table slots), matching (the grid's
        build where the tables changed, the kernels and the copies to the
        host) and the host patch."""
        with self._lock:
            if not self._slots:
                return {}
            entries = [(name, slot, self._filters[slot][1],
                        self._filters[slot][2])
                       for name, slot in self._slots.items()]
            reg = self._registry
            n = batch.n
            split = {}
            marks = [time.perf_counter()]

            def stage(name: str):
                marks.append(time.perf_counter())
                split[name] = marks[-1] - marks[-2]

            from ..obs.prof import watchdog
            from ..obs.runtime import runtime
            with reg.time("cq.device.dispatch"), \
                    watchdog.watch("dispatch.cq"):
                rows = self._rows_host(batch)
                chunk = self._chunk_rows(n)
                key = (self._cap, self._k, len(self.attr_names), chunk)
                self._probe_plan_cache(key)
                stage("prep_s")
                dev_rows = self._rows_device(rows, -(-n // chunk) * chunk)
                tables = self.device_tables()
                stage("upload_s")
                hit_rows, counts = self._match(dev_rows, tables, n, chunk)
                stage("match_s")
                runtime.note_dispatch(
                    "standing", key, marks[-1] - marks[0],
                    h2d_bytes=sum(int(t.numel() * t.element_size())
                                  for t in dev_rows),
                    d2h_bytes=int(hit_rows.nbytes + counts.nbytes))
                hi = np.cumsum(counts)
                lo = hi - counts
                out: dict[str, np.ndarray] = {}
                cand_rows = 0
                for name, slot, f, cf in entries:
                    cand = hit_rows[lo[slot]:hi[slot]]
                    cand_rows += len(cand)
                    out[name] = exact_hits(cf, f, batch, cand)
                stage("patch_s")
            self.last_split = split
            n_res = sum(1 for _, _, _, cf in entries if cf.residual)
            reg.counter("cq.device.rows", n)
            reg.counter("cq.device.candidates", cand_rows)
            reg.counter("cq.device.hits",
                        int(sum(len(h) for h in out.values())))
            self._gauges(residual=n_res / max(len(entries), 1))
            return out

    # -- observability -----------------------------------------------------

    def _gauges(self, residual: float | None = None):
        reg = self._registry
        reg.gauge("cq.device.padded_cap", self._cap)
        reg.gauge("cq.device.live", len(self._slots))
        if residual is not None:
            reg.gauge("cq.device.residual.fraction", round(residual, 4))
        probes = self.cache_hits + self.cache_misses
        if probes:
            reg.gauge("cq.device.plan_cache.hit_rate",
                      round(self.cache_hits / probes, 4))

    def stats(self) -> dict:
        with self._lock:
            n_res = sum(1 for e in self._filters
                        if e[0] is not None and e[2].residual)
            live = len(self._slots)
            return {
                "type_name": self.sft.type_name,
                "live": live,
                "padded_cap": self._cap,
                "boxes_per_filter": self._k,
                "tracked_attrs": list(self.attr_names),
                "residual": n_res,
                "residual_fraction": round(n_res / max(live, 1), 4),
                "plan_cache_hits": self.cache_hits,
                "plan_cache_misses": self.cache_misses,
            }
