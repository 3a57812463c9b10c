"""The port's micro-batched scan against the JAX reference on the CPU.

The same seeded columns (the reference's DeviceScanData, fetched as
numpy and carried across with scan_data_from_numpy) go through the
port's batched scan (the plain versions of scan_batch_bits and
compact_bits) and through the reference's vmapped XLA programs
(_batch_mask_cand, _batch_count, batch_hit_rows, scan_mask_batch); at
the store level the port's query_batched meets the reference store's
and the port's own scalar query(). Tolerance: exact everywhere. The
batched predicate and candidate test are pure compares of identical
f32/i32 words, so bitmaps, counts and row ids must be equal."""

import numpy as np
import pytest
import torch

from geomesa_tpu.index.api import Query as JQuery
from geomesa_tpu.scan import zscan as jzscan
from geomesa_tpu.store import InMemoryDataStore as JaxStore
from geomesa_tpu_torch import InMemoryDataStore, Query
from geomesa_tpu_torch.scan import kernels
from geomesa_tpu_torch.scan import zscan as tzscan

MS_DAY = 86_400_000

# mixed K (1..3 boxes, pad 4) and B (0..3 intervals, pad 4), time-free
# members, boxes with bounds on 0.0
BASE_QUERIES = [
    ([(-80.0, 30.0, -60.0, 45.0)], [(20 * MS_DAY, 50 * MS_DAY)]),
    ([(-10.0, -10.0, 10.0, 10.0)], []),
    ([(-80.0, 30.0, -60.0, 45.0), (0.0, 0.0, 30.0, 20.0),
      (100.0, -50.0, 140.0, -10.0)],
     [(0, 10 * MS_DAY), (90 * MS_DAY, 99 * MS_DAY), (40 * MS_DAY, 41 * MS_DAY)]),
    ([(-180.0, -90.0, 180.0, 90.0)], [(0, 100 * MS_DAY)]),
    ([(0.0, -5.0, 5.0, 0.0)], []),
]


def _queries(count: int, seed: int = 11):
    """``count`` queries: the base ones, then seeded boxes 1-40 degrees
    wide, a quarter of them time-free, some with two boxes."""
    rng = np.random.default_rng(seed)
    out = list(BASE_QUERIES[:count])
    while len(out) < count:
        boxes = []
        for _ in range(1 + (rng.random() < 0.25)):
            w, h = rng.uniform(1, 40, 2)
            x0, y0 = rng.uniform(-180, 180 - w), rng.uniform(-90, 90 - h)
            boxes.append((x0, y0, x0 + w, y0 + h))
        iv = [] if rng.random() < 0.25 else [
            tuple(sorted(rng.integers(0, 100 * MS_DAY, 2).tolist()))]
        out.append((boxes, iv))
    return out


def _carry(d, device="cpu"):
    """The reference's device columns as the port's ScanData."""
    return tzscan.scan_data_from_numpy(
        *(np.asarray(a) for a in (d.xhi, d.xlo, d.yhi, d.ylo, d.tday, d.tms)),
        d.n, device)


@pytest.fixture(scope="module", params=[(40_001, 65_536), (4_096, 4_096),
                                        (2_085, 2_090)],
                ids=["cap>n", "cap=n", "cap%32"])
def data(request):
    """n % 32 != 0 with capacity padding; n == cap; a capacity that is
    not a multiple of 32. Rows at exactly x = 0 and y = 0 (the hi cells
    of the zero bounds)."""
    n, cap = request.param
    rng = np.random.default_rng(5)
    x = rng.uniform(-180, 180, n)
    y = rng.uniform(-90, 90, n)
    ms = rng.integers(0, 100 * MS_DAY, n).astype(np.int64)
    x[:40] = 0.0
    y[20:60] = 0.0
    jd = jzscan.build_scan_data(x, y, ms, cap=cap)
    return x, y, ms, jd, _carry(jd)


def _batches(count):
    qs = _queries(count)
    return (jzscan.stack_queries([jzscan.make_query(*q) for q in qs]),
            tzscan.stack_queries([tzscan.make_query(*q) for q in qs]))


@pytest.mark.parametrize("count", [1, 2, 3, 32])
def test_bitmaps_match_batch_mask_cand(data, count):
    _, _, _, jd, td = data
    jb, tb = _batches(count)
    # the reference pads its batch to a power of two; the port's batch
    # is the queries themselves, with the same (K, B) padding
    assert tb.boxes_np.shape == (count,) + jb.boxes.shape[1:]
    assert tb.times_np.shape == (count,) + jb.times.shape[1:]
    mask, cand = jzscan._batch_mask_cand(
        jd.xhi, jd.xlo, jd.yhi, jd.ylo, jd.tday, jd.tms, jb.boxes,
        jb.box_valid, jb.times, jb.time_valid, np.int32(jd.n))
    b, t = tb.tables("cpu")
    bits, partials = kernels.scan_batch_bits(td.cols, td.n, b, t,
                                             tb.counts("cpu"))
    words, nb = kernels.batch_shape(td.cap)
    assert bits.shape == (2, count, words) and partials.shape == (2, count, nb)
    for kind, want in enumerate((mask, cand)):
        got = kernels.unpack_bits(bits[kind].reshape(-1)).view(count, -1)
        assert not got[:, td.n:].any()
        want = np.asarray(want)
        assert not want[count:].any()
        assert np.array_equal(got[:, :td.cap].numpy(), want[:count])
        assert np.array_equal(partials[kind].sum(dim=1).numpy(),
                              np.asarray(jzscan._batch_count(want))[:count])
    # rows at x = 0 or y = 0 are candidates of query 2, whose box has
    # zero bounds, and of no query without one: unused slots and padded
    # queries never flag them
    cand_np = np.asarray(cand)
    assert not cand_np[:2, :60].any() and not cand_np[count:].any()
    if count > 2:
        assert cand_np[2, :60].all()
    assert np.array_equal(tzscan.scan_mask_batch(td, tb).numpy(),
                          np.asarray(jzscan.scan_mask_batch(jd, jb))[:count])


@pytest.mark.parametrize("count", [1, 2, 3, 32])
def test_batch_hit_rows_match(data, count):
    _, _, _, jd, td = data
    jb, tb = _batches(count)
    hits, cands = tzscan.batch_hit_rows(td, tb)
    want_hits, want_cands = jzscan.batch_hit_rows(jd, jb)
    assert len(hits) == len(cands) == count
    for got, want in zip(hits + cands, want_hits + want_cands):
        assert got.dtype == np.int32
        assert np.array_equal(got, want)


def test_compaction_layout(data):
    """compact_bits' flat buffers are each query's ascending rows in
    query order, as partials count them."""
    _, _, _, _, td = data
    _, tb = _batches(32)
    b, t = tb.tables("cpu")
    bits, partials = kernels.scan_batch_bits(td.cols, td.n, b, t,
                                             tb.counts("cpu"))
    offsets, totals = kernels.compact_prefix(partials)
    assert offsets.dtype == torch.int32 and offsets.shape == partials.shape
    assert torch.equal(offsets[:, :, 1:],
                       torch.cumsum(partials, dim=2)[:, :, :-1].int())
    assert not offsets[:, :, 0].any()
    assert totals.dtype == torch.int64 and totals.shape == (2, 32)
    *ids_by_kind, got_counts = kernels.compact_bits(bits, partials)
    assert np.array_equal(got_counts, totals.numpy())
    for kind, ids in enumerate(ids_by_kind):
        counts = partials[kind].sum(dim=1).tolist()
        assert got_counts[kind].tolist() == counts
        assert ids.dtype == torch.int32 and len(ids) == sum(counts)
        parts = torch.split(ids, counts)
        for q, part in enumerate(parts):
            mask = kernels.unpack_bits(bits[kind, q])
            assert torch.equal(part.long(), torch.nonzero(mask).flatten())


def test_patched_rows_are_exact(data):
    """After the per-query f64 patch the batched rows equal the f64
    brute force (rows at the zero bounds included)."""
    x, y, ms, _, td = data
    qs = _queries(32)
    sqs = [tzscan.make_query(*q) for q in qs]
    hits, cands = tzscan.batch_hit_rows(td, tzscan.stack_queries(sqs))
    for (boxes, iv), sq, rows, cand in zip(qs, sqs, hits, cands):
        want = np.zeros(len(x), dtype=bool)
        for x0, y0, x1, y1 in boxes:
            want |= (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
        if iv:
            t = np.zeros(len(x), dtype=bool)
            for lo, hi in iv:
                t |= (ms >= lo) & (ms <= hi)
            want &= t
        got = tzscan.patch_hit_rows(rows, sq, x, y, ms, cand)
        assert np.array_equal(got, np.flatnonzero(want))


def test_slot_counts_match_reference():
    """stack_queries' per-query counts are the reference's box_valid and
    time_valid prefixes: each query's own boxes, and its intervals (one,
    the catch-all, when it is time-free)."""
    for count in (1, 3, 32):
        jb, tb = _batches(count)
        assert tb.counts_np.dtype == np.int32
        assert tb.counts_np.shape == (count, 2)
        assert np.array_equal(tb.counts_np[:, 0],
                              np.asarray(jb.box_valid).sum(1)[:count])
        assert np.array_equal(tb.counts_np[:, 1],
                              np.asarray(jb.time_valid).sum(1)[:count])
        c = tb.counts("cpu")
        assert c.dtype == torch.int32 and np.array_equal(c.numpy(),
                                                         tb.counts_np)
    assert tb.counts_np[1].tolist() == [1, 1]   # time-free: the catch-all
    assert tb.counts_np[2].tolist() == [3, 3]


def test_counts_bound_the_slots(data):
    """The plain bitmap scan over each query's own slots equals the scan
    over every slot (counts of K boxes and B intervals: unused slots
    match nothing); counts of 0 boxes or 0 intervals match no row, and
    counts past the padding are clamped to it."""
    _, _, _, _, td = data
    _, tb = _batches(32)
    b, t = tb.tables("cpu")
    all_slots = torch.tensor([[b.shape[1], t.shape[1]]] * 32,
                             dtype=torch.int32)
    every = kernels.scan_batch_bits(td.cols, td.n, b, t, all_slots)
    own = kernels.scan_batch_bits(td.cols, td.n, b, t, tb.counts("cpu"))
    assert all(torch.equal(x, y) for x, y in zip(every, own))
    c = tb.counts("cpu").clone()
    c[0, 0] = 0
    c[3, 1] = 0
    c[5] = torch.tensor([99, -4])
    bits, partials = kernels.scan_batch_bits(td.cols, td.n, b, t, c)
    assert not bits[:, 0].any() and not bits[0, 3].any()
    assert torch.equal(bits[1, 3], every[0][1, 3])
    assert not bits[0, 5].any()
    assert torch.equal(bits[1, 5], every[0][1, 5])
    assert torch.equal(bits[:, 6:], every[0][:, 6:])


def test_prefix_bases_past_int32():
    """The plain prefix on synthetic partials whose sum over the queries
    passes 2^31: int32 offsets within each query, int64 totals, and int64
    bases (the prefix of the totals over the queries of a kind)."""
    qp, nb = 96, 16_384
    parts = torch.full((2, qp, nb), 2048, dtype=torch.int32)
    parts[:, :, 5::7] = 3
    parts[0, 11] = 0
    offsets, totals = kernels.compact_prefix(parts)
    host = parts.numpy().astype(np.int64)
    sums = host.sum(axis=2)
    assert offsets.dtype == torch.int32 and totals.dtype == torch.int64
    assert np.array_equal(offsets.numpy(), np.cumsum(host, axis=2) - host)
    assert np.array_equal(totals.numpy(), sums)
    bases = np.cumsum(totals.numpy(), axis=1) - totals.numpy()
    assert bases.dtype == np.int64 and bases[0, -1] > 2**31
    assert np.array_equal(bases, np.cumsum(sums, axis=1) - sums)


def _lookback_emulation(partials, order):
    """The prefix kernel's bookkeeping on the host: the tiles of
    ``kernels.prefix_plan`` (PREFIX_TILE partials each, row by row) all
    publish their aggregates (a row's first tile its inclusive prefix),
    then walk back in ``order`` over their row's earlier tiles to the
    nearest published inclusive prefix, each publishing its own."""
    rows = partials.shape[0] * partials.shape[1]
    nb = partials.shape[2]
    per_row, tiles, words = kernels.prefix_plan(rows, nb)
    flat = partials.reshape(rows, nb).to(torch.int64)
    tile = kernels.PREFIX_TILE

    def part(t):
        row, j = divmod(t, per_row)
        return flat[row, j * tile:(j + 1) * tile]
    status = [("P" if t % per_row == 0 else "A", int(part(t).sum()))
              for t in range(tiles)]
    offsets = torch.empty(rows, nb, dtype=torch.int64)
    totals = torch.empty(rows, dtype=torch.int64)
    for t in order:
        row, j = divmod(t, per_row)
        agg, prefix, k = int(part(t).sum()), 0, t - 1
        while j:
            flag, v = status[k]
            prefix += v
            if flag == "P":
                break
            k -= 1
        assert k >= row * per_row or not j   # the walk ends in its row
        status[t] = ("P", prefix + agg)
        offsets[row, j * tile:(j + 1) * tile] = (
            prefix + torch.cumsum(part(t), 0) - part(t))
        if j == per_row - 1:
            totals[row] = prefix + agg
    assert words == 1 + tiles
    return (offsets.view(partials.shape).to(torch.int32),
            totals.view(partials.shape[:2]))


@pytest.mark.parametrize("nb", [1, 4095, 4097, 65536])
def test_prefix_tiles_and_lookback(nb):
    """The tile count and scratch size that the wrapper computes for
    the prefix kernel (one tile of 4096 partials per block, a counter
    and a status word per tile), and a look-back over those tiles, in
    ticket order (each tile finds its predecessor's inclusive prefix)
    and in reverse (each walks over aggregates to its row's first
    tile), equal the plain prefix."""
    assert kernels.PREFIX_TILE == 4096
    rng = np.random.default_rng(nb)
    parts = torch.from_numpy(rng.integers(0, 2049, (2, 3, nb)).astype(np.int32))
    parts[:, :, ::5] = 0
    per_row, tiles, words = kernels.prefix_plan(6, nb)
    assert per_row == -(-nb // 4096) and tiles == 6 * per_row
    assert per_row * 4096 >= nb > (per_row - 1) * 4096
    want = kernels.compact_prefix_plain(parts)
    for order in (range(tiles), range(tiles - 1, -1, -1)):
        got = _lookback_emulation(parts, list(order))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_stacked_tables():
    """Unused box slots hold NaN in every bound and unused intervals
    impossible bounds; a time-free query carries the reference's
    catch-all interval; padded queries hold no used slot."""
    qs = _queries(3)
    tb = tzscan.stack_queries([tzscan.make_query(*q) for q in qs])
    assert tb.boxes_np.shape == (3, 4, 8) and tb.times_np.shape == (3, 4, 4)
    assert tb.n_queries == 3
    assert np.isnan(tb.boxes_np[0, 1:]).all()
    assert np.isnan(tb.boxes_np[1, 1:]).all()
    assert tuple(tb.times_np[1, 0]) == jzscan._CATCH_ALL_INTERVAL
    assert (tb.times_np[1, 1:, 0] == np.iinfo(np.int32).max).all()
    assert (tb.times_np[1, 1:, 2] == np.iinfo(np.int32).min).all()
    sq = tzscan.make_query(*qs[2])
    assert np.array_equal(tb.boxes_np[2, :3], sq.boxes_np[:3])
    assert np.array_equal(tb.times_np[2, :3], sq.times_np[:3])
    with pytest.raises(ValueError):
        tzscan.stack_queries([])


def test_empty_and_zero_capacity():
    """n = 0 gives empty bitmaps; a zero-capacity table no words."""
    _, tb = _batches(2)
    b, t = tb.tables("cpu")
    for n, cap in ((0, 64), (0, 0)):
        cols = tuple(torch.zeros(cap, dtype=dt) for dt in
                     (torch.float32,) * 4 + (torch.int32,) * 2)
        bits, partials = kernels.scan_batch_bits(cols, n, b, t,
                                                 tb.counts("cpu"))
        assert bits.shape[2] == -(-cap // 32) and not bits.any()
        assert not partials.any()
        hit, cand, counts = kernels.compact_bits(bits, partials)
        assert len(hit) == len(cand) == 0
        assert counts.shape == (2, 2) and not counts.any()


def test_batch_wrapper_checks():
    cols = tuple(torch.zeros(64, dtype=dt) for dt in
                 (torch.float32,) * 4 + (torch.int32,) * 2)
    boxes = torch.zeros(2, 1, 8)
    times = torch.zeros(2, 1, 4, dtype=torch.int32)
    counts = torch.ones(2, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        kernels.scan_batch_bits(cols, 65, boxes, times, counts)
    with pytest.raises(ValueError, match="boxes"):
        kernels.scan_batch_bits(cols, 64, boxes[0], times, counts)
    with pytest.raises(ValueError, match="same Qp"):
        kernels.scan_batch_bits(cols, 64, boxes, times[:1], counts)
    with pytest.raises(ValueError, match="times"):
        kernels.scan_batch_bits(cols, 64, boxes, times.long(), counts)
    bits, partials = kernels.scan_batch_bits(cols, 64, boxes, times, counts)
    with pytest.raises(ValueError, match="partials"):
        kernels.compact_bits(bits, partials[:, :, :0])
    # a batch whose tables exceed the shared memory of one launch runs
    # as several launches over query groups; only one query's own
    # tables past the limit are refused
    assert kernels._batch_group(boxes, times) == kernels.BATCH_MAX_GROUP
    # (a query's shared memory: its staged hit and candidate words, 2 x
    # 64 x 4 B, its boxes with their hi bounds again, 48 B each, its
    # interval keys of 16 B and its counts)
    wide = torch.zeros(32, 64, 8), torch.zeros(32, 8, 4, dtype=torch.int32)
    assert kernels._batch_group(*wide) == (48 * 1024) // (
        512 + 64 * 48 + 8 * 16 + 8)
    with pytest.raises(ValueError, match="one query"):
        kernels._batch_group(torch.zeros(1, 2048, 8), times[:1])
    for bad in (torch.zeros(2, 2, dtype=torch.int64),
                torch.zeros(1, 2, dtype=torch.int32),
                torch.zeros(2, 3, dtype=torch.int32)):
        with pytest.raises(ValueError, match="counts"):
            kernels.scan_batch_bits(cols, 64, boxes, times, bad)


# -- the store ---------------------------------------------------------------

SPEC = "name:String,dtg:Date,*geom:Point:srid=4326"
T0 = int(np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64))
N = 30_000

STORE_QUERIES = [
    "BBOX(geom, -80, 30, -60, 45) AND dtg DURING "
    "2020-01-10T00:00:00Z/2020-02-20T00:00:00Z",
    "BBOX(geom, -10, -10, 10, 10)",
    "(BBOX(geom, -80, 30, -60, 45) OR BBOX(geom, 0, 0, 30, 20)) AND "
    "dtg DURING 2020-01-05T00:00:00Z/2020-03-01T00:00:00Z",
    "INTERSECTS(geom, POLYGON((100 -50, 140 -50, 140 -10, 100 -10, "
    "100 -50))) AND dtg BETWEEN 2020-02-01T00:00:00Z AND "
    "2020-03-15T00:00:00Z",
    "BBOX(geom, 0, -30, 50, 0) AND dtg DURING "
    "2020-01-01T00:00:00Z/2020-04-01T00:00:00Z",
    "BBOX(geom, -120, -60, 120, 60) AND dtg >= 2020-01-15T00:00:00Z AND "
    "dtg <= 2020-02-15T00:00:00Z",
    "BBOX(geom, 0, 0, 10, 10) AND BBOX(geom, 20, 20, 30, 30)",
    "INCLUDE",
]
FUSED = {0, 1, 2, 4, 5}


@pytest.fixture(scope="module")
def stores():
    rng = np.random.default_rng(23)
    port, ref = InMemoryDataStore(device="cpu"), JaxStore()
    for tn, n in (("pts", N), ("other", N // 3)):
        x = rng.uniform(-180, 180, n)
        y = rng.uniform(-90, 90, n)
        x[:50], y[25:75] = 0.0, 0.0
        ms = T0 + rng.integers(0, 100 * MS_DAY, n)
        names = np.array(["a", "b"], dtype=object)[rng.integers(0, 2, n)]
        for s in (port, ref):
            s.create_schema(tn, SPEC)
            s.write_dict(tn, [f"{tn}{i}" for i in range(n)],
                         {"name": names, "dtg": ms, "geom": (x, y)})
    for s in (port, ref):
        s.create_schema("empty", SPEC)
    return port, ref


def _check(port, ref, qs):
    got = port.query_batched([Query(tn, f) for tn, f in qs])
    want = ref.query_batched([JQuery(tn, f) for tn, f in qs])
    assert len(got) == len(want) == len(qs)
    for (tn, f), g, w in zip(qs, got, want):
        assert list(g.ids) == list(w.ids), (tn, f)
        scalar = port.query(f, tn)
        assert list(g.ids) == list(scalar.ids), (tn, f)
        assert np.array_equal(g.rows, scalar.rows)
    return got


def test_store_batched_matches_reference_and_scalar(stores):
    port, ref = stores
    got = _check(port, ref, [("pts", f) for f in STORE_QUERIES])
    for i, r in enumerate(got):
        assert ("Fused device scan" in r.explain.text) == (i in FUSED), i
    assert "query 5 of 5," in got[5].explain.text


def test_store_batched_two_types_and_empty(stores):
    port, ref = stores
    qs = [("pts", STORE_QUERIES[0]), ("other", STORE_QUERIES[1]),
          ("empty", STORE_QUERIES[1]), ("pts", STORE_QUERIES[4]),
          ("other", STORE_QUERIES[2]), ("pts", STORE_QUERIES[3]),
          ("empty", STORE_QUERIES[0])]
    got = _check(port, ref, qs)
    fused = ["Fused device scan" in r.explain.text for r in got]
    assert fused == [True, True, False, True, True, False, False]
    assert got[2].n == got[6].n == 0


def test_store_batched_single_and_lone_fusible(stores):
    """A one-element list passes through to query(); a type with one
    fusible query among scalar ones runs no fused scan."""
    port, ref = stores
    for qs in ([("pts", STORE_QUERIES[0])],
               [("pts", STORE_QUERIES[1]), ("pts", STORE_QUERIES[3])]):
        got = _check(port, ref, qs)
        assert not any("Fused" in r.explain.text for r in got)
    assert port.query_batched([]) == []


def test_store_batched_max_features(stores):
    port, ref = stores
    qs = [Query("pts", STORE_QUERIES[1], max_features=5),
          Query("pts", STORE_QUERIES[2])]
    got = port.query_batched(qs)
    want = ref.query_batched([JQuery("pts", STORE_QUERIES[1], max_features=5),
                              JQuery("pts", STORE_QUERIES[2])])
    assert got[0].n == 5 and "Fused" in got[0].explain.text
    for g, w in zip(got, want):
        assert list(g.ids) == list(w.ids)


def test_store_batched_out_of_slice_raises(stores):
    """A query the store refuses (a hint it does not know) raises
    through query_batched too."""
    port, _ = stores
    with pytest.raises(NotImplementedError):
        port.query_batched([Query("pts", STORE_QUERIES[0]),
                            Query("pts", STORE_QUERIES[0],
                                  hints={"NOT_A_HINT": 1000})])
