#!/usr/bin/env python
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--rows 100000000] [--store-rows 10000000]

Phases, one JSON line each; any failure exits non-zero:

1. build   the CUDA kernels from geomesa_tpu_torch/csrc/scan.cu,
           csrc/batch.cu, csrc/geom.cu, csrc/residual.cu, csrc/density.cu,
           csrc/extent.cu, csrc/join.cu, csrc/tube.cu and csrc/standing.cu
           (one nvcc per source, started together, then one link;
           sm_90a), with the
           card's name and power limit; then the native host library
           from geomesa_tpu_torch/native/src (one g++), its seconds and
           path.
2. kernels each hand kernel against its plain PyTorch version on the
           same device tensors: 100M rows from --seed, in a capacity
           of 2^27 (so rows n..cap are capacity padding), the four
           reference queries, and a gathered case of 1M random int32
           row ids, in their random order and sorted, and 1M random
           ids within the first 2^20 rows (a 32 MB slice of the table that the L2 cache holds).
           Tolerance: exact (torch.equal / ==). Median kernel and plain
           times (CUDA events, the card held busy while each launch is
           enqueued), and the bound: useful bytes / 3.35 TB/s. The
           gathered kernel is timed with the L2 cache flushed before
           each launch (its 1M rows would otherwise stay in the 50 MB
           L2 between launches), beside its warm time and the sector
           floor (32 B per random row). The batched kernels at the
           same 100M rows with a batch of 32 queries (the four reference
           queries, then seeded ones: boxes 1-40 degrees wide, a quarter
           time-free, an eighth with two boxes), each query over its own
           slots: bitmaps, partials, the prefix kernel's offsets and
           totals, and compacted ids held exactly against the plain
           versions; the compaction timed through its wrapper and alone,
           the prefix kernel beside one torch.cumsum of the partials.
           Then, the points freed, the extent tristate on --rows boxes
           (centres uniform over the world, sides log-uniform from 1e-5
           to 1 degree, 1 % null, the same times) over the four
           reference queries and one whose f64 edges have no exact f32,
           held to its plain version with torch.equal, timed beside its
           bound (the bytes these rows need: 2 B a row, 16 B a valid
           row, 8 B of times a row the box test kept) and the 26 (18) B
           a row of reading every row (bound_all_rows_ms). The tube
           kernel on the same 100M rows against two tubes: 720 pairs
           (hourly bins of a 30-day track, boxes 0.1-0.5 degrees wide)
           and 1,000 pairs (overlapping intervals of 1-5 days anywhere
           in the rows' dates, boxes 20-90 degrees wide, so nearly
           every row is a candidate and millions match), each held
           to its plain version with torch.equal, timed beside its
           bound (the bytes these rows need: 8 B of times a row, 16 B
           of coordinates a row some interval holds, 1 B written; or the
           operations of the time tests and of the box tests of the
           pairs whose interval holds a row), its sector floor (32 B
           for each sector of each coordinate column that holds such a
           row, sector_floor_ms) and the operations of testing every
           (row, pair) (bound_all_pairs_ms), and its plain time.
3. store   the main path: InMemoryDataStore() on CUDA, 10M rows written
           in chunks through write_dict (in-place appends and one
           capacity rebuild), the BBOX+time north-star query and two
           more through the gathered and the dense tiers, ids and
           query_count checked against a float64 numpy brute force;
           the scan layer's count entry point on the store's columns.
           Launch counts are zeroed before this phase and read after;
           each kernel must have launched. Then, outside the counted
           run, the gathered kernel at the main path's own shape: the
           north-star query's candidate ids from the store's z-index.
           Then on the same store (store_native): the native host paths
           on its columns (the DAY/WEEK binning, z3 and z2 encode, the
           fused binned z3 encode, sort_bin_z, sort_z, gather_xyz, and
           zranges for the three store queries), each held bit for bit
           to its numpy plain twin, with the host-clock seconds of both,
           and a new index's z3 and z2 sort orders and first z3 query;
           (store_versions) reindex to index version 1 (the legacy
           curve) and back to 2, each timed, the three store queries
           after each id-exact against the float64 brute force with the
           z3 plan on the gathered tier; (store_tube) tube_select_process
           along two vessels' AIS-like tracks (1,440 fixes, one every 30
           minutes over 30 days at about 12 knots, hourly bins, a 0.1
           degree buffer; the second silent for 48 hours, which the gap
           fill bridges), ids equal to a numpy brute force of the
           kernel's two-float and (day, ms) compares, the rows where a
           float64 brute force differs counted (information), p50 of 3;
           launch counts zeroed before the calls and read after:
           tube_mask must have launched; then one call of each track
           split into TubeBuilder, tables, kernel and ids (host clock).
           (durable) bench.py's config 7 on the card at --store-rows:
           the ais schema written in 100 chunks non-durable, then into
           a durable store (InMemoryDataStore(durable_dir=...)) under
           the "always" fsync policy, with rows/s, the overhead against
           the non-durable run, WAL MB, fsyncs and the seconds of the
           Arrow IPC encode and of the fsyncs; a cold full recovery of
           that log, a checkpoint (s, bytes), a reopen bounded by it;
           8 chunks of 10k new ids, 2 chunks of 1k existing ids moved
           (delete, then write) and 2 deletes of 1k ids, then an abort
           with a torn partial frame after the last record and a
           reopen. Each reopen is split into its snapshot load, tail
           replay and first query (host clock). After every reopen, and
           before the crash, the three store queries through the
           gathered and the dense tiers must equal a float64 brute
           force over the expected rows (ids, rows, query_count; the
           count equal to the rows), and each reopen's answers those
           before the crash; the scan kernels must launch (launch
           counts zeroed before the phase, read after). Then the
           "interval" and "never" ingests, at config 7's own 1M rows
           once the phase would pass 120 s (``cut``). Each durable
           store writes into a temporary directory of its own, removed
           when the phase ends.
           (fs) BASELINE.md configuration 5's storage: bench.py config
           16's AIS rows (5,000 vessel names, mmsi by vessel, speed,
           course, heading; the store's 100 days; uniform points) at
           --store-rows in a FileSystemDataStore on the card under a
           temporary root, daily partitions: written in 10 chunks
           (about 1,000 files; fewer chunks, ``cut``, once the writes
           would pass their share of the two phases' 120 s), compacted
           to a file a partition (write rows/s, files, bytes a row on
           disk); a 7-day BBOX+time query cold and warm (its explain
           line: partitions scanned, pushdown used), projected to one
           attribute, and with an attribute predicate; 12 one-day
           loads, 4 past the type's cache of 8 (memory_allocated after
           each: an evicted load frees its device memory);
           load_resident split into the Parquet read, the decode and
           the store writes; the north-star query (gathered tier; the
           first writes a sidecar) and a wide one (dense); count,
           bin_query, arrow_ipc; three reopens with the sidecar (no
           z-key sort, counted) alternated with three without, the load
           and the first query timed apart (medians); a delete
           of 1,000 ids and the queries after it; reindex to version 1
           and back. Every answer's ids and count equal a float64 brute
           force over the rows that remain; scan_mask and
           scan_mask_gather must launch (counts zeroed before the
           phase, read after, added to the kernels line).
           (convert) bench.py config 16 part A's converter at 1M rows:
           its CSV through the scalar path (chunks of 4,096) and the
           vectorized one (65,536), rows/s and their ratio, equal
           batches (ids, every column, validity) and counters (the
           scalar leg on the first rows its budget allows, ``cut``);
           then the batches into a file store and a durable in-memory
           store on the card, a BBOX+time query on each equal to the
           brute force over the CSV's values.
           (geofence) bench.py config 15 at its own shapes, nothing
           cut (a fleet or port operator's geofences on a live feed):
           (A) a LiveDataStore with a ContinuousQueryPublisher and
           10,000 filters (bench.py's mix: 0.5-2.5 degree half-width
           boxes, a tenth with a DURING, a tenth with a speed BETWEEN, a
           tenth with a LIKE), a warm write, then 4 batches of 8,192
           rows; on 64 probed topics the published ids equal evaluate
           per filter over each batch; device rows/s beside the host
           loop's (the same publisher with the type held on the host)
           and their ratio. (B) a StandingFilterSet with 100,000 filters
           and one 1M-row dispatch, id-exact against evaluate on a
           2,048-filter stride; register/s, the dispatch split (row
           prep, uploads, matching with its steps: the slot grid's
           build, the count passes, the prefix, the write passes, the
           sort; host patch), padded_cap and the residual fraction. (C)
           256 unregisters and registers within the cap and another
           1M-row dispatch: no new shape class, the device tables'
           storage unchanged, the replaced filters id-exact. The five
           standing kernels (grid, count, offsets, write, sort) held to
           their plain version on (B)'s first two chunks pair for pair
           (a hard gate), each timed (held medians: the count and write
           passes on a chunk, the grid, prefix and sort once a
           dispatch) beside its plain version and its bound (the bytes
           of the rows, the grid lists they read and the pairs written,
           or the operations of the candidate pairs at 33.5 T/s), the
           all-pairs kernel's bound (0.0489 ms a chunk) as the old
           yardstick; the grid's entries, everywhere slots, build time
           and the candidate pairs tested per row. Launch counts zeroed
           before the phase and read after (the comparison's launches
           left out): every standing kernel must have launched, and
           no bitmap kernel or compaction.
           (stream) the streaming tiers at a live AIS picture's size:
           262,144 vessel ids, 32 messages of 8,192 creates, then 32 of
           upserts of the same ids (cut once past their share of the
           budget left: ``cut``), into a LiveDataStore whose
           ContinuousQueryPublisher matches 8 standing queries and
           publishes to a SocketBroker(root=...) on 127.0.0.1, one
           subscriber thread a query; the broker stops and restarts on
           its port and root after the creates. Every matching
           (message, id) must arrive exactly once, equal to evaluate
           over what was sent; the live store's north-star query
           (gathered and dense) and query_count equal a float64 brute
           force over each id's latest version; expire drops the first
           half by arrival time. A LambdaDataStore over a
           FileSystemDataStore: persist moves half, 1,000 persisted ids
           written again, the union query equal to the brute force with
           the transient rows winning. A StreamDataStore on a
           FileTailSource grown over 10 ticks with bench.py config 16's
           CSV, its query equal to the brute force. Ingest rows/s
           (creates, upserts), the upsert's id conversion, the CQ
           publish-to-receive p50, the resume seconds, persist seconds,
           the union query's p50. Then, before the broker stops, 32
           creates of 4 rows published through
           ChaosProxy(reset_rate=1.0, seed=5) to the broker: resets
           counted, the log holding each message once and in order, a
           LiveDataStore on the card consuming it equal to the brute
           force (``chaos``). The two phases have 150 s together
           (STREAM_BUDGET_S). Launch counts zeroed before the phase and
           read after: the scan kernels and the standing kernels must
           launch.
4. batched the serving path on the store phase's 10M rows: 32 seeded
           queries in the store's dates through query_batched at batch
           sizes 2, 8 and 32, every query's ids equal to the float64
           brute force and to scalar query(), with the fused path shown
           by the explain text; p50 of one batched call beside the same
           queries as sequential query() calls. Then QueryBatcher(ds)
           with 32 threads each submitting 8 queries: all exact, with
           queries/s, the coalesce ratio and the batch count. Launch
           counts are zeroed before this phase and read after; the
           three batched kernels must have launched. Every stacked batch
           that the path ran (batch sizes and the batcher's) is recorded
           and, outside the counted run, the batched kernels are held
           exactly against their plain versions on it over the store's
           columns, and every compact_prefix launch of the path (its
           partials and the offsets and totals it returned) is held to
           the plain prefix with torch.equal. Then where one call of 32
           queries spends its time: the device path alone, the gather of
           the result ids, and a cProfile of the call (host clock); and
           the batched kernels timed at this phase's own shape beside
           their bounds (``kernels_32``).
           (serving) the serving planes over the same store and queries:
           trace sampling 1, QoS on with three tenants weighted 4:2:1,
           an AuditLogger writing JSONL under a temporary directory, the
           continuous profiler at 19 Hz, runtime and SLO at their
           defaults (on). 32 threads x 8 queries through
           shared_batcher(ds), each thread under its own tenant_scope
           and principal_scope. Hard gates: every query's ids equal the
           float64 brute force; one audit record per query (its
           tenant's principal, index, hits equal to its ids' count,
           batched true on fused ones; as many JSONL lines); every
           caller's trace holds its dispatch subtree; the per-tenant
           drained counts sum to 256; runtime.compile{domain=batcher}
           has one miss per shape class and hits after it; the runtime
           device sample non-zero and within 1 % of
           torch.cuda.memory_allocated() at the same point;
           prometheus_text() holds the store.scan, batcher and runtime
           series; TIMEOUT 1e-9 s raises QueryTimeout and 60 s answers
           the brute force. Launch counts zeroed before the load and
           read after; the three batched kernels must launch, and are
           held to their plain versions on every batch the load ran.
           Then the same load with the planes at their defaults and
           with all of them on, alternated, three runs each (queries/s,
           per-query p50), the north-star query() p50 at defaults, and
           the card's name and power limit. At the script's end the
           runtime snapshot's batcher, knn, standing and join domains
           with their probe and dispatch counts (``runtime``).
5. analytics  BASELINE.md's joins at their shapes, on the store phase's
           10M rows before they are freed: a DWithin of 1,000 query
           points (r = 0.25) through proximity_process (counts, ids) and
           dwithin_join on the store's resident columns (counts, pairs),
           held to a float64 brute force (a host argsort of x, a
           searchsorted slab of +-r, the exact distance); KNN, k = 100,
           of bench.py's 8 points over 50M points in a 2^26-row f32
           buffer through knn_batched (an argpartition + (d2, id) lexsort
           oracle per point), and on the store through knn_process (the
           z-ring host tier and the kernel) and QueryBatcher.knn from 32
           threads x 8 points, through the default batcher and one with
           a static 200 ms linger (each answer against a float64 stable
           sort on the card), with each batcher's queries/s and coalesce
           ratio; every dispatch of more than one query must launch
           knn_topk (counted from that batcher's run alone), and the
           static batcher must make at least one such dispatch; a
           Contains of 100M points (2^27 rows) against bench.py's 10,000
           config-5 rectangles and 32 star polygons with holes
           (contains_join counts; the counts of 256 sampled polygons,
           every star among them, against a float64 brute force, and
           the pairs path on 100 of them). Launch counts are zeroed
           before the store's calls and the Contains calls and read after
           each; every join kernel must have launched. Every recorded
           call of a join kernel is held to its plain version
           (torch.equal), and each kernel is timed alone at its main
           call's shape (1,000 queries x 10M rows; their slabs; 8
           queries x 50M rows; 10,032 polygons x 100M rows, the counts
           pass, and the rows pass apart) beside its plain version once
           and its bound, the larger of bytes (inputs read once, the
           slabs' union) and f32 operations (33.5 T instructions/s: 7 a
           slab column for the dwithin kernel, with the all-pairs count
           beside it as all_pairs_bound_ms); the dwithin and contains
           kernels with the host-clock time of their tile lists
           (lists_ms), the dwithin and slab wrappers held (wrapper_ms),
           the dwithin kernel at a wide radius (30 degrees, 64 seeded
           points on the store) held to its plain version and timed;
           the slab kernels' two passes also in box mode at the
           Contains pairs call's shape; the knn kernel also at the
           batcher's largest shape (the store's 10M rows x 32 of its
           points, kpad 256), each knn line with its plan and, as
           library_ms, one torch.topk(d2, kpad, largest=False) over a
           precomputed (queries, rows) d2 (selection only); the
           x-sort of the store's and the 100M table's columns on a line
           of its own (analytics_xsort); each call's p50 of 3 host-clock
           runs.
5b. sql_ais  BASELINE #3 through SQL on the store phase's 10M rows
           (before they are freed): the analytics phase's 1,000 query
           points as a second type, SELECT count(*) ... JOIN ... ON
           ST_DWithin(a.geom, b.geom, 0.25) equal to that phase's f64
           brute force, its first-call time and p50 of 5 beside the
           p50 of 5 of the direct dwithin_join(counts_only=True) on the
           resident columns; the join must receive the store's resident
           columns; the grouped form (GROUP BY b.__fid__) equal to the
           brute force per point; a cProfile of one COUNT(*) statement.
5c. web    the REST surface on the same store: (a) a GeoMesaWebServer
           over it and the port's RemoteDataStore on localhost; the
           north-star query and the 32 batch queries through /rest/query
           (Arrow), and the three store queries and their counts with
           the gathered and the dense tiers forced, ids equal to the
           f64 brute force; the north star as format=json (timed) and
           through /rest/count; a 256 x 256 /rest/density tile equal to
           a direct density() and its repeat with If-None-Match a 304;
           /rest/bin bytes and /rest/stats MinMax(dtg) equal to direct
           calls; /rest/knn k=100 equal to knn_process; BASELINE #3's
           COUNT(*) DWithin join through /rest/sql equal to SqlEngine
           and to the analytics phase's brute force; 1,000 rows written
           through /rest/write (the ingest pipeline) and 100 deleted,
           read back by box and by id. The request threads' CUDA device
           is the store's. Gates: every answer equal, no server error
           (resilience.web.errors) and no client retry on these legs,
           and each of WEB_KERNELS launched by the requests (launch
           counts zeroed before them and read after; the oracles' direct
           calls come after). Reported: the north star's p50 of 20
           through the client beside direct query(); /rest/query p50 and
           queries/s with 1 and 32 client threads; the 32-thread load's
           fused dispatches. (b) bench.py config 8 at its shapes: 200k
           points, 300 BBOX queries direct and through a ChaosProxy with
           1 % resets and 10 ms jitter (gates: no client error, ids equal
           between the runs and to the brute force), and the breaker's
           fast-fail against a black-holed endpoint beside the client's
           0.3 s timeout; config 8's broker restart runs in the stream
           phase. (c) bench.py config 13 at its shapes: 200k rows, 16
           web and 16 embedded callers in one fused dispatch, id-exact;
           hedged against unhedged p50/p95/p99 of 150 queries through a
           straggler proxy (10 % of connections stall 0.25 s), with the
           hedge counters and the budget invariant (gates); the
           latency-derived batch cap with and without
           geomesa.batch.latency.budget.ms (gates). One JSON line a
           part, then the phase's seconds beside WEB_BUDGET_S.
5d. cluster the replicated and sharded tiers on the card, on the store
           phase's rows before they are freed; launch counts zeroed
           before each part and read after, device memory before and
           after each part (its stores closed; at most
           CLUSTER_MEM_SLACK more). (a) ``cluster11``, bench.py config
           11: the store's 10M rows written through
           ClusterDataStore.write into 4 groups; config 11's 400
           5-degree boxes (seed 110) as query_count, each equal to the
           store's, queries/s, p50, p95, p99 and the legs contacted
           after pruning beside the store's own; the three store
           queries id-exact against the f64 brute force on the gathered
           and the dense tiers (gate: scan_mask and scan_mask_gather
           launched on the groups); 1 and 2 groups at the same rows
           while CLUSTER_FULL_SHARE of CLUSTER_BUDGET_S holds, else at
           config 11's 200k (``cut``); at 200k rows, a replicated group 0
           (its primary durable, behind a web server and a ChaosProxy)
           killed under ingest and a query stream (gates: promoted by
           itself, no acked write lost, every query exact or typed),
           then one group down (gates: typed without
           geomesa.cluster.allow.partial, flagged with its missing
           z-ranges with it). (b) ``repl9``, bench.py config 9 at 1M
           rows: a durable primary (wal_fsync="never", 100 writes, a
           checkpoint after 50), 4 replicas bootstrapping from it and
           streaming the rest; 400 box counts at 1, 2 and 4 replicas,
           each equal to the primary's (queries/s, p50, p95, p99, the
           staleness hit rate); a half-world count on each replica
           (gate: scan_mask launched on each); config 9's failover
           through RemoteDataStore and ChaosProxy (gates: promoted, no
           acked write lost). (c) ``reshard21``, bench.py config 21:
           240k rows then 480k in one corner, 32 threads x 6 queries
           before, under and after; the autoscaler on the real leg
           latencies, else on config 21's synthetic_hot_signal (marked
           ``signal``); gates: it fired (``reason`` auto), id-exact
           against one store across the flip; the heal ratio and the
           flip's snapshot, copy, delete and swap times. (d) ``sql19``
           runs in 7b. The phase's total line, with its seconds beside
           CLUSTER_BUDGET_S, follows sql19.
5e. lifecycle online schema evolution, views, the crash harness and the
           batch jobs on the card, after ``cluster`` on the store phase's
           rows; launch counts zeroed before each part and read after,
           device memory before and after each part (its stores closed;
           at most LIFECYCLE_MEM_SLACK more). (a) ``evolve24``, bench.py
           config 24: 1M rows in a durable store (wal_fsync "never"), 16
           writer and 16 reader threads, the evolver reindexing the
           type from version 2 to 1 in the middle (gates: 0 reader
           mismatches, 0 untyped errors, 0 acked writes lost, one flip,
           the longest write stall at most 10 s, the shadow's columns
           on the card); the snapshot, catch-up, index-build and flip
           times, the cut's ms, typed refusals, schema refreshes,
           rounds, memory before, after the snapshot, after the
           shadow's index and after the flip (gate: the losing copy's
           memory returned); the first query after the flip (rebuilt or
           merged); the north star's box id-exact against a float64
           brute force with a scan kernel launched; a crash at a random
           kill point and resume() (gate: completes once); an abort
           with the shadow built (gate: its memory returned); the kill
           switch off beside a twin store (gates). (b) ``evolve10m``:
           an online update_schema adding an Integer attribute with a
           default to the store phase's 10M-row type under 8 north-star
           readers (gates: every read exact or typed, the default on
           every row, the north star id-exact on the shadow's device
           columns, the old copy's memory returned); it changes the
           store's schema, so it is the store's last use. (c)
           ``views23``, bench.py config 23: 1M rows, a 32-group view,
           20 commits of 1,000 rows timed with a read beside the p50 of
           3 full re-executions (the speedup is reported, not gated),
           a 500-id delete wave with its pre-image timed (gate: the
           view equals SqlEngine's re-execution), the kill switch off
           beside a twin (gates). (d) ``harness``: run_crash_workload's
           harness on a durable card store, 3 rounds of 20 writes
           (gate: no violation), faults by kind. (e) ``jobs``:
           SchemaCopyJob from a file store on the card (ids equal),
           AttributeIndexJob (the next attribute query plans attr: and
           is exact), ConverterIngestJob over 4 files of config 16's
           CSV (rows equal to one scalar converter run). Then the
           phase's seconds beside LIFECYCLE_BUDGET_S.
5f. mesh   parallel/, DistributedDataStore and
           FsBackedDistributedDataStore on the card, after ``lifecycle``
           and before the store phase's store is freed; launch counts
           zeroed before each part's main path and read after it,
           device memory before and after each part. (A) ``parallel``:
           --rows uniform points (the kernels phase's seed) sharded over
           data_mesh(8), eight shards on the one card (24 B a row), and
           the same rows as one shard: the north star's hit rows and
           count, the batched trio over the kernels phase's 32 queries,
           two density grids, config 5's 10,000 rectangles' contains
           counts, KNN at k = 10 for four points, the ring's DWithin counts at 1M x 1M (radius 0.25),
           and the tristate on the kernels phase's extent boxes. Gates:
           rows, counts and KNN ids in order equal a float64 brute force
           on the card; the density grids equal a brute force of the
           raw two-float verdict (the scan's plain version, bincount);
           256 sampled contains counts equal the f64 closed-box count,
           and 8 shards equal 1; the ring's (sure, band) arrays equal
           on 8 shards and 1, and 2,000 sampled left rows' f64 totals
           lie in [sure, sure + band] (equal to sure without band); the
           tristate equals its plain version on every shard. p50s of 3
           host-clock runs on 8 shards and on 1; then each program's
           kernel launched on the eight shards in one timed loop beside
           its one launch at the same rows (held medians), and the
           shard-shaped calls of every kernel of MESH_KERNELS against
           their plain versions (exact; not counted). (B) ``store``:
           DistributedDataStore(data_mesh(8)) and a one-shard twin
           written with the store phase's 10M rows; the north star and
           a wide box (default tiers and the dense tier forced), their
           query_count, a world density grid of the north star (held as
           in A), KNN at four points (f64 brute force, ids in order),
           a dtg histogram (a float32 numpy brute force), arrow_ipc of
           the north star (ids, times and points equal), query_batched
           of the batched phase's 32 queries (equal to the single
           store's); every query id-exact against the single store and
           the brute force, p50s beside the single store's (whose calls
           are left out of the part's launch counts). (C) ``fs``:
           FsBackedDistributedDataStore on 8 shards at 1M of those rows:
           write, the north star, persist_index, reopen (gates: the
           index_mesh sidecar adopted, no z-key sort, ids identical).
           Gate: every kernel of MESH_KERNELS launched on the mesh's
           shards. Then the phase's seconds beside MESH_BUDGET_S.
6. predicates  exact polygon and attribute predicates: the earlier
           stores freed, a store of --store-rows rows shaped like a GDELT
           1.0 event record (EventCode:String:index=true with 320
           CAMEO-like codes, Zipf-skewed; Actor1CountryCode:String, 250
           codes, 15 % null; NumMentions:Integer, heavy-tailed, 0.1 %
           null; AvgTone:Double in -10..10, a fifth rounded to 0.1 and
           0.2 % on f64 neighbours of one threshold; IsRootEvent:Boolean;
           dtg; geom) written through write() with the string columns
           built from their vocabularies and int32 codes; the residual's
           device columns uploaded and timed apart; then eight queries
           (PRED_QUERIES: a 300-vertex polygon with a hole AND DURING and
           a two-part multipolygon through the point-in-polygon kernel,
           attribute-only filters through the residual kernel as the
           fullscan secondary, the dense secondary with f64 band rows and
           a wide attribute-index range, an attribute-index equality, a
           fid IN of 1,000 ids, a DISJOINT), each query's ids and
           query_count equal to a float64 numpy brute force. Launch
           counts are zeroed before the queries and read after; both
           kernels must have launched. Outside the counted run, every
           call the path made to either kernel is held exactly against
           its plain version (torch.equal), both kernels are timed at the
           path's own shapes beside their bounds, and each query's p50
           (host clock, 3 runs) is printed with its strategy. pip_mask's
           bound counts the pairs its skip leaves (counted on the device:
           within each edge's expanded y range, inside its whole box),
           beside the earlier all-pairs count (bound_all_pairs_ms); the
           residual kernel is timed alone (a launch prepared once) and
           through its wrapper, held (wrapper_ms) and on an idle card,
           so that the host's work counts: warm (wrapper_bare_ms, the
           prepared launch found) and cold (wrapper_cold_ms, prepared
           anew each call, as on a new filter or after a flush), beside
           the prepared launch on an idle card (kernel_bare_ms).
7. stats   stats and Arrow on the predicates phase's store, before the
           surface phase frees it (host code; the filtered queries run
           the store's scans, so launch counts are zeroed before it, read
           after, and scan_mask must have launched): the write-side
           stats observation of the store's batch timed alone, analyze()
           (its z3 histogram equal to the one the write built), then
           STATS_SPECS (Count, MinMax(dtg), Histogram(NumMentions),
           Enumeration and TopK of EventCode, DescriptiveStats(AvgTone),
           GroupBy(IsRootEvent, Count()), Z3Histogram) through
           stats_query over INCLUDE, the surface phase's tile filter and
           its 73-day world filter, each the p50 of up to STATS_RUNS
           host-clock runs (one once a call takes STATS_RUN_BUDGET_MS),
           each held to a numpy brute force over the same rows (exact;
           the moments within 1e-9 of max(|x|, 1); the Z3 total equal to
           the rows); each predicate query's plan cost and
           estimate_count beside its hits; query_stream of the world
           filter (windows, ids equal to the query's); arrow_ipc of the
           tile (read back through FeatureArrowFileReader, value for
           value) and of the world filter (its ids read back through
           pyarrow), after one untimed call. The store's result cache
           is off for the timing thread in these loops (they time the
           compute, as before the cache); each line has the time of a
           cache hit beside it (hit_ms; an Arrow payload over the
           cache's byte budget is not kept: null).
7b. sql_gdelt  bench.py config 19's statements on the predicates
           phase's store (its GDELT columns in place of config 19's):
           GROUP BY Actor1CountryCode with COUNT, SUM(NumMentions),
           MIN/MAX/AVG(AvgTone) under a BBOX+time WHERE of about 29 % of
           the rows (the gathered kernel), ORDER BY cnt DESC LIMIT 5 and
           ST_Extent per key over the whole table, the COUNT(*) and
           grouped ST_Contains joins against config 19's 16 zone boxes,
           a ST_GeoHash(geom, 25) projection with a LIMIT (against the
           textbook bisection) and one knn_spiral_process, each against
           numpy or the f64 brute force over the same columns (exact;
           an AVG within recursive summation's bound of the fsum mean);
           then ``sql19`` (the cluster phase's part, 5d): config 19's
           statements through a SqlEngine over a 4-group
           ClusterDataStore holding 2M of the rows (the plan says
           distributed, rows equal to one store's engine over the same
           rows), the pull path beside three of them, the leg kill;
           cProfiles of the slowest statements.
           Launch counts are zeroed before each of the two sql phases
           and read after; the `sql` line has their seconds (budget
           60 s).
8. surface the query surface and the pushdowns on the predicates
           phase's store, before it is freed. Launch counts are zeroed,
           then density() draws four grids (a 256x256 tile over a BBOX
           and 30 days; the world at 2048x1024 over 73 days weighted by
           NumMentions, and by AvgTone; the world at 256x256 unweighted,
           the zoom-0 WMS tile), each from the query's row ids into the
           store's device columns, each held to a float32 numpy brute
           force that casts as the reference does and sums with
           np.add.at: exact where the weights are unit or integers with
           a cell total under 2^24, else each cell within 2 * n_cell *
           2^-24 * sum |w|; bin_query on the tile, plain and time-sorted,
           labelled by EventCode, record for record; a sort by
           NumMentions descending with max_features, a projection,
           SAMPLING 0.1 with and without SAMPLE_BY EventCode, id-exact;
           and a store of 1M rows with four distinct visibility labels at
           feature and at attribute level, id-exact per auth set (the
           leak guard's case included); then the density kernel's count
           is read: it must have launched. Outside the counted run,
           every recorded launch's own grid is held to its plain version
           on the card (unit weights equal, integer weights exact under
           2^24 a cell, others within the bound), the kernel is timed at
           the weighted world call's shape beside its byte bound (the
           id, the point, the weight and validity bytes a row, 8 B a
           cell), its plain version, one index_add_ over the same cells
           and the array loader on the same rows gathered; and with
           every row in one cell (a 1x1 grid), at the zoom-0 tile and at
           the tile, each with the path it took; one density() call is
           split into the query, the ids' upload, the kernel and the copy
           back, beside the device columns' first upload. The p50s of
           repeated density() and bin_query() calls are timed with the
           result cache off for the timing thread, each beside a cache
           hit's time (hit_ms). Then 1,000 ids
           are deleted (delete and rebuild timed) and a z3, a polygon and
           an attribute query are held to the brute force over the kept
           rows, and analyze() must count n - 1,000 rows (the stats stay
           at n until then); then remove_schema, with
           torch.cuda.memory_allocated falling.
9. geometry_less  the predicates phase's attribute columns as a
           schema without a geometry (an event table keyed by its
           attributes), written through write(): an attr: equality, a
           fid IN of 100 ids and a fullscan whose residual runs
           residual_mask, each id-exact against a numpy brute force,
           with its strategy and p50 of 3; launch counts zeroed before
           the queries and read after: residual_mask must have launched.
10. extent an extent (XZ) store shaped like a city's footprint and
           street layers (NYC Open Data's building footprints, about
           1.08M polygons, and street centerlines, about 120k segments):
           the earlier stores freed, 1M rotated rectangles 8-60 m a side
           and 200k LineStrings of 2-10 vertices, 30-400 m long, in
           (-74.26, 40.49, -73.70, 40.92) with dtg over 365 days,
           written as Geometry objects in chunks of 100k (cut, at 500k
           at the least, once the writes project the phase past 90 s:
           ``reduced``);
           then eight queries (a neighbourhood BBOX and 30 days, the
           tristate: the XZ curve's cells are coarser than the box; the
           same BBOX and 7 days, the XZ-pruned host scan; a borough BBOX
           and 90 days and 30 days alone, the tristate; an INTERSECTS of
           a 100-vertex polygon and 30 days; a DWITHIN of 500 m; a
           CROSSES of a line across the region; a TOUCHES of a
           parallelogram on a footprint's corner), the first six id for
           id against a float64 numpy brute force
           (orientation tests, crossing numbers both ways, clamped
           point-segment distances), CROSSES and TOUCHES against the
           port's host evaluate over the whole batch, query_count equal;
           launch counts zeroed before them and read after (the
           tristate must have launched); each query's strategy, explain
           lines, p50 of 3 host-clock runs and the tristate's OUT, MAYBE
           and IN counts; then every tristate call of the path held to
           its plain version with torch.equal and timed at its shape.
11. cache  bench.py config 12 (A-E) on the card: a store ``tiles12``
           (dtg:Date,*geom:Point) of --store-rows uniform world points
           (the reference's 100M cut: ``reduced``); density() of 32
           tiles of 256 x 256 on a 45-degree grid, 4 hot ones asked 80 %
           of the time, 32 threads x 12 requests a phase (cut only if
           phases A and D would pass 60 s: ``cut``): (A) the cache off,
           (B) cached warm, (C) 32 identical cold requests, (D) cached
           under a write stream (100 rows every 20 ms) with a
           CacheRefresher(interval_s=0.05, top_k=4), (E) six tiles'
           cached grids (hits) byte-equal to a fresh recompute at the
           same version, tile 0 to the float32 brute force over every
           row. p50, p95, p99, hot-tile p99, queries/s and the hit rate
           a phase, the hot-tile p99 speedup. Gates: (C) one cache miss
           and one density_grid launch; (E) exact; the refresher ran,
           with no errors and no crashes. Launch counts zeroed after
           the write and read after (E). Then (F), config 12's
           replicated bounded-staleness probe: a durable primary, one
           replica, a router with a lag bound of 50, density reads
           under 150 one-row writes (gates: no staleness violation and
           density_grid launched).
12. ingest bench.py config 16 whole (A-C) at its own 1M rows into
           durable stores on the card: (A) the scalar per-write leg
           (geomesa.ingest.vectorized off for its thread, 4,096 rows a
           write; cut to its first rows past its share of 90 s:
           ``cut``) against the columnar converter staging 65,536 rows
           a batch through IngestPipeline, both under "interval":
           rows/s, writes, staged batches, groups, fsyncs, the speedup
           (beside the reference's 5x); (B) 32 reader threads x 4 BBOX
           queries of 40 x 25 degrees, idle and during a pipeline ingest
           of 200k new rows: p50, p99 and their ratio (beside the
           reference's 10), each reader's counts rising and at
           committed groups' boundaries; (C) under "always", group_rows
           8,192 and 1,024-row batches, the directory copied while the
           writer runs and the copy reopened. Gates: counts equal the
           converter's successes, groups <= staged and fsyncs <= groups
           + 1 in (A), recovered >= acked, a BBOX+time query on each
           (A) store (gathered and dense tiers) equal to the brute
           force over the CSV's values. Launch counts zeroed before (A)
           and read after (C).

Then the kernels summary line, the card line, and the final
{"ok": true, ...} line. Without CUDA it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

MS_DAY = 86_400_000
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
SECTOR_BYTES = 32              # least device-memory traffic of a random row
L2_FLUSH_BYTES = 256 << 20     # written between cold launches (L2: 50 MB)
HOLD_CYCLES = 200_000          # ~0.1 ms of GPU spin ahead of each timed launch
INT32_OPS_PER_S = 67e12        # H100 SXM non-tensor 32-bit rate
T0_DAY, T1_DAY = 17_000, 17_100   # the store's dates: 2016-07-18 .. +100 days

KERNEL_QUERIES = [
    ([(-80.0, 30.0, -60.0, 45.0)], [(20 * MS_DAY, 50 * MS_DAY)]),
    ([(-10.0, -10.0, 10.0, 10.0)], []),
    ([(-80.0, 30.0, -60.0, 45.0), (0.0, 0.0, 30.0, 20.0),
      (100.0, -50.0, 140.0, -10.0)],
     [(0, 10 * MS_DAY), (90 * MS_DAY, 99 * MS_DAY)]),
    ([(-180.0, -90.0, 180.0, 90.0)], [(0, 100 * MS_DAY)]),
]

STORE_QUERIES = [
    ("BBOX(geom, -80, 30, -60, 45) AND "
     "dtg DURING 2016-08-07T00:00:00Z/2016-09-06T00:00:00Z",
     [(-80, 30, -60, 45)], (17_020 * MS_DAY, 17_050 * MS_DAY)),
    ("(BBOX(geom, -10, -10, 10, 10) OR BBOX(geom, 100, -50, 140, -10)) AND "
     "dtg DURING 2016-07-20T00:00:00Z/2016-10-01T00:00:00Z",
     [(-10, -10, 10, 10), (100, -50, 140, -10)],
     (17_002 * MS_DAY, 17_075 * MS_DAY)),
    ("BBOX(geom, -120, 20, -70, 50)", [(-120, 20, -70, 50)], None),
]

SOURCES = {
    "scan_mask": "geomesa_tpu/scan/pallas_scan.py:140 _mask_call",
    "scan_mask_gather": "geomesa_tpu/scan/zscan.py:304 _gather_scan_mask",
    "scan_count": "geomesa_tpu/scan/pallas_scan.py:162 _count_call",
    "scan_batch_bits": "geomesa_tpu/scan/zscan.py:536 _batch_mask_cand "
                       "(+ :558 _batch_count)",
    "compact_prefix": "geomesa_tpu/scan/zscan.py:563 _batch_nonzero "
                      "(its offsets; + :558 _batch_count's totals)",
    "compact_bits": "geomesa_tpu/scan/zscan.py:563 _batch_nonzero",
}
PRED_KERNELS = ("pip_mask", "residual_mask")   # the predicates phase's
SOURCES.update({
    "pip_mask": "geomesa_tpu/scan/gscan.py:239 _pip_kernel",
    "residual_mask": "geomesa_tpu/scan/residual.py:132 device_mask "
                     "(+ :214 _pair_cmp, :313 _vocab_gather)",
})
SURFACE_KERNELS = ("density_grid",)           # the surface phase's
SOURCES["density_grid"] = "geomesa_tpu/scan/aggregations.py:28 _density_kernel"
SOURCE_FILES = {k: "geomesa_tpu_torch/csrc/batch.cu"
                for k in ("scan_batch_bits", "compact_prefix", "compact_bits")}
SOURCES["extent_tristate"] = "geomesa_tpu/scan/gscan.py:153 _tristate_body"
SOURCE_FILES.update({"pip_mask": "geomesa_tpu_torch/csrc/geom.cu",
                     "residual_mask": "geomesa_tpu_torch/csrc/residual.cu",
                     "density_grid": "geomesa_tpu_torch/csrc/density.cu",
                     "extent_tristate": "geomesa_tpu_torch/csrc/extent.cu"})
SOURCES["tube_mask"] = "geomesa_tpu/analytics/tube.py:85 _tube_kernel"
SOURCE_FILES["tube_mask"] = "geomesa_tpu_torch/csrc/tube.cu"
BATCH = 32          # queries per batch in the kernels phase
STORE_BATCH_QUERIES = 32
BATCH_SIZES = (2, 8, 32)
BATCHER_THREADS, BATCHER_PER_THREAD = 32, 8


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2, flush=None,
            held: bool = True, hold: int = HOLD_CYCLES) -> float:
    """Median milliseconds of fn() on the card (CUDA events); ``flush``
    runs before each timed launch, outside the events. Held (the
    default), a spin kernel holds the card ahead of the first event
    while the host enqueues fn(), so the events time the device's work
    and not the host's launch latency (which exceeds a short kernel's
    own time); not held, the card is idle and the events take in the
    host's work between them too."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush()
        if held:
            torch.cuda._sleep(hold)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _ops_per_row(k: int, b: int, time_any: bool) -> int:
    # per box 4 two-float compares of ~3 operations, plus the reductions;
    # per interval 2 (day, ms) compares of ~3 operations
    return 13 * k + (0 if time_any else 7 * b)


def _l2_flush(dev):
    buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    return lambda: buf.fill_(1)


def _err(got, want) -> int:
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max()
               .item()) if got.numel() else 0


def gather_timing(rows, idx, b, t, time_any, flush) -> dict:
    """The gathered kernel on ``idx`` against its plain version: cold
    (L2 flushed) and warm medians of 20 launches, the useful-byte bound
    and the sector floor. Launches here are outside any counted run."""
    from geomesa_tpu_torch.scan import kernels
    m = idx.shape[0]
    col_bytes = 16 if time_any else 24
    table_bytes = b.numel() * 4 + t.numel() * 4
    want = kernels.scan_mask_gather_plain(rows, idx, b, t, time_any)

    def kern():
        return kernels.scan_mask_gather(rows, idx, b, t, time_any)
    out = {"m": m, "max_abs_err": _err(kern(), want),
           "ms": cuda_ms(kern, 20, flush=flush), "warm_ms": cuda_ms(kern, 20)}
    out["plain_ms"] = cuda_ms(
        lambda: kernels.scan_mask_gather_plain(rows, idx, b, t, time_any), 3,
        warmup=1)
    out["bound_ms"], out["bound_by"] = bound_ms(
        (4 + col_bytes + 1) * m + table_bytes,
        _ops_per_row(b.shape[0], t.shape[0], time_any) * m)
    out["sector_floor_ms"] = ((SECTOR_BYTES + 4 + 1) * m
                              / HBM_BYTES_PER_S * 1e3)
    out["hits"] = int(want.sum().item())
    return out


def random_queries(rng, count: int, lo_ms: int, hi_ms: int):
    """``count`` seeded (boxes, interval or None) queries: boxes 1-40
    degrees wide on a 0.001-degree grid, a quarter time-free, an eighth
    with two boxes; intervals of 1-40 days on whole seconds in
    [lo_ms, hi_ms)."""
    out = []
    for i in range(count):
        boxes = []
        for _ in range(2 if i % 8 == 7 else 1):
            w, h = (round(float(v), 3) for v in rng.uniform(1, 40, 2))
            x0 = round(float(rng.uniform(-180, 180 - w)), 3)
            y0 = round(float(rng.uniform(-90, 90 - h)), 3)
            boxes.append((x0, y0, round(x0 + w, 3), round(y0 + h, 3)))
        iv = None
        if i % 4 != 1:
            span = int(rng.integers(1, 41)) * MS_DAY
            lo = int(rng.integers(lo_ms // 1000, (hi_ms - span) // 1000)) * 1000
            iv = (lo, lo + span)
        out.append((boxes, iv))
    return out


def batch_stats(data, bq, plain: bool = True) -> dict:
    """The batched kernels on the batch ``bq`` over ``data``: each
    against its plain version (exact), timed held (medians of 10
    launches; the plain versions of 1 when ``plain``) beside its bound;
    ``compact_bits`` through its wrapper (prefix kernel, the totals'
    copy to the host, compaction kernel) and its kernel alone."""
    from geomesa_tpu_torch.scan import kernels
    b, t = bq.tables(data.device)
    c = bq.counts(data.device)
    n, qp, k, nb_ = data.n, bq.n_queries, b.shape[1], t.shape[1]
    words, nblocks = kernels.batch_shape(data.cap)

    def bits_k():
        return kernels.scan_batch_bits(data.cols, n, b, t, c)

    def bits_p():
        return kernels.scan_batch_bits_plain(data.cols, n, b, t, c)
    bits, parts = bits_k()
    torch.cuda.synchronize()
    want_bits, want_parts = bits_p()
    equal = torch.equal(bits, want_bits) and torch.equal(parts, want_parts)
    del want_bits, want_parts

    def prefix_k():
        return kernels.compact_prefix(parts)

    def prefix_p():
        return kernels.compact_prefix_plain(parts)
    offsets, totals = prefix_k()
    prefix_equal = all(torch.equal(g, w) for g, w in zip((offsets, totals),
                                                         prefix_p()))

    def comp_k():
        return kernels.compact_bits(bits, parts)

    def comp_p():
        return kernels.compact_bits_plain(bits, parts)
    comp_equal = _compact_equal(comp_k(), comp_p())
    counts = totals.cpu().numpy()
    outs = [torch.empty(int(x), dtype=torch.int32, device=data.device)
            for x in counts.sum(axis=1)]
    lib = kernels._library()
    stream = torch.cuda.current_stream(data.device).cuda_stream

    def comp_kernel():   # the compaction kernel alone, outside the counts
        lib.geomesa_compact_bits(
            bits.data_ptr(), parts.data_ptr(), offsets.data_ptr(),
            totals.data_ptr(), qp, nblocks, words, outs[0].data_ptr(),
            outs[1].data_ptr(), stream)
    n_ids = int(counts.sum())
    table_bytes = b.numel() * 4 + t.numel() * 4
    bits_bytes = 24 * n + 2 * qp * words * 4 + 2 * qp * nblocks * 4 + table_bytes
    # per row and query: 13 operations per box of the predicate, 8 of the
    # candidate test, 7 per interval; counted over each query's own boxes
    # and intervals (the padded slots are no work the function needs),
    # and over the padded (Qp, K, B)
    ops = n * sum(21 * q.n_boxes + 7 * len(q.host_intervals)
                  for q in bq.queries)
    bits_bound = bound_ms(bits_bytes, ops)
    padded_bound = bound_ms(bits_bytes, n * qp * (13 * k + 7 * nb_ + 8 * k))
    nonempty = int((parts != 0).sum().item())
    # the bytes the compaction needs: every partial, the int32 offset
    # and the 64 words of each non-empty block, 4 B per id written
    comp_bound = bound_ms(
        2 * qp * nblocks * 4 + nonempty * (4 + 64 * 4) + 4 * n_ids,
        4 * n_ids)
    # the yardstick of the first compaction design, kept so that times
    # compare: partials read and int64 offsets for every block
    comp_bound_int64 = bound_ms(
        2 * qp * nblocks * (4 + 8) + nonempty * 64 * 4 + 4 * n_ids,
        4 * n_ids)
    prefix_bound = bound_ms(2 * qp * nblocks * (4 + 4) + 2 * qp * 8,
                            2 * qp * nblocks)

    def timed(kern, plain_fn):
        out = {"ms": cuda_ms(kern, 10)}
        if plain:
            out["plain_ms"] = cuda_ms(plain_fn, 1, 1)
        return out
    out = {
        "scan_batch_bits": {
            "max_abs_err": 0 if equal else 1, "queries": qp, "k": k, "b": nb_,
            **timed(bits_k, bits_p),
            "bound_ms": bits_bound[0], "bound_by": bits_bound[1],
            "padded_bound_ms": padded_bound[0],
            "hits": int(parts[0].sum().item()),
            "candidates": int(parts[1].sum().item())},
        "compact_prefix": {
            "max_abs_err": 0 if prefix_equal else 1, "rows": 2 * qp,
            "partials": 2 * qp * nblocks, **timed(prefix_k, prefix_p),
            # one PyTorch call for the same scan (inclusive, int64)
            "library_ms": cuda_ms(
                lambda: torch.cumsum(parts, dim=2, dtype=torch.int64), 10),
            "bound_ms": prefix_bound[0], "bound_by": prefix_bound[1]},
        "compact_bits": {
            "max_abs_err": 0 if comp_equal else 1, "ids": n_ids,
            "nonempty_blocks": nonempty, "blocks": 2 * qp * nblocks,
            **timed(comp_k, comp_p), "kernel_ms": cuda_ms(comp_kernel, 10),
            "bound_ms": comp_bound[0], "bound_by": comp_bound[1],
            "int64_offsets_bound_ms": comp_bound_int64[0]},
    }
    del bits, parts, offsets, totals, outs
    return out


def batch_kernel_stats(data, seed: int) -> dict:
    """The batched kernels at the kernels phase's rows with a batch of
    BATCH queries (the four reference queries, then seeded ones)."""
    from geomesa_tpu_torch.scan import zscan
    return batch_stats(data, zscan.stack_queries(
        [zscan.make_query(*q) for q in kernel_batch_specs(seed)]))


def kernel_batch_specs(seed: int) -> list:
    """The kernels phase's BATCH queries as (boxes, intervals)."""
    rng = np.random.default_rng(seed + 7)
    return list(KERNEL_QUERIES) + [
        (boxes, [iv] if iv else [])
        for boxes, iv in random_queries(rng, BATCH - len(KERNEL_QUERIES), 0,
                                        1000 * MS_DAY)]


def store_batch_specs(seed: int) -> list:
    """The batched phase's STORE_BATCH_QUERIES seeded queries in the
    store's dates as (boxes, DURING interval or None)."""
    rng = np.random.default_rng(seed + 2)
    return random_queries(rng, STORE_BATCH_QUERIES, T0_DAY * MS_DAY,
                          T1_DAY * MS_DAY)


def store_batch(specs):
    """``specs`` as the store stacks them: DURING's exclusive bounds as
    inclusive millis."""
    from geomesa_tpu_torch.scan import zscan
    return zscan.stack_queries([zscan.make_query(
        boxes, [(iv[0] + 1, iv[1] - 1)] if iv else [])
        for boxes, iv in specs])


def _compact_equal(got, want) -> bool:
    """compact_bits' (hit ids, candidate ids, counts) equal, exactly."""
    return (np.array_equal(got[2], want[2])
            and all(torch.equal(g, w) for g, w in zip(got[:2], want[:2])))


def check_batch(data, bq) -> bool:
    """The batched kernels against their plain versions on the batch
    ``bq`` over ``data``: bitmaps, partials, offsets, totals, ids and
    counts equal."""
    from geomesa_tpu_torch.scan import kernels
    b, t = bq.tables(data.device)
    c = bq.counts(data.device)
    bits, parts = kernels.scan_batch_bits(data.cols, data.n, b, t, c)
    torch.cuda.synchronize()
    want_bits, want_parts = kernels.scan_batch_bits_plain(data.cols, data.n,
                                                          b, t, c)
    return (torch.equal(bits, want_bits) and torch.equal(parts, want_parts)
            and all(torch.equal(g, w) for g, w in zip(
                kernels.compact_prefix(parts),
                kernels.compact_prefix_plain(parts)))
            and _compact_equal(kernels.compact_bits(bits, parts),
                               kernels.compact_bits_plain(bits, parts)))


def phase_build():
    from geomesa_tpu_torch import native
    from geomesa_tpu_torch.scan import kernels
    info = kernels.build_library()
    print(info.log, file=sys.stderr, flush=True)
    host_path, host_s = native.build()
    emit({"phase": "build", "seconds": info.seconds, "library": info.path,
          "native_seconds": host_s, "native_library": host_path,
          "card": card_line(), "device": torch.cuda.get_device_name(0)})


def phase_kernels(seed: int, rows: int) -> dict:
    from geomesa_tpu_torch.scan import kernels, zscan
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    x = rng.uniform(-180, 180, rows)
    y = rng.uniform(-90, 90, rows)
    ms = rng.integers(0, 1000 * MS_DAY, rows)
    cap = zscan.next_pow2(rows)
    t0 = time.perf_counter()
    data = zscan.build_scan_data(x, y, ms, dev, cap=cap)
    del x, y, ms
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    n = data.n
    idx = torch.randint(0, n, (1_000_000,), device=dev, dtype=torch.int32,
                        generator=torch.Generator(dev).manual_seed(seed))
    idx_sorted = torch.sort(idx).values
    idx_l2 = torch.randint(0, 1 << 20, idx.shape, device=dev,
                           dtype=torch.int32,
                           generator=torch.Generator(dev).manual_seed(seed))
    m = idx.shape[0]
    flush = _l2_flush(dev)
    stats = {k: {"max_abs_err": 0, "per_query": []} for k in SOURCES
             if k not in PRED_KERNELS + SURFACE_KERNELS + JOIN_KERNELS
             + ("tube_mask",) + STANDING_KERNELS}
    for qi, (boxes, intervals) in enumerate(KERNEL_QUERIES):
        q = zscan.make_query(boxes, intervals)
        b, t = q.tables(dev)
        k, nb, ta = b.shape[0], t.shape[0], q.time_any
        col_bytes = 16 if ta else 24
        table_bytes = b.numel() * 4 + t.numel() * 4
        ops = _ops_per_row(k, nb, ta)
        cases = {
            "scan_mask": (
                lambda: kernels.scan_mask(data.cols, n, b, t, ta),
                lambda: kernels.scan_mask_plain(data.cols, n, b, t, ta),
                col_bytes * n + cap + table_bytes, ops * n),
            "scan_count": (
                lambda: kernels.scan_count(data.cols, n, b, t, ta),
                lambda: kernels.scan_count_plain(data.cols, n, b, t, ta),
                col_bytes * n + 4 + table_bytes, ops * n),
        }
        for name, (kern, plain, nbytes, nops) in cases.items():
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            torch.cuda.synchronize()
            err = _err(got, want)
            if name == "scan_mask" and bool(got[n:].any()):
                err = max(err, 1)
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
            bms, bby = bound_ms(nbytes, nops)
            stats[name]["per_query"].append({
                "query": qi, "ms": cuda_ms(kern, 20), "plain_ms":
                cuda_ms(plain, 3, warmup=1), "bound_ms": bms, "bound_by": bby,
                "hits": int(want.sum().item()), "equal": err == 0})
        # the gathered kernel: random ids, the same ids sorted, and ids
        # the L2 cache can hold
        g = gather_timing(data.rows, idx, b, t, ta, flush)
        g["sorted"] = gather_timing(data.rows, idx_sorted, b, t, ta, flush)
        g["l2_window"] = gather_timing(data.rows, idx_l2, b, t, ta, flush)
        err = max(d["max_abs_err"] for d in (g, g["sorted"], g["l2_window"]))
        g.update(query=qi, equal=err == 0)
        s = stats["scan_mask_gather"]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["per_query"].append(g)
    for name, st in batch_kernel_stats(data, seed).items():
        stats[name] = {"max_abs_err": st["max_abs_err"], "per_query": [st]}
    stats["tube_mask"] = tube_kernel_stats(data, seed)
    scan_data_bytes = data.nbytes
    del data, idx, idx_sorted, idx_l2, flush
    torch.cuda.empty_cache()
    stats["extent_tristate"] = extent_kernel_stats(seed, rows)
    emit({"phase": "kernels", "rows": n, "cap": cap, "gathered_rows": m,
          "upload_s": upload_s, "scan_data_bytes": scan_data_bytes,
          "kernels": stats})
    bad = [k for k, s in stats.items() if s["max_abs_err"] != 0]
    if bad:
        raise SystemExit(f"kernels disagree with their plain versions: {bad}")
    return stats


def _brute(x, y, ms, boxes, iv):
    hit = np.zeros(len(x), dtype=bool)
    for x0, y0, x1, y1 in boxes:
        hit |= (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
    if iv is not None:   # DURING: exclusive bounds
        hit &= (ms > iv[0]) & (ms < iv[1])
    return np.flatnonzero(hit)


def phase_store(seed: int, rows: int, gather_stats: dict):
    from geomesa_tpu_torch import InMemoryDataStore
    from geomesa_tpu_torch.index.zkeys import search_rows
    from geomesa_tpu_torch.scan import kernels, zscan
    from geomesa_tpu_torch.utils.properties import SystemProperty
    host_rows = SystemProperty("geomesa.scan.host.rows")
    threshold = SystemProperty("geomesa.scan.index.threshold")
    rng = np.random.default_rng(seed + 1)
    x = rng.uniform(-180, 180, rows)
    y = rng.uniform(-90, 90, rows)
    ms = rng.integers(T0_DAY * MS_DAY, T1_DAY * MS_DAY, rows)
    ids = np.arange(rows).astype(str).astype(object)
    # chunks: a first build at 60%, two in-place appends, one rebuild
    cuts = [0, int(rows * 0.6), int(rows * 0.7), int(rows * 0.8), rows]

    kernels.reset_launches()
    t_main = time.perf_counter()
    ds = InMemoryDataStore()
    ds.create_schema("ais", "dtg:Date,*geom:Point:srid=4326")
    st = ds._types["ais"]
    write_s, appends = [], []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        t0 = time.perf_counter()
        col = st.scan_data.xhi if st.scan_data is not None else None
        ds.write_dict("ais", ids[lo:hi], {"dtg": ms[lo:hi],
                                          "geom": (x[lo:hi], y[lo:hi])})
        ds.query(STORE_QUERIES[0][0], "ais")   # flush + index
        write_s.append(time.perf_counter() - t0)
        appends.append("in_place" if st.scan_data.xhi is col else "build")
    tiers = {}
    for tier, (h, thr) in {"gathered": ("0", "1.0"),
                           "dense": ("0", "0")}.items():
        host_rows.set(h)
        threshold.set(thr)
        per_q = []
        for ecql, boxes, iv in STORE_QUERIES:
            want = _brute(x, y, ms, boxes, iv)
            res = ds.query(ecql, "ais")
            line = ("Index-pruned device scan" if tier == "gathered"
                    else "Device scan:")
            if line not in res.explain.text:
                raise SystemExit(f"{tier} tier did not run for {ecql!r}")
            ok = (np.array_equal(res.rows, want)
                  and np.array_equal(res.ids, ids[want])
                  and ds.query_count(ecql, "ais") == len(want))
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                ds.query(ecql, "ais").ids
                times.append((time.perf_counter() - t0) * 1e3)
            per_q.append({"query": ecql, "hits": len(want), "exact": ok,
                          "p50_ms": statistics.median(times)})
            if not ok:
                raise SystemExit(f"{tier} tier wrong for {ecql!r}")
        tiers[tier] = per_q
    host_rows.set(None)
    threshold.set(None)
    # the scan layer's count entry point on the store's own columns
    # the north-star query's DURING as the store's inclusive interval
    north_iv = [(17_020 * MS_DAY + 1, 17_050 * MS_DAY - 1)]
    sq = zscan.make_query(STORE_QUERIES[0][1], north_iv)
    count = zscan.scan_count(st.scan_data, sq)
    mask_sum = int(zscan.scan_mask(st.scan_data, sq).sum().item())
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    counts = dict(kernels.launches)
    # the gathered kernel at the main path's shape: the north-star
    # query's candidates as the gathered tier gets them (host cap 0,
    # block cap n), in the index's z-order
    kind, cand = search_rows(st.zindex, "z3", STORE_QUERIES[0][1], north_iv,
                             0, st.n)
    if kind != "candidates":
        raise SystemExit(f"the z-index gave {kind!r}, not candidates")
    b, t = sq.tables(st.device)
    main_gather = gather_timing(st.scan_data.rows,
                                torch.from_numpy(cand).to(st.device), b, t,
                                sq.time_any, _l2_flush(st.device))
    gather_stats["max_abs_err"] = max(gather_stats["max_abs_err"],
                                      main_gather["max_abs_err"])
    emit({"phase": "store", "rows": rows, "cap": st.scan_data.cap,
          "scan_data_bytes": st.scan_data.nbytes,
          "write_s": write_s, "appends": appends, "tiers": tiers,
          "scan_count": count, "scan_mask_sum": mask_sum,
          "launches": counts, "seconds": main_s,
          "main_path_gather": main_gather})
    if main_gather["max_abs_err"] != 0:
        raise SystemExit("scan_mask_gather disagrees with its plain version "
                         "at the main path's shape")
    if count != mask_sum:
        raise SystemExit("scan_count disagrees with the mask on the store")
    if appends[0] != "build" or "in_place" not in appends:
        raise SystemExit(f"no in-place append among the writes: {appends}")
    missing = [k for k in ("scan_mask", "scan_mask_gather", "scan_count")
               if counts[k] == 0]
    if missing:
        raise SystemExit(f"kernels never launched on the main path: {missing}")
    return counts, ds, (x, y, ms, ids)


# -- the tube kernel, the native host paths, index versions, tube select ------

HOUR_MS = 3_600_000
TUBE_PAIRS = 720          # hourly bins of a 30-day track
TUBE_RUNS = 3             # host-clock runs per tube select for its p50
TUBE_WARMUP = 30          # launches ahead of the tube's second timing
TUBE_HOLD = 4 * HOLD_CYCLES   # and its spin, past the wrapper's host work
KNOTS_12 = 0.2            # degrees an hour (12 nm/h, a degree is 60 nm)


def ais_track(rng, n, t0_ms, step_ms, x0, y0, gap_at=None, gap_ms=0):
    """A vessel's AIS-like track: n fixes every ``step_ms`` from (x0, y0)
    at about 12 knots, its heading a random walk; after fix ``gap_at`` a
    silence of ``gap_ms`` (the vessel keeps moving)."""
    ms = t0_ms + np.arange(n, dtype=np.int64) * step_ms
    if gap_at is not None:
        ms[gap_at:] += gap_ms
    heading = rng.normal(0.0, 0.1, n).cumsum()
    hours = np.diff(ms, prepend=ms[0]) / HOUR_MS
    x = x0 + np.cumsum(KNOTS_12 * hours * np.cos(heading))
    y = y0 + np.cumsum(KNOTS_12 * hours * np.sin(heading))
    return x, y, ms


TUBE_DENSE_PAIRS = 1000   # overlapping intervals: several pairs a row


def tube_cases(seed: int) -> list:
    """The kernels phase's two tubes as (label, boxes, intervals): boxes
    (K, 4) f64 [xmin, ymin, xmax, ymax], intervals (K, 2) int64 millis,
    inclusive. "sparse": 720 pairs, hourly bins of a 30-day track from
    day 500, boxes 0.1-0.5 degrees wide (about 3 % of the rows' times in
    the tube, a handful of hits). "dense": 1,000 pairs in random order,
    intervals 1-5 days long starting anywhere in the rows' 1,000 days
    (overlapping), boxes 20-90 degrees wide anywhere, so nearly every row
    is a candidate and millions match."""
    rng = np.random.default_rng(seed + 9)
    t0 = 500 * MS_DAY
    cx, cy, _ = ais_track(rng, TUBE_PAIRS, t0, HOUR_MS, -100.0, 0.0)
    w = rng.uniform(0.1, 0.5, (TUBE_PAIRS, 2))
    sparse = np.stack([cx - w[:, 0] / 2, cy - w[:, 1] / 2, cx + w[:, 0] / 2,
                       cy + w[:, 1] / 2], axis=1)
    lo = t0 + np.arange(TUBE_PAIRS, dtype=np.int64) * HOUR_MS
    k = TUBE_DENSE_PAIRS
    w = rng.uniform(20.0, 90.0, (k, 2))
    cx, cy = rng.uniform(-180, 180, k), rng.uniform(-90, 90, k)
    dense = np.stack([cx - w[:, 0] / 2, cy - w[:, 1] / 2, cx + w[:, 0] / 2,
                      cy + w[:, 1] / 2], axis=1)
    dlo = rng.integers(0, 1000 * MS_DAY, k)
    dhi = dlo + rng.integers(MS_DAY, 5 * MS_DAY, k)
    return [("sparse", sparse, np.stack([lo, lo + HOUR_MS - 1], 1)),
            ("dense", dense, np.stack([dlo, dhi], 1))]


def tube_needs(cols, n: int, times) -> tuple[int, int, int]:
    """(rows of the first n whose (day, ms) some pair's interval holds,
    (row, pair) pairs whose interval holds the row, 32-byte sectors of a
    coordinate column that hold such a row), by searches over the
    intervals' keys (day * 2^32 + ms + 2^31, the (day, ms) order). The
    first and third are exact for any table: among the pairs with lo <=
    t, the largest hi reaches t. The second counts lo <= t less hi < t,
    exact where every interval has lo <= hi, as the tubes' do. A sector
    is 8 rows of a column from a 32-byte aligned start (the columns'
    allocations are)."""
    def key(day, ms):
        return day.long() * (1 << 32) + ms.long() + (1 << 31)
    t = key(cols[4][:n], cols[5][:n])
    lo, hi = key(times[:, 0], times[:, 1]), key(times[:, 2], times[:, 3])
    if bool((lo > hi).any()):
        raise SystemExit("tube_needs: an interval with lo > hi")
    order = torch.argsort(lo)
    lo, pm = lo[order], torch.cummax(hi[order], dim=0).values
    a = torch.searchsorted(lo, t, right=True)
    held = (a > 0) & (pm[(a - 1).clamp(min=0)] >= t)
    pairs = a - torch.searchsorted(torch.sort(hi).values, t)
    sectors = torch.nn.functional.pad(held, (0, -n % 8)).view(-1, 8).any(1)
    return (int(held.sum().item()), int(pairs.sum().item()),
            int(sectors.sum().item()))


def tube_kernel_stats(data, seed: int) -> dict:
    """tube_mask on the kernels phase's rows against the two tubes of
    tube_cases, each held to tube_mask_plain with torch.equal and timed
    beside its bound: the bytes this call's rows need (8 B of time words
    a row, 16 B of coordinates a row whose time some interval holds, 1 B
    written, the tables) or the operations they need (a time test of 7
    a row, a box test of 13 for each (row, pair) whose interval holds the
    row), whichever is larger; beside it the sector floor (the same with
    32 B for each sector of each coordinate column that holds such a row,
    as reads by row cost), and the operations of testing every (row,
    pair) at one each (bound_all_pairs_ms). ``ms`` is timed as every
    wrapper's; ``ms_long_spin`` after 30 warm-up launches and behind a
    spin 4x as long, which covers the wrapper's host work (its pair sort
    and two launches), so the card's time alone."""
    from geomesa_tpu_torch.analytics.tube import tube_tables
    from geomesa_tpu_torch.scan import kernels
    n = data.n
    err, out = 0, []
    for label, boxes, iv in tube_cases(seed):
        bx, tm = (torch.from_numpy(a).to(data.device)
                  for a in tube_tables(boxes, iv))
        k = bx.shape[0]

        def kern():
            return kernels.tube_mask(data.cols, n, bx, tm)

        def plain():
            return kernels.tube_mask_plain(data.cols, n, bx, tm)
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        err = max(err, 0 if equal else 1)
        held, pair_tests, sectors = tube_needs(data.cols, n, tm)
        nbytes = 9 * n + 16 * held + k * 48
        ops = 7 * n + 13 * pair_tests
        bms, bby = bound_ms(nbytes, ops)
        out.append({
            "query": f"{label} tube of {k} pairs", "pairs": k,
            "ms": cuda_ms(kern, 20),
            "ms_long_spin": cuda_ms(kern, 20, warmup=TUBE_WARMUP,
                                    hold=TUBE_HOLD),
            "plain_ms": cuda_ms(plain, 1, warmup=0),
            "bound_ms": bms, "bound_by": bby,
            "sector_floor_ms": (9 * n + 4 * SECTOR_BYTES * sectors + k * 48)
            / HBM_BYTES_PER_S * 1e3,
            "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ops_bound_ms": ops / INT32_OPS_PER_S * 1e3,
            "bound_all_pairs_ms": k * n / INT32_OPS_PER_S * 1e3,
            "rows_in_interval": held, "pair_tests_needed": pair_tests,
            "sectors_with_candidates": sectors,
            "hits": int(want.sum().item()), "equal": equal,
            "library_ms": None})
    return {"max_abs_err": err, "per_query": out}


def _same_bits(a, b) -> bool:
    """Bit for bit (NaN included): arrays, or tuples of them."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(_same_bits, a, b))
    if a is None or b is None:
        return a is None and b is None
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def store_zranges() -> list:
    """(lows, highs, bits) of the three store queries' range
    decompositions: per box, the z3 cube of each distinct (lo, hi)
    offset key of its bins (the index's per-bin fan-out), or the z2
    square of a query without time."""
    from geomesa_tpu_torch.curves import timebin
    from geomesa_tpu_torch.curves.sfc import z2sfc, z3sfc
    sfc3, sfc2 = z3sfc("week"), z2sfc()
    out = []
    for _, boxes, iv in STORE_QUERIES:
        keys = []
        if iv is not None:
            _, los, his = timebin.bins_of_interval(iv[0] + 1, iv[1] - 1,
                                                   "week")
            keys = sorted(set(zip(los.tolist(), his.tolist())))
        for x0, y0, x1, y1 in boxes:
            if iv is None:
                out.append(((sfc2.lon.normalize(x0), sfc2.lat.normalize(y0)),
                            (sfc2.lon.normalize(x1), sfc2.lat.normalize(y1)),
                            31))
            for lo, hi in keys:
                out.append(((sfc3.lon.normalize(x0), sfc3.lat.normalize(y0),
                             sfc3.time.normalize(lo)),
                            (sfc3.lon.normalize(x1), sfc3.lat.normalize(y1),
                             sfc3.time.normalize(hi)), 21))
    return out


def phase_native(ds, rows) -> dict:
    """The native host paths on the store's columns, each against its
    numpy plain twin (bit for bit), with the host-clock seconds of both;
    then the sort-order builds and the first z3 query of a new index."""
    import importlib
    from geomesa_tpu_torch.curves import timebin
    from geomesa_tpu_torch.curves.sfc import z2sfc, z3sfc
    from geomesa_tpu_torch.index import zkeys
    from geomesa_tpu_torch.utils.properties import HOST_RANGES_TARGET
    zr = importlib.import_module("geomesa_tpu_torch.curves.zranges")
    x, y, ms, _ = rows
    paths, wrong = {}, []

    def pair(name, fn, plain):
        t0 = time.perf_counter()
        got = fn()
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = plain()
        plain_s = time.perf_counter() - t0
        same = _same_bits(got, want)
        paths[name] = {"native_s": native_s, "plain_s": plain_s,
                       "equal": same}
        if not same:
            wrong.append(name)
        return got

    sfc = z3sfc("week")
    _, offs = pair("to_binned_week",
                   lambda: timebin.to_binned(ms, "week", lenient=True),
                   lambda: timebin.to_binned_plain(ms, "week", lenient=True))
    offs = offs.astype(np.float64)
    pair("z3_encode", lambda: sfc.index(x, y, offs, lenient=True),
         lambda: sfc.index_plain(x, y, offs, lenient=True))
    z2 = pair("z2_encode", lambda: z2sfc().index(x, y, lenient=True),
              lambda: z2sfc().index_plain(x, y, lenient=True))
    bins, z = pair("encode_binned_z3",
                   lambda: zkeys.encode_binned_z3(x, y, ms, "week"),
                   lambda: zkeys.encode_binned_z3_plain(x, y, ms, "week"))
    perm = pair("sort_bin_z", lambda: zkeys.sort_bin_z(bins, z),
                lambda: zkeys.sort_bin_z_plain(bins, z))[1]
    z2 = z2.astype(np.int64)
    pair("sort_z", lambda: zkeys.sort_z(z2), lambda: zkeys.sort_z_plain(z2))
    pair("gather_xyz", lambda: zkeys.gather_xyz(x, y, ms, perm),
         lambda: zkeys.gather_xyz_plain(x, y, ms, perm))
    del offs, z2, bins, z, perm
    cubes = store_zranges()
    mr = int(HOST_RANGES_TARGET.get())
    pair("zranges", lambda: tuple(zr.zranges(lo, hi, b, max_ranges=mr)
                                  for lo, hi, b in cubes),
         lambda: tuple(zr.zranges_plain(lo, hi, b, max_ranges=mr)
                       for lo, hi, b in cubes))
    paths["zranges"]["decompositions"] = len(cubes)

    # a new index's sort orders, and its first z3 query
    north_iv = [(17_020 * MS_DAY + 1, 17_050 * MS_DAY - 1)]
    t0 = time.perf_counter()
    zi = zkeys.ZKeyIndex(x, y, ms, "week")
    zi._build_z3()
    z3_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    kind, got = zi.query_rows("z3", STORE_QUERIES[0][1], north_iv,
                              2_000_000, len(x))
    first_z3_s = time.perf_counter() - t0
    query_s = time.perf_counter() - t1
    t0 = time.perf_counter()
    zi._build_z2()
    z2_s = time.perf_counter() - t0
    want = _brute(x, y, ms, STORE_QUERIES[0][1], STORE_QUERIES[0][2])
    if kind != "exact" or not np.array_equal(got, want):
        wrong.append("first_z3_query")
    del zi
    emit({"phase": "store_native", "rows": len(x), "paths": paths,
          "z3_sort_order_s": z3_s, "first_z3_query_s": first_z3_s,
          "first_z3_query_after_build_s": query_s, "z2_sort_order_s": z2_s,
          "wrong": wrong})
    if wrong:
        raise SystemExit(f"native paths disagree with numpy: {wrong}")
    return paths


def phase_versions(ds, rows) -> dict:
    """reindex the store's type to index version 1 (the legacy curve),
    then back to 2, each timed; after each, the three store queries
    id-exact against the f64 brute force, the z3 plan on the gathered
    tier (host tier off, block cap the table)."""
    from geomesa_tpu_torch.utils.properties import SystemProperty
    host_rows = SystemProperty("geomesa.scan.host.rows")
    threshold = SystemProperty("geomesa.scan.index.threshold")
    x, y, ms, ids = rows
    st = ds._types["ais"]
    out, wrong = {}, []
    host_rows.set("0")
    threshold.set("1.0")
    try:
        for version in (1, None):
            t0 = time.perf_counter()
            ds.reindex("ais", version)
            reindex_s = time.perf_counter() - t0
            v = st.zindex.version
            if v != (version or 2) or ds.get_schema("ais").index_version != v:
                wrong.append(("version", version, v))
            per_q = []
            for ecql, boxes, iv in STORE_QUERIES:
                want = _brute(x, y, ms, boxes, iv)
                t0 = time.perf_counter()
                res = ds.query(ecql, "ais")
                res_ids = res.ids
                first_ms = (time.perf_counter() - t0) * 1e3
                gathered = "Index-pruned device scan" in res.explain.text
                ok = (np.array_equal(res.rows, want)
                      and np.array_equal(res_ids, ids[want])
                      and ds.query_count(ecql, "ais") == len(want)
                      and gathered and (iv is None or res.plan.index == "z3"))
                per_q.append({"query": ecql, "strategy": res.plan.index,
                              "gathered": gathered, "hits": len(want),
                              "exact": bool(ok), "first_ms": first_ms})
                if not ok:
                    wrong.append((v, ecql))
            out[f"v{v}"] = {"reindex_s": reindex_s, "queries": per_q}
    finally:
        host_rows.set(None)
        threshold.set(None)
    emit({"phase": "store_versions", "rows": len(x), **out, "wrong": wrong})
    if wrong:
        raise SystemExit(f"index versions: wrong results: {wrong}")
    return out


def _tube_brute(tables, cols, order, ms_sorted):
    """The rows a tube's pairs hold, by the kernel's own compares in
    numpy (two-float boxes, (day, ms) intervals), and by float64: each
    pair's candidates are the rows whose millis lie in its interval
    widened by 1 ms (a superset: the floor split orders (day, ms) as the
    millis)."""
    boxes, iv, bx, tm = tables
    x, y, ms, xhi, xlo, yhi, ylo, tday, tms = cols

    def ge2(h, lo, bh, bl):
        return (h > bh) | ((h == bh) & (lo >= bl))

    def le2(h, lo, bh, bl):
        return (h < bh) | ((h == bh) & (lo <= bl))
    two, f64 = [], []
    for i in range(len(boxes)):
        a = np.searchsorted(ms_sorted, iv[i, 0] - 1, side="left")
        b = np.searchsorted(ms_sorted, iv[i, 1] + 1, side="right")
        r = order[a:b]
        d, m = tday[r], tms[r]
        during = (((d > tm[i, 0]) | ((d == tm[i, 0]) & (m >= tm[i, 1])))
                  & ((d < tm[i, 2]) | ((d == tm[i, 2]) & (m <= tm[i, 3]))))
        inside = (ge2(xhi[r], xlo[r], bx[i, 0], bx[i, 1])
                  & le2(xhi[r], xlo[r], bx[i, 2], bx[i, 3])
                  & ge2(yhi[r], ylo[r], bx[i, 4], bx[i, 5])
                  & le2(yhi[r], ylo[r], bx[i, 6], bx[i, 7]))
        two.append(r[during & inside])
        f64.append(r[(x[r] >= boxes[i, 0]) & (x[r] <= boxes[i, 2])
                     & (y[r] >= boxes[i, 1]) & (y[r] <= boxes[i, 3])
                     & (ms[r] >= iv[i, 0]) & (ms[r] <= iv[i, 1])])
    return np.unique(np.concatenate(two)), np.unique(np.concatenate(f64))


def tube_split(ds, tx, ty, tms) -> tuple[dict, np.ndarray]:
    """One tube_select_process call on the store's "ais" type in its
    parts, host clock in ms: TubeBuilder's pairs (pairs_ms), the tables
    split and copied to the card (tables_ms), the kernel with its pairs'
    sort (kernel_ms), the hit rows taken on the card and their ids
    gathered on the host (ids_ms); and the ids."""
    from geomesa_tpu_torch.analytics import processes
    from geomesa_tpu_torch.analytics.tube import TubeBuilder, tube_tables
    from geomesa_tpu_torch.scan import kernels
    st, _ = processes._point_cols(ds, "ais")
    data = st.scan_data
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    boxes, iv = TubeBuilder(0.1, HOUR_MS).build(tx, ty, tms)
    t1 = time.perf_counter()
    bx, tm = (torch.from_numpy(a).to(data.device)
              for a in tube_tables(boxes, iv))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    mask = kernels.tube_mask(data.cols, data.n, bx, tm)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    ids = st.batch.ids[torch.nonzero(mask).flatten().cpu().numpy()]
    t4 = time.perf_counter()
    return ({"pairs_ms": (t1 - t0) * 1e3, "tables_ms": (t2 - t1) * 1e3,
             "kernel_ms": (t3 - t2) * 1e3, "ids_ms": (t4 - t3) * 1e3,
             "total_ms": (t4 - t0) * 1e3}, ids)


def phase_tube(seed: int, ds, rows) -> int:
    """tube_select_process on the store: two vessels' AIS-like tracks of
    1,440 fixes, one every 30 minutes over 30 days inside the store's
    dates at about 12 knots, the second silent for 48 hours (the gap
    fill), hourly bins, a 0.1 degree buffer; the ids held to a numpy
    brute force of the kernel's compares, the rows where an f64 brute
    force differs counted, p50 of 3 host-clock runs. Launch counts are
    zeroed before the calls and read after: tube_mask must launch. Then,
    outside the counted runs, one call of each track in its parts
    (``tube_split``), its ids held to the process's."""
    from geomesa_tpu_torch.analytics import processes
    from geomesa_tpu_torch.analytics.tube import TubeBuilder, tube_tables
    from geomesa_tpu_torch.scan import kernels, zscan
    x, y, ms, ids = rows
    rng = np.random.default_rng(seed + 13)
    t0_ms = (T0_DAY + 30) * MS_DAY
    tracks = {
        "continuous": ais_track(rng, 1440, t0_ms, HOUR_MS // 2, -150.0,
                                10.0),
        "gap_48h": ais_track(rng, 1440, t0_ms, HOUR_MS // 2, 20.0, -30.0,
                             gap_at=720, gap_ms=48 * HOUR_MS)}
    order = np.argsort(ms, kind="stable")
    cols = (x, y, ms, *zscan.split_two_float(x), *zscan.split_two_float(y),
            ms // MS_DAY, ms % MS_DAY)
    ms_sorted = ms[order]
    kernels.reset_launches()
    out, wrong, got_ids = {}, [], {}
    for name, (tx, ty, tms) in tracks.items():
        runs, got = [], None
        for _ in range(TUBE_RUNS):
            t0 = time.perf_counter()
            got = processes.tube_select_process(ds, "ais", tx, ty, tms, 0.1,
                                                bin_millis=HOUR_MS)
            runs.append((time.perf_counter() - t0) * 1e3)
        got_ids[name] = got
        boxes, iv = TubeBuilder(0.1, HOUR_MS).build(tx, ty, tms)
        want, f64 = _tube_brute((boxes, iv, *tube_tables(boxes, iv)), cols,
                                order, ms_sorted)
        ok = np.array_equal(got.astype(str), ids[want].astype(str))
        out[name] = {"pairs": len(boxes), "hits": len(want),
                     "exact": bool(ok), "differ_from_f64": int(
                         len(np.setxor1d(want, f64))),
                     "p50_ms": statistics.median(runs), "runs_ms": runs}
        if not ok:
            wrong.append(name)
    launches = kernels.launches["tube_mask"]
    for name, (tx, ty, tms) in tracks.items():
        split, split_ids = tube_split(ds, tx, ty, tms)
        out[name]["split"] = split
        if not np.array_equal(split_ids.astype(str),
                              got_ids[name].astype(str)):
            wrong.append(f"{name} split")
    emit({"phase": "store_tube", "rows": len(x), "tracks": out,
          "launches": {"tube_mask": launches}, "wrong": wrong})
    if wrong:
        raise SystemExit(f"tube select: wrong ids: {wrong}")
    if launches == 0:
        raise SystemExit("tube_mask never launched on the tube select path")
    return launches


# -- durability: the write-ahead log, checkpoints, crash recovery ------------

DURABLE_CHUNKS = 100          # bench.py config 7: rows // 100 a write
DURABLE_REPEATS = 3           # non-durable and "always" ingests, alternated
DURABLE_POLICIES = ("always", "interval", "never")
DURABLE_BUDGET_S = 120.0      # the phase's share of the script's time
DURABLE_CUT_ROWS = 1_000_000  # config 7's own rows, for a cut policy
DURABLE_TAIL = (8, 10_000)    # new-id chunks written after the checkpoint
DURABLE_UPDATES = (2, 1_000)  # chunks of existing ids moved (delete, write)
DURABLE_DELETES = (2, 1_000)  # deletes of existing ids
TORN_FRAME = b"\x1f\x00\x00\x00 a torn in-flight append"


def _wal_timers() -> dict:
    """Counts and summed seconds of the WAL's encode and fsync timers and
    its fsync counter, from the port's metrics registry."""
    from geomesa_tpu_torch.metrics import metrics
    snap = metrics.snapshot()
    out = {"fsyncs": snap["counters"].get("wal.fsyncs", 0)}
    for name in ("wal.encode", "wal.fsync"):
        t = snap["timers"].get(name, {"count": 0, "mean_ms": 0.0})
        out[name] = t["count"] * t["mean_ms"] / 1e3
    return out


def _ingest(ds, ids, ms, x, y, chunk: int) -> list:
    """Chunked write_dict of the rows; the host-clock seconds after each
    chunk (cumulative)."""
    marks, t0 = [], time.perf_counter()
    for lo in range(0, len(ids), chunk):
        hi = lo + chunk
        ds.write_dict("ais", ids[lo:hi], {"dtg": ms[lo:hi],
                                          "geom": (x[lo:hi], y[lo:hi])})
        marks.append(time.perf_counter() - t0)
    return marks


class _ReplayClock:
    """Times recovery's parts around a store's construction: replay_into
    is wrapped for the call, so everything before it (the log's open and
    torn-tail scan, the checkpoint's read, verify, decode and write) is
    the snapshot load, and replay_into itself is the tail replay."""

    def __enter__(self):
        from geomesa_tpu_torch.wal import recovery
        self._mod, self._real = recovery, recovery.replay_into
        self.t0 = time.perf_counter()
        self.replay = [None, None]

        def timed(*a, **k):
            self.replay[0] = time.perf_counter()
            try:
                return self._real(*a, **k)
            finally:
                self.replay[1] = time.perf_counter()
        recovery.replay_into = timed
        return self

    def __exit__(self, *exc):
        self._mod.replay_into = self._real
        self.t1 = time.perf_counter()

    def split(self) -> dict:
        r0, r1 = self.replay
        return {"open_s": self.t1 - self.t0, "snapshot_load_s": r0 - self.t0,
                "tail_replay_s": r1 - r0}


def _store_answers(ds, x, y, ms, ids, what: str) -> dict:
    """The STORE_QUERIES through the gathered and the dense tiers: ids,
    rows and query_count against the float64 brute force over the
    expected rows (x, y, ms, ids in the store's row order); the count
    against the rows. Returns {(tier, query): ids}; raises on any
    mismatch."""
    from geomesa_tpu_torch.utils.properties import SystemProperty
    host_rows = SystemProperty("geomesa.scan.host.rows")
    threshold = SystemProperty("geomesa.scan.index.threshold")
    if ds.count("ais") != len(ids):
        raise SystemExit(f"durable {what}: count {ds.count('ais')} != "
                         f"{len(ids)} expected rows")
    out = {}
    try:
        for tier, (h, thr) in {"gathered": ("0", "1.0"),
                               "dense": ("0", "0")}.items():
            host_rows.set(h)
            threshold.set(thr)
            for qi, (ecql, boxes, iv) in enumerate(STORE_QUERIES):
                want = _brute(x, y, ms, boxes, iv)
                res = ds.query(ecql, "ais")
                line = ("Index-pruned device scan" if tier == "gathered"
                        else "Device scan:")
                if line not in res.explain.text:
                    raise SystemExit(f"durable {what}: the {tier} tier did "
                                     f"not run for {ecql!r}")
                if not (np.array_equal(res.rows, want)
                        and np.array_equal(res.ids, ids[want])
                        and ds.query_count(ecql, "ais") == len(want)):
                    raise SystemExit(f"durable {what}: {tier} tier wrong "
                                     f"for {ecql!r}")
                out[(tier, qi)] = res.ids
    finally:
        host_rows.set(None)
        threshold.set(None)
    return out


def _same_answers(got: dict, want: dict, what: str):
    bad = [k for k in want if not np.array_equal(got[k], want[k])]
    if bad:
        raise SystemExit(f"durable {what}: answers differ from the store "
                         f"before the crash: {bad}")


def _reopen(root: str, what: str, x, y, ms, ids) -> tuple:
    """Open a durable store on CUDA over ``root`` (recovery timed in its
    parts), run the north-star query once (its first query), then gate
    every STORE_QUERIES answer; the scan kernels must launch."""
    from geomesa_tpu_torch import InMemoryDataStore
    from geomesa_tpu_torch.scan import kernels
    with _ReplayClock() as clock:
        ds = InMemoryDataStore(durable_dir=root)
    t0 = time.perf_counter()
    ds.query(STORE_QUERIES[0][0], "ais").ids
    first_s = time.perf_counter() - t0
    before = dict(kernels.launches)
    answers = _store_answers(ds, x, y, ms, ids, what)
    moved = {k: kernels.launches[k] - before[k]
             for k in ("scan_mask", "scan_mask_gather")}
    rep = ds.journal.last_report
    line = {"reopen": what, **clock.split(), "first_query_s": first_s,
            "total_s": clock.split()["open_s"] + first_s,
            "report": rep.to_json_object(), "scan_launches": moved}
    if min(moved.values()) == 0:
        raise SystemExit(f"durable {what}: scan kernels never launched: "
                         f"{moved}")
    return ds, answers, line


def phase_durable(seed: int, rows: int) -> dict:
    """bench.py's config 7 on the card at the store's rows: the ais
    schema written in DURABLE_CHUNKS chunks non-durable and into a
    durable store under the "always" policy, DURABLE_REPEATS times each,
    alternated (the overhead is the ratio of the medians); a cold full
    recovery of the last "always" run's
    log, a checkpoint, a reopen bounded by it; a tail of new ids,
    updates (delete, then write) and deletes, an abort with a torn
    partial frame, and a reopen; then the "interval" and "never"
    ingests, at DURABLE_CUT_ROWS once the phase would pass
    DURABLE_BUDGET_S. Each durable store writes into a temporary
    directory of its own, removed when the phase ends. Every reopen's
    answers are held to the float64 brute force over the expected rows
    and to the store's before the crash. Launch counts are zeroed
    before the phase and read after; returns them."""
    import shutil
    import tempfile

    from geomesa_tpu_torch import InMemoryDataStore
    from geomesa_tpu_torch.scan import kernels
    from geomesa_tpu_torch.wal.log import list_segments
    rng = np.random.default_rng(seed + 7)
    x = rng.uniform(-180, 180, rows)
    y = rng.uniform(-90, 90, rows)
    ms = rng.integers(T0_DAY * MS_DAY, T1_DAY * MS_DAY, rows)
    ids = np.arange(rows).astype(str).astype(object)
    chunk = rows // DURABLE_CHUNKS
    spec = "dtg:Date,*geom:Point:srid=4326"
    t_phase = time.perf_counter()
    roots = []

    def mkroot(policy):
        roots.append(tempfile.mkdtemp(prefix=f"geomesa-durable-{policy}-"))
        return roots[-1]
    kernels.reset_launches()
    try:
        # the encode path's first use (pyarrow's import, the first IPC
        # stream) outside every timed run
        warm = InMemoryDataStore(durable_dir=mkroot("warm"),
                                 wal_fsync="never")
        warm.create_schema("ais", spec)
        _ingest(warm, ids[:chunk], ms[:chunk], x[:chunk], y[:chunk], chunk)
        warm.close()
        del warm
        # the non-durable and the "always" ingests alternate, the same
        # rows each time, so that neither side owns a point of the phase;
        # the overhead is the ratio of their medians
        base_runs, always_runs, ingest, cut = [], [], {}, []

        def base_ingest():
            ds = InMemoryDataStore()
            ds.create_schema("ais", spec)
            marks = _ingest(ds, ids, ms, x, y, chunk)
            del ds
            torch.cuda.empty_cache()
            base_runs.append(marks)
            emit({"phase": "durable", "ingest": "non_durable",
                  "run": len(base_runs), "rows": rows, "chunk_rows": chunk,
                  "seconds": marks[-1], "rows_per_s": rows / marks[-1]})

        def durable_ingest(policy, n, ref_s):
            root = mkroot(policy)
            ds = InMemoryDataStore(durable_dir=root, wal_fsync=policy)
            ds.create_schema("ais", spec)
            w0 = _wal_timers()
            marks = _ingest(ds, ids[:n], ms[:n], x[:n], y[:n], chunk)
            w1 = _wal_timers()
            ds.close()
            del ds
            torch.cuda.empty_cache()
            wal_bytes = sum(os.path.getsize(p) for _, p in
                            list_segments(os.path.join(root, "log")))
            el = marks[-1]
            line = {"phase": "durable", "ingest": policy, "rows": n,
                    "seconds": el, "rows_per_s": n / el,
                    "overhead_pct": (el / ref_s - 1.0) * 100.0,
                    "wal_mb": wal_bytes / 1e6,
                    "fsyncs": w1["fsyncs"] - w0["fsyncs"],
                    "encode_s": w1["wal.encode"] - w0["wal.encode"],
                    "fsync_s": w1["wal.fsync"] - w0["wal.fsync"]}
            line["encode_share"] = line["encode_s"] / el
            line["fsync_share"] = line["fsync_s"] / el
            emit(line)
            return root, line
        root = None
        for i in range(DURABLE_REPEATS):
            base_ingest()
            if root is not None:     # the last run's log is the one reopened
                shutil.rmtree(root, ignore_errors=True)
            # each "always" run against the non-durable run just before it
            root, line = durable_ingest("always", rows, base_runs[-1][-1])
            line["run"] = i + 1
            always_runs.append(line)
        base_marks = np.median(np.array(base_runs), axis=0)
        base_s = float(base_marks[-1])
        med = {k: statistics.median(r[k] for r in always_runs)
               for k in ("seconds", "encode_s", "fsync_s")}
        gap = med["seconds"] - base_s
        ingest["always"] = {
            "phase": "durable", "ingest": "always_vs_non_durable",
            "runs": DURABLE_REPEATS, "rows": rows,
            "non_durable_s": [m[-1] for m in base_runs],
            "always_s": [r["seconds"] for r in always_runs],
            "non_durable_median_s": base_s, "seconds": med["seconds"],
            "rows_per_s": rows / med["seconds"],
            "overhead_pct": (med["seconds"] / base_s - 1.0) * 100.0,
            "overhead_pct_pairs": [r["overhead_pct"] for r in always_runs],
            "encode_median_s": med["encode_s"],
            "fsync_median_s": med["fsync_s"],
            "encode_of_gap": med["encode_s"] / gap if gap > 0 else None,
            "fsync_of_gap": med["fsync_s"] / gap if gap > 0 else None}
        emit(ingest["always"])
        reopens = []
        # a cold full recovery: every record of the log replayed
        ds, answers, line = _reopen(root, "full", x, y, ms, ids)
        reopens.append(line)
        emit({"phase": "durable", **line})
        t0 = time.perf_counter()
        info = ds.checkpoint()
        ckpt = {"seconds": time.perf_counter() - t0, "lsn": info["lsn"],
                "bytes": sum(os.path.getsize(os.path.join(info["path"], f))
                             for f in os.listdir(info["path"])),
                "segments_dropped": info["segments_dropped"]}
        emit({"phase": "durable", "checkpoint": ckpt})
        ds.close()
        del ds
        torch.cuda.empty_cache()
        # the reopen bounded by the checkpoint: the snapshot, no tail
        ds, bounded, line = _reopen(root, "checkpoint", x, y, ms, ids)
        reopens.append(line)
        emit({"phase": "durable", **line})
        _same_answers(bounded, answers, "checkpoint reopen")
        # the tail: new ids, updates (delete, then write at new
        # positions), deletes; the expected rows follow the store's
        # order (kept rows in place, written rows appended)
        trng = np.random.default_rng(seed + 8)
        keep = np.ones(rows, dtype=bool)
        tail = []
        for c in range(DURABLE_TAIL[0]):
            k = DURABLE_TAIL[1]
            tid = np.array([f"n{c}-{i}" for i in range(k)], dtype=object)
            tx, ty = trng.uniform(-180, 180, k), trng.uniform(-90, 90, k)
            tms = trng.integers(T0_DAY * MS_DAY, T1_DAY * MS_DAY, k)
            ds.write_dict("ais", tid, {"dtg": tms, "geom": (tx, ty)})
            tail.append((tx, ty, tms, tid))
        picks = trng.choice(rows, DURABLE_UPDATES[0] * DURABLE_UPDATES[1]
                            + DURABLE_DELETES[0] * DURABLE_DELETES[1],
                            replace=False)
        t0 = time.perf_counter()
        for c in range(DURABLE_UPDATES[0]):
            rid = picks[c * DURABLE_UPDATES[1]:(c + 1) * DURABLE_UPDATES[1]]
            tx = np.clip(x[rid] + trng.normal(0, 0.5, len(rid)), -180, 180)
            ty = np.clip(y[rid] + trng.normal(0, 0.5, len(rid)), -90, 90)
            ds.delete("ais", ids[rid])
            ds.write_dict("ais", ids[rid], {"dtg": ms[rid], "geom": (tx, ty)})
            keep[rid] = False
            tail.append((tx, ty, ms[rid], ids[rid]))
        off = DURABLE_UPDATES[0] * DURABLE_UPDATES[1]
        for c in range(DURABLE_DELETES[0]):
            rid = picks[off + c * DURABLE_DELETES[1]:
                        off + (c + 1) * DURABLE_DELETES[1]]
            ds.delete("ais", ids[rid])
            keep[rid] = False
        tail_s = time.perf_counter() - t0
        ex, ey, ems, eids = (np.concatenate([a[keep]] + [t[i] for t in tail])
                             for i, a in enumerate((x, y, ms, ids)))
        before = _store_answers(ds, ex, ey, ems, eids, "before the crash")
        ds.journal.abort()
        del ds
        torch.cuda.empty_cache()
        _, seg = list_segments(os.path.join(root, "log"))[-1]
        with open(seg, "ab") as f:
            f.write(TORN_FRAME)
        ds, crashed, line = _reopen(root, "crash", ex, ey, ems, eids)
        line["updates_deletes_s"] = tail_s
        reopens.append(line)
        emit({"phase": "durable", **line})
        _same_answers(crashed, before, "crash reopen")
        rep = line["report"]
        if rep["torn_records_dropped"] != 1 or rep["records_failed"]:
            raise SystemExit(f"durable crash reopen: {rep}")
        ds.close()
        del ds
        torch.cuda.empty_cache()
        shutil.rmtree(root, ignore_errors=True)
        launches = dict(kernels.launches)
        # the other policies, at config 7's own rows once the phase has
        # spent its budget's share
        for policy in DURABLE_POLICIES[1:]:
            n = rows
            if rows > DURABLE_CUT_ROWS and time.perf_counter() - t_phase \
                    + 2 * ingest["always"]["seconds"] > DURABLE_BUDGET_S:
                n = DURABLE_CUT_ROWS
                cut.append(policy)
            ref_s = base_s if n == rows else float(base_marks[n // chunk - 1])
            shutil.rmtree(durable_ingest(policy, n, ref_s)[0],
                          ignore_errors=True)
        counts = {k: launches[k] for k in ("scan_mask", "scan_mask_gather",
                                           "scan_count")}
        summary = {
            "phase": "durable", "rows": rows, "card": card_line(),
            "seconds": time.perf_counter() - t_phase, "cut": cut,
            "cut_rows": DURABLE_CUT_ROWS if cut else None,
            "always_overhead_pct": ingest["always"]["overhead_pct"],
            "always_overhead_pct_pairs":
                ingest["always"]["overhead_pct_pairs"],
            "full_recovery_s": reopens[0]["open_s"],
            "checkpoint_recovery_s": reopens[1]["open_s"],
            "crash_recovery_s": reopens[2]["open_s"],
            "first_query_p50_s": statistics.median(
                r["first_query_s"] for r in reopens),
            "checkpoint_bytes": ckpt["bytes"], "launches": counts}
        emit(summary)
        if min(counts[k] for k in ("scan_mask", "scan_mask_gather")) == 0:
            raise SystemExit(f"scan kernels never launched on the durable "
                             f"path: {counts}")
    finally:
        for r in roots:
            shutil.rmtree(r, ignore_errors=True)
    return launches


FS_SPEC = ("name:String,mmsi:Integer,dtg:Date,speed:Double,course:Double,"
           "heading:Double,*geom:Point:srid=4326")   # bench.py config 16
FS_VESSELS = 5_000
FS_CHUNKS = 10            # writes of rows // 10: about 1,000 files
FS_BUDGET_S = 120.0       # the fs and convert phases' share together
FS_WRITE_SHARE = 0.35     # of it, the writes' (the cut below)
FS_DELETES = 1_000
FS_REOPENS = 3            # reopens with the sidecar, and as many without
FS_EVICT_DAYS = 12        # one-day loads, 4 past the type's cache of 8
FS_WEEK = ("BBOX(geom, -80, 30, -60, 45) AND "
           "dtg DURING 2016-08-07T00:00:00Z/2016-08-14T00:00:00Z",
           [(-80, 30, -60, 45)], (17_020 * MS_DAY, 17_027 * MS_DAY))
FS_ATTR = ("speed > 25 AND BBOX(geom, -80, 30, -60, 45) AND "
           "dtg DURING 2016-08-07T00:00:00Z/2016-08-14T00:00:00Z")
CONVERT_ROWS = 1_000_000  # bench.py config 16 part A's default
CONVERT_CHUNKS = (4_096, 65_536)   # scalar, vectorized
CONVERT_SCALAR_SHARE = 0.5   # of the budget left: the scalar leg's cut
CONVERT_CSV = {"type": "delimited-text", "format": "CSV",
               "id-field": "concat('v', $2)",
               "fields": [
                   {"name": "name", "transform": "$1"},
                   {"name": "mmsi", "transform": "$2::int"},
                   {"name": "dtg", "transform": "isoDate($3)"},
                   {"name": "geom",
                    "transform": "point($4::double, $5::double)"},
                   {"name": "speed", "transform": "$6::double"},
                   {"name": "course", "transform": "$7::double"},
                   {"name": "heading", "transform": "$8::double"}]}
CONVERT_QUERY = ("BBOX(geom, -80, 30, -60, 45) AND "
                 "dtg DURING 2017-03-05T00:00:00Z/2017-03-12T00:00:00Z")


def fs_rows(seed: int, rows: int) -> dict:
    """bench.py config 16's AIS columns at ``rows``: FS_VESSELS names
    (mmsi by vessel), times over the store's 100 days, uniform points,
    speed, course and heading."""
    rng = np.random.default_rng(seed + 17)
    vessel = rng.integers(0, FS_VESSELS, rows)
    names = np.array([f"vessel{i:04d}" for i in range(FS_VESSELS)],
                     dtype=object)        # sorted: code i is vessel i
    return {"vessel": vessel.astype(np.int32), "vocab": names,
            "mmsi": 366_000_000 + vessel.astype(np.int64),
            "ms": rng.integers(T0_DAY * MS_DAY, T1_DAY * MS_DAY, rows),
            "x": rng.uniform(-180, 180, rows), "y": rng.uniform(-90, 90, rows),
            "speed": rng.uniform(0, 30, rows),
            "course": rng.uniform(0, 360, rows),
            "heading": rng.uniform(0, 360, rows),
            "ids": np.arange(rows).astype(str).astype(object)}


def fs_batch(sft, d: dict, lo: int, hi: int):
    from geomesa_tpu_torch.features.batch import (DateColumn, FeatureBatch,
                                                  NumericColumn, PointColumn,
                                                  StringColumn)
    ones = np.ones(hi - lo, dtype=bool)
    return FeatureBatch(sft, d["ids"][lo:hi], {
        "name": StringColumn("name", d["vessel"][lo:hi], d["vocab"]),
        "mmsi": NumericColumn("mmsi", d["mmsi"][lo:hi], ones),
        "dtg": DateColumn("dtg", d["ms"][lo:hi], ones),
        "speed": NumericColumn("speed", d["speed"][lo:hi], ones),
        "course": NumericColumn("course", d["course"][lo:hi], ones),
        "heading": NumericColumn("heading", d["heading"][lo:hi], ones),
        "geom": PointColumn("geom", d["x"][lo:hi], d["y"][lo:hi], ones)})


def _row_ids(res) -> np.ndarray:
    """A file store result's ids as the sorted row numbers they name."""
    return np.sort(np.asarray(res.ids, dtype=object).astype(np.int64))


class _LoadClock:
    """Splits the file store's loads: the Parquet scan (fs._read_table),
    the decode (FeatureBatch.from_arrow) and the memory store's writes,
    each summed over the calls inside the block."""

    def __enter__(self):
        from geomesa_tpu_torch.features.batch import FeatureBatch
        from geomesa_tpu_torch.store import fs as fs_mod
        from geomesa_tpu_torch.store.memory import InMemoryDataStore
        self.s = {"read_s": 0.0, "decode_s": 0.0, "write_s": 0.0,
                  "writes": 0}
        self._saved = [(fs_mod, "_read_table", fs_mod._read_table),
                       (FeatureBatch, "from_arrow",
                        FeatureBatch.__dict__["from_arrow"]),
                       (InMemoryDataStore, "write", InMemoryDataStore.write)]
        clock = self

        def timed(key, fn):
            def wrapper(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    clock.s[key] += time.perf_counter() - t0
                    if key == "write_s":
                        clock.s["writes"] += 1
            return wrapper
        fs_mod._read_table = timed("read_s", fs_mod._read_table)
        real_decode = FeatureBatch.from_arrow
        FeatureBatch.from_arrow = staticmethod(timed("decode_s", real_decode))
        InMemoryDataStore.write = timed("write_s", InMemoryDataStore.write)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.s["total_s"] = time.perf_counter() - self.t0
        for owner, name, real in self._saved:
            setattr(owner, name, real)


class _SortCount:
    """Counts the z-key sorts (zkeys.sort_bin_z, sort_z) inside the
    block: a store that adopts a sidecar runs none."""

    def __enter__(self):
        from geomesa_tpu_torch.index import zkeys
        self._mod = zkeys
        self._real = (zkeys.sort_bin_z, zkeys.sort_z)
        self.n = 0

        def counted(fn):
            def wrapper(*a, **k):
                self.n += 1
                return fn(*a, **k)
            return wrapper
        zkeys.sort_bin_z, zkeys.sort_z = (counted(f) for f in self._real)
        return self

    def __exit__(self, *exc):
        self._mod.sort_bin_z, self._mod.sort_z = self._real


def _fs_tier(tier: str | None):
    """Force the resident store's tier as _store_answers does: gathered
    (index-pruned), dense, or the planner's own choice (None)."""
    from geomesa_tpu_torch.utils.properties import SystemProperty
    host_rows = SystemProperty("geomesa.scan.host.rows")
    threshold = SystemProperty("geomesa.scan.index.threshold")
    setting = {"gathered": ("0", "1.0"), "dense": ("0", "0"),
               None: (None, None)}[tier]
    host_rows.set(setting[0])
    threshold.set(setting[1])


def _fs_check(ds, ecql: str, want: np.ndarray, what: str,
              tier: str | None = None) -> dict:
    """One query through the file store: its ids must name exactly the
    rows ``want`` (a float64 brute force); host-clock seconds."""
    _fs_tier(tier)
    try:
        t0 = time.perf_counter()
        res = ds.query(ecql, "ais")
        got = _row_ids(res)
        sec = time.perf_counter() - t0
    finally:
        _fs_tier(None)
    if not np.array_equal(got, want):
        raise SystemExit(f"fs {what}: {len(got)} ids, the brute force "
                         f"{len(want)}; {ecql!r}")
    text = res.explain.text
    if tier == "gathered" and "Index-pruned device scan" not in text:
        raise SystemExit(f"fs {what}: the gathered tier did not run")
    if tier == "dense" and "Device scan:" not in text:
        raise SystemExit(f"fs {what}: the dense tier did not run")
    return {"step": what, "seconds": sec, "hits": len(got),
            "explain": text.splitlines()[-1]}


def phase_fs(seed: int, rows: int) -> tuple[dict, dict]:
    """BASELINE.md configuration 5's storage: bench.py config 16's AIS
    rows in a FileSystemDataStore (daily partitions over the store's 100
    days), written in FS_CHUNKS writes (cut once the writes would pass
    their share of FS_BUDGET_S), compacted to a file a partition, then
    queried cold and warm, projected, with an attribute predicate,
    resident (the gathered and the dense tiers, the sidecar written),
    through count, bin_query and arrow_ipc, reopened FS_REOPENS times
    with the sidecar alternated with as many without, after a delete of FS_DELETES ids and across a reindex
    to version 1 and back. Every answer is held to a float64 brute force
    over the rows that remain. Launch counts are zeroed before the phase
    and read after; returns them and the phase's summary."""
    import gc
    import shutil
    import tempfile

    import pyarrow
    import pyarrow.dataset  # noqa: F401  (the loads' scan)
    import pyarrow.parquet  # noqa: F401  (the writes)

    from geomesa_tpu_torch import FileSystemDataStore, Query
    from geomesa_tpu_torch.features.sft import parse_spec
    from geomesa_tpu_torch.scan import kernels
    t_phase = time.perf_counter()
    emit({"phase": "fs", "pyarrow": pyarrow.__version__})
    d = fs_rows(seed, rows)
    root = tempfile.mkdtemp(prefix="geomesa-fs-")
    kernels.reset_launches()
    steps = []

    def step(line):
        steps.append(line)
        emit({"phase": "fs", **line})
    try:
        ds = FileSystemDataStore(root)
        ds.create_schema(parse_spec("ais", FS_SPEC))
        sft = ds.get_schema("ais")
        chunk = rows // FS_CHUNKS
        t0, written, cut = time.perf_counter(), 0, None
        for c in range(FS_CHUNKS):
            ds.write("ais", fs_batch(sft, d, written, written + chunk))
            written += chunk
            el = time.perf_counter() - t0
            if (c + 1 < FS_CHUNKS and el / (c + 1) * (c + 2)
                    > FS_WRITE_SHARE * FS_BUDGET_S):
                cut = {"rows": written, "chunks": c + 1, "of": FS_CHUNKS}
                break
        write_s = time.perf_counter() - t0
        n = written
        for k in ("vessel", "mmsi", "ms", "x", "y", "speed", "ids"):
            d[k] = d[k][:n]
        files = ds._files_for(ds._state("ais"), None)
        on_disk = sum(os.path.getsize(f) for f in files)
        step({"step": "write", "rows": n, "chunks": written // chunk,
              "seconds": write_s, "rows_per_s": n / write_s,
              "files": len(files), "bytes_per_row": on_disk / n,
              "partitions": len(ds.partitions("ais")), "cut": cut})
        t0 = time.perf_counter()
        ds.compact("ais")
        files = ds._files_for(ds._state("ais"), None)
        on_disk = sum(os.path.getsize(f) for f in files)
        step({"step": "compact", "seconds": time.perf_counter() - t0,
              "files": len(files), "bytes_per_row": on_disk / n})
        x, y, ms = d["x"], d["y"], d["ms"]
        week = _brute(x, y, ms, FS_WEEK[1], FS_WEEK[2])
        for what in ("week_cold", "week_warm"):
            line = _fs_check(ds, FS_WEEK[0], week, what)
            if not re.search(r"Partitions scanned: \d+; files: \d+; "
                             r"parquet pushdown: yes", line["explain"]):
                raise SystemExit(f"fs {what}: {line['explain']!r}")
            step(line)
        t0 = time.perf_counter()
        res = ds.query(Query("ais", FS_WEEK[0], properties=["name"]))
        got = _row_ids(res)
        sec = time.perf_counter() - t0
        if not (np.array_equal(got, week)
                and set(res.batch.columns) == {"name"}
                and "columns: 3" in res.explain.text):
            raise SystemExit("fs projected load: wrong ids or columns")
        names = [res.batch.col("name").value(i) for i in range(res.n)]
        rows_of = np.asarray(res.ids, dtype=object).astype(np.int64)
        if names != d["vocab"][d["vessel"][rows_of]].tolist():
            raise SystemExit("fs projected load: wrong names")
        step({"step": "week_projected", "seconds": sec, "hits": len(got),
              "explain": res.explain.text.splitlines()[-1]})
        attr = np.intersect1d(week, np.flatnonzero(d["speed"] > 25))
        step(_fs_check(ds, FS_ATTR, attr, "attr_predicate"))
        # LRU evictions: one-day loads past the type's cache of 8; the
        # evicted stores (and any sidecar they awaited) must let go of
        # their device memory, so four loads past the 8th add less than
        # one load's memory
        mem_at = {}
        t0 = time.perf_counter()
        for k in range(FS_EVICT_DAYS):
            day = T0_DAY + 40 + k
            want = _brute(x, y, ms, [(-180, -90, 180, 90)],
                          (day * MS_DAY, (day + 1) * MS_DAY))
            _fs_check(ds, f"BBOX(geom, -180, -90, 180, 90) AND dtg "
                      f"DURING {_iso(day)}/{_iso(day + 1)}", want,
                      f"evict_{k}")
            gc.collect()
            mem_at[k + 1] = torch.cuda.memory_allocated()
        cache = ds._state("ais").cache
        held = {id(m) for m in cache.values()}
        one_load = (mem_at[8] - mem_at[1]) / 7
        if (len(cache) != 8
                or mem_at[FS_EVICT_DAYS] > mem_at[8] + one_load
                or not all(id(m) in held for m in
                           ds._state("ais").pending_sidecar.values())):
            raise SystemExit(f"fs: evicted loads still held ({mem_at})")
        del cache    # the phase's only reference besides the store's own
        step({"step": "evictions", "loads": FS_EVICT_DAYS,
              "seconds": time.perf_counter() - t0,
              "memory_allocated_by_load": mem_at})
        # the full table on the card: the Parquet scan, the decode and
        # the store writes split
        with _LoadClock() as clock:
            ds.load_resident("ais")
        step({"step": "load_resident", **clock.s,
              "memory_allocated": torch.cuda.memory_allocated()})
        north = _brute(x, y, ms, STORE_QUERIES[0][1], STORE_QUERIES[0][2])
        wide = _brute(x, y, ms, STORE_QUERIES[2][1], STORE_QUERIES[2][2])
        first = _fs_check(ds, STORE_QUERIES[0][0], north,
                          "resident_north_star_first", "gathered")
        step(first)
        index_dir = os.path.join(root, "ais", "index")
        if not any(os.path.isfile(os.path.join(index_dir, s,
                                               "manifest.json"))
                   for s in os.listdir(index_dir)):
            raise SystemExit("fs: the first z3 query wrote no sidecar")
        step(_fs_check(ds, STORE_QUERIES[0][0], north,
                       "resident_north_star", "gathered"))
        step(_fs_check(ds, STORE_QUERIES[2][0], wide, "resident_wide",
                       "dense"))
        t0 = time.perf_counter()
        count = ds.count("ais")
        count_s = time.perf_counter() - t0
        if count != n:
            raise SystemExit(f"fs count {count} != {n}")
        t0 = time.perf_counter()
        bins = ds.bin_query("ais", STORE_QUERIES[0][0])
        bin_s = time.perf_counter() - t0
        if len(bins) != 16 * len(north):
            raise SystemExit(f"fs bin_query: {len(bins)} bytes for "
                             f"{len(north)} hits")
        t0 = time.perf_counter()
        ipc = ds.arrow_ipc("ais", STORE_QUERIES[0][0])
        ipc_s = time.perf_counter() - t0
        table = pyarrow.ipc.open_file(pyarrow.py_buffer(ipc)).read_all()
        ipc_ids = np.sort(np.asarray(table.column("__fid__").to_pylist(),
                                     dtype=object).astype(np.int64))
        if not np.array_equal(ipc_ids, north):
            raise SystemExit("fs arrow_ipc: wrong ids")
        step({"step": "surface", "count_s": count_s, "bin_query_s": bin_s,
              "bin_bytes": len(bins), "arrow_ipc_s": ipc_s,
              "arrow_ipc_bytes": len(ipc)})
        before_drop = torch.cuda.memory_allocated()
        del ds
        gc.collect()
        torch.cuda.empty_cache()
        dropped = torch.cuda.memory_allocated()
        if dropped >= before_drop:
            raise SystemExit(f"fs: the dropped store still holds device "
                             f"memory ({before_drop} -> {dropped})")
        # reopens, alternated: with the sidecar (adopted: no sort), then
        # without it (index/ removed: a re-sort, whose query writes the
        # sidecar again); the open and load timed apart from the first
        # query, which is where the sort runs
        reopen = {"with_sidecar": [], "without_sidecar": []}
        for r in range(2 * FS_REOPENS):
            what = ("with_sidecar", "without_sidecar")[r % 2]
            if what == "without_sidecar":
                shutil.rmtree(index_dir)
            with _SortCount() as sorts:
                t0 = time.perf_counter()
                ds = FileSystemDataStore(root)
                ds.load_resident("ais")
                load_s = time.perf_counter() - t0
                line = _fs_check(ds, STORE_QUERIES[0][0], north,
                                 f"reopen_{what}", "gathered")
            line.update(load_s=load_s, z_sorts=sorts.n)
            if (sorts.n == 0) != (what == "with_sidecar"):
                raise SystemExit(f"fs reopen {what}: {sorts.n} z-key sorts")
            reopen[what].append({"load_s": load_s,
                                 "first_query_s": line["seconds"]})
            step(line)
            if r + 1 < 2 * FS_REOPENS:
                del ds
                gc.collect()
        # a delete rewrites the files holding the ids; the loads go
        drng = np.random.default_rng(seed + 18)
        gone = np.sort(drng.choice(n, FS_DELETES, replace=False))
        t0 = time.perf_counter()
        ds.delete("ais", d["ids"][gone])
        delete_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        after_delete = torch.cuda.memory_allocated()
        keep = np.ones(n, dtype=bool)
        keep[gone] = False
        north = north[keep[north]]
        week = week[keep[week]]
        wide = wide[keep[wide]]
        step({"step": "delete", "ids": FS_DELETES, "seconds": delete_s,
              "memory_allocated": after_delete})
        step(_fs_check(ds, FS_WEEK[0], week, "week_after_delete"))
        if ds.count("ais") != n - FS_DELETES:
            raise SystemExit("fs count after delete")
        ds.load_resident("ais")
        step(_fs_check(ds, STORE_QUERIES[0][0], north,
                       "resident_after_delete", "gathered"))
        step(_fs_check(ds, STORE_QUERIES[2][0], wide,
                       "wide_after_delete", "dense"))
        for version in (1, None):
            t0 = time.perf_counter()
            ds.reindex("ais", version)
            sec = time.perf_counter() - t0
            line = _fs_check(ds, STORE_QUERIES[0][0], north,
                             f"reindex_{version or 'current'}", "gathered")
            line["reindex_s"] = sec
            step(line)
        del ds
        gc.collect()
        torch.cuda.empty_cache()
        launches = dict(kernels.launches)
        counts = {k: launches[k] for k in ("scan_mask", "scan_mask_gather",
                                           "scan_count", "residual_mask")}
        summary = {
            "phase": "fs", "rows": n, "card": card_line(),
            "seconds": time.perf_counter() - t_phase, "cut": cut,
            "write_rows_per_s": steps[0]["rows_per_s"],
            "files": steps[0]["files"], "files_compacted": steps[1]["files"],
            "bytes_per_row": steps[1]["bytes_per_row"],
            "reopens": {what: {
                "first_query_s_median": statistics.median(
                    r["first_query_s"] for r in runs),
                "load_s_median": statistics.median(
                    r["load_s"] for r in runs),
                "runs": runs} for what, runs in reopen.items()},
            "memory_allocated": {"resident": before_drop,
                                 "after_drop": dropped,
                                 "after_delete": after_delete,
                                 "eighth_load": mem_at[8],
                                 "last_load": mem_at[FS_EVICT_DAYS],
                                 "end": torch.cuda.memory_allocated()},
            "launches": counts}
        emit(summary)
        if min(counts["scan_mask"], counts["scan_mask_gather"]) == 0:
            raise SystemExit(f"scan kernels never launched on the file "
                             f"store path: {counts}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches, summary


def convert_csv(seed: int, rows: int, start: int = 0):
    """bench.py config 16's CSV (make_csv's lines, mmsi and ids from
    ``start``) and the float64 values of its rows as the converter reads
    them (the coordinates parsed from the same text)."""
    rng = np.random.default_rng(seed + 16)
    x, y = rng.uniform(-180, 180, rows), rng.uniform(-90, 90, rows)
    day, hh = rng.integers(1, 28, rows), rng.integers(0, 24, rows)
    spd, crs = rng.uniform(0, 30, rows), rng.uniform(0, 360, rows)
    xs = [f"{v:.5f}" for v in x.tolist()]
    ys = [f"{v:.5f}" for v in y.tolist()]
    text = "".join([
        f"vessel{i % 5000},{i},2017-03-{d:02d}T{h:02d}:15:00Z,{a},{b},"
        f"{s:.2f},{c:.2f},{c:.1f}\n"
        for i, d, h, a, b, s, c in zip(range(start, start + rows),
                                       day.tolist(),
                                       hh.tolist(), xs, ys, spd.tolist(),
                                       crs.tolist())])
    t0 = int(np.datetime64("2017-03-01", "ms").astype(np.int64))
    ms = t0 + (day - 1) * MS_DAY + hh * 3_600_000 + 15 * 60_000
    return (text, np.array(xs, dtype=np.float64),
            np.array(ys, dtype=np.float64), ms)


def _same_batches(a, b) -> bool:
    """Two FeatureBatches equal id for id, column for column (values and
    validity; string columns by vocabulary and codes)."""
    from geomesa_tpu_torch.features.batch import (PointColumn,
                                                  StringColumn)
    if a.n != b.n or a.ids.tolist() != b.ids.tolist():
        return False
    for name, ca in a.columns.items():
        cb = b.columns[name]
        if isinstance(ca, StringColumn):
            ok = (ca.vocab.tolist() == cb.vocab.tolist()
                  and np.array_equal(ca.codes, cb.codes))
        elif isinstance(ca, PointColumn):
            ok = (np.array_equal(ca.x, cb.x, equal_nan=True)
                  and np.array_equal(ca.y, cb.y, equal_nan=True)
                  and np.array_equal(ca.valid, cb.valid))
        else:
            va = getattr(ca, "values", getattr(ca, "millis", None))
            vb = getattr(cb, "values", getattr(cb, "millis", None))
            ok = (np.array_equal(va, vb) and np.array_equal(ca.valid, cb.valid))
        if not ok:
            return False
    return True


def phase_convert(seed: int, budget_s: float) -> tuple[dict, dict]:
    """bench.py config 16 part A's converter at CONVERT_ROWS: the CSV
    through the scalar path (chunks of 4,096) and the vectorized one
    (chunks of 65,536), rows/s and their ratio; the two must give equal
    batches and equal counters. The scalar leg runs on the first rows
    only once the whole would pass its share of the budget (``cut``).
    Then the converted batches go into a file store and a durable
    in-memory store on the card, and a BBOX+time query on each must equal
    the brute force over the CSV's values. Launch counts are zeroed
    before the stores' queries and read after; returns them and the
    phase's summary."""
    import gc
    import shutil
    import tempfile

    import pyarrow
    import pyarrow.csv  # noqa: F401  (the vectorized CSV parse)
    import pyarrow.json  # noqa: F401  (the vectorized JSON parse)

    from geomesa_tpu_torch import FileSystemDataStore, InMemoryDataStore
    from geomesa_tpu_torch.convert import EvaluationContext, converter_for
    from geomesa_tpu_torch.convert.vectorized import INGEST_VECTORIZED
    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.features.sft import parse_spec
    from geomesa_tpu_torch.scan import kernels
    t_phase = time.perf_counter()
    rows = CONVERT_ROWS
    text, x, y, ms = convert_csv(seed, rows)
    setup_s = time.perf_counter() - t_phase
    sft = parse_spec("ais16", FS_SPEC)
    conv = converter_for(sft, CONVERT_CSV)
    # vectorized first: the scalar leg's cut follows from the budget left
    ctx = EvaluationContext()
    t0 = time.perf_counter()
    vec = [b for b, _ in conv.iter_batches(text, ctx,
                                           batch_rows=CONVERT_CHUNKS[1])]
    vec_s = time.perf_counter() - t0
    # the scalar leg on a 2 % probe, then on the rows its share allows
    probe = rows // 50
    cut_at = text.index("\n", len(text) * probe // rows) + 1
    INGEST_VECTORIZED.set("false")
    try:
        t0 = time.perf_counter()
        list(conv.iter_batches(text[:cut_at], EvaluationContext(),
                               batch_rows=CONVERT_CHUNKS[0]))
        probe_rate = text[:cut_at].count("\n") / (time.perf_counter() - t0)
        left = budget_s - (time.perf_counter() - t_phase)
        scalar_rows = min(rows, int(probe_rate * max(
            10.0, CONVERT_SCALAR_SHARE * left)))
        cut = None if scalar_rows >= rows else {"scalar_rows": scalar_rows,
                                                "of": rows}
        sub = text if cut is None else text[:text.index(
            "\n", len(text) * scalar_rows // rows) + 1]
        scalar_rows = sub.count("\n")
        sctx = EvaluationContext()
        t0 = time.perf_counter()
        sca = [b for b, _ in conv.iter_batches(sub, sctx,
                                               batch_rows=CONVERT_CHUNKS[0])]
        sca_s = time.perf_counter() - t0
    finally:
        INGEST_VECTORIZED.set(None)
    vec_all = FeatureBatch.concat_all(vec)
    sca_all = FeatureBatch.concat_all(sca)
    if cut is None:
        same = (_same_batches(vec_all, sca_all)
                and (ctx.success, ctx.failure, ctx.line)
                == (sctx.success, sctx.failure, sctx.line))
    else:
        # the scalar rows against the vectorized path on the same rows
        vctx = EvaluationContext()
        head = FeatureBatch.concat_all(
            [b for b, _ in conv.iter_batches(sub, vctx,
                                             batch_rows=CONVERT_CHUNKS[1])])
        same = (_same_batches(head, sca_all)
                and (vctx.success, vctx.failure, vctx.line)
                == (sctx.success, sctx.failure, sctx.line))
    if not same or ctx.success != rows or ctx.failure:
        raise SystemExit("convert: the scalar and vectorized paths differ "
                         f"({ctx.success} / {sctx.success} rows)")
    emit({"phase": "convert", "rows": rows, "csv_mb": len(text) / 1e6,
          "setup_s": setup_s,
          "vectorized": {"chunk_rows": CONVERT_CHUNKS[1], "seconds": vec_s,
                         "rows_per_s": rows / vec_s, "batches": len(vec)},
          "scalar": {"chunk_rows": CONVERT_CHUNKS[0], "rows": scalar_rows,
                     "seconds": sca_s, "rows_per_s": scalar_rows / sca_s,
                     "batches": len(sca)},
          "speedup": (rows / vec_s) / (scalar_rows / sca_s), "cut": cut,
          "equal": same})
    del sca, sca_all, text
    week = [int(np.datetime64(f"2017-03-{d:02d}", "ms").astype(np.int64))
            for d in (5, 12)]
    want = _brute(x, y, ms, [(-80, 30, -60, 45)], week)
    roots = [tempfile.mkdtemp(prefix="geomesa-convert-fs-"),
             tempfile.mkdtemp(prefix="geomesa-convert-wal-")]
    kernels.reset_launches()
    stores = {}
    try:
        fs = FileSystemDataStore(roots[0])
        fs.create_schema(parse_spec("ais16", FS_SPEC))
        mem = InMemoryDataStore(durable_dir=roots[1], wal_fsync="interval")
        mem.create_schema(parse_spec("ais16", FS_SPEC))
        for name, ds in (("fs", fs), ("durable", mem)):
            t0 = time.perf_counter()
            for b in vec:
                ds.write("ais16", b)
            write_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            res = ds.query(CONVERT_QUERY, "ais16")
            got = np.sort(np.array([int(i[1:]) for i in res.ids],
                                   dtype=np.int64))
            q_s = time.perf_counter() - t0
            if not (np.array_equal(got, want) and ds.count("ais16") == rows):
                raise SystemExit(f"convert {name}: {len(got)} ids, the "
                                 f"brute force {len(want)}")
            stores[name] = {"write_s": write_s,
                            "write_rows_per_s": rows / write_s,
                            "query_s": q_s, "hits": len(got)}
        mem.close()
        del fs, mem
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        for r in roots:
            shutil.rmtree(r, ignore_errors=True)
    launches = dict(kernels.launches)
    summary = {"phase": "convert", "rows": rows, "card": card_line(),
               "seconds": time.perf_counter() - t_phase, "cut": cut,
               "vectorized_rows_per_s": rows / vec_s,
               "scalar_rows_per_s": scalar_rows / sca_s,
               "speedup": (rows / vec_s) / (scalar_rows / sca_s),
               "stores": stores,
               "launches": {k: launches[k] for k in ("scan_mask",
                                                     "scan_mask_gather")}}
    emit(summary)
    return launches, summary


# -- geofence and stream (queue 1 item 5: the streaming tiers) -------------

GEOFENCE_SPEC = "name:String,speed:Double,dtg:Date,*geom:Point:srid=4326"
GEOFENCE_FILTERS = 10_000         # bench.py config 15 (A)
GEOFENCE_FILTERS_BIG = 100_000    # (B)
GEOFENCE_ROWS = 8_192             # (A): rows a batch
GEOFENCE_BATCHES = 4
GEOFENCE_BULK = 1_000_000         # (B), (C)
GEOFENCE_ORACLE = 2_048           # (B): filters checked, a stride
GEOFENCE_PROBES = 64              # (A): topics probed, a stride
GEOFENCE_CHURN = 256              # (C)
STREAM_BUDGET_S = 150.0           # the geofence and stream phases together
STANDING_BOX_OPS, STANDING_TIME_OPS, STANDING_ATTR_OPS = 15, 6, 4
STANDING_KERNELS = ("standing_grid", "standing_count", "standing_offsets",
                    "standing_write", "standing_sort")
SOURCES.update({
    "standing_grid": "geomesa_tpu/scan/standing.py:130 _standing_mask",
    "standing_count": "geomesa_tpu/scan/standing.py:130 _standing_mask "
                      "(+ :165 _mask_total)",
    "standing_offsets": "geomesa_tpu/scan/standing.py:165 _mask_total",
    "standing_write": "geomesa_tpu/scan/standing.py:170 _flat_nonzero",
    "standing_sort": "geomesa_tpu/scan/standing.py:170 _flat_nonzero"})
SOURCE_FILES.update({k: "geomesa_tpu_torch/csrc/standing.cu"
                     for k in STANDING_KERNELS})


def geofence_ecql(rng, i: int) -> str:
    """bench.py's _geofence_ecql: 0.5-2.5 degree half-width boxes, every
    tenth filter with a DURING, one with a speed BETWEEN and one with a
    LIKE (residual)."""
    cx = float(rng.uniform(-178, 178))
    cy = float(rng.uniform(-88, 88))
    w = float(rng.uniform(0.5, 2.5))
    box = (f"bbox(geom,{cx - w:.4f},{cy - w:.4f},"
           f"{cx + w:.4f},{cy + w:.4f})")
    m = i % 10
    if m == 3:
        return (f"{box} AND dtg DURING "
                f"2016-07-01T00:00:00Z/2016-09-01T00:00:00Z")
    if m == 5:
        lo = float(rng.uniform(0, 200))
        return f"{box} AND speed BETWEEN {lo:.2f} AND {lo + 40:.2f}"
    if m == 7:
        return f"{box} AND name LIKE 'u{i % 100}%'"
    return box


def geofence_batch(rng, sft, n: int, tag: str):
    """bench.py's _geofence_batch: names u0..u499, speeds 0-300, the
    store's 100 days, uniform points."""
    from geomesa_tpu_torch.features.batch import FeatureBatch
    ms = rng.integers(T0_DAY * MS_DAY, T1_DAY * MS_DAY, n).astype(np.int64)
    return FeatureBatch.from_dict(
        sft, [f"{tag}_{i}" for i in range(n)],
        {"name": [f"u{i % 500}" for i in range(n)],
         "speed": rng.uniform(0, 300, n), "dtg": ms,
         "geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n))})


def standing_all_pairs_ms(tables, n_valid: int, chunk: int) -> float:
    """The yardstick of the all-pairs kernel this design replaces (its
    bound, PERF.md row K5 before PR 19): the operations of testing every
    live slot against each of the chunk's rows (a box test per valid box,
    the time test where the slot has an interval, an attribute test per
    bounded attribute; STANDING_*_OPS each) at F32_OPS_PER_S, or the
    bytes of its bitmap layout at HBM_BYTES_PER_S; the larger."""
    boxes, box_valid, box_any, times, attrs, attr_any, alive = (
        t.cpu().numpy() for t in tables)
    f, k, a = boxes.shape[0], boxes.shape[1], attrs.shape[1]
    timed = ~((times[:, 0] == -(2 ** 30)) & (times[:, 2] == 2 ** 30))
    per_slot = (STANDING_BOX_OPS * np.where(box_any, 0, box_valid.sum(1))
                + STANDING_TIME_OPS * timed
                + STANDING_ATTR_OPS * (~attr_any).sum(1))
    ops = float(per_slot[alive].sum()) * n_valid
    words = -(-chunk // 32)
    nbytes = (chunk * (24 + 8 * a) + f * (32 * k + k + 2 + 16 + 17 * a)
              + f * words * 4 + f * -(-words // 64) * 4)
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3


def _f32_bound(nbytes: float, ops: float) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def standing_candidates(tables, grid, views, n_valid: int) -> dict:
    """What the grid sends to the full test for these rows: the candidate
    (slot, row) pairs, their operations (per slot STANDING_BOX_OPS a
    valid box unless box_any, STANDING_TIME_OPS a bounded interval,
    STANDING_ATTR_OPS a bounded attribute), the rows with a cell and the
    grid entries they read (torch on the card, outside the counted run)."""
    from geomesa_tpu_torch.scan import kernels
    boxes, box_valid, box_any, times, attrs, attr_any, alive = tables
    timed = ~((times[:, 0] == -(2 ** 30)) & (times[:, 2] == 2 ** 30))
    ops = (STANDING_BOX_OPS * torch.where(box_any, 0, box_valid.sum(1))
           + STANDING_TIME_OPS * timed
           + STANDING_ATTR_OPS * (~attr_any).sum(1))
    start = grid.cell_start.long()
    sizes = start[1:] - start[:-1]
    cells = torch.arange(kernels.STANDING_CELLS, device=start.device)
    cell_ops = torch.zeros(kernels.STANDING_CELLS, dtype=torch.int64,
                           device=start.device).index_add_(
        0, torch.repeat_interleave(cells, sizes),
        ops[grid.cell_slots.long()])
    cell = kernels.standing_cells_plain(views[0][:n_valid],
                                        views[2][:n_valid])
    r = cell[cell >= 0]
    n_every = int(grid.every.shape[0])
    listed = int(sizes[r].sum())
    return {"pairs": listed + n_every * n_valid,
            "ops": int(cell_ops[r].sum())
            + int(ops[grid.every.long()].sum()) * n_valid,
            "rows_with_cell": int(r.shape[0]), "listed": listed,
            "n_every": n_every}


def standing_bounds(tables, grid, views, n_valid: int, hits: int,
                    pairs: int) -> dict:
    """Each standing kernel's bound (ms, by) at the shapes timed: the
    chunk's count and write passes (the rows, 24 B and 8 B an attribute;
    the cell bounds of a row with a cell, 8 B; the grid lists they read,
    4 B a listed slot; the everywhere list, 4 B a slot; a hit counted or
    written, 4 B; or the candidate pairs' operations), the grid's build
    (the tables' boxes, box_valid, box_any and alive read, the mode, cell
    starts, lists and everywhere list written; 12 operations a live valid
    box, 2 an entry), the slots' prefix (counts read, starts and cursor
    written) and the sort (the dispatch's ``pairs`` read and written, the
    slots' starts, counts and modes read)."""
    from geomesa_tpu_torch.scan import kernels
    f, k, a = (tables[0].shape[0], tables[0].shape[1],
               tables[4].shape[1])
    c = standing_candidates(tables, grid, views, n_valid)
    rows_b = (n_valid * (24 + 8 * a) + 8 * c["rows_with_cell"]
              + 4 * c["listed"] + 4 * c["n_every"])
    match = _f32_bound(rows_b + 4 * hits, c["ops"])
    entries = int(grid.cell_slots.shape[0])
    live_boxes = int((tables[1] & tables[6][:, None]).sum())
    grid_b = (f * (32 * k + k + 2) + f
              + 4 * (kernels.STANDING_CELLS + 1) + 4 * entries
              + 4 * c["n_every"])
    return {"standing_grid": _f32_bound(grid_b, 12 * live_boxes
                                        + 2 * entries),
            "standing_count": match, "standing_write": match,
            "standing_offsets": _f32_bound(12 * f + 12, f),
            "standing_sort": _f32_bound(8 * pairs + 9 * f, pairs),
            "candidates": c}


def _grid_err(got, want) -> int:
    """0 when two grids list the same slots in the same cells (the
    kernels list them in no set order), else 1."""
    from geomesa_tpu_torch.scan import kernels
    out = []
    for g in (got, want):
        f = g.mode.shape[0]
        start = g.cell_start.long()
        cell = torch.repeat_interleave(
            torch.arange(kernels.STANDING_CELLS, device=start.device),
            start[1:] - start[:-1])
        out.append((g.mode, g.cell_start,
                    torch.sort(cell * f + g.cell_slots.long()).values,
                    torch.sort(g.every).values))
    return int(not all(x.shape == y.shape and torch.equal(x, y)
                       for x, y in zip(*out)))


def _same(got, want) -> int:
    return _err(got, want) if got.shape == want.shape else 1


def standing_kernel_stats(fset, batch) -> dict:
    """The standing kernels on a dispatch of ``batch`` (outside the
    counted run). (1) Held against their plain version on the first two
    chunks, pair for pair: the grid (its lists compared as sets), the
    counts, the prefix, the write pass (each segment ordered), the sort,
    and the whole function against its plain version (the plain grid
    too); any difference fails the phase. (2) Timed: the grid's two C
    entries held, and the wrapper's wall time with its sync; the count
    and write passes held on the first chunk; the prefix held at the
    slots' counts; the sort held on the dispatch's pairs; each plain
    version once after a warm call; the prefix beside one torch.cumsum.
    (3) The whole dispatch's steps spanned by CUDA events (the host's
    launches included), its wall time and the ids' copy. With the
    bounds, the all-pairs yardstick, the grid's entries, everywhere
    slots and candidates per row."""
    from geomesa_tpu_torch.scan import kernels
    n = batch.n
    chunk = fset._chunk_rows(n)
    rows = fset._rows_device(fset._rows_host(batch), -(-n // chunk) * chunk)
    tables = fset.device_tables()
    dev = rows[0].device
    f, k = tables[0].shape[0], tables[0].shape[1]
    chunks = [(fset._chunk_views(rows, s, chunk), min(chunk, n - s), s)
              for s in range(0, n, chunk)]
    two = chunks[:2]
    # (1) the kernels against their plain version on two chunks
    got = kernels.standing_pairs(two, tables)
    want = kernels.standing_pairs_plain(two, tables)
    g = got[2]
    errs = {"standing_grid": _grid_err(g, want[2])}
    kc = torch.zeros(f, dtype=torch.int32, device=dev)
    pc = kc.clone()
    for views, nv, _ in two:
        kernels.standing_count(views, tables, g, nv, kc)
        kernels.standing_count_plain(views, tables, g, nv, pc)
    errs["standing_count"] = _same(kc, pc)
    ks, kcur, ktot = kernels.standing_offsets(kc)
    ps, pcur, ptot = kernels.standing_offsets_plain(pc)
    errs["standing_offsets"] = max(_same(ks, ps), _same(kcur, pcur),
                                   abs(ktot - ptot))
    kout = torch.empty(ktot, dtype=torch.int32, device=dev)
    pout = torch.empty(ptot, dtype=torch.int32, device=dev)
    for views, nv, r0 in two:
        kernels.standing_write(views, tables, g, nv, r0, kcur, kout)
        kernels.standing_write_plain(views, tables, g, nv, r0, pcur, pout)
    errs["standing_write"] = max(_same(kernels.standing_sort_plain(
        kout, ks, kc, g.mode), pout), _same(kcur, pcur))
    errs["standing_sort"] = _same(kernels.standing_sort(kout, ks, kc, g.mode),
                                  kernels.standing_sort_plain(kout, ks, kc,
                                                              g.mode))
    torch.cuda.synchronize()
    whole_equal = (torch.equal(got[0], want[0])
                   and torch.equal(got[1], want[1]))
    if any(errs.values()) or not whole_equal:
        raise SystemExit(f"geofence: the standing kernels differ from their "
                         f"plain version on the first two chunks: {errs}, "
                         f"pairs equal {whole_equal}")
    two_pairs = int(got[0].shape[0])
    # (2) each kernel timed, held, at the main path's shapes
    lib = kernels._library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    tp = [t.data_ptr() for t in tables]
    i32 = dict(dtype=torch.int32, device=dev)
    mode = torch.empty(f, dtype=torch.uint8, device=dev)
    cell_count = torch.zeros(kernels.STANDING_CELLS, **i32)
    every = torch.empty(f, **i32)
    cell_start = torch.empty(kernels.STANDING_CELLS + 1, **i32)
    cursor = torch.empty(kernels.STANDING_CELLS, **i32)
    sizes = torch.zeros(2, dtype=torch.int64, device=dev)
    slots = torch.empty_like(g.cell_slots)

    def grid_count():
        lib.geomesa_standing_grid_count(
            *tp, f, k, mode.data_ptr(), cell_count.data_ptr(),
            every.data_ptr(), cell_start.data_ptr(), cursor.data_ptr(),
            sizes.data_ptr(), stream)

    def grid_fill():
        lib.geomesa_standing_grid_fill(*tp, f, k, mode.data_ptr(),
                                       cursor.data_ptr(), slots.data_ptr(),
                                       stream)
    count_ms = cuda_ms(grid_count, 20, flush=lambda: (cell_count.zero_(),
                                                      sizes.zero_()))
    fill_ms = cuda_ms(grid_fill, 20, flush=lambda: cursor.copy_(
        cell_start[:-1]))
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kernels.standing_grid(tables)
        walls.append((time.perf_counter() - t0) * 1e3)
    views0, nv0, _ = chunks[0]
    c0 = torch.zeros(f, **i32)
    kernels.standing_count(views0, tables, g, nv0, c0)
    s0, cur0, t0_hits = kernels.standing_offsets(c0)
    out0 = torch.empty(t0_hits, **i32)
    scratch = torch.zeros(f, **i32)
    times = {
        "standing_grid": count_ms + fill_ms,
        "standing_count": cuda_ms(lambda: kernels.standing_count(
            views0, tables, g, nv0, scratch), 20),
        "standing_write": cuda_ms(lambda: kernels.standing_write(
            views0, tables, g, nv0, 0, cur0, out0), 20,
            flush=lambda: cur0.copy_(s0[:-1]))}
    # (3) the whole dispatch, step by step, on the card's clock
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    grid = kernels.standing_grid(tables)
    ev[1].record()
    counts = torch.zeros(f, **i32)
    for views, nv, _ in chunks:
        kernels.standing_count(views, tables, grid, nv, counts)
    ev[2].record()
    starts, cur, total = kernels.standing_offsets(counts)
    ev[3].record()
    pairs = torch.empty(total, **i32)
    for views, nv, r0 in chunks:
        kernels.standing_write(views, tables, grid, nv, r0, cur, pairs)
    ev[4].record()
    ids = kernels.standing_sort(pairs, starts, counts, grid.mode)
    ev[5].record()
    ev[5].synchronize()
    pipeline_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    ids.cpu(), counts.cpu()
    copy_s = time.perf_counter() - t1
    steps = {name: ev[i].elapsed_time(ev[i + 1]) for i, name in enumerate(
        ("grid_ms", "count_all_ms", "offsets_ms", "write_all_ms",
         "sort_ms"))}
    so, scur, stot = (torch.empty(f + 1, **i32), torch.empty(f, **i32),
                      torch.empty(1, dtype=torch.int64, device=dev))
    times["standing_offsets"] = cuda_ms(
        lambda: lib.geomesa_standing_offsets(
            counts.data_ptr(), f, so.data_ptr(), scur.data_ptr(),
            stot.data_ptr(), stream), 20)
    times["standing_sort"] = cuda_ms(
        lambda: kernels.standing_sort(pairs, starts, counts, grid.mode), 20)
    library = {"standing_offsets": cuda_ms(lambda: torch.cumsum(counts, 0),
                                           20)}
    plain = {
        "standing_grid": cuda_ms(lambda: kernels.standing_grid_plain(tables),
                                 1, warmup=1),
        "standing_count": cuda_ms(lambda: kernels.standing_count_plain(
            views0, tables, g, nv0, scratch), 1, warmup=1),
        "standing_write": cuda_ms(lambda: kernels.standing_write_plain(
            views0, tables, g, nv0, 0, s0[:-1].clone(), out0), 1, warmup=1),
        "standing_offsets": cuda_ms(lambda: kernels.standing_offsets_plain(
            counts), 1, warmup=1),
        "standing_sort": cuda_ms(lambda: kernels.standing_sort_plain(
            pairs, starts, counts, grid.mode), 1, warmup=1)}
    bounds = standing_bounds(tables, grid, views0, nv0, t0_hits, total)
    bulk_cand = standing_candidates(tables, grid, rows, n)
    per_kernel = {name: {"max_abs_err": errs[name], "ms": times[name],
                         "plain_ms": plain[name],
                         "bound_ms": bounds[name][0],
                         "bound_by": bounds[name][1],
                         "library_ms": library.get(name)}
                  for name in STANDING_KERNELS}
    chunks_n = len(chunks)
    device_only_ms = (times["standing_grid"] + times["standing_offsets"]
                      + times["standing_sort"] + chunks_n
                      * (times["standing_count"] + times["standing_write"]))
    sizes_all = grid.cell_start.long()
    return {
        "kernels": per_kernel, "chunk": chunk, "chunks": chunks_n,
        "slots": f, "live": int(tables[6].sum().item()),
        "first_two_chunks": {"pairs": two_pairs, "equal": True},
        "grid": {"entries": int(grid.cell_slots.shape[0]),
                 "everywhere": int(grid.every.shape[0]),
                 "grid_slots": int((grid.mode == kernels.STANDING_GRID)
                                   .sum()),
                 "largest_cell": int((sizes_all[1:] - sizes_all[:-1])
                                     .max()),
                 "count_scan_ms": count_ms, "fill_ms": fill_ms,
                 "wrapper_wall_ms": statistics.median(walls)},
        "candidates_per_row": bulk_cand["pairs"] / n,
        "hits_per_row": total / n,
        "chunk0": {"rows": nv0, "hits": t0_hits,
                   "candidates": bounds["candidates"]["pairs"],
                   "all_pairs_yardstick_ms": standing_all_pairs_ms(
                       tables, nv0, chunk)},
        "dispatch": {"steps_ms": steps, "pipeline_s": pipeline_s,
                     "ids_copy_s": copy_s, "pairs": total,
                     "device_only_ms": device_only_ms,
                     "all_pairs_yardstick_ms": chunks_n
                     * standing_all_pairs_ms(tables, nv0, chunk)}}


def phase_geofence(seed: int) -> tuple[dict, dict, float]:
    """bench.py config 15 at its own shapes (nothing cut): a fleet or port
    operator's 100k geofences alerting on a live vessel or vehicle feed.
    (A) a LiveDataStore on the card with a ContinuousQueryPublisher and
    10,000 filters, one warm write, then 4 batches of 8,192 rows; on 64
    probed topics (a stride) the published ids must equal a host
    evaluate per filter over each batch; device rows/s beside the host
    loop's on the same batches (the publisher with the type held on the
    host), and their ratio. (B) a StandingFilterSet on the card with
    100,000 filters and one 1M-row dispatch, id-exact against evaluate
    on a 2,048-filter stride (the residual tenth kept in); register/s,
    the dispatch split into row prep, uploads, matching (the grid's
    build, the kernels and the copies to the host; its steps from a rerun
    on the card's clock) and the host patch; padded_cap and the residual
    fraction. (C) churn: 256 unregisters and registers within the cap,
    then another 1M-row dispatch: no new shape class, the device tables'
    storage unchanged, the grid rebuilt, the replaced filters id-exact.
    The standing kernels are held to their plain version on (B)'s first
    two chunks and timed at (B)'s shapes (standing_kernel_stats). Launch
    counts zeroed before the phase, read after: every standing kernel
    must have launched, and the launches line shows that no bitmap
    kernel or compaction ran. Returns the kernels' stats, the launch
    counts and the seconds."""
    from geomesa_tpu_torch import LiveDataStore
    from geomesa_tpu_torch.features.sft import parse_spec
    from geomesa_tpu_torch.filters import evaluate, parse_ecql
    from geomesa_tpu_torch.scan import kernels
    from geomesa_tpu_torch.scan.standing import StandingFilterSet
    from geomesa_tpu_torch.store.continuous import ContinuousQueryPublisher
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 15)
    nf, nbig = GEOFENCE_FILTERS, GEOFENCE_FILTERS_BIG
    ecqls = [geofence_ecql(rng, i) for i in range(max(nf, nbig))]
    parsed = [parse_ecql(e) for e in ecqls]
    sft = parse_spec("g15", GEOFENCE_SPEC)
    feed = [geofence_batch(rng, sft, GEOFENCE_ROWS, f"b{b}")
            for b in range(GEOFENCE_BATCHES)]
    warm = geofence_batch(rng, sft, GEOFENCE_ROWS, "warm")
    sample = list(range(0, nf, max(nf // GEOFENCE_PROBES, 1)))[
        :GEOFENCE_PROBES]
    kernels.reset_launches()

    def publisher_run(host: bool):
        store = LiveDataStore()
        store.create_schema(parse_spec("g15", GEOFENCE_SPEC))
        pub = ContinuousQueryPublisher(store)
        if host:
            # the type held on the host loop, as a type whose schema the
            # publisher could not read is
            pub._host_only.add("g15")
        t0 = time.perf_counter()
        for i in range(nf):
            pub.register(f"q{i}", "g15", ecqls[i])
        reg_s = time.perf_counter() - t0
        store.write("g15", warm)
        probe = {}
        for i in sample:
            got = probe[f"q{i}"] = []
            store.bus.subscribe(f"cq.q{i}", lambda m, g=got: g.extend(
                str(x) for x in m.batch.ids))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in feed:
            store.write("g15", b)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        stats = pub.device_stats()
        pub.close()
        return elapsed, reg_s, probe, stats

    dev_s, dev_reg_s, dev_probe, dev_stats = publisher_run(host=False)
    host_s, _, host_probe, _ = publisher_run(host=True)
    for i in sample:
        want = [str(x) for b in feed
                for x in b.ids[np.flatnonzero(evaluate(parsed[i], b))]]
        if dev_probe[f"q{i}"] != want or host_probe[f"q{i}"] != want:
            raise SystemExit(f"geofence (A): topic cq.q{i} published "
                             f"{len(dev_probe[f'q{i}'])} ids, evaluate "
                             f"{len(want)}")
    total = GEOFENCE_ROWS * GEOFENCE_BATCHES
    publisher = {"filters": nf, "register_per_s": nf / dev_reg_s,
                 "device_s": dev_s, "host_s": host_s,
                 "device_rows_per_s": total / dev_s,
                 "host_rows_per_s": total / host_s,
                 "ratio": host_s / dev_s, "topics_probed": len(sample),
                 "probed_ids": sum(map(len, dev_probe.values())),
                 "padded_cap": dev_stats[0]["padded_cap"]}
    emit({"phase": "geofence", "part": "publisher", **publisher})

    # (B) the bulk dispatch
    fset = StandingFilterSet(sft)
    t0 = time.perf_counter()
    for i in range(nbig):
        fset.register(f"q{i}", parsed[i])
    big_reg_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bulk = geofence_batch(rng, sft, GEOFENCE_BULK, "bulk")
    bulk_make_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hits = fset.dispatch(bulk)
    torch.cuda.synchronize()
    bulk_s = time.perf_counter() - t0
    split = dict(fset.last_split)
    st = fset.stats()
    check = list(range(0, nbig, max(nbig // GEOFENCE_ORACLE, 1)))
    t0 = time.perf_counter()
    bad = [i for i in check if not np.array_equal(
        hits[f"q{i}"], np.flatnonzero(evaluate(parsed[i], bulk)))]
    oracle_s = time.perf_counter() - t0
    if bad:
        raise SystemExit(f"geofence (B): {len(bad)} of {len(check)} filters "
                         f"differ from evaluate (first q{bad[0]})")
    counted = dict(kernels.launches)      # the comparisons do not count
    kstats = standing_kernel_stats(fset, bulk)
    # the matching stage's steps, from a rerun of its pipeline (CUDA
    # events, the host's launches included)
    split["match_steps_ms"] = kstats["dispatch"]["steps_ms"]
    cand = sum(len(v) for v in hits.values())
    bulk_line = {"filters": nbig, "register_per_s": nbig / big_reg_s,
                 "register_s": big_reg_s, "rows": GEOFENCE_BULK,
                 "batch_make_s": bulk_make_s, "dispatch_s": bulk_s,
                 "rows_per_s": GEOFENCE_BULK / bulk_s, "split_s": split,
                 "padded_cap": st["padded_cap"],
                 "residual_fraction": st["residual_fraction"],
                 "hits": cand, "oracle_filters": len(check),
                 "oracle_s": oracle_s, "id_exact": True,
                 "chunk": kstats["chunk"], "chunks": kstats["chunks"]}
    emit({"phase": "geofence", "part": "bulk", **bulk_line})
    emit({"phase": "geofence", "part": "standing", **kstats})

    # (C) churn within the cap
    misses = fset.cache_misses
    ptrs = [t.data_ptr() for t in fset.device_tables()]
    grid_before = fset._grid
    t0 = time.perf_counter()
    for i in range(GEOFENCE_CHURN):
        fset.unregister(f"q{i}")
        fset.register(f"q{i}r", parsed[i])
    churn_reg_s = time.perf_counter() - t0
    churn = geofence_batch(rng, sft, GEOFENCE_BULK, "churn")
    kernels.reset_launches()
    t0 = time.perf_counter()
    hits = fset.dispatch(churn)
    churn_s = time.perf_counter() - t0
    same_ptrs = [t.data_ptr() for t in fset.device_tables()] == ptrs
    rebuilt = fset._grid is not grid_before
    bad = [i for i in range(GEOFENCE_CHURN) if f"q{i}" in hits
           or not np.array_equal(hits[f"q{i}r"], np.flatnonzero(
               evaluate(parsed[i], churn)))]
    if fset.cache_misses != misses or not same_ptrs or not rebuilt or bad:
        raise SystemExit(f"geofence (C): misses {misses} -> "
                         f"{fset.cache_misses}, tables kept {same_ptrs}, "
                         f"grid rebuilt {rebuilt}, {len(bad)} replaced "
                         f"filters differ")
    launches = {k: v + counted[k] for k, v in kernels.launches.items()}
    missing = [k for k in STANDING_KERNELS if not launches[k]]
    if missing:
        raise SystemExit(f"geofence: {missing} never launched")
    seconds = time.perf_counter() - t_phase
    emit({"phase": "geofence", "part": "churn", "replaced": GEOFENCE_CHURN,
          "register_s": churn_reg_s, "dispatch_s": churn_s,
          "split_s": fset.last_split, "new_shape_classes": 0,
          "tables_kept": same_ptrs, "grid_rebuilt": rebuilt,
          "seconds": seconds,
          "card": card_line(),
          "launches": {k: launches[k] for k in STANDING_KERNELS + (
              "compact_prefix", "compact_bits", "scan_batch_bits")}})
    del fset, hits, bulk, churn
    torch.cuda.empty_cache()
    return kstats, launches, seconds


STREAM_IDS = 262_144        # vessels live worldwide at one time (AIS)
STREAM_MSG_ROWS = 8_192     # 32 messages of creates, then 32 of upserts
STREAM_COLLIDE = 1_000      # lambda: persisted ids written again
STREAM_TICKS, STREAM_TAIL_ROWS = 10, 100_000   # the tailed CSV feed
STREAM_UPSERT_SHARE = 0.5   # of the budget left after the creates
STREAM_QUERIES = [
    "BBOX(geom, -80, 30, -60, 45)",
    "BBOX(geom, 100, -10, 120, 10)",
    "BBOX(geom, -10, 35, 30, 60) AND "
    "dtg DURING 2016-08-01T00:00:00Z/2016-08-31T00:00:00Z",
    "speed BETWEEN 20 AND 20.5",
    "name LIKE 'vessel12%'",
    "BBOX(geom, 0, 0, 40, 40) OR BBOX(geom, -40, -40, 0, 0)",
    "dtg DURING 2016-09-01T00:00:00Z/2016-09-05T00:00:00Z AND speed > 25",
    "BBOX(geom, 140, 30, 150, 40) AND mmsi < 366001000",
]
STREAM_NORTH = ("BBOX(geom, -80, 30, -60, 45) AND "
                "dtg DURING 2016-08-07T00:00:00Z/2016-08-14T00:00:00Z",
                [(-80, 30, -60, 45)], (17_020 * MS_DAY, 17_027 * MS_DAY))


class _Watch:
    """A ContinuousQuerySubscriber consumed on a thread of its own: long
    polls until stopped, every create delta kept as (timestamp, ids,
    host time). A poll that outlives the bus's retry policy while the
    broker restarts (a refused or reset connection) is counted and
    polled again, as a consumer does: its offsets are the broker's, so
    the exactly-once gate still holds; any other error is kept and fails
    the phase."""

    def __init__(self, sub):
        import threading
        self.sub, self.got, self.errors, self.polls = sub, [], [], 0
        self.outages = 0
        self.stop = threading.Event()
        sub.on_message(lambda m: self.got.append(
            (m.timestamp_ms, [str(i) for i in m.batch.ids], time.time()))
            if m.kind == "create" else None)
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while not self.stop.is_set():
            try:
                self.sub.poll(wait_s=0.25)
                self.polls += 1
            except ConnectionError:
                self.outages += 1
                time.sleep(0.05)
            except Exception as e:   # noqa: BLE001 (kept for the gate)
                self.errors.append(repr(e))
                time.sleep(0.05)

    def close(self):
        self.stop.set()
        self.thread.join(timeout=10)
        self.sub.close()


def stream_rows(seed: int):
    """The live picture: STREAM_IDS vessels' creates (fs_rows' columns),
    and an upsert of each: the same vessels at new positions, times and
    speeds, in a shuffled order."""
    d = fs_rows(seed + 18, STREAM_IDS)
    d["ids"] = np.array([f"m{i}" for i in range(STREAM_IDS)], dtype=object)
    up = fs_rows(seed + 19, STREAM_IDS)
    perm = np.random.default_rng(seed + 20).permutation(STREAM_IDS)
    for k in ("ids", "vessel", "mmsi"):
        up[k] = d[k][perm]
    return d, up, perm


def phase_stream(seed: int, budget_s: float) -> tuple[dict, dict]:
    """The streaming tiers on the card at a live AIS picture's size:
    STREAM_IDS vessels, 32 messages of 8,192 creates, then 32 of upserts
    of the same ids (a maritime-awareness service keeping every vessel's
    last position live and pushing alerts).
    Live + CQ: a LiveDataStore on the card, a ContinuousQueryPublisher
    with STREAM_QUERIES publishing to a SocketBroker(root=...) on
    127.0.0.1, one ContinuousQuerySubscriber per query consuming on a
    thread of its own; after the creates the broker stops and restarts
    on its port and root, and the subscribers resume. Gates: every
    matching (message, id) arrives exactly once and equals evaluate over
    what was sent; the live store's north-star query (gathered and
    dense tiers) and query_count equal a float64 brute force over each
    id's latest version; expire with a ttl dropping the first half by
    arrival time drops that many. The upserts are cut (``cut``) once
    they would pass their share of the budget left.
    Lambda: a LambdaDataStore over a FileSystemDataStore on the card;
    persist moves the first half; STREAM_COLLIDE persisted ids are
    written again; the union query equals the brute force with the
    transient rows winning and the count is the ids'.
    Stream: a StreamDataStore on a FileTailSource that a writer grows
    with bench.py config 16's CSV, STREAM_TICKS ticks; its query equals
    the brute force over the lines written.
    Launch counts zeroed before the phase, read after: scan_mask or
    scan_mask_gather must launch (the live store, the file store's
    loads), and the standing kernels (the publisher)."""
    import shutil
    import tempfile

    from geomesa_tpu_torch import (FileSystemDataStore, FileTailSource,
                                   LambdaDataStore, LiveDataStore,
                                   SocketBroker, SocketBus, StreamDataStore)
    from geomesa_tpu_torch.features.sft import parse_spec
    from geomesa_tpu_torch.filters import evaluate, parse_ecql
    from geomesa_tpu_torch.scan import kernels
    from geomesa_tpu_torch.store.continuous import (
        ContinuousQueryPublisher, ContinuousQuerySubscriber)
    t_phase = time.perf_counter()
    d, up, perm = stream_rows(seed)
    sft = parse_spec("ais", FS_SPEC)
    n_msg = STREAM_IDS // STREAM_MSG_ROWS
    creates = [fs_batch(sft, d, i * STREAM_MSG_ROWS, (i + 1) * STREAM_MSG_ROWS)
               for i in range(n_msg)]
    upserts = [fs_batch(sft, up, i * STREAM_MSG_ROWS,
                        (i + 1) * STREAM_MSG_ROWS) for i in range(n_msg)]
    setup_s = time.perf_counter() - t_phase
    filters = [parse_ecql(q) for q in STREAM_QUERIES]
    base = int(time.time() * 1000) - 10 * 64_000
    roots = [tempfile.mkdtemp(prefix=p) for p in (
        "geomesa-stream-broker-", "geomesa-stream-lambda-",
        "geomesa-stream-tail-")]
    kernels.reset_launches()
    watches, pub_bus, broker = [], None, None
    out = {"phase": "stream", "ids": STREAM_IDS,
           "messages_rows": STREAM_MSG_ROWS, "setup_s": setup_s}
    try:
        broker = SocketBroker(root=roots[0]).start()
        port = broker.port
        # expire's ttl: the upserts' first half by arrival time
        live = LiveDataStore(ttl_millis=n_msg // 2 * 1000)
        live.create_schema(sft)
        pub_bus = SocketBus(broker.host, port, group="cq-pub", timeout_s=10.0)
        pub = ContinuousQueryPublisher(live, bus=pub_bus)
        for j, q in enumerate(STREAM_QUERIES):
            pub.register(f"s{j}", "ais", q)
        watches = [_Watch(ContinuousQuerySubscriber(
            f"s{j}", host=broker.host, port=port, group="watch",
            timeout_s=10.0)) for j in range(len(STREAM_QUERIES))]
        sent, sent_at = [], {}
        deletes = {"s": 0.0, "n": 0}
        real_delete = live._mem.delete

        def timed_delete(*a, **k):
            t0 = time.perf_counter()
            try:
                return real_delete(*a, **k)
            finally:
                deletes["s"] += time.perf_counter() - t0
                deletes["n"] += 1
        live._mem.delete = timed_delete

        def send(i, batch):
            ts = base + i * 1000
            sent.append((ts, batch))
            sent_at[ts] = time.time()
            live.write("ais", batch, timestamp_ms=ts)

        t0 = time.perf_counter()
        for i, b in enumerate(creates):
            send(i, b)
        create_s = time.perf_counter() - t0
        # the broker stops and restarts on its port and root
        polls = [w.polls for w in watches]
        t0 = time.perf_counter()
        broker.stop()
        broker = SocketBroker(port=port, root=roots[0]).start()
        deadline = time.monotonic() + 10.0
        while (any(w.polls <= p + 1 for w, p in zip(watches, polls))
               and time.monotonic() < deadline):
            time.sleep(0.01)
        resume_s = time.perf_counter() - t0
        left = budget_s - (time.perf_counter() - t_phase)
        fit = int(STREAM_UPSERT_SHARE * left / max(create_s / n_msg, 1e-3))
        n_up = min(n_msg, max(fit, 8))
        cut = None if n_up == n_msg else {"upsert_messages": n_up,
                                          "of": n_msg}
        deletes.update(s=0.0, n=0)
        t0 = time.perf_counter()
        for i, b in enumerate(upserts[:n_up]):
            send(n_msg + i, b)
        upsert_s = time.perf_counter() - t0
        live._mem.delete = real_delete
        # exactly once: each query's deltas against evaluate over the sent
        want = [sorted((ts, str(x)) for ts, b in sent
                       for x in b.ids[np.flatnonzero(evaluate(f, b))])
                for f in filters]
        deadline = time.monotonic() + 10.0
        while (any(sum(len(g[1]) for g in w.got) < len(wt)
                   for w, wt in zip(watches, want))
               and time.monotonic() < deadline):
            time.sleep(0.05)
        for w in watches:
            w.close()
        errors = [e for w in watches for e in w.errors]
        lat = []
        for j, (w, wt) in enumerate(zip(watches, want)):
            got = sorted((ts, x) for ts, xs, _ in w.got for x in xs)
            if got != wt:
                raise SystemExit(
                    f"stream: query s{j} received {len(got)} (message, id) "
                    f"pairs ({len(set(got))} distinct), evaluate "
                    f"{len(wt)}; {STREAM_QUERIES[j]!r}")
            lat += [(t - sent_at[ts]) * 1e3 for ts, _, t in w.got]
        # the live picture: each id's latest version
        latest = {k: d[k].copy() for k in ("x", "y", "ms")}
        moved = perm[:n_up * STREAM_MSG_ROWS]
        for k in latest:
            latest[k][moved] = up[k][:n_up * STREAM_MSG_ROWS]
        ecql, boxes, iv = STREAM_NORTH
        brute = _brute(latest["x"], latest["y"], latest["ms"], boxes, iv)
        want_ids = sorted(f"m{i}" for i in brute)
        for tier in ("gathered", "dense"):
            _fs_tier(tier)
            try:
                got_ids = sorted(str(i) for i in live.query(ecql, "ais").ids)
                count = live.query_count(ecql, "ais")
            finally:
                _fs_tier(None)
            if got_ids != want_ids or count != len(want_ids):
                raise SystemExit(f"stream: the live {tier} query gave "
                                 f"{len(got_ids)} ids ({count} counted), "
                                 f"the brute force {len(want_ids)}")
        # the upsert's id conversion (LiveDataStore._on_message's
        # astype(str) and isin) on the whole cache, one message's worth
        cache = live._mem._state("ais").batch.ids
        t0 = time.perf_counter()
        incoming = set(upserts[0].ids.astype(str))
        np.isin(cache.astype(str), list(incoming))
        conv_s = time.perf_counter() - t0
        # expire: arrivals before the cutoff, the upserts' first half (or
        # the creates the cut left)
        arrival = np.full(STREAM_IDS, 0, dtype=np.int64)
        for i in range(n_msg):
            arrival[i * STREAM_MSG_ROWS:(i + 1) * STREAM_MSG_ROWS] = \
                base + i * 1000
        for i in range(n_up):
            arrival[perm[i * STREAM_MSG_ROWS:(i + 1) * STREAM_MSG_ROWS]] = \
                base + (n_msg + i) * 1000
        live.ttl_millis = (n_up + 1) // 2 * 1000   # the upserts sent
        now = base + (n_msg + n_up) * 1000
        cutoff = now - live.ttl_millis
        dropped = live.expire("ais", now_ms=now)
        if (dropped != int((arrival < cutoff).sum())
                or live.count("ais") != int((arrival >= cutoff).sum())):
            raise SystemExit(f"stream: expire dropped {dropped}, the "
                             f"arrivals {int((arrival < cutoff).sum())}")
        out["live"] = {
            "creates_rows_per_s": STREAM_IDS / create_s,
            "create_s": create_s,
            "upserts_rows_per_s": n_up * STREAM_MSG_ROWS / upsert_s,
            "upsert_s": upsert_s, "upsert_deletes_s": deletes["s"],
            "id_conversion_s": conv_s, "id_conversion_cache_rows": len(cache),
            "cq_p50_ms": float(np.percentile(lat, 50)),
            "cq_p99_ms": float(np.percentile(lat, 99)),
            "cq_deltas": len(lat), "resume_s": resume_s,
            "pairs": [len(w) for w in want],
            "polls_past_retries": sum(w.outages for w in watches),
            "north_star_hits": len(want_ids), "expired": dropped,
            "cut": cut}
        if errors:
            raise SystemExit(f"stream: subscriber errors {errors[:3]}")
        pub.close()
        pub_bus.close()
        pub_bus = None
        del live
        emit({**out, "part": "live"})
        out["chaos"] = stream_chaos(seed, broker, n_msg)
        emit({"phase": "stream", "part": "chaos", **out["chaos"]})
        broker.stop()
        broker = None

        # lambda: a transient live tier over a file store on the card
        lam = LambdaDataStore(persistent=FileSystemDataStore(roots[1]),
                              persist_after_millis=60_000)
        lam.create_schema(sft)
        for i, b in enumerate(creates):
            lam.write("ais", b, timestamp_ms=base + i * 1000)
        half = n_msg // 2
        t0 = time.perf_counter()
        moved = lam.persist("ais", now_ms=base + half * 1000 + 60_000)
        persist_s = time.perf_counter() - t0
        rng = np.random.default_rng(seed + 21)
        coll = rng.choice(half * STREAM_MSG_ROWS, STREAM_COLLIDE,
                          replace=False)
        again = {k: d[k][coll] for k in ("ids", "vessel", "mmsi")}
        again["vocab"] = d["vocab"]
        newer = fs_rows(seed + 22, STREAM_COLLIDE)
        for k in ("ms", "x", "y", "speed", "course", "heading"):
            again[k] = newer[k]
        lam.write("ais", fs_batch(sft, again, 0, STREAM_COLLIDE),
                  timestamp_ms=base + n_msg * 1000)
        latest = {k: d[k].copy() for k in ("x", "y", "ms")}
        for k in latest:
            latest[k][coll] = newer[k]
        brute = _brute(latest["x"], latest["y"], latest["ms"], boxes, iv)
        want_ids = sorted(f"m{i}" for i in brute)
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            got_ids = sorted(str(i) for i in lam.query(ecql, "ais").ids)
            runs.append(time.perf_counter() - t0)
            if got_ids != want_ids:
                raise SystemExit(f"stream: the lambda union gave "
                                 f"{len(got_ids)} ids, the brute force "
                                 f"{len(want_ids)}")
        total = lam.count("ais")
        if moved != half * STREAM_MSG_ROWS or total != STREAM_IDS:
            raise SystemExit(f"stream: persist moved {moved}, the union "
                             f"counts {total}")
        out["lambda"] = {"persisted": moved, "persist_s": persist_s,
                         "collisions": STREAM_COLLIDE,
                         "union_p50_ms": statistics.median(runs) * 1e3,
                         "union_hits": len(want_ids), "count": total}
        lam.close()
        del lam
        emit({"phase": "stream", "part": "lambda", **out["lambda"]})

        # stream: a tailed CSV feed through the converter
        text, x, y, ms = convert_csv(seed + 23, STREAM_TAIL_ROWS)
        lines = text.splitlines(keepends=True)
        path = os.path.join(roots[2], "feed.csv")
        st = StreamDataStore(parse_spec("ais16", FS_SPEC), CONVERT_CSV,
                             FileTailSource(path))
        per = -(-len(lines) // STREAM_TICKS)
        ingested, tick_s = [], []
        for t in range(STREAM_TICKS):
            with open(path, "a") as f:
                f.write("".join(lines[t * per:(t + 1) * per]))
            t0 = time.perf_counter()
            ingested.append(st.tick())
            tick_s.append(time.perf_counter() - t0)
        week = [int(np.datetime64(f"2017-03-{dd:02d}", "ms").astype(np.int64))
                for dd in (5, 12)]
        want = _brute(x, y, ms, [(-80, 30, -60, 45)], week)
        res = st.query(CONVERT_QUERY, "ais16")
        got = np.sort(np.array([int(str(i)[1:]) for i in res.ids],
                               dtype=np.int64))
        if sum(ingested) != STREAM_TAIL_ROWS or not np.array_equal(got,
                                                                   want):
            raise SystemExit(f"stream: the tailed feed ingested "
                             f"{sum(ingested)} rows and answered "
                             f"{len(got)} ids, the brute force {len(want)}")
        out["stream"] = {"rows": STREAM_TAIL_ROWS, "ticks": STREAM_TICKS,
                         "rows_per_s": STREAM_TAIL_ROWS / sum(tick_s),
                         "tick_p50_s": statistics.median(tick_s),
                         "hits": len(want)}
    finally:
        for w in watches:
            if w.thread.is_alive():
                w.close()
        if pub_bus is not None:
            pub_bus.close()
        if broker is not None:
            broker.stop()
        for r in roots:
            shutil.rmtree(r, ignore_errors=True)
    launches = dict(kernels.launches)
    if not (launches["scan_mask"] + launches["scan_mask_gather"]
            and launches["standing_count"]):
        raise SystemExit(f"stream: the scan or standing kernels never "
                         f"launched ({launches})")
    out.update(seconds=time.perf_counter() - t_phase, card=card_line(),
               launches={k: launches[k] for k in (
                   "scan_mask", "scan_mask_gather", *STANDING_KERNELS,
                   "compact_bits")})
    emit({"phase": "stream", "part": "summary",
          **{k: out[k] for k in ("stream", "seconds", "card", "launches")}})
    torch.cuda.empty_cache()
    return launches, out


STREAM_CHAOS_ROWS = 4       # rows a create: a frame well under 4 KiB


def stream_chaos(seed: int, broker, n_msg: int) -> dict:
    """tests/test_resilience.py's publish-through-resets case at the
    stream phase's message count: ``n_msg`` creates of STREAM_CHAOS_ROWS
    rows (their own type) published by a SocketBus through
    ChaosProxy(reset_rate=1.0, seed=5) to the phase's broker, so every
    connection is reset within its first 4 KiB. Gates: resets counted;
    the broker's log holds every message once, in order; a
    LiveDataStore on the card consuming the log answers a BBOX query as
    the brute force over the rows sent."""
    from geomesa_tpu_torch import LiveDataStore, SocketBus
    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.features.sft import parse_spec
    from geomesa_tpu_torch.resilience import ChaosProxy, RetryPolicy
    from geomesa_tpu_torch.store.live import GeoMessage
    t0 = time.perf_counter()
    sft = parse_spec("ais_chaos", FS_SPEC)
    k = STREAM_CHAOS_ROWS
    d = fs_rows(seed + 24, n_msg * k)
    proxy = ChaosProxy(broker.host, broker.port, reset_rate=1.0,
                       seed=5).start()
    buses = []
    try:
        pub = SocketBus(proxy.host, proxy.port, group="chaos-pub",
                        retry_policy=RetryPolicy(
                            max_attempts=40, base_s=0.02, cap_s=0.25,
                            total_deadline_s=30.0))
        buses.append(pub)
        for i in range(n_msg):
            sl = slice(i * k, (i + 1) * k)
            b = FeatureBatch.from_dict(
                sft, [f"c{j}" for j in range(i * k, (i + 1) * k)],
                {"name": [str(v) for v in d["vocab"][d["vessel"][sl]]],
                 "mmsi": d["mmsi"][sl], "dtg": d["ms"][sl],
                 "speed": d["speed"][sl], "course": d["course"][sl],
                 "heading": d["heading"][sl],
                 "geom": (d["x"][sl], d["y"][sl])})
            pub.publish("ais_chaos", GeoMessage("create", "ais_chaos",
                                                batch=b,
                                                timestamp_ms=1000 + i))
        publish_s = time.perf_counter() - t0
        stats = dict(proxy.stats)
        log = SocketBus(broker.host, broker.port, group="chaos-log")
        buses.append(log)
        seen = []
        log.subscribe("ais_chaos", lambda m: seen.append(
            (m.timestamp_ms, [str(i) for i in m.batch.ids])))
        log.poll()
        bus = SocketBus(broker.host, broker.port, group="chaos-live")
        buses.append(bus)
        live = LiveDataStore(bus=bus)
        live.create_schema(sft)
        bus.poll()
        ecql = "BBOX(geom, -90, -45, 90, 45)"
        want = sorted(f"c{j}" for j in np.flatnonzero(
            _in_box(d["x"], d["y"], (-90, -45, 90, 45))))
        got = sorted(str(i) for i in live.query(ecql, "ais_chaos").ids)
        count = live.count("ais_chaos")
        del live
    finally:
        for b in buses:
            b.close()
        proxy.stop()
    want_log = [(1000 + i, [f"c{j}" for j in range(i * k, (i + 1) * k)])
                for i in range(n_msg)]
    out = {"messages": n_msg, "rows_each": k, "resets": stats["resets"],
           "connections": stats["connections"], "publish_s": publish_s,
           "log_exactly_once_in_order": seen == want_log,
           "live_hits": len(got), "live_equal": got == want,
           "live_count": count, "seconds": time.perf_counter() - t0}
    if not (stats["resets"] > 0 and seen == want_log and got == want
            and count == n_msg * k):
        raise SystemExit(f"stream: the chaos leg failed: {out}")
    return out


PLAIN_IDS = 100           # ids in the geometry-less phase's id query


def phase_plain(d: dict, ids) -> int:
    """A schema without a geometry: the predicates phase's GDELT-shaped
    attribute columns as an event table keyed by its attributes (the
    same rows, no geom), written through write(); an attr: query, an id
    query and a fullscan whose residual runs residual_mask, each id-exact
    against a numpy brute force, with its strategy and p50 of 3
    host-clock runs. Launch counts are zeroed before the queries and read
    after: residual_mask must launch."""
    from geomesa_tpu_torch import InMemoryDataStore
    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.features.sft import parse_spec
    from geomesa_tpu_torch.scan import kernels
    sft = parse_spec("events", PRED_SPEC.replace(",*geom:Point:srid=4326",
                                                 ""))
    full = predicate_batch(parse_spec("gdelt", PRED_SPEC), d, ids)
    batch = FeatureBatch(sft, ids, {a.name: full.col(a.name)
                                    for a in sft.attributes})
    del full
    ds = InMemoryDataStore()
    ds.create_schema(sft)
    t0 = time.perf_counter()
    ds.write("events", batch)
    write_s = time.perf_counter() - t0
    code = int(np.searchsorted(d["ev_vocab"], "190"))
    pick = np.random.default_rng(43).choice(len(ids), PLAIN_IDS,
                                            replace=False)
    in_ids = np.zeros(len(ids), dtype=bool)
    in_ids[pick] = True
    queries = [
        ("attr_equality", "EventCode = '190'", d["ev"] == code, "attr:"),
        ("id_in", "IN (" + ", ".join(f"'{i}'" for i in ids[pick]) + ")",
         in_ids, "id"),
        ("fullscan_residual", "AvgTone < -5 AND NumMentions >= 10",
         (d["tone"] < -5) & (d["mentions"] >= 10) & d["mentions_valid"],
         "fullscan"),
    ]
    kernels.reset_launches()
    out, wrong = [], []
    for name, ecql, mask, plan in queries:
        runs = []
        for _ in range(PRED_RUNS):
            t0 = time.perf_counter()
            res = ds.query(ecql, "events")
            res.ids
            runs.append((time.perf_counter() - t0) * 1e3)
        want = np.flatnonzero(mask)
        ok = (np.array_equal(res.rows, want)
              and np.array_equal(res.ids, ids[want])
              and ds.query_count(ecql, "events") == len(want)
              and res.plan.index.startswith(plan))
        if name == "fullscan_residual":
            ok = ok and "Device residual scan (dense)" in res.explain.text
        out.append({"query": name, "strategy": res.plan.index,
                    "hits": len(want), "exact": bool(ok),
                    "p50_ms": statistics.median(runs), "runs_ms": runs})
        if not ok:
            wrong.append(name)
    launches = kernels.launches["residual_mask"]
    ds.remove_schema("events")
    emit({"phase": "geometry_less", "rows": len(ids), "reduced": None,
          "write_s": write_s, "queries": out,
          "launches": {"residual_mask": launches}, "wrong": wrong})
    if wrong:
        raise SystemExit(f"geometry-less store: wrong results: {wrong}")
    if launches == 0:
        raise SystemExit("residual_mask never launched on the geometry-less "
                         "fullscan")
    return launches


def _ecql(boxes, iv) -> str:
    bb = " OR ".join(f"BBOX(geom, {x0!r}, {y0!r}, {x1!r}, {y1!r})"
                     for x0, y0, x1, y1 in boxes)
    if len(boxes) > 1:
        bb = f"({bb})"
    if iv is None:
        return bb
    lo, hi = (str(np.datetime64(v // 1000, "s")) + "Z" for v in iv)
    return f"{bb} AND dtg DURING {lo}/{hi}"


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def phase_batched(seed: int, ds, rows) -> dict:
    """The micro-batched serving path on the store phase's rows."""
    from geomesa_tpu_torch import Query
    from geomesa_tpu_torch.scan import kernels, zscan
    from geomesa_tpu_torch.scan.batcher import QueryBatcher
    x, y, ms, ids = rows
    specs = store_batch_specs(seed)
    ecqls = [_ecql(boxes, iv) for boxes, iv in specs]
    truth = [_brute(x, y, ms, boxes, iv) for boxes, iv in specs]
    scalar = [ds.query(e, "ais") for e in ecqls]   # also warms the planner
    for e, res, want in zip(ecqls, scalar, truth):
        if not np.array_equal(res.rows, want):
            raise SystemExit(f"scalar query() wrong for {e!r}")

    # every stacked batch that the store hands the device path while the
    # path is checked and while the batcher serves, to hold the kernels
    # against their plain versions at those shapes afterwards
    seen, prefixes = [], []
    device_path = zscan.batch_hit_rows
    prefix_kernel = kernels.compact_prefix

    def recording(data, bq):
        seen.append(bq)
        kernels.compact_prefix = prefix_recorder
        try:
            return device_path(data, bq)
        finally:
            kernels.compact_prefix = prefix_kernel

    def prefix_recorder(partials):   # each launch with what it returned
        out = prefix_kernel(partials)
        prefixes.append((partials, out))
        return out

    kernels.reset_launches()
    t_main = time.perf_counter()
    zscan.batch_hit_rows = recording
    sizes = {}
    try:
        for size in BATCH_SIZES:
            chunks = [list(range(i, i + size))
                      for i in range(0, len(ecqls), size)]
            for chunk in chunks:
                res = ds.query_batched([Query("ais", ecqls[i])
                                        for i in chunk])
                for i, r in zip(chunk, res):
                    if not (np.array_equal(r.rows, truth[i])
                            and np.array_equal(r.ids, scalar[i].ids)):
                        raise SystemExit(f"query_batched wrong for "
                                         f"{ecqls[i]!r} at batch size {size}")
                    if "Fused device scan" not in r.explain.text:
                        raise SystemExit(f"{ecqls[i]!r} did not take the "
                                         f"fused path at batch size {size}")
            zscan.batch_hit_rows = device_path
            batched, seq = [], []
            for _ in range(3):
                for chunk in chunks:
                    qs = [Query("ais", ecqls[i]) for i in chunk]
                    batched.append(_timed(lambda: [
                        r.ids for r in ds.query_batched(qs)]))
                    seq.append(_timed(lambda: [ds.query(q).ids
                                               for q in qs]))
            sizes[size] = {"calls": len(batched),
                           "batched_p50_ms": statistics.median(batched),
                           "sequential_p50_ms": statistics.median(seq)}
            zscan.batch_hit_rows = recording
        batcher_runs = {"default": run_batcher(QueryBatcher(ds), ecqls,
                                               truth)}
    finally:
        zscan.batch_hit_rows = device_path
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    counts = dict(kernels.launches)

    # outside the counted run: both kernels against their plain versions
    # on every batch the path ran, at its own (Q, K, B) over the store's
    # columns
    st = ds._types["ais"]
    data = st.scan_data
    shapes = sorted({(bq.n_queries, bq.boxes_np.shape[1], bq.times_np.shape[1])
                     for bq in seen})
    wrong = [bq.n_queries for bq in seen if not check_batch(data, bq)]
    # every compact_prefix launch of the path, its own outputs against
    # the plain version of its partials
    prefix_wrong = [tuple(parts.shape) for parts, got in prefixes
                    if not all(torch.equal(g, w) for g, w in zip(
                        got, kernels.compact_prefix_plain(parts)))]
    checked = {"batches": len(seen), "shapes": shapes, "wrong": wrong,
               "prefix_launches": len(prefixes), "prefix_wrong": prefix_wrong}
    del prefixes

    # the same callers with a static 200 ms linger
    batcher_runs["linger_200ms_static"] = run_batcher(
        QueryBatcher(ds, linger_us=200_000, adaptive=False), ecqls, truth)

    # where one call of 32 queries spends its time: the device path
    # alone (both kernels, the sync, the ids' copy to the host), the
    # gather of the result ids from the id column as query_batched does
    # it, and a cProfile of the call
    qs = [Query("ais", e) for e in ecqls]
    bq = store_batch(specs)
    res = ds.query_batched(qs)
    breakdown = {
        "call_ms": statistics.median(
            _timed(lambda: [r.ids for r in ds.query_batched(qs)])
            for _ in range(5)),
        "batch_hit_rows_ms": statistics.median(
            _timed(lambda: zscan.batch_hit_rows(data, bq)) for _ in range(5)),
        "id_gather_ms": statistics.median(
            _timed(lambda: [st.batch.ids[r.rows] for r in res])
            for _ in range(5)),
        "ids": sum(r.n for r in res),
        "profile": profile_top(lambda: ds.query_batched(qs)),
    }
    # the batched kernels at this phase's own shape (the store's
    # columns, the 32-query batch), beside their bounds
    kernels_32 = batch_stats(data, bq, plain=False)
    emit({"phase": "batched", "rows": len(x), "queries": len(ecqls),
          "hits": [len(w) for w in truth], "sizes": sizes,
          "batcher": batcher_runs, "checked": checked,
          "breakdown_32": breakdown, "kernels_32": kernels_32,
          "launches": counts, "seconds": main_s})
    bad = [k for k, v in kernels_32.items() if v["max_abs_err"]]
    if wrong or not seen or bad or prefix_wrong or not checked[
            "prefix_launches"]:
        raise SystemExit(f"batched kernels disagree with their plain "
                         f"versions on the batched path: {checked} {bad}")
    bad = {k: r["errors"] for k, r in batcher_runs.items() if r["errors"]}
    if bad:
        raise SystemExit(f"QueryBatcher results wrong: {bad}")
    missing = [k for k in ("scan_batch_bits", "compact_prefix",
                           "compact_bits") if counts[k] == 0]
    if missing:
        raise SystemExit(f"kernels never launched on the batched path: "
                         f"{missing}")
    return counts


SERVING_TENANTS = {"gold": 4, "silver": 2, "bronze": 1}   # DWRR weights
SERVING_RUNS = 3          # runs of the load at defaults and with planes on
NORTH_RUNS = 21           # host-clock runs of the north-star query()


def serving_load(batcher, ecqls, scoped: bool) -> dict:
    """BATCHER_THREADS callers x BATCHER_PER_THREAD queries through
    ``batcher``; caller t runs as tenant t % 3 with principal
    "user-<tenant>" when ``scoped``. Returns the results by (t, j), each
    call's host-clock ms, the wall seconds and any errors."""
    import threading
    from geomesa_tpu_torch.audit import principal_scope
    from geomesa_tpu_torch.tenants import tenant_scope
    names = list(SERVING_TENANTS)
    results, lat, errors = {}, [], []

    def caller(t):
        tenant = names[t % len(names)]
        try:
            with tenant_scope(tenant if scoped else None), \
                    principal_scope(f"user-{tenant}" if scoped else None):
                for j in range(BATCHER_PER_THREAD):
                    i = (t * BATCHER_PER_THREAD + j) % len(ecqls)
                    t0 = time.perf_counter()
                    r = batcher.query(ecqls[i], "ais")
                    r.ids
                    lat.append((time.perf_counter() - t0) * 1e3)
                    results[t, j] = (i, tenant, r)
        except Exception as e:  # noqa: BLE001 - reported by the caller
            errors.append(repr(e))
    threads = [threading.Thread(target=caller, args=(t,))
               for t in range(BATCHER_THREADS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(600.0)
    wall = time.perf_counter() - t0
    if any(th.is_alive() for th in threads):
        errors.append("a caller did not finish in 600 s")
    return {"results": results, "lat_ms": lat, "seconds": wall,
            "errors": errors}


class _Planes:
    """Every serving plane on for a block (trace sampling 1, QoS with
    SERVING_TENANTS' weights, ``audit`` as the store's logger, the
    profiler at 19 Hz); the defaults restored after, also on error."""

    def __init__(self, ds, audit):
        from geomesa_tpu_torch.obs.prof import PROF_HZ
        from geomesa_tpu_torch.obs.trace import TRACE_SAMPLE
        from geomesa_tpu_torch.tenants import QOS_ENABLED
        from geomesa_tpu_torch.utils.properties import SystemProperty
        self.ds, self.audit = ds, audit
        self.props = [(TRACE_SAMPLE, "1"), (QOS_ENABLED, "true"),
                      (PROF_HZ, "19")] + [
            (SystemProperty(f"geomesa.qos.tenant.{t}.weight"), str(w))
            for t, w in SERVING_TENANTS.items()]

    def __enter__(self):
        from geomesa_tpu_torch.obs import profiler
        for p, v in self.props:
            p.set(v)
        self.ds.audit = self.audit
        profiler.start()
        return self

    def __exit__(self, *exc):
        from geomesa_tpu_torch.obs import profiler
        profiler.stop()
        self.ds.audit = None
        for p, _ in self.props:
            p.set(None)


def phase_serving(seed: int, ds, rows) -> dict:
    """The serving planes on the batched phase's store and queries (see
    the module's head): hard gates, timeouts, then the planes' cost."""
    import tempfile
    from geomesa_tpu_torch import Query
    from geomesa_tpu_torch.audit import AuditLogger
    from geomesa_tpu_torch.metrics import metrics
    from geomesa_tpu_torch.obs import profiler, runtime, tracer
    from geomesa_tpu_torch.scan import kernels, zscan
    from geomesa_tpu_torch.scan.registry import (batcher_registry,
                                                 shared_batcher)
    from geomesa_tpu_torch.utils.threads import QueryTimeout
    x, y, ms, ids = rows
    specs = store_batch_specs(seed)
    ecqls = [_ecql(boxes, iv) for boxes, iv in specs]
    truth = [_brute(x, y, ms, boxes, iv) for boxes, iv in specs]
    filters = [str(Query("ais", e).filter) for e in ecqls]
    batcher = shared_batcher(ds)
    if shared_batcher(ds) is not batcher:
        raise SystemExit("shared_batcher gave two batchers for one store")
    tmp = tempfile.mkdtemp(prefix="serving-")
    audit_path = os.path.join(tmp, "audit.jsonl")
    audit = AuditLogger(path=audit_path)

    # the counted run with every plane on; each stacked batch recorded
    seen = []
    device_path = zscan.batch_hit_rows

    def recording(data, bq):
        seen.append(bq)
        return device_path(data, bq)
    tracer.clear()
    before = metrics.snapshot()["counters"]
    rt0 = runtime.snapshot()["compile"].get("batcher", {})
    kernels.reset_launches()
    t_main = time.perf_counter()
    zscan.batch_hit_rows = recording
    try:
        with _Planes(ds, audit):
            run = serving_load(batcher, ecqls, scoped=True)
            torch.cuda.synchronize()
            runtime.sample_device_memory()
            allocated = torch.cuda.memory_allocated()
            sampled = runtime.snapshot()["device_memory"]
            prof_stats = profiler.stats()
    finally:
        zscan.batch_hit_rows = device_path
    main_s = time.perf_counter() - t_main
    counts = dict(kernels.launches)
    after = metrics.snapshot()["counters"]
    rt1 = runtime.snapshot()["compile"].get("batcher", {})
    traces = tracer.traces(limit=10_000)
    prom = metrics.prometheus_text()
    tracer.clear()

    errors = list(run["errors"])
    n_q = BATCHER_THREADS * BATCHER_PER_THREAD
    if len(run["results"]) != n_q:
        errors.append(f"{len(run['results'])} results of {n_q}")
    want_events = []
    for i, tenant, r in run["results"].values():
        if not np.array_equal(r.rows, truth[i]):
            errors.append(f"wrong ids for query {i}")
        fused = "Fused device scan" in r.explain.text
        want_events.append((filters[i], f"user-{tenant}", tenant, r.n, fused))
    events = audit.query("ais")
    got_events = [(e.filter, e.user, e.tenant, e.hits, e.batched)
                  for e in events]
    with open(audit_path) as fh:
        jsonl = len(fh.read().splitlines())
    if sorted(got_events) != sorted(want_events) or jsonl != n_q:
        errors.append(f"audit: {len(events)} events, {jsonl} lines; "
                      f"equal to the queries: "
                      f"{sorted(got_events) == sorted(want_events)}")
    if any(e.index not in ("z3", "z2") for e in events):
        errors.append("an audit record without its z-index")
    no_subtree = [t["trace_id"] for t in traces
                  if not {"batcher-wait", "dispatch",
                          "store-scan"} <= set(t["kinds"])]
    if len(traces) != n_q or no_subtree:
        errors.append(f"{len(traces)} traces, {len(no_subtree)} without "
                      f"their dispatch subtree")
    drained = {k: after[k] - before.get(k, 0) for k in after
               if k.startswith("qos.admission.dispatched")}
    if sum(drained.values()) != n_q:
        errors.append(f"drained by tenant {drained}")
    classes = {c: {"hits": v["hits"] - rt0.get(c, {}).get("hits", 0),
                   "misses": v["misses"] - rt0.get(c, {}).get("misses", 0)}
               for c, v in rt1.items()}
    classes = {c: v for c, v in classes.items() if v["hits"] + v["misses"]}
    fused = sum(v["hits"] + v["misses"] for v in classes.values())
    # the shared batcher's table is new: each class misses at its first
    # fused dispatch and hits at every later one
    if not classes or any(v["misses"] != 1 for v in classes.values()) \
            or (fused > len(classes)
                and not any(v["hits"] for v in classes.values())):
        errors.append(f"runtime.compile batcher classes {classes}")
    dev = sampled["devices"].get(f"cuda:{torch.cuda.current_device()}", {})
    in_use = dev.get("bytes_in_use", 0)
    if not in_use or abs(in_use - allocated) > 0.01 * allocated \
            or not sampled["live_bytes"] or not sampled["live_buffers"]:
        errors.append(f"device sample {dev} against memory_allocated "
                      f"{allocated}")
    series = ["geomesa_store_scan_seconds", "geomesa_batcher_queries_total",
              "geomesa_runtime_compile_total",
              "geomesa_runtime_dispatch_seconds",
              "geomesa_runtime_device_bytes"]
    missing_series = [m for m in series if m not in prom]
    if missing_series:
        errors.append(f"prometheus text lacks {missing_series}")

    # timeouts: the reaper's deadline at the store's stage boundaries
    q = Query("ais", ecqls[0], hints={"TIMEOUT": 1e-9})
    try:
        ds.query(q)
        errors.append("TIMEOUT 1e-9 s answered")
    except QueryTimeout:
        pass
    ok60 = ds.query(Query("ais", ecqls[0], hints={"TIMEOUT": 60}))
    if not np.array_equal(ok60.rows, truth[0]):
        errors.append("TIMEOUT 60 s: wrong ids")

    # outside the counted run: the batched kernels against their plain
    # versions on every batch the load ran
    data = ds._types["ais"].scan_data
    wrong = [bq.n_queries for bq in seen if not check_batch(data, bq)]

    # the planes' cost: the same load at defaults and with every plane
    # on, alternated (the batcher and its plan table already warm)
    cost = {"defaults": [], "planes_on": []}
    for k in range(2 * SERVING_RUNS):
        mode = ("defaults", "planes_on")[k % 2]
        if mode == "defaults":
            r = serving_load(batcher, ecqls, scoped=True)
        else:
            with _Planes(ds, AuditLogger(path=audit_path)):
                r = serving_load(batcher, ecqls, scoped=True)
            tracer.clear()
        errors += r["errors"]
        cost[mode].append({"queries_per_s": len(r["results"]) / r["seconds"],
                           "p50_ms": statistics.median(r["lat_ms"])})
    spread = {m: {k: [min(v[k] for v in runs), max(v[k] for v in runs)]
                  for k in ("queries_per_s", "p50_ms")}
              for m, runs in cost.items()}
    north = STORE_QUERIES[0][0]
    north_ms = [_timed(lambda: ds.query(north, "ais").ids)
                for _ in range(NORTH_RUNS)]
    shutil.rmtree(tmp, ignore_errors=True)
    batcher_registry.clear()     # the registry must not pin the store
    emit({"phase": "serving", "rows": len(x), "queries": n_q,
          "seconds": main_s, "errors": errors[:5],
          "audit_events": len(events), "traces": len(traces),
          "drained": drained, "batcher_classes": classes,
          "fused_dispatches": fused,
          "device_sample": dev, "memory_allocated": allocated,
          "profiler": prof_stats, "checked_batches": len(seen),
          "wrong_batches": wrong, "cost": cost, "spread": spread,
          "north_star_p50_ms": statistics.median(north_ms),
          "launches": counts, "card": card_line()})
    if errors:
        raise SystemExit(f"serving planes: {errors[:5]}")
    if wrong or not seen:
        raise SystemExit(f"batched kernels disagree with their plain "
                         f"versions on the serving path: {wrong}")
    missing = [k for k in ("scan_batch_bits", "compact_prefix",
                           "compact_bits") if counts[k] == 0]
    if missing:
        raise SystemExit(f"kernels never launched on the serving path: "
                         f"{missing}")
    return counts


def runtime_summary() -> dict:
    """The runtime plane's domains (batcher, knn, standing, join) with
    their probe and dispatch counts over the whole run."""
    from geomesa_tpu_torch.obs import runtime
    snap = runtime.snapshot()
    out = {}
    for domain in ("batcher", "knn", "standing", "join"):
        comp = snap["compile"].get(domain, {})
        disp = snap["dispatch"].get(domain, {})
        out[domain] = {
            "classes": len(set(comp) | set(disp)),
            "misses": sum(v["misses"] for v in comp.values()),
            "hits": sum(v["hits"] for v in comp.values()),
            "dispatches": sum(v["count"] for v in disp.values()),
            "dispatch_ms": sum(v["total_ms"] for v in disp.values())}
    return out


def profile_top(fn, top: int = 12) -> list:
    """cProfile of one fn() call: the ``top`` functions by own time,
    as [where, own ms, cumulative ms, calls]."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    rows = sorted(pstats.Stats(prof).stats.items(),
                  key=lambda kv: kv[1][2], reverse=True)[:top]
    return [[f"{os.path.basename(f)}:{line}({name})", tt * 1e3, ct * 1e3, nc]
            for (f, line, name), (_cc, nc, tt, ct, _callers) in rows]


def run_batcher(batcher, ecqls, truth) -> dict:
    """BATCHER_THREADS callers each submitting BATCHER_PER_THREAD of the
    queries through ``batcher``; every result checked against the brute
    force."""
    import threading
    results, errors = {}, []

    def caller(t):
        try:
            for j in range(BATCHER_PER_THREAD):
                i = (t * BATCHER_PER_THREAD + j) % len(ecqls)
                r = batcher.query(ecqls[i], "ais")
                r.ids   # the ids on the host inside the timed run
                results[t, j] = (i, r)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))
    threads = [threading.Thread(target=caller, args=(t,))
               for t in range(BATCHER_THREADS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    errors += [f"wrong ids for query {i}" for (i, r) in results.values()
               if not np.array_equal(r.rows, truth[i])]
    if len(results) != BATCHER_THREADS * BATCHER_PER_THREAD:
        errors.append(f"{len(results)} results")
    st = batcher.stats()
    return {"threads": BATCHER_THREADS, "per_thread": BATCHER_PER_THREAD,
            "seconds": wall, "queries_per_s": len(results) / wall,
            "coalesce_ratio": st["coalesce_ratio"], "batches": st["batches"],
            "stats": st, "errors": errors[:3]}


# -- the predicates phase ----------------------------------------------------

PRED_SPEC = ("EventCode:String:index=true,Actor1CountryCode:String,"
             "NumMentions:Integer,AvgTone:Double,IsRootEvent:Boolean,"
             "dtg:Date,*geom:Point:srid=4326")
TONE_T = -5.123456789     # AvgTone threshold; its f64 neighbours are data
PRED_RUNS = 3             # host-clock runs per query for its p50


def event_codes() -> np.ndarray:
    """320 CAMEO-like event codes: 20 roots, each with its base code,
    nine 3-digit and six 4-digit refinements, sorted."""
    out = []
    for r in range(1, 21):
        out += [f"{r:02d}{k}" for k in range(10)]
        out += [f"{r:02d}{k}{m}" for k in (1, 2) for m in (1, 2, 3)]
    return np.array(sorted(out))


def country_codes(rng) -> np.ndarray:
    """250 three-letter country codes, sorted, with a few real ones."""
    real = {"USA", "GBR", "CHN", "RUS", "UKR", "UGA", "URY", "UZB", "FRA"}
    letters = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"))
    out = set(real)
    while len(out) < 250:
        out.add("".join(rng.choice(letters, 3)))
    return np.array(sorted(out))


def star_ring(cx, cy, rx, ry, n, k=0, wobble=0.0, phase=0.0):
    """A counter-clockwise ring of n vertices, star-shaped about (cx,
    cy): radius (rx, ry) * (1 + wobble sin(k t + phase)) at parameter
    angles t in (-pi, pi)."""
    t = -np.pi + (np.arange(n) + 0.5) * (2 * np.pi / n)
    r = 1 + wobble * np.sin(k * t + phase)
    return np.c_[cx + rx * r * np.cos(t), cy + ry * r * np.sin(t)]


def _ring_wkt(ring) -> str:
    closed = np.vstack([ring, ring[:1]])
    return "(" + ", ".join(f"{float(x)!r} {float(y)!r}" for x, y in closed) + ")"


PRED_SHELL = star_ring(10.0, 0.0, 95.0, 60.0, 300, k=7, wobble=0.15, phase=0.3)
PRED_HOLE = star_ring(20.0, 10.0, 20.0, 20.0, 40)
PRED_PARTS = [star_ring(-95.0, 0.0, 70.0, 55.0, 64, k=5, wobble=0.1),
              star_ring(95.0, 5.0, 70.0, 55.0, 64, k=4, wobble=0.1, phase=1.0)]
PRED_SMALL = star_ring(120.0, -20.0, 15.0, 15.0, 24, k=3, wobble=0.2)
PRED_POLYGON = f"POLYGON({_ring_wkt(PRED_SHELL)}, {_ring_wkt(PRED_HOLE)})"
PRED_DURING = (T0_DAY + 5, T0_DAY + 95)   # days, exclusive
PRED_ATTR_FILTER = ("AvgTone < -5 AND NumMentions >= 10 AND "
                    "Actor1CountryCode LIKE 'U%'")
PRED_BAND_FILTER = (f"AvgTone = {TONE_T!r} OR NOT (Actor1CountryCode IN "
                    f"('USA', 'GBR', 'CHN', 'RUS'))")


def in_star(x, y, ring, cx, cy, rx, ry) -> np.ndarray:
    """Float64 brute force of a point in a ring star-shaped about (cx,
    cy), boundary included: the ray from the centre to the point crosses
    the edge of the point's angular sector, and the point lies on the
    centre's side of that edge or on it (the orientation sign of the
    edge and the point in f64)."""
    ang = np.arctan2((ring[:, 1] - cy) / ry, (ring[:, 0] - cx) / rx)
    phi = np.arctan2((y - cy) / ry, (x - cx) / rx)
    i = np.searchsorted(ang, phi, side="right") - 1   # -1: the wrap edge
    x0, y0 = ring[i, 0], ring[i, 1]
    j = (i + 1) % len(ring)
    x1, y1 = ring[j, 0], ring[j, 1]
    return (x1 - x0) * (y - y0) - (y1 - y0) * (x - x0) >= 0


def _in_box(x, y, box):
    return (x >= box[0]) & (x <= box[2]) & (y >= box[1]) & (y <= box[3])


def _env(ring):
    return (ring[:, 0].min(), ring[:, 1].min(), ring[:, 0].max(),
            ring[:, 1].max())


def predicate_data(seed: int, rows: int) -> dict:
    """The GDELT-shaped columns from ``seed``: strings as sorted vocab +
    int32 codes (-1 null), numbers with validity, points and dates."""
    rng = np.random.default_rng(seed + 5)
    ev_vocab = event_codes()
    rank = rng.permutation(len(ev_vocab))     # frequency rank -> code
    ev = rank[np.minimum(rng.zipf(1.4, rows) - 1,
                         len(ev_vocab) - 1)].astype(np.int32)
    ac_vocab = country_codes(rng)
    ac = np.minimum(rng.zipf(1.2, rows) - 1, len(ac_vocab) - 1)
    ac = rng.permutation(len(ac_vocab))[ac].astype(np.int32)
    ac[rng.random(rows) < 0.15] = -1
    mentions = (np.floor(rng.pareto(1.1, rows) * 3) + 1).astype(np.int64)
    mentions_valid = rng.random(rows) >= 0.001
    tone = rng.uniform(-10.0, 10.0, rows)
    tone = np.where(rng.random(rows) < 0.2, np.round(tone, 1), tone)
    near = np.flatnonzero(rng.random(rows) < 0.002)
    tone[near] = TONE_T + rng.integers(-8, 9, len(near)) * np.spacing(TONE_T)
    return {"ev": ev, "ev_vocab": ev_vocab, "ac": ac, "ac_vocab": ac_vocab,
            "mentions": mentions, "mentions_valid": mentions_valid,
            "tone": tone, "root": rng.random(rows) < 0.4,
            "ms": rng.integers(T0_DAY * MS_DAY, T1_DAY * MS_DAY, rows),
            "x": rng.uniform(-180, 180, rows),
            "y": rng.uniform(-90, 90, rows)}


def predicate_batch(sft, d: dict, ids):
    """The store's batch from ``predicate_data``'s columns (the string
    columns from their vocabularies and codes, no Python strings)."""
    from geomesa_tpu_torch.features.batch import (BoolColumn, DateColumn,
                                                  FeatureBatch, NumericColumn,
                                                  PointColumn, StringColumn)
    n = len(d["x"])
    ones = np.ones(n, dtype=bool)
    return FeatureBatch(sft, ids, {
        "EventCode": StringColumn("EventCode", d["ev"],
                                  d["ev_vocab"].astype(object)),
        "Actor1CountryCode": StringColumn("Actor1CountryCode", d["ac"],
                                          d["ac_vocab"].astype(object)),
        "NumMentions": NumericColumn("NumMentions", d["mentions"],
                                     d["mentions_valid"]),
        "AvgTone": NumericColumn("AvgTone", d["tone"], ones),
        "IsRootEvent": BoolColumn("IsRootEvent", d["root"], ones),
        "dtg": DateColumn("dtg", d["ms"], ones),
        "geom": PointColumn("geom", d["x"], d["y"], ones)})


def _iso(day: int) -> str:
    return str(np.datetime64(day, "D")) + "T00:00:00Z"


def predicate_queries(d: dict, ids) -> list:
    """The phase's eight queries as (name, ecql, brute-force mask): each
    mask in float64 / int64 numpy over the raw columns."""
    x, y, ms = d["x"], d["y"], d["ms"]
    ev, ac = d["ev"], d["ac"]
    ev_vocab, ac_vocab = d["ev_vocab"], d["ac_vocab"]

    def during(lo_day, hi_day):
        return (ms > lo_day * MS_DAY) & (ms < hi_day * MS_DAY)

    def star(ring, cx, cy, rx, ry):
        box = _env(ring)
        inside = np.zeros(len(x), dtype=bool)
        sel = np.flatnonzero(_in_box(x, y, box))
        inside[sel] = in_star(x[sel], y[sel], ring, cx, cy, rx, ry)
        return inside

    shell = star(PRED_SHELL, 10.0, 0.0, 95.0, 60.0)
    hole = star(PRED_HOLE, 20.0, 10.0, 20.0, 20.0)
    # a point on the hole's boundary stays in: the strict interior goes
    hole_strict = hole & ~_on_ring(x, y, PRED_HOLE, hole)
    q1 = shell & ~hole_strict & during(*PRED_DURING)
    parts = (star(PRED_PARTS[0], -95.0, 0.0, 70.0, 55.0)
             | star(PRED_PARTS[1], 95.0, 5.0, 70.0, 55.0))
    like_u = np.char.startswith(ac_vocab, "U")
    q3 = ((d["tone"] < -5) & (d["mentions"] >= 10) & d["mentions_valid"]
          & (ac >= 0) & like_u[np.maximum(ac, 0)])
    big4 = np.isin(ac_vocab, ["USA", "GBR", "CHN", "RUS"])
    q4 = (_in_box(x, y, (-179, -89, 179, 89)) & during(T0_DAY + 1,
                                                       T0_DAY + 99)
          & ((d["tone"] == TONE_T) | ~((ac >= 0) & big4[np.maximum(ac, 0)])))
    # an equality on a code of middling frequency; a range >= the code
    # at the lexicographic median of the rows
    counts = np.bincount(ev, minlength=len(ev_vocab))
    order = np.argsort(-counts)
    eq_code = ev_vocab[order[10]]
    ge_code = ev_vocab[np.searchsorted(np.cumsum(counts), len(ev) // 2)]
    q5 = (ev_vocab[ev] == eq_code) & during(T0_DAY + 10, T0_DAY + 40)
    q6 = ev_vocab[ev] >= ge_code
    fid_rows = np.random.default_rng(99).choice(len(x), 1000, replace=False)
    q7 = np.zeros(len(x), dtype=bool)
    q7[fid_rows] = True
    small_box = (100.0, -40.0, 140.0, 0.0)
    q8 = _in_box(x, y, small_box) & ~star(PRED_SMALL, 120.0, -20.0, 15.0,
                                          15.0)
    multi = ("MULTIPOLYGON(" + ", ".join(f"({_ring_wkt(p)})"
                                         for p in PRED_PARTS) + ")")
    fids = ", ".join(f"'{ids[i]}'" for i in fid_rows)
    return [
        ("polygon_hole_during",
         f"INTERSECTS(geom, {PRED_POLYGON}) AND dtg DURING "
         f"{_iso(PRED_DURING[0])}/{_iso(PRED_DURING[1])}", q1),
        ("multipolygon_within", f"WITHIN(geom, {multi})", parts),
        ("attributes_fullscan", PRED_ATTR_FILTER, q3),
        ("dense_secondary_band",
         f"BBOX(geom, -179, -89, 179, 89) AND dtg DURING "
         f"{_iso(T0_DAY + 1)}/{_iso(T0_DAY + 99)} AND ({PRED_BAND_FILTER})",
         q4),
        ("attr_equality_during",
         f"EventCode = '{eq_code}' AND dtg DURING "
         f"{_iso(T0_DAY + 10)}/{_iso(T0_DAY + 40)}", q5),
        ("attr_wide_range", f"EventCode >= '{ge_code}'", q6),
        ("fid_in_1000", f"IN ({fids})", q7),
        ("bbox_disjoint",
         f"BBOX(geom, {small_box[0]}, {small_box[1]}, {small_box[2]}, "
         f"{small_box[3]}) AND DISJOINT(geom, POLYGON({_ring_wkt(PRED_SMALL)}))",
         q8),
    ]


def _on_ring(x, y, ring, cand):
    """Exactly on one of the ring's edges (f64 orientation zero within
    the edge's box), over the rows ``cand`` only."""
    out = np.zeros(len(x), dtype=bool)
    sel = np.flatnonzero(cand)
    if not len(sel):
        return out
    px, py = x[sel], y[sel]
    hit = np.zeros(len(sel), dtype=bool)
    for a, b in zip(ring, np.roll(ring, -1, axis=0)):
        cross = (b[0] - a[0]) * (py - a[1]) - (b[1] - a[1]) * (px - a[0])
        hit |= ((cross == 0) & (px >= min(a[0], b[0]))
                & (px <= max(a[0], b[0])) & (py >= min(a[1], b[1]))
                & (py <= max(a[1], b[1])))
    out[sel] = hit
    return out


def _strategy(res) -> str:
    text = res.explain.text
    notes = [k for k, line in (
        ("pip_kernel", "Device point-in-polygon residual"),
        ("residual_dense", "Device residual scan (dense)"),
        ("attr_too_wide", "Attribute bounds too wide"),
        ("attr_index_scan", "Attribute index scan"),
        ("device_scan", "Device scan:"),
        ("gathered_scan", "Index-pruned device scan"),
        ("host_scan", "Index-pruned host scan")) if line in text]
    return "+".join([res.plan.index] + notes)


# pip_mask's operations, each add, subtract, multiply, division, compare,
# select or xor counted as one at the f32 rate, as csrc/geom.cu's note
# counts what these inputs need: per point its slab (four); per pair
# within the y reach the y test's two, the span test's three, the x
# reach's two and the crossing's two; per pair inside the expanded box
# the full path's 21, five more where the edge spans the point's y; per
# edge the prologue's 29
PIP_OPS = {"point": 4, "y_reach": 9, "in_box": 21, "in_box_span": 5,
           "edge": 29}
# the count before the skip, kept for continuity: per (point, edge) the
# crossing test's two compares and xor, t's two subtracts, two
# multiplies, add and division, the clamp's two, dx's and dy's three
# each, d2's three and the minimum's one; three more (xint's multiply,
# division and add) and two (px < xint, the parity flip) where the edge
# spans the point's y; once per edge ex, ey, len2 and the two zero guards
PIP_OPS_PAIR, PIP_OPS_CROSSING, PIP_OPS_EDGE = 21, 5, 9


def pip_crossings(py, edges) -> int:
    """(point, edge) pairs whose edge spans the point's y, the crossing
    test's ``(y0 > py) != (y1 > py)``: py in [min(y0, y1), max(y0, y1))."""
    ys = torch.sort(py).values
    lo = torch.minimum(edges[:, 1], edges[:, 3]).contiguous()
    hi = torch.maximum(edges[:, 1], edges[:, 3]).contiguous()
    return int((torch.searchsorted(ys, hi) - torch.searchsorted(ys, lo))
               .sum().item())


def pip_pair_counts(px, py, edges, eps2) -> dict:
    """The pairs the kernel's walk needs, counted on the device over
    chunks of points: within each edge's expanded y range (or not
    testable: a NaN, infinite or huge point or edge), inside the whole
    expanded box, and inside it with the edge spanning the point's y
    (``kernels.pip_edge_terms_plain``: the kernel's own margins)."""
    from geomesa_tpu_torch.scan import kernels
    lox, hix, loy, hiy = kernels.pip_edge_terms_plain(edges, eps2)
    y0, y1 = edges[:, 1], edges[:, 3]
    out = {"y_reach": 0, "in_box": 0, "in_box_span": 0}
    step = max(1, (1 << 24) // max(1, edges.shape[0]))
    for lo in range(0, px.shape[0], step):
        x, y = px[lo:lo + step], py[lo:lo + step]
        tame = (x.abs() <= 2.0**60) & (y.abs() <= 2.0**60)
        sx = torch.where(tame, x, float("nan"))[:, None]
        sy = torch.where(tame, y, float("nan"))[:, None]
        iny = ~((sy < loy) | (sy > hiy))
        inbox = iny & ~((sx < lox) | (sx > hix))
        cond = (y0 > y[:, None]) != (y1 > y[:, None])
        out["y_reach"] += int(iny.sum().item())
        out["in_box"] += int(inbox.sum().item())
        out["in_box_span"] += int((inbox & cond).sum().item())
    return out


def _residual_bytes(slots, n: int) -> int:
    """Bytes the residual kernel must move: each slot column read once
    per row, one byte out per row."""
    return n * (1 + sum(t.element_size() for s in slots for t in s
                        if t is not None))


PIP_STEP_SIZES = (100, 1_000, 10_000, 50_000, 500_000)   # candidates


def pip_step_times(ds, st, d: dict) -> list:
    """The polygon query's exact-geometry step both ways on the same
    candidates (the first k rows inside the polygon's envelope): the
    host's float64 crossing number over the candidates' coordinates, and
    the store's point-in-polygon path (``pip_mask`` plus its float64 band
    recheck). Host-clock medians of PRED_RUNS interleaved runs each, in
    ms (a host run of over a second is made once); the two keep masks
    must agree."""
    from geomesa_tpu_torch.filters.ecql import parse_ecql
    f = parse_ecql(f"INTERSECTS(geom, {PRED_POLYGON})")
    col = st.batch.col("geom")
    env = np.flatnonzero(_in_box(d["x"], d["y"], _env(PRED_SHELL)))
    out = []
    for k in PIP_STEP_SIZES:
        idx = env[:k]

        def host():
            return f.geom.contains_points(col.x[idx], col.y[idx]) \
                & col.valid[idx]

        def device():
            return ds._pip_residual(st, f, col, idx, lambda _: None)
        times = {"host": [], "device": []}
        keep = {}
        for r in range(PRED_RUNS):
            for name, fn in (("device", device), ("host", host)):
                if name == "host" and r and times["host"][0] > 1e3:
                    continue
                t0 = time.perf_counter()
                keep[name] = fn()
                times[name].append((time.perf_counter() - t0) * 1e3)
        row = {"candidates": len(idx), "hits": int(keep["host"].sum()),
               "same": bool(np.array_equal(keep["host"], keep["device"]))}
        for name, ts in times.items():
            row[f"{name}_ms"] = statistics.median(ts)
        out.append(row)
    return out


def phase_predicates(seed: int, rows: int, ids) -> dict:
    """Exact polygon and attribute predicates on a GDELT-shaped store."""
    from geomesa_tpu_torch import InMemoryDataStore
    from geomesa_tpu_torch.scan import kernels
    d = predicate_data(seed, rows)
    queries = predicate_queries(d, ids)
    ds = InMemoryDataStore()
    ds.create_schema("gdelt", PRED_SPEC)
    t0 = time.perf_counter()
    ds.write("gdelt", predicate_batch(ds.get_schema("gdelt"), d, ids))
    st = ds._types["gdelt"]
    st.ensure_index()
    torch.cuda.synchronize()
    write_s = time.perf_counter() - t0
    # the residual's device columns, uploaded apart from the queries
    t0 = time.perf_counter()
    cols = st.device_cols()
    for name in ("EventCode", "Actor1CountryCode", "NumMentions", "AvgTone",
                 "IsRootEvent"):
        cols.get(name)
    torch.cuda.synchronize()
    upload = {"seconds": time.perf_counter() - t0, "bytes": cols.nbytes}

    # the counted run; every call the path makes to either kernel is
    # recorded for the checks and timings below
    calls = {"pip_mask": [], "residual_mask": []}
    real = {k: getattr(kernels, k) for k in calls}

    def recorder(name):
        def call(*args):
            calls[name].append(args)
            return real[name](*args)
        return call
    kernels.reset_launches()
    t_main = time.perf_counter()
    per_q = []
    try:
        for name in calls:
            setattr(kernels, name, recorder(name))
        for qname, ecql, want in queries:
            res = ds.query(ecql, "gdelt")
            rows_want = np.flatnonzero(want)
            ok = (np.array_equal(res.rows, rows_want)
                  and np.array_equal(res.ids, ids[rows_want])
                  and ds.query_count(ecql, "gdelt") == len(rows_want))
            per_q.append({"query": qname, "hits": len(rows_want),
                          "strategy": _strategy(res),
                          "cost": res.plan.cost, "exact": ok})
            if not ok:
                raise SystemExit(f"predicates: {qname} disagrees with the "
                                 f"float64 brute force")
    finally:
        for name in calls:
            setattr(kernels, name, real[name])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    counts = {k: kernels.launches[k] for k in calls}

    # outside the counted run: every recorded call against the plain
    # version, exactly; then both kernels timed at the path's shapes
    wrong = []
    for px, py, edges, eps2 in calls["pip_mask"]:
        got = kernels.pip_mask(px, py, edges, eps2)
        want = kernels.pip_mask_plain(px, py, edges, eps2)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            wrong.append(("pip_mask", px.shape[0], edges.shape[0]))
    for args in calls["residual_mask"]:
        got = kernels.residual_mask(*args)
        if not torch.equal(got, kernels.residual_mask_plain(*args)):
            wrong.append(("residual_mask", args[4], args[0].shape[0]))
    stats = {}
    if calls["pip_mask"]:
        px, py, edges, eps2 = max(
            calls["pip_mask"], key=lambda a: a[0].shape[0] * a[2].shape[0])
        n, e = px.shape[0], edges.shape[0]
        crossings = pip_crossings(py, edges)
        pairs = pip_pair_counts(px, py, edges, eps2)
        all_ms, _ = bound_ms(10 * n + 16 * e, PIP_OPS_PAIR * n * e
                             + PIP_OPS_CROSSING * crossings + PIP_OPS_EDGE * e)
        bms, bby = bound_ms(10 * n + 16 * e, PIP_OPS["point"] * n + sum(
            PIP_OPS[k] * pairs[k] for k in pairs) + PIP_OPS["edge"] * e)
        stats["pip_mask"] = {
            "points": n, "edges": e, "crossing_pairs": crossings, **pairs,
            "max_abs_err": 0,
            "ms": cuda_ms(lambda: kernels.pip_mask(px, py, edges, eps2), 10),
            "plain_ms": cuda_ms(
                lambda: kernels.pip_mask_plain(px, py, edges, eps2), 1, 1),
            "bound_ms": bms, "bound_by": bby, "bound_all_pairs_ms": all_ms,
            "library_ms": None,
            "band": int(kernels.pip_mask_plain(px, py, edges, eps2)[1]
                        .sum().item())}
    if calls["residual_mask"]:
        args = max(calls["residual_mask"], key=lambda a: a[4])
        code, consts, table, slots, n = args[:5]
        bms, bby = bound_ms(_residual_bytes(slots, n)
                            + code.numel() * 4 + consts.numel() * 4
                            + table.numel(), n * code.shape[0])
        out = kernels.residual_mask(*args)
        launch = kernels.residual_launcher(code, consts, table, slots,
                                           out.device)
        stats["residual_mask"] = {
            "rows": n, "instructions": code.shape[0], "slots": len(slots),
            "max_abs_err": 0,
            "ms": cuda_ms(lambda: launch(n, out), 10),
            "wrapper_ms": cuda_ms(lambda: kernels.residual_mask(*args), 10),
            "kernel_bare_ms": cuda_ms(lambda: launch(n, out), 10,
                                      held=False),
            "wrapper_bare_ms": cuda_ms(lambda: kernels.residual_mask(*args),
                                       10, held=False),
            "wrapper_cold_ms": cuda_ms(
                lambda: kernels.residual_mask(*args), 10,
                flush=kernels._residual_launches.clear, held=False),
            "plain_ms": cuda_ms(lambda: kernels.residual_mask_plain(*args),
                                3, 1),
            "bound_ms": bms, "bound_by": bby, "library_ms": None,
            "band": int(((out & 2) != 0).sum().item())}
    for name, _, _ in wrong:
        stats.setdefault(name, {})["max_abs_err"] = 1
    pip_step = pip_step_times(ds, st, d)
    wrong += [("pip_step", r["candidates"], 0) for r in pip_step
              if not r["same"]]
    for q, (qname, ecql, _) in zip(per_q, queries):
        times = []
        for _ in range(PRED_RUNS):
            t0 = time.perf_counter()
            ds.query(ecql, "gdelt").ids
            times.append((time.perf_counter() - t0) * 1e3)
        q["p50_ms"] = statistics.median(times)
    emit({"phase": "predicates", "rows": rows, "write_s": write_s,
          "device_columns": upload, "queries": per_q,
          "kernel_calls": {k: len(v) for k, v in calls.items()},
          "kernels": stats, "launches": counts, "seconds": main_s,
          "pip_step": pip_step, "wrong": wrong})
    if wrong:
        raise SystemExit(f"predicates: kernels disagree with their plain "
                         f"versions, or the exact step's two ways "
                         f"disagree: {wrong}")
    missing = [k for k, c in counts.items() if c == 0]
    if missing:
        raise SystemExit(f"kernels never launched on the predicates path: "
                         f"{missing}")
    del calls
    return stats, counts, ds, d, queries, per_q


# -- the stats phase ---------------------------------------------------------

STATS_SPECS = ("Count()", "MinMax(dtg)", "Histogram(NumMentions,100,0,1000)",
               "Enumeration(EventCode)", "TopK(EventCode,10)",
               "DescriptiveStats(AvgTone)", "GroupBy(IsRootEvent,Count())",
               "Z3Histogram(geom,dtg,week,1024)")
STATS_RUNS = 3            # host-clock runs per call for its p50, at most
STATS_RUN_BUDGET_MS = 500  # no repeat once a call's runs took this long
MOMENTS_RTOL = 1e-9       # DescriptiveStats, relative to max(|x|, 1)
MS_WEEK = 7 * MS_DAY


def stats_brute(spec: str, d: dict, rows: np.ndarray):
    """The to_json_object that ``spec`` must give over ``rows``, from
    numpy on the raw columns (the moments in float64, by dot products)."""
    n = len(rows)
    ms = d["ms"][rows]
    if spec == "Count()":
        return {"count": n}
    if spec == "MinMax(dtg)":
        return {"min": int(ms.min()), "max": int(ms.max()),
                "cardinality": len(np.unique(ms[::max(1, n // 1000)]))}
    if spec.startswith("Histogram"):
        v = d["mentions"][rows][d["mentions_valid"][rows]]
        return {"lower-bound": 0, "upper-bound": 1000,
                "bins": np.bincount(np.minimum(v // 10, 99),
                                    minlength=100).tolist()}
    if spec.startswith(("Enumeration", "TopK")):
        c = np.bincount(d["ev"][rows], minlength=len(d["ev_vocab"]))
        items = sorted(((str(d["ev_vocab"][k]), int(c[k]))
                        for k in np.flatnonzero(c)),
                       key=lambda kv: (-kv[1], kv[0]))
        if spec.startswith("TopK"):
            return [{"value": v, "count": k} for v, k in items[:10]]
        return dict(items)
    if spec.startswith("DescriptiveStats"):
        v = d["tone"][rows]
        mean = float(np.mean(v))
        c = v - mean
        m2, m3, m4 = (float(np.dot(c, c)), float(np.dot(c * c, c)),
                      float(np.dot(c * c, c * c)))
        return {"count": n, "minimum": float(v.min()),
                "maximum": float(v.max()), "mean": mean,
                "stddev": float(np.sqrt(m2 / (n - 1))),
                "skewness": float(np.sqrt(n) * m3 / m2 ** 1.5),
                "kurtosis": float(n * m4 / (m2 * m2) - 3.0)}
    if spec.startswith("GroupBy"):
        root = d["root"][rows]
        return [{str(k): {"count": int(np.sum(root == k))}}
                for k in (False, True) if np.any(root == k)]
    if spec.startswith("Z3Histogram"):
        c = np.bincount(ms // MS_WEEK)
        return {str(b): int(c[b]) for b in np.flatnonzero(c)}
    raise ValueError(spec)


def stats_ok(spec: str, got, want) -> bool:
    if spec.startswith("DescriptiveStats"):
        return set(got) == set(want) and all(
            abs(got[k] - want[k]) <= MOMENTS_RTOL * max(abs(want[k]), 1.0)
            for k in want) and got["count"] == want["count"]
    return json.dumps(got) == json.dumps(want)


def _runs(fn) -> tuple:
    """Host-clock ms of up to STATS_RUNS calls, fewer once they took
    STATS_RUN_BUDGET_MS (the repeats cut, not the rows, to keep the
    stats phase near 30 s); the first call's result with them."""
    times, first = [], None
    while len(times) < STATS_RUNS and sum(times) < STATS_RUN_BUDGET_MS:
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
        if first is None:
            first = out
    return times, first


def phase_stats(ds, d: dict, ids, queries, per_q) -> dict:
    """Stats and Arrow on the predicates phase's store, before the
    surface phase frees it. Launch counts are zeroed before it and read
    after: the filtered stats queries run the store's scans."""
    import pyarrow as pa
    from geomesa_tpu_torch.arrow.io import FeatureArrowFileReader
    from geomesa_tpu_torch.cache import ResultCache, stats_key
    from geomesa_tpu_torch.filters import parse_ecql
    from geomesa_tpu_torch.scan import kernels
    from geomesa_tpu_torch.stats.estimator import StatsEstimator
    from geomesa_tpu_torch.stats.serialize import (deserialize_stat,
                                                   serialize_stat)
    t_phase = time.perf_counter()
    x, y, ms = d["x"], d["y"], d["ms"]
    n = len(x)
    kernels.reset_launches()
    wrong = []
    # the write-side observation alone, on the phase's batch
    sft = ds.get_schema("gdelt")
    batch = predicate_batch(sft, d, ids)
    t0 = time.perf_counter()
    StatsEstimator(sft).observe(batch)
    observe_s = time.perf_counter() - t0
    del batch
    before = ds.stats.get("gdelt").z3.to_json_object()
    t0 = time.perf_counter()
    est = ds.analyze("gdelt")
    analyze_s = time.perf_counter() - t0
    if est.count.count != n or est.z3.to_json_object() != before:
        wrong.append(("analyze", est.count.count))

    tile = np.flatnonzero(_in_box(x, y, SURFACE_TILE) & (
        ms > SURFACE_TILE_DAYS[0] * MS_DAY) & (ms < SURFACE_TILE_DAYS[1]
                                               * MS_DAY))
    world = np.flatnonzero((ms > SURFACE_WORLD_DAYS[0] * MS_DAY)
                           & (ms < SURFACE_WORLD_DAYS[1] * MS_DAY))
    world_ecql = (f"dtg DURING {_iso(SURFACE_WORLD_DAYS[0])}/"
                  f"{_iso(SURFACE_WORLD_DAYS[1])}")
    filters = [("INCLUDE", None, np.arange(n)), ("tile", _tile_ecql(), tile),
               ("world_73d", world_ecql, world)]
    stat_rows = []
    for fname, ecql, rows in filters:
        for spec in STATS_SPECS:
            want = stats_brute(spec, d, rows)
            times, stat = _cache_off(lambda: _runs(
                lambda: ds.stats_query("gdelt", spec, ecql)))
            ok = stats_ok(spec, stat.to_json_object(), want)
            if spec.startswith("Z3Histogram"):
                ok = ok and stat.total == len(rows)
            # install the entry a miss would, from the run above at the
            # same version, so the hit is timed without a second compute
            ds.result_cache.get_or_compute(
                "gdelt", stats_key(ecql, spec)[1], lambda: stat,
                encode=serialize_stat, decode=deserialize_stat)
            hit = _hit_ms(ds, lambda: ds.stats_query("gdelt", spec, ecql))
            ok = ok and stats_ok(spec, ds.stats_query(
                "gdelt", spec, ecql).to_json_object(), want)
            stat_rows.append({"filter": fname, "stat": spec, "exact": ok,
                              "p50_ms": statistics.median(times),
                              "runs": len(times), "hit_ms": hit})
            if not ok:
                wrong.append(("stats_query", fname, spec))

    # the eight predicate queries: plan, cost and estimate beside hits
    plans = []
    for q, (qname, ecql, _) in zip(per_q, queries):
        plans.append({"query": qname, "hits": q["hits"],
                      "strategy": q["strategy"], "cost": q["cost"],
                      "estimate_count": est.estimate_count(
                          parse_ecql(ecql))})

    # query_stream of the world filter: windows equal to query's ids
    times, wins = _runs(lambda: list(ds.query_stream(world_ecql, "gdelt")))
    got_ids = np.concatenate([w.ids for w in wins])
    stream = {"windows": len(wins), "rows": len(got_ids),
              "sizes": sorted({w.n for w in wins}),
              "p50_ms": statistics.median(times), "runs": len(times),
              "exact": bool(np.array_equal(got_ids, ids[world]))}
    del wins, got_ids
    if not stream["exact"]:
        wrong.append(("query_stream", stream["rows"]))

    # arrow_ipc: the tile read back value for value, the world by id;
    # one untimed call first pays pyarrow's lazy imports (about 2 s)
    _cache_off(lambda: ds.arrow_ipc("gdelt", _tile_ecql()))
    arrow = []
    for fname, ecql, rows in (("tile", _tile_ecql(), tile),
                              ("world_73d", world_ecql, world)):
        times, payload = _cache_off(lambda: _runs(
            lambda: ds.arrow_ipc("gdelt", ecql)))
        if fname == "tile":
            b = FeatureArrowFileReader(payload).read_all()
            ev = b.col("EventCode")
            ok = (np.array_equal(b.ids, ids[rows])
                  and np.array_equal(b.col("geom").x, x[rows])
                  and np.array_equal(b.col("geom").y, y[rows])
                  and np.array_equal(b.col("dtg").millis, ms[rows])
                  and np.array_equal(ev.vocab[ev.codes],
                                     d["ev_vocab"][d["ev"][rows]])
                  and np.array_equal(b.col("AvgTone").values, d["tone"][rows]))
        else:
            fids = pa.ipc.open_file(pa.BufferReader(payload)).read_all(
            ).column("__fid__").to_numpy(zero_copy_only=False)
            ok = bool(np.array_equal(fids, ids[rows]))
        # a payload over the cache's byte budget is served, not kept
        hit = (_hit_ms(ds, lambda: ds.arrow_ipc("gdelt", ecql))
               if len(payload) <= ResultCache.max_bytes() else None)
        arrow.append({"filter": fname, "rows": len(rows),
                      "bytes": len(payload), "exact": bool(ok),
                      "ms": statistics.median(times), "runs": len(times),
                      "hit_ms": hit})
        if not ok:
            wrong.append(("arrow_ipc", fname))
        del payload
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.launches.items() if v}
    emit({"phase": "stats", "rows": n, "observe_s": observe_s,
          "analyze_s": analyze_s, "stats_query": stat_rows,
          "plans": plans, "query_stream": stream, "arrow_ipc": arrow,
          "launches": launches,
          "seconds": time.perf_counter() - t_phase, "wrong": wrong})
    if wrong:
        raise SystemExit(f"stats: wrong results: {wrong}")
    if not launches.get("scan_mask"):
        raise SystemExit("the stats path launched no scan_mask")
    return launches


# -- the surface phase -------------------------------------------------------

SURFACE_TILE = (-80.0, 30.0, -60.0, 45.0)
SURFACE_TILE_DAYS = (T0_DAY + 20, T0_DAY + 50)     # 30 days, exclusive
SURFACE_WORLD_DAYS = (T0_DAY + 2, T0_DAY + 75)     # 73 days, exclusive
SURFACE_WIDE = (-120.0, 20.0, -70.0, 50.0)         # no time
WORLD = (-180.0, -90.0, 180.0, 90.0)
SURFACE_RUNS = 3          # host-clock runs per call for its p50
VIS_ROWS = 1_000_000
VIS_LABELS = [None, "a", "a&b", "b|c"]            # feature level
# attribute level, one part per attribute of VIS_SPEC
ATTR_VIS_LABELS = [",,,", "a,,,", ",b,a&b,", "c,c,c,c"]
VIS_SPEC = "EventCode:String,NumMentions:Integer,dtg:Date,*geom:Point:srid=4326"
AUTH_SETS = ([], ["a"], ["a", "b"], ["a", "b", "c"])


def _label_ok(label, auths) -> bool:
    """An Accumulo visibility label of VIS_LABELS' forms against auths."""
    if not label:
        return True
    if "|" in label:
        return any(t in auths for t in label.split("|"))
    return all(t in auths for t in label.split("&"))


def java_hash(s: str) -> int:
    h = 0
    for ch in s:
        h = (31 * h + ord(ch)) & 0xFFFFFFFF
    return h - (1 << 32) if h >= 1 << 31 else h


def density_brute(x, y, mask, bbox, width, height, w=None):
    """(grid, flat): the float32 numpy brute force of the density grid,
    cast as the reference casts (f32 coordinates rounded to nearest, the
    scalars in f64 rounded to f32, f32 arithmetic, a saturating
    truncation with NaN as 0, the clip) and summed in row order by
    np.add.at in f32; ``flat`` each row's cell."""
    xmin, ymin, xmax, ymax = (float(v) for v in bbox)
    sx = np.float32(width / (xmax - xmin) if xmax > xmin else 0.0)
    sy = np.float32(height / (ymax - ymin) if ymax > ymin else 0.0)

    def bins(v, lo, scale, size):
        with np.errstate(invalid="ignore", over="ignore"):
            t = np.trunc((v.astype(np.float32) - np.float32(lo)) * scale)
        t = np.where(np.isnan(t), 0.0, t.astype(np.float64))
        return np.clip(t, 0, size - 1).astype(np.int64)
    flat = bins(y, ymin, sy, height) * width + bins(x, xmin, sx, width)
    vals = np.where(mask, np.float32(1.0) if w is None
                    else np.asarray(w, np.float32), np.float32(0.0))
    grid = np.zeros(height * width, dtype=np.float32)
    np.add.at(grid, flat, vals.astype(np.float32))
    return grid.reshape(height, width), flat


def grid_bound(flat, mask, w, cells: int):
    """(bound, exact) float64 and bool [cells]: per cell 2 * n_cell *
    2^-24 * sum |w|, how far f32 sums of the cell's weights may move
    with the order of the adds; and the cells that every order sums
    exactly (unit or integer weights with sum |w| under 2^24, so every
    partial sum is an exact f32 integer)."""
    f = flat[mask]
    n_cell = np.bincount(f, minlength=cells)
    wm = (np.ones(len(f)) if w is None
          else np.asarray(w, np.float64)[mask])
    abs_w = np.bincount(f, np.abs(wm), minlength=cells)
    exact = ((abs_w < 2**24) if np.all(wm == np.round(wm))
             else np.zeros(cells, dtype=bool))
    return 2 * n_cell * 2.0**-24 * abs_w, exact


def grid_verdict(got, want, flat, mask, w) -> dict:
    """Exact on grid_bound's exact cells, within its bound elsewhere."""
    diff = np.abs(got.astype(np.float64).ravel() - want.astype(np.float64)
                  .ravel())
    bound, exact = grid_bound(flat, mask, w, want.size)
    ok = bool(np.all(diff[exact] == 0) and np.all(diff[~exact]
                                                  <= bound[~exact]))
    return {"max_abs_err": float(diff.max()) if diff.size else 0.0,
            "exact_cells": int(exact.sum()),
            "bound_cells": int((~exact).sum()), "ok": ok}


def _p50(fn, runs: int = SURFACE_RUNS) -> float:
    return statistics.median(_timed(fn) for _ in range(runs))


def density_split(ds, ecql, bbox, width, height, attr) -> dict:
    """Where one density() call spends its time, each step synchronised
    (host clock, medians of SURFACE_RUNS), as the store runs it: the
    query's rows (plan, scan, visibility), the row ids' upload, the
    kernel (reading the point and weight from the store's device
    columns), the grid's copy back; and the whole call. Beside them the
    upload of the point and weight device columns that a store's first
    density() call after a write pays (device_columns_s)."""
    from geomesa_tpu_torch import Query
    from geomesa_tpu_torch.index.api import Explainer
    from geomesa_tpu_torch.scan import aggregations, kernels, residual
    st = ds._types["gdelt"]
    t0 = time.perf_counter()
    fresh = residual.DeviceColumns(st.batch, ds.device)
    for name in ("geom",) + (() if attr is None else (attr,)):
        fresh.get(name)
    torch.cuda.synchronize()
    columns_s = time.perf_counter() - t0
    del fresh
    cols = st.device_cols()
    point = cols.get("geom")["slot"]
    weight = None if attr is None else (cols.get(attr)["kind"],
                                        cols.get(attr)["slot"])
    steps = {k: [] for k in ("query", "ids_upload", "kernel", "copy_back",
                             "call")}
    xmin, ymin, sx, sy = aggregations.density_scalars(bbox, width, height)
    for _ in range(SURFACE_RUNS):
        t0 = time.perf_counter()
        rows = ds._matching_rows(Query("gdelt", ecql), st, Explainer())[0]
        t1 = time.perf_counter()
        ids = torch.from_numpy(rows.astype(np.int32)).to(ds.device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        grid = kernels.density_grid_rows(ids, point, weight, xmin, ymin, sx,
                                         sy, width, height)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        grid.cpu().numpy()
        t4 = time.perf_counter()
        for k, a, b in (("query", t0, t1), ("ids_upload", t1, t2),
                        ("kernel", t2, t3), ("copy_back", t3, t4)):
            steps[k].append((b - a) * 1e3)
        steps["call"].append(_cache_off(lambda: _timed(lambda: ds.density(
            "gdelt", ecql, bbox, width, height, attr))))
    return {"rows": len(rows), "device_columns_s": columns_s,
            **{f"{k}_ms": statistics.median(v) for k, v in steps.items()},
            "hit_ms": _hit_ms(ds, lambda: ds.density(
                "gdelt", ecql, bbox, width, height, attr))}


def density_launch_ok(args, got) -> tuple[bool, float]:
    """A rows-loader launch's grid ``got`` against its plain version:
    equal unweighted; weighted, exact on cells of integer weights (Long,
    Integer, Boolean) whose sum |w| is under 2^24 and within 2 * n_cell
    * 2^-24 * sum |w| elsewhere. (ok, max |difference|)."""
    from geomesa_tpu_torch.scan import kernels
    want = kernels.density_grid_rows_plain(*args)
    diff = (got.double() - want.double()).abs().flatten()
    err = float(diff.max().item()) if diff.numel() else 0.0
    if args[2] is None:
        return torch.equal(got, want), err
    x, y, w, mask = kernels.density_rows_gather(*args[:3])
    width, height = args[7], args[8]
    cells = kernels.density_cells_plain(x, y, *args[3:9])[mask]
    n_cell = torch.bincount(cells, minlength=width * height).double()
    abs_w = torch.bincount(cells, w[mask].abs().double(),
                           minlength=width * height)
    bound = 2 * n_cell * 2.0**-24 * abs_w
    if args[2][0] in ("i64", "bool"):
        bound = torch.where(abs_w < 2**24, torch.zeros_like(bound), bound)
    return bool((diff <= bound).all()), err


def density_bytes(args) -> int:
    """The bytes a rows-loader launch must move: per row the 4 B id, x
    and y (8 B), the weight's 4 B (8 B for an int64 as two words, 1 B for
    a Boolean) and the validity bytes; 4 B a cell to zero the grid and 4
    B a cell to copy it out."""
    ids, _point, weight = args[:3]
    per_row = 4 + 8 + 1
    if weight is not None:
        per_row += {"f64": 4, "i64": 8, "bool": 1}[weight[0]] + 1
    return ids.shape[0] * per_row + 8 * args[7] * args[8]


def _tile_ecql() -> str:
    x0, y0, x1, y1 = SURFACE_TILE
    return (f"BBOX(geom, {x0}, {y0}, {x1}, {y1}) AND dtg DURING "
            f"{_iso(SURFACE_TILE_DAYS[0])}/{_iso(SURFACE_TILE_DAYS[1])}")


def _sample_brute(rows, rate, by=None):
    k = max(1, int(round(1.0 / rate)))
    if by is None:
        return rows[np.arange(len(rows)) % k == 0]
    order = np.argsort(by, kind="stable")
    g = by[order]
    start = np.r_[True, g[1:] != g[:-1]]
    pos = np.arange(len(rows))
    rank = np.empty(len(rows), dtype=np.int64)
    rank[order] = pos - np.maximum.accumulate(np.where(start, pos, 0))
    return rows[rank % k == 0]


def surface_queries(ds, d, ids, during) -> list:
    """The query surface on the store, each result id-exact against
    the brute force: a sort with max_features, a projection, SAMPLING
    with and without SAMPLE_BY (with query_count equal to query().n)."""
    from geomesa_tpu_torch import Query
    from geomesa_tpu_torch.index.api import QueryHints
    x, y, ms = d["x"], d["y"], d["ms"]
    tile = np.flatnonzero(_in_box(x, y, SURFACE_TILE) & during(
        *SURFACE_TILE_DAYS))
    wide = np.flatnonzero(_in_box(x, y, SURFACE_WIDE))
    ev = d["ev_vocab"][d["ev"]]
    x0, y0, x1, y1 = SURFACE_WIDE
    wide_ecql = f"BBOX(geom, {x0}, {y0}, {x1}, {y1})"
    order = np.argsort(d["mentions"][tile], kind="stable")[::-1]
    cases = [
        ("sort_desc_limit", Query("gdelt", _tile_ecql(),
                                  sort_by="NumMentions", sort_desc=True,
                                  max_features=1000), tile[order[:1000]]),
        ("projection", Query("gdelt", _tile_ecql(),
                             properties=["EventCode", "geom"]), tile),
        ("sampling_0.1", Query("gdelt", wide_ecql,
                               hints={QueryHints.SAMPLING: 0.1}),
         _sample_brute(wide, 0.1)),
        ("sampling_0.1_by_EventCode",
         Query("gdelt", wide_ecql, hints={QueryHints.SAMPLING: 0.1,
                                          QueryHints.SAMPLE_BY: "EventCode"}),
         _sample_brute(wide, 0.1, ev[wide])),
    ]
    out = []
    for name, q, want in cases:
        res = ds.query(q)
        ok = (np.array_equal(res.rows, want)
              and np.array_equal(res.ids, ids[want])
              and ds.query_count(q) == res.n == len(want))
        if name == "projection":
            b = res.batch
            ok = ok and (set(b.columns) == {"EventCode", "geom"}
                         and np.array_equal(b.col("geom").x, x[want])
                         and np.array_equal(b.col("EventCode").vocab[
                             b.col("EventCode").codes], ev[want])
                         and set(b.feature(0)) == {"id", "EventCode",
                                                   "geom"})
        out.append({"query": name, "hits": len(want), "exact": bool(ok),
                    "p50_ms": _p50(lambda: ds.query(q).ids)})
    return out


def visibility_cases(d, ids, during) -> list:
    """A store of VIS_ROWS rows (the first rows of the phase's data)
    with four distinct labels, at feature and at attribute level; the
    tile query (and at attribute level one on a possibly hidden
    attribute, the leak guard's case) per auth set, id-exact against
    the brute force."""
    from geomesa_tpu_torch import InMemoryDataStore, Query
    from geomesa_tpu_torch.features.batch import (DateColumn, FeatureBatch,
                                                  NumericColumn, PointColumn,
                                                  StringColumn)
    n = min(VIS_ROWS, len(d["x"]))
    rng = np.random.default_rng(31)
    pick = rng.integers(0, 4, n)
    x, y, ms, ment = d["x"][:n], d["y"][:n], d["ms"][:n], d["mentions"][:n]
    ones = np.ones(n, dtype=bool)
    out = []
    for level, labels in (("feature", VIS_LABELS),
                          ("attribute", ATTR_VIS_LABELS)):
        ds = InMemoryDataStore()
        spec = VIS_SPEC + (";geomesa.visibility.level='attribute'"
                           if level == "attribute" else "")
        ds.create_schema("vis", spec)
        batch = FeatureBatch(ds.get_schema("vis"), ids[:n], {
            "EventCode": StringColumn("EventCode", d["ev"][:n],
                                      d["ev_vocab"].astype(object)),
            "NumMentions": NumericColumn("NumMentions", ment,
                                         d["mentions_valid"][:n]),
            "dtg": DateColumn("dtg", ms, ones),
            "geom": PointColumn("geom", x, y, ones)})
        t0 = time.perf_counter()
        ds.write("vis", batch, visibilities=np.array(labels,
                                                     dtype=object)[pick])
        ds.query(_tile_ecql(), "vis")
        write_s = time.perf_counter() - t0
        tile = _in_box(x, y, SURFACE_TILE) & (ms > SURFACE_TILE_DAYS[0]
                                              * MS_DAY) & (
            ms < SURFACE_TILE_DAYS[1] * MS_DAY)
        x0, y0, x1, y1 = SURFACE_TILE
        probe = (f"BBOX(geom, {x0}, {y0}, {x1}, {y1}) AND NumMentions >= 5")
        probe_hit = (_in_box(x, y, SURFACE_TILE) & (ment >= 5)
                     & d["mentions_valid"][:n])
        for auths in AUTH_SETS:
            if level == "feature":
                seen = np.array([_label_ok(lb, auths) for lb in labels])
                cases = [("tile", _tile_ecql(), tile & seen[pick])]
            else:
                # per label and attribute (EventCode, NumMentions, dtg,
                # geom): visible; a row shows when any attribute does,
                # and a filter on a hidden attribute drops it
                attr_ok = np.array([[_label_ok(p, auths)
                                     for p in lb.split(",")]
                                    for lb in labels])[pick]
                any_ok = attr_ok.any(axis=1)
                cases = [("tile", _tile_ecql(),
                          tile & any_ok & attr_ok[:, 2] & attr_ok[:, 3]),
                         ("hidden_probe", probe,
                          probe_hit & any_ok & attr_ok[:, 1]
                          & attr_ok[:, 3])]
            for name, ecql, want in cases:
                q = Query("vis", ecql, auths=list(auths))
                res = ds.query(q)
                rows = np.flatnonzero(want)
                ok = (np.array_equal(res.rows, rows)
                      and np.array_equal(res.ids, ids[rows])
                      and ds.query_count(q) == len(rows))
                if level == "attribute" and ok and len(rows):
                    # redacted cells read as null
                    code_ok = attr_ok[rows, 0]
                    ok = bool(np.array_equal(
                        res.batch.col("EventCode").codes >= 0, code_ok))
                out.append({"level": level, "query": name,
                            "auths": list(auths), "hits": len(rows),
                            "exact": bool(ok), "write_s": write_s,
                            "p50_ms": _p50(lambda: ds.query(q).ids)})
        del ds
    torch.cuda.empty_cache()
    return out


def phase_surface(ds, d: dict, ids, queries) -> dict:
    """The query surface and the density and BIN pushdowns on the
    predicates phase's store, then a delete and remove_schema."""
    import gc
    from geomesa_tpu_torch import Query
    from geomesa_tpu_torch.scan import kernels
    t_phase = time.perf_counter()
    x, y, ms = d["x"], d["y"], d["ms"]

    def during(lo_day, hi_day):
        return (ms > lo_day * MS_DAY) & (ms < hi_day * MS_DAY)
    tile = _in_box(x, y, SURFACE_TILE) & during(*SURFACE_TILE_DAYS)
    world = during(*SURFACE_WORLD_DAYS)
    world_ecql = (f"dtg DURING {_iso(SURFACE_WORLD_DAYS[0])}/"
                  f"{_iso(SURFACE_WORLD_DAYS[1])}")
    ment = np.where(d["mentions_valid"], d["mentions"], 0)
    grids = [
        ("tile_256", _tile_ecql(), SURFACE_TILE, 256, 256, None, tile, None),
        ("world_2048x1024_NumMentions", world_ecql, WORLD, 2048, 1024,
         "NumMentions", world & d["mentions_valid"], ment),
        ("world_2048x1024_AvgTone", world_ecql, WORLD, 2048, 1024,
         "AvgTone", world, d["tone"]),
        ("world_256x256_zoom0", world_ecql, WORLD, 256, 256, None, world,
         None),
    ]

    # the counted run: every launch of the density kernel is recorded
    # with its grid for the checks and timings below
    calls = []
    real = kernels.density_grid_rows

    def recorder(*args):
        out = real(*args)
        calls.append((args, out))
        return out
    kernels.reset_launches()
    t_main = time.perf_counter()
    density, wrong = [], []
    try:
        kernels.density_grid_rows = recorder
        for name, ecql, bbox, w, h, attr, mask, wts in grids:
            got = ds.density("gdelt", ecql, bbox, w, h, attr)
            sel = np.flatnonzero(mask)
            want, flat = density_brute(x[sel], y[sel], np.ones(len(sel), bool),
                                       bbox, w, h,
                                       None if wts is None else wts[sel])
            v = grid_verdict(got, want, flat, np.ones(len(sel), bool),
                             None if wts is None else wts[sel])
            v.update(grid=name, rows=len(sel), mass=float(got.sum(
                dtype=np.float64)))
            density.append(v)
            if not v["ok"]:
                wrong.append(("density", name))
        # BIN records of the tile query, plain and time-sorted
        rows = np.flatnonzero(tile)
        track = np.array([java_hash(str(i)) for i in ids[rows]], np.int32)
        secs = (ms[rows] // 1000).astype(np.int32)
        label = np.array([c[:8].encode() for c in
                          d["ev_vocab"][d["ev"][rows]]], dtype="S8")
        bins = []
        for sort in (False, True):
            payload = ds.bin_query("gdelt", _tile_ecql(), label="EventCode",
                                   sort=sort)
            rec = np.frombuffer(payload, dtype=[
                ("track", "<i4"), ("secs", "<i4"), ("lat", "<f4"),
                ("lon", "<f4"), ("label", "S8")])
            o = (np.argsort(secs, kind="stable") if sort
                 else np.arange(len(rows)))
            ok = (len(rec) == ds.query_count(_tile_ecql(), "gdelt")
                  == len(rows)
                  and np.array_equal(rec["track"], track[o])
                  and np.array_equal(rec["secs"], secs[o])
                  and np.array_equal(rec["lat"], y[rows][o].astype(np.float32))
                  and np.array_equal(rec["lon"], x[rows][o].astype(np.float32))
                  and np.array_equal(rec["label"], label[o])
                  and (not sort or bool(np.all(np.diff(rec["secs"]) >= 0))))
            bins.append({"sort": sort, "records": len(rec), "exact": bool(ok),
                         "p50_ms": _cache_off(lambda: _p50(
                             lambda: ds.bin_query("gdelt", _tile_ecql(),
                                                  label="EventCode",
                                                  sort=sort))),
                         "hit_ms": _hit_ms(ds, lambda: ds.bin_query(
                             "gdelt", _tile_ecql(), label="EventCode",
                             sort=sort))})
            if not ok:
                wrong.append(("bin_query", sort))
        surface = surface_queries(ds, d, ids, during)
        vis = visibility_cases(d, ids, during)
    finally:
        kernels.density_grid_rows = real
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    launches = kernels.launches["density_grid"]
    wrong += [("surface", q["query"]) for q in surface if not q["exact"]]
    wrong += [("visibility", v["level"], v["query"], str(v["auths"]))
              for v in vis if not v["exact"]]

    # outside the counted run: every recorded launch's own grid against
    # the plain version of its inputs, then the kernel timed at the
    # surface's shapes (rows loader) beside its bound, its plain version,
    # one index_add_ over the same cells, and the array loader on the
    # same rows gathered
    errs = []
    for args, got in calls:
        ok, err = density_launch_ok(args, got)
        errs.append(err)
        if not ok:
            wrong.append(("density_grid", args[0].shape[0], args[7], args[8]))
    by_name = {name: args for (name, *_r), (args, _g)
               in zip(grids, calls[:len(grids)])}
    args = by_name["world_2048x1024_NumMentions"]
    xt, yt, wt, mt = kernels.density_rows_gather(*args[:3])
    w, h = args[7], args[8]
    flat = kernels.density_cells_plain(xt, yt, *args[3:9])
    vals = torch.where(mt, wt, torch.zeros_like(wt))
    bms, bby = bound_ms(density_bytes(args), 0)
    one_cell = (*args[:7], 1, 1)
    zoom = by_name["world_256x256_zoom0"]
    tile_args = by_name["tile_256"]

    def path(a):
        return kernels.density_plan(a[0].shape[0], a[7], a[8],
                                    None if a[2] is None else a[2][0])["path"]
    stats = {
        "rows": int(args[0].shape[0]), "width": w, "height": h,
        "weighted": "i64", "max_abs_err": max(errs), "launches": launches,
        "path": path(args),
        "ms": cuda_ms(lambda: kernels.density_grid_rows(*args), 20),
        "plain_ms": cuda_ms(lambda: kernels.density_grid_rows_plain(*args), 3,
                            1),
        "library_ms": cuda_ms(lambda: torch.zeros(
            w * h, dtype=torch.float32, device=xt.device).index_add_(
                0, flat, vals), 20),
        "bound_ms": bms, "bound_by": bby,
        "array_loader_ms": cuda_ms(lambda: kernels.density_grid(
            xt, yt, wt, mt, *args[3:9]), 20),
        "one_cell_path": path(one_cell),
        "one_cell_ms": cuda_ms(lambda: kernels.density_grid_rows(*one_cell),
                               20),
        "one_cell_bound_ms": bound_ms(density_bytes(one_cell), 0)[0],
        "one_cell_call_ms": _cache_off(lambda: _p50(lambda: ds.density(
            "gdelt", grids[1][1], WORLD, 1, 1, "NumMentions"))),
        "zoom0": {"rows": int(zoom[0].shape[0]), "width": zoom[7],
                  "height": zoom[8], "path": path(zoom),
                  "ms": cuda_ms(lambda: kernels.density_grid_rows(*zoom), 20),
                  "bound_ms": bound_ms(density_bytes(zoom), 0)[0]},
        "unweighted": {"rows": int(tile_args[0].shape[0]),
                       "width": tile_args[7], "height": tile_args[8],
                       "path": path(tile_args),
                       "ms": cuda_ms(lambda: kernels.density_grid_rows(
                           *tile_args), 20),
                       "bound_ms": bound_ms(density_bytes(tile_args), 0)[0]},
    }
    del calls, args, one_cell, tile_args, zoom, xt, yt, wt, mt, flat, vals
    del by_name
    split = {name: density_split(ds, ecql, bbox, w, h, attr)
             for name, ecql, bbox, w, h, attr, _m, _w in grids[:2]}
    for g, (name, ecql, bbox, w, h, attr, _m, _w) in zip(density, grids):
        g["p50_ms"] = (split[name]["call_ms"] if name in split
                       else _cache_off(lambda: _p50(lambda: ds.density(
                           "gdelt", ecql, bbox, w, h, attr))))
        g["hit_ms"] = (split[name]["hit_ms"] if name in split
                       else _hit_ms(ds, lambda: ds.density(
                           "gdelt", ecql, bbox, w, h, attr)))

    # delete 1,000 ids, then the rebuild and three strategies
    gone = np.random.default_rng(41).choice(len(x), 1000, replace=False)
    keep = np.ones(len(x), dtype=bool)
    keep[gone] = False
    st = ds._types["gdelt"]
    t0 = time.perf_counter()
    ds.delete("gdelt", ids[gone])
    delete_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    st.ensure_index()
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    del st
    by_name = {qn: (e, m) for qn, e, m in queries}
    after = []
    for name, ecql, want in (
            ("z3_tile", _tile_ecql(), tile),
            ("polygon_within", *by_name["multipolygon_within"]),
            ("attr_equality", *by_name["attr_equality_during"])):
        t0 = time.perf_counter()
        res = ds.query(ecql, "gdelt")
        first_ms = (time.perf_counter() - t0) * 1e3
        kept = np.flatnonzero(want & keep)
        ok = (np.array_equal(res.ids, ids[kept])
              and ds.query_count(ecql, "gdelt") == len(kept))
        after.append({"query": name, "hits": len(kept), "exact": bool(ok),
                      "first_ms": first_ms,
                      "strategy": _strategy(res)})
        if not ok:
            wrong.append(("after_delete", name))

    # analyze recounts the kept rows (the stats stay stale until then)
    stale = ds.stats.get("gdelt").count.count
    t0 = time.perf_counter()
    recount = ds.analyze("gdelt").count.count
    analyzed = {"stale_count": stale, "count": recount,
                "seconds": time.perf_counter() - t0}
    if stale != len(x) or recount != len(x) - len(gone):
        wrong.append(("analyze_after_delete", stale, recount))

    # remove_schema releases the type's device memory
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ds.remove_schema("gdelt")
    gc.collect()
    torch.cuda.synchronize()
    removed = {"seconds": time.perf_counter() - t0,
               "allocated_before": before,
               "allocated_after": torch.cuda.memory_allocated(),
               "types_after": ds.get_type_names()}
    if not removed["allocated_after"] < before or removed["types_after"]:
        wrong.append(("remove_schema", before, removed["allocated_after"]))
    emit({"phase": "surface", "density": density, "bin_query": bins,
          "queries": surface, "visibility": vis,
          "delete": {"ids": len(gone), "delete_s": delete_s,
                     "rebuild_s": rebuild_s, "queries": after,
                     "analyze": analyzed},
          "remove_schema": removed, "density_split": split,
          "kernels": {"density_grid": stats}, "launches": {
              "density_grid": launches}, "counted_s": main_s,
          "seconds": time.perf_counter() - t_phase, "wrong": wrong})
    if wrong:
        raise SystemExit(f"surface: wrong results: {wrong}")
    if launches == 0:
        raise SystemExit("density_grid never launched on the surface path")
    return {"density_grid": stats}, {"density_grid": launches}


# -- the extent kernel at --rows, and the extent phase ------------------------

# the kernels phase's extent queries: the four reference queries, then a
# box and interval whose f64 edges have no exact f32 (MAYBE rows from the
# rounding itself)
EXTENT_KERNEL_QUERIES = KERNEL_QUERIES + [
    ([(-80.123456789, 30.987654321, -60.000000001, 45.333333333)],
     [(20 * MS_DAY + 1, 50 * MS_DAY - 1)]),
]
EXTENT_REGION = (-74.26, 40.49, -73.70, 40.92)   # the five boroughs' box
EXTENT_POLYGONS, EXTENT_LINES = 1_000_000, 200_000
EXTENT_MIN_FEATURES = 500_000
EXTENT_BUDGET_S = 90.0
EXTENT_CHUNK = 100_000
EXTENT_SPEC = "name:String,dtg:Date,*geom:Geometry:srid=4326"
EXTENT_T0_DAY = 19_358       # 2023-01-01; dtg over 365 days from there
EXTENT_RUNS = 3              # host-clock runs per query for its p50
# the phase took 2.9-3.4 times its data and writes on an H100 host
# (PERF.md): the writes stop early when 3 times their pace projects it
# past its budget
EXTENT_PHASE_PER_WRITE = 3.0
M_PER_DEG = 111_320.0        # meters per degree of latitude
EXTENT_MAX_VERTS = 10        # a street's most vertices; polygons have 5


def extent_rows(seed: int, rows: int):
    """(bounds f64 (rows, 4), millis) for the kernel: box centres uniform
    over the world, each side log-uniform from 1e-5 to 1 degree, 1 % null
    rows (NaN), the kernels phase's times."""
    rng = np.random.default_rng(seed + 7)
    c = np.empty((rows, 2))
    c[:, 0] = rng.uniform(-180, 180, rows)
    c[:, 1] = rng.uniform(-90, 90, rows)
    half = 10.0 ** rng.uniform(-5, 0, (rows, 2)) / 2
    bounds = np.concatenate([c - half, c + half], axis=1)
    del c, half
    bounds[rng.random(rows) < 0.01] = np.nan
    return bounds, rng.integers(0, 1000 * MS_DAY, rows)


def extent_bound(args) -> tuple[float, str]:
    """The bytes the tristate needs on these inputs (its wrapper's
    arguments) over 3.35 TB/s: the valid byte and the state byte of
    every row, a valid row's 16 B of bounds, and, when the query has
    intervals, the 8 B of (day, ms) of each row that the box test kept
    (only those read their times: counted by the plain version without
    the intervals); the compares are far below the integer rate."""
    from geomesa_tpu_torch.scan import kernels
    bounds, valid, times, outer, inner, intervals = args
    n = valid.shape[0]
    nbytes = 2 * n + 16 * int(valid.sum().item())
    if times is not None and intervals.shape[0]:
        box = kernels.extent_tristate_plain(bounds, valid, None, outer,
                                            inner, intervals[:0])
        nbytes += 8 * int((box > 0).sum().item())
    return bound_ms(nbytes, 0)


def extent_kernel_stats(seed: int, rows: int) -> dict:
    """extent_tristate at --rows rows against its plain version
    (torch.equal) over EXTENT_KERNEL_QUERIES, timed beside its bound."""
    from geomesa_tpu_torch.scan import gscan, kernels
    dev = torch.device("cuda")
    bounds, ms = extent_rows(seed, rows)
    t0 = time.perf_counter()
    data = gscan.build_extent_data(bounds, ms, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    del bounds, ms
    per_q, err = [], 0
    for qi, (boxes, intervals) in enumerate(EXTENT_KERNEL_QUERIES):
        q = gscan.extent_query(boxes, intervals)
        o, i, t = q.tables(dev)

        def kern():
            return kernels.extent_tristate(data.bounds, data.valid,
                                           data.times, o, i, t)

        def plain():
            return kernels.extent_tristate_plain(data.bounds, data.valid,
                                                 data.times, o, i, t)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        err = max(err, 0 if same else _err(got, want))
        bms, bby = extent_bound((data.bounds, data.valid, data.times, o, i,
                                 t))
        counts = torch.bincount(want.to(torch.int64), minlength=3).tolist()
        per_q.append({
            "query": qi, "ms": cuda_ms(kern, 20),
            "plain_ms": cuda_ms(plain, 3, warmup=1), "bound_ms": bms,
            "bound_by": bby,
            "bound_all_rows_ms": rows * (26 if intervals else 18)
            / HBM_BYTES_PER_S * 1e3,
            "library_ms": None, "out": counts[0], "maybe": counts[1],
            "in": counts[2], "equal": same})
    out = {"max_abs_err": err, "per_query": per_q, "rows": rows,
           "build_s": build_s, "device_bytes": data.nbytes}
    del data
    torch.cuda.empty_cache()
    return out


def city_arrays(seed: int, n_poly: int, n_line: int) -> dict:
    """A city's footprint and street layers inside EXTENT_REGION, as
    padded vertex arrays (n, EXTENT_MAX_VERTS, 2) f64 (a geometry's last
    vertex repeated to the end), shuffled: rotated rectangles 8-60 m a
    side (5-vertex closed rings), and streets of 2-10 vertices, 30-400 m
    long; dtg uniform over 365 days."""
    rng = np.random.default_rng(seed + 11)
    x0, y0, x1, y1 = EXTENT_REGION
    cy = rng.uniform(y0 + 0.005, y1 - 0.005, n_poly)
    cx = rng.uniform(x0 + 0.005, x1 - 0.005, n_poly)
    a, b = rng.uniform(8, 60, (2, n_poly)) / 2
    th = rng.uniform(0, np.pi, n_poly)
    sa = np.array([-1, 1, 1, -1, -1.0])
    sb = np.array([-1, -1, 1, 1, -1.0])
    du = sa[None] * a[:, None]
    dv = sb[None] * b[:, None]
    ct, stt = np.cos(th)[:, None], np.sin(th)[:, None]
    kx = 1 / (M_PER_DEG * np.cos(np.radians(cy)))[:, None]
    poly = np.empty((n_poly, EXTENT_MAX_VERTS, 2))
    poly[:, :5, 0] = cx[:, None] + (du * ct - dv * stt) * kx
    poly[:, :5, 1] = cy[:, None] + (du * stt + dv * ct) / M_PER_DEG
    poly[:, 5:] = poly[:, 4:5]
    nv = rng.integers(2, EXTENT_MAX_VERTS + 1, n_line)
    length = rng.uniform(30, 400, n_line)
    lx = rng.uniform(x0 + 0.005, x1 - 0.005, n_line)
    ly = rng.uniform(y0 + 0.005, y1 - 0.005, n_line)
    heading = (rng.uniform(0, 2 * np.pi, n_line)[:, None]
               + np.cumsum(rng.normal(0, 0.3, (n_line, EXTENT_MAX_VERTS - 1)),
                           axis=1))
    step = (length / (nv - 1))[:, None]
    k = np.arange(EXTENT_MAX_VERTS - 1)[None]
    live = k < (nv - 1)[:, None]
    dx = np.where(live, step * np.cos(heading), 0.0)
    dy = np.where(live, step * np.sin(heading), 0.0)
    line = np.empty((n_line, EXTENT_MAX_VERTS, 2))
    line[:, 0, 0], line[:, 0, 1] = lx, ly
    kl = 1 / (M_PER_DEG * np.cos(np.radians(ly)))[:, None]
    line[:, 1:, 0] = lx[:, None] + np.cumsum(dx, axis=1) * kl
    line[:, 1:, 1] = ly[:, None] + np.cumsum(dy, axis=1) / M_PER_DEG
    verts = np.concatenate([poly, line])
    nverts = np.concatenate([np.full(n_poly, 5), nv])
    is_poly = np.concatenate([np.ones(n_poly, bool), np.zeros(n_line, bool)])
    order = rng.permutation(len(verts))
    verts, nverts, is_poly = verts[order], nverts[order], is_poly[order]
    n = len(verts)
    return {"verts": verts, "nverts": nverts, "is_poly": is_poly,
            "bounds": np.concatenate([verts.min(axis=1), verts.max(axis=1)],
                                     axis=1),
            "ms": (EXTENT_T0_DAY * MS_DAY
                   + rng.integers(0, 365 * MS_DAY, n)),
            "names": np.array(["footprint", "street"], dtype=object)[
                (~is_poly).astype(int)]}


def city_geoms(c: dict, lo: int, hi: int) -> list:
    from geomesa_tpu_torch.geometry import LineString, Polygon
    v, nv, poly = c["verts"], c["nverts"], c["is_poly"]
    return [Polygon(v[i, :5]) if poly[i] else LineString(v[i, :nv[i]])
            for i in range(lo, hi)]


def _seg_hits(p0, p1, q0, q1):
    """Whether segments p0-p1 and q0-q1 meet (broadcast, f64): a proper
    crossing by orientations, or an endpoint on the other segment."""
    def orient(a, b, c):
        return np.sign((b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1])
                       - (b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0]))

    def on(a, b, c):
        return ((np.minimum(a[..., 0], b[..., 0]) <= c[..., 0])
                & (c[..., 0] <= np.maximum(a[..., 0], b[..., 0]))
                & (np.minimum(a[..., 1], b[..., 1]) <= c[..., 1])
                & (c[..., 1] <= np.maximum(a[..., 1], b[..., 1])))
    o1, o2 = orient(p0, p1, q0), orient(p0, p1, q1)
    o3, o4 = orient(q0, q1, p0), orient(q0, q1, p1)
    return (((o1 != o2) & (o3 != o4)) | ((o1 == 0) & on(p0, p1, q0))
            | ((o2 == 0) & on(p0, p1, q1)) | ((o3 == 0) & on(q0, q1, p0))
            | ((o4 == 0) & on(q0, q1, p1)))


def _crossing(px, py, r0, r1):
    """Crossing-number parity of points (..., 1) against edges r0-r1."""
    cond = (r0[..., 1] > py) != (r1[..., 1] > py)
    with np.errstate(divide="ignore", invalid="ignore"):
        xi = r0[..., 0] + (py - r0[..., 1]) * (r1[..., 0] - r0[..., 0]) / (
            r1[..., 1] - r0[..., 1])
    return (cond & (px < xi)).sum(axis=-1) % 2 == 1


def city_intersects(c: dict, rows: np.ndarray, ring: np.ndarray) -> np.ndarray:
    """Brute force, f64: does each feature in ``rows`` meet the polygon
    ``ring`` (closed, (E + 1, 2))? Any of its segments meets an edge, or
    any of its vertices is inside the ring, or (a footprint) a vertex of
    the ring is inside it."""
    out = np.zeros(len(rows), dtype=bool)
    e0, e1 = ring[:-1], ring[1:]
    step = max(1, 4_000_000 // (EXTENT_MAX_VERTS * len(e0)))
    for lo in range(0, len(rows), step):
        sel = rows[lo:lo + step]
        v = c["verts"][sel]
        seg = _seg_hits(v[:, :-1, None], v[:, 1:, None], e0[None, None],
                        e1[None, None]).any(axis=(1, 2))
        inside = _crossing(v[..., 0, None], v[..., 1, None], e0[None, None],
                           e1[None, None]).any(axis=1)
        fp = v[:, :5]
        back = _crossing(ring[None, :, 0, None], ring[None, :, 1, None],
                         fp[:, None, :-1], fp[:, None, 1:]).any(axis=1)
        out[lo:lo + step] = seg | inside | (back & c["is_poly"][sel])
    return out


def city_dwithin(c: dict, rows: np.ndarray, px: float, py: float,
                 deg: float) -> np.ndarray:
    """Brute force, f64: is each feature in ``rows`` within ``deg`` of
    (px, py)? Inside a footprint, or the least distance to a segment
    (the projection clamped to it) at most deg."""
    v = c["verts"][rows]
    a, b = v[:, :-1], v[:, 1:]
    dx, dy = b[..., 0] - a[..., 0], b[..., 1] - a[..., 1]
    len2 = dx * dx + dy * dy
    with np.errstate(divide="ignore", invalid="ignore"):
        t = ((px - a[..., 0]) * dx + (py - a[..., 1]) * dy) / len2
    t = np.where(len2 == 0, 0.0, np.clip(t, 0.0, 1.0))
    d2 = ((px - (a[..., 0] + t * dx)) ** 2
          + (py - (a[..., 1] + t * dy)) ** 2).min(axis=1)
    fp = v[:, :5]
    inside = _crossing(np.full((len(rows), 1), px), np.full((len(rows), 1),
                                                           py),
                       fp[:, :-1], fp[:, 1:]) & c["is_poly"][rows]
    return inside | (np.sqrt(d2) <= deg)


def _ring_text(ring) -> str:
    return "(" + ", ".join(f"{float(x)!r} {float(y)!r}" for x, y in ring) + ")"


def city_queries(c: dict, n: int) -> list:
    """(name, ecql, oracle) of the extent phase: the oracle returns the
    expected rows, from the brute force above (None: the port's host
    evaluate over the whole batch)."""
    from geomesa_tpu_torch.filters.helper import dwithin_degrees
    from geomesa_tpu_torch.geometry import Point
    b, ms = c["bounds"][:n], c["ms"][:n]

    def days(lo, hi):   # DURING: exclusive bounds
        return (f" AND dtg DURING {_iso(EXTENT_T0_DAY + lo)}/"
                f"{_iso(EXTENT_T0_DAY + hi)}",
                (ms > (EXTENT_T0_DAY + lo) * MS_DAY)
                & (ms < (EXTENT_T0_DAY + hi) * MS_DAY))

    def box_ring(x0, y0, x1, y1):
        return np.array([(x0, y0), (x1, y0), (x1, y1), (x0, y1), (x0, y0)])

    def env_rows(env, tmask=None):
        m = ((b[:, 0] <= env[2]) & (b[:, 2] >= env[0])
             & (b[:, 1] <= env[3]) & (b[:, 3] >= env[1]))
        return np.flatnonzero(m if tmask is None else m & tmask)

    def by_ring(ring, tmask=None):
        env = (*ring.min(axis=0), *ring.max(axis=0))
        rows = env_rows(env, tmask)
        return lambda: rows[city_intersects(c, rows, ring)]

    out = []
    hood = (-73.99, 40.72, -73.98, 40.73)
    t30, m30 = days(60, 90)
    out.append(("hood_bbox_30d", f"BBOX(geom, {', '.join(map(str, hood))})"
                + t30, by_ring(box_ring(*hood), m30)))
    # the XZ curve's cells (precision 12: 0.088 degrees of longitude) are
    # coarser than a neighbourhood, so over 30 days its candidates pass
    # the pruned path's 50,000 rows at 1.2M features; a week stays under
    t7, m7 = days(60, 67)
    out.append(("hood_bbox_7d", f"BBOX(geom, {', '.join(map(str, hood))})"
                + t7, by_ring(box_ring(*hood), m7)))
    boro = (-74.10, 40.57, -73.80, 40.87)
    t90, m90 = days(100, 190)
    out.append(("borough_bbox_90d", f"BBOX(geom, {', '.join(map(str, boro))})"
                + t90, by_ring(box_ring(*boro), m90)))
    tt, mt = days(200, 230)
    out.append(("time_30d", tt[5:], lambda: np.flatnonzero(mt)))
    # a 100-vertex star over most of the region: its envelope holds
    # about 50-100k rows of the 30 days
    ang = np.linspace(0, 2 * np.pi, 101)[:-1]
    rad = 0.14 * (1 + 0.12 * np.sin(7 * ang))
    star = np.stack([-73.98 + rad * np.cos(ang) / 0.76,
                     40.705 + rad * np.sin(ang)], axis=1)
    star = np.concatenate([star, star[:1]])
    out.append(("intersects_polygon_100v_30d",
                f"INTERSECTS(geom, POLYGON({_ring_text(star)}))" + t30,
                by_ring(star, m30)))
    px, py = -73.98, 40.75
    deg = dwithin_degrees(Point(px, py), 500.0, "meters")
    drows = env_rows((px - deg, py - deg, px + deg, py + deg))
    out.append(("dwithin_500m", f"DWITHIN(geom, POINT({px} {py}), 500, "
                f"meters)", lambda: drows[city_dwithin(c, drows, px, py,
                                                       deg)]))
    out.append(("crosses_line",
                "CROSSES(geom, LINESTRING(-74.25 40.7001, -73.98 40.7002, "
                "-73.71 40.7003))", None))
    # a parallelogram on a footprint's far corner, pointing away from
    # it, touches it at that vertex (a shared vertex is exact in f64,
    # where a shared rotated edge's midpoint is not)
    k = int(np.flatnonzero(c["is_poly"][:n])[0])
    v = c["verts"][k, :5]
    a, b2 = v[1] - v[0], v[2] - v[1]
    corner = np.array([v[2], v[2] + a, v[2] + a + b2, v[2] + b2, v[2]])
    out.append(("touches_polygon",
                f"TOUCHES(geom, POLYGON({_ring_text(corner)}))", None))
    return out


def _extent_strategy(res) -> str:
    text = res.explain.text
    notes = [k for k, line in (("xz_pruned_host", "XZ-pruned host scan"),
                               ("tristate", "Device extent scan"),
                               ("exact", "Exact predicate on"))
             if line in text]
    return "+".join([res.plan.index] + notes)


def phase_extent(seed: int) -> tuple[dict, int]:
    """An extent store shaped like a city's building footprints and
    street centerlines, its queries held to the brute force, the
    tristate's calls held to the plain version."""
    from geomesa_tpu_torch import InMemoryDataStore
    from geomesa_tpu_torch.filters.ecql import parse_ecql
    from geomesa_tpu_torch.filters.evaluate import evaluate
    from geomesa_tpu_torch.scan import kernels
    t_phase = time.perf_counter()
    c = city_arrays(seed, EXTENT_POLYGONS, EXTENT_LINES)
    total = len(c["ms"])
    ids = np.array([f"c{i}" for i in range(total)], dtype=object)
    ds = InMemoryDataStore()
    ds.create_schema("city", EXTENT_SPEC)
    sft = ds.get_schema("city")
    from geomesa_tpu_torch.features.batch import FeatureBatch
    build_s = write_s = 0.0
    n = 0
    reduced = None
    while n < total:
        hi = min(total, n + EXTENT_CHUNK)
        t0 = time.perf_counter()
        geoms = city_geoms(c, n, hi)
        t1 = time.perf_counter()
        ds.write("city", FeatureBatch.from_dict(sft, ids[n:hi], {
            "name": c["names"][n:hi],
            "dtg": c["ms"][n:hi].astype("datetime64[ms]"), "geom": geoms}))
        t2 = time.perf_counter()
        build_s += t1 - t0
        write_s += t2 - t1
        n = hi
        # stop early (at the least feature count) once the writes so far
        # project the phase past its budget
        per_row = (time.perf_counter() - t_phase) / n
        if (n >= EXTENT_MIN_FEATURES and n < total and per_row * min(
                total, n + EXTENT_CHUNK) * EXTENT_PHASE_PER_WRITE
                > EXTENT_BUDGET_S):
            reduced = {"features": n, "from": total,
                       "why": f"the writes projected the phase past "
                              f"{EXTENT_BUDGET_S} s"}
            break
    st = ds._types["city"]
    t0 = time.perf_counter()
    st.ensure_index()
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    queries = city_queries(c, n)

    calls = []
    real = kernels.extent_tristate
    current = [None]

    def recorder(*args):
        out = real(*args)
        calls.append((current[0], args, out))
        return out
    kernels.reset_launches()
    per_q, wrong, first_ids = [], [], {}
    t_main = time.perf_counter()
    try:
        kernels.extent_tristate = recorder
        for qname, ecql, _ in queries:
            current[0] = qname
            t0 = time.perf_counter()
            res = ds.query(ecql, "city")
            got = res.rows
            first_ms = (time.perf_counter() - t0) * 1e3
            count = ds.query_count(ecql, "city")
            first_ids[qname] = (res, got, count, first_ms)
    finally:
        kernels.extent_tristate = real
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    launches = kernels.launches["extent_tristate"]

    batch = st.batch
    for qname, ecql, oracle in queries:
        res, got, count, first_ms = first_ids[qname]
        t0 = time.perf_counter()
        want = (np.flatnonzero(evaluate(parse_ecql(ecql), batch))
                if oracle is None else np.sort(oracle()))
        oracle_s = time.perf_counter() - t0
        ok = (np.array_equal(got, want) and np.array_equal(res.ids, ids[want])
              and count == len(want))
        if not ok:
            wrong.append((qname, len(got), len(want), count))
        times = [first_ms] + [_timed(lambda e=ecql: ds.query(e, "city").ids)
                              for _ in range(EXTENT_RUNS - 1)]
        states = [out for q, _a, out in calls if q == qname]
        per_q.append({
            "query": qname, "hits": len(want), "exact": ok,
            "strategy": _extent_strategy(res),
            "explain": [ln.strip() for ln in res.explain.text.splitlines()
                        if any(k in ln for k in ("XZ-pruned", "extent scan",
                                                 "Exact predicate"))],
            "p50_ms": statistics.median(times), "runs_ms": times,
            "oracle": "brute_f64" if oracle is not None else "host_evaluate",
            "oracle_s": oracle_s,
            "tristate": [dict(zip(("out", "maybe", "in"), torch.bincount(
                s.to(torch.int64), minlength=3).tolist())) for s in states]})

    # outside the counted run: every call the path made against the plain
    # version, then the kernel timed at each call's shape
    checks = []
    for qname, args, out in calls:
        plain = kernels.extent_tristate_plain(*args)
        same = torch.equal(out, plain)
        bms, bby = extent_bound(args)
        checks.append({
            "query": qname, "rows": args[0].shape[0],
            "boxes": args[3].shape[0], "intervals": args[5].shape[0],
            "equal": same, "ms": cuda_ms(lambda a=args: real(*a), 20),
            "plain_ms": cuda_ms(
                lambda a=args: kernels.extent_tristate_plain(*a), 3, 1),
            "bound_ms": bms, "bound_by": bby})
        if not same:
            wrong.append(("extent_tristate", qname))
    emit({"phase": "extent", "features": n, "reduced": reduced,
          "build_geoms_s": build_s, "write_s": write_s, "index_s": index_s,
          "extent_device_bytes": st.extent_data.nbytes,
          "queries": per_q, "kernel_checks": checks,
          "launches": {"extent_tristate": launches}, "counted_s": main_s,
          "seconds": time.perf_counter() - t_phase, "wrong": wrong})
    if wrong:
        raise SystemExit(f"extent: wrong results: {wrong}")
    if launches == 0:
        raise SystemExit("extent_tristate never launched on the extent path")
    ds.remove_schema("city")
    return checks, launches


# -- analytics: the joins and KNN (BASELINE.md configurations 3, 4, 5) -------

JOIN_KERNELS = ("dwithin_counts", "slab_pairs", "contains_counts", "knn_topk")
SOURCES.update({
    "dwithin_counts": "geomesa_tpu/analytics/join.py:60 _dwithin_counts_all "
                      "(body :48 _dwithin_matrices)",
    "slab_pairs": "geomesa_tpu/analytics/join.py:123 _slab_cand_mask "
                  "(+ :137, :148, :159; :473 _contains_cand_mask + :493, "
                  ":501)",
    "contains_counts": "geomesa_tpu/analytics/join.py:420 "
                       "_contains_counts_all (+ :389 _pip_body, :454 "
                       "_contains_band_rows)",
    "knn_topk": "geomesa_tpu/analytics/join.py:635 _knn_kernel",
})
SOURCE_FILES.update({k: "geomesa_tpu_torch/csrc/join.cu" for k in JOIN_KERNELS})
# H100 SXM float32 instructions a second outside the tensor cores: the
# data sheet's 67 TFLOP/s counts an FMA as two operations, and the join
# kernels round every step alone (no FMA), so each operation they count
# is one instruction at half that rate
F32_OPS_PER_S = 33.5e12
DW_QUERIES, DW_RADIUS = 1_000, 0.25      # BASELINE #3 on the store's 10M
DW_WIDE_QUERIES, DW_WIDE_RADIUS = 64, 30.0   # slabs of a sixth of the table
KNN_ROWS, KNN_CAP, KNN_K = 50_000_000, 1 << 26, 100   # BASELINE #4
KNN_POINTS = [(10.0, 10.0), (-120.0, 40.0), (0.0, 0.0), (150.0, -30.0),
              (-60.0, -60.0), (80.0, 20.0), (-10.0, 55.0), (100.0, 5.0)]
CT_ROWS, CT_CAP, CT_RECTS, CT_STARS = 100_000_000, 1 << 27, 10_000, 32
CT_SAMPLE, CT_PAIRS = 256, 100           # BASELINE #5's checked polygons
AN_RUNS = 3                              # host-clock runs per call's p50
PIP_PAIR_OPS, BOX_OPS, KNN_OPS, DW_OPS = 23, 4, 6, 7


def contains_polygons(seed: int):
    """bench.py's config-5 rectangles (half-sides 0.05-0.5 degrees), then
    star polygons with holes (star_ring, 64 vertices, a 16-vertex hole
    about the same centre): (wkts, stars as (shell, hole, cx, cy, rx,
    ry))."""
    rng = np.random.default_rng(seed + 5)
    cx = rng.uniform(-175, 175, CT_RECTS)
    cy = rng.uniform(-85, 85, CT_RECTS)
    w = rng.uniform(0.05, 0.5, CT_RECTS)
    h = rng.uniform(0.05, 0.5, CT_RECTS)
    wkts = [f"POLYGON (({cx[i]-w[i]} {cy[i]-h[i]}, {cx[i]+w[i]} {cy[i]-h[i]}, "
            f"{cx[i]+w[i]} {cy[i]+h[i]}, {cx[i]-w[i]} {cy[i]+h[i]}, "
            f"{cx[i]-w[i]} {cy[i]-h[i]}))" for i in range(CT_RECTS)]
    stars = []
    for _ in range(CT_STARS):
        sx, sy = rng.uniform(-170, 170), rng.uniform(-80, 80)
        rx, ry = rng.uniform(0.5, 3.0), rng.uniform(0.5, 3.0)
        shell = star_ring(sx, sy, rx, ry, 64, k=int(rng.integers(3, 8)),
                          wobble=0.3, phase=float(rng.uniform(0, 3)))
        hole = star_ring(sx, sy, 0.3 * rx, 0.3 * ry, 16)
        stars.append((shell, hole, sx, sy, rx, ry))
        wkts.append(f"POLYGON({_ring_wkt(shell)}, {_ring_wkt(hole)})")
    return wkts, stars


def _union_len(los, widths) -> int:
    """Rows covered by the slabs [lo, lo + width): each counted once."""
    keep = widths > 0
    lo, hi = los[keep].astype(np.int64), (los + widths)[keep].astype(np.int64)
    if not len(lo):
        return 0
    o = np.argsort(lo)
    lo, hi = lo[o], np.maximum.accumulate(hi[o])
    starts = np.r_[True, lo[1:] > hi[:-1]]
    ends = np.r_[starts[1:], True]
    return int((hi[ends] - lo[starts]).sum())


def _time_once(fn):
    """(fn(), its ms on the card): one run between CUDA events."""
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def _join_equal(name, got, want) -> tuple[bool, int]:
    """(equal, max |error|) of a join wrapper's outputs and its plain
    version's: integers as integers, the knn window's d2 by its bits
    (every NaN one NaN)."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            return False, -1
        if g.dtype == torch.float32:
            g, w = (t.masked_fill(t.isnan(), float("nan")).view(torch.int32)
                    for t in (g, w))
        err = max(err, _err(g, w))
    return err == 0, err


def _slab_launcher(args):
    """Both passes of the slab kernels (counts, then writes) on their
    tile lists and buffers prepared once (the prefix of the counts taken
    once), so the events time the kernels; and the lists."""
    from geomesa_tpu_torch.scan import kernels
    xs, ys, order, los, widths, qa, r2, eps, box = args
    dev = xs.device
    lib = kernels._library()
    lists = kernels.tile_lists(los, widths, xs.shape[0])
    counts = torch.empty(max(lists.total, 1), dtype=torch.int32, device=dev)
    bits = torch.empty(max(lists.total, 1) * (kernels.JOIN_TILE // 32),
                       dtype=torch.int32, device=dev)
    incl = kernels._slab_counts_launch(xs, ys, los, widths, qa, r2, eps, box,
                                       lists, counts, bits)
    total = max(int(incl[-1]), 1)
    rows = torch.empty(total, dtype=torch.int32, device=dev)
    qi = torch.empty(total, dtype=torch.int32, device=dev)
    groups = -(-lists.most // kernels.SLAB_GROUP)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tables = (lists.offsets.data_ptr(), lists.objs.data_ptr(), groups,
              lists.perm.data_ptr(), los.data_ptr(), widths.data_ptr())

    def run():
        lib.geomesa_slab_counts(xs.data_ptr(), ys.data_ptr(), xs.shape[0],
                                *tables, int(box), qa.data_ptr(), r2, eps,
                                counts.data_ptr(), bits.data_ptr(), stream)
        lib.geomesa_slab_write(order.data_ptr(), xs.shape[0], *tables,
                               counts.data_ptr(), incl.data_ptr(),
                               bits.data_ptr(), rows.data_ptr(),
                               qi.data_ptr(), stream)
    return run, lists


def _xsorted(args):
    """The (xs, ys) of a recorded dwithin call: its ``xsorted``, or a
    sort of its columns."""
    from geomesa_tpu_torch.scan import kernels
    if len(args) > 7 and args[7] is not None:
        return args[7][:2]
    return kernels.sorted_by_x(args[0], args[1], args[6])[:2]


def _dwithin_launcher(args):
    """The dwithin kernel alone on its tile lists, built once from the
    call's x-sorted table (the recorded ``xsorted``, or a sort here) and
    its own slabs, into outputs prepared once; and the lists."""
    from geomesa_tpu_torch.scan import kernels
    px, py, qx, qy, hi, lo, n = args[:7]
    xs, ys = _xsorted(args)
    lists = kernels.tile_lists(*kernels.dwithin_slabs(xs, qx, hi, lo),
                               xs.shape[0])
    definite = torch.zeros(qx.shape[0], dtype=torch.int32, device=px.device)
    band = torch.zeros_like(definite)
    return lambda: kernels._dwithin_counts_launch(
        xs, ys, lists, qx, qy, hi, lo, definite, band), lists


def _contains_launcher(args):
    """The counts pass of the contains kernel (the edge terms, then the
    counts) on its tile lists and buffers prepared once; and the lists."""
    from geomesa_tpu_torch.scan import kernels
    xs, ys, order, los, widths, boxes, edges, ecount, eps, eps2, _ = args
    lists = kernels.tile_lists(los, widths, xs.shape[0])
    dc = torch.zeros(los.shape[0], dtype=torch.int32, device=xs.device)
    bc = torch.zeros_like(dc)
    terms = torch.empty_like(edges)
    return lambda: kernels._contains_counts_launch(
        xs, ys, los, widths, boxes, edges, ecount, eps, eps2, lists, terms,
        dc, bc), lists


def _contains_rows_launcher(args):
    """The rows pass of the contains kernel alone (the edge terms, then
    the rows), on its work items (from one counts pass) and an output
    prepared once: (items, launch)."""
    from geomesa_tpu_torch.scan import kernels
    xs, ys, order, los, widths, boxes, edges, ecount, eps, eps2, cap = args
    dev = xs.device
    kp = los.shape[0]
    lists = kernels.tile_lists(los, widths, xs.shape[0])
    dc = torch.zeros((2, kp), dtype=torch.int32, device=dev)
    terms = torch.empty_like(edges)
    cband = kernels._contains_counts_launch(xs, ys, los, widths, boxes, edges,
                                            ecount, eps, eps2, lists, terms,
                                            dc[0], dc[1])
    banded = np.flatnonzero(dc[1].cpu().numpy())
    items = kernels.contains_rows_items(lists, cband, banded, kp, cap)
    out = torch.full((len(banded), cap), -1, dtype=torch.int32, device=dev)
    lib = kernels._library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    return items.shape[0], lambda: lib.geomesa_contains_band_rows(
        xs.data_ptr(), ys.data_ptr(), order.data_ptr(), xs.shape[0],
        los.data_ptr(), widths.data_ptr(), items.data_ptr(), items.shape[0],
        boxes.data_ptr(), edges.data_ptr(), ecount.data_ptr(), kp,
        edges.shape[1], eps, eps2, terms.data_ptr(), cap, out.data_ptr(),
        stream)


def _lists_ms(los, widths, ncols) -> float:
    """Host-clock ms of one tile_lists build (torch ops on the card, one
    copy to the host), the median of five."""
    from geomesa_tpu_torch.scan import kernels
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kernels.tile_lists(los, widths, ncols)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _plain_args(name, args):
    """A recorded call's arguments for its plain version: the dwithin
    wrapper's x-sorted table is its own business."""
    return args[:7] if name == "dwithin_counts" else args


def dwithin_wide(seed: int, resident, n: int) -> dict:
    """The dwithin kernel at a wide radius (DW_WIDE_RADIUS over
    DW_WIDE_QUERIES seeded points on the store's resident columns, whose
    slabs cover about a sixth of the table each): the wrapper held to its
    plain version, the kernel timed alone beside the plain version and
    the bounds."""
    from geomesa_tpu_torch.scan import kernels
    from geomesa_tpu_torch.utils.fp import f32_band
    px, py = resident
    rng = np.random.default_rng(seed + 14)
    dev = px.device
    qx = torch.from_numpy(rng.uniform(-170, 170, DW_WIDE_QUERIES)
                          .astype(np.float32)).to(dev)
    qy = torch.from_numpy(rng.uniform(-80, 80, DW_WIDE_QUERIES)
                          .astype(np.float32)).to(dev)
    hi, lo = (float(np.float32(v)) for v in f32_band(DW_WIDE_RADIUS, 360.0))
    xsorted = kernels.sorted_by_x(px, py, n)[:2]
    args = (px, py, qx, qy, hi, lo, n, xsorted)
    got = kernels.dwithin_counts(*args)
    want, plain_ms = _time_once(
        lambda: kernels.dwithin_counts_plain(*args[:7]))
    same, err = _join_equal("dwithin_counts", got, want)
    kern, lists = _dwithin_launcher(args)
    los, widths = kernels.dwithin_slabs(xsorted[0], qx, hi, lo)
    w = widths.cpu().numpy()
    tb = (8 * _union_len(los.cpu().numpy(), w) + 16 * DW_WIDE_QUERIES) \
        / HBM_BYTES_PER_S * 1e3
    to = DW_OPS * int(w.sum()) / F32_OPS_PER_S * 1e3
    return {"equal": same, "max_abs_err": err, "radius": DW_WIDE_RADIUS,
            "queries": DW_WIDE_QUERIES, "rows": n,
            "slab_columns": int(w.sum()), "tile_entries": lists.total,
            "pairs": int(got[0].sum().item() + got[1].sum().item()),
            "ms": cuda_ms(kern, 20), "plain_ms": plain_ms,
            "bound_ms": max(tb, to), "bound_by": "bytes" if tb >= to
            else "operations", "all_pairs_bound_ms":
                DW_OPS * n * DW_WIDE_QUERIES / F32_OPS_PER_S * 1e3}


def join_kernel_line(name, args, out) -> dict:
    """One join kernel at one recorded call's shape: the kernel timed
    alone (20 held runs), its plain version once (its output is the one
    compared), and the bound, larger of bytes and operations."""
    from geomesa_tpu_torch.scan import kernels
    plain = {"dwithin_counts": kernels.dwithin_counts_plain,
             "slab_pairs": kernels.slab_pairs_plain,
             "contains_counts": kernels.contains_counts_plain,
             "knn_topk": kernels.knn_topk_plain}[name]
    want, plain_ms = _time_once(lambda: plain(*_plain_args(name, args)))
    same, err = _join_equal(name, out, want)
    extra = {}
    if name == "dwithin_counts":
        px, py, qx, qy, hi, lo, n = args[:7]
        k = qx.shape[0]
        kern, lists = _dwithin_launcher(args)
        los, widths = kernels.dwithin_slabs(_xsorted(args)[0], qx, hi, lo)
        w = widths.cpu().numpy()
        # the slabs' union read once, the queries and the counts
        nbytes = 8 * _union_len(los.cpu().numpy(), w) + 16 * k
        ops = DW_OPS * int(w.sum())
        shape = {"rows": n, "queries": k, "slab_columns": int(w.sum()),
                 "tile_entries": lists.total,
                 "tile_columns": lists.total * kernels.JOIN_TILE,
                 "lists_ms": _lists_ms(los, widths, px.shape[0]),
                 "wrapper_ms": cuda_ms(lambda: kernels.dwithin_counts(*args),
                                       20)}
        extra["all_pairs_bound_ms"] = DW_OPS * n * k / F32_OPS_PER_S * 1e3
    elif name == "slab_pairs":
        xs, ys, order, los, widths, qa, *_r, box = args
        w = widths.cpu().numpy()
        cols, m = int(w.sum()), out[0].shape[0]
        kern, lists = _slab_launcher(args)
        nbytes = (8 * _union_len(los.cpu().numpy(), w) + qa.numel() * 4
                  + 8 * los.shape[0] + 8 * m)
        ops = (BOX_OPS if box else DW_OPS - 1) * cols
        shape = {"queries": los.shape[0], "slab_columns": cols,
                 "pairs": m, "mode": "box" if box else "radius",
                 "tile_entries": lists.total, "timed": "both passes",
                 "lists_ms": _lists_ms(los, widths, xs.shape[0]),
                 "wrapper_ms": cuda_ms(lambda: kernels.slab_pairs(*args),
                                       20)}
    elif name == "contains_counts":
        xs, ys, order, los, widths, boxes, edges, ecount = args[:8]
        w = widths.cpu().numpy()
        kern, lists = _contains_launcher(args)
        # the columns inside each widened box (the box-mode candidates)
        inbox = kernels.slab_pairs(xs, ys, order, los, widths, boxes, 0.0,
                                   args[8], True)[1]
        edge_pairs = int(ecount.to(torch.int64)[inbox.long()].sum().item())
        nbytes = (8 * _union_len(los.cpu().numpy(), w)
                  + 16 * int(ecount.sum().item()) + boxes.numel() * 4
                  + los.shape[0] * (8 + 4 * args[10]))
        ops = BOX_OPS * int(w.sum()) + PIP_PAIR_OPS * edge_pairs
        shape = {"polygons": int((w > 0).sum()), "slab_columns": int(w.sum()),
                 "in_box_rows": int(inbox.shape[0]),
                 "in_box_edge_pairs": edge_pairs, "band_rows": int(
                     out[1].sum().item()), "tile_entries": lists.total,
                 "tiles": lists.ntiles, "longest_list": lists.most,
                 "lists_ms": _lists_ms(los, widths, xs.shape[0]),
                 "timed": "the counts pass"}
    else:
        px, py, qx, qy, kpad, n = args
        nq = qx.shape[0]
        kern = lambda: kernels.knn_topk(*args)   # noqa: E731
        nbytes, ops = 8 * n + 8 * nq + 12 * nq * kpad, KNN_OPS * n * nq
        shape = {"rows": n, "queries": nq, "kpad": kpad,
                 "plan": kernels.knn_plan(min(px.shape[0], n + kpad), nq,
                                          kpad)}
        extra["library_ms"] = _topk_ms(args)
        extra["library"] = ("torch.topk(d2, kpad, largest=False): selection "
                            "only, d2 precomputed")
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / F32_OPS_PER_S * 1e3
    return {"equal": same, "max_abs_err": err, **shape,
            "ms": cuda_ms(kern, 20), "plain_ms": plain_ms,
            "bound_ms": max(tb, to), "bound_by": "bytes" if tb >= to
            else "operations", "bytes_bound_ms": tb, "ops_bound_ms": to,
            "library_ms": None, **extra}


def _topk_ms(args) -> float:
    """The nearest library yardstick for the knn kernel: one
    torch.topk(d2, kpad, largest=False) over the (nq, n) f32 d2 of the
    call's rows, precomputed outside the timing (selection only; the
    port never calls it)."""
    px, py, qx, qy, kpad, n = args
    d2 = (px[None, :n] - qx[:, None]) ** 2 + (py[None, :n] - qy[:, None]) ** 2
    ms = cuda_ms(lambda: torch.topk(d2, kpad, dim=1, largest=False), 10)
    del d2
    torch.cuda.empty_cache()
    return ms


def knn_batcher_line(resident, n: int, bq) -> dict:
    """The knn kernel at the batcher's largest shape: the store's resident
    columns against the first 32 of its queries, k = KNN_K (kpad 256),
    held to its plain version and timed beside its bounds."""
    from geomesa_tpu_torch.scan import kernels
    from geomesa_tpu_torch.scan.zscan import next_pow2
    dev = resident[0].device
    qx = torch.tensor([q[0] for q in bq[:32]], dtype=torch.float32,
                      device=dev)
    qy = torch.tensor([q[1] for q in bq[:32]], dtype=torch.float32,
                      device=dev)
    kpad = min(next_pow2(KNN_K + 32), resident[0].shape[0])
    args = (resident[0], resident[1], qx, qy, kpad, n)
    return join_kernel_line("knn_topk", args, kernels.knn_topk(*args))


def _main_call(calls, name, tag):
    """(args, outputs) of the recorded call of kernel ``name`` in run
    ``tag`` with the most queries (or polygons)."""
    return max(((a, o) for q, nm, a, o in calls if nm == name and q == tag),
               key=lambda c: c[0][3].shape[0] if name == "slab_pairs"
               else c[0][2].shape[0])


def _f64_knn(xt, yt, qx, qy, k):
    """Exact f64 top-k on the card, (distance, id) order: a stable sort
    of the f64 squared distances (ties keep the lower id)."""
    d2 = (xt - qx) ** 2 + (yt - qy) ** 2
    return torch.sort(d2, stable=True).indices[:k].cpu().numpy()


def run_knn_batcher(qb, bq, k) -> dict:
    """QueryBatcher.knn from 32 threads x 8 points: the answers, the
    seconds, the batcher's counters, its dispatches of more than one
    query and the knn_topk launches of this run alone."""
    import threading
    from geomesa_tpu_torch.scan import kernels
    res = [None] * len(bq)
    multi = []
    inner = qb._dispatch_knn

    def counted(type_name, kk, chunk):
        if len(chunk) > 1:
            multi.append(len(chunk))
        inner(type_name, kk, chunk)
    qb._dispatch_knn = counted

    def worker(t):
        for i in range(t * 8, t * 8 + 8):
            res[i] = qb.knn("ais", bq[i][0], bq[i][1], k)
    before = kernels.launches["knn_topk"]
    t0 = time.perf_counter()
    ts = [threading.Thread(target=worker, args=(t,)) for t in range(32)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    seconds = time.perf_counter() - t0
    return {"res": res, "seconds": seconds,
            "queries_per_s": len(bq) / seconds,
            "multi_query_dispatches": len(multi),
            "knn_topk_launches": kernels.launches["knn_topk"] - before,
            **qb.stats()}


def phase_analytics(seed: int, ds, rows) -> tuple[dict, dict]:
    """The joins and KNN at BASELINE.md's shapes: DWithin on the store,
    KNN at 50M points and on the store (processes and the batcher),
    Contains at 100M points x 10k polygons; every answer held to a float64
    brute force; every recorded join-kernel call held to its plain
    version."""
    from geomesa_tpu_torch.analytics import join, processes
    from geomesa_tpu_torch.geometry import parse_wkt
    from geomesa_tpu_torch.scan import kernels
    from geomesa_tpu_torch.scan.batcher import QueryBatcher
    t_phase = time.perf_counter()
    x, y, _ms, ids = rows
    st = ds._types["ais"]
    dev = st.device
    st.ensure_index()
    resident = (st.scan_data.xhi, st.scan_data.yhi)
    rng = np.random.default_rng(seed + 11)
    wrong = []

    calls = []
    real = {k: getattr(kernels, k) for k in
            JOIN_KERNELS + ("contains_band_rows",)}
    current = [None]

    def recorder(name):
        def rec(*args, **kw):   # keywords are the trailing parameters
            args += tuple(kw.values())
            out = real[name](*args)
            calls.append((current[0], name, args,
                          out if isinstance(out, tuple) else (out,)))
            return out
        return rec

    # BASELINE #3's inputs and its f64 brute force: a host argsort of x,
    # a searchsorted slab of +-r, the exact d2 over every query's slab
    qx = rng.uniform(-170, 170, DW_QUERIES)
    qy = rng.uniform(-80, 80, DW_QUERIES)
    t0 = time.perf_counter()
    xo = np.argsort(x, kind="stable")
    xsort = x[xo]
    lo = np.searchsorted(xsort, qx - DW_RADIUS, side="left")
    hi = np.searchsorted(xsort, qx + DW_RADIUS, side="right")
    dw_rows = []
    for j in range(DW_QUERIES):
        c = xo[lo[j]:hi[j]]
        dw_rows.append(np.sort(c[(x[c] - qx[j]) ** 2 + (y[c] - qy[j]) ** 2
                                 <= DW_RADIUS * DW_RADIUS]))
    dw_counts = np.array([len(r) for r in dw_rows])
    dw_oracle_s = time.perf_counter() - t0

    # BASELINE #4's table: 50M points as f32 in a 2^26-row buffer
    rk = np.random.default_rng(seed + 12)
    kx = rk.uniform(-180, 180, KNN_ROWS)
    ky = rk.uniform(-90, 90, KNN_ROWS)
    kdev = tuple(torch.zeros(KNN_CAP, dtype=torch.float32, device=dev)
                 for _ in range(2))
    kdev[0][:KNN_ROWS] = torch.from_numpy(kx.astype(np.float32)).to(dev)
    kdev[1][:KNN_ROWS] = torch.from_numpy(ky.astype(np.float32)).to(dev)
    kqx = np.array([q[0] for q in KNN_POINTS])
    kqy = np.array([q[1] for q in KNN_POINTS])
    # batcher queries: 32 threads x 8 points over the store, through the
    # default (adaptive) batcher and one whose static 200 ms linger makes
    # its dispatches carry many queries each
    bq = [(float(a), float(b)) for a, b in zip(
        rng.uniform(-170, 170, 256), rng.uniform(-80, 80, 256))]
    batchers = {"default": QueryBatcher(ds),
                "linger_200ms_static": QueryBatcher(
                    ds, linger_us=200_000, adaptive=False)}

    kernels.reset_launches()
    t_main = time.perf_counter()
    out = {}
    try:
        for name in real:
            setattr(kernels, name, recorder(name))
        current[0] = "dwithin"
        t0 = time.perf_counter()
        out["prox_counts"] = processes.proximity_process(
            ds, "ais", qx, qy, DW_RADIUS, counts_only=True)
        out["first_prox_counts_ms"] = (time.perf_counter() - t0) * 1e3
        out["prox_pairs"] = processes.proximity_process(ds, "ais", qx, qy,
                                                        DW_RADIUS)
        out["dw_counts"] = join.dwithin_join(x, y, qx, qy, DW_RADIUS,
                                             counts_only=True,
                                             device_xy=resident)
        out["dw_pairs"] = join.dwithin_join(x, y, qx, qy, DW_RADIUS,
                                            device_xy=resident)
        current[0] = "knn_50m"
        out["knn50"] = join.knn_batched(kx, ky, kqx, kqy, KNN_K,
                                        device_xy=kdev)
        current[0] = "knn_store"
        out["knn_scalar"] = [processes.knn_process(ds, "ais", a, b, KNN_K)
                             for a, b in KNN_POINTS]
        out["knn_array"] = processes.knn_process(ds, "ais", kqx, kqy, KNN_K)
        current[0] = "batcher"
        out["batcher"] = {name: run_knn_batcher(qb, bq, KNN_K)
                          for name, qb in batchers.items()}
    finally:
        for name, fn in real.items():
            setattr(kernels, name, fn)
    torch.cuda.synchronize()
    store_s = time.perf_counter() - t_main
    launches = {k: kernels.launches[k] for k in JOIN_KERNELS}

    # -- exactness on the store -------------------------------------------
    pc, _ = out["prox_counts"]
    _, pids = out["prox_pairs"]
    want_ids = ids[np.unique(np.concatenate(dw_rows))]
    if not (np.array_equal(pc, dw_counts)
            and np.array_equal(out["prox_pairs"][0], dw_counts)
            and list(pids) == list(want_ids)):
        wrong.append("proximity_process")
    jc, _ = out["dw_counts"]
    pcnt, pairs = out["dw_pairs"]
    got_pairs = pairs[np.lexsort((pairs[:, 0], pairs[:, 1]))]
    want_pairs = np.concatenate(
        [np.stack([r, np.full(len(r), j)], 1) for j, r in enumerate(dw_rows)])
    if not (np.array_equal(jc, dw_counts) and np.array_equal(pcnt, dw_counts)
            and np.array_equal(got_pairs, want_pairs)):
        wrong.append("dwithin_join")
    xt = torch.from_numpy(x).to(dev)
    yt = torch.from_numpy(y).to(dev)
    for (a, b), (sids, sd), (aids, ad) in zip(
            KNN_POINTS, out["knn_scalar"], out["knn_array"]):
        want = ids[_f64_knn(xt, yt, a, b, KNN_K)]
        if list(sids) != list(want) or list(aids) != list(want):
            wrong.append(("knn_process", a, b))
    for i, (a, b) in enumerate(bq):
        want = list(ids[_f64_knn(xt, yt, a, b, KNN_K)])
        for name, run in out["batcher"].items():
            if list(run["res"][i][0]) != want:
                wrong.append(("batcher", name, a, b))
    # a dispatch of more than one query goes through the batched kernel
    # (one query alone may take the host z-ring); the static linger must
    # coalesce, so its run holds this check to at least one such dispatch
    for name, run in out["batcher"].items():
        if run["knn_topk_launches"] < run["multi_query_dispatches"]:
            wrong.append(("batcher dispatches without knn_topk", name,
                          run["multi_query_dispatches"],
                          run["knn_topk_launches"]))
    if out["batcher"]["linger_200ms_static"]["multi_query_dispatches"] == 0:
        wrong.append(("batcher never coalesced", "linger_200ms_static"))
    del xt, yt
    # BASELINE #4's oracle: argpartition + (d2, id) lexsort per query
    t0 = time.perf_counter()
    for i, (a, b) in enumerate(KNN_POINTS):
        d2 = (kx - a) ** 2 + (ky - b) ** 2
        cand = np.argpartition(d2, KNN_K + 64)[:KNN_K + 64]
        if not np.array_equal(out["knn50"][1][i],
                              cand[np.lexsort((cand, d2[cand]))][:KNN_K]):
            wrong.append(("knn_batched_50m", a, b))
    knn_oracle_s = time.perf_counter() - t0

    p50 = {
        "proximity_counts": [_timed(lambda: processes.proximity_process(
            ds, "ais", qx, qy, DW_RADIUS, counts_only=True))
            for _ in range(AN_RUNS)],
        "proximity_pairs": [_timed(lambda: processes.proximity_process(
            ds, "ais", qx, qy, DW_RADIUS)) for _ in range(AN_RUNS)],
        "dwithin_counts": [_timed(lambda: join.dwithin_join(
            x, y, qx, qy, DW_RADIUS, counts_only=True, device_xy=resident))
            for _ in range(AN_RUNS)],
        "dwithin_pairs": [_timed(lambda: join.dwithin_join(
            x, y, qx, qy, DW_RADIUS, device_xy=resident))
            for _ in range(AN_RUNS)],
        "knn_batched_50m_8q": [_timed(lambda: join.knn_batched(
            kx, ky, kqx, kqy, KNN_K, device_xy=kdev)) for _ in range(AN_RUNS)],
        "knn_process_scalar": [_timed(lambda: processes.knn_process(
            ds, "ais", *KNN_POINTS[i % 8], KNN_K)) for i in range(AN_RUNS)],
        "knn_process_array_8q": [_timed(lambda: processes.knn_process(
            ds, "ais", kqx, kqy, KNN_K)) for _ in range(AN_RUNS)],
    }
    del kx, ky
    # the kernel lines at the store's and the 50M table's shapes (the
    # calls are still referenced by ``calls``)
    lines = {name: join_kernel_line(name, *_main_call(calls, name, tag))
             for name, tag in (("dwithin_counts", "dwithin"),
                               ("slab_pairs", "dwithin"),
                               ("knn_topk", "knn_50m"))}
    lines["dwithin_counts"]["wide"] = dwithin_wide(seed, resident, len(x))
    lines["knn_topk"]["batcher_32"] = knn_batcher_line(resident, len(x), bq)
    lines["knn_topk"]["batcher_largest_call"] = max(
        a[2].shape[0] for q, nm, a, _ in calls
        if nm == "knn_topk" and q == "batcher")
    xsort_ms = {"store_10m": cuda_ms(
        lambda: kernels.sorted_by_x(*resident, len(x)), 5)}
    checks = [("wide radius", "dwithin_counts",
               lines["dwithin_counts"]["wide"]["equal"]),
              ("batcher 32", "knn_topk",
               lines["knn_topk"]["batcher_32"]["equal"])]
    for q, name, args, res_ in calls:
        if name in ("contains_counts", "contains_band_rows"):
            continue
        plain = getattr(kernels, name + "_plain")
        same = _join_equal(name, res_, plain(*_plain_args(name, args)))[0]
        checks.append((q, name, same))
    calls.clear()
    del kdev
    torch.cuda.empty_cache()

    # -- BASELINE #5: 100M points x 10k rectangles + 32 stars -------------
    rc = np.random.default_rng(seed + 13)
    cx_ = rc.uniform(-180, 180, CT_ROWS)
    cy_ = rc.uniform(-90, 90, CT_ROWS)
    cdev = tuple(torch.zeros(CT_CAP, dtype=torch.float32, device=dev)
                 for _ in range(2))
    cdev[0][:CT_ROWS] = torch.from_numpy(cx_.astype(np.float32)).to(dev)
    cdev[1][:CT_ROWS] = torch.from_numpy(cy_.astype(np.float32)).to(dev)
    wkts, stars = contains_polygons(seed)
    t0 = time.perf_counter()
    polys = [parse_wkt(w) for w in wkts]
    parse_s = time.perf_counter() - t0
    sample = np.sort(np.r_[rc.choice(CT_RECTS, CT_SAMPLE - CT_STARS,
                                     replace=False),
                           CT_RECTS + np.arange(CT_STARS)])
    pair_sel = np.r_[sample[:CT_PAIRS - 16], CT_RECTS + np.arange(16)]
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        for name in real:
            setattr(kernels, name, recorder(name))
        current[0] = "contains"
        counts, _ = join.contains_join(polys, cx_, cy_, counts_only=True,
                                       device_xy=cdev)
        first_contains_s = time.perf_counter() - t0
        current[0] = "contains_pairs"
        pcounts, cpairs = join.contains_join([polys[j] for j in pair_sel],
                                             cx_, cy_, device_xy=cdev)
    finally:
        for name, fn in real.items():
            setattr(kernels, name, fn)
    torch.cuda.synchronize()
    for k in JOIN_KERNELS:
        launches[k] += kernels.launches[k]
    # the f64 brute force of the sample: the closed box on the card for
    # a rectangle; the box's candidates through in_star (shell minus the
    # hole's interior) on the host for a star
    X = torch.from_numpy(cx_).to(dev)
    Y = torch.from_numpy(cy_).to(dev)

    def brute_rows(j):
        env = polys[j].envelope
        m = (X >= env.xmin) & (X <= env.xmax) & (Y >= env.ymin) & \
            (Y <= env.ymax)
        cand = torch.nonzero(m).flatten().cpu().numpy()
        if j < CT_RECTS:
            return cand
        shell, hole, sx, sy, rx, ry = stars[j - CT_RECTS]
        px_, py_ = cx_[cand], cy_[cand]
        inside = in_star(px_, py_, shell, sx, sy, rx, ry)
        in_hole = in_star(px_, py_, hole, sx, sy, 0.3 * rx, 0.3 * ry)
        on_hole = _on_ring(px_, py_, hole, in_hole)
        return cand[inside & ~(in_hole & ~on_hole)]

    t0 = time.perf_counter()
    brute = {int(j): brute_rows(int(j)) for j in np.union1d(sample, pair_sel)}
    ct_oracle_s = time.perf_counter() - t0
    bad = [int(j) for j in sample if counts[j] != len(brute[int(j)])]
    if bad:
        wrong.append(("contains_join counts", bad[:10]))
    order_ = np.lexsort((cpairs[:, 0], cpairs[:, 1]))
    cpairs = cpairs[order_]
    bounds = np.searchsorted(cpairs[:, 1], np.arange(len(pair_sel) + 1))
    for i, j in enumerate(pair_sel):
        got = cpairs[bounds[i]:bounds[i + 1], 0]
        if not (np.array_equal(got, brute[int(j)])
                and pcounts[i] == len(brute[int(j)])):
            wrong.append(("contains_join pairs", int(j)))
    del X, Y
    xsort_ms["contains_100m"] = cuda_ms(
        lambda: kernels.sorted_by_x(*cdev, CT_ROWS), 5)
    p50["contains_counts_10k"] = [_timed(lambda: join.contains_join(
        polys, cx_, cy_, counts_only=True, device_xy=cdev))
        for _ in range(AN_RUNS)]
    args, res_ = _main_call(calls, "contains_counts", "contains")
    lines["contains_counts"] = join_kernel_line("contains_counts", args, res_)
    # the slab kernels in box mode at contains_join's pairs shape
    lines["slab_pairs"]["box_contains_pairs"] = join_kernel_line(
        "slab_pairs", *_main_call(calls, "slab_pairs", "contains_pairs"))
    band_polys = np.flatnonzero(res_[1].cpu().numpy())
    rows_items, rows_run = _contains_rows_launcher(args)
    rows_ms = cuda_ms(rows_run, 20) if rows_items else None
    for q, name, args, res_ in calls:
        if name == "contains_counts" and q == "contains":
            continue   # held to its plain version in its line above
        plain = getattr(kernels, name + "_plain")
        checks.append((q, name, _join_equal(name, res_, plain(
            *_plain_args(name, args)))[0]))
    checks += [("kernel line", nm, ln["equal"]) for nm, ln in lines.items()]
    checks.append(("kernel line", "slab_pairs box",
                   lines["slab_pairs"]["box_contains_pairs"]["equal"]))
    calls.clear()
    join.clear_xsort_cache()
    del cdev, cx_, cy_
    torch.cuda.empty_cache()
    for q, name, same in checks:
        if not same:
            wrong.append(("plain", q, name))
    # the x-sort on a line of its own: the dwithin and contains calls
    # read a resident table's cached sort, outside their kernels' times
    emit({"phase": "analytics_xsort", "ms": xsort_ms,
          "rows": {"store_10m": len(x), "contains_100m": CT_ROWS}})
    emit({"phase": "analytics", "store_rows": len(x),
          "dwithin": {"queries": DW_QUERIES, "radius": DW_RADIUS,
                      "pairs": int(dw_counts.sum()),
                      "first_proximity_counts_ms":
                          out["first_prox_counts_ms"],
                      "oracle_s": dw_oracle_s},
          "knn": {"rows": KNN_ROWS, "cap": KNN_CAP, "k": KNN_K,
                  "queries": len(KNN_POINTS), "oracle_s": knn_oracle_s,
                  "batcher": {name: {"threads": 32, "per_thread": 8,
                                     **{k: v for k, v in run.items()
                                        if k != "res"}}
                              for name, run in out["batcher"].items()}},
          "contains": {"rows": CT_ROWS, "cap": CT_CAP,
                       "polygons": len(polys), "stars": CT_STARS,
                       "checked": len(sample), "pairs_checked": len(pair_sel),
                       "total": int(counts.sum()),
                       "band_polygons": int(len(band_polys)),
                       "parse_s": parse_s, "first_s": first_contains_s,
                       "band_rows_pass_ms": rows_ms,
                       "band_rows_pass_items": rows_items,
                       "oracle_s": ct_oracle_s},
          "p50_ms": {k: statistics.median(v) for k, v in p50.items()},
          "runs_ms": p50, "store_counted_s": store_s,
          "launches": launches, "kernel_lines": lines,
          "plain_checks": len(checks),
          "seconds": time.perf_counter() - t_phase, "wrong": wrong})
    if wrong:
        raise SystemExit(f"analytics: wrong results: {wrong}")
    missing = [k for k in JOIN_KERNELS if launches[k] == 0]
    if missing:
        raise SystemExit(f"join kernels never launched on the analytics "
                         f"path: {missing}")
    return lines, launches, (qx, qy, dw_counts)


# -- the sql phase ------------------------------------------------------------

SQL_BUDGET_S = 60.0       # the sql phase's share of the script's time
SQL_RUNS = 5              # host-clock runs per timed statement for its p50
SQL_KERNELS = ("scan_mask", "scan_mask_gather", "scan_count", "pip_mask",
               "residual_mask", "dwithin_counts", "slab_pairs",
               "contains_counts")
# about 29 % of the rows, so the z-index candidates (about 3M of 10M)
# pass the host tier's 2M and go through the gathered scan kernel
SQL_WHERE = (f"ST_Contains(ST_MakeBBOX(-120, -60, 120, 70), geom) AND "
             f"dtg >= '{_iso(T0_DAY + 10)}' AND dtg < '{_iso(T0_DAY + 70)}'")
SQL_WHERE_BOX = (-120.0, -60.0, 120.0, 70.0)
SQL_WHERE_DAYS = (T0_DAY + 10, T0_DAY + 70)
SQL_LEG_ROWS = 2_000_000  # config 19's rows, split over its 4 groups
SQL_LEGS = 4
SQL_GEOHASH_ROWS = 1_000
SQL_KNN = (12.34, 41.2, 10, 0.5)   # qx, qy, k, estimated distance
# bench.py config 19's statements on the GDELT-shaped columns
SQL_AGG = [
    "SELECT Actor1CountryCode, COUNT(*), SUM(NumMentions), MIN(AvgTone), "
    "MAX(AvgTone), AVG(AvgTone) FROM gdelt GROUP BY Actor1CountryCode",
    "SELECT Actor1CountryCode, COUNT(*) AS cnt FROM gdelt "
    "GROUP BY Actor1CountryCode ORDER BY cnt DESC LIMIT 5",
    "SELECT COUNT(*), SUM(NumMentions), AVG(AvgTone) FROM gdelt",
    "SELECT Actor1CountryCode, ST_Extent(geom) FROM gdelt "
    "GROUP BY Actor1CountryCode",
]
SQL_JOIN = [
    "SELECT COUNT(*) FROM gdelt p "
    "JOIN zones19 z ON ST_Contains(z.geom, p.geom)",
    "SELECT z.zname, COUNT(*) FROM gdelt p "
    "JOIN zones19 z ON ST_Contains(z.geom, p.geom) GROUP BY z.zname",
]


def zone19_boxes() -> list:
    """bench.py config 19's 16 zone boxes: 15 x 25 degrees."""
    return [(-160.0 + 20 * (i % 16), -60.0 + 30 * (i // 8),
             -145.0 + 20 * (i % 16), -35.0 + 30 * (i // 8))
            for i in range(16)]


def _sql_launches() -> dict:
    from geomesa_tpu_torch.scan import kernels
    return {k: kernels.launches[k] for k in SQL_KERNELS}


def _sql_timed(engine, sql: str, runs: int = SQL_RUNS):
    """(result, first-call ms, p50 ms of ``runs`` more calls)."""
    t0 = time.perf_counter()
    res = engine.query(sql)
    first = (time.perf_counter() - t0) * 1e3
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        engine.query(sql)
        times.append((time.perf_counter() - t0) * 1e3)
    return res, first, statistics.median(times)


def geohash_plain(lon: float, lat: float, chars: int) -> str:
    """The textbook geohash (geohash.org): bisect lon and lat in turn,
    lon first, five bits a base-32 character."""
    alphabet = "0123456789bcdefghjkmnpqrstuvwxyz"
    lo = [-180.0, -90.0]
    hi = [180.0, 90.0]
    v, out = (lon, lat), []
    bit, ch, even = 0, 0, True
    while len(out) < chars:
        d = 0 if even else 1
        mid = (lo[d] + hi[d]) / 2
        if v[d] >= mid:
            ch = ch * 2 + 1
            lo[d] = mid
        else:
            ch = ch * 2
            hi[d] = mid
        even = not even
        bit += 1
        if bit == 5:
            out.append(alphabet[ch])
            bit, ch = 0, 0
    return "".join(out)


def phase_sql_ais(ds, rows, dw) -> tuple[dict, dict]:
    """BASELINE #3 through SQL on the store phase's 10M rows: the
    COUNT(*) DWithin join of the analytics phase's 1,000 query points
    and its grouped form, held to that phase's f64 brute force; the
    join must reach the kernel with the store's resident columns."""
    from geomesa_tpu_torch.analytics import join
    from geomesa_tpu_torch.scan import kernels
    from geomesa_tpu_torch.sql import SqlEngine
    t_phase = time.perf_counter()
    x, y, _ms, _ids = rows
    qx, qy, dw_counts = dw
    st = ds._types["ais"]
    st.ensure_index()
    resident = (st.scan_data.xhi, st.scan_data.yhi)
    ds.create_schema("qpts", "*geom:Point:srid=4326")
    qids = np.array([f"q{j}" for j in range(len(qx))], dtype=object)
    ds.write_dict("qpts", qids, {"geom": (qx, qy)})
    engine = SqlEngine(ds)
    seen = []
    real = join.dwithin_join

    def spy(*a, **kw):
        seen.append(kw.get("device_xy"))
        return real(*a, **kw)
    count_sql = ("SELECT count(*) AS n FROM ais a JOIN qpts b "
                 f"ON ST_DWithin(a.geom, b.geom, {DW_RADIUS})")
    group_sql = ("SELECT b.__fid__ AS q, COUNT(*) AS n FROM ais a "
                 f"JOIN qpts b ON ST_DWithin(a.geom, b.geom, {DW_RADIUS}) "
                 "GROUP BY b.__fid__")
    wrong = []
    kernels.reset_launches()
    join.dwithin_join = spy
    try:
        res, first_ms, p50_ms = _sql_timed(engine, count_sql)
        n_count_calls = len(seen)
        grouped, g_first_ms, g_p50_ms = _sql_timed(engine, group_sql)
    finally:
        join.dwithin_join = real
    launches = _sql_launches()
    # the direct call config 3 measures against, outside the counted run
    direct = []
    for _ in range(SQL_RUNS + 1):
        t0 = time.perf_counter()
        dc, _ = join.dwithin_join(x, y, qx, qy, DW_RADIUS, counts_only=True,
                                  device_xy=resident)
        direct.append((time.perf_counter() - t0) * 1e3)
    direct_p50 = statistics.median(direct[1:])
    total = int(dw_counts.sum())
    if res.names != ["n"] or int(res.column("n")[0]) != total:
        wrong.append(("count", res.names, list(res.column(res.names[0]))))
    if int(dc.sum()) != total:
        wrong.append("direct count")
    resident_ok = (n_count_calls == SQL_RUNS + 1
                   and all(d is not None and d[0] is resident[0]
                           and d[1] is resident[1]
                           for d in seen[:n_count_calls]))
    if not resident_ok:
        wrong.append("count join without the resident columns")
    want = {f"q{j}": int(c) for j, c in enumerate(dw_counts) if c}
    got = {str(q): int(n) for q, n in grouped.rows()}
    if grouped.names != ["q", "n"] or got != want:
        wrong.append(("grouped", len(got), len(want)))
    if launches["dwithin_counts"] < SQL_RUNS + 1:
        wrong.append(("dwithin_counts launches", launches["dwithin_counts"]))
    if launches["slab_pairs"] < SQL_RUNS + 1:
        wrong.append(("slab_pairs launches", launches["slab_pairs"]))
    # where the statement's time goes, after the counted run
    profile = profile_top(lambda: engine.query(count_sql), top=8)
    ds.remove_schema("qpts")
    out = {"phase": "sql_ais", "rows": len(x), "queries": len(qx),
           "radius": DW_RADIUS, "pairs": total,
           "count_join": {"first_ms": first_ms, "p50_ms": p50_ms,
                          "direct_p50_ms": direct_p50,
                          "sql_over_direct": p50_ms / direct_p50,
                          "resident_columns": resident_ok},
           "grouped_join": {"first_ms": g_first_ms, "p50_ms": g_p50_ms,
                            "groups": len(got)},
           "profile_count_join": profile, "launches": launches,
           "seconds": time.perf_counter() - t_phase, "wrong": wrong}
    emit(out)
    if wrong:
        raise SystemExit(f"sql_ais: wrong results: {wrong}")
    return out, launches


# -- the web phase: the REST surface and its client on the card's store ------

WEB_BUDGET_S = 90.0       # the web phase's share of the script's time
WEB_NORTH_RUNS = 20       # the north star through the client and direct
WEB_LOAD_PER_THREAD = 4   # 32 client threads x 4 of the 32 batch queries
WEB_WRITE_ROWS, WEB_DELETE_ROWS = 1_000, 100
WEB_TILE = (-80.0, 30.0, -60.0, 45.0)     # a 256 x 256 density tile
WEB_KNN = (10.0, 10.0, 100)               # x, y, k
# the kernels the web requests must reach (scan_count is reported too):
# the route sweep's, and the batched scan's through the fused /rest/query
# dispatches (config 13's phase A makes one for certain)
ROUTE_KERNELS = ("scan_mask", "scan_mask_gather", "density_grid",
                 "knn_topk", "dwithin_counts", "slab_pairs")
WEB_KERNELS = ROUTE_KERNELS + ("scan_batch_bits", "compact_prefix",
                               "compact_bits")
WEB_KNN_BURST = 32        # concurrent /rest/knn requests, one fused top-k
WEB_COUNTERS = ("resilience.web.errors", "resilience.retries",
                "resilience.web.sheds", "resilience.web.stream_aborts")
CHAOS8_POINTS, CHAOS8_QUERIES = 200_000, 300          # bench.py config 8
TAIL13_ROWS, TAIL13_WEB, TAIL13_EMB = 200_000, 16, 16  # bench.py config 13
TAIL13_QUERIES, TAIL13_SLOW_S = 150, 0.25


def _web_counters() -> dict:
    return {k: _counter(k) for k in WEB_COUNTERS}


def _web_get(port: int, path: str, body=None, headers=None):
    """One request to the server on localhost: (status, headers, body)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST" if body is not None else "GET", path, body=body,
                     headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _pct_ms(lat) -> dict:
    a = np.asarray(lat) * 1e3
    return {"p50_ms": float(np.percentile(a, 50)),
            "p95_ms": float(np.percentile(a, 95)),
            "p99_ms": float(np.percentile(a, 99))}


def web_load(client, ecqls, truth, ids, threads: int, per: int) -> dict:
    """``threads`` callers x ``per`` of the queries through ``client``
    (Arrow replies), each checked against its brute-force ids."""
    import threading
    lat, wrong, errors = [], [], []

    def caller(t):
        try:
            for j in range(per):
                i = (t * per + j) % len(ecqls)
                t0 = time.perf_counter()
                res = client.query(ecqls[i], "ais")
                lat.append(time.perf_counter() - t0)
                if not np.array_equal(res.ids, ids[truth[i]]):
                    wrong.append(i)
        except Exception as e:  # noqa: BLE001 - reported by the caller
            errors.append(repr(e))
    th = [threading.Thread(target=caller, args=(t,)) for t in range(threads)]
    t0 = time.perf_counter()
    for t in th:
        t.start()
    for t in th:
        t.join(300.0)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in th):
        errors.append("a caller did not finish in 300 s")
    return {"threads": threads, "queries": len(lat), "seconds": wall,
            "queries_per_s": len(lat) / wall,
            "p50_ms": statistics.median(lat) * 1e3 if lat else None,
            "wrong": wrong[:5], "errors": errors[:3]}


def web_knn_burst(server, ds, points, k: int) -> list:
    """``points`` as concurrent /rest/knn requests, fused into batched
    top-k calls by the server's batcher: a gate query holds a dispatch
    in flight (as bench.py config 13 holds one) and the linger is static
    and long, so the burst's leader waits for the burst (the queue's cap
    is the batcher's max_batch, the burst's size; an adaptive linger
    would size the wait from the first arrivals' gaps). A request that
    reaches the server late rides a dispatch of its own. Returns the
    replies in the points' order."""
    import threading
    from geomesa_tpu_torch import Query
    from geomesa_tpu_torch.scan.batcher import BATCH_LINGER_MICROS
    b = server.batcher
    if len(points) != b.max_batch:
        raise SystemExit(f"knn burst of {len(points)} against a batch cap "
                         f"of {b.max_batch}")
    hold = threading.Event()
    gate = Query("ais", "BBOX(geom, 0, 0, 0.001, 0.001)")
    real = ds.query

    def gated(q, *a, **kw):
        if q is gate and not hold.wait(60.0):
            raise RuntimeError("gate never released")
        return real(q, *a, **kw)
    replies: list = [None] * len(points)
    barrier = threading.Barrier(len(points))

    def caller(i):
        barrier.wait()
        qx, qy = points[i]
        replies[i] = json.loads(_web_get(
            server.port, f"/rest/knn/ais?x={qx!r}&y={qy!r}&k={k}")[2])
    ds.query = gated
    adaptive, b.adaptive = b.adaptive, False
    BATCH_LINGER_MICROS.set(str(int(5e6)))
    warm = threading.Thread(target=b.query, args=(gate,), daemon=True)
    try:
        warm.start()
        deadline = time.perf_counter() + 30.0
        while b._in_flight < 1 and time.perf_counter() < deadline:
            time.sleep(0.001)
        th = [threading.Thread(target=caller, args=(i,), daemon=True)
              for i in range(len(points))]
        for t in th:
            t.start()
        for t in th:
            t.join(120.0)
    finally:
        hold.set()
        warm.join(30.0)
        del ds.query
        b.adaptive = adaptive
        BATCH_LINGER_MICROS.set(None)
    return replies


def web_routes(seed: int, ds, rows, dw) -> tuple[dict, dict]:
    """(a) Every route against its oracle on the store phase's 10M rows,
    through a GeoMesaWebServer and the port's RemoteDataStore on
    localhost; the clean legs' server errors and client retries, and the
    kernels the routes reached (counts zeroed before, read after the
    web requests; the oracles' direct calls come after)."""
    from geomesa_tpu_torch.analytics.processes import knn_process
    from geomesa_tpu_torch.features import FeatureBatch
    from geomesa_tpu_torch.scan import kernels
    from geomesa_tpu_torch.scan.registry import batcher_registry
    from geomesa_tpu_torch.sql import SqlEngine
    from geomesa_tpu_torch.store import RemoteDataStore
    from geomesa_tpu_torch.utils.properties import SystemProperty
    from geomesa_tpu_torch.web import GeoMesaWebServer
    from urllib.parse import quote
    host_rows = SystemProperty("geomesa.scan.host.rows")
    threshold = SystemProperty("geomesa.scan.index.threshold")
    x, y, ms, ids = rows
    qx, qy, dw_counts = dw
    specs = store_batch_specs(seed)
    ecqls = [_ecql(boxes, iv) for boxes, iv in specs]
    truth = [_brute(x, y, ms, boxes, iv) for boxes, iv in specs]
    north, nboxes, niv = STORE_QUERIES[0]
    north_truth = _brute(x, y, ms, nboxes, niv)
    # set-up outside the counted run: the join's query points as a type
    ds.create_schema("qpts", "*geom:Point:srid=4326")
    ds.write_dict("qpts", np.array([f"q{j}" for j in range(len(qx))],
                                   dtype=object), {"geom": (qx, qy)})
    count_sql = ("SELECT count(*) AS n FROM ais a JOIN qpts b "
                 f"ON ST_DWithin(a.geom, b.geom, {DW_RADIUS})")
    rng = np.random.default_rng(seed + 23)
    w_ids = np.array([f"web{i}" for i in range(WEB_WRITE_ROWS)], dtype=object)
    # north of 85 degrees (past every join point's radius and the knn
    # points' reach) and after the store's dates: the oracles computed
    # after these writes see the rows the requests saw
    w_x = rng.uniform(20.0, 30.0, WEB_WRITE_ROWS)
    w_y = rng.uniform(85.0, 89.0, WEB_WRITE_ROWS)
    w_day = T1_DAY + 10
    w_ms = rng.integers(w_day * MS_DAY, (w_day + 1) * MS_DAY, WEB_WRITE_ROWS)
    w_box = (f"BBOX(geom, 20, 85, 30, 89) AND dtg DURING "
             f"{_iso(w_day - 1)}/{_iso(w_day + 2)}")
    deleted = w_ids[:WEB_DELETE_ROWS]
    tile_ecql = north
    ds.invalidate_cache()        # the pushdowns below are misses
    batcher_registry.clear()
    server = GeoMesaWebServer(ds).start()
    wrong, out = [], {}
    try:
        if server._cuda_index != torch.cuda.current_device():
            wrong.append(("request device", server._cuda_index))
        client = RemoteDataStore("127.0.0.1", server.port, hedge=False)
        client.get_schema("ais")
        sft = client.get_schema("ais")
        c0 = _web_counters()
        b0 = (server.batcher.batches, server.batcher.coalesced_queries)
        kernels.reset_launches()
        t_main = time.perf_counter()
        # the north star and the 32 batch queries, one at a time (Arrow)
        got = [client.query(e, "ais") for e in [north] + ecqls]
        # the gathered and dense tiers, forced as the store phase does
        tier_got = {}
        for tier, (h, thr) in {"gathered": ("0", "1.0"),
                               "dense": ("0", "0")}.items():
            host_rows.set(h)
            threshold.set(thr)
            try:
                tier_got[tier] = [(client.query(e, "ais"),
                                   client.query_count(e, "ais"))
                                  for e, _, _ in STORE_QUERIES]
            finally:
                host_rows.set(None)
                threshold.set(None)
        t0 = time.perf_counter()
        st_json, _, body_json = _web_get(
            server.port, f"/rest/query/ais?cql={quote(north)}&format=json")
        json_ms = (time.perf_counter() - t0) * 1e3
        feats = json.loads(body_json)["features"]
        n_count = json.loads(_web_get(
            server.port, f"/rest/count/ais?cql={quote(north)}")[2])["count"]
        dpath = (f"/rest/density/ais?bbox={','.join(map(str, WEB_TILE))}"
                 f"&width=256&height=256&cql={quote(tile_ecql)}")
        st_d, hd, body_d = _web_get(server.port, dpath)
        web_grid = np.asarray(json.loads(body_d)["grid"], np.float32)
        st_304, _, body_304 = _web_get(server.port, dpath,
                                       headers={"If-None-Match":
                                                hd.get("ETag", "")})
        web_bin = client.bin_query("ais", north)
        web_stats = client.stats_query("ais", "MinMax(dtg)", north)
        kx, ky, kk = WEB_KNN
        knn_points = [(kx, ky)] + [
            (float(a), float(b)) for a, b in zip(
                rng.uniform(-170, 170, WEB_KNN_BURST - 1),
                rng.uniform(-80, 80, WEB_KNN_BURST - 1))]
        kb0 = server.batcher.batches
        knn = web_knn_burst(server, ds, knn_points, kk)
        knn_dispatches = server.batcher.batches - kb0 - 1   # less the gate
        sql = json.loads(_web_get(server.port, "/rest/sql",
                                  body=count_sql.encode())[2])
        routes_s = time.perf_counter() - t_main
        # the wire's cost and the load, 1 and 32 client threads
        wire_ms = [_timed(lambda: client.query(north, "ais").ids)
                   for _ in range(WEB_NORTH_RUNS)]
        load1 = web_load(client, ecqls, truth, ids, 1, len(ecqls))
        bl = (server.batcher.batches, server.batcher.coalesced_queries)
        load32 = web_load(client, ecqls, truth, ids, BATCHER_THREADS,
                          WEB_LOAD_PER_THREAD)
        fused = {"batches": server.batcher.batches - bl[0],
                 "coalesced_queries": (server.batcher.coalesced_queries
                                       - bl[1]),
                 "registry_shared": batcher_registry.get(ds)
                 is server.batcher}
        # writes through the ingest pipeline, then deletes; read back by
        # box and by id (last: the load's answers are the 10M rows')
        t0 = time.perf_counter()
        client.write("ais", FeatureBatch.from_dict(
            sft, w_ids, {"dtg": w_ms, "geom": (w_x, w_y)}))
        after_write = (sorted(client.query(w_box, "ais").ids),
                       client.query_count(w_box, "ais"))
        client.delete("ais", list(deleted))
        id_ecql = "IN (" + ", ".join(f"'{i}'" for i in w_ids[:200]) + ")"
        after_delete = (sorted(client.query(w_box, "ais").ids),
                        sorted(client.query(id_ecql, "ais").ids))
        write_s = time.perf_counter() - t0
        main_s = time.perf_counter() - t_main
        counts = {k: kernels.launches[k] for k in WEB_KERNELS + (
            "scan_count",)}
        c1 = _web_counters()
        batches = server.batcher.batches - b0[0]
    finally:
        server.stop()
        batcher_registry.clear()
    direct_ms = [_timed(lambda: ds.query(north, "ais").ids)
                 for _ in range(WEB_NORTH_RUNS)]

    # the oracles, after the counted run
    for i, (res, want) in enumerate(zip(got, [north_truth] + truth)):
        if not np.array_equal(res.ids, ids[want]):
            wrong.append(("query", i))
    for tier, pairs in tier_got.items():
        for (res, n), (_e, boxes, iv) in zip(pairs, STORE_QUERIES):
            want = _brute(x, y, ms, boxes, iv)
            if not np.array_equal(res.ids, ids[want]) or n != len(want):
                wrong.append((tier, _e))
    if st_json != 200 or [f["id"] for f in feats] != list(ids[north_truth]):
        wrong.append("format=json")
    if n_count != len(north_truth):
        wrong.append("count")
    grid = _cache_off(lambda: np.asarray(ds.density(
        "ais", tile_ecql, WEB_TILE, 256, 256), np.float32))
    if st_d != 200 or not np.array_equal(web_grid, grid) or not hd.get(
            "ETag"):
        wrong.append("density")
    if st_304 != 304 or body_304:
        wrong.append(("density If-None-Match", st_304))
    if web_bin != _cache_off(lambda: ds.bin_query("ais", north)):
        wrong.append("bin")
    if web_stats != _cache_off(lambda: ds.stats_query(
            "ais", "MinMax(dtg)", north)).to_json_object():
        wrong.append("stats")
    for j, ((px, py), reply) in enumerate(zip(knn_points, knn)):
        k_ids, k_d = knn_process(ds, "ais", px, py, kk)
        if reply is None or reply["ids"] != [str(i) for i in k_ids] or \
                reply["distances"] != np.asarray(k_d, np.float64).tolist():
            wrong.append(("knn", j))
    direct_sql = SqlEngine(ds).query(count_sql)
    if sql["rows"] != [[int(direct_sql.column("n")[0])]] or \
            sql["rows"][0][0] != int(dw_counts.sum()):
        wrong.append(("sql", sql.get("rows")))
    if after_write != (sorted(w_ids), WEB_WRITE_ROWS):
        wrong.append(("write", after_write[1]))
    if after_delete != (sorted(w_ids[WEB_DELETE_ROWS:]),
                        sorted(w_ids[WEB_DELETE_ROWS:200])):
        wrong.append("delete")
    ds.remove_schema("qpts")
    clean = {k: c1[k] - c0[k] for k in WEB_COUNTERS}
    if clean["resilience.web.errors"] or clean["resilience.retries"]:
        wrong.append(("clean counters", clean))
    missing = [k for k in ROUTE_KERNELS if counts[k] == 0]
    if missing:
        wrong.append(("kernels never launched on the routes", missing))
    errors = load1["errors"] + load32["errors"]
    wrong += [("load", w) for w in load1["wrong"] + load32["wrong"]]
    out = {"part": "routes", "rows": len(x), "routes_s": routes_s,
           "write_delete_s": write_s, "seconds": main_s, "json_ms": json_ms,
           "knn_burst": {"requests": len(knn_points), "k": kk,
                         "dispatches": knn_dispatches},
           "json_bytes": len(body_json), "json_rows": len(feats),
           "north_hits": len(north_truth),
           "north_p50_ms": {"client": statistics.median(wire_ms),
                            "direct": statistics.median(direct_ms)},
           "load": {"1": load1, "32": load32}, "fused_32": fused,
           "dispatches": batches, "clean_counters": clean,
           "launches": counts, "wrong": wrong[:8], "errors": errors}
    return out, counts


def web_config8(seed: int) -> tuple[dict, dict]:
    """(b) bench.py config 8 at its shapes: 200k points, 300 BBOX queries
    through a RemoteDataStore direct, then through a ChaosProxy with 1 %
    resets and 10 ms jitter; the breaker's fast-fail against a
    black-holed endpoint. The socket-broker restart leg of config 8 runs
    in the stream phase (stream_chaos)."""
    from geomesa_tpu_torch import InMemoryDataStore
    from geomesa_tpu_torch.resilience import (BreakerBoard, ChaosProxy,
                                              CircuitOpenError, RetryPolicy)
    from geomesa_tpu_torch.scan import kernels
    from geomesa_tpu_torch.scan.registry import batcher_registry
    from geomesa_tpu_torch.store import RemoteDataStore
    from geomesa_tpu_torch.web import GeoMesaWebServer
    rng = np.random.default_rng(seed + 80)
    n, nq = CHAOS8_POINTS, CHAOS8_QUERIES
    x = rng.uniform(-180, 180, n)
    y = rng.uniform(-90, 90, n)
    ids = np.arange(n).astype(str).astype(object)
    ds = InMemoryDataStore()
    ds.create_schema("pts8", "*geom:Point:srid=4326")
    ds.write_dict("pts8", ids, {"geom": (x, y)})
    q_rng = np.random.default_rng(77)
    boxes = []
    for _ in range(nq):
        x0 = float(q_rng.uniform(-170, 130))
        y0 = float(q_rng.uniform(-80, 55))
        boxes.append((x0, y0, x0 + 5, y0 + 5))
    ecqls = [f"BBOX(geom, {a:.4f}, {b:.4f}, {c:.4f}, {d:.4f})"
             for a, b, c, d in boxes]
    truth = [tuple(sorted(ids[_brute(x, y, None, [(float(f"{a:.4f}"),
                                                   float(f"{b:.4f}"),
                                                   float(f"{c:.4f}"),
                                                   float(f"{d:.4f}"))],
                                     None)]))
             for a, b, c, d in boxes]

    def run(client):
        got, times, errors = [], [], 0
        for e in ecqls:
            t0 = time.perf_counter()
            try:
                got.append(tuple(sorted(client.query(e, "pts8").ids)))
            except Exception:  # noqa: BLE001 - counted: the gate
                errors += 1
                got.append(None)
            times.append(time.perf_counter() - t0)
        return got, {"qps": nq / sum(times), **_pct_ms(times),
                     "client_errors": errors}

    batcher_registry.clear()
    kernels.reset_launches()
    srv = GeoMesaWebServer(ds).start()
    out = {"part": "config8", "points": n, "queries": nq}
    try:
        direct = RemoteDataStore("127.0.0.1", srv.port)
        direct.query(ecqls[0], "pts8")
        c0 = _web_counters()
        clean_ids, out["clean"] = run(direct)
        c1 = _web_counters()
        out["clean"]["counters"] = {k: c1[k] - c0[k] for k in WEB_COUNTERS}
        out["clean"]["ids_exact"] = clean_ids == truth
        proxy = ChaosProxy("127.0.0.1", srv.port, reset_rate=0.01,
                           jitter_s=0.010, seed=42).start()
        try:
            faulty = RemoteDataStore("127.0.0.1", proxy.port, timeout_s=10.0)
            r0 = _counter("resilience.retries")
            chaos_ids, chaos = run(faulty)
            chaos["resets_injected"] = proxy.stats["resets"]
            chaos["retries"] = _counter("resilience.retries") - r0
            chaos["ids_exact"] = chaos_ids == clean_ids
            out["chaos_1pct_resets"] = chaos
        finally:
            proxy.stop()
        hole = ChaosProxy("127.0.0.1", srv.port, blackhole=True).start()
        try:
            dead = RemoteDataStore(
                "127.0.0.1", hole.port, timeout_s=0.3,
                retry_policy=RetryPolicy(max_attempts=1),
                breakers=BreakerBoard(failure_threshold=2,
                                      reset_timeout_s=60.0))
            trip = []
            for _ in range(2):
                t0 = time.perf_counter()
                try:
                    dead.count("pts8")
                except Exception:  # noqa: BLE001 - the timeouts that trip
                    pass
                trip.append(time.perf_counter() - t0)
            ff, opened = [], 0
            for _ in range(20):
                t0 = time.perf_counter()
                try:
                    dead.count("pts8")
                except CircuitOpenError:
                    opened += 1
                ff.append(time.perf_counter() - t0)
            out["breaker"] = {"timeout_s": 0.3,
                              "trip_ms": [t * 1e3 for t in trip],
                              "fast_fail_p50_us": statistics.median(ff) * 1e6,
                              "fast_fails": opened}
        finally:
            hole.stop()
    finally:
        srv.stop()
        batcher_registry.clear()
    out["launches"] = {k: kernels.launches[k] for k in WEB_KERNELS + (
        "scan_count",)}
    out["broker_restart"] = "in the stream phase (stream_chaos)"
    wrong = []
    if out["clean"]["client_errors"] or not out["clean"]["ids_exact"] \
            or out["clean"]["counters"]["resilience.web.errors"] \
            or out["clean"]["counters"]["resilience.retries"]:
        wrong.append("clean leg")
    if chaos["client_errors"] or not chaos["ids_exact"]:
        wrong.append("chaos leg")
    if out["breaker"]["fast_fails"] != 20:
        wrong.append("breaker")
    out["wrong"] = wrong
    return out, out["launches"]


def web_config13(seed: int) -> tuple[dict, dict]:
    """(c) bench.py config 13 at its shapes: 200k rows; (A) 16 web and
    16 embedded callers in one fused dispatch, ids exact against direct
    store.query; (B) hedged against unhedged p99 through a straggler
    proxy (10 % of connections stall 0.25 s), the hedge counters and the
    budget invariant; (C) the latency-derived batch cap."""
    import threading
    from geomesa_tpu_torch import InMemoryDataStore, Query
    from geomesa_tpu_torch.resilience import ChaosProxy
    from geomesa_tpu_torch.scan import kernels
    from geomesa_tpu_torch.scan.batcher import (BATCH_LATENCY_BUDGET_MS,
                                                BATCH_LINGER_ADAPTIVE,
                                                BATCH_LINGER_MICROS,
                                                BATCH_MAX_SIZE)
    from geomesa_tpu_torch.scan.registry import (batcher_registry,
                                                 shared_batcher)
    from geomesa_tpu_torch.store import RemoteDataStore
    from geomesa_tpu_torch.web import GeoMesaWebServer
    n, cw, ce = TAIL13_ROWS, TAIL13_WEB, TAIL13_EMB
    nq, slow = TAIL13_QUERIES, TAIL13_SLOW_S
    total = cw + ce
    rng = np.random.default_rng(seed + 130)

    class GateStore(InMemoryDataStore):
        """Holds the gate query in flight so the burst's leader lingers."""

        def __init__(self):
            super().__init__()
            self.hold = threading.Event()
            self.gate = None

        def query(self, q, *args, **kwargs):
            if q is self.gate:
                if not self.hold.wait(60.0):
                    raise RuntimeError("gate never released")
            return super().query(q, *args, **kwargs)

    ds = GateStore()
    ds.create_schema("tail13", "dtg:Date,*geom:Point:srid=4326")
    ds.write_dict("tail13", np.arange(n).astype(str).astype(object),
                  {"dtg": rng.integers(T0_DAY * MS_DAY, T1_DAY * MS_DAY, n),
                   "geom": (rng.uniform(-180, 180, n),
                            rng.uniform(-90, 90, n))})

    def bbox_q(i, w=4.0, h=4.0):
        x0 = -170.0 + (i * 37) % 330
        y0 = -80.0 + (i * 23) % 150
        return Query("tail13", f"BBOX(geom, {x0}, {y0}, {x0 + w}, {y0 + h})")

    def wait_for(pred, timeout=15.0):
        deadline = time.perf_counter() + timeout
        while not pred():
            if time.perf_counter() > deadline:
                raise SystemExit("web config 13: staging timed out")
            time.sleep(0.001)

    out = {"part": "config13", "rows": n, "web_callers": cw,
           "embedded_callers": ce}
    kernels.reset_launches()
    # (A) one fused dispatch for both tiers
    batcher_registry.clear()
    BATCH_LINGER_ADAPTIVE.set("false")
    BATCH_LINGER_MICROS.set(str(int(5e6)))
    BATCH_MAX_SIZE.set(str(total))
    server = None
    try:
        server = GeoMesaWebServer(ds).start()
        b = shared_batcher(ds)
        shared = server.batcher is b
        client = RemoteDataStore("127.0.0.1", server.port, hedge=False)
        client.get_schema("tail13")
        pre = b.batches
        ds.gate = bbox_q(0, w=0.01, h=0.01)
        warm = threading.Thread(target=b.query, args=(ds.gate,), daemon=True)
        warm.start()
        wait_for(lambda: b._in_flight >= 1 and b.batches == pre + 1)
        batches0, co0 = b.batches, b.coalesced_queries
        queries = [bbox_q(i + 1) for i in range(total)]
        results: list = [None] * total
        barrier = threading.Barrier(total)

        def web_worker(i):
            barrier.wait()
            results[i] = client.query(queries[i])

        def emb_worker(i):
            barrier.wait()
            results[i] = b.query(queries[i])
        threads = [threading.Thread(target=web_worker if i < cw
                                    else emb_worker, args=(i,), daemon=True)
                   for i in range(total)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        stuck = any(t.is_alive() for t in threads)
        ds.hold.set()
        warm.join(10.0)
        exact = not stuck
        for i, r in enumerate(results):
            want = InMemoryDataStore.query(ds, queries[i])
            exact = exact and r is not None and np.array_equal(
                np.sort(r.ids.astype(str)), np.sort(want.ids.astype(str)))
        fused = b.batches - batches0
        health = json.loads(_web_get(server.port, "/rest/health")[2])
        out["coalesce"] = {
            "callers": total, "registry_shared_instance": shared,
            "fused_dispatches": fused,
            "coalesced_queries": b.coalesced_queries - co0,
            "single_fused_dispatch": (fused == 1 and b.coalesced_queries
                                      - co0 == total),
            "ids_exact": exact,
            "health_has_batcher": health.get("batcher") is not None}
    finally:
        ds.hold.set()
        BATCH_LINGER_ADAPTIVE.set(None)
        BATCH_LINGER_MICROS.set(None)
        BATCH_MAX_SIZE.set(None)
        if server is not None:
            server.stop()
    # (C) the latency-derived cap, from phase A's cost EWMA
    cost = max(b._cost_ewma.values()) if b._cost_ewma else 0.0
    eff_unset = b.effective_max_batch("tail13")
    want_cap = max(1, total // 2)
    BATCH_LATENCY_BUDGET_MS.set(str(cost * (want_cap + 0.5) * 1e3))
    try:
        eff = b.effective_max_batch("tail13")
    finally:
        BATCH_LATENCY_BUDGET_MS.set(None)
    out["batch_caps"] = {
        "static_max_batch": b.max_batch, "per_query_cost_ms": cost * 1e3,
        "effective_max_batch": eff,
        "derived_below_static": cost > 0 and eff < b.max_batch,
        "uncapped_without_budget": eff_unset == b.max_batch}
    batcher_registry.clear()
    # (B) hedged against unhedged through the straggler profile
    server = GeoMesaWebServer(ds).start()
    proxy = ChaosProxy("127.0.0.1", server.port, seed=7, slow_rate=0.0,
                       slow_s=slow).start()
    try:
        unhedged = RemoteDataStore("127.0.0.1", proxy.port, hedge=False)
        hedged = RemoteDataStore("127.0.0.1", proxy.port)

        def stream(c, count):
            lat = []
            for i in range(count):
                t0 = time.perf_counter()
                c.query(bbox_q(i))
                lat.append(time.perf_counter() - t0)
            return lat
        warmup = max(nq // 5, 10)
        stream(unhedged, warmup)
        stream(hedged, warmup)
        proxy.slow_rate = 0.1
        c0 = dict(_counter_all())
        lat_u = stream(unhedged, nq)
        lat_h = stream(hedged, nq)
        time.sleep(slow + 0.2)       # the last losers come back
        c1 = dict(_counter_all())

        def delta(k):
            return c1.get(k, 0) - c0.get(k, 0)
        probe_ok = True
        for i in range(5):
            got = hedged.query(bbox_q(i))
            want = InMemoryDataStore.query(ds, bbox_q(i))
            probe_ok = probe_ok and np.array_equal(
                np.sort(got.ids.astype(str)), np.sort(want.ids.astype(str)))
        proxy.slow_rate = 0.0
        attempts = delta("resilience.hedge.attempts")
        budget_cap = (nq + warmup + 5) * 0.2 + 10.0
        out["unhedged"] = {"requests": nq, **_pct_ms(lat_u)}
        out["hedged"] = {"requests": nq, **_pct_ms(lat_h),
                         "attempts": attempts,
                         "wins": delta("resilience.hedge.wins"),
                         "losses": delta("resilience.hedge.losses"),
                         "cancelled": delta("resilience.hedge.cancelled"),
                         "suppressed_budget": delta(
                             "resilience.hedge.suppressed.budget"),
                         "budget_cap": budget_cap,
                         "budget_ok": attempts <= budget_cap,
                         "ids_exact": probe_ok}
        out["slow_profile"] = {"slow_rate": 0.1, "slow_s": slow,
                               "slowed_connections": proxy.stats["slowed"]}
        out["hedge_p99_speedup"] = (out["unhedged"]["p99_ms"]
                                    / max(out["hedged"]["p99_ms"], 1e-9))
    finally:
        proxy.stop()
        server.stop()
        batcher_registry.clear()
    out["launches"] = {k: kernels.launches[k] for k in WEB_KERNELS + (
        "scan_count",)}
    co, h, caps = out["coalesce"], out["hedged"], out["batch_caps"]
    wrong = []
    if not (co["single_fused_dispatch"] and co["ids_exact"]
            and co["registry_shared_instance"] and co["health_has_batcher"]):
        wrong.append("phase A")
    if not (h["attempts"] and h["wins"] and h["cancelled"]
            and h["budget_ok"] and h["ids_exact"]):
        wrong.append("phase B")
    if not (caps["derived_below_static"] and caps["uncapped_without_budget"]):
        wrong.append("phase C")
    out["wrong"] = wrong
    return out, out["launches"]


def _counter_all() -> dict:
    from geomesa_tpu_torch.metrics import metrics
    return metrics.snapshot()["counters"]


def phase_web(seed: int, ds, rows, dw) -> dict:
    """The REST surface on the card (see the module's head): the route
    sweep at 10M rows, then bench.py configs 8 and 13 at their shapes.
    Returns the launches of the three parts together."""
    t_phase = time.perf_counter()
    counts = {k: 0 for k in WEB_KERNELS + ("scan_count",)}
    wrong = []
    for name, part in (("routes", lambda: web_routes(seed, ds, rows, dw)),
                       ("config8", lambda: web_config8(seed)),
                       ("config13", lambda: web_config13(seed))):
        t0 = time.perf_counter()
        out, launches = part()
        out.update(seconds_part=time.perf_counter() - t0, card=card_line())
        emit({"phase": "web", **out})
        for k, v in launches.items():
            counts[k] += v
        wrong += [(name, w) for w in out["wrong"] + out.get("errors", [])]
    missing = [k for k in WEB_KERNELS if counts[k] == 0]
    if missing:
        wrong.append(("kernels never launched on the web path", missing))
    emit({"phase": "web", "part": "total",
          "seconds": time.perf_counter() - t_phase,
          "budget_s": WEB_BUDGET_S, "launches": counts,
          "wrong": wrong[:8], "card": card_line()})
    if wrong:
        raise SystemExit(f"web: {wrong[:8]}")
    return counts


# -- the replicated and sharded tiers (queue 1 item 8a) ---------------------

CLUSTER_BUDGET_S = 120.0      # the cluster phase's share of the script's time
CLUSTER_GROUPS = 4            # bench.py config 11's widest cluster
CLUSTER_QUERIES = 400         # configs 9 and 11: 5-degree box counts
CLUSTER_N = 200_000           # config 11's own rows (phases 2, 3 and cuts)
CLUSTER_FULL_SHARE = 0.3      # of the budget: past it 1 and 2 groups are cut
CLUSTER_MEM_SLACK = 64 << 20  # memory_allocated after a part, at most above
CLUSTER_HALF = "BBOX(geom, -180, -90, 0, 90)"   # a dense-tier count
CLUSTER_WORLD = "BBOX(geom, -180, -90, 180, 90)"
REPL_ROWS = 1_000_000         # config 9's primary at the issue's size
REPL_CHUNKS = 100             # writes; a checkpoint after half of them
REPL_REPLICAS = (1, 2, 4)
RESHARD_N = 240_000           # config 21: uniform rows, then twice that hot
RESHARD_C = 32                # config 21's client threads
RESHARD_PER_THREAD = 6        # queries a thread and phase
RESHARD_HOT = "BBOX(geom, 100, 40, 112, 46)"
RESHARD_BROAD = "BBOX(geom, -179, -89, 179, 89)"
SQL19_KERNELS = ("dwithin_counts", "slab_pairs", "contains_counts")
CLUSTER_KERNELS = ("scan_mask", "scan_mask_gather", "scan_count",
                   "density_grid") + SQL19_KERNELS


class _DownGroup:
    """A shard group that lost every node: every call fails fast."""

    def close(self):
        pass

    def __getattr__(self, name):
        def boom(*a, **kw):
            raise ConnectionError("shard group down")
        return boom


def _five_degree(seed: int, count: int) -> list:
    """bench.py configs 9 and 11's box stream: 5-degree boxes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        x0 = float(rng.uniform(-170, 130))
        y0 = float(rng.uniform(-80, 55))
        out.append(f"BBOX(geom, {x0:.4f}, {y0:.4f}, "
                   f"{x0 + 5:.4f}, {y0 + 5:.4f})")
    return out


def _lat(lat_s: list, wall_s: float) -> dict:
    a = np.asarray(lat_s) * 1e3
    return {"qps": len(a) / wall_s, "p50_ms": float(np.percentile(a, 50)),
            "p95_ms": float(np.percentile(a, 95)),
            "p99_ms": float(np.percentile(a, 99))}


def _wait_for(cond, timeout_s: float) -> bool:
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def _launches(names=CLUSTER_KERNELS) -> dict:
    from geomesa_tpu_torch.scan import kernels
    return {k: kernels.launches[k] for k in names}


def _chaos_group(root: str, sft, name: str):
    """A replicated group whose primary (durable, on the card) serves
    through a web server behind a ChaosProxy: (router, server, shipper,
    proxy)."""
    from geomesa_tpu_torch import InMemoryDataStore
    from geomesa_tpu_torch.replication import (Replica, ReplicatedDataStore,
                                               WalShipper)
    from geomesa_tpu_torch.resilience import ChaosProxy, RetryPolicy
    from geomesa_tpu_torch.store.remote import RemoteDataStore
    from geomesa_tpu_torch.web import GeoMesaWebServer
    primary = InMemoryDataStore(durable_dir=os.path.join(root, name),
                                wal_fsync="never")
    primary.create_schema(sft)
    srv = GeoMesaWebServer(primary).start()
    proxy = ChaosProxy("127.0.0.1", srv.port).start()
    remote = RemoteDataStore(
        "127.0.0.1", proxy.port, timeout_s=2.0,
        retry_policy=RetryPolicy(max_attempts=2, base_s=0.02, cap_s=0.05,
                                 total_deadline_s=1.0))
    ship = WalShipper(primary.journal)
    replicas = [Replica(ship.host, ship.port, name=f"{name}r{i}")
                for i in range(2)]
    router = ReplicatedDataStore(primary=remote, replicas=replicas,
                                 ack_replicas=1, auto_promote=True,
                                 probe_ms=50, probe_failures=2,
                                 max_lag_lsn=100_000, max_lag_s=600)
    return router, srv, ship, proxy


def _failover(router, srv, ship, proxy, write, query=None) -> dict:
    """bench.py configs 9 and 11's kill: ingest (and a query stream)
    for a second, then the primary's server, shipper and proxy go down;
    the router must promote by itself and keep every acked write."""
    import threading
    from geomesa_tpu_torch.replication import Replica
    acked, failed = [], [0]
    stop = threading.Event()

    def ingest():
        b = 0
        while not stop.is_set():
            try:
                acked.extend(write(b))
            except Exception:   # noqa: BLE001 - unacked: may be lost
                failed[0] += 1
            b += 1

    threads = [threading.Thread(target=ingest, daemon=True)]
    if query is not None:
        threads.append(threading.Thread(target=query, args=(stop,),
                                        daemon=True))
    for t in threads:
        t.start()
    try:
        time.sleep(1.0)
        srv.stop()
        ship.stop()
        proxy.stop()
        promoted = _wait_for(lambda: isinstance(router.primary, Replica),
                             15.0)
        time.sleep(0.5)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    st = router.replication_status()
    return {"auto_promoted": promoted, "failover_s": st.get(
                "failover_seconds"), "promoted_to": st.get("promoted_to"),
            "acked": acked, "unacked_write_errors": failed[0]}


def cluster11(seed: int, ds, rows) -> tuple[dict, dict, list]:
    """bench.py config 11 on the card. Phase 1: the store phase's rows
    written through ``ClusterDataStore.write`` into 4 groups, config
    11's 400 boxes (seed 110) as ``query_count``, each equal to the
    store phase's store, and the three store queries id-exact against
    the float64 brute force on the gathered and the dense tiers (both
    scan kernels must launch on the groups); 1 and 2 groups at the same
    rows while the budget holds, else at config 11's 200k (``cut``).
    Phase 2: a replicated group 0 behind a ChaosProxy fails over inside
    a 2-group cluster under ingest and a query stream. Phase 3: one
    group down, typed without partials and flagged with them."""
    import tempfile
    from geomesa_tpu_torch import InMemoryDataStore
    from geomesa_tpu_torch.cluster import (CLUSTER_ALLOW_PARTIAL,
                                           ClusterDataStore,
                                           ShardUnavailableError)
    from geomesa_tpu_torch.cluster.coordinator import CLUSTER_PRUNE
    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.replication import Replica
    from geomesa_tpu_torch.utils.properties import SystemProperty
    t_part = time.perf_counter()
    x, y, ms, ids = rows
    n = len(x)
    sft = ds.get_schema("ais")
    wrong = []
    boxes = _five_degree(110, CLUSTER_QUERIES)
    ds.query_count(boxes[0], "ais")
    want, lat = [], []
    t0 = time.perf_counter()
    for e in boxes:
        tq = time.perf_counter()
        want.append(ds.query_count(e, "ais"))
        lat.append(time.perf_counter() - tq)
    out = {"part": "cluster11", "rows": n,
           "single": _lat(lat, time.perf_counter() - t0), "groups": {}}

    def batch_of(m):
        return FeatureBatch.from_dict(sft, ids[:m], {"dtg": ms[:m],
                                                     "geom": (x[:m], y[:m])})

    def scatter(k, m, oracle_counts):
        groups = [InMemoryDataStore() for _ in range(k)]
        cluster = ClusterDataStore(groups, leg_deadline_s=60)
        cluster.create_schema(sft)
        t0 = time.perf_counter()
        cluster.write("ais", batch_of(m))
        cluster.query_count(CLUSTER_WORLD, "ais")    # flush and index
        write_s = time.perf_counter() - t0
        lat, legs, got = [], [], []
        t0 = time.perf_counter()
        for e in boxes:
            tq = time.perf_counter()
            got.append(cluster.query_count(e, "ais"))
            lat.append(time.perf_counter() - tq)
            legs.append(len(cluster.last_plan()["contacted"]))
        line = {"rows": m, "write_s": write_s,
                **_lat(lat, time.perf_counter() - t0),
                "legs_contacted_mean": float(np.mean(legs)),
                "legs_contacted_max": int(max(legs)),
                "per_group_rows": [g.count("ais") for g in groups],
                "counts_exact": got == oracle_counts}
        if not line["counts_exact"]:
            wrong.append(("counts", k, m))
        return cluster, groups, line

    cluster, groups, line = scatter(CLUSTER_GROUPS, n, want)
    # the three store queries on the groups, both device tiers
    host_rows = SystemProperty("geomesa.scan.host.rows")
    threshold = SystemProperty("geomesa.scan.index.threshold")
    before_q = _launches(("scan_mask", "scan_mask_gather"))
    exact = {}
    try:
        for tier, (h, thr) in {"gathered": ("0", "1.0"),
                               "dense": ("0", "0")}.items():
            host_rows.set(h)
            threshold.set(thr)
            for qi, (ecql, qboxes, iv) in enumerate(STORE_QUERIES):
                w = _brute(x, y, ms, qboxes, iv)
                res = cluster.query(ecql, "ais")
                got = np.sort(np.asarray(res.ids).astype(np.int64))
                ok = (res.complete and np.array_equal(got, w)
                      and cluster.query_count(ecql, "ais") == len(w))
                exact[f"{tier}_{qi}"] = {"hits": len(w), "exact": ok}
                if not ok:
                    wrong.append(("store query", tier, ecql))
    finally:
        host_rows.set(None)
        threshold.set(None)
    line["store_queries"] = exact
    after_q = _launches(("scan_mask", "scan_mask_gather"))
    line["store_query_launches"] = {k: after_q[k] - before_q[k]
                                    for k in after_q}
    if min(line["store_query_launches"].values()) == 0:
        wrong.append(("store query kernels", line["store_query_launches"]))
    out["groups"][str(CLUSTER_GROUPS)] = line
    cluster.close()
    del cluster, groups
    # 1 and 2 groups: the same rows while the budget holds
    small_want = None
    for k in (1, 2):
        full = time.perf_counter() - t_part < \
            CLUSTER_FULL_SHARE * CLUSTER_BUDGET_S
        m = n if full else min(CLUSTER_N, n)
        if not full and small_want is None:
            one = InMemoryDataStore()
            one.create_schema(sft)
            one.write("ais", batch_of(m))
            small_want = [one.query_count(e, "ais") for e in boxes]
            del one
        c, g, line = scatter(k, m, want if full else small_want)
        if not full:
            line["cut"] = {"rows": m, "of": n}
        out["groups"][str(k)] = line
        c.close()
        del c, g
    torch.cuda.synchronize()
    # phase 2: failover inside the cluster at config 11's rows
    m = min(CLUSTER_N, n)
    n_static = min(m, 20_000)
    sx, sy = x[:n_static], y[:n_static]
    root = tempfile.mkdtemp(prefix="geomesa-cluster11-")
    try:
        router, srv, ship, proxy = _chaos_group(root, sft, "g0")
        g1 = InMemoryDataStore()
        g1.create_schema(sft)
        cluster = ClusterDataStore([router, g1], names=["g0", "g1"],
                                   leg_deadline_s=5, hedge_ms=50)
        cluster._sfts["ais"] = sft
        cluster.write("ais", FeatureBatch.from_dict(
            sft, np.array([f"s{i}" for i in range(n_static)], object),
            {"dtg": ms[:n_static], "geom": (sx, sy)}))
        w_rng = np.random.default_rng(seed + 112)
        q_ok, q_err, q_wrong = [0], [0], [0]

        def write(b):
            wids = [f"w{b}_{i}" for i in range(50)]
            cluster.write("ais", FeatureBatch.from_dict(
                sft, np.array(wids, dtype=object),
                {"dtg": np.full(50, T0_DAY * MS_DAY),
                 "geom": (w_rng.uniform(-180, 180, 50),
                          w_rng.uniform(-90, 90, 50))}))
            return wids

        def query(stop):
            q_rng = np.random.default_rng(seed + 113)
            while not stop.is_set():
                x0 = float(q_rng.uniform(-170, 130))
                y0 = float(q_rng.uniform(-80, 55))
                try:
                    res = cluster.query(
                        f"BBOX(geom, {x0:.4f}, {y0:.4f}, {x0 + 20:.4f}, "
                        f"{y0 + 20:.4f})", "ais")
                except Exception:   # noqa: BLE001 - typed, never wrong
                    q_err[0] += 1
                    continue
                got = set(np.asarray(res.ids).astype(str))
                inb = ((sx >= x0) & (sx <= x0 + 20) & (sy >= y0)
                       & (sy <= y0 + 20))
                w = {f"s{i}" for i in np.flatnonzero(inb)}
                if w - got or any(not g.startswith(("s", "w"))
                                  for g in got - w):
                    q_wrong[0] += 1
                else:
                    q_ok[0] += 1

        fo = _failover(router, srv, ship, proxy, write, query)
        survived = (set(np.asarray(cluster.query("INCLUDE", "ais").ids)
                        .astype(str)) if fo["auto_promoted"] else set())
        acked = fo.pop("acked")
        lost = [i for i in acked if i not in survived]
        fo.update(rows=m, static_rows=n_static, acked_writes=len(acked),
                  acked_lost=len(lost), queries_ok=q_ok[0],
                  queries_typed_error=q_err[0],
                  queries_silently_wrong=q_wrong[0],
                  promoted_is_replica=isinstance(router.primary, Replica))
        out["failover"] = fo
        if not fo["auto_promoted"] or lost or q_wrong[0] or not acked:
            wrong.append(("failover", {k: fo[k] for k in (
                "auto_promoted", "acked_writes", "acked_lost",
                "queries_silently_wrong")}))
        cluster.close()
        proxy.stop()
        del cluster, router, g1
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # phase 3: one group down
    live = InMemoryDataStore()
    live.create_schema(sft)
    live.write("ais", batch_of(m))
    oracle_counts = {}
    nq3 = max(CLUSTER_QUERIES // 10, 5)
    probe = _five_degree(114, nq3)
    for e in probe:
        oracle_counts[e] = live.query_count(e, "ais")
    typed = partial = got_rows = 0
    missing = []
    CLUSTER_PRUNE.set("false")      # every query reaches the dead group
    try:
        half = ClusterDataStore([live, _DownGroup()], names=["up", "down"],
                                leg_deadline_s=2, hedge_ms=20,
                                allow_partial=False)
        half._sfts["ais"] = sft
        for e in probe:
            try:
                half.query_count(e, "ais")
            except ShardUnavailableError:
                typed += 1
        CLUSTER_ALLOW_PARTIAL.set("true")
        half = ClusterDataStore([live, _DownGroup()], names=["up", "down"],
                                leg_deadline_s=2, hedge_ms=20)
        half._sfts["ais"] = sft
        for e in probe:
            c = half.query_count(e, "ais")
            if getattr(c, "complete", True) is False and \
                    int(c) == oracle_counts[e]:
                partial += 1
                missing = c.missing_z_ranges
            got_rows += int(c)
    finally:
        CLUSTER_PRUNE.set(None)
        CLUSTER_ALLOW_PARTIAL.set(None)
    out["degraded"] = {"rows": m, "queries": nq3,
                       "typed_errors_knob_off": typed,
                       "partial_flagged_knob_on": partial,
                       "missing_z_ranges": missing}
    if typed != nq3 or partial != nq3 or not missing:
        wrong.append(("degraded", out["degraded"]))
    del live, half
    out["seconds"] = time.perf_counter() - t_part
    return out, _launches(), wrong


def repl9(seed: int) -> tuple[dict, dict, list]:
    """bench.py config 9 on the card: a durable primary of REPL_ROWS
    rows written in REPL_CHUNKS writes (``wal_fsync="never"``), a
    checkpoint after half of them, so replicas bootstrap from it and
    stream the rest. 400 box counts through a ReplicatedDataStore at
    1, 2 and 4 replicas, each equal to the primary's; on each replica
    one dense-tier count (half the world), which must launch
    ``scan_mask``. Then config 9's failover through RemoteDataStore
    and ChaosProxy."""
    import tempfile
    from geomesa_tpu_torch import InMemoryDataStore
    from geomesa_tpu_torch.features import parse_spec
    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.metrics import metrics
    from geomesa_tpu_torch.replication import (Replica, ReplicatedDataStore,
                                               WalShipper)
    from geomesa_tpu_torch.scan import kernels
    t_part = time.perf_counter()
    sft = parse_spec("pts9", "*geom:Point:srid=4326")
    rng = np.random.default_rng(seed + 9)
    n = REPL_ROWS
    x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    ids = np.arange(n).astype(str).astype(object)
    wrong = []
    out = {"part": "repl9", "rows": n, "chunks": REPL_CHUNKS}
    root = tempfile.mkdtemp(prefix="geomesa-repl9-")
    try:
        primary = InMemoryDataStore(durable_dir=os.path.join(root, "p"),
                                    wal_fsync="never")
        primary.create_schema(sft)
        step = n // REPL_CHUNKS
        t0 = time.perf_counter()
        for i in range(REPL_CHUNKS):
            lo, hi = i * step, (n if i == REPL_CHUNKS - 1 else (i + 1) * step)
            primary.write_dict("pts9", ids[lo:hi], {"geom": (x[lo:hi],
                                                             y[lo:hi])})
            if i == REPL_CHUNKS // 2 - 1:
                out["checkpoint_lsn"] = primary.checkpoint()["lsn"]
        out["ingest_s"] = time.perf_counter() - t0
        tail = primary.journal.wal.last_lsn
        ship = WalShipper(primary.journal, store=primary)
        t0 = time.perf_counter()
        replicas = [Replica(ship.host, ship.port, name=f"r{i}")
                    for i in range(max(REPL_REPLICAS))]
        caught = _wait_for(lambda: all(r.applied_lsn >= tail
                                       for r in replicas), 120.0)
        out["catch_up_s"] = time.perf_counter() - t0
        out["bootstraps"] = [r.bootstraps for r in replicas]
        out["records_applied"] = [r.status()["records_applied"]
                                  for r in replicas]
        if not caught or any(b != 1 for b in out["bootstraps"]):
            wrong.append(("catch-up", caught, out["bootstraps"]))
        half = {}
        for r in replicas:
            before = kernels.launches["scan_mask"]
            c = r.query_count(CLUSTER_HALF, "pts9")
            half[r.name] = {"count": c, "scan_mask":
                            kernels.launches["scan_mask"] - before}
        want_half = primary.query_count(CLUSTER_HALF, "pts9")
        out["half_world"] = {"want": want_half, "replicas": half}
        if any(v["count"] != want_half or v["scan_mask"] < 1
               for v in half.values()):
            wrong.append(("half-world count", half))
        for k in REPL_REPLICAS:
            boxes = _five_degree(90 + k, CLUSTER_QUERIES)
            want = [primary.query_count(e, "pts9") for e in boxes]
            router = ReplicatedDataStore(primary, replicas[:k],
                                         ack_replicas=0,
                                         max_lag_lsn=10_000, max_lag_s=600)
            for r in replicas[:k]:
                r.query_count("BBOX(geom, 0, 0, 5, 5)", "pts9")
            c0 = metrics.snapshot()["counters"]
            lat, got = [], []
            t0 = time.perf_counter()
            for e in boxes:
                tq = time.perf_counter()
                got.append(router.query_count(e, "pts9"))
                lat.append(time.perf_counter() - tq)
            wall = time.perf_counter() - t0
            c1 = metrics.snapshot()["counters"]
            on_replica = (c1.get("replication.reads.replica", 0)
                          - c0.get("replication.reads.replica", 0))
            out[f"replicas_{k}"] = {
                **_lat(lat, wall), "staleness_hit_rate": on_replica / len(
                    boxes), "counts_exact": got == want}
            if got != want:
                wrong.append(("replica counts", k))
        for r in replicas:
            r.stop()
        ship.stop()
        primary.close()
        del replicas, primary, router
        # config 9's failover
        sft9 = sft
        router, srv, ship, proxy = _chaos_group(root, sft9, "f")
        w_rng = np.random.default_rng(seed + 91)

        def write(b):
            wids = [f"w{b}_{i}" for i in range(50)]
            router.write("pts9", FeatureBatch.from_dict(
                sft9, wids, {"geom": (w_rng.uniform(-10, 10, 50),
                                      w_rng.uniform(-10, 10, 50))}))
            return wids

        fo = _failover(router, srv, ship, proxy, write)
        survived = (set(np.asarray(router.query("INCLUDE", "pts9").ids)
                        .astype(str)) if fo["auto_promoted"] else set())
        acked = fo.pop("acked")
        lost = [i for i in acked if i not in survived]
        fo.update(acked_writes=len(acked), acked_lost=len(lost))
        out["failover"] = fo
        if not fo["auto_promoted"] or lost or not acked:
            wrong.append(("failover", fo))
        router.close()
        proxy.stop()
        del router
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_part
    return out, _launches(), wrong


def reshard21(seed: int) -> tuple[dict, dict, list]:
    """bench.py config 21 on the card: 4 groups, RESHARD_N uniform rows,
    then twice that in one group's corner; RESHARD_C threads of
    RESHARD_PER_THREAD queries (every 4th world-spanning) before, under
    and after the hot ingest; the autoscaler on the real per-leg
    latencies (config 21's knobs) must split the hot group by itself
    (``reason`` ``auto``); where the leg latencies do not fire it, it
    runs again on config 21's ``synthetic_hot_signal`` (rows a group x
    20 ns), marked so. Id-exact against one store across the flip; the
    flip's copy, delete and swap times from the resharder's kill-point
    hooks."""
    import threading
    from geomesa_tpu_torch import InMemoryDataStore
    from geomesa_tpu_torch.cluster import ClusterDataStore
    from geomesa_tpu_torch.cluster.autoscale import (RESHARD_AUTO,
                                                     RESHARD_HOT_FACTOR,
                                                     RESHARD_HOT_MIN_MS,
                                                     RESHARD_HOT_SUSTAIN_S,
                                                     Autoscaler)
    from geomesa_tpu_torch.features import parse_spec
    from geomesa_tpu_torch.features.batch import FeatureBatch
    t_part = time.perf_counter()
    rng = np.random.default_rng(seed + 21)
    n = RESHARD_N
    sft = parse_spec("pts21", "*geom:Point:srid=4326,val:Integer")
    cluster = ClusterDataStore([InMemoryDataStore() for _ in range(4)],
                               names=["g0", "g1", "g2", "g3"],
                               leg_deadline_s=120)
    oracle = InMemoryDataStore()
    for st in (cluster, oracle):
        st.create_schema(sft)

    def write_both(prefix, xs, ys):
        b = FeatureBatch.from_dict(
            sft, np.array([f"{prefix}{i}" for i in range(len(xs))], object),
            {"geom": (xs, ys), "val": np.arange(len(xs), dtype=np.int64)})
        cluster.write("pts21", b)
        oracle.write("pts21", b)

    def measure(per_thread=RESHARD_PER_THREAD):
        lats, lock, errors = [], threading.Lock(), []

        def worker():
            mine = []
            try:
                for i in range(per_thread):
                    cql = RESHARD_BROAD if i % 4 == 3 else RESHARD_HOT
                    t0 = time.perf_counter()
                    cluster.query(cql, "pts21")
                    mine.append((time.perf_counter() - t0) * 1e3)
            except Exception as e:  # noqa: BLE001 - reported, gated
                errors.append(repr(e))
            with lock:
                lats.extend(mine)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker) for _ in range(RESHARD_C)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        a = np.asarray(lats)
        return {"p50_ms": float(np.percentile(a, 50)),
                "p99_ms": float(np.percentile(a, 99)),
                "queries": len(a), "errors": errors[:3],
                "seconds": time.perf_counter() - t0}

    wrong = []
    write_both("u", rng.uniform(-180, 180, n), rng.uniform(-90, 90, n))
    out = {"part": "reshard21", "n": n, "hot_rows": 2 * n,
           "concurrency": RESHARD_C, "per_thread": RESHARD_PER_THREAD}
    measure(1)
    out["pre"] = measure()
    write_both("h", rng.uniform(100, 112, 2 * n), rng.uniform(40, 46, 2 * n))
    out["hot"] = measure()
    marks = {}
    r = cluster.resharder
    r.fault_hook = lambda tag: marks.setdefault(tag, time.perf_counter())
    RESHARD_AUTO.set("true")
    RESHARD_HOT_FACTOR.set("1.5")
    RESHARD_HOT_SUSTAIN_S.set("5")
    RESHARD_HOT_MIN_MS.set("0")
    try:
        def ticks(scaler):
            return [{k: d.get(k) for k in ("action", "group", "executed",
                                           "blocked", "hot_p99_s",
                                           "slo_fast_burning")}
                    for d in (scaler.run_once(now=0.0),
                              scaler.run_once(now=6.0))]
        scaler = Autoscaler(cluster)
        obs_hot = scaler.observe()
        out["signal"] = "leg_latency"
        out["decisions"] = ticks(scaler)
        if not any(d["executed"] for d in out["decisions"]):
            scaler = Autoscaler(cluster)
            scaler.observe = lambda: {
                name: g.count("pts21") * 20e-9
                for name, g in zip(cluster._names, cluster._groups)}
            obs_hot = scaler.observe()
            out["signal"] = "synthetic_hot_signal"
            out["decisions"] += ticks(scaler)
        t_done = time.perf_counter()
    finally:
        RESHARD_AUTO.set(None)
        RESHARD_HOT_FACTOR.set(None)
        RESHARD_HOT_SUSTAIN_S.set(None)
        RESHARD_HOT_MIN_MS.set(None)
        r.fault_hook = None
    if "flip.copy" in marks:
        out["flip_ms"] = {
            "snapshot": (marks["snapshot.done"] - marks["snapshot.start"])
            * 1e3,
            "copy": (marks["flip.delete_src"] - marks["flip.copy"]) * 1e3,
            "delete": (marks["flip.swap"] - marks["flip.delete_src"]) * 1e3,
            "swap": (t_done - marks["flip.swap"]) * 1e3}
    out["post"] = measure()
    obs_post = scaler.observe()
    real_post = {k: cluster._breakers.latency_p99_s(k)
                 for k in cluster._names}
    history = r.status()["history"]
    out["history"] = [{k: e.get(k) for k in ("epoch", "op", "reason", "src",
                                             "dst", "rows_moved", "flip_ms")}
                      for e in history]
    auto = any(e.get("reason") == "auto" and e.get("op") == "migrate"
               for e in history)
    got = cluster.query("INCLUDE", "pts21")
    want = oracle.query("INCLUDE", "pts21")
    exact = (set(np.asarray(got.ids).astype(str))
             == set(np.asarray(want.ids).astype(str))
             and cluster.count("pts21") == oracle.count("pts21")
             and set(np.asarray(cluster.query(RESHARD_HOT, "pts21").ids)
                     .astype(str))
             == set(np.asarray(oracle.query(RESHARD_HOT, "pts21").ids)
                    .astype(str))
             and sum(g.count("pts21") for g in cluster._groups)
             == oracle.count("pts21"))
    hot_group = next((e["src"] for e in history
                      if e.get("reason") == "auto"), None)
    leg_hot = obs_hot.get(hot_group)
    leg_post = obs_post.get(hot_group)
    out.update(auto_fired=auto, exact=bool(exact), hot_group=hot_group,
               epoch=cluster._part.epoch,
               leg_p99_ms_hot={k: v * 1e3 for k, v in obs_hot.items()
                               if v is not None},
               leg_p99_ms_post={k: v * 1e3 for k, v in obs_post.items()
                                if v is not None},
               leg_latency_p99_ms_post={k: v * 1e3 for k, v in
                                        real_post.items() if v is not None},
               heal_ratio=(leg_post / max(leg_hot, 1e-12)
                           if leg_hot is not None and leg_post is not None
                           else None),
               per_group_rows=[g.count("pts21") for g in cluster._groups])
    errors = out["pre"]["errors"] + out["hot"]["errors"] + \
        out["post"]["errors"]
    if not auto or not exact or errors:
        wrong.append(("reshard", auto, exact, errors[:2]))
    cluster.close()
    del cluster, oracle
    out["seconds"] = time.perf_counter() - t_part
    return out, _launches(), wrong


def phase_cluster(seed: int, ds, rows) -> tuple[dict, float]:
    """The replicated and sharded tiers on the card (see the module's
    head): cluster11, repl9 and reshard21, one line each with its
    launches and device memory before and after (its stores closed).
    Returns the launches of the three parts and their seconds; the
    phase's total line follows sql19 (phase_sql_gdelt)."""
    import gc
    t_phase = time.perf_counter()
    counts = {k: 0 for k in CLUSTER_KERNELS}
    wrong = []
    from geomesa_tpu_torch.scan import kernels
    for name, part in (("cluster11", lambda: cluster11(seed, ds, rows)),
                       ("repl9", lambda: repl9(seed)),
                       ("reshard21", lambda: reshard21(seed))):
        gc.collect()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        kernels.reset_launches()
        out, launches, w = part()
        gc.collect()
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        out.update(launches=launches, memory_allocated_before=mem0,
                   memory_allocated_after=mem1, wrong=w, card=card_line())
        emit({"phase": "cluster", **out})
        if mem1 > mem0 + CLUSTER_MEM_SLACK:
            w = w + [("device memory not returned", mem0, mem1)]
        for k, v in launches.items():
            counts[k] += v
        wrong += [(name, x) for x in w]
    torch.cuda.empty_cache()
    if wrong:
        raise SystemExit(f"cluster: {wrong[:8]}")
    return counts, time.perf_counter() - t_phase


def sql19(d: dict, ids, zsft, zb) -> tuple[dict, list]:
    """Config 19's statements through ``SqlEngine`` over a 4-group
    ``ClusterDataStore`` holding SQL_LEG_ROWS of the predicates phase's
    rows, against one store's engine over the same rows: the plan says
    distributed and the rows are equal; beside it the pull path
    (``geomesa.sql.distributed`` off) and config 19's leg kill (typed
    without partials, flagged with them). The join kernels must launch
    on the legs."""
    from geomesa_tpu_torch import InMemoryDataStore
    from geomesa_tpu_torch.cluster import (CLUSTER_ALLOW_PARTIAL,
                                           ClusterDataStore,
                                           ShardUnavailableError)
    from geomesa_tpu_torch.sql import SqlEngine
    from geomesa_tpu_torch.utils.properties import SQL_DISTRIBUTED
    t_part = time.perf_counter()
    n = len(d["x"])
    m = min(SQL_LEG_ROWS, n)
    sub = {k: (v[:m] if isinstance(v, np.ndarray) and len(v) == n else v)
           for k, v in d.items()}
    one = InMemoryDataStore()
    cluster = ClusterDataStore([InMemoryDataStore() for _ in range(SQL_LEGS)],
                               leg_deadline_s=60)
    t0 = time.perf_counter()
    for st in (one, cluster):
        st.create_schema("gdelt", PRED_SPEC)
        st.write("gdelt", predicate_batch(st.get_schema("gdelt"), sub,
                                          ids[:m]))
        st.create_schema(zsft)
        st.write("zones19", zb)
    write_s = time.perf_counter() - t0
    ce, oe = SqlEngine(cluster), SqlEngine(one)

    def canon(r):
        return sorted(_sql_cells(r), key=repr)
    # a merged AVG adds its leg sums in another order than one store's
    # bincount: each is within the recursive-summation bound of the
    # exact sum, (m - 1) u sum|x| (|AvgTone| <= 10), so the two means
    # within twice that over the count (at least 1)
    avg_atol = 2.0 * m * 2.0 ** -53 * 10.0
    wrong, lines = [], []
    before = _launches(SQL19_KERNELS + ("scan_mask", "scan_mask_gather"))
    pull = (SQL_AGG[0], SQL_AGG[2], SQL_JOIN[0])
    for sql in SQL_AGG + SQL_JOIN:
        want = oe.query(sql)
        t0 = time.perf_counter()
        res = ce.query(sql)
        ms_dist = (time.perf_counter() - t0) * 1e3
        ok = (res.names == want.names and res.complete
              and _sql_same(canon(res), canon(want), avg_atol))
        line = {"sql": sql, "mode": res.plan.get("mode"),
                "distributed": res.plan.get("distributed"),
                "legs": len(res.plan.get("legs", [])), "ms": ms_dist,
                "rows": res.n, "exact": ok}
        if sql in pull:
            SQL_DISTRIBUTED.set("false")
            try:
                t0 = time.perf_counter()
                pres = ce.query(sql)
                line["pull_ms"] = (time.perf_counter() - t0) * 1e3
            finally:
                SQL_DISTRIBUTED.set(None)
            line["pull_mode"] = pres.plan.get("mode")
            line["pull_exact"] = _sql_same(canon(pres), canon(want),
                                           avg_atol)
            if not line["pull_exact"] or line["pull_mode"] != \
                    "cluster-materialize":
                wrong.append(("pull", sql))
        if not ok or res.plan.get("distributed") is not True:
            wrong.append(("distributed", sql, line["mode"]))
        lines.append(line)
    after = _launches(SQL19_KERNELS + ("scan_mask", "scan_mask_gather"))
    launches = {k: after[k] - before[k] for k in after}
    if not any(launches[k] for k in SQL19_KERNELS):
        wrong.append(("join kernels never launched on the legs", launches))
    # the leg kill: group 2 down
    kill = {}
    live = cluster._groups[2]
    cluster._groups[2] = _DownGroup()
    try:
        typed = 0
        for sql in (SQL_AGG[0], SQL_JOIN[0]):
            try:
                ce.query(sql)
            except ShardUnavailableError as e:
                typed += e.groups == ["shard2"]
        CLUSTER_ALLOW_PARTIAL.set("true")
        res = ce.query(SQL_AGG[0])
        got = {r[0]: r[1] for r in _sql_cells(res)}
        full = {r[0]: r[1] for r in _sql_cells(oe.query(SQL_AGG[0]))}
        kill = {"typed_knob_off": typed, "flagged_knob_on":
                res.complete is False and res.missing_groups == ["shard2"],
                "counts_at_most_full": set(got) <= set(full) and all(
                    got[k] <= full[k] for k in got)}
    finally:
        CLUSTER_ALLOW_PARTIAL.set(None)
        cluster._groups[2] = live
    if kill.get("typed_knob_off") != 2 or not kill.get("flagged_knob_on") \
            or not kill.get("counts_at_most_full"):
        wrong.append(("leg kill", kill))
    cluster.close()
    del cluster, one, ce, oe, live
    out = {"part": "sql19", "rows": m, "groups": SQL_LEGS,
           "write_s": write_s, "statements": lines, "leg_kill": kill,
           "launches": launches, "seconds": time.perf_counter() - t_part,
           "wrong": wrong, "card": card_line()}
    emit({"phase": "cluster", **out})
    return out, wrong


def cache12f(seed: int) -> tuple[dict, int]:
    """bench.py config 12's phase F on the card: replicated density
    reads under a write stream, one row a write, so the primary's LSN
    maps onto a tile's mass; a tile implying fewer rows than the
    primary's LSN at request time less the lag bound (50) is a
    staleness violation. Returns the line and density_grid's launches
    in it (at least one: the replica's misses recompute on the card)."""
    import tempfile
    import threading
    from geomesa_tpu_torch import InMemoryDataStore
    from geomesa_tpu_torch.features import parse_spec
    from geomesa_tpu_torch.replication import (Replica, ReplicatedDataStore,
                                               WalShipper)
    from geomesa_tpu_torch.scan import kernels
    t_part = time.perf_counter()
    lag_bound, writes, base = 50, 150, 64
    root = tempfile.mkdtemp(prefix="geomesa-cache12f-")
    violations = reads = 0
    d0 = kernels.launches["density_grid"]
    try:
        prim = InMemoryDataStore(durable_dir=os.path.join(root, "p"),
                                 wal_fsync="never")
        prim.create_schema(parse_spec("pts12", "*geom:Point:srid=4326"))
        prim.write_dict("pts12", np.arange(base).astype(str).astype(object),
                        {"geom": (np.full(base, 0.5), np.full(base, 0.5))})
        base_lsn = prim.journal.wal.last_lsn
        ship = WalShipper(prim.journal)
        replica = Replica(ship.host, ship.port, name="r0")
        router = ReplicatedDataStore(prim, [replica], ack_replicas=0,
                                     max_lag_lsn=lag_bound, max_lag_s=600)
        try:
            _wait_for(lambda: replica.applied_lsn >= base_lsn, 30.0)
            bb = (0.0, 0.0, 1.0, 1.0)
            stop = threading.Event()

            def writer():
                j = 0
                while not stop.is_set() and j < writes:
                    prim.write_dict("pts12", np.array([f"x{j}"], object),
                                    {"geom": (np.full(1, 0.5),
                                              np.full(1, 0.5))})
                    j += 1
                    stop.wait(0.002)

            w = threading.Thread(target=writer)
            w.start()
            try:
                while w.is_alive() or reads < 20:
                    lsn_pre = prim.journal.wal.last_lsn
                    grid = router.density("pts12", "INCLUDE", bb, 8, 8)
                    implied = base_lsn + int(round(float(np.sum(grid)))) \
                        - base
                    reads += 1
                    violations += implied < lsn_pre - lag_bound
                    if reads > writes * 4:
                        break
            finally:
                stop.set()
                w.join()
            on_replica = replica.cache_status()
        finally:
            router.close()
            ship.stop()
            prim.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = kernels.launches["density_grid"] - d0
    out = {"phase": "cache", "part": "F_replicated", "reads": reads,
           "writes": writes, "lag_bound": lag_bound,
           "staleness_violations": violations,
           "replica_cache": {k: on_replica.get(k) for k in (
               "hits", "misses", "applied_lsn")},
           "launches": {"density_grid": launches},
           "seconds": time.perf_counter() - t_part, "card": card_line()}
    emit(out)
    if violations or reads < 20 or not launches:
        raise SystemExit(f"cache F: {violations} staleness violations in "
                         f"{reads} reads, {launches} density launches")
    return out, launches


def _sql_cells(res) -> list:
    """Rows with the geometry cells as their envelopes' tuples."""
    out = []
    for r in res.rows():
        out.append(tuple((v.envelope.as_tuple() if hasattr(v, "envelope")
                          else (None if v is None else
                                v.item() if isinstance(v, np.generic)
                                else v)) for v in r))
    return out


def _sql_same(got: list, want: list, atol: float = 0.0) -> bool:
    """Rows equal cell for cell; a float cell within ``atol`` of its
    counterpart (0: exact)."""
    if len(got) != len(want):
        return False
    for a, b in zip(got, want):
        if len(a) != len(b):
            return False
        for u, v in zip(a, b):
            if isinstance(u, float) and isinstance(v, float) and atol:
                if abs(u - v) > atol:
                    return False
            elif u != v:
                return False
    return True


def _group_oracle(d: dict, keep: np.ndarray) -> dict:
    """{key: (count, SUM(NumMentions), MIN, MAX, exactly rounded AVG of
    AvgTone, envelope, the AVG's bound)} over the rows ``keep``, the null
    key as None: numpy over predicate_data's columns, the mean by
    math.fsum. The bound is recursive summation's, (n - 1) u sum|x| / n
    with u = 2^-53, doubled for the division: the engine adds a group's
    values one at a time in its result order."""
    import math
    rows = np.flatnonzero(keep)
    codes = d["ac"][rows].astype(np.int64)
    order = np.argsort(codes, kind="stable")
    rows, codes = rows[order], codes[order]
    starts = np.flatnonzero(np.diff(codes, prepend=codes[0] - 1)) \
        if len(codes) else np.empty(0, np.int64)
    ends = np.append(starts[1:], len(codes))
    out = {}
    for a, b in zip(starts, ends):
        r = rows[a:b]
        c = int(codes[a])
        key = None if c < 0 else str(d["ac_vocab"][c])
        mv = d["mentions_valid"][r]
        tone = d["tone"][r]
        out[key] = (len(r), float(d["mentions"][r][mv].sum()) if mv.any()
                    else None, float(tone.min()), float(tone.max()),
                    math.fsum(tone) / len(r),
                    (float(d["x"][r].min()), float(d["y"][r].min()),
                     float(d["x"][r].max()), float(d["y"][r].max())),
                    len(r) * 2.0 ** -52 * float(np.abs(tone).mean()))
    return out


def phase_sql_gdelt(seed: int, ds, d: dict, ids) -> tuple[dict, dict]:
    """bench.py config 19's statements on the predicates phase's 10M-row
    GDELT-shaped store, each held to numpy over the same columns; the
    statements through a 4-group ClusterDataStore holding 2M of those
    rows against one store's engine (``sql19``, the cluster phase's
    part); one geohash-spiral KNN against the f64 brute force."""
    from geomesa_tpu_torch import parse_spec
    from geomesa_tpu_torch.analytics import processes
    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.geometry import Polygon
    from geomesa_tpu_torch.scan import kernels
    from geomesa_tpu_torch.sql import SqlEngine
    t_phase = time.perf_counter()
    x, y, ms = d["x"], d["y"], d["ms"]
    n = len(x)
    zsft = parse_spec("zones19", "*geom:Polygon:srid=4326,zname:String")
    boxes = zone19_boxes()
    zb = FeatureBatch.from_dict(
        zsft, np.array([f"z{i}" for i in range(16)], dtype=object),
        {"geom": np.array([Polygon(np.array(
            [[b[0], b[1]], [b[2], b[1]], [b[2], b[3]], [b[0], b[3]],
             [b[0], b[1]]], float)) for b in boxes], dtype=object),
         "zname": np.array([f"zone{i}" for i in range(16)], dtype=object)})
    ds.create_schema(zsft)
    ds.write("zones19", zb)
    engine = SqlEngine(ds)
    wrong, times = [], {}
    keep = (_in_box(x, y, SQL_WHERE_BOX) & (ms >= SQL_WHERE_DAYS[0] * MS_DAY)
            & (ms < SQL_WHERE_DAYS[1] * MS_DAY))
    t0 = time.perf_counter()
    where_oracle = _group_oracle(d, keep)
    all_oracle = _group_oracle(d, np.ones(n, dtype=bool))
    in_zone = [_in_box(x, y, b) for b in boxes]
    oracle_s = time.perf_counter() - t0

    kernels.reset_launches()
    t_main = time.perf_counter()
    # GROUP BY under a BBOX+time WHERE (the null key, the null mentions)
    group_sql = ("SELECT Actor1CountryCode AS k, COUNT(*) AS cnt, "
                 "SUM(NumMentions) AS sm, MIN(AvgTone) AS lo, "
                 f"MAX(AvgTone) AS hi, AVG(AvgTone) AS av FROM gdelt "
                 f"WHERE {SQL_WHERE} GROUP BY Actor1CountryCode")
    res, times["group_where_first"], times["group_where"] = \
        _sql_timed(engine, group_sql, 2)
    got = {r[0]: r[1:] for r in _sql_cells(res)}
    if set(got) != set(where_oracle) or any(
            got[k][:4] != where_oracle[k][:4]
            or got[k][4] is None
            or abs(got[k][4] - where_oracle[k][4]) > where_oracle[k][6]
            for k in got):
        wrong.append("group_by_where")
    # ORDER BY cnt DESC LIMIT 5 over the whole table
    res, _, times["top5"] = _sql_timed(engine, SQL_AGG[1], 2)
    top = sorted(((v[0], k) for k, v in all_oracle.items()),
                 key=lambda t: -t[0])[:5]
    got = _sql_cells(res)
    if [c for _, c in got] != [c for c, _ in top] or any(
            all_oracle[k][0] != c for k, c in got):
        wrong.append("order_by_limit")
    # ST_Extent per key over the whole table
    res, _, times["extent"] = _sql_timed(engine, SQL_AGG[3], 1)
    got = {r[0]: r[1] for r in _sql_cells(res)}
    if got != {k: v[5] for k, v in all_oracle.items()}:
        wrong.append("extent")
    # the Contains joins against the 16 zones
    res, times["contains_count_first"], times["contains_count"] = \
        _sql_timed(engine, SQL_JOIN[0], 2)
    per_zone = [int(m.sum()) for m in in_zone]
    if int(res.column(res.names[0])[0]) != sum(per_zone):
        wrong.append("contains_count")
    res, _, times["contains_grouped"] = _sql_timed(engine, SQL_JOIN[1], 1)
    got = {str(k): int(c) for k, c in res.rows()}
    if got != {f"zone{i}": c for i, c in enumerate(per_zone) if c}:
        wrong.append("contains_grouped")
    # a geohash projection with a LIMIT
    sql = (f"SELECT __fid__, ST_GeoHash(geom, 25) AS h FROM gdelt "
           f"WHERE {SQL_WHERE} LIMIT {SQL_GEOHASH_ROWS}")
    res, _, times["geohash"] = _sql_timed(engine, sql, 1)
    rows_h = np.array([int(f) for f in res.column("__fid__")], np.int64)
    want_h = [geohash_plain(float(x[r]), float(y[r]), 5) for r in rows_h]
    if (res.n != SQL_GEOHASH_ROWS or not keep[rows_h].all()
            or list(res.column("h")) != want_h):
        wrong.append("geohash")
    # the geohash-spiral KNN: one BBOX query a cell
    qx, qy, k, est = SQL_KNN
    t0 = time.perf_counter()
    kids, kd = processes.knn_spiral_process(ds, "gdelt", qx, qy, k,
                                            estimated_distance=est)
    times["knn_spiral"] = (time.perf_counter() - t0) * 1e3
    dist = np.hypot(x - qx, y - qy)
    near = np.argpartition(dist, k)[:k]
    near = near[np.argsort(dist[near], kind="stable")]
    if (not np.array_equal(kd, dist[near])
            or set(kids.astype(str)) != set(ids[near].astype(str))):
        wrong.append("knn_spiral")
    store_s = time.perf_counter() - t_main
    launches = _sql_launches()
    if launches["contains_counts"] < 3 or launches["slab_pairs"] < 2:
        wrong.append(("contains launches", launches))
    if launches["scan_mask"] + launches["scan_mask_gather"] == 0:
        wrong.append(("scan launches", launches))

    # config 19 through a real cluster: its statements through the SQL
    # engine over 4 groups holding 2M of these rows (cluster phase)
    sql19_out, sql19_wrong = sql19(d, ids, zsft, zb)
    wrong += [("sql19", w) for w in sql19_wrong]
    launches_all = _sql_launches()
    # where the slowest statements' time goes, after the counted run
    profiles = {name: profile_top(lambda q=q: engine.query(q), top=8)
                for name, q in (("group_where", group_sql),
                                ("extent", SQL_AGG[3]))}
    profiles["knn_spiral"] = profile_top(
        lambda: processes.knn_spiral_process(ds, "gdelt", qx, qy, k,
                                             estimated_distance=est), top=8)
    ds.remove_schema("zones19")
    torch.cuda.empty_cache()
    out = {"phase": "sql_gdelt", "rows": n, "card": card_line(),
           "where": SQL_WHERE, "where_rows": int(keep.sum()),
           "ms": times, "store_s": store_s, "oracle_s": oracle_s,
           "sql19_seconds": sql19_out["seconds"],
           "sql19_launches": sql19_out["launches"],
           "knn_spiral": {"k": k, "estimated_distance": est,
                          "max_distance": float(kd[-1])},
           "profiles": profiles, "launches": launches_all,
           "seconds": time.perf_counter() - t_phase, "wrong": wrong}
    emit(out)
    if wrong:
        raise SystemExit(f"sql_gdelt: wrong results: {wrong}")
    return out, launches_all


# -- the result cache and the ingest pipeline (queue 1 item 7b) ------------

CACHE_TILES, CACHE_HOT = 32, 4      # bench.py config 12: a 45-degree grid
CACHE_TILE_PX = 256
CACHE_THREADS = 32
CACHE_REQUESTS = 12                 # per worker and phase, the reference's
CACHE_BUDGET_S = 60.0               # phases A-E (the write is set-up)
CACHE_WRITE_ROWS, CACHE_WRITE_S = 100, 0.02    # phase D's write stream
CACHE_EXACT_TILES = CACHE_HOT + 2


def _cache_off(fn):
    """fn() with the store's result cache off for this thread only (as
    bench.py config 12 phase E recomputes), so that a loop repeating one
    pushdown times its compute, as before the cache."""
    from geomesa_tpu_torch.cache import CACHE_ENABLED
    CACHE_ENABLED.thread_local_set("false")
    try:
        return fn()
    finally:
        CACHE_ENABLED.thread_local_set(None)


def _hit_ms(ds, fn, runs: int = 3):
    """Median host-clock ms of ``runs`` cache hits of fn(), after one call
    that installs its entry (a miss unless an earlier call did). Fails
    the run if any timed call was not a hit."""
    fn()
    h0 = ds.result_cache.hits
    times = [_timed(fn) for _ in range(runs)]
    if ds.result_cache.hits - h0 != runs:
        raise SystemExit("a repeated pushdown was not served from the cache")
    return statistics.median(times)


def _counter(name: str) -> int:
    from geomesa_tpu_torch.metrics import metrics
    return metrics.snapshot()["counters"].get(name, 0)


def _latency_pcts(lat) -> dict:
    a = np.asarray(lat) * 1e3
    return {f"p{q}_ms": float(np.percentile(a, q)) for q in (50, 95, 99)}


def cache_tile(i: int) -> tuple:
    x0 = -180.0 + (i % 8) * 45.0
    y0 = -90.0 + ((i // 8) % 4) * 45.0
    return (x0, y0, x0 + 45.0, y0 + 45.0)


def phase_cache(seed: int, rows: int) -> tuple[dict, dict]:
    """bench.py config 12, phases A-E, on the card: hot-tile density
    serving through the store's result cache. ``tiles12``
    (dtg:Date,*geom:Point) holds ``rows`` uniform world points (the
    reference's N_BIG is 100M: ``reduced``). 32 tiles of 256 x 256 on a
    45-degree grid, 4 hot ones asked 80 % of the time, 32 threads x
    CACHE_REQUESTS requests a phase, each worker's schedule fixed by its
    phase's seed. (A) uncached (the cache off process-wide), (B) cached
    warm, (C) single flight: 32 identical cold requests, (D) cached
    under a write stream of 100 rows every 20 ms with a
    CacheRefresher(interval_s=0.05, top_k=4), (E) exactness: six tiles'
    cached grids against a fresh recompute at the same version (the
    cache off for this thread), one against density_brute over every
    row written. Requests a worker are cut (``cut``) only if phases A
    and D would pass CACHE_BUDGET_S. Launch counts zeroed after the
    write and read after (E)."""
    import threading
    from geomesa_tpu_torch import InMemoryDataStore
    from geomesa_tpu_torch.cache import CACHE_ENABLED, CacheRefresher
    from geomesa_tpu_torch.scan import kernels
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 12)
    x = rng.uniform(-180, 180, rows)
    y = rng.uniform(-90, 90, rows)
    ms = rng.integers(T0_DAY * MS_DAY, T1_DAY * MS_DAY, rows)
    ds = InMemoryDataStore()
    ds.create_schema("tiles12", "dtg:Date,*geom:Point:srid=4326")
    ds.write_dict("tiles12", np.arange(rows).astype(str).astype(object),
                  {"dtg": ms, "geom": (x, y)})
    del ms
    px = CACHE_TILE_PX

    def serve(i):
        return ds.density("tiles12", "INCLUDE", cache_tile(int(i)), px, px)

    # the first call pays the index, the device columns and the kernel
    # library; then the uncached cost of one request, for the cut
    serve(0)
    setup_s = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    _cache_off(lambda: [serve(i) for i in range(CACHE_HOT)])
    probe_s = (time.perf_counter() - t0) / CACHE_HOT
    nq = min(CACHE_REQUESTS, max(2, int(
        0.4 * CACHE_BUDGET_S / (CACHE_THREADS * probe_s))))
    cut = None if nq == CACHE_REQUESTS else {"requests_per_worker": nq,
                                             "of": CACHE_REQUESTS}
    kernels.reset_launches()
    t_main = time.perf_counter()

    def run_phase(phase_seed):
        prng = np.random.default_rng(phase_seed)
        sched = [np.where(prng.random(nq) < 0.8,
                          prng.integers(0, CACHE_HOT, nq),
                          prng.integers(CACHE_HOT, CACHE_TILES, nq))
                 for _ in range(CACHE_THREADS)]
        lat = [[] for _ in range(CACHE_THREADS)]
        hot = [[] for _ in range(CACHE_THREADS)]
        barrier = threading.Barrier(CACHE_THREADS)
        errors = []

        def worker(w):
            try:
                barrier.wait(60.0)
                for i in sched[w]:
                    t0 = time.perf_counter()
                    serve(i)
                    dt = time.perf_counter() - t0
                    lat[w].append(dt)
                    if i < CACHE_HOT:
                        hot[w].append(dt)
            except Exception as e:   # noqa: BLE001 (fails the phase)
                errors.append(repr(e))
        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(CACHE_THREADS)]
        h0, m0 = ds.result_cache.hits, ds.result_cache.misses
        w0 = ds.result_cache.singleflight_waits
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        if errors:
            raise SystemExit(f"cache: a worker failed: {errors[:3]}")
        alls = [v for ws in lat for v in ws]
        hots = [v for ws in hot for v in ws] or alls
        hits = ds.result_cache.hits - h0
        misses = ds.result_cache.misses - m0
        return {"requests": len(alls), "qps": len(alls) / wall,
                **_latency_pcts(alls),
                "hot_p99_ms": _latency_pcts(hots)["p99_ms"],
                "hits": hits, "misses": misses,
                "singleflight_waits": ds.result_cache.singleflight_waits - w0,
                "hit_rate": hits / max(hits + misses, 1), "seconds": wall}

    out = {"phase": "cache", "rows": rows, "card": card_line(),
           "tiles": CACHE_TILES, "hot": CACHE_HOT, "width": px,
           "threads": CACHE_THREADS, "requests_per_worker": nq, "cut": cut,
           "reduced": {"rows": rows, "of": 100_000_000,
                       "why": "bench.py's N_BIG; the script's other "
                              "phases hold the card's memory and time"},
           "setup_s": setup_s, "uncached_probe_ms": probe_s * 1e3}
    # (A) uncached: the process-wide switch, every thread
    CACHE_ENABLED.set("false")
    try:
        out["uncached"] = run_phase(7)
    finally:
        CACHE_ENABLED.set(None)
    # (B) cached warm: every tile installed at the current version
    for i in range(CACHE_TILES):
        serve(i)
    out["cached"] = run_phase(8)
    out["hot_p99_speedup"] = (out["uncached"]["hot_p99_ms"]
                              / max(out["cached"]["hot_p99_ms"], 1e-9))
    # (C) single flight: 32 identical cold requests, one compute
    cache = ds.result_cache
    cache.invalidate()
    m0, sf0, c0 = (cache.misses, cache.singleflight_waits,
                   _counter("cache.misses"))
    launches0 = kernels.launches["density_grid"]
    barrier = threading.Barrier(CACHE_THREADS)
    grids = [None] * CACHE_THREADS

    def cold(w):
        barrier.wait(60.0)
        grids[w] = serve(0)
    threads = [threading.Thread(target=cold, args=(w,))
               for w in range(CACHE_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    flight = {"requests": CACHE_THREADS, "misses": cache.misses - m0,
              "cache_misses_counter": _counter("cache.misses") - c0,
              "waits": cache.singleflight_waits - sf0,
              "launches": kernels.launches["density_grid"] - launches0,
              "same_grids": all(g is not None
                                and g.tobytes() == grids[0].tobytes()
                                for g in grids)}
    out["singleflight"] = flight
    del grids
    # (D) cached under writes, the refresher re-materializing hot tiles
    stop = threading.Event()
    written = {"x": [], "y": [], "rows": 0}
    werrors = []

    def writer():
        w_rng = np.random.default_rng(seed + 999)
        try:
            while not stop.is_set():
                k = CACHE_WRITE_ROWS
                wx = w_rng.uniform(-180, 180, k)
                wy = w_rng.uniform(-90, 90, k)
                ds.write_dict("tiles12", np.array(
                    [f"w{written['rows'] + j}" for j in range(k)],
                    dtype=object), {"dtg": w_rng.integers(
                        T0_DAY * MS_DAY, T1_DAY * MS_DAY, k),
                        "geom": (wx, wy)})
                written["x"].append(wx)
                written["y"].append(wy)
                written["rows"] += k
                stop.wait(CACHE_WRITE_S)
        except Exception as e:   # noqa: BLE001 (fails the phase)
            werrors.append(repr(e))
    e0 = _counter("cache.refresh.errors")
    k0 = _counter("cache.refresh.crashes")
    refresher = CacheRefresher(ds, interval_s=0.05, top_k=CACHE_HOT).start()
    wt = threading.Thread(target=writer)
    wt.start()
    try:
        out["cached_under_writes"] = run_phase(9)
    finally:
        stop.set()
        wt.join()
        refresher.stop()
    out["cached_under_writes"].update(
        rows_written=written["rows"], refresh_runs=refresher.runs,
        refresh_errors=_counter("cache.refresh.errors") - e0,
        refresh_crashes=_counter("cache.refresh.crashes") - k0,
        refreshes=cache.refreshes)
    out["hot_p99_speedup_under_writes"] = (
        out["uncached"]["hot_p99_ms"]
        / max(out["cached_under_writes"]["hot_p99_ms"], 1e-9))
    # (E) exactness: a cached grid (a hit) against a fresh recompute at
    # the same version; tile 0 against the brute force over every row
    # (a density grid clips the rows outside its box to the edge cells)
    exact, version = [], ds.pushdown_version("tiles12")
    for i in range(CACHE_EXACT_TILES):
        serve(i)
        h0 = cache.hits
        g_cached = serve(i)
        g_fresh = _cache_off(lambda: serve(i))
        exact.append(cache.hits == h0 + 1
                     and g_cached.tobytes() == g_fresh.tobytes())
    same_version = ds.pushdown_version("tiles12") == version
    ax = np.concatenate([x] + written["x"])
    ay = np.concatenate([y] + written["y"])
    want, _ = density_brute(ax, ay, np.ones(len(ax), bool), cache_tile(0),
                            px, px)
    brute_ok = bool(np.array_equal(serve(0), want))
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    out.update(exact_at_version=exact, same_version=same_version,
               brute_tile0=brute_ok, rows_at_end=ds.count("tiles12"),
               cache_status={k: v for k, v in ds.cache_status().items()
                             if k in ("entries", "bytes", "hits", "misses",
                                      "evictions", "singleflight_waits",
                                      "refreshes", "invalidations")},
               launches={"density_grid": launches["density_grid"]},
               main_s=time.perf_counter() - t_main,
               seconds=time.perf_counter() - t_phase)
    for p in ("uncached", "cached", "cached_under_writes"):
        emit({"phase": "cache", "part": p, **out[p]})
    wrong = []
    if werrors:
        wrong.append(("writer", werrors[:3]))
    if not (flight["misses"] == 1 and flight["cache_misses_counter"] == 1
            and flight["launches"] == 1 and flight["same_grids"]):
        wrong.append(("singleflight", flight))
    if not (all(exact) and same_version and brute_ok):
        wrong.append(("exactness", exact, same_version, brute_ok))
    d = out["cached_under_writes"]
    if d["refresh_errors"] or d["refresh_crashes"] or not d["refresh_runs"]:
        wrong.append(("refresher", d["refresh_runs"], d["refresh_errors"],
                      d["refresh_crashes"]))
    if ds.count("tiles12") != rows + written["rows"]:
        wrong.append(("rows", ds.count("tiles12"), rows + written["rows"]))
    out["wrong"] = wrong
    emit(out)
    del ds, ax, ay, x, y
    torch.cuda.empty_cache()
    if wrong:
        raise SystemExit(f"cache: {wrong}")
    if not launches["density_grid"]:
        raise SystemExit("cache: density_grid never launched")
    out["F_replicated"], f_launches = cache12f(seed)
    launches["density_grid"] += f_launches
    return launches, out


INGEST_ROWS = 1_000_000             # bench.py config 16's own rows
INGEST_CHUNKS = (4_096, 65_536)     # the scalar leg's writes, the staged
INGEST_READERS, INGEST_READ_ROUNDS = 32, 4
INGEST_LIVE_ROWS = 200_000          # (B): the live pipeline ingest
INGEST_KILL_ROWS, INGEST_KILL_BATCH = 100_000, 1_024   # (C)
INGEST_KILL_GROUP = 8_192
INGEST_BUDGET_S = 90.0
INGEST_SCALAR_SHARE = 0.35          # of the budget: the scalar leg's cut


def ingest_queries(m: int, seed: int) -> list:
    """bench.py config 16 (B)'s reads: BBOX queries of 40 x 25 degrees."""
    q_rng = np.random.default_rng(seed)
    out = []
    for _ in range(m):
        x0 = float(q_rng.uniform(-150, 110))
        y0 = float(q_rng.uniform(-70, 45))
        out.append(f"BBOX(geom, {x0:.4f}, {y0:.4f}, {x0 + 40:.4f}, "
                   f"{y0 + 25:.4f})")
    return out


def read_battery(ds, seed: int, watch=None) -> dict:
    """INGEST_READERS threads x INGEST_READ_ROUNDS BBOX queries; each
    thread also reads the store's count after each query (``watch``
    collects them, with the thread, in order)."""
    import threading
    lat, lock, errors = [], threading.Lock(), []
    ends = []

    def worker(wid):
        try:
            mine, seen = [], []
            for ecql in ingest_queries(INGEST_READ_ROUNDS, seed + wid):
                t0 = time.perf_counter()
                ds.query(ecql, "ais16").ids
                t1 = time.perf_counter()
                mine.append(t1 - t0)
                seen.append(ds.count("ais16"))
            with lock:
                lat.extend(mine)
                ends.append(t1)
                if watch is not None:
                    watch.append(seen)
        except Exception as e:   # noqa: BLE001 (fails the phase)
            errors.append(repr(e))
    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(INGEST_READERS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise SystemExit(f"ingest: a reader failed: {errors[:3]}")
    return {**_latency_pcts(lat), "queries": len(lat),
            "seconds": time.perf_counter() - t0, "last_end": max(ends)}


def phase_ingest(seed: int) -> tuple[dict, dict]:
    """bench.py config 16 whole (A-C) at its own 1M rows, into durable
    stores on the card (each under a temporary directory, removed at
    the end). (A) its CSV converted and written two ways under the
    "interval" fsync policy: the scalar leg (record-at-a-time
    transforms, geomesa.ingest.vectorized off for this thread only, one
    store.write per 4,096 rows; cut to its first rows once past its
    share of INGEST_BUDGET_S, ``cut``) against the columnar converter
    staging 65,536-row batches through IngestPipeline; rows/s, writes,
    staged batches, groups, fsyncs, the speedup beside the reference's
    5x. (B) 32 reader threads x 4 BBOX queries of 40 x 25 degrees on the
    pipeline's store, idle, then during a pipeline ingest of 200k new
    rows: p50 and p99 of each and their ratio beside the reference's 10;
    every reader's counts after each query only rise, and each is a
    committed group's boundary. (C) the kill image: under "always",
    group_rows 8,192 and batches of 1,024, half of 100k rows staged,
    the directory copied while the writer runs, the copy reopened on
    the card. Gates: every store's count equals the converter's
    successes; groups <= staged batches and fsyncs <= groups + 1 in
    (A); the recovered rows >= the rows acked before the copy; a
    BBOX+time query on each (A) store, through the gathered and the
    dense tiers, equals the brute force over the CSV's values. Launch
    counts zeroed before (A) and read after (C)."""
    import gc
    import shutil
    import tempfile
    import threading

    import pyarrow.csv  # noqa: F401  (the vectorized CSV parse)

    from geomesa_tpu_torch import InMemoryDataStore
    from geomesa_tpu_torch.convert import EvaluationContext, converter_for
    from geomesa_tpu_torch.convert.vectorized import INGEST_VECTORIZED
    from geomesa_tpu_torch.features.sft import parse_spec
    from geomesa_tpu_torch.ingest import IngestPipeline
    from geomesa_tpu_torch.scan import kernels
    t_phase = time.perf_counter()
    rows = INGEST_ROWS
    text, x, y, ms = convert_csv(seed, rows)
    live_text, lx, ly, lms = convert_csv(seed + 1, INGEST_LIVE_ROWS,
                                         start=rows)
    setup_s = time.perf_counter() - t_phase
    conv = converter_for(parse_spec("ais16", FS_SPEC), CONVERT_CSV)
    week = [int(np.datetime64(f"2017-03-{dd:02d}", "ms").astype(np.int64))
            for dd in (5, 12)]
    roots = [tempfile.mkdtemp(prefix=f"geomesa-ingest16-{p}-")
             for p in ("scalar", "vec", "kill", "img")]
    out = {"phase": "ingest", "rows": rows, "card": card_line(),
           "setup_s": setup_s}
    wrong = []

    def check(ds, what, n_rows, xs, ys, mss):
        """count == the rows, a BBOX+time query through both kernel
        tiers equal to the brute force over those rows."""
        want = _brute(xs, ys, mss, [(-80, 30, -60, 45)], week)
        for tier in ("gathered", "dense"):
            _fs_tier(tier)
            try:
                got = np.sort(np.array([int(i[1:]) for i in ds.query(
                    CONVERT_QUERY, "ais16").ids], dtype=np.int64))
                count = ds.query_count(CONVERT_QUERY, "ais16")
            finally:
                _fs_tier(None)
            if not (np.array_equal(got, want) and count == len(want)):
                wrong.append((what, tier, len(got), count, len(want)))
        if ds.count("ais16") != n_rows:
            wrong.append((what, "count", ds.count("ais16"), n_rows))
        return len(want)

    kernels.reset_launches()
    try:
        # (A) the scalar leg: a 2 % probe, then the rows its share allows
        ds = InMemoryDataStore(durable_dir=roots[0], wal_fsync="interval")
        ds.create_schema(parse_spec("ais16", FS_SPEC))
        probe = rows // 50
        probe_text = text[:text.index("\n", len(text) * probe // rows) + 1]
        INGEST_VECTORIZED.thread_local_set("false")
        try:
            t0 = time.perf_counter()
            n_probe = sum(b.n for b, _ in conv.iter_batches(
                probe_text, EvaluationContext(),
                batch_rows=INGEST_CHUNKS[0]))
            rate = n_probe / (time.perf_counter() - t0)
            fit = int(rate * INGEST_SCALAR_SHARE * INGEST_BUDGET_S / 2)
            sub = text if fit >= rows else text[:text.index(
                "\n", len(text) * fit // rows) + 1]
            scalar_rows = sub.count("\n")
            cut = None if scalar_rows == rows else {"scalar_rows":
                                                    scalar_rows, "of": rows}
            ctx = EvaluationContext()
            gc.collect()
            gc.disable()
            f0, t0 = _counter("wal.fsyncs"), time.perf_counter()
            writes = 0
            for batch, _ in conv.iter_batches(sub, ctx,
                                              batch_rows=INGEST_CHUNKS[0]):
                ds.write("ais16", batch)
                writes += 1
            scalar_s = time.perf_counter() - t0
            scalar_fsyncs = _counter("wal.fsyncs") - f0
        finally:
            gc.enable()
            INGEST_VECTORIZED.thread_local_set(None)
        if ctx.success != scalar_rows:
            wrong.append(("scalar successes", ctx.success, scalar_rows))
        check(ds, "scalar", ctx.success, x[:scalar_rows], y[:scalar_rows],
              ms[:scalar_rows])
        ds.close()
        del ds
        # (A) the pipeline leg: the columnar converter, staged
        ds = InMemoryDataStore(durable_dir=roots[1], wal_fsync="interval")
        ds.create_schema(parse_spec("ais16", FS_SPEC))
        ctx = EvaluationContext()
        gc.collect()
        gc.disable()
        try:
            f0, g0, t0 = (_counter("wal.fsyncs"), _counter("ingest.groups"),
                          time.perf_counter())
            staged = 0
            with IngestPipeline(ds) as pipe:
                for batch, _ in conv.iter_batches(
                        text, ctx, batch_rows=INGEST_CHUNKS[1]):
                    pipe.write("ais16", batch)
                    staged += 1
                pipe.flush()
                vec_s = time.perf_counter() - t0
                vec_fsyncs = _counter("wal.fsyncs") - f0
                vec_groups = _counter("ingest.groups") - g0
        finally:
            gc.enable()
        if ctx.success != rows:
            wrong.append(("pipeline successes", ctx.success, rows))
        hits = check(ds, "pipeline", rows, x, y, ms)
        scalar_rps, vec_rps = scalar_rows / scalar_s, rows / vec_s
        out["A"] = {
            "scalar_per_write": {"chunk_rows": INGEST_CHUNKS[0],
                                 "rows": scalar_rows, "seconds": scalar_s,
                                 "rows_per_s": scalar_rps, "writes": writes,
                                 "fsyncs": scalar_fsyncs},
            "pipeline": {"chunk_rows": INGEST_CHUNKS[1], "rows": rows,
                         "seconds": vec_s, "rows_per_s": vec_rps,
                         "staged_batches": staged, "groups": vec_groups,
                         "fsyncs": vec_fsyncs},
            "speedup": vec_rps / scalar_rps, "speedup_reference_min": 5.0,
            "cut": cut, "query_hits": hits}
        if not (vec_groups <= staged and vec_fsyncs <= vec_groups + 1):
            wrong.append(("groups/fsyncs", staged, vec_groups, vec_fsyncs))
        emit({"phase": "ingest", "part": "A", **out["A"]})

        # (B) reads, idle and during a live pipeline ingest
        ds.query(ingest_queries(1, 5)[0], "ais16")   # warm the plan path
        idle = read_battery(ds, 1000)
        boundaries = [ds.count("ais16")]
        real_many = ds.write_many

        def counted_many(type_name, pairs):
            r = real_many(type_name, pairs)
            boundaries.append(boundaries[-1] + sum(b.n for b, _ in pairs))
            return r
        ds.write_many = counted_many
        lctx = EvaluationContext()
        perrors, pump_end = [], [None]
        started = threading.Event()

        def pump():
            try:
                with IngestPipeline(ds) as pipe:
                    for batch, _ in conv.iter_batches(
                            live_text, lctx, batch_rows=INGEST_CHUNKS[1]):
                        pipe.write("ais16", batch)
                        started.set()
                    pipe.flush()
            except Exception as e:   # noqa: BLE001 (fails the phase)
                perrors.append(repr(e))
            finally:
                started.set()
                pump_end[0] = time.perf_counter()
        pumper = threading.Thread(target=pump)
        watch = []
        pumper.start()
        started.wait(60.0)
        t_load = time.perf_counter()
        loaded = read_battery(ds, 2000, watch)
        pumper.join()
        ds.write_many = real_many
        rising = all(all(a <= b for a, b in zip(s, s[1:])) for s in watch)
        bset = set(boundaries)
        whole = all(c in bset for s in watch for c in s)
        overlap = ((min(pump_end[0], loaded["last_end"]) - t_load)
                   / max(loaded["last_end"] - t_load, 1e-9))
        ratio = loaded["p99_ms"] / max(idle["p99_ms"], 1e-9)
        out["B"] = {"readers": INGEST_READERS, "rounds": INGEST_READ_ROUNDS,
                    "idle": idle, "loaded": loaded,
                    "p50_ratio": loaded["p50_ms"] / max(idle["p50_ms"], 1e-9),
                    "p99_ratio": ratio, "p99_ratio_reference_max": 10.0,
                    "live_rows": INGEST_LIVE_ROWS,
                    "groups_during": len(boundaries) - 1,
                    "loaded_share_during_ingest": max(0.0, min(1.0, overlap)),
                    "counts_rise": rising, "counts_at_group_bounds": whole}
        if perrors:
            wrong.append(("live pipeline", perrors[:3]))
        if not (rising and whole):
            wrong.append(("reads saw a half-applied group", rising, whole))
        if lctx.success != INGEST_LIVE_ROWS:
            wrong.append(("live successes", lctx.success))
        check(ds, "pipeline+live", rows + INGEST_LIVE_ROWS,
              np.concatenate([x, lx]), np.concatenate([y, ly]),
              np.concatenate([ms, lms]))
        emit({"phase": "ingest", "part": "B", **out["B"]})
        ds.close()
        del ds
        gc.collect()

        # (C) the kill image under "always"
        kill_text = text[:text.index(
            "\n", len(text) * INGEST_KILL_ROWS // rows) + 1]
        ds = InMemoryDataStore(durable_dir=roots[2], wal_fsync="always")
        ds.create_schema(parse_spec("ais16", FS_SPEC))
        acks, kctx = [], EvaluationContext()
        half = (INGEST_KILL_ROWS // INGEST_KILL_BATCH) // 2
        with IngestPipeline(ds, group_rows=INGEST_KILL_GROUP) as pipe:
            for batch, _ in conv.iter_batches(
                    kill_text, kctx, batch_rows=INGEST_KILL_BATCH):
                acks.append((pipe.write("ais16", batch), batch.n))
                if len(acks) >= half:
                    break
            acked = sum(n for a, n in acks if a is not None and a.done)
            t0 = time.perf_counter()
            shutil.rmtree(roots[3])
            shutil.copytree(roots[2], roots[3])
            copy_s = time.perf_counter() - t0
        staged_rows = sum(n for _, n in acks)
        if ds.count("ais16") != staged_rows:
            wrong.append(("kill store count", ds.count("ais16"),
                          staged_rows))
        ds.close()
        del ds
        t0 = time.perf_counter()
        img = InMemoryDataStore(durable_dir=roots[3], wal_fsync="always")
        recovered = img.count("ais16")
        reopen_s = time.perf_counter() - t0
        ids = np.sort(np.array([int(i[1:]) for i in img.query(
            "INCLUDE", "ais16").ids], dtype=np.int64))
        img.close()
        del img
        if not (recovered >= acked and np.array_equal(
                ids, np.arange(recovered))):
            wrong.append(("kill image", acked, recovered))
        out["C"] = {"group_rows": INGEST_KILL_GROUP,
                    "batch_rows": INGEST_KILL_BATCH,
                    "staged_rows": staged_rows, "acked_at_copy": acked,
                    "recovered": recovered, "copy_s": copy_s,
                    "reopen_s": reopen_s,
                    "zero_acked_loss": recovered >= acked}
        emit({"phase": "ingest", "part": "C", **out["C"]})
    finally:
        for r in roots:
            shutil.rmtree(r, ignore_errors=True)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    out.update(launches={k: launches[k] for k in (
        "scan_mask", "scan_mask_gather", "scan_count")},
        seconds=time.perf_counter() - t_phase, budget_s=INGEST_BUDGET_S,
        wrong=wrong)
    emit({k: out[k] for k in ("phase", "rows", "card", "setup_s", "launches",
                              "seconds", "budget_s", "wrong")})
    gc.collect()
    torch.cuda.empty_cache()
    if wrong:
        raise SystemExit(f"ingest: {wrong}")
    if not launches["scan_mask"] + launches["scan_mask_gather"]:
        raise SystemExit("ingest: the scan kernels never launched")
    return launches, out


# -- the lifecycle: online schema evolution, views, harness, jobs --------------

LIFECYCLE_BUDGET_S = 90.0        # the lifecycle phase's share of the script
LIFECYCLE_MEM_SLACK = 64 << 20   # memory_allocated after a part, at most above
EVOLVE24_ROWS = 1_000_000        # bench.py config 24's own rows
EVOLVE24_C = 32                  # its client threads: 16 writers, 16 readers
EVOLVE24_WRITE_ROWS = 200        # rows a writer's batch
EVOLVE24_OFF_ROWS = 20_000       # the kill-switch leg's twin stores
EVOLVE24_SPEC = "*geom:Point:srid=4326,name:String,val:Integer"
EVOLVE24_BOX = (-80.0, 30.0, -60.0, 45.0)   # the north star's box (no dtg)
EVOLVE10M_READERS = 8
VIEWS23_ROWS = 1_000_000         # bench.py config 23's own rows
VIEWS23_COMMIT_ROWS = 1_000
VIEWS23_COMMITS = 20
VIEWS23_REPS = 3                 # full re-executions for their p50
VIEWS23_DELETES = 500
VIEWS23_SQL = ("SELECT name, COUNT(*) AS c, SUM(val) AS s, AVG(val) AS a, "
               "MIN(val) AS lo, MAX(val) AS hi FROM pts23 GROUP BY name")
HARNESS_ROUNDS, HARNESS_WRITES = 3, 20
JOBS_FS_ROWS = 200_000           # the file store SchemaCopyJob reads
JOBS_CSV_ROWS = 100_000          # the delimited input, in JOBS_CSV_FILES
JOBS_CSV_FILES = 4
JOBS_WORKERS = 4


def _mem() -> int:
    import gc
    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _evolve_probe(ds) -> tuple[dict, dict]:
    """A fault hook that never fires: it stamps each of the evolver's
    kill points with the host clock and memory_allocated at the snapshot's
    end and after the shadow's index build, and times that build alone
    (wrapping the shadow's ensure_index once the snapshot has built it).
    Returns (hook, record)."""
    rec = {"t": {}, "mem": {}}

    def hook(tag):
        rec["t"].setdefault(tag, time.perf_counter())
        evo = ds.evolver._active
        if tag == "snapshot.done":
            rec["mem"]["after_snapshot"] = _mem()
            rec["shadow_device"] = str(evo.shadow.device)
            shadow = evo.shadow
            build = shadow.ensure_index

            def timed_build():
                # the evolver's one call; the flipped state's later calls
                # (queries) go to the class's method again
                del shadow.ensure_index
                t0 = time.perf_counter()
                build()
                rec["index_build_s"] = time.perf_counter() - t0
            shadow.ensure_index = timed_build
        elif tag == "catchup.done":
            rec["mem"]["after_index_build"] = _mem()
            sd = evo.shadow.scan_data
            rec["shadow_columns"] = None if sd is None else str(sd.xhi.device)
            rec["shadow_scan_data"] = id(sd)
    return hook, rec


def _evolve_times(rec: dict) -> dict:
    t = rec["t"]

    def span(a, b):
        return t[b] - t[a] if a in t and b in t else None
    return {"snapshot_s": span("snapshot.start", "snapshot.done"),
            "catchup_and_index_s": span("snapshot.done", "catchup.done"),
            "index_build_s": rec.get("index_build_s"),
            "flip_s": span("catchup.done", "flip.done"),
            "cut_ms": (span("flip.cut", "flip.done") or 0.0) * 1e3}


def _memory_gate(mem: dict, what: str) -> list:
    """The superseded copy must leave the card: after the flip (or the
    abort) the memory is back within a quarter of the shadow's build
    (plus LIFECYCLE_MEM_SLACK) of where it was before the evolution."""
    built = max(mem["after_index_build"] - mem.get("after_snapshot",
                                                   mem["before"]), 0)
    if mem["after"] > mem["before"] + built // 4 + LIFECYCLE_MEM_SLACK:
        return [(f"{what}: device memory of the losing copy not returned",
                 mem)]
    return []


def _first_query(ds, tn: str, ecql: str) -> dict:
    """The first query on a type after a flip: its seconds, and whether
    it rebuilt the device structures (the staging deletes drop them) or
    merged pending rows in place."""
    st = ds._types[tn]
    rebuild = st.dirty or st.scan_data is None
    pending = st._pending_n
    t0 = time.perf_counter()
    res = ds.query(ecql, tn)
    res.ids
    return {"first_query_s": time.perf_counter() - t0,
            "rebuilt": bool(rebuild), "pending_rows_merged": int(pending)}


def evolve24(seed: int) -> tuple[dict, list]:
    """bench.py config 24 on the card: a durable store (wal_fsync
    "never") of 1M rows, 16 writer and 16 reader threads, the evolver
    reindexing the type from version 2 to version 1 in the middle; then
    a crash at a random kill point and resume(), an abort that must free
    the shadow, the kill switch off beside a twin store, and the north
    star's box on the evolved type against a float64 brute force."""
    import tempfile
    import threading

    from geomesa_tpu_torch import InMemoryDataStore
    from geomesa_tpu_torch.evolve import (EVOLVE_ENABLED, Evolver,
                                          SchemaEvolutionError)
    from geomesa_tpu_torch.features import FeatureBatch, parse_spec
    from geomesa_tpu_torch.scan import kernels
    from geomesa_tpu_torch.utils.device import cuda_index, device_scope
    from geomesa_tpu_torch.utils.properties import SystemProperty
    wrong = []
    sft = parse_spec("pts24", EVOLVE24_SPEC)
    names = np.array([f"grp{i}" for i in range(32)], dtype=object)

    def batch(rng, m, prefix, name=None, bsft=None):
        ids = np.array([f"{prefix}{i}" for i in range(m)], dtype=object)
        col = (np.full(m, name, dtype=object) if name is not None
               else names[rng.integers(0, len(names), m)])
        return FeatureBatch.from_dict(bsft if bsft is not None else sft, ids, {
            "geom": (rng.uniform(-170, 170, m), rng.uniform(-80, 80, m)),
            "name": col,
            "val": rng.integers(0, 1_000_000, m).astype(np.int64)})

    rng = np.random.default_rng(seed + 24)
    root = tempfile.mkdtemp(prefix="geomesa-evolve24-")
    out = {"part": "evolve24", "rows": EVOLVE24_ROWS, "c": EVOLVE24_C}
    try:
        t0 = time.perf_counter()
        ds = InMemoryDataStore(durable_dir=os.path.join(root, "wal"),
                               wal_fsync="never")
        ds.create_schema(sft)
        seed_b = batch(rng, EVOLVE24_ROWS, "s")
        ds.write("pts24", seed_b)
        # the readers' truth: writers only append name='writer' rows, so
        # the grp7 ids stay those of the seed rows through the flip
        col = seed_b.col("name")
        expected = set(seed_b.ids[col.vocab[col.codes] == "grp7"].tolist())
        ds.query("name = 'grp7'", "pts24").ids     # index and columns
        out["setup_s"] = time.perf_counter() - t0
        writers = EVOLVE24_C // 2
        readers = EVOLVE24_C - writers
        index = cuda_index(ds)
        stop = threading.Event()
        acked = [set() for _ in range(writers)]
        stalls = [0.0] * writers
        errs = {"mismatch": 0, "typed": 0, "untyped": 0, "refresh": 0,
                "reads": 0}
        untyped = []
        lock = threading.Lock()

        def writer(w):
            wrng = np.random.default_rng(seed * 1000 + w)
            k = 0
            cur = ds.get_schema("pts24")
            with device_scope(index):
                while not stop.is_set():
                    b = batch(wrng, EVOLVE24_WRITE_ROWS, f"w{w}_{k}_",
                              name="writer", bsft=cur)
                    t = time.perf_counter()
                    try:
                        ds.write("pts24", b)
                    except SchemaEvolutionError:
                        with lock:
                            errs["typed"] += 1
                        continue
                    except ValueError:
                        # the flip changed the schema's index version:
                        # re-read it and send the same ids again
                        cur = ds.get_schema("pts24")
                        with lock:
                            errs["refresh"] += 1
                        continue
                    except Exception as e:   # noqa: BLE001 - counted
                        with lock:
                            errs["untyped"] += 1
                            untyped.append(repr(e)[:200])
                        continue
                    stalls[w] = max(stalls[w], time.perf_counter() - t)
                    acked[w].update(b.ids.tolist())
                    k += 1

        def reader():
            with device_scope(index):
                while not stop.is_set():
                    try:
                        got = set(ds.query("name = 'grp7'", "pts24")
                                  .ids.tolist())
                    except SchemaEvolutionError:
                        with lock:
                            errs["typed"] += 1
                        continue
                    except Exception as e:   # noqa: BLE001 - counted
                        with lock:
                            errs["untyped"] += 1
                            untyped.append(repr(e)[:200])
                        continue
                    with lock:
                        errs["reads"] += 1
                        if got != expected:
                            errs["mismatch"] += 1

        threads = ([threading.Thread(target=writer, args=(w,), daemon=True)
                    for w in range(writers)]
                   + [threading.Thread(target=reader, daemon=True)
                      for _ in range(readers)])
        EVOLVE_ENABLED.set("true")
        try:
            mem = {"before": _mem()}
            hook, rec = _evolve_probe(ds)
            for t in threads:
                t.start()
            time.sleep(0.05)
            ds.evolver.fault_hook = hook
            t0 = time.perf_counter()
            entry = ds.evolver.reindex("pts24", 1)
            reindex_s = time.perf_counter() - t0
            ds.evolver.fault_hook = None
            time.sleep(0.05)
            stop.set()
            for t in threads:
                t.join(timeout=60)
            mem["after"] = _mem()
            mem.update(rec["mem"])
            all_acked = set().union(*acked)
            final_ids = set(ds.query("INCLUDE", "pts24").ids.tolist())
            flips = sum(1 for h in ds.evolver.history
                        if h.get("op") == "reindex")
            out.update({
                "reindex_under_load_s": reindex_s, "flip_ms": entry["flip_ms"],
                "rounds": entry["rounds"], "barrier_lsn": entry["barrier_lsn"],
                **_evolve_times(rec), "memory": mem,
                "shadow_device": rec.get("shadow_device"),
                "shadow_columns": rec.get("shadow_columns"),
                "index_version": ds.get_schema("pts24").index_version,
                "rows_final": len(final_ids), "rows_acked": len(all_acked),
                "reads": errs["reads"],
                "reader_mismatches": errs["mismatch"],
                "typed_refusals": errs["typed"],
                "schema_refreshes": errs["refresh"],
                "untyped_errors": errs["untyped"],
                "acked_writes_lost": len(all_acked - final_ids),
                "flips_recorded": flips,
                "write_stall_max_s": max(stalls)})
            wrong += [("untyped error", e) for e in untyped[:3]]
            if (errs["mismatch"] or errs["untyped"]
                    or out["acked_writes_lost"] or flips != 1
                    or max(stalls) > 10.0 or out["index_version"] != 1
                    or not rec.get("shadow_columns", "").startswith("cuda")):
                wrong.append(("config 24 gates", {
                    k: out[k] for k in (
                        "reader_mismatches", "untyped_errors",
                        "acked_writes_lost", "flips_recorded",
                        "write_stall_max_s", "index_version",
                        "shadow_columns")}))
            wrong += _memory_gate(mem, "evolve24 flip")
            # the north star's box on the evolved type, first query timed
            host_rows = SystemProperty("geomesa.scan.host.rows")
            ecql = "BBOX(geom, {}, {}, {}, {})".format(*EVOLVE24_BOX)
            host_rows.set("0")
            kernels.reset_launches()
            try:
                out.update(_first_query(ds, "pts24", ecql))
                res = ds.query(ecql, "pts24")
                full = ds.query("INCLUDE", "pts24").batch
                g = full.col("geom")
                x0, y0, x1, y1 = EVOLVE24_BOX
                want = full.ids[(g.x >= x0) & (g.x <= x1)
                                & (g.y >= y0) & (g.y <= y1)]
                exact = sorted(res.ids.tolist()) == sorted(want.tolist())
            finally:
                host_rows.set(None)
            scans = {k: kernels.launches[k]
                     for k in ("scan_mask", "scan_mask_gather")}
            out["north_star"] = {"hits": len(want), "exact": exact,
                                 "launches": scans}
            if not exact or not sum(scans.values()):
                wrong.append(("north star after the flip", out["north_star"]))
            # a crash at a random kill point, then resume(): exactly once
            phase = Evolver.PHASES[int(rng.integers(0, len(Evolver.PHASES)))]

            def crash_at(tag):
                def fire(t):
                    if t == tag:
                        raise RuntimeError(f"injected crash @ {t}")
                return fire
            before = flips
            ds.evolver.fault_hook = crash_at(phase)
            try:
                ds.evolver.reindex("pts24", 2)
                crashed = False
            except RuntimeError:
                crashed = True
            finally:
                ds.evolver.fault_hook = None
            t0 = time.perf_counter()
            ds.evolver.resume()
            after = sum(1 for h in ds.evolver.history
                        if h.get("op") == "reindex")
            once = after == before + 1 and \
                ds.get_schema("pts24").index_version == 2
            out.update(crash_phase=phase, crash_injected=crashed,
                       resume_s=time.perf_counter() - t0,
                       resume_completed_once=once)
            if not once:
                wrong.append(("resume did not complete once", phase))
            # an abort with the shadow built must give its memory back
            amem = {"before": _mem()}
            ahook, arec = _evolve_probe(ds)

            def abort_at(tag):
                ahook(tag)
                if tag == "catchup.done":
                    raise RuntimeError("injected crash @ catchup.done")
            ds.evolver.fault_hook = abort_at
            try:
                ds.evolver.reindex("pts24", 1)
            except RuntimeError:
                pass
            finally:
                ds.evolver.fault_hook = None
            ds.evolver.abort()
            amem["after"] = _mem()
            amem.update(arec["mem"])
            out["abort_memory"] = amem
            wrong += _memory_gate(amem, "evolve24 abort")
            if ds.get_schema("pts24").index_version != 2:
                wrong.append(("abort changed the schema", None))
        finally:
            EVOLVE_ENABLED.set(None)
        ds.close()
        del ds
        # the kill switch off: the evolver refuses, a twin stays identical
        b = batch(rng, EVOLVE24_OFF_ROWS, "o")
        off, twin = InMemoryDataStore(), InMemoryDataStore()
        for s in (off, twin):
            s.create_schema(sft)
            s.write("pts24", b)
        try:
            off.evolver.reindex("pts24", 1)
            refuses = False
        except SchemaEvolutionError:
            refuses = True
        same = (off.query("name = 'grp3'", "pts24").ids.tolist()
                == twin.query("name = 'grp3'", "pts24").ids.tolist()
                and off.query("INCLUDE", "pts24").ids.tolist()
                == twin.query("INCLUDE", "pts24").ids.tolist()
                and off._evolve_feeds == {}
                and off.get_schema("pts24") == twin.get_schema("pts24"))
        out.update(off_refuses=refuses, off_results_identical=same)
        if not (refuses and same):
            wrong.append(("kill switch off", (refuses, same)))
        del off, twin
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out, wrong


def evolve10m(ds, rows) -> tuple[dict, list]:
    """The store phase's 10M-row type: an online update_schema adding an
    Integer attribute with a default under EVOLVE10M_READERS north-star
    reader threads; every read exact or typed, the new column equal to
    its default on every row, the north star id-exact after the flip on
    the shadow's device columns. Changes the store's schema: the last use
    of the store."""
    import threading

    from geomesa_tpu_torch.evolve import EVOLVE_ENABLED, SchemaEvolutionError
    from geomesa_tpu_torch.scan import kernels
    from geomesa_tpu_torch.utils.device import cuda_index, device_scope
    from geomesa_tpu_torch.utils.properties import SystemProperty
    x, y, ms, ids = rows
    wrong = []
    ecql, boxes, iv = STORE_QUERIES[0]
    want = ids[_brute(x, y, ms, boxes, iv)]
    index = cuda_index(ds)
    stop = threading.Event()
    errs = {"reads": 0, "mismatch": 0, "typed": 0, "untyped": 0}
    untyped = []
    lock = threading.Lock()

    def reader():
        with device_scope(index):
            while not stop.is_set():
                try:
                    got = ds.query(ecql, "ais").ids
                except SchemaEvolutionError:
                    with lock:
                        errs["typed"] += 1
                    continue
                except Exception as e:   # noqa: BLE001 - counted
                    with lock:
                        errs["untyped"] += 1
                        untyped.append(repr(e)[:200])
                    continue
                with lock:
                    errs["reads"] += 1
                    if not np.array_equal(got, want):
                        errs["mismatch"] += 1

    threads = [threading.Thread(target=reader, daemon=True)
               for _ in range(EVOLVE10M_READERS)]
    mem = {"before": _mem()}
    hook, rec = _evolve_probe(ds)
    EVOLVE_ENABLED.set("true")
    try:
        for t in threads:
            t.start()
        time.sleep(0.2)
        ds.evolver.fault_hook = hook
        t0 = time.perf_counter()
        entry = ds.evolver.update_schema("ais", [
            {"op": "add", "name": "tag", "type": "Integer", "default": 7}])
        update_s = time.perf_counter() - t0
    finally:
        ds.evolver.fault_hook = None
        stop.set()
        for t in threads:
            t.join(timeout=60)
        EVOLVE_ENABLED.set(None)
    mem["after"] = _mem()
    mem.update(rec["mem"])
    host_rows = SystemProperty("geomesa.scan.host.rows")
    host_rows.set("0")          # a kernel tier for the check
    kernels.reset_launches()
    try:
        first = _first_query(ds, "ais", ecql)
        res = ds.query(ecql, "ais")
    finally:
        host_rows.set(None)
    exact = np.array_equal(res.ids, want)
    scans = {k: kernels.launches[k] for k in ("scan_mask", "scan_mask_gather")}
    st = ds._types["ais"]
    on_shadow = id(st.scan_data) == rec.get("shadow_scan_data")
    tag = st.batch.col("tag")
    defaults = bool(np.all(tag.values == 7) and np.all(tag.valid))
    out = {"part": "evolve10m", "rows": len(ids), "update_s": update_s,
           "flip_ms": entry["flip_ms"], "rounds": entry["rounds"],
           **_evolve_times(rec), **first, "memory": mem,
           "shadow_device": rec.get("shadow_device"),
           "shadow_columns": rec.get("shadow_columns"),
           "columns_after": str(st.scan_data.xhi.device),
           "spec": ds.get_schema("ais").to_spec(), "reads": errs["reads"],
           "reader_mismatches": errs["mismatch"],
           "typed_refusals": errs["typed"], "untyped_errors": errs["untyped"],
           "north_star": {"hits": len(want), "exact": exact,
                          "launches": scans,
                          "on_shadow_columns": on_shadow},
           "default_on_every_row": defaults}
    wrong += [("untyped error", e) for e in untyped[:3]]
    if errs["mismatch"] or errs["untyped"] or not defaults or not exact \
            or not sum(scans.values()) or not on_shadow \
            or not str(rec.get("shadow_columns")).startswith("cuda"):
        wrong.append(("evolve10m gates", {
            k: out[k] for k in ("reader_mismatches", "untyped_errors",
                                "default_on_every_row", "north_star",
                                "shadow_columns")}))
    wrong += _memory_gate(mem, "evolve10m flip")
    return out, wrong


def views23(seed: int) -> tuple[dict, list]:
    """bench.py config 23 on the card: a 1M-row type, a standing GROUP BY
    view over 32 groups, 20 commits of 1,000 rows each timed end to end
    (the write's fold and a read through the result cache) beside the
    p50 of full re-executions; a 500-id delete wave (its pre-image query
    timed apart); the view equal to SqlEngine re-execution (gate); the
    kill switch off beside a twin store (gates)."""
    from geomesa_tpu_torch import InMemoryDataStore
    from geomesa_tpu_torch.features import FeatureBatch, parse_spec
    from geomesa_tpu_torch.sql import SqlEngine
    from geomesa_tpu_torch.views import VIEWS_ENABLED, ViewRegistry
    wrong = []
    rng = np.random.default_rng(seed + 23)
    sft = parse_spec("pts23", "*geom:Point:srid=4326,name:String,"
                              "val:Integer")
    names = np.array([f"grp{i}" for i in range(32)], dtype=object)

    def batch(m, prefix):
        ids = np.array([f"{prefix}{i}" for i in range(m)], dtype=object)
        return FeatureBatch.from_dict(sft, ids, {
            "geom": (rng.uniform(-170, 170, m), rng.uniform(-80, 80, m)),
            "name": names[rng.integers(0, len(names), m)],
            "val": rng.integers(0, 1_000_000, m).astype(np.int64)})

    def canon(res):
        return [tuple(str(v) for v in r) for r in res.rows()]

    t0 = time.perf_counter()
    seed_b = batch(VIEWS23_ROWS, "s")
    ds = InMemoryDataStore()
    ds.create_schema(sft)
    ds.write("pts23", seed_b)
    eng = SqlEngine(ds)
    eng.query(VIEWS23_SQL)      # warm
    out = {"part": "views23", "rows": VIEWS23_ROWS,
           "commit_rows": VIEWS23_COMMIT_ROWS, "commits": VIEWS23_COMMITS,
           "setup_s": time.perf_counter() - t0}
    full = [_timed(lambda: eng.query(VIEWS23_SQL)) / 1e3
            for _ in range(VIEWS23_REPS)]
    VIEWS_ENABLED.set("true")
    try:
        reg = ViewRegistry(ds, restore=False)
        t0 = time.perf_counter()
        reg.register("hot23", VIEWS23_SQL)
        out["register_s"] = time.perf_counter() - t0
        fire = [batch(VIEWS23_COMMIT_ROWS, f"c{j}_")
                for j in range(VIEWS23_COMMITS)]
        inc = []
        for b in fire:
            t0 = time.perf_counter()
            ds.write("pts23", b)
            reg.result("hot23")
            inc.append(time.perf_counter() - t0)
        pre = []
        orig_pre = reg._pre_image

        def timed_pre(*a):
            t = time.perf_counter()
            r = orig_pre(*a)
            pre.append(time.perf_counter() - t)
            return r
        reg._pre_image = timed_pre
        doom = [f"c0_{i}" for i in range(VIEWS23_DELETES)]
        t0 = time.perf_counter()
        ds.delete("pts23", doom)
        delete_s = time.perf_counter() - t0
        reg._pre_image = orig_pre
        exact = canon(reg.result("hot23")) == canon(eng.query(VIEWS23_SQL))
        st = reg.get("hot23").status()
        reg.close()
    finally:
        VIEWS_ENABLED.set(None)
    full_s, inc_s = statistics.median(full), statistics.median(inc)
    out.update({"full_reexec_s": full, "full_p50_s": full_s,
                "incremental_commit_s": inc, "incremental_p50_s": inc_s,
                "speedup": full_s / inc_s, "reference_speedup_gate": 5.0,
                "exact_after_firehose_and_deletes": exact,
                "delete_wave_s": delete_s, "pre_image_s": sum(pre),
                "folds": st["folds"], "rows_folded": st["rows_folded"],
                "retraction_fallbacks": st["retraction_fallbacks"],
                "replays": st["replays"]})
    if not exact:
        wrong.append(("view differs from re-execution", None))
    del ds, eng, reg
    # the kill switch off: register refuses, no hook, a twin's results
    m = min(VIEWS23_ROWS, 100_000)
    off, twin = InMemoryDataStore(), InMemoryDataStore()
    for s in (off, twin):
        s.create_schema(sft)
        s.write("pts23", seed_b.take(np.arange(m)))
    off_reg = ViewRegistry(off, restore=False)
    try:
        off_reg.register("x", VIEWS23_SQL)
        refuses = False
    except ValueError:
        refuses = True
    inert = not off_reg._orig and "write" not in off.__dict__
    same = (canon(SqlEngine(off).query(VIEWS23_SQL))
            == canon(SqlEngine(twin).query(VIEWS23_SQL)))
    out.update(off_refuses=refuses, off_write_path_inert=inert,
               off_results_identical=same)
    if not (refuses and inert and same):
        wrong.append(("kill switch off", (refuses, inert, same)))
    return out, wrong


def harness_part(seed: int) -> tuple[dict, list]:
    """run_crash_workload's harness on a durable store on the card:
    HARNESS_ROUNDS rounds of HARNESS_WRITES single-feature writes, one
    random storage fault a round; gate: no violation."""
    import tempfile

    from geomesa_tpu_torch.integrity import CrashHarness
    root = tempfile.mkdtemp(prefix="geomesa-harness-")
    try:
        t0 = time.perf_counter()
        h = CrashHarness(root, seed=seed)
        rep = h.run(rounds=HARNESS_ROUNDS, writes_per_round=HARNESS_WRITES)
        kinds = {}
        for _op, _path, kind in h.faults:
            kinds[kind] = kinds.get(kind, 0) + 1
        out = {"part": "harness", **rep, "faults_by_kind": kinds,
               "device": str(h.device), "run_s": time.perf_counter() - t0}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wrong = [] if rep["ok"] and h.device.type == "cuda" else \
        [("harness", rep["violations"][:3])]
    return out, wrong


def _decoded(batch) -> dict:
    """A batch's rows sorted by id, each column as plain values (strings
    decoded, validity applied), so batches built apart compare."""
    from geomesa_tpu_torch.features.batch import PointColumn, StringColumn
    order = np.argsort(batch.ids.astype(str), kind="stable")
    out = {"ids": batch.ids.astype(str)[order].tolist()}
    for name, col in batch.columns.items():
        if isinstance(col, StringColumn):
            codes = col.codes[order]
            vals = np.where(codes >= 0, col.vocab[np.maximum(codes, 0)]
                            if len(col.vocab) else None, None)
            out[name] = vals.tolist()
        elif isinstance(col, PointColumn):
            out[name] = (col.x[order].tolist(), col.y[order].tolist())
        else:
            vals = getattr(col, "values", getattr(col, "millis", None))
            out[name] = np.where(col.valid[order], vals[order],
                                 0).tolist() + col.valid[order].tolist()
    return out


def jobs_part(seed: int) -> tuple[dict, list]:
    """The batch jobs on the card: SchemaCopyJob from a file store on the
    card into an in-memory one (the copy's ids equal the source's),
    ConverterIngestJob over JOBS_CSV_FILES delimited files (config 16's
    CSV, JOBS_CSV_ROWS rows; the store's rows equal to one scalar
    converter run over the same text), then AttributeIndexJob, after
    which an attribute query plans ``attr:`` and is id-exact."""
    import tempfile

    from geomesa_tpu_torch import FileSystemDataStore, InMemoryDataStore
    from geomesa_tpu_torch.convert import converter_for
    from geomesa_tpu_torch.features.sft import parse_spec
    from geomesa_tpu_torch.jobs import (AttributeIndexJob,
                                        ConverterIngestJob, SchemaCopyJob)
    wrong = []
    root = tempfile.mkdtemp(prefix="geomesa-jobs-")
    out = {"part": "jobs"}
    try:
        d = fs_rows(seed, JOBS_FS_ROWS)
        sft = parse_spec("ais16", FS_SPEC)
        fs = FileSystemDataStore(os.path.join(root, "fs"))
        fs.create_schema(sft)
        fs.write("ais16", fs_batch(sft, d, 0, JOBS_FS_ROWS))
        src_ids = sorted(fs.query("INCLUDE", "ais16").ids.tolist())
        dst = InMemoryDataStore()
        t0 = time.perf_counter()
        copied = SchemaCopyJob(fs, dst, n_workers=JOBS_WORKERS).run("ais16")
        out["copy_s"] = time.perf_counter() - t0
        copy_ids = sorted(dst.query("INCLUDE", "ais16").ids.tolist())
        out.update(copied=copied, copy_ids_equal=copy_ids == src_ids)
        if copied != JOBS_FS_ROWS or copy_ids != src_ids:
            wrong.append(("SchemaCopyJob ids", copied))
        # AttributeIndexJob, then an attribute query on the copy
        mmsi = int(d["mmsi"][0])
        ecql = f"mmsi = {mmsi}"
        t0 = time.perf_counter()
        AttributeIndexJob(dst).run("ais16", "mmsi")
        res = dst.query(ecql, "ais16")
        out["attr_query_s"] = time.perf_counter() - t0
        want = sorted(d["ids"][d["mmsi"] == mmsi].tolist())
        exact = sorted(res.ids.tolist()) == want
        out.update(attr_plan=res.plan.index, attr_hits=len(want),
                   attr_exact=exact)
        if res.plan.index != "attr:mmsi" or not exact:
            wrong.append(("AttributeIndexJob", res.plan.index, exact))
        del dst, fs
        # ConverterIngestJob over delimited files on disk
        text, _x, _y, _ms = convert_csv(seed, JOBS_CSV_ROWS)
        lines = text.splitlines(keepends=True)
        files = []
        per = -(-len(lines) // JOBS_CSV_FILES)
        for i in range(JOBS_CSV_FILES):
            p = os.path.join(root, f"in{i}.csv")
            with open(p, "w") as fh:
                fh.write("".join(lines[i * per:(i + 1) * per]))
            files.append(p)
        ing = InMemoryDataStore()
        t0 = time.perf_counter()
        counts = ConverterIngestJob(ing, sft, CONVERT_CSV,
                                    n_workers=JOBS_WORKERS).run(files)
        out["ingest_s"] = time.perf_counter() - t0
        scalar, _ctx = converter_for(sft, CONVERT_CSV).process(text)
        got = ing.query("INCLUDE", "ais16").batch
        same = _decoded(got) == _decoded(scalar)
        out.update(ingest_counts=counts, ingest_rows=got.n,
                   ingest_equal_scalar=same)
        if counts["success"] != JOBS_CSV_ROWS or counts["failure"] \
                or not same:
            wrong.append(("ConverterIngestJob", counts, same))
        del ing
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out, wrong


def phase_lifecycle(seed: int, ds, rows) -> tuple[dict, float]:
    """Online schema evolution, materialized views, the crash harness and
    the batch jobs on the card (see the module's head): evolve24,
    evolve10m (on the store phase's store, its last use), views23,
    harness and jobs, one line each with its launches and device memory
    before and after (its stores closed), then the phase's total beside
    LIFECYCLE_BUDGET_S. Returns the launches of the parts and the
    phase's seconds."""
    from geomesa_tpu_torch.scan import kernels
    t_phase = time.perf_counter()
    counts = {}
    wrong = []
    for name, part in (("evolve24", lambda: evolve24(seed)),
                       ("evolve10m", lambda: evolve10m(ds, rows)),
                       ("views23", lambda: views23(seed)),
                       ("harness", lambda: harness_part(seed)),
                       ("jobs", lambda: jobs_part(seed))):
        mem0 = _mem()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out, w = part()
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.launches.items() if v}
        mem1 = _mem()
        out.update(seconds=seconds, launches=launches,
                   memory_allocated_before=mem0, memory_allocated_after=mem1,
                   wrong=w, card=card_line())
        emit({"phase": "lifecycle", **out})
        if name != "evolve10m" and mem1 > mem0 + LIFECYCLE_MEM_SLACK:
            w = w + [("device memory not returned", mem0, mem1)]
        for k, v in launches.items():
            counts[k] = counts.get(k, 0) + v
        wrong += [(name, x) for x in w]
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    emit({"phase": "lifecycle", "part": "total", "seconds": seconds,
          "budget_s": LIFECYCLE_BUDGET_S, "launches": counts,
          "wrong": wrong[:8], "card": card_line()})
    if wrong:
        raise SystemExit(f"lifecycle: {wrong[:8]}")
    return counts, seconds


# -- the mesh: parallel/, DistributedDataStore, FsBackedDistributedDataStore --

MESH_BUDGET_S = 120.0        # the mesh phase's share of the script's time
MESH_SHARDS = 8              # data_mesh(8): eight shards on the one card
MESH_RUNS = 3                # host-clock runs of a call for its p50
MESH_POLYGONS = CT_RECTS     # bench.py config 5's rectangles
MESH_CHECK = 256             # contains counts held to the f64 brute force
MESH_RING_ROWS = 1_000_000   # each side of the ring's DWithin counts
MESH_RING_CHECK = 2_000      # left rows whose totals meet the f64 brute force
MESH_KNN_K = 10
MESH_FS_ROWS = 1_000_000
MESH_KERNELS = ("scan_mask", "scan_count", "scan_batch_bits",
                "compact_prefix", "compact_bits", "density_grid",
                "contains_counts", "dwithin_counts", "knn_topk",
                "extent_tristate")


def _mesh_p50(fn, runs: int = MESH_RUNS) -> tuple[float, object]:
    """(p50 ms over ``runs`` synchronised host-clock calls, the first
    call's result)."""
    times, first = [], None
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if first is None:
            first = out
    return statistics.median(times), first


@contextlib.contextmanager
def _uncounted():
    """Launches made inside the block left out of the kernels' counts
    (the counts are put back as they were on entry)."""
    from geomesa_tpu_torch.scan import kernels
    saved = dict(kernels.launches)
    try:
        yield
    finally:
        kernels.launches.update(saved)


def _one_shard(data, mesh):
    """``data``'s rows as one shard on ``mesh`` (one device): the
    shards' columns concatenated on the card, the host arrays shared."""
    from geomesa_tpu_torch.parallel import mesh as pmesh
    cols = tuple(torch.cat([c[j] for c in data.cols]) for j in range(6))
    return pmesh.DistributedScanData([cols], data.n, data.n_padded, mesh,
                                     data.host_x, data.host_y,
                                     data.host_millis, data.host_xhi,
                                     data.host_yhi)


def _raw_grid(data, q, bbox, width, height) -> torch.Tensor:
    """The density grid's brute force: the raw two-float verdict (the
    scan's plain version on every shard), the f32 point xhi + xlo binned
    by the plain binning, counted by bincount in int64."""
    from geomesa_tpu_torch.scan import kernels
    xmin, ymin, xmax, ymax = (float(v) for v in bbox)
    sx = width / (xmax - xmin)
    sy = height / (ymax - ymin)
    dev = data.mesh.devices[0]
    out = torch.zeros(width * height, dtype=torch.int64, device=dev)
    for cols in data.cols:
        b, t = q.tables(cols[0].device)
        m = kernels.scan_mask_plain(cols, cols[0].shape[0], b, t, q.time_any)
        cells = kernels.density_cells_plain(
            (cols[0] + cols[1])[m], (cols[2] + cols[3])[m],
            *(float(np.float32(v)) for v in (xmin, ymin, sx, sy)), width,
            height)
        out += torch.bincount(cells, minlength=width * height).to(dev)
    return out.view(height, width)


def _shard_ms(fn_shard, shards, fn_single, iters: int = 10) -> dict:
    """The kernel of one program launched on every shard (summed in one
    timed loop) beside its one launch at the same rows, held medians."""
    return {"shards_ms": cuda_ms(lambda: [fn_shard(s) for s in shards],
                                 iters),
            "single_ms": cuda_ms(fn_single, iters)}


def mesh_parallel(seed: int, rows: int):
    """Part A: parallel/ at --rows uniform points over data_mesh(8) (and
    the same rows as one shard), each program held to a float64 brute
    force on the card; then each program's kernel on the eight shards
    beside its one launch at the same rows, and the shard-shaped calls
    against their plain versions. Returns (line, wrong, launches)."""
    from geomesa_tpu_torch import parallel as par
    from geomesa_tpu_torch.geometry import parse_wkt
    from geomesa_tpu_torch.parallel import mesh as pmesh
    from geomesa_tpu_torch.scan import gscan, kernels, zscan
    from geomesa_tpu_torch.utils.fp import f32_band
    dev = torch.device("cuda")
    wrong, out = [], {"part": "parallel", "rows": rows,
                      "shards": MESH_SHARDS}
    rng = np.random.default_rng(seed)
    x = rng.uniform(-180, 180, rows)
    y = rng.uniform(-90, 90, rows)
    ms = rng.integers(0, 1000 * MS_DAY, rows)
    mesh8, mesh1 = par.data_mesh(MESH_SHARDS), par.data_mesh(1)
    t0 = time.perf_counter()
    d8 = par.shard_scan_data(x, y, ms, mesh8)
    torch.cuda.synchronize()
    out["shard_s"] = time.perf_counter() - t0
    d1 = _one_shard(d8, mesh1)
    data = {MESH_SHARDS: d8, 1: d1}
    out["device_bytes"] = d8.nbytes
    X, Y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    M = torch.from_numpy(ms).to(dev)

    def brute(boxes, ivs) -> torch.Tensor:
        hit = torch.zeros(rows, dtype=torch.bool, device=dev)
        for x0, y0, x1, y1 in boxes:
            hit |= (X >= x0) & (X <= x1) & (Y >= y0) & (Y <= y1)
        if ivs:
            t = torch.zeros_like(hit)
            for lo, hi in ivs:
                t |= (M >= lo) & (M <= hi)
            hit &= t
        return hit

    def rows_of(mask) -> np.ndarray:
        return torch.nonzero(mask).flatten().cpu().numpy()

    kernels.reset_launches()
    # the north star: hit rows and count on 8 shards and on 1
    q0 = zscan.make_query(*KERNEL_QUERIES[0])
    want0 = brute(*KERNEL_QUERIES[0])
    want_rows = rows_of(want0)
    p = {}
    for k, d in data.items():
        runs = MESH_RUNS if k == MESH_SHARDS else 1
        p[f"hit_rows_{k}"], got = _mesh_p50(
            lambda: par.exact_hit_rows(d, q0), runs)
        if not np.array_equal(got, want_rows):
            wrong.append(("exact_hit_rows", k))
        p[f"count_{k}"], n = _mesh_p50(
            lambda: par.distributed_count(d, q0), runs)
        if n != len(want_rows):
            wrong.append(("distributed_count", k, n, len(want_rows)))
    out["north_star_hits"] = len(want_rows)
    # the batched north star: 32 queries through the batched trio
    specs = kernel_batch_specs(seed)
    bq = zscan.stack_queries([zscan.make_query(*s) for s in specs])
    # (one call: its host patch of millions of hit rows a query leads;
    # the kernels' cost on 8 shards against 1 is timed below)
    p[f"batch_{MESH_SHARDS}"], got = _mesh_p50(
        lambda: pmesh.batch_exact_hit_rows(d8, bq), 1)
    bad = [i for i, (s, g) in enumerate(zip(specs, got))
           if not np.array_equal(g, rows_of(brute(*s)))]
    if bad:
        wrong.append(("batch_exact_hit_rows", bad[:4]))
    out["batch_queries"] = len(specs)
    # density: the north star's box, and the world over 100 days
    grids = []
    for qi, bbox, w, h in ((0, (-80.0, 30.0, -60.0, 45.0), 512, 384),
                           (3, (-180.0, -90.0, 180.0, 90.0), 1024, 512)):
        q = zscan.make_query(*KERNEL_QUERIES[qi])
        want = _raw_grid(d8, q, bbox, w, h)
        for k, d in data.items():
            p[f"density{qi}_{k}"], g = _mesh_p50(
                lambda: par.distributed_density(d, q, bbox, w, h))
            if not np.array_equal(g, want.cpu().numpy().astype(np.float32)):
                wrong.append(("distributed_density", qi, k))
        grids.append((q, bbox, w, h))
    # contains: config 5's rectangles
    wkts, _stars = contains_polygons(seed)
    npoly = MESH_POLYGONS
    out["polygons"] = npoly
    polys = [parse_wkt(w) for w in wkts[:npoly]]
    cnt = {}
    for k, d in data.items():
        t0 = time.perf_counter()
        cnt[k] = pmesh.distributed_contains_counts(d, polys)
        p[f"contains_first_{k}"] = (time.perf_counter() - t0) * 1e3
    p[f"contains_{MESH_SHARDS}"], again = _mesh_p50(
        lambda: pmesh.distributed_contains_counts(d8, polys), 2)
    if not np.array_equal(again, cnt[MESH_SHARDS]):
        wrong.append(("contains repeat",))
    if not np.array_equal(cnt[MESH_SHARDS], cnt[1]):
        wrong.append(("contains 8 != 1",))
    sample = np.random.default_rng(seed + 29).choice(
        npoly, min(MESH_CHECK, npoly), replace=False)
    bad = []
    for j in sample:
        env = polys[j].envelope    # a rectangle: its closed box
        n = int(((X >= env.xmin) & (X <= env.xmax) & (Y >= env.ymin)
                 & (Y <= env.ymax)).sum())
        if n != cnt[MESH_SHARDS][j]:
            bad.append(int(j))
    if bad:
        wrong.append(("contains counts", bad[:4]))
    out["contains_checked"] = len(sample)
    out["contains_total"] = int(cnt[MESH_SHARDS].sum())
    # knn at k = 10 through the shards' two-float columns
    for k, d in data.items():
        sp, valid, _n = d.knn_split()
        times = []
        for qx, qy in KNN_POINTS[:4]:
            t, got = _mesh_p50(lambda: par.distributed_knn(
                None, None, valid, d.mesh, rows, qx, qy, MESH_KNN_K,
                split=sp))
            times.append(t)
            d2 = (X - qx) ** 2 + (Y - qy) ** 2
            want = torch.sort(d2, stable=True).indices[:MESH_KNN_K]
            if not np.array_equal(got, want.cpu().numpy()):
                wrong.append(("distributed_knn", k, qx, qy))
        p[f"knn_{k}"] = statistics.median(times)
    # the ring's DWithin counts at 1M x 1M
    rr = np.random.default_rng(seed + 31)
    lx, ly, rx, ry = (rr.uniform(-180, 180, MESH_RING_ROWS) if i % 2 == 0
                      else rr.uniform(-90, 90, MESH_RING_ROWS)
                      for i in range(4))
    ring = {}
    for k, m in ((MESH_SHARDS, mesh8), (1, mesh1)):
        left, right = par.shard_points(lx, ly, m), par.shard_points(rx, ry, m)
        p[f"ring_{k}"], ring[k] = _mesh_p50(lambda: par.ring_dwithin_counts(
            *left[:3], *right[:3], m, DW_RADIUS))
    if not all(np.array_equal(a, b)
               for a, b in zip(ring[MESH_SHARDS], ring[1])):
        wrong.append(("ring 8 != 1",))
    sure, band = (a[:MESH_RING_ROWS] for a in ring[MESH_SHARDS])
    RX, RY = torch.from_numpy(rx).to(dev), torch.from_numpy(ry).to(dev)
    check = np.random.default_rng(seed + 37).choice(
        MESH_RING_ROWS, MESH_RING_CHECK, replace=False)
    exact = np.array([int((((RX - lx[i]) ** 2 + (RY - ly[i]) ** 2)
                           <= DW_RADIUS * DW_RADIUS).sum()) for i in check])
    ok = ((sure[check] <= exact) & (exact <= sure[check] + band[check])
          & ((band[check] > 0) | (exact == sure[check])))
    if not ok.all():
        wrong.append(("ring totals", int((~ok).sum())))
    out.update(ring_rows=MESH_RING_ROWS, ring_radius=DW_RADIUS,
               ring_sure=int(sure.sum()), ring_band_rows=int((band > 0).sum()),
               ring_checked=MESH_RING_CHECK)
    del RX, RY
    # the tristate on the kernels phase's extent boxes
    bounds, ems = extent_rows(seed, rows)
    t0 = time.perf_counter()
    ext = par.shard_extent_data(bounds, ems, mesh8)
    torch.cuda.synchronize()
    out["extent_shard_s"] = time.perf_counter() - t0
    del bounds, ems
    tri = []
    for qi, (boxes, ivs) in enumerate(EXTENT_KERNEL_QUERIES):
        eq = gscan.extent_query(boxes, ivs)
        t, got = _mesh_p50(lambda: par.distributed_tristate(ext, eq))
        o, i_, tt = eq.tables(dev)
        want = torch.cat([kernels.extent_tristate_plain(
            s.bounds, s.valid, s.times, o, i_, tt) for s in ext.shards])
        if not np.array_equal(got, want[:rows].cpu().numpy()):
            wrong.append(("distributed_tristate", qi))
        tri.append(t)
    p["tristate_8"] = statistics.median(tri)
    launches = {k: v for k, v in kernels.launches.items() if v}
    out["p50_ms"] = p

    # -- each program's kernel on the shards beside one launch, and the
    # shard-shaped calls against their plain versions (not counted) --
    ktime, plain = {}, {}
    b, t = q0.tables(dev)
    ta = q0.time_any
    per = d8.per
    one = d1.cols[0]
    ktime["scan_mask"] = _shard_ms(
        lambda c: kernels.scan_mask(c, per, b, t, ta), d8.cols,
        lambda: kernels.scan_mask(one, d1.n_padded, b, t, ta))
    ktime["scan_count"] = _shard_ms(
        lambda c: kernels.scan_count(c, per, b, t, ta), d8.cols,
        lambda: kernels.scan_count(one, d1.n_padded, b, t, ta))
    bb, bt = bq.tables(dev)
    bc = bq.counts(dev)
    ktime["scan_batch_bits"] = _shard_ms(
        lambda c: kernels.scan_batch_bits(c, per, bb, bt, bc), d8.cols,
        lambda: kernels.scan_batch_bits(one, d1.n_padded, bb, bt, bc), 5)
    bits8 = [kernels.scan_batch_bits(c, per, bb, bt, bc) for c in d8.cols]
    bits1 = kernels.scan_batch_bits(one, d1.n_padded, bb, bt, bc)
    ktime["compact_bits"] = _shard_ms(
        lambda bp: kernels.compact_bits(*bp), bits8,
        lambda: kernels.compact_bits(*bits1), 5)
    ktime["compact_prefix"] = _shard_ms(
        lambda bp: kernels.compact_prefix(bp[1]), bits8,
        lambda: kernels.compact_prefix(bits1[1]))
    q, bbox, w, h = grids[1]
    gb, gt = q.tables(dev)
    sc = [float(np.float32(v)) for v in (bbox[0], bbox[1],
                                         w / (bbox[2] - bbox[0]),
                                         h / (bbox[3] - bbox[1]))]
    pts8 = [(c[0] + c[1], c[2] + c[3],
             kernels.scan_mask(c, per, gb, gt, q.time_any)) for c in d8.cols]
    pts1 = (one[0] + one[1], one[2] + one[3],
            kernels.scan_mask(one, d1.n_padded, gb, gt, q.time_any))
    ktime["density_grid"] = _shard_ms(
        lambda s: kernels.density_grid(s[0], s[1], None, s[2], *sc, w, h),
        pts8, lambda: kernels.density_grid(pts1[0], pts1[1], None, pts1[2],
                                           *sc, w, h))
    eo, ei, et = gscan.extent_query(*EXTENT_KERNEL_QUERIES[0]).tables(dev)
    ecat = [torch.cat([getattr(s, f) for s in ext.shards])
            for f in ("bounds", "valid", "times")]
    ktime["extent_tristate"] = _shard_ms(
        lambda s: kernels.extent_tristate(s.bounds, s.valid, s.times, eo,
                                          ei, et), ext.shards,
        lambda: kernels.extent_tristate(*ecat, eo, ei, et))
    qx32 = torch.tensor([KNN_POINTS[0][0]], dtype=torch.float32, device=dev)
    qy32 = torch.tensor([KNN_POINTS[0][1]], dtype=torch.float32, device=dev)
    fetch = 2 * MESH_KNN_K + 16
    ktime["knn_topk"] = _shard_ms(
        lambda c: kernels.knn_topk(c[0], c[2], qx32, qy32, fetch, per),
        d8.cols,
        lambda: kernels.knn_topk(one[0], one[2], qx32, qy32, fetch, rows))
    r2_hi, r2_lo = (float(np.float32(v)) for v in f32_band(DW_RADIUS, 360.0))
    left8, right8 = par.shard_points(lx, ly, mesh8), par.shard_points(rx, ry,
                                                                      mesh8)
    xs8 = [kernels.sorted_by_x(px, py, px.shape[0])
           for px, py in zip(right8[0], right8[1])]
    blocks = [(qx, qy, px, py, xs) for qx, qy in zip(left8[0], left8[1])
              for px, py, xs in zip(right8[0], right8[1], xs8)]
    L = par.shard_points(lx, ly, mesh1)
    R = par.shard_points(rx, ry, mesh1)
    xs1 = kernels.sorted_by_x(R[0][0], R[1][0], MESH_RING_ROWS)
    ktime["dwithin_counts"] = _shard_ms(
        lambda bk: kernels.dwithin_counts(bk[2], bk[3], bk[0], bk[1], r2_hi,
                                          r2_lo, bk[2].shape[0],
                                          xsorted=bk[4]), blocks,
        lambda: kernels.dwithin_counts(R[0][0], R[1][0], L[0][0], L[1][0],
                                       r2_hi, r2_lo, MESH_RING_ROWS,
                                       xsorted=xs1), 3)
    ktime["dwithin_counts"]["blocks"] = len(blocks)
    # contains_counts: each shard's tables as distributed_contains_counts
    # builds them, against the same over the one shard's sort
    from geomesa_tpu_torch.analytics.join import (_contains_slab_setup,
                                                  _poly_pad,
                                                  pack_polygon_batch)
    from geomesa_tpu_torch.scan.gscan import EDGE_EPS, EDGE_EPS2
    kp = _poly_pad(npoly)
    edges, evalid, pboxes = pack_polygon_batch(polys, pad_to=kp)
    boxes64 = np.array([pp.envelope.as_tuple() for pp in polys], np.float64)
    ecount = torch.from_numpy(evalid.sum(axis=1).astype(np.int32)).to(dev)
    edges_t, pboxes_t = (torch.from_numpy(a).to(dev) for a in (edges, pboxes))
    eps = float(np.float32(EDGE_EPS))

    def ctables(xs_ord):
        xs, ys, order = xs_ord
        _, _, los, widths = _contains_slab_setup(xs, boxes64)
        lp, wp = np.zeros(kp, np.int32), np.zeros(kp, np.int32)
        lp[:npoly], wp[:npoly] = los, widths
        return (xs, ys, order, torch.from_numpy(lp).to(dev),
                torch.from_numpy(wp).to(dev), pboxes_t, edges_t, ecount)
    ct8 = [ctables(s) for s in pmesh._xsorted(d8)]
    ct1 = ctables(pmesh._xsorted(d1)[0])
    ktime["contains_counts"] = _shard_ms(
        lambda tb: kernels.contains_counts(*tb, eps, EDGE_EPS2, 512), ct8,
        lambda: kernels.contains_counts(*ct1, eps, EDGE_EPS2, 512), 3)
    # the shard-shaped calls against their plain versions (exact)
    c0 = d8.cols[0]
    s0 = ext.shards[0]
    checks = {
        "scan_mask": (lambda: kernels.scan_mask(c0, per, b, t, ta),
                      lambda: kernels.scan_mask_plain(c0, per, b, t, ta)),
        "scan_count": (lambda: kernels.scan_count(c0, per, b, t, ta),
                       lambda: kernels.scan_count_plain(c0, per, b, t, ta)),
        "density_grid": (
            lambda: kernels.density_grid(*pts8[0][:2], None, pts8[0][2], *sc,
                                         w, h),
            lambda: kernels.density_grid_plain(*pts8[0][:2], None,
                                               pts8[0][2], *sc, w, h)),
        "extent_tristate": (
            lambda: kernels.extent_tristate(s0.bounds, s0.valid, s0.times,
                                            eo, ei, et),
            lambda: kernels.extent_tristate_plain(s0.bounds, s0.valid,
                                                  s0.times, eo, ei, et)),
        "knn_topk": (
            lambda: kernels.knn_topk(c0[0], c0[2], qx32, qy32, fetch, per),
            lambda: kernels.knn_topk_plain(c0[0], c0[2], qx32, qy32, fetch,
                                           per)),
        "dwithin_counts": (
            lambda: kernels.dwithin_counts(*blocks[9][2:4], *blocks[9][:2],
                                           r2_hi, r2_lo,
                                           blocks[9][2].shape[0],
                                           xsorted=blocks[9][4]),
            lambda: kernels.dwithin_counts_plain(*blocks[9][2:4],
                                                 *blocks[9][:2], r2_hi,
                                                 r2_lo,
                                                 blocks[9][2].shape[0])),
        "scan_batch_bits": (
            lambda: bits8[0],
            lambda: kernels.scan_batch_bits_plain(c0, per, bb, bt, bc)),
        "compact_prefix": (
            lambda: kernels.compact_prefix(bits8[0][1]),
            lambda: kernels.compact_prefix_plain(bits8[0][1])),
        "compact_bits": (
            lambda: kernels.compact_bits(*bits8[0]),
            lambda: kernels.compact_bits_plain(*bits8[0])),
        "contains_counts": (
            lambda: kernels.contains_counts(*ct8[0], eps, EDGE_EPS2, 512),
            lambda: kernels.contains_counts_plain(*ct8[0], eps, EDGE_EPS2,
                                                  512)),
    }
    for name, (kern, pl) in checks.items():
        got, want = kern(), pl()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        plain[name] = len(got) == len(want) and all(
            np.array_equal(g, v) if isinstance(g, np.ndarray)
            else torch.equal(g, v) for g, v in zip(got, want))
        if not plain[name]:
            wrong.append(("plain", name))
    out.update(kernel_ms=ktime, plain_equal=plain)
    del d8, d1, data, X, Y, M, ext, ecat, pts8, pts1, bits8, bits1, ct8, ct1
    torch.cuda.empty_cache()
    return out, wrong, launches


def mesh_store_part(seed: int, ds, rows):
    """Part B: DistributedDataStore(data_mesh(8)) and a one-shard twin on
    the store phase's rows, each call held against the single CUDA store
    ``ds`` on the same rows (density as in part A, KNN and the histogram
    against a float64 / float32 brute force), p50s beside ``ds``'s. The
    launches are the mesh stores' only: ``ds``'s calls run uncounted.
    Returns (line, wrong, launches)."""
    from geomesa_tpu_torch import DistributedDataStore, Query
    from geomesa_tpu_torch.arrow.io import FeatureArrowFileReader
    from geomesa_tpu_torch.parallel import data_mesh
    from geomesa_tpu_torch.scan import kernels, zscan
    from geomesa_tpu_torch.utils.properties import SystemProperty
    host_rows = SystemProperty("geomesa.scan.host.rows")
    threshold = SystemProperty("geomesa.scan.index.threshold")
    x, y, ms, ids = rows
    n = len(x)
    wrong, out = [], {"part": "store", "rows": n}
    spec = "dtg:Date,*geom:Point:srid=4326"
    kernels.reset_launches()
    stores, write_s = {}, {}
    for k in (MESH_SHARDS, 1):
        t0 = time.perf_counter()
        s = DistributedDataStore(data_mesh(k))
        s.create_schema("ais", spec)
        s.write_dict("ais", ids, {"dtg": ms, "geom": (x, y)})
        torch.cuda.synchronize()
        write_s[k] = time.perf_counter() - t0
        stores[k] = s
    out["write_s"] = write_s
    p, tiers = {}, {}
    for ecql, boxes, iv in (STORE_QUERIES[0], STORE_QUERIES[2]):
        want = _brute(x, y, ms, boxes, iv)
        tag = "north" if iv else "wide"
        for tier, (h, thr) in (("default", (None, None)),
                               ("dense", ("0", "0"))):
            host_rows.set(h)
            threshold.set(thr)
            try:
                for k, s in stores.items():
                    res = s.query(ecql, "ais")
                    tiers[f"{tag}_{tier}_{k}"] = res.explain.text.split(
                        "\n")[-2:]
                    if not np.array_equal(res.ids, ids[want]):
                        wrong.append(("query", tag, tier, k))
                    p[f"{tag}_{tier}_{k}"], _ = _mesh_p50(
                        lambda: s.query(ecql, "ais").ids)
                    p[f"{tag}_{tier}_count_{k}"], c = _mesh_p50(
                        lambda: s.query_count(ecql, "ais"))
                    if c != len(want):
                        wrong.append(("query_count", tag, tier, k, c))
                with _uncounted():
                    p[f"{tag}_{tier}_single"], got = _mesh_p50(
                        lambda: ds.query(ecql, "ais").ids)
                if not np.array_equal(got, ids[want]):
                    wrong.append(("single store", tag, tier))
            finally:
                host_rows.set(None)
                threshold.set(None)
    out["explain"] = tiers
    # density of the north star over the world, held as in part A
    ecql, boxes, iv = STORE_QUERIES[0]
    bbox, w, h = (-180.0, -90.0, 180.0, 90.0), 720, 360
    sq = zscan.make_query(boxes, [(iv[0] + 1, iv[1] - 1)])
    want = sum(_raw_grid(seg, sq, bbox, w, h)
               for seg in stores[MESH_SHARDS]._state("ais").segments)
    for k, s in stores.items():
        s.invalidate_cache("ais")
        p[f"density_{k}"], g = _mesh_p50(lambda: (
            s.invalidate_cache("ais"), s.density("ais", ecql, bbox, w, h))[1])
        if not np.array_equal(g, want.cpu().numpy().astype(np.float32)):
            wrong.append(("density", k))
    with _uncounted():
        ds.invalidate_cache("ais")
        p["density_single"], g1 = _mesh_p50(lambda: (
            ds.invalidate_cache("ais"),
            ds.density("ais", ecql, bbox, w, h))[1])
    out["density_cells_differing_from_single"] = int((g1 != g).sum())
    # knn, the histogram, Arrow and query_batched
    knn_want = []
    for qx, qy in KNN_POINTS[:4]:
        # the f64 top k in (d2, row) order: every row within the k-th
        # smallest d2, then a stable sort of those
        d2 = (x - qx) ** 2 + (y - qy) ** 2
        cand = np.flatnonzero(d2 <= np.partition(d2, MESH_KNN_K - 1)
                              [MESH_KNN_K - 1])
        knn_want.append(ids[cand[np.argsort(d2[cand],
                                            kind="stable")][:MESH_KNN_K]])
    for k, s in stores.items():
        times = []
        for (qx, qy), want_k in zip(KNN_POINTS[:4], knn_want):
            t, got = _mesh_p50(lambda: s.knn("ais", qx, qy, MESH_KNN_K))
            times.append(t)
            if not np.array_equal(got, want_k):
                wrong.append(("knn", k, qx, qy))
        p[f"knn_{k}"] = statistics.median(times)
    lo, hi, nb = float(T0_DAY * MS_DAY), float(T1_DAY * MS_DAY), 100
    v32 = ms.astype(np.float32)
    keep = (v32 >= np.float32(lo)) & (v32 <= np.float32(hi))
    binned = ((v32[keep] - np.float32(lo))
              * np.float32(nb / (hi - lo))).astype(np.int64)
    want_h = np.bincount(np.clip(binned, 0, nb - 1), minlength=nb)
    for k, s in stores.items():
        p[f"histogram_{k}"], got = _mesh_p50(
            lambda: s.histogram("ais", "dtg", nb, lo, hi))
        if not np.array_equal(got, want_h):
            wrong.append(("histogram", k))
    want = _brute(x, y, ms, boxes, iv)
    for k, s in stores.items():
        s.invalidate_cache("ais")
        p[f"arrow_{k}"], payload = _mesh_p50(lambda: (
            s.invalidate_cache("ais"), s.arrow_ipc("ais", ecql))[1])
        batch = FeatureArrowFileReader(payload, s.get_schema("ais")).read_all()
        col = batch.col("geom")
        if not (np.array_equal(batch.ids, ids[want])
                and np.array_equal(batch.col("dtg").millis, ms[want])
                and np.array_equal(col.x, x[want])
                and np.array_equal(col.y, y[want])):
            wrong.append(("arrow_ipc", k))
    qs = [Query("ais", _ecql(b, i)) for b, i in store_batch_specs(seed)]
    with _uncounted():
        ds.invalidate_cache("ais")
        p["arrow_single"], _ = _mesh_p50(lambda: (
            ds.invalidate_cache("ais"), ds.arrow_ipc("ais", ecql))[1])
        p["batched_single"], want_b = _mesh_p50(lambda: ds.query_batched(qs))
    want_b = [list(r.ids) for r in want_b]
    for k, s in stores.items():
        p[f"batched_{k}"], got = _mesh_p50(lambda: s.query_batched(qs))
        if [list(r.ids) for r in got] != want_b:
            wrong.append(("query_batched", k))
    launches = {k: v for k, v in kernels.launches.items() if v}
    out["p50_ms"] = p
    del stores
    torch.cuda.empty_cache()
    return out, wrong, launches


def mesh_fs_part(rows):
    """Part C: FsBackedDistributedDataStore at MESH_FS_ROWS of the store
    phase's rows: write, the north star (the brute force's ids, in the
    partition-grouped row order), persist_index, reopen (the sidecar
    adopted: no z-key sort), the north star again, its ids identical.
    Returns (line, wrong, launches)."""
    import tempfile

    from geomesa_tpu_torch import FsBackedDistributedDataStore
    from geomesa_tpu_torch.index import zkeys
    from geomesa_tpu_torch.parallel import data_mesh
    from geomesa_tpu_torch.scan import kernels
    x, y, ms, ids = (a[:MESH_FS_ROWS] for a in rows)
    ecql, boxes, iv = STORE_QUERIES[0]
    want = ids[_brute(x, y, ms, boxes, iv)]
    wrong, out = [], {"part": "fs", "rows": len(x)}
    root = tempfile.mkdtemp(prefix="geomesa-fsmesh-")
    sorts = {"n": 0}
    real = (zkeys.sort_bin_z, zkeys.sort_z)

    def counted(fn):
        def run(*a, **k):
            sorts["n"] += 1
            return fn(*a, **k)
        return run
    kernels.reset_launches()
    try:
        t0 = time.perf_counter()
        fsm = FsBackedDistributedDataStore(root, data_mesh(MESH_SHARDS))
        fsm.create_schema("ais", "dtg:Date,*geom:Point:srid=4326")
        fsm.write_dict("ais", ids, {"dtg": ms, "geom": (x, y)})
        out["write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        first = fsm.query(ecql, "ais").ids
        out["first_query_s"] = time.perf_counter() - t0
        # rows serve grouped by partition, so the ids come in that order
        if not np.array_equal(np.sort(first.astype(str)),
                              np.sort(want.astype(str))):
            wrong.append(("fs-mesh query",))
        t0 = time.perf_counter()
        persisted = fsm.persist_index("ais")
        out["persist_s"] = time.perf_counter() - t0
        out["partitions"] = len(fsm.partitions("ais"))
        shards = fsm.partition_shards("ais")
        out["shards_served"] = len(set().union(*shards.values()))
        del fsm
        zkeys.sort_bin_z, zkeys.sort_z = (counted(f) for f in real)
        t0 = time.perf_counter()
        re = FsBackedDistributedDataStore(root, data_mesh(MESH_SHARDS))
        torch.cuda.synchronize()
        out["reopen_s"] = time.perf_counter() - t0
        adopted = re._state("ais").zindex_warm is not None
        t0 = time.perf_counter()
        got = re.query(ecql, "ais").ids
        out["reopen_query_s"] = time.perf_counter() - t0
        same = bool(np.array_equal(got, first))
        out.update(persisted=persisted, sidecar_adopted=adopted,
                   zkey_sorts_after_reopen=sorts["n"],
                   hits=len(want), ids_identical=same)
        if not (persisted and adopted and sorts["n"] == 0 and same):
            wrong.append(("reopen", persisted, adopted, sorts["n"]))
        del re
    finally:
        zkeys.sort_bin_z, zkeys.sort_z = real
        shutil.rmtree(root, ignore_errors=True)
    launches = {k: v for k, v in kernels.launches.items() if v}
    torch.cuda.empty_cache()
    return out, wrong, launches


def phase_mesh(seed: int, rows: int, ds, store_rows) -> tuple[dict, float]:
    """parallel/, DistributedDataStore and FsBackedDistributedDataStore on
    the card (see the module's head): parts A (``parallel``), B
    (``store``) and C (``fs``), one line each with its launches and
    device memory before and after, then the phase's total beside
    MESH_BUDGET_S. Gates: every part's answers, and every kernel of
    MESH_KERNELS launched on the mesh's shards. Returns the parts'
    launches and the phase's seconds."""
    t_phase = time.perf_counter()
    counts, wrong = {}, []
    for name, part in (("parallel", lambda: mesh_parallel(seed, rows)),
                       ("store", lambda: mesh_store_part(seed, ds, store_rows)),
                       ("fs", lambda: mesh_fs_part(store_rows))):
        mem0 = _mem()
        t0 = time.perf_counter()
        out, w, launches = part()
        out.update(seconds=time.perf_counter() - t0, launches=launches,
                   memory_allocated_before=mem0,
                   memory_allocated_after=_mem(), wrong=w,
                   card=card_line())
        emit({"phase": "mesh", **out})
        for k, v in launches.items():
            counts[k] = counts.get(k, 0) + v
        wrong += [(name, x) for x in w]
    missing = [k for k in MESH_KERNELS if not counts.get(k)]
    if missing:
        wrong.append(("kernels never launched on the mesh", missing))
    seconds = time.perf_counter() - t_phase
    emit({"phase": "mesh", "part": "total", "seconds": seconds,
          "budget_s": MESH_BUDGET_S, "launches": counts,
          "wrong": wrong[:8], "card": card_line()})
    if wrong:
        raise SystemExit(f"mesh: {wrong[:8]}")
    return counts, seconds


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=100_000_000)
    ap.add_argument("--store-rows", type=int, default=10_000_000)
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    phase_build()
    stats = phase_kernels(args.seed, args.rows)
    launches, ds, rows = phase_store(args.seed, args.store_rows,
                                     stats["scan_mask_gather"])
    phase_native(ds, rows)
    phase_versions(ds, rows)
    launches["tube_mask"] = phase_tube(args.seed, ds, rows)
    durable = phase_durable(args.seed, args.store_rows)
    for name in ("scan_mask", "scan_mask_gather", "scan_count"):
        launches[name] += durable[name]
    fs_launches, fs_summary = phase_fs(args.seed, args.store_rows)
    conv_launches, _ = phase_convert(args.seed,
                                     FS_BUDGET_S - fs_summary["seconds"])
    for name in ("scan_mask", "scan_mask_gather", "scan_count"):
        launches[name] += fs_launches[name] + conv_launches[name]
    standing, fence_launches, fence_s = phase_geofence(args.seed)
    stream_launches, _ = phase_stream(args.seed, STREAM_BUDGET_S - fence_s)
    for name in ("scan_mask", "scan_mask_gather", "scan_count"):
        launches[name] += stream_launches[name]
    for name in STANDING_KERNELS:
        launches[name] = fence_launches[name] + stream_launches[name]
    batched = phase_batched(args.seed, ds, rows)
    serving = phase_serving(args.seed, ds, rows)
    for name in ("scan_batch_bits", "compact_prefix", "compact_bits"):
        launches[name] = (batched[name] + serving[name]
                          + fence_launches[name] + stream_launches[name])
    join_stats, join_launches, dw = phase_analytics(args.seed, ds, rows)
    launches.update(join_launches)
    sql_ais, sql_launches = phase_sql_ais(ds, rows, dw)
    web_launches = phase_web(args.seed, ds, rows, dw)
    cluster_launches, cluster_s = phase_cluster(args.seed, ds, rows)
    life_launches, _ = phase_lifecycle(args.seed, ds, rows)
    mesh_launches, _ = phase_mesh(args.seed, args.rows, ds, rows)
    del ds
    torch.cuda.empty_cache()
    pred_stats, pred_counts, pred_ds, pred_data, pred_queries, pred_q = \
        phase_predicates(args.seed, args.store_rows, rows[3])
    launches.update(pred_counts)
    launches["residual_mask"] += (fs_launches["residual_mask"]
                                  + conv_launches["residual_mask"])
    phase_stats(pred_ds, pred_data, rows[3], pred_queries, pred_q)
    sql_gdelt, gdelt_launches = phase_sql_gdelt(args.seed, pred_ds,
                                                pred_data, rows[3])
    for name, n in sql_gdelt["sql19_launches"].items():
        cluster_launches[name] += n
    emit({"phase": "cluster", "part": "total",
          "seconds": cluster_s + sql_gdelt["sql19_seconds"],
          "budget_s": CLUSTER_BUDGET_S, "launches": cluster_launches,
          "card": card_line()})
    sql_s = sql_ais["seconds"] + sql_gdelt["seconds"]
    emit({"phase": "sql", "seconds": sql_s, "budget_s": SQL_BUDGET_S,
          "card": card_line()})
    for name in SQL_KERNELS:
        launches[name] += sql_launches[name] + gdelt_launches[name]
    surf_stats, surf_counts = phase_surface(pred_ds, pred_data, rows[3],
                                            pred_queries)
    launches.update(surf_counts)
    pred_stats.update(surf_stats)
    del pred_ds
    torch.cuda.empty_cache()
    phase_plain(pred_data, rows[3])
    del pred_data
    _, launches["extent_tristate"] = phase_extent(args.seed)
    torch.cuda.empty_cache()
    cache_launches, _ = phase_cache(args.seed, args.store_rows)
    launches["density_grid"] += cache_launches["density_grid"]
    ingest_launches, _ = phase_ingest(args.seed)
    for name in ("scan_mask", "scan_mask_gather", "scan_count"):
        launches[name] += ingest_launches[name]
    for name, n in web_launches.items():
        launches[name] += n
    for name in ("scan_mask", "scan_mask_gather", "scan_count",
                 "density_grid"):     # sql19's are in the sql counts
        launches[name] += cluster_launches[name] - \
            sql_gdelt["sql19_launches"].get(name, 0)
    for name, n in (*life_launches.items(), *mesh_launches.items()):
        if name in launches:
            launches[name] += n
    summary = []
    for name, s in stats.items():
        q0 = s["per_query"][0]   # the BBOX+time query (1M random ids
                                 # for the gathered kernel, L2 cold; the
                                 # extent tristate on --rows boxes); the
                                 # batch of 32 for the batched kernels
        summary.append({
            "name": name, "route": "cuda",
            "source": SOURCE_FILES.get(name,
                                       "geomesa_tpu_torch/csrc/scan.cu"),
            "replaces": SOURCES[name], "launches": launches[name],
            "max_abs_err": s["max_abs_err"], "ms": q0["ms"],
            "plain_ms": q0["plain_ms"], "bound_ms": q0["bound_ms"],
            "bound_by": q0["bound_by"],
            "library_ms": q0.get("library_ms")})
    for name, s in pred_stats.items():   # at the predicates and surface
                                         # paths' shapes
        summary.append({
            "name": name, "route": "cuda", "source": SOURCE_FILES[name],
            "replaces": SOURCES[name], "launches": launches[name],
            **{k: s[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")}})
    for name, s in join_stats.items():   # at the analytics phase's shapes
        summary.append({
            "name": name, "route": "cuda", "source": SOURCE_FILES[name],
            "replaces": SOURCES[name], "launches": launches[name],
            **{k: s[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")}})
    for name in STANDING_KERNELS:        # at the geofence bulk's shapes
        summary.append({
            "name": name, "route": "cuda", "source": SOURCE_FILES[name],
            "replaces": SOURCES[name], "launches": launches[name],
            **{k: standing["kernels"][name][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}})
    runtime = runtime_summary()
    emit({"phase": "runtime", "domains": runtime})
    quiet = [d for d, v in runtime.items()
             if not v["misses"] + v["hits"] + v["dispatches"]]
    if quiet:
        raise SystemExit(f"runtime plane heard nothing from {quiet}")
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(card_line(), flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
