"""geomesa-tpu's PyTorch/CUDA port for NVIDIA Hopper (H100).

A package of its own beside ``geomesa_tpu`` (the JAX reference), with
the same module layout. It imports torch and numpy, never jax and
nothing of ``geomesa_tpu``. The kernels are hand-written CUDA
(``csrc/*.cu``: the scans, the batched scan, point-in-polygon, the
attribute residual, the density grid, the extent tristate, the joins
and KNN of ``analytics/``, the tube and the standing filters of
``scan/standing.py``), built at first use. The stats
(``stats/``) and the Arrow encoding (``arrow/``, pyarrow imported only
when an Arrow entry point is called) run on the host.

Entry points run on the CUDA card unless the caller passes another
device: ``InMemoryDataStore()`` is ``InMemoryDataStore(device="cuda")``.
``FileSystemDataStore(root)`` keeps features as partitioned Parquet
under ``root`` and answers each query from an in-memory store it loads
on the card (``store/fs.py``); the converters of ``convert/`` turn
delimited text, JSON, XML, fixed-width, Avro, shapefile, JDBC and OSM
records into feature batches. The streaming tiers keep a live picture
on the card: ``LiveDataStore`` applies the creates, deletes and clears
of a message bus (``MessageBus`` in process, ``FileBus`` over a shared
directory, ``SocketBus`` against a ``SocketBroker`` over TCP) as
upserts, ``StreamDataStore`` feeds one from a converter over a tailed
file or an iterable, and ``LambdaDataStore`` moves aged rows into a
persistent store and answers the union. A ``ContinuousQueryPublisher``
matches every create batch against its standing filters on the card
and publishes the matches per query (``store/continuous.py``).
``SqlEngine(store).query(text)`` answers a SELECT over a store's types
(``sql/``): WHERE pushes down into the store's planner and scan kernels,
spatial joins run on the join kernels, and GROUP BY, HAVING and the
aggregates reduce on the host. ``geohash/`` holds the geohash encoding
and the spiral that ``knn_spiral_process`` walks. A store's density,
stats, BIN and Arrow pushdowns are memoized at the type's version (the
WAL LSN when durable) by ``cache/``'s ``ResultCache``, kept warm under
writes by its ``CacheRefresher``; ``ingest/``'s ``IngestPipeline``
group-commits staged batches through one writer thread; ``resilience/``
holds the retry policy, circuit breakers, hedging and a fault-injecting
TCP proxy; ``api/``'s ``GeoMesaIndex`` stores serialized values by
point and time. ``DistributedDataStore`` shards the scan columns over a
mesh of torch devices (``parallel/``: several shards on one card, each
shard's work on the same kernels, the reduces in shard order), and
``FsBackedDistributedDataStore`` serves a file-store root from one.
"""

# equal to the JAX package's: the file store stamps it into each type's
# metadata.json and refuses a major skew on open, so an equal value lets
# a root written by either package open in the other without a warning
__version__ = "0.2.0"

from .features import FeatureBatch, SimpleFeatureType, parse_spec  # noqa: E402
from .index import Query  # noqa: E402
from .store import (DataStore, DistributedDataStore,  # noqa: E402
                    FileBus, FileSystemDataStore, FileTailSource,
                    FsBackedDistributedDataStore, GeoMessage,
                    InMemoryDataStore,
                    IterableSource, LambdaDataStore, LiveDataStore,
                    MessageBus, QueryResult, SocketBroker, SocketBus,
                    StreamDataStore, StreamSource)
from .store.continuous import (ContinuousQueryPublisher,  # noqa: E402
                               ContinuousQuerySubscriber)
from .sql import SqlEngine, SqlError, SqlResult, parse_sql  # noqa: E402

__all__ = ["ContinuousQueryPublisher", "ContinuousQuerySubscriber",
           "DataStore", "DistributedDataStore", "FeatureBatch", "FileBus",
           "FileSystemDataStore", "FileTailSource",
           "FsBackedDistributedDataStore", "GeoMessage", "InMemoryDataStore",
           "IterableSource", "LambdaDataStore", "LiveDataStore",
           "MessageBus", "Query", "QueryResult", "SimpleFeatureType",
           "SocketBroker", "SocketBus", "SqlEngine", "SqlError", "SqlResult",
           "StreamDataStore", "StreamSource", "parse_spec", "parse_sql",
           "__version__"]
