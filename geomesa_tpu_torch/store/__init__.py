"""Datastores of the port: the in-memory store with its scan on the GPU,
the file store (partitioned Parquet, loaded into in-memory stores on
the card) with its partition schemes, and the streaming tiers: the live
store over a message bus (in-process, file or socket), the stream store
fed by a converter, and the lambda store (a live tier over a persistent
one). Continuous queries (``store/continuous.py``) publish what
standing filters match on the card. ``RemoteDataStore``
(``store/remote.py``) is the client of a ``GeoMesaWebServer``.
``DistributedDataStore`` (``store/mesh_store.py``) shards its device
tier over a mesh of torch devices, and ``FsBackedDistributedDataStore``
(``store/fs_mesh.py``) serves a file-store root from such a mesh."""

from .api import DataStore
from .memory import InMemoryDataStore, QueryResult
from .fs import FileSystemDataStore
from .live import GeoMessage, LiveDataStore, MessageBus
from .filebus import FileBus
from .socketbus import SocketBroker, SocketBus
from .lambda_store import LambdaDataStore
from .mesh_store import DistributedDataStore
from .fs_mesh import FsBackedDistributedDataStore
from .remote import RemoteDataStore
from .stream import (FileTailSource, IterableSource, StreamDataStore,
                     StreamSource)
from .partitions import (AttributeScheme, CompositeScheme, DateTimeScheme,
                         PartitionScheme, Z2Scheme, scheme_from_config)

__all__ = ["DataStore", "InMemoryDataStore", "QueryResult",
           "FileSystemDataStore",
           "DistributedDataStore", "FsBackedDistributedDataStore",
           "RemoteDataStore",
           "GeoMessage", "LiveDataStore", "MessageBus", "LambdaDataStore",
           "FileBus", "SocketBroker", "SocketBus",
           "StreamSource", "StreamDataStore", "FileTailSource",
           "IterableSource",
           "AttributeScheme", "CompositeScheme", "DateTimeScheme",
           "PartitionScheme", "Z2Scheme", "scheme_from_config"]
