"""Datastores of the port: the in-memory store with its scan on the GPU,
and the file store (partitioned Parquet, loaded into in-memory stores on
the card) with its partition schemes."""

from .api import DataStore
from .fs import FileSystemDataStore
from .memory import InMemoryDataStore, QueryResult
from .partitions import (AttributeScheme, CompositeScheme, DateTimeScheme,
                         PartitionScheme, Z2Scheme, scheme_from_config)

__all__ = ["AttributeScheme", "CompositeScheme", "DataStore",
           "DateTimeScheme", "FileSystemDataStore", "InMemoryDataStore",
           "PartitionScheme", "QueryResult", "Z2Scheme",
           "scheme_from_config"]
