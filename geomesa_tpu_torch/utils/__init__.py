"""Host utilities of the port: configuration flags, device selection,
the metadata catalog, schema locks, query timeout management, age-off
and the version check."""

from .device import resolve_device
from .locking import FileLock, LocalLock, with_lock
from .metadata import FileMetadata, InMemoryMetadata, MetadataCatalog
from .properties import SystemProperty
from .threads import ManagedQuery, QueryTimeout, ThreadManagement

__all__ = ["FileLock", "FileMetadata", "InMemoryMetadata", "LocalLock",
           "ManagedQuery", "MetadataCatalog", "QueryTimeout",
           "SystemProperty", "ThreadManagement", "resolve_device",
           "with_lock"]
