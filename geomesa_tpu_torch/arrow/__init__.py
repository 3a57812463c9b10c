"""Arrow columnar interchange (geomesa-arrow analog), on the host.

Arrow is the interchange format between the store and external
consumers: query results stream out as dictionary-encoded IPC batches
(SimpleFeatureVector.scala:35 semantics), partial results merge with
dictionary deltas (io/DeltaWriter.scala:47,203), and Arrow files are
directly queryable (ArrowDataStore). Every module imports pyarrow inside
the functions that need it, so importing this package does not.
"""

from .io import (DEFAULT_BATCH_SIZE, FeatureArrowFileReader,
                 FeatureArrowFileWriter, merge_sorted_ipc, read_ipc_batches,
                 sort_batches, write_ipc)
from .scan import ArrowScan, merge_deltas
from .data import ArrowDataStore
from .feature import ArrowFeature
from .vector import (ArrowAttributeReader, ArrowAttributeWriter,
                     ArrowDictionary, SimpleFeatureVector)

__all__ = ["DEFAULT_BATCH_SIZE", "FeatureArrowFileWriter",
           "FeatureArrowFileReader", "write_ipc", "read_ipc_batches",
           "sort_batches", "merge_sorted_ipc", "ArrowScan", "merge_deltas",
           "ArrowDataStore", "ArrowFeature", "SimpleFeatureVector",
           "ArrowDictionary", "ArrowAttributeReader",
           "ArrowAttributeWriter"]
