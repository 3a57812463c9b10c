"""geomesa-tpu's PyTorch/CUDA port for NVIDIA Hopper (H100).

A package of its own beside ``geomesa_tpu`` (the JAX reference), with
the same module layout. It imports torch and numpy, never jax and
nothing of ``geomesa_tpu``. The kernels are hand-written CUDA
(``csrc/*.cu``: the scans, the batched scan, point-in-polygon, the
attribute residual, the density grid, the extent tristate and the joins
and KNN of ``analytics/``), built at first use. The stats
(``stats/``) and the Arrow encoding (``arrow/``, pyarrow imported only
when an Arrow entry point is called) run on the host.

Entry points run on the CUDA card unless the caller passes another
device: ``InMemoryDataStore()`` is ``InMemoryDataStore(device="cuda")``.
"""

from .features import FeatureBatch, SimpleFeatureType, parse_spec
from .index import Query
from .store import DataStore, InMemoryDataStore, QueryResult

__all__ = ["DataStore", "FeatureBatch", "InMemoryDataStore", "Query",
           "QueryResult", "SimpleFeatureType", "parse_spec"]
