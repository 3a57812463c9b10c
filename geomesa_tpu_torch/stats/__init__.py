"""Statistical sketches and the stats-based selectivity estimator
(geomesa-utils stats package and geomesa-index-api stats), on the host."""

from .sketches import (CountStat, DescriptiveStats, EnumerationStat,
                       Frequency, GroupBy, Histogram, MinMax, SeqStat,
                       Stat, TopK, Z3Frequency, Z3Histogram, parse_stat)
from .estimator import DataStoreStats, StatsEstimator
from .serialize import deserialize_stat, serialize_stat

__all__ = ["CountStat", "DescriptiveStats", "EnumerationStat", "Frequency",
           "GroupBy", "Histogram", "MinMax", "SeqStat", "Stat", "TopK",
           "Z3Frequency", "Z3Histogram", "parse_stat", "DataStoreStats",
           "StatsEstimator", "serialize_stat", "deserialize_stat"]
