"""Feature model: schemas (SimpleFeatureType + spec parser) and
columnar host batches."""

from .sft import AttributeSpec, AttributeType, Configs, SimpleFeatureType, parse_spec
from .batch import (BoolColumn, Column, DateColumn, FeatureBatch,
                    NumericColumn, PointColumn, StringColumn)

__all__ = ["AttributeSpec", "AttributeType", "Configs", "SimpleFeatureType",
           "parse_spec", "BoolColumn", "Column", "DateColumn", "FeatureBatch",
           "NumericColumn", "PointColumn", "StringColumn"]
