"""Ingest converters (the geomesa-convert analog): raw records ->
FeatureBatch through a converter config of transform expressions.
Delimited text and JSON (``converter``, with the columnar path of
``vectorized``), XML, fixed width, composite and Avro (``formats``,
``avro_reader``, ``avro_writer``), shapefile, JDBC through sqlite3 and
OSM XML (``geo_formats``); validators and enrichment caches. Host code:
the batches they make are written into a store like any other."""

from .converter import (DelimitedTextConverter, JsonConverter,
                        SimpleFeatureConverter, converter_for)
from .dsl import EvaluationContext, compile_expression

__all__ = ["DelimitedTextConverter", "JsonConverter",
           "SimpleFeatureConverter", "converter_for",
           "EvaluationContext", "compile_expression"]
