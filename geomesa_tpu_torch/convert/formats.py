"""Additional converter formats: XML, Avro, fixed-width, composite
(geomesa-convert-xml / -avro / -fixedwidth / composite-converter
analogs, SURVEY.md 2.4).
"""

from __future__ import annotations

import io
import re
import xml.etree.ElementTree as ET
from typing import Any

from ..features.sft import SimpleFeatureType
from .converter import _BAD_RECORD, SimpleFeatureConverter

__all__ = ["XmlConverter", "FixedWidthConverter", "CompositeConverter",
           "AvroConverter"]


class XmlConverter(SimpleFeatureConverter):
    """XML -> features. Config:
        {"type": "xml", "feature-path": ".//entry",
         "id-field": "$1",
         "fields": [{"name": "a", "path": "name"},            # child text
                    {"name": "b", "path": "@attr"},           # attribute
                    {"name": "geom", "path": "pos",
                     "transform": "point(...)"}]}
    Paths are ElementTree paths relative to each feature element;
    '@x' reads an attribute; columns bind $1..$N in declared order
    (the reference's XPath fields, geomesa-convert-xml)."""

    def __init__(self, sft: SimpleFeatureType, config: dict):
        self.feature_path = config.get("feature-path", ".")
        self.paths = [f["path"] for f in config.get("fields", [])
                      if "path" in f]
        fields = []
        col = 0
        for f in config.get("fields", []):
            f = dict(f)
            if "path" in f:
                col += 1
                if "name" in f:
                    f.setdefault("transform", f"${col}")
            fields.append(f)
        config = dict(config)
        config["fields"] = fields
        super().__init__(sft, config)

    @staticmethod
    def _resolve(elem: ET.Element, path: str):
        if path.startswith("@"):
            return elem.get(path[1:])
        # trailing @attr on a child path
        if "/@" in path:
            p, attr = path.rsplit("/@", 1)
            child = elem.find(p)
            return None if child is None else child.get(attr)
        child = elem.find(path)
        if child is None:
            return None
        return (child.text or "").strip() or None

    def _records(self, source):
        if not isinstance(source, str):
            source = source.read()
        try:
            root = ET.fromstring(source)
        except ET.ParseError:
            yield _BAD_RECORD
            return
        elems = ([root] if self.feature_path in (".", "")
                 else root.findall(self.feature_path))
        for el in elems:
            try:
                yield [el] + [self._resolve(el, p) for p in self.paths]
            except Exception:
                yield _BAD_RECORD


class FixedWidthConverter(SimpleFeatureConverter):
    """Fixed-width lines (geomesa-convert-fixedwidth): columns declared
    as {"start": S, "width": W} slices; $1..$N bind in declared order."""

    def __init__(self, sft: SimpleFeatureType, config: dict):
        self.slices = [(f["start"], f["width"])
                       for f in config.get("fields", [])
                       if "start" in f and "width" in f]
        fields = []
        col = 0
        for f in config.get("fields", []):
            f = dict(f)
            if "start" in f and "width" in f:
                col += 1
                if "name" in f:
                    f.setdefault("transform", f"${col}")
            fields.append(f)
        config = dict(config)
        config["fields"] = fields
        super().__init__(sft, config)

    def _records(self, source):
        if isinstance(source, str):
            source = io.StringIO(source)
        for line in source:
            line = line.rstrip("\n")
            if not line.strip():
                continue
            yield [line] + [line[s:s + w].strip() or None
                            for s, w in self.slices]


class CompositeConverter:
    """Dispatch each record to the first matching delegate
    (composite-converter of geomesa-convert-common): config is
    {"type": "composite", "converters": [{"predicate": "regex", ...child
    config...}, ...]}; the predicate is a regex tested against the raw
    record line."""

    def __init__(self, sft: SimpleFeatureType, config: dict):
        from .converter import converter_for
        self.sft = sft
        self.delegates = []
        for sub in config.get("converters", []):
            sub = dict(sub)
            pred = re.compile(sub.pop("predicate", ".*"))
            self.delegates.append((pred, converter_for(sft, sub)))

    def process(self, source, ctx=None):
        from .dsl import EvaluationContext
        from ..features.batch import FeatureBatch
        ctx = ctx or EvaluationContext()
        if not isinstance(source, str):
            source = source.read()
        batches = []
        for line in source.splitlines():
            if not line.strip():
                continue
            for pred, conv in self.delegates:
                if pred.search(line):
                    b, ctx = conv.process(line, ctx)
                    if b.n:
                        batches.append(b)
                    break
            else:
                ctx.line += 1
                ctx.failure += 1
        if not batches:
            empty = FeatureBatch.from_dict(
                self.sft, [], {a.name: ((), ()) if a.type.name == "Point"
                               else [] for a in self.sft.attributes})
            return empty, ctx
        out = batches[0]
        for b in batches[1:]:
            out = out.concat(b)
        return out, ctx


class AvroConverter(SimpleFeatureConverter):
    """Avro OCF -> features (geomesa-convert-avro): record fields
    resolve by dotted path like the JSON converter; the embedded reader
    needs no external avro dependency."""

    def __init__(self, sft: SimpleFeatureType, config: dict):
        self.paths = [f["path"] for f in config.get("fields", [])
                      if "path" in f]
        fields = []
        col = 0
        for f in config.get("fields", []):
            f = dict(f)
            if "path" in f:
                col += 1
                if "name" in f:
                    f.setdefault("transform", f"${col}")
            fields.append(f)
        config = dict(config)
        config["fields"] = fields
        super().__init__(sft, config)

    @staticmethod
    def _resolve(obj: Any, path: str):
        cur = obj
        for part in path.replace("$.", "").split("."):
            if isinstance(cur, dict):
                cur = cur.get(part)
            else:
                return None
        return cur

    def _records(self, source):
        from .avro_reader import AvroFileReader
        try:
            if isinstance(source, str):
                with open(source, "rb") as fh:
                    records = list(AvroFileReader(fh.read()))
            elif isinstance(source, (bytes, bytearray)):
                records = list(AvroFileReader(bytes(source)))
            else:
                records = list(AvroFileReader(source.read()))
        except Exception:
            yield _BAD_RECORD
            return
        for obj in records:
            try:
                yield [obj] + [self._resolve(obj, p) for p in self.paths]
            except Exception:
                yield _BAD_RECORD
