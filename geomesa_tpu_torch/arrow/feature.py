"""ArrowFeature: zero-copy feature facade over a pyarrow RecordBatch row
(arrow/vector/ArrowSimpleFeature analog) — attribute reads index the
Arrow vectors directly without materializing python rows.
"""

from __future__ import annotations

from ..features.sft import SimpleFeatureType

__all__ = ["ArrowFeature"]


class ArrowFeature:
    def __init__(self, sft: SimpleFeatureType, rb, row: int):
        self._sft = sft
        self._rb = rb
        self._row = row

    @property
    def id(self) -> str:
        return self._rb.column("__fid__")[self._row].as_py()

    def get(self, name: str):
        # ONE decode implementation for every layout: the typed reader
        # (arrow/vector.py); a second copy here would drift
        from .vector import ArrowAttributeReader
        return ArrowAttributeReader(
            name, self._rb.column(name),
            attr=self._sft.attr(name)).apply(self._row)

    def as_dict(self) -> dict:
        out = {"id": self.id}
        for a in self._sft.attributes:
            out[a.name] = self.get(a.name)
        return out
