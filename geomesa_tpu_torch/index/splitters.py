"""Table pre-split strategies (index/conf/Splitters.scala:16-45).

The reference computes initial tablet/region split keys so new tables
start distributed; here the same split keys seed the sharded store's
partition boundaries (a new type's rows hash/range across shards from
the first write instead of after a re-balance).
"""

from __future__ import annotations

__all__ = ["DigitSplitter", "HexSplitter", "AlphaNumericSplitter",
           "NoSplitter", "splitter_for"]


class DigitSplitter:
    """Numeric split points: options fmt (printf), min, max
    (Splitters.scala:16-27)."""

    def get_splits(self, options: dict | None = None) -> list[bytes]:
        options = options or {}
        fmt = options.get("fmt", "%01d")
        lo = int(options.get("min", 0))
        hi = int(options.get("max", 0))
        return [(fmt % i).encode() for i in range(lo, hi + 1)]


class HexSplitter:
    """Hex character split points; 0 omitted to avoid an empty initial
    shard (Splitters.scala:29-33)."""

    _splits = [c.encode() for c in "123456789abcdefABCDEF"]

    def get_splits(self, options: dict | None = None) -> list[bytes]:
        return list(self._splits)


class AlphaNumericSplitter:
    """[1-9a-zA-Z] single-character split points
    (Splitters.scala:35-39)."""

    _splits = [c.encode() for c in
               "123456789abcdefghijklmnopqrstuvwxyz"
               "ABCDEFGHIJKLMNOPQRSTUVWXYZ"]

    def get_splits(self, options: dict | None = None) -> list[bytes]:
        return list(self._splits)


class NoSplitter:
    def get_splits(self, options: dict | None = None) -> list[bytes]:
        return []


_REGISTRY = {
    "digit": DigitSplitter,
    "hex": HexSplitter,
    "alphanumeric": AlphaNumericSplitter,
    "none": NoSplitter,
}


def splitter_for(name: str):
    """Splitter by short name (the SFT user-data `table.splitter.class`
    analog)."""
    try:
        return _REGISTRY[name.lower()]()
    except KeyError:
        raise ValueError(f"unknown splitter '{name}'; "
                         f"one of {sorted(_REGISTRY)}") from None
