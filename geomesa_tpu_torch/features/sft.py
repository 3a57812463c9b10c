"""SimpleFeatureType schema model + spec-string parser.

Keeps the reference's spec grammar (geomesa-utils/.../geotools/
SimpleFeatureTypes.scala:24 and SimpleFeatureSpecParser):

    "name:String:index=true,dtg:Date,*geom:Point:srid=4326;geomesa.z3.interval='week'"

- comma-separated attributes: ``[*]name:Type[:opt=val]*`` where ``*``
  marks the default geometry
- after ``;``: schema-level user-data options (``key='val'`` or
  ``key=val``)
- types: String, Integer/Int, Double, Float, Long, Boolean, Date,
  Timestamp, UUID, Bytes, List[T], Map[K,V], Point, LineString,
  Polygon, MultiPoint, MultiLineString, MultiPolygon,
  GeometryCollection, Geometry

Typed accessors for the geomesa.* user-data keys mirror
RichSimpleFeatureType (Conversions.scala:239 getXZPrecision etc.).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

from ..curves.timebin import TimePeriod

__all__ = ["AttributeType", "AttributeSpec", "SimpleFeatureType",
           "parse_spec", "encode_spec", "Configs", "CURRENT_INDEX_VERSION"]


class Configs:
    """Schema-level user-data keys the slice reads
    (SimpleFeatureTypes.scala:28-49)."""
    DEFAULT_DATE = "geomesa.index.dtg"
    IGNORE_INDEX_DTG = "geomesa.ignore.dtg"
    VIS_LEVEL = "geomesa.visibility.level"
    Z3_INTERVAL = "geomesa.z3.interval"
    INDEX_VERSION = "geomesa.index.version"


# current z-index layout version (see SimpleFeatureType.index_version)
CURRENT_INDEX_VERSION = 2


GEOMETRY_TYPES = {
    "Point", "LineString", "Polygon", "MultiPoint", "MultiLineString",
    "MultiPolygon", "GeometryCollection", "Geometry",
}

_TYPE_ALIASES = {
    "Int": "Integer", "int": "Integer", "Integer": "Integer",
    "String": "String", "str": "String",
    "Double": "Double", "double": "Double",
    "Float": "Float", "float": "Float",
    "Long": "Long", "long": "Long",
    "Boolean": "Boolean", "boolean": "Boolean",
    "Date": "Date", "Timestamp": "Date",
    "UUID": "UUID", "Uuid": "UUID",
    "Bytes": "Bytes",
}


@dataclasses.dataclass(frozen=True)
class AttributeType:
    """A resolved attribute type, possibly parameterized (List/Map)."""
    name: str                       # canonical binding name
    key_type: str | None = None     # for Map
    value_type: str | None = None   # for List/Map

    @property
    def is_geometry(self) -> bool:
        return self.name in GEOMETRY_TYPES

    def __str__(self) -> str:
        if self.name == "List":
            return f"List[{self.value_type}]"
        if self.name == "Map":
            return f"Map[{self.key_type},{self.value_type}]"
        return self.name


@dataclasses.dataclass
class AttributeSpec:
    name: str
    type: AttributeType
    options: dict[str, str] = dataclasses.field(default_factory=dict)
    default_geom: bool = False

    @property
    def is_geometry(self) -> bool:
        return self.type.is_geometry

    @property
    def indexed(self) -> bool:
        v = self.options.get("index", "false").lower()
        return v in ("true", "full", "join")

    def to_spec(self) -> str:
        star = "*" if self.default_geom else ""
        opts = "".join(f":{k}={v}" for k, v in sorted(self.options.items()))
        return f"{star}{self.name}:{self.type}{opts}"


class SimpleFeatureType:
    """Schema: ordered attributes + user-data, with geomesa accessors."""

    def __init__(self, type_name: str, attributes: list[AttributeSpec],
                 user_data: dict[str, Any] | None = None):
        self.type_name = type_name
        self.attributes = list(attributes)
        self.user_data: dict[str, Any] = dict(user_data or {})
        self._by_name = {a.name: i for i, a in enumerate(self.attributes)}
        if len(self._by_name) != len(self.attributes):
            raise ValueError("duplicate attribute names")

    # -- lookup -----------------------------------------------------------

    def index_of(self, name: str) -> int:
        if name not in self._by_name:
            raise KeyError(f"no attribute '{name}' in {self.type_name}")
        return self._by_name[name]

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def attr(self, name: str) -> AttributeSpec:
        return self.attributes[self.index_of(name)]

    @property
    def geom_field(self) -> str | None:
        """Default geometry attribute (the '*'-marked one, else first geom)."""
        for a in self.attributes:
            if a.default_geom:
                return a.name
        for a in self.attributes:
            if a.is_geometry:
                return a.name
        return None

    @property
    def dtg_field(self) -> str | None:
        """Default date attribute: geomesa.index.dtg user-data, else the
        first Date attribute (RichSimpleFeatureType semantics)."""
        if self.user_data.get(Configs.IGNORE_INDEX_DTG) in (True, "true"):
            return None
        explicit = self.user_data.get(Configs.DEFAULT_DATE)
        if explicit and explicit in self:
            return explicit
        for a in self.attributes:
            if a.type.name == "Date":
                return a.name
        return None

    @property
    def is_points(self) -> bool:
        g = self.geom_field
        return g is not None and self.attr(g).type.name == "Point"

    # -- geomesa config accessors ----------------------------------------

    @property
    def z3_interval(self) -> TimePeriod:
        return TimePeriod.parse(self.user_data.get(Configs.Z3_INTERVAL, "week"))

    @property
    def visibility_level(self) -> str:
        """'feature' (default) or 'attribute': attribute-level stores
        one visibility label PER ATTRIBUTE per feature (comma-joined on
        write), and queries null out unauthorized attributes instead of
        dropping whole rows (KryoVisibilityRowEncoder semantics,
        accumulo/iterators/KryoVisibilityRowEncoder.scala:26)."""
        return str(self.user_data.get(Configs.VIS_LEVEL, "feature"))

    @property
    def index_version(self) -> int:
        """Z-index layout version (GeoMesaFeatureIndex keys table names
        by version, GeoMesaFeatureIndex.scala:33-35). The batcher keys
        its shape classes on it."""
        return int(self.user_data.get(Configs.INDEX_VERSION,
                                      CURRENT_INDEX_VERSION))

    # -- encoding ---------------------------------------------------------

    def to_spec(self) -> str:
        return encode_spec(self)

    def __repr__(self) -> str:
        return f"SimpleFeatureType({self.type_name!r}, {self.to_spec()!r})"

    def __eq__(self, other) -> bool:
        return (isinstance(other, SimpleFeatureType)
                and self.type_name == other.type_name
                and self.to_spec() == other.to_spec())


_ATTR_RE = re.compile(
    r"^(?P<star>\*?)(?P<name>[a-zA-Z_][\w.-]*):(?P<type>[A-Za-z]+(?:\[[^\]]+\])?)"
    r"(?P<opts>(?::[^:,;]+=[^:,;]*)*)$")


def _parse_type(s: str) -> AttributeType:
    m = re.match(r"^List\[\s*(\w+)\s*\]$", s)
    if m:
        return AttributeType("List", value_type=_TYPE_ALIASES.get(m.group(1), m.group(1)))
    m = re.match(r"^Map\[\s*(\w+)\s*,\s*(\w+)\s*\]$", s)
    if m:
        return AttributeType("Map", key_type=_TYPE_ALIASES.get(m.group(1), m.group(1)),
                             value_type=_TYPE_ALIASES.get(m.group(2), m.group(2)))
    if s in GEOMETRY_TYPES:
        return AttributeType(s)
    if s in _TYPE_ALIASES:
        return AttributeType(_TYPE_ALIASES[s])
    raise ValueError(f"unknown attribute type: {s!r}")


def _split_top(s: str, sep: str) -> list[str]:
    """Split on sep outside of [] brackets and quotes."""
    out, depth, quote, cur = [], 0, None, []
    for ch in s:
        if quote:
            if ch == quote:
                quote = None
            cur.append(ch)
        elif ch in "'\"":
            quote = ch
            cur.append(ch)
        elif ch == "[":
            depth += 1
            cur.append(ch)
        elif ch == "]":
            depth -= 1
            cur.append(ch)
        elif ch == sep and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return out


def parse_spec(type_name: str, spec: str) -> SimpleFeatureType:
    """Parse a spec string into a SimpleFeatureType."""
    spec = spec.strip()
    if ";" in spec:
        attr_part, opt_part = spec.split(";", 1)
    else:
        attr_part, opt_part = spec, ""

    attributes = []
    for raw in _split_top(attr_part, ","):
        raw = raw.strip()
        if not raw:
            continue
        m = _ATTR_RE.match(raw)
        if not m:
            raise ValueError(f"invalid attribute spec: {raw!r}")
        atype = _parse_type(m.group("type"))
        opts: dict[str, str] = {}
        opt_str = m.group("opts")
        if opt_str:
            for kv in opt_str.strip(":").split(":"):
                k, _, v = kv.partition("=")
                opts[k.strip()] = v.strip()
        default_geom = m.group("star") == "*"
        if default_geom and not atype.is_geometry:
            raise ValueError(f"'*' default marker on non-geometry: {raw!r}")
        attributes.append(AttributeSpec(m.group("name"), atype, opts, default_geom))

    user_data: dict[str, Any] = {}
    if opt_part.strip():
        for kv in _split_top(opt_part, ","):
            kv = kv.strip()
            if not kv:
                continue
            k, _, v = kv.partition("=")
            v = v.strip()
            if len(v) >= 2 and v[0] == v[-1] and v[0] in "'\"":
                v = v[1:-1]
            user_data[k.strip()] = v

    return SimpleFeatureType(type_name, attributes, user_data)


def encode_spec(sft: SimpleFeatureType) -> str:
    attrs = ",".join(a.to_spec() for a in sft.attributes)
    if sft.user_data:
        opts = ",".join(f"{k}='{v}'" for k, v in sorted(sft.user_data.items()))
        return f"{attrs};{opts}"
    return attrs
