"""Converter transform-expression DSL.

The reference's ingest converters evaluate a small expression language
per field (convert/Transformers.scala — scala parser-combinators):
column refs ``$1``, field refs ``$name``, regex literals ``'rx'::r``,
casts ``::int``, function calls, ``try(expr, fallback)``, a date-format
zoo, hashes, math, list/map helpers, geometry constructors. This is a
from-scratch recursive-descent implementation of that grammar over
Python values.

Supported grammar:
    $0 .. $N                 raw input columns ($0 = whole record)
    $name                    previously-computed field (declaration order)
    'literal'  123  4.5      literals; 'pattern'::r compiles a regex
    expr::int  ::long ::float ::double ::string ::boolean
    fn(args...)              from the registry below
    try(expr, fallback)      withDefault(expr, default)

Function registry (Transformers.scala parity): strings (concat, trim,
capitalize, stripQuotes, emptyToNull, mkstring, regexReplace,
substring, length...), dates (now, date, datetime, isodate,
isodatetime, basicDateTimeNoMillis, dateHourMinuteSecondMillis,
millisToDate, secsToDate, dateToString), hashes (md5, murmur3_32,
murmur3_64, base64), math (add, subtract, multiply, divide, mean, min,
max), lists/maps (list, listItem, parseList, parseMap, mapValue),
conversions (stringToInt/Long/Float/Double/Boolean), geometry (point,
linestring, polygon, multi*, geometry), uuid, stringToBytes,
cacheLookup.
"""

from __future__ import annotations

import base64 as _b64
import hashlib
import re
import struct
import threading
import uuid as _uuid
from typing import Any, Callable

import numpy as np

from ..geometry import Point, parse_wkt

__all__ = ["compile_expression", "parse_expression", "EvaluationContext",
           "murmur3_32", "murmur3_128"]


class EvaluationContext:
    """Per-ingest counters + caches (convert/EvaluationContext analog).

    Counter bumps are NOT atomic in CPython across `+=` on attributes,
    so the ingest pipeline's worker threads each get their own context
    and `merge()` them into the caller's at flush — the per-worker-
    context strategy of the reference's EvaluationContext.copy. A lock
    still guards `merge`/`counters` so a live metrics scrape racing a
    flush reads a consistent triple."""

    def __init__(self):
        self.success = 0
        self.failure = 0
        self.line = 0
        self._lock = threading.Lock()

    def merge(self, other: "EvaluationContext") -> "EvaluationContext":
        """Fold another context's counts into this one (thread-safe)."""
        with other._lock:
            s, f, ln = other.success, other.failure, other.line
        with self._lock:
            self.success += s
            self.failure += f
            self.line += ln
        return self

    def counters(self) -> dict[str, int]:
        with self._lock:
            return {"success": self.success, "failure": self.failure,
                    "line": self.line}


# -- murmur3 (x86_32 and x64_128) — pure-python, test-vector checked ------

def murmur3_32(data: bytes, seed: int = 0) -> int:
    """MurmurHash3 x86 32-bit (the guava Hashing.murmur3_32 the
    reference's hash transformer uses)."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & 0xFFFFFFFF
    n = len(data)
    rounded = n - (n % 4)
    for i in range(0, rounded, 4):
        k = struct.unpack_from("<I", data, i)[0]
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    k = 0
    tail = data[rounded:]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def _fmix64(k: int) -> int:
    k ^= k >> 33
    k = (k * 0xFF51AFD7ED558CCD) & 0xFFFFFFFFFFFFFFFF
    k ^= k >> 33
    k = (k * 0xC4CEB9FE1A85EC53) & 0xFFFFFFFFFFFFFFFF
    k ^= k >> 33
    return k


def murmur3_128(data: bytes, seed: int = 0):
    """MurmurHash3 x64 128-bit; murmur3_64 is its leading 8 bytes."""
    m = 0xFFFFFFFFFFFFFFFF
    c1, c2 = 0x87C37B91114253D5, 0x4CF5AD432745937F
    h1 = h2 = seed & m
    n = len(data)
    rounded = n - (n % 16)
    for i in range(0, rounded, 16):
        k1, k2 = struct.unpack_from("<QQ", data, i)
        k1 = (k1 * c1) & m
        k1 = ((k1 << 31) | (k1 >> 33)) & m
        k1 = (k1 * c2) & m
        h1 ^= k1
        h1 = ((h1 << 27) | (h1 >> 37)) & m
        h1 = (h1 + h2) & m
        h1 = (h1 * 5 + 0x52DCE729) & m
        k2 = (k2 * c2) & m
        k2 = ((k2 << 33) | (k2 >> 31)) & m
        k2 = (k2 * c1) & m
        h2 ^= k2
        h2 = ((h2 << 31) | (h2 >> 33)) & m
        h2 = (h2 + h1) & m
        h2 = (h2 * 5 + 0x38495AB5) & m
    tail = data[rounded:]
    k1 = k2 = 0
    for j in range(min(len(tail), 16) - 1, 7, -1):
        k2 ^= tail[j] << ((j - 8) * 8)
    for j in range(min(len(tail), 8) - 1, -1, -1):
        k1 ^= tail[j] << (j * 8)
    if len(tail) > 8:
        k2 = (k2 * c2) & m
        k2 = ((k2 << 33) | (k2 >> 31)) & m
        k2 = (k2 * c1) & m
        h2 ^= k2
    if len(tail) > 0:
        k1 = (k1 * c1) & m
        k1 = ((k1 << 31) | (k1 >> 33)) & m
        k1 = (k1 * c2) & m
        h1 ^= k1
    h1 ^= n
    h2 ^= n
    h1 = (h1 + h2) & m
    h2 = (h2 + h1) & m
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    h1 = (h1 + h2) & m
    h2 = (h2 + h1) & m
    return h1, h2


def _to_bytes(v) -> bytes:
    return v if isinstance(v, (bytes, bytearray)) else str(v).encode()


# -- parser ----------------------------------------------------------------

class _P:
    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def ws(self):
        while self.i < len(self.s) and self.s[self.i].isspace():
            self.i += 1

    def peek(self) -> str:
        self.ws()
        return self.s[self.i] if self.i < len(self.s) else ""

    def eat(self, ch: str):
        self.ws()
        if self.peek() != ch:
            raise ValueError(f"expected {ch!r} at {self.i} in {self.s!r}")
        self.i += 1

    def match_re(self, rx: str):
        self.ws()
        m = re.match(rx, self.s[self.i:])
        if m:
            self.i += m.end()
            return m
        return None


_CASTS: dict[str, Callable[[Any], Any]] = {
    "int": lambda v: int(float(v)),
    "integer": lambda v: int(float(v)),
    "long": lambda v: int(float(v)),
    "float": float,
    "double": float,
    "string": str,
    "boolean": lambda v: str(v).strip().lower() in ("true", "1", "t", "yes"),
}


def _java_fmt(fmt: str) -> str:
    return (fmt.replace("yyyy", "%Y").replace("MM", "%m")
            .replace("dd", "%d").replace("HH", "%H").replace("mm", "%M")
            .replace("ss", "%S").replace("SSS", "%f")
            .replace("'T'", "T").replace("'Z'", "Z"))


def _fn_date(fmt: str, s: str) -> int:
    """Parse with a java-SimpleDateFormat-flavored pattern -> millis."""
    import datetime as _dt
    dt = _dt.datetime.strptime(str(s).strip(), _java_fmt(fmt))
    return int(dt.replace(tzinfo=_dt.timezone.utc).timestamp() * 1000)


def _fn_iso_date(s: str) -> int:
    return int(np.datetime64(str(s).strip().rstrip("Z"), "ms").astype(np.int64))


def _fn_date_to_string(fmt: str, millis: int) -> str:
    import datetime as _dt
    dt = _dt.datetime.fromtimestamp(int(millis) / 1000.0,
                                    tz=_dt.timezone.utc)
    # java SSS means 3-digit millis; strftime %f is 6-digit micros, and
    # a placeholder char cannot ride through C strftime (glibc
    # truncates the format at a NUL) — format around the SSS runs
    ms = f"{dt.microsecond // 1000:03d}"
    return ms.join(dt.strftime(_java_fmt(p)) for p in fmt.split("SSS"))


def _line_geom(cls_wkt: str, arg):
    """Geometry constructor accepting full WKT text or, for the types
    where a bare body is unambiguous, just the coordinates
    (Transformers' linestring('0 0, 1 1') convenience). A bare
    POLYGON/MULTIPOLYGON body is a single shell; a bare
    MULTILINESTRING body is a single line; GEOMETRYCOLLECTION requires
    full WKT (a bare body has no type tags)."""
    s = str(arg).strip()
    if not s.upper().startswith(cls_wkt):
        if cls_wkt == "GEOMETRYCOLLECTION":
            raise ValueError(
                "geometrycollection() requires full WKT input")
        if cls_wkt in ("POLYGON", "MULTILINESTRING") \
                and not s.startswith("("):
            s = f"({s})"
        elif cls_wkt == "MULTIPOLYGON" and not s.startswith("(("):
            if not s.startswith("("):
                s = f"({s})"
            s = f"({s})"
        s = f"{cls_wkt} ({s})"
    return parse_wkt(s)


def _num_args(args):
    return [float(a) for a in args]


_FUNCTIONS: dict[str, Callable[..., Any]] = {
    # strings (Transformers.scala string fns)
    "concat": lambda *a: "".join(str(x) for x in a),
    "concatenate": lambda *a: "".join(str(x) for x in a),
    "trim": lambda s: str(s).strip(),
    "strip": lambda s, chars=None: str(s).strip(chars),
    "stripQuotes": lambda s: str(s).strip("'\""),
    "stripPrefix": lambda s, p: str(s)[len(str(p)):]
        if str(s).startswith(str(p)) else str(s),
    "stripSuffix": lambda s, p: str(s)[: -len(str(p))]
        if str(p) and str(s).endswith(str(p)) else str(s),
    "capitalize": lambda s: str(s).capitalize(),
    "lowercase": lambda s: str(s).lower(),
    "uppercase": lambda s: str(s).upper(),
    "emptyToNull": lambda s: None if s is None or str(s).strip() == ""
        else s,
    "mkstring": lambda sep, *a: str(sep).join(str(x) for x in a),
    "regexReplace": lambda rx, rep, s: (
        rx.sub(str(rep), str(s)) if isinstance(rx, re.Pattern)
        else re.sub(str(rx), str(rep), str(s))),
    "regexExtract": lambda rx, s, group=None: _regex_extract(rx, s,
                                                             group),
    "substring": lambda s, i, j: str(s)[int(i):int(j)],
    "substr": lambda s, i, j: str(s)[int(i):int(j)],
    "length": lambda s: len(str(s)),
    "strlen": lambda s: len(str(s)),
    "stringLength": lambda s: len(str(s)),
    "toString": str,
    # dates (the reference's StandardDateParser zoo)
    "now": lambda: int(np.datetime64("now", "ms").astype(np.int64)),
    "date": _fn_date,
    "customFormatDateParser": _fn_date,
    "datetime": _fn_iso_date,
    "isoDate": _fn_iso_date,
    "isodate": lambda s: _fn_date("yyyyMMdd", s),
    "basicDate": lambda s: _fn_date("yyyyMMdd", s),
    "isodatetime": lambda s: _fn_date("yyyyMMdd'T'HHmmss.SSS",
                                      str(s).rstrip("Z")),
    "basicDateTime": lambda s: _fn_date("yyyyMMdd'T'HHmmss.SSS",
                                        str(s).rstrip("Z")),
    "basicDateTimeNoMillis": lambda s: _fn_date("yyyyMMdd'T'HHmmss",
                                                str(s).rstrip("Z")),
    "dateHourMinuteSecondMillis":
        lambda s: _fn_date("yyyy-MM-dd'T'HH:mm:ss.SSS", s),
    "millisToDate": lambda n: int(n),
    "secsToDate": lambda n: int(float(n) * 1000),
    "dateToString": _fn_date_to_string,
    # geometry constructors
    "point": lambda x, y: Point(float(x), float(y)),
    "geometry": lambda wkt: parse_wkt(str(wkt)),
    "linestring": lambda a: _line_geom("LINESTRING", a),
    "polygon": lambda a: _line_geom("POLYGON", a),
    "multipoint": lambda a: _line_geom("MULTIPOINT", a),
    "multilinestring": lambda a: _line_geom("MULTILINESTRING", a),
    "multipolygon": lambda a: _line_geom("MULTIPOLYGON", a),
    "geometrycollection": lambda a: _line_geom("GEOMETRYCOLLECTION", a),
    # hashes / ids / bytes
    "md5": lambda s: hashlib.md5(_to_bytes(s)).hexdigest(),
    "murmur3_32": lambda s: murmur3_32(_to_bytes(s)),
    "murmur3_64": lambda s: struct.unpack(
        "<q", struct.pack("<Q", murmur3_128(_to_bytes(s))[0]))[0],
    "murmurHash3": lambda s: murmur3_128(_to_bytes(s))[0],
    "base64": lambda s: _b64.b64encode(_to_bytes(s)).decode(),
    "uuid": lambda: str(_uuid.uuid4()),
    "stringToBytes": lambda s: str(s).encode(),
    "string2bytes": lambda s: str(s).encode(),
    # math (numeric-string tolerant, like the reference's)
    "add": lambda *a: sum(_num_args(a)),
    "subtract": lambda *a: (lambda v: v[0] - sum(v[1:]))(_num_args(a)),
    "multiply": lambda *a: float(np.prod(_num_args(a))),
    "divide": lambda *a: (lambda v: float(np.divide.reduce(v)))(_num_args(a)),
    "mean": lambda *a: float(np.mean(_num_args(a))),
    "min": lambda *a: min(_num_args(a)),
    "max": lambda *a: max(_num_args(a)),
    # lists / maps
    "list": lambda *a: list(a),
    "listItem": lambda lst, i: lst[int(i)],
    "parseList": lambda typ, s, sep=",": [
        _CASTS.get(str(typ).lower(), str)(x)
        for x in str(s).split(str(sep)) if x != ""],
    "parseMap": lambda typ, s, sep=",", kv="->": {
        (p.split(str(kv))[0].strip()):
        _CASTS.get(str(typ).lower(), str)(p.split(str(kv))[1].strip())
        for p in str(s).split(str(sep)) if str(kv) in p},
    "mapValue": lambda m, k, default=None: (m or {}).get(str(k), default),
    # conversions
    "stringToInt": lambda s, d=None: _try_cast(s, int, d),
    "stringToInteger": lambda s, d=None: _try_cast(s, int, d),
    "stringToLong": lambda s, d=None: _try_cast(s, int, d),
    "stringToFloat": lambda s, d=None: _try_cast(s, float, d),
    "stringToDouble": lambda s, d=None: _try_cast(s, float, d),
    "stringToBool": lambda s, d=None: _try_cast(s, _parse_bool, d),
    "stringToBoolean": lambda s, d=None: _try_cast(s, _parse_bool, d),
    "cacheLookup": lambda name, key, field=None: _cache_lookup(
        name, key, field),
}


def _cache_lookup(name, key, field):
    from .enrichment import cache_lookup
    return cache_lookup(name, key, field)


def _try_cast(s, fn, default):
    try:
        return fn(s)
    except (TypeError, ValueError):
        return default


def _regex_extract(rx, s, group):
    """First match of rx in s: group 1 when the pattern captures,
    else the whole match; an explicit out-of-range group is a clear
    error, not a silent per-record failure."""
    pat = rx if isinstance(rx, re.Pattern) else re.compile(str(rx))
    g = int(group) if group is not None else (1 if pat.groups else 0)
    if g > pat.groups:
        raise ValueError(f"regexExtract: pattern has {pat.groups} "
                         f"group(s), requested {g}")
    m = pat.search(str(s))
    return m.group(g) if m else None


def _parse_bool(v):
    s = str(v).strip().lower()
    if s in ("true", "1", "t", "yes", "y"):
        return True
    if s in ("false", "0", "f", "no", "n"):
        return False
    raise ValueError(f"not a boolean: {v!r}")


def parse_expression(text: str) -> tuple:
    """Parse an expression into its AST — tagged tuples shared by the
    scalar compiler below and the columnar compiler in ``vectorized``:

        ("col", i)               column reference $i
        ("field", name)          $fieldName cross-reference
        ("lit", value)           literal (str only from quoted literals)
        ("relit", pattern)       '...'::r constant-folded at parse time
        ("recast", node)         dynamic ::r over a non-literal
        ("cast", name, node)     ::int / ::double / ...
        ("fn", name, [nodes])    registry function call
        ("try", expr, fallback)
        ("withdefault", expr, default)
    """
    p = _P(text)
    node = _parse_expr(p)
    p.ws()
    if p.i != len(p.s):
        raise ValueError(f"trailing input in expression: {text[p.i:]!r}")
    return node


def compile_expression(text: str) -> Callable[..., Any]:
    """Compile an expression to ``fn(columns, fields=None)``.
    ``columns[0]`` is the whole record; ``columns[1:]`` are input
    fields; ``fields`` maps previously-computed field names to values
    (the reference's `$fieldName` cross-references, evaluated in
    declaration order)."""
    expr = _compile_node(parse_expression(text))

    def run(cols, fields=None):
        return expr((cols, fields or {}))
    return run


def _parse_expr(p: _P) -> tuple:
    e = _parse_primary(p)
    # postfix casts, possibly chained; '...'::r compiles a regex literal
    while True:
        m = p.match_re(r"::(\w+)")
        if not m:
            return e
        name = m.group(1).lower()
        if name == "r":
            if e[0] == "lit" and isinstance(e[1], str):
                # constant-fold: string literals compile ONCE at
                # expression-compile time, not per record
                e = ("relit", re.compile(e[1]))
            else:
                e = ("recast", e)
            continue
        if name not in _CASTS:
            raise ValueError(f"unknown cast ::{m.group(1)}")
        e = ("cast", name, e)


def _parse_primary(p: _P) -> tuple:
    m = p.match_re(r"\$(\d+)")
    if m:
        return ("col", int(m.group(1)))
    m = p.match_re(r"\$([A-Za-z_]\w*)")
    if m:
        return ("field", m.group(1))
    m = p.match_re(r"'((?:[^']|'')*)'")
    if m:
        return ("lit", m.group(1).replace("''", "'"))
    m = p.match_re(r"[-+]?\d+\.\d+(?:[eE][-+]?\d+)?")
    if m:
        return ("lit", float(m.group(0)))
    m = p.match_re(r"[-+]?\d+(?![\w.])")
    if m:
        return ("lit", int(m.group(0)))
    m = p.match_re(r"null\b")
    if m:
        return ("lit", None)
    m = p.match_re(r"(\w+)\s*\(")
    if m:
        name = m.group(1)
        args = []
        if p.peek() != ")":
            args.append(_parse_expr(p))
            while p.peek() == ",":
                p.eat(",")
                args.append(_parse_expr(p))
        p.eat(")")
        if name == "try":
            if len(args) != 2:
                raise ValueError("try(expr, fallback) takes 2 args")
            return ("try", args[0], args[1])
        if name == "withDefault":
            if len(args) != 2:
                raise ValueError("withDefault(expr, default) takes 2 args")
            return ("withdefault", args[0], args[1])
        if name not in _FUNCTIONS:
            raise ValueError(f"unknown function {name!r}")
        return ("fn", name, args)
    raise ValueError(f"cannot parse expression at {p.i} in {p.s!r}")


def _compile_node(node: tuple) -> Callable[[tuple], Any]:
    """Scalar backend: AST -> closure over ctx=(cols, fields)."""
    kind = node[0]
    if kind == "col":
        idx = node[1]
        return lambda ctx: ctx[0][idx]
    if kind == "field":
        name = node[1]

        def _field(ctx, name=name):
            if name not in ctx[1]:
                raise ValueError(f"unknown field reference ${name} "
                                 "(fields evaluate in declaration order)")
            return ctx[1][name]
        return _field
    if kind == "lit":
        lit = node[1]
        return lambda ctx: lit
    if kind == "relit":
        pat = node[1]
        return lambda ctx: pat
    if kind == "recast":
        inner = _compile_node(node[1])
        return lambda ctx: re.compile(str(inner(ctx)))
    if kind == "cast":
        cast = _CASTS[node[1]]
        inner = _compile_node(node[2])
        return lambda ctx: cast(inner(ctx))
    if kind == "try":
        expr = _compile_node(node[1])
        fallback = _compile_node(node[2])

        def _try(ctx, expr=expr, fallback=fallback):
            try:
                return expr(ctx)
            except Exception:
                return fallback(ctx)
        return _try
    if kind == "withdefault":
        expr = _compile_node(node[1])
        default = _compile_node(node[2])

        def _wd(ctx, expr=expr, default=default):
            v = expr(ctx)
            return default(ctx) if v in (None, "") else v
        return _wd
    fn = _FUNCTIONS[node[1]]
    args = [_compile_node(a) for a in node[2]]
    return lambda ctx: fn(*(a(ctx) for a in args))
